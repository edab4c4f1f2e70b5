"""WebP reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL, whose WebP reader runs
libwebp's WebPAnimDecoder on every file: the demuxer checks the RIFF
container, frame 0 is decoded to RGBA onto a zeroed canvas, and the mode
is "RGBA" where WebPGetFeatures finds alpha in the file, else "RGB" (the
fourth byte dropped). This is the port's reader, returning an `image_io.Picture`:

- the container as libwebp's demuxer walks it: a simple file (one `VP8 `
  or `VP8L` chunk, its alpha from VP8L's header bit), or `VP8X` with its
  flags and canvas, `ALPH` before a `VP8 ` frame (kept only under the
  alpha flag), `ICCP`, `EXIF`, `XMP ` and unknown chunks skipped (PIL
  applies no EXIF orientation to a WebP), and `ANIM` / `ANMF`: frame 0 at
  its offset on the canvas, the background colour ignored;
- the bitstreams in `csrc/webp_decode.cc` (compiled host C++, built at
  first use): VP8L lossless, ALPH, VP8 lossy with libwebp's fancy
  upsampling to RGB.

Where libwebp refuses a file (a truncated file, a bad chunk size, frames
out of order or off the canvas, a corrupt bitstream), this raises a
`ValueError` naming the file, as PIL raises.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from gaussian_splatting_torch.utils import cuda_build
from gaussian_splatting_torch.utils.bmp import MAX_PIXELS

ALPHA_FLAG, ANIMATION_FLAG, ICCP_FLAG, EXIF_FLAG, XMP_FLAG = 0x10, 0x02, 0x20, 0x08, 0x04
ALL_VALID_FLAGS = ALPHA_FLAG | ANIMATION_FLAG | ICCP_FLAG | EXIF_FLAG | XMP_FLAG
MAX_CHUNK_PAYLOAD = (1 << 32) - 1 - 8 - 1  # libwebp's ~0U - CHUNK_HEADER_SIZE - 1
MAX_IMAGE_AREA = 1 << 32
IMAGE_CHUNKS = (b"VP8 ", b"VP8L", b"VP8X")
SUPPORTED = "the port reads the WebP files PIL reads (libwebp's WebPAnimDecoder)"


class Refused(ValueError):
    pass


class _Frame:
    """One frame as libwebp's demuxer keeps it (its `Frame`)."""

    def __init__(self):
        self.x = self.y = 0
        self.width = self.height = 0
        self.has_alpha = False
        self.alpha = None  # (offset, declared size) of the ALPH payload
        self.image = None  # (offset, size with the pad byte, lossless)
        self.alpha_at = self.image_at = 0  # chunk offsets, for libwebp's order check
        self.alph_first = False  # an ALPH chunk before the image chunk
        self.alpha_bit = False  # VP8L's header bit
        self.complete = False
        self.number = 0


def _u32(data, at):
    return struct.unpack_from("<I", data, at)[0]


def _u24(data, at):
    return data[at] | data[at + 1] << 8 | data[at + 2] << 16


def _library(name):
    try:
        lib = cuda_build.load_host("webp_decode")
    except RuntimeError as err:
        raise RuntimeError(f"{name}: the WebP decoder (csrc/webp_decode.cc) could not be built: {err}") from err
    if not hasattr(lib, "_gs_typed"):
        lib.gs_webp_info.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.gs_webp_info.restype = ctypes.c_int
        lib.gs_webp_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_char_p,
                                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]
        lib.gs_webp_decode.restype = ctypes.c_int
        lib.gs_webp_error.argtypes, lib.gs_webp_error.restype = [], ctypes.c_char_p
        lib._gs_typed = True
    return lib


class _Demux:
    """libwebp's WebPDemux (demux.c) over the whole file: PARSE_ERROR and
    a file shorter than its RIFF size raise `Refused`."""

    def __init__(self, data: bytes, lib):
        self.data, self.lib = data, lib
        if len(data) < 20:
            raise Refused("a WebP file shorter than its RIFF header")
        riff_size = _u32(data, 4)
        if riff_size < 8 or riff_size > MAX_CHUNK_PAYLOAD:
            raise Refused(f"a RIFF size of {riff_size}")
        self.end = riff_size + 8
        if len(data) < self.end:
            raise Refused(f"the file ends {self.end - len(data)} bytes before its RIFF size")
        self.pos = 12
        self.flags = 0
        self.canvas = (0, 0)
        self.frames = []
        self.is_ext = False
        self.anim_chunks = 0
        if data[12:16] == b"VP8X":
            if self._vp8x() != "ok":
                raise Refused("a WebP file whose chunks run past its RIFF size")
            self._valid_extended()
        else:  # a simple file: one VP8 or VP8L chunk
            if self._single_image() != "ok":
                raise Refused("a WebP file with data after its image cut short")
            self._valid_simple()

    def left(self):
        return self.end - self.pos

    def _store_frame(self, number, min_size, frame):
        """libwebp's StoreFrame: ALPH and the image chunk of one frame."""
        data = self.data
        if self.left() < 8 or self.left() < min_size:
            return "more"
        status, alpha_chunks, image_chunks = "ok", 0, 0
        while True:
            start = self.pos
            fourcc, size = data[start:start + 4], _u32(data, start + 4)
            if size > MAX_CHUNK_PAYLOAD:
                raise Refused("a chunk size past libwebp's limit")
            padded = size + (size & 1)
            self.pos += 8
            available = min(padded, self.left())
            if padded > self.end - self.pos:
                raise Refused(f"a {bytes(fourcc)!r} chunk running past the RIFF size")
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks += 1
                frame.alpha, frame.alpha_at = (self.pos, size), start
                frame.has_alpha = True
                frame.alph_first = image_chunks == 0
                frame.number = number
                self.pos += available
            elif fourcc in (b"VP8L", b"VP8 ") and image_chunks == 0:
                lossless = fourcc == b"VP8L"
                if lossless and alpha_chunks > 0:
                    raise Refused("an ALPH chunk before a VP8L image")
                payload = data[self.pos:self.pos + available]
                info = (ctypes.c_int * 3)()
                if self.lib.gs_webp_info(payload, len(payload), size, int(lossless), ctypes.addressof(info)):
                    raise Refused(self.lib.gs_webp_error().decode())
                image_chunks += 1
                frame.image, frame.image_at = (self.pos, available, lossless), start
                frame.width, frame.height = info[0], info[1]
                frame.alpha_bit = bool(info[2])
                frame.has_alpha |= frame.alpha_bit
                frame.number = number
                frame.complete = True
                self.pos += available
            else:
                self.pos = start  # rewind: the frame ends here
                return status
            if self.pos == self.end:
                return status
            if self.left() < 8:
                return "more"

    def _single_image(self):
        if self.frames:
            raise Refused("a second image in a WebP file")
        if self.left() < 8:
            return "more"
        frame = _Frame()
        status = self._store_frame(1, 0, frame)
        if not self.flags & ALPHA_FLAG and frame.alpha is not None:
            frame.alpha, frame.has_alpha = None, False  # alpha only under the VP8X flag
        if not self.is_ext and frame.width > 0 and frame.height > 0:
            self.canvas = (frame.width, frame.height)
            if frame.has_alpha:
                self.flags |= ALPHA_FLAG
        if self.frames and not self.frames[-1].complete:
            raise Refused("a frame after an incomplete one")
        self.frames.append(frame)
        return status

    def _vp8x(self):
        data = self.data
        self.is_ext = True
        size = _u32(data, self.pos + 4)
        if size > MAX_CHUNK_PAYLOAD or size < 10:
            raise Refused(f"a VP8X chunk of {size} bytes")
        size += size & 1
        self.pos += 8
        if size > self.left():
            raise Refused("a VP8X chunk running past the RIFF size")
        self.flags = data[self.pos]
        self.canvas = (1 + _u24(data, self.pos + 4), 1 + _u24(data, self.pos + 7))
        if self.canvas[0] * self.canvas[1] >= MAX_IMAGE_AREA:
            raise Refused(f"a canvas of {self.canvas[0]}x{self.canvas[1]}")
        self.pos += size
        if self.left() < 8:
            return "more"
        is_animation = bool(self.flags & ANIMATION_FLAG)
        status = "ok"
        while status == "ok":
            start = self.pos
            fourcc, size = data[start:start + 4], _u32(data, start + 4)
            self.pos += 8
            if size > MAX_CHUNK_PAYLOAD:
                raise Refused("a chunk size past libwebp's limit")
            padded = size + (size & 1)
            if padded > self.left():
                raise Refused(f"a {bytes(fourcc)!r} chunk running past the RIFF size")
            if fourcc == b"VP8X":
                raise Refused("a second VP8X chunk")
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if self.anim_chunks > 0 or is_animation:
                    raise Refused(f"a {bytes(fourcc)!r} chunk outside ANMF in an animation")
                self.pos = start
                status = self._single_image()
            elif fourcc == b"ANIM":
                if padded < 6:
                    raise Refused("an ANIM chunk of fewer than 6 bytes")
                self.anim_chunks += 1
                self.pos += padded
            elif fourcc == b"ANMF":
                if self.anim_chunks == 0:
                    raise Refused("an ANMF chunk before ANIM")
                status = self._animation_frame(padded)
            else:  # ICCP, EXIF, XMP and unknown chunks
                self.pos += padded
            if self.pos == self.end:
                break
            if self.left() < 8:
                status = "more"
        return status

    def _animation_frame(self, chunk_size):
        data = self.data
        is_animation = bool(self.flags & ANIMATION_FLAG)
        if chunk_size < 16:
            raise Refused("an ANMF chunk of fewer than 16 bytes")
        payload_size = chunk_size - 16
        frame = _Frame()
        at = self.pos
        frame.x, frame.y = 2 * _u24(data, at), 2 * _u24(data, at + 3)
        frame.width, frame.height = 1 + _u24(data, at + 6), 1 + _u24(data, at + 9)
        if frame.width * frame.height >= MAX_IMAGE_AREA:
            raise Refused(f"an ANMF frame of {frame.width}x{frame.height}")
        self.pos += 16
        start = self.pos
        status = self._store_frame(len(self.frames) + 1, payload_size, frame)
        if self.pos - start > payload_size:
            raise Refused("an ANMF chunk whose frame runs past it")
        if is_animation and frame.number > 0:
            if self.frames and not self.frames[-1].complete:
                raise Refused("a frame after an incomplete one")
            self.frames.append(frame)
        return status

    def _valid_simple(self):
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames:
            raise Refused("a WebP file without an image")
        if self.frames[0].width <= 0 or self.frames[0].height <= 0:
            raise Refused("a WebP image of zero size")

    def _valid_extended(self):
        is_animation = bool(self.flags & ANIMATION_FLAG)
        if not self.frames:
            raise Refused("a WebP file without an image")
        if self.flags & ~ALL_VALID_FLAGS:
            raise Refused(f"VP8X flags {self.flags:#x} with reserved bits set")
        for f in self.frames:
            if not is_animation and f.number > 1:
                raise Refused("a second frame in a file that is not an animation")
            if not f.complete:
                raise Refused("a frame without its image chunk")
            if f.alpha is not None and f.alpha_at > f.image_at:
                raise Refused("an ALPH chunk after its image chunk")
            cw, ch = self.canvas
            if not is_animation:
                inside = (f.x, f.y, f.width, f.height) == (0, 0, cw, ch)
            else:
                inside = f.x + f.width <= cw and f.y + f.height <= ch
            if not inside:
                raise Refused(f"a {f.width}x{f.height} frame at ({f.x}, {f.y}) on a {cw}x{ch} canvas")


def decode_webp(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of WebP bytes: frame 0 on its canvas, in
    PIL's mode ("RGB" or "RGBA")."""
    from gaussian_splatting_torch.utils.image_io import Picture

    if data[:4] != b"RIFF" or data[8:12] != b"WEBP" or data[12:16] not in IMAGE_CHUNKS:
        raise ValueError(f"{name}: not a WebP file (RIFF, WEBP and a VP8, VP8L or VP8X chunk); {SUPPORTED}")
    lib = _library(name)
    try:
        demux = _Demux(data, lib)
    except Refused as err:
        raise ValueError(f"{name}: {err}; {SUPPORTED}") from None
    frame = demux.frames[0]
    width, height = demux.canvas
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    canvas = np.zeros((height, width, 4), np.uint8)
    offset, size, lossless = frame.image
    payload = data[offset:offset + size]
    alpha = None if frame.alpha is None else data[frame.alpha[0]:frame.alpha[0] + frame.alpha[1]]
    at = canvas[frame.y:, frame.x:]
    if lib.gs_webp_decode(payload, len(payload), int(lossless), alpha, 0 if alpha is None else len(alpha),
                          at.ctypes.data, canvas.strides[0]):
        raise ValueError(f"{name}: {lib.gs_webp_error().decode()}; {SUPPORTED}")
    # PIL's mode is WebPGetFeatures' has_alpha over the file: an
    # animation's VP8X flag; else the VP8X flag, or VP8L's header bit in
    # its place, or an ALPH chunk before the image (even one the demuxer
    # drops for want of the flag)
    if demux.flags & ANIMATION_FLAG:
        has_alpha = bool(demux.flags & ALPHA_FLAG)
    else:
        has_alpha = (frame.alpha_bit if lossless else bool(demux.flags & ALPHA_FLAG)) or frame.alph_first
    if has_alpha:
        return Picture(canvas, "RGBA")
    return Picture(np.ascontiguousarray(canvas[..., :3]), "RGB")


def open_webp(path):
    """The `image_io.Picture` of a WebP file."""
    with open(path, "rb") as f:
        return decode_webp(f.read(), str(path))
