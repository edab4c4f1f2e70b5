"""DDS reading that gives PIL's pixels and mode bit for bit.

The JAX package opens its dataset images with PIL; this is the port's
reader of the DirectDraw Surface files PIL 12's DdsImagePlugin reads,
returning an `image_io.Picture` of the first surface (mipmaps, cube faces
and array slices after it are not read, as in PIL):

- `DDPF_RGB` (tested first): "RGBA" where `DDPF_ALPHAPIXELS` is set, else
  "RGB", each channel read through its bit mask as PIL's Python
  `DdsRgbDecoder` reads it: `bitcount // 8` bytes a pixel from byte 128,
  no row pitch, the mask's trailing zeros shifted off and the value
  scaled as `int(v / (mask >> shift) * 255)` in double precision (0 for
  a zero mask), zeros past the end of the data.
- `DDPF_LUMINANCE`: "L" at 8 bits, "LA" at 16 bits with alpha.
- `DDPF_PALETTEINDEXED8`: "P", its palette the 1024 bytes after the
  header as (256, 4) RGBA entries, which `to_rgba` applies with alpha.
- `DDPF_FOURCC`: DXT1, DXT3, DXT5 ("RGBA"), BC4U / ATI1 ("L"), BC5U /
  ATI2 and BC5S ("RGB"), and through the DX10 header BC1-BC5 (TYPELESS /
  UNORM; BC5 SNORM as BC5S), BC6H UF16 and SF16 ("RGB"), BC7 (TYPELESS /
  UNORM / UNORM_SRGB, "RGBA") and R8G8B8A8 (TYPELESS / UNORM /
  UNORM_SRGB, "RGBA", raw). The blocks are decoded by
  `csrc/bcn_decode.cc` (host C++, built by `cuda_build.build_host` at
  first use; no fallback: a failed build raises naming the file).

Where PIL's open of the file fails in a way that passes it on to its next
format (a file that ends inside the header size or the DX10 format, a
size of 0), this raises `image_io.NotThisFormat`; where PIL raises
(another header size, a header cut short, unknown pixel format flags,
FourCC or DXGI format, a luminance bit count other than 8 or 16 with
alpha, image data cut short except in the uncompressed RGB forms) it
raises a `ValueError` naming the file and the field.
"""

from __future__ import annotations

import ctypes

import numpy as np

from gaussian_splatting_torch.utils import cuda_build
from gaussian_splatting_torch.utils.bmp import MAX_PIXELS

SIGNATURE = b"DDS "
HEADER = 128  # "DDS ", then the 124-byte header
ALPHAPIXELS, FOURCC, PALETTEINDEXED8, RGB, LUMINANCE = 0x1, 0x4, 0x20, 0x40, 0x20000

# FourCC -> (mode, PIL's bcn decoder number, signed)
FOURCCS = {b"DXT1": ("RGBA", 1, False), b"DXT3": ("RGBA", 2, False), b"DXT5": ("RGBA", 3, False),
           b"BC4U": ("L", 4, False), b"ATI1": ("L", 4, False), b"BC5S": ("RGB", 5, True),
           b"BC5U": ("RGB", 5, False), b"ATI2": ("RGB", 5, False)}
# DXGI format -> (mode, decoder number (0: raw), signed)
DXGI = {70: ("RGBA", 1, False), 71: ("RGBA", 1, False), 73: ("RGBA", 2, False), 74: ("RGBA", 2, False),
        76: ("RGBA", 3, False), 77: ("RGBA", 3, False), 79: ("L", 4, False), 80: ("L", 4, False),
        82: ("RGB", 5, False), 83: ("RGB", 5, False), 84: ("RGB", 5, True), 95: ("RGB", 6, False),
        96: ("RGB", 6, True), 97: ("RGBA", 7, False), 98: ("RGBA", 7, False), 99: ("RGBA", 7, False),
        27: ("RGBA", 0, False), 28: ("RGBA", 0, False), 29: ("RGBA", 0, False)}
CHANNELS = {"L": 1, "LA": 2, "P": 1, "RGB": 3, "RGBA": 4}


def _u32(data: bytes, at: int) -> int:
    return int.from_bytes(data[at:at + 4], "little")


def decode_dds(data: bytes, name: str = "<bytes>"):
    """The `image_io.Picture` of DDS bytes."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat, Picture

    if len(data) < 8:
        raise NotThisFormat(f"{name}: a DDS header size cut short (PIL: struct.error, passed on)")
    size = _u32(data, 4)
    if size != 124:
        raise ValueError(f"{name}: a DDS header size of {size} (PIL: Unsupported header size)")
    if len(data) < HEADER:
        raise ValueError(f"{name}: a DDS header of {len(data) - 8} of its 120 bytes (PIL: Incomplete header)")
    height, width = _u32(data, 12), _u32(data, 16)
    flags, fourcc, bitcount = _u32(data, 80), data[84:88], _u32(data, 88)
    start, palette, n, signed = HEADER, None, 0, False
    if flags & RGB:
        mode = "RGBA" if flags & ALPHAPIXELS else "RGB"
        masks = [_u32(data, 92 + 4 * i) for i in range(len(mode))]
    elif flags & LUMINANCE:
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and flags & ALPHAPIXELS:
            mode = "LA"
        else:
            raise ValueError(f"{name}: a DDS luminance bit count of {bitcount} with pixel format flags {flags} "
                             f"(PIL: Unsupported bitcount)")
    elif flags & PALETTEINDEXED8:
        mode, start = "P", HEADER + 1024
        entries = data[HEADER:start]
        palette = np.frombuffer(entries[:len(entries) // 4 * 4], np.uint8).reshape(-1, 4)
    elif flags & FOURCC:
        if fourcc in FOURCCS:
            mode, n, signed = FOURCCS[fourcc]
        elif fourcc == b"DX10":
            if len(data) < HEADER + 4:
                raise NotThisFormat(f"{name}: a DDS DX10 header cut short (PIL: struct.error, passed on)")
            dxgi, start = _u32(data, HEADER), HEADER + 20
            if dxgi not in DXGI:
                raise ValueError(f"{name}: DDS DXGI format {dxgi} (PIL: Unimplemented DXGI format)")
            mode, n, signed = DXGI[dxgi]
        else:
            raise ValueError(f"{name}: DDS pixel format {fourcc!r} (PIL: Unimplemented pixel format)")
    else:
        raise ValueError(f"{name}: DDS pixel format flags {flags} (PIL: Unknown pixel format flags)")
    if width <= 0 or height <= 0:
        raise NotThisFormat(f"{name}: a DDS image of {width}x{height} pixels (PIL: an empty size, passed on)")
    if width * height > MAX_PIXELS:
        raise ValueError(f"{name}: an image of more than {MAX_PIXELS} pixels (PIL's decompression bomb limit)")
    if flags & RGB:
        return Picture(_masked(data, width, height, bitcount // 8, masks), mode)
    if n:
        return Picture(bcn_decode(data[start:], n, signed, width, height, name), mode)
    need = width * height * CHANNELS[mode]
    body = data[start:start + need]
    if len(body) < need:
        raise ValueError(f"{name}: DDS image data of {len(body)} of its {need} bytes (PIL: image file is truncated)")
    return Picture(np.frombuffer(body, np.uint8).reshape(height, width, CHANNELS[mode]), mode, palette)


def _masked(data: bytes, width: int, height: int, step: int, masks) -> np.ndarray:
    """(height, width, len(masks)) uint8: PIL's DdsRgbDecoder. A pixel is
    the little-endian value of its `step` bytes from byte HEADER (bytes
    past the end read as 0; the masks are 32-bit, so only its first four
    bytes count), each channel its masked bits scaled to 8 bits."""
    count, first = width * height, min(step, 4)
    if len(data) >= HEADER + count * step:
        raw = np.frombuffer(data, np.uint8, count * step, HEADER).reshape(count, step)[:, :first]
    else:  # the data ends early: each pixel's bytes past the end read as 0
        at = HEADER + np.arange(count, dtype=np.int64)[:, None] * step + np.arange(first)
        whole = np.frombuffer(data, np.uint8)
        raw = np.where(at < whole.size, whole[np.minimum(at, whole.size - 1)], 0)
    value = np.zeros(count, np.uint64)
    for k in range(first):
        value |= raw[:, k].astype(np.uint64) << np.uint64(8 * k)
    out = np.zeros((count, len(masks)), np.uint8)
    for i, mask in enumerate(masks):
        if mask == 0:
            continue
        shift = (mask & -mask).bit_length() - 1  # PIL's loop: the mask's trailing zeros
        total = mask >> shift
        bits = (value & np.uint64(mask)) >> np.uint64(shift)
        out[:, i] = np.trunc(bits.astype(np.float64) / total * 255).astype(np.uint8)
    return out.reshape(height, width, len(masks))


def _library(name: str):
    try:
        lib = cuda_build.load_host("bcn_decode")
    except RuntimeError as err:
        raise RuntimeError(f"{name}: the DDS block decoder (csrc/bcn_decode.cc) could not be built: {err}") from err
    if not hasattr(lib, "_gs_typed"):
        L = ctypes.c_longlong
        lib.gs_bcn_decode.argtypes = [ctypes.c_char_p, L, ctypes.c_int, ctypes.c_int, L, L, ctypes.c_void_p]
        lib.gs_bcn_decode.restype = ctypes.c_int
        lib._gs_typed = True
    return lib


def bcn_decode(body: bytes, n: int, signed: bool, width: int, height: int, name: str) -> np.ndarray:
    """(height, width, channels) uint8: the 4x4 blocks of PIL's bcn decoder
    `n` (1 BC1, 2 BC2, 3 BC3, 4 BC4, 5 BC5, 6 BC6H, 7 BC7) in `body`, as
    `csrc/bcn_decode.cc` decodes them; raises a `ValueError` naming `name`
    where `body` holds fewer blocks than the image (PIL: image file is
    truncated)."""
    blocks = ((width + 3) // 4) * ((height + 3) // 4)
    need = blocks * (8 if n in (1, 4) else 16)
    if len(body) < need:
        raise ValueError(f"{name}: DDS block data of {len(body)} of its {need} bytes (PIL: image file is truncated)")
    lib = _library(name)
    out = np.empty((height, width, {4: 1, 5: 3, 6: 3}.get(n, 4)), np.uint8)
    if lib.gs_bcn_decode(body, need, n, int(signed), width, height, out.ctypes.data):
        raise ValueError(f"{name}: DDS block data cut short")
    return out
