"""EPS reading as PIL reads it: PIL's parse of the header, then Ghostscript.

The JAX package opens its dataset images with PIL, whose EpsImagePlugin
parses an Encapsulated PostScript file's comments for its size and then
rasterises it with Ghostscript (`gs`). This is the port's copy of that:

- `_open`'s parse (`parse`): "%!PS", or a DOS EPS binary header
  (0xC6D3D0C5) whose PostScript offset it starts from; lines of at most
  255 bytes ending at CR or LF, read into PIL's one 255-byte buffer (whose
  stale bytes its prefix tests see); the header comments up to
  %%EndComments or a line that is not a comment (%!PS-Adobe and
  %%BoundingBox required there), the first %%BoundingBox, or the last
  after %%Trailer where the first was "(atend)"; an %ImageData line's
  columns and rows, which take precedence; %%BeginBinary skipped; %%EOF.
- The picture (`open_eps`): where `gs --version` runs, `gs` with the
  arguments PIL's `Ghostscript` builds (the size, the resolution from it
  and the bounding box, "pnmraw", -dSAFER, the bounding box's translate,
  the file, `showpage`), its output read by the port's PNM reader
  (`utils/ppm.py`): PIL's mode and pixels of it. Where there is no `gs`,
  it raises, as PIL does ("Unable to locate Ghostscript on paths").

No PostScript is interpreted here and no picture is made up.

A head PIL's parse rejects in a way that passes the file on raises
`image_io.NotThisFormat`; a bad header comment, no bounding box, a
number PIL cannot read, no Ghostscript or a Ghostscript that fails raise a
`ValueError` naming the file.
"""

from __future__ import annotations

import os
import re
import struct
import subprocess
import tempfile

DOS_MAGIC = 0xC6D3D0C5
SPLIT = re.compile(r"^%%([^:]*):[ \t]*(.*)[ \t]*$")
FIELD = re.compile(r"^%[%!\w]([^:]*)[ \t]*$")
MODES = {1: "L", 2: "LAB", 3: "RGB", 4: "CMYK"}


def accepts(head: bytes) -> bool:
    """EpsImagePlugin._accept: "%!PS" or the DOS EPS magic."""
    return head.startswith(b"%!PS") or (len(head) >= 4 and struct.unpack_from("<I", head)[0] == DOS_MAGIC)


def _refuse(name, what: str):
    raise ValueError(f"{name}: {what}; the port reads EPS files as PIL does, through Ghostscript")


def parse(data: bytes, name: str = "<bytes>"):
    """PIL's EpsImageFile._open: ((width, height), bounding box)."""
    from gaussian_splatting_torch.utils.image_io import NotThisFormat

    def passed(why):
        raise NotThisFormat(f"{name}: {why} (PIL: passed on)")

    if data[:4] == b"%!PS":
        pos = 0
    elif len(data) >= 4 and struct.unpack_from("<I", data)[0] == DOS_MAGIC:
        if len(data) < 12:
            passed("a DOS EPS header cut short")
        pos = struct.unpack_from("<I", data, 4)[0]
    else:
        passed("not an EPS file")
    info, bbox, size = {}, None, None
    buf, n = bytearray(255), 0
    header, trailer, trailer_reached = True, False, False

    def check_header():
        if "PS-Adobe" not in info:
            passed('an EPS header without "%!PS-Adobe"')
        if "BoundingBox" not in info:
            passed('an EPS header without "%%BoundingBox"')

    def comment(s: str) -> bool:
        nonlocal bbox, trailer
        m = SPLIT.match(s)
        if not m:
            return False
        k, v = m.group(1, 2)
        info[k] = v
        if k == "BoundingBox":
            if v == "(atend)":
                trailer = True
            elif not bbox or (trailer_reached and trailer):
                try:
                    bbox = [int(float(i)) for i in v.split()]
                except Exception:  # noqa: BLE001  (PIL passes over any fault here)
                    pass
        return True

    while True:
        byte = data[pos:pos + 1]
        pos += len(byte)
        if byte == b"":
            if n == 0:
                if header:
                    check_header()
                break
        elif byte in b"\r\n":
            if n == 0:
                continue
        else:
            if n >= 255:
                if buf[0] == ord("%"):
                    passed("an EPS comment line of more than 255 bytes")
                if header:
                    check_header()
                    header = False
                n = 0
            buf[n] = byte[0]
            n += 1
            continue
        line = bytes(buf[:n])
        if header:
            if buf[0] != ord("%") or buf[:13] == b"%%EndComments":
                check_header()
                header = False
                continue
            s = line.decode("latin-1")
            if not comment(s):
                m = FIELD.match(s)
                if m:
                    k = m.group(1)
                    info["PS-Adobe" if k.startswith("PS-Adobe") else k] = k[9:] if k.startswith("PS-Adobe") else ""
                elif s[0] != "%":
                    _refuse(name, "a bad EPS header line (PIL: bad EPS header)")
        elif buf[:11] == b"%ImageData:":
            if size:
                n = 0
                continue
            values = bytes(buf[11:n]).split(None, 7)
            try:
                columns, rows, depth, mode_id = (int(v) for v in values[:4])
            except ValueError:
                _refuse(name, f"an %ImageData line PIL cannot read ({line!r})")
            if depth == 1 or (depth == 8 and mode_id in MODES):
                size = columns, rows
            elif depth == 8:
                passed(f"an %ImageData mode of {mode_id} (KeyError)")
            else:
                break
        elif buf[:5] == b"%%EOF":
            break
        elif trailer_reached and trailer:
            comment(line.decode("latin-1"))
        elif buf[:9] == b"%%Trailer":
            trailer_reached = True
        elif buf[:14] == b"%%BeginBinary:":
            try:
                pos += int(bytes(buf[14:n]))
            except ValueError:
                _refuse(name, f"a %%BeginBinary count PIL cannot read ({line!r})")
            if pos < 0:
                _refuse(name, "a %%BeginBinary count before the file's start (PIL: negative seek)")
        n = 0
    if not bbox:
        _refuse(name, "no EPS bounding box (PIL: cannot determine EPS bounding box)")
    if size is None:
        if len(bbox) < 4:
            passed("an EPS bounding box of fewer than 4 numbers (IndexError)")
        size = bbox[2] - bbox[0], bbox[3] - bbox[1]
    if size[0] <= 0 or size[1] <= 0:
        passed(f"an EPS image of {size[0]}x{size[1]} pixels (an empty size)")
    return size, bbox


def ghostscript_argv(gs: str, size, bbox, infile: str, outfile: str) -> list:
    """The command PIL's `Ghostscript` runs (scale 1, no transparency)."""
    width, height = size
    res_x = 72.0 * width / (bbox[2] - bbox[0])
    res_y = 72.0 * height / (bbox[3] - bbox[1])
    return [gs, "-q", f"-g{width:d}x{height:d}", f"-r{res_x:f}x{res_y:f}", "-dBATCH", "-dNOPAUSE", "-dSAFER",
            "-sDEVICE=pnmraw", f"-sOutputFile={outfile}", "-c", f"{-bbox[0]} {-bbox[1]} translate", "-f", infile,
            "-c", "showpage"]


def has_ghostscript() -> bool:
    """PIL's `has_ghostscript` on this machine: `gs --version` runs."""
    try:
        subprocess.check_call(["gs", "--version"], stdout=subprocess.DEVNULL)
    except OSError:
        return False
    return True


def open_eps(path):
    """The `image_io.Picture` of an EPS file: PIL's parse, then the picture
    Ghostscript draws of it at that size, as PIL loads it."""
    from gaussian_splatting_torch.utils import ppm

    with open(path, "rb") as f:
        data = f.read()
    size, bbox = parse(data, str(path))
    if not has_ghostscript():
        _refuse(path, "no Ghostscript (PIL: Unable to locate Ghostscript on paths)")
    if len(bbox) < 4:
        _refuse(path, f"an EPS bounding box of {len(bbox)} numbers beside an %ImageData size (PIL: IndexError)")
    if bbox[2] == bbox[0] or bbox[3] == bbox[1]:
        _refuse(path, f"an EPS bounding box of no width or height, {bbox} (PIL: division by zero)")
    fd, outfile = tempfile.mkstemp()
    os.close(fd)
    try:
        try:
            subprocess.check_call(ghostscript_argv("gs", size, bbox, os.fspath(path), outfile))
        except subprocess.CalledProcessError as err:
            _refuse(path, f"Ghostscript failed ({err})")
        with open(outfile, "rb") as f:
            return ppm.decode_ppm(f.read(), f"{path} (Ghostscript's output)")
    finally:
        os.unlink(outfile)
