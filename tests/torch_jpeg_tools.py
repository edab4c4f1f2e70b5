"""libjpeg-turbo's own encoder for the tests of arithmetic-coded and lossless
JPEG (tests/test_torch_jpeg_arith.py, tests/test_torch_jpeg_lossless.py)
and for tests/fixtures/torch_jpeg_arith/make_fixtures.py: PIL writes
neither form, but the libjpeg-turbo 3 it bundles has both encoders.

`writer()` builds tests/fixtures/torch_jpeg_arith/jpeg_writer.c with `cc`
against the system's jpeglib.h, linked to PIL's bundled libjpeg-turbo, into
build/jpeg_writer/ (once per source and library); `missing()` says why it
cannot (no compiler, no header, no bundled library with the arithmetic and
lossless codecs), for a skip. `arith` transcodes a JPEG's coefficients to
arithmetic coding (SOF9, or SOF10 for a progressive file), as
`jpegtran -arithmetic` does; `lossless` writes SOF3 as `cjpeg -lossless`
does (libjpeg-turbo's encoder samples every component 1x1 there:
tests/torch_image_writers.py's `lossless_jpeg` writes the other forms).
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "tests", "fixtures", "torch_jpeg_arith", "jpeg_writer.c")
OUT_DIR = os.path.join(ROOT, "build", "jpeg_writer")


def pil_libjpeg():
    """PIL's bundled libjpeg-turbo, or None."""
    import PIL

    libs = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir, "pillow.libs", "libjpeg*.so*"))
    return os.path.realpath(libs[0]) if libs else None


def missing():
    """Why the writer cannot be built here, or None."""
    if shutil.which("cc") is None:
        return "no C compiler (cc) to build the JPEG writer"
    lib = pil_libjpeg()
    if lib is None:
        return "PIL bundles no libjpeg-turbo to link the JPEG writer to"
    so = ctypes.CDLL(lib)
    if not all(hasattr(so, f) for f in ("jinit_arith_encoder", "jpeg_enable_lossless")):
        return "PIL's libjpeg-turbo has no arithmetic or lossless encoder"
    probe = subprocess.run(["cc", "-E", "-x", "c", "-"], input=b"#include <stdio.h>\n#include <jpeglib.h>\n",
                           capture_output=True)
    if probe.returncode:
        return "no jpeglib.h to build the JPEG writer against"
    return None


def writer() -> str:
    """The built writer's path (building it if needed)."""
    lib = pil_libjpeg()
    with open(SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + lib.encode()).hexdigest()[:16]
    exe = os.path.join(OUT_DIR, f"jpeg_writer-{key}")
    if not os.path.exists(exe):
        os.makedirs(OUT_DIR, exist_ok=True)
        tmp = f"{exe}.{os.getpid()}.tmp"
        d = os.path.dirname(lib)
        subprocess.run(["cc", "-O2", "-o", tmp, SOURCE, f"-L{d}", f"-l:{os.path.basename(lib)}",
                        f"-Wl,-rpath,{d}"], check=True)
        os.replace(tmp, exe)  # atomic: parallel test workers may build at once
    return exe


def _run(args, data: bytes) -> bytes:
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in"), os.path.join(tmp, "out.jpg")
        with open(src, "wb") as f:
            f.write(data)
        subprocess.run([writer(), args[0], src, dst, *args[1:]], check=True)
        with open(dst, "rb") as f:
            return f.read()


def arith(jpeg: bytes, rows=0, mcus=0, L=0, U=1, K=5) -> bytes:
    """`jpeg`'s coefficients arithmetic-coded (progressive where it is), a
    restart marker every `rows` MCU rows or `mcus` MCUs, each table's DAC
    conditioning L, U (DC) and K (AC)."""
    return _run(["arith", f"rows={rows}", f"mcus={mcus}", f"L={L}", f"U={U}", f"K={K}"], jpeg)


def lossless(pixels, psv=1, pt=0, rows=0, colour=None, one_component_scans=False, psvs=None) -> bytes:
    """libjpeg-turbo's lossless JPEG of (H, W, C) uint8 `pixels` (C 1, 3 or
    4): predictor `psv`, point transform `pt`, a restart every `rows` MCU
    rows; `colour` "rgb" (an Adobe marker) or "ycc" (the samples taken as
    Y, Cb, Cr, under a JFIF marker); one scan per component, predictors
    `psvs`, where asked."""
    a = np.ascontiguousarray(pixels, np.uint8)
    a = a[..., None] if a.ndim == 2 else a
    h, w, c = a.shape
    args = ["lossless", str(w), str(h), str(c), f"psv={psv}", f"pt={pt}", f"rows={rows}"]
    if colour:
        args.append(f"colour={colour}")
    if one_component_scans:
        args.append("scans=one")
    if psvs:
        args.append("psvs=" + ",".join(map(str, psvs)))
    return _run(args, a.tobytes())
