"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain
`extern "C"` interface, built for Hopper (`sm_90a`) into `build/kernels/`
at the repo root (git-ignored) under a name keyed by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one is reused.
The build uses nothing but the repo's sources and the CUDA toolkit. A
failed build raises; nothing falls back to another implementation.

`nvcc -Xptxas -v` reports each kernel's registers, shared memory and
spills; the report is kept beside the library (`<library>.log`) and
returned by `build`.

Every entry point returns a cudaError_t; `launch` calls one and raises on
anything but 0, with the library's `gs_error_string`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def sources() -> list[str]:
    """Names of the kernel sources (`csrc/<name>.cu`)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile the named sources (default: all), one nvcc per source, all
    started together; sources already built are reused. Returns each
    source's ptxas report. Raises if any build fails."""
    names = sources() if names is None else list(names)
    todo = [name for name in names if not library_path(name).exists()]
    if todo:
        nvcc = _nvcc()  # before starting any process, so a missing nvcc orphans none
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:  # wait for every nvcc before raising
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name).with_suffix(".log").read_text() for name in names}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, building it if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


# ctypes argument types: device pointers and streams, C ints, C long longs.
PTR, INT, LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.cache
def _entry(source: str, function: str, argtypes: tuple):
    lib = load(source)
    fn = getattr(lib, function)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    lib.gs_error_string.argtypes = [ctypes.c_int]
    lib.gs_error_string.restype = ctypes.c_char_p
    return fn, lib.gs_error_string


def launch(source: str, function: str, argtypes: tuple, *args) -> None:
    """Call the C entry point `function` of `csrc/<source>.cu` (built at
    first use) with `args` typed as `argtypes`; raise if it returns a
    cudaError_t other than 0."""
    fn, err_str = _entry(source, function, argtypes)
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{function} kernel launch failed: {err_str(err).decode()} ({err})")
