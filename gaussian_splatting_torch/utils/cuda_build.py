"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Each `csrc/<name>.cu` becomes its own shared library with a plain
`extern "C"` interface, built for Hopper (`sm_90a`) into `build/kernels/`
at the repo root (git-ignored) under a name keyed by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one is reused.
The build uses nothing but the repo's sources and the CUDA toolkit. A
failed build raises; nothing falls back to another implementation.

Each host source `csrc/<name>.cc` (host code, no kernel: the JPEG and
WebP decoders, the BMP / TIFF / GIF byte loops) is built the same way by
the host C++ compiler (`$CXX`, else `c++`; `build_host`, `load_host`).

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


CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def sources() -> list[str]:
    """Names of the kernel sources (`csrc/<name>.cu`)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def host_sources() -> list[str]:
    """Names of the host sources (`csrc/<name>.cc`)."""
    return sorted(p.stem for p in CSRC.glob("*.cc"))


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


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "c++"
    path = shutil.which(cxx)
    if path is None:
        raise RuntimeError(f"host C++ compiler {cxx!r} not found (set CXX or put c++ on PATH)")
    return path


def host_library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in sorted(CSRC.glob("*.h")) + [CSRC / f"{name}.cc"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-host-{h.hexdigest()[:16]}.so"


def _compile(names, path_of, command, suffix) -> dict[str, str]:
    """One compiler process per source not yet built (`path_of(name)`
    missing), all started together; `command(out, source)` is its argv.
    Returns each source's compiler output; raises if any build fails."""
    todo = [name for name in names if not path_of(name).exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in todo:
        out = path_of(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(command(tmp, CSRC / f"{name}{suffix}"), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in running:  # wait for every compiler before raising
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{command(tmp, '')[0]} failed for {name}{suffix} (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: path_of(name).with_suffix(".log").read_text() for name in names}


def build(names=None) -> dict[str, str]:
    """Compile the named sources (default: all), one nvcc per source, all
    started together; sources already built are reused. Returns each
    source's ptxas report. Raises if any build fails."""
    names = sources() if names is None else list(names)
    if any(not library_path(name).exists() for name in names):
        nvcc = _nvcc()  # before starting any process, so a missing nvcc orphans none
    return _compile(names, library_path,
                    lambda out, src: [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)], ".cu")


def build_host(names=None) -> dict[str, str]:
    """Compile the named host sources (default: all) with the host C++
    compiler, as `build` does the kernels. Returns its output per source."""
    names = host_sources() if names is None else list(names)
    if any(not host_library_path(name).exists() for name in names):
        cxx = _cxx()
    return _compile(names, host_library_path,
                    lambda out, src: [cxx, *CXX_FLAGS, "-o", str(out), str(src)], ".cc")


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, building it if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))


@functools.cache
def load_host(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cc`, building it if needed."""
    build_host([name])
    return ctypes.CDLL(str(host_library_path(name)))


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


def occupancy(source: str, function: str, *args: int) -> dict:
    """Call the C query `function` of `csrc/<source>.cu`, which takes `args`
    (C ints) and fills an int[3] with a kernel's registers per thread,
    threads per block and resident blocks per SM (`cudaFuncGetAttributes`,
    `cudaOccupancyMaxActiveBlocksPerMultiprocessor`); raise as `launch`."""
    out = (ctypes.c_int * 3)()
    launch(source, function, (INT,) * len(args) + (PTR,), *args, ctypes.addressof(out))
    return {"registers": out[0], "threads": out[1], "blocks_per_sm": out[2]}
