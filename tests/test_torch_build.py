"""The kernel build (`utils/cuda_build.py`) with a stand-in nvcc.

The real nvcc exists only on the card's machine; here a small script on
PATH plays it, so the orchestration (one process per source, reuse of a
built library, a failed build raising with nvcc's output) is tested on
the CPU.
"""

import os
import stat

import pytest

from gaussian_splatting_torch.utils import cuda_build

FAKE_NVCC = """#!/bin/sh
# stand-in nvcc: write the -o target, report like ptxas, count the calls
echo call >> "{calls}"
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo "ptxas info    : Used 42 registers"
[ "{fail}" = "1" ] && {{ echo "error: bad source"; exit 2; }}
: > "$out"
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    def install(fail=False):
        bindir = tmp_path / "bin"
        bindir.mkdir(exist_ok=True)
        nvcc = bindir / "nvcc"
        nvcc.write_text(FAKE_NVCC.format(calls=tmp_path / "calls", fail=int(fail)))
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
        monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
        return tmp_path / "calls"

    return install


def test_builds_each_source_once_and_reuses_it(fake_nvcc):
    calls = fake_nvcc()
    names = ["composite_bwd", "composite_fwd", "route_grads"]
    assert cuda_build.sources() == names
    logs = cuda_build.build()
    assert sorted(logs) == names
    assert "Used 42 registers" in logs["composite_bwd"]
    for name in names:
        path = cuda_build.library_path(name)
        assert path.exists() and path.parent == cuda_build.BUILD_DIR
    assert not list(cuda_build.BUILD_DIR.glob("*.tmp.so"))
    cuda_build.build()  # already built: no second nvcc
    assert calls.read_text().count("call") == len(names)


def test_failed_build_raises_with_the_log(fake_nvcc):
    fake_nvcc(fail=True)
    with pytest.raises(RuntimeError, match="bad source"):
        cuda_build.build(["composite_fwd"])
    assert not cuda_build.library_path("composite_fwd").exists()


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build()


def test_shared_header_is_part_of_every_key(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in cuda_build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    before = {name: cuda_build.library_path(name) for name in cuda_build.sources()}
    with open(csrc / "blend.cuh", "a") as f:
        f.write("// changed\n")
    after = {name: cuda_build.library_path(name) for name in cuda_build.sources()}
    assert all(before[name] != after[name] for name in before)
