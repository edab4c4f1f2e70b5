"""3D Gaussian Splatting in PyTorch with hand-written CUDA kernels for Hopper.

The port of `gaussian_splatting_tpu` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100. It mirrors that package's module names; each Pallas kernel
becomes a CUDA C++ kernel under `csrc/`, built with nvcc at first use,
beside a plain torch version of the same function. It imports no JAX and
nothing of the JAX package, which stays as the reference the tests hold
this package to.

Ported so far: the render path (PLY model -> `activate` -> `rasterize`:
preprocess, tile binning, the compositing kernel) and the train step
(`init_train_state` -> `train_step`: render, L1 + SSIM loss, the
compositing backward and gradient-routing kernels, masked Adam, the
densification statistics), the host training loop from a point cloud
(`create_from_pcd` with its KNN -> `Trainer`: camera sampling, SH warm-up,
the entry-capacity probe and growth, densification on the device or the
host, opacity reset, checkpoints), the per-stage profiler
(`python -m gaussian_splatting_torch.tools.profile_stages`) with the JAX
tool's probe kernels: the transpose (`ops/relayout.py`) and the column
sums (`tools/consumers.py`), and the user's entry path: scene IO
(`scene/colmap.py`, `scene/dataset_readers.py`, `scene/scene.py`, PNG
and JPEG reading (PIL's pixels; the JPEG decoder is host C++,
`csrc/jpeg_decode.cc`, beside its plain version `utils/jpeg.py`), PNG
writing and PIL's resize in `utils/image_io.py`), the flag
groups (`config.py`), the CLIs (`python -m gaussian_splatting_torch.cli.
{train,render,metrics,full_eval,convert}`), the bench (`cli/bench.py`,
run as the repo root's `bench_torch.py`: the port's `bench.py`) and the
live-viewer bridge
(`viewer/network_gui.py`), LPIPS (`ops/lpips.py`, in the metrics CLI), and
training on several devices (`parallel/sharding.py` on torch.distributed:
Gaussian rows sharded over the ranks, each rank's strip of tile rows
composited at its row origin; `Trainer(mesh=...)`).
"""

__version__ = "0.1.0"

from gaussian_splatting_torch.ops.rasterize import RasterizerConfig, mark_visible, rasterize  # noqa: F401
from gaussian_splatting_torch.scene.cameras import Camera  # noqa: F401
from gaussian_splatting_torch.scene.gaussians import create_from_pcd  # noqa: F401
from gaussian_splatting_torch.trainer import Trainer  # noqa: F401
from gaussian_splatting_torch.training import (  # noqa: F401
    OptimizationConfig, TrainState, eval_render, init_train_state, train_step,
)
