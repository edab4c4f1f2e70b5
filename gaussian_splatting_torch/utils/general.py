"""General utilities: deterministic seeding, timestamped stdout, fs helpers.

The counterpart of `gaussian_splatting_tpu/utils/general.py` (itself the
reference's utils/general_utils.py:152-173 and utils/system_utils.py).
That module's `enable_compilation_cache` configures JAX's persistent
compilation cache and has no counterpart here: the port's kernels are
compiled once per source into `build/kernels/` by `utils/cuda_build.py`,
which plays that part.
"""

from __future__ import annotations

import os
import random
import sys
from datetime import datetime

import numpy as np
import torch


def safe_state(silent: bool = False, seed: int = 0):
    """Seed Python's, numpy's and torch's RNGs and wrap stdout with
    timestamps; with `silent` the wrapper drops everything
    (general_utils.py:152-173). `sys.stdout` stays replaced: an
    in-process caller restores it."""
    old_f = sys.stdout

    class F:
        def __init__(self, silent):
            self.silent = silent

        def write(self, x):
            if not self.silent:
                if x.endswith("\n"):
                    ts = datetime.now().strftime("%d/%m %H:%M:%S")
                    old_f.write(x.replace("\n", f" [{ts}]\n"))
                else:
                    old_f.write(x)

        def flush(self):
            old_f.flush()

    sys.stdout = F(silent)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def mkdir_p(path: str):
    os.makedirs(path, exist_ok=True)


def search_for_max_iteration(folder: str) -> int:
    """The largest N of the `iteration_N` entries in `folder`."""
    return max(int(fname.split("_")[-1]) for fname in os.listdir(folder))
