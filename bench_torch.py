#!/usr/bin/env python3
"""1080p render fps, or train steps per second, of the PyTorch port on one card.

    python3 bench_torch.py                      # render, assets/trained_r5.ply
    GS_BENCH_MODE=train python3 bench_torch.py  # full train steps

The port's counterpart of bench.py, with its GS_BENCH_* variables and its
one JSON line, printed last. gaussian_splatting_torch/cli/bench.py says what
it measures, what it reads and what it leaves out. It runs on the CUDA card
and raises without one; a failed run exits non-zero and prints no number.
"""

import sys

from gaussian_splatting_torch.cli.bench import main

if __name__ == "__main__":
    main(sys.argv[1:])
