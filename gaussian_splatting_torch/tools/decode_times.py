"""Time the port's image reader on files: `image_io.open_image`, the median
of `--repeat` calls a file after one untimed call (which builds the host
decoders at first use), for the port package found in `--tree` (default:
the one this file is in). Two trees' readers compare on one machine by
running this once for each, in one session.

    python gaussian_splatting_torch/tools/decode_times.py [--tree DIR] [--repeat N] FILE...

Prints one JSON line: {"tree": DIR, "ms": {file: median ms, or the error
the reader raised}, "host": the platform's processor name}.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                        help="the directory holding the gaussian_splatting_torch package to time")
    parser.add_argument("--repeat", type=int, default=5)
    parser.add_argument("files", nargs="+")
    args = parser.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from gaussian_splatting_torch.utils import image_io

    if not image_io.__file__.startswith(tree):
        raise SystemExit(f"imported {image_io.__file__}, not the package in {tree}")
    ms = {}
    for path in args.files:
        try:
            image_io.open_image(path)
        except ValueError as err:
            ms[os.path.basename(path)] = f"raises: {str(err)[:120]}"
            continue
        times = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            image_io.open_image(path)
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        ms[os.path.basename(path)] = times[len(times) // 2]
    out = {"tree": args.tree, "ms": ms, "host": platform.processor() or platform.machine()}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
