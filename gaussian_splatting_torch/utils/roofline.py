"""The H100's published peaks and the least time a piece of work can take.

A bound is the larger of two times: the bytes the work must move (each
input read once, each output written once) over the card's memory rate,
and the FP32 operations it does over the card's FP32 rate. `chip_smoke.py`
and `tools/profile_stages.py` hold every kernel and stage to it.
"""

from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# Per taken (pixel, entry) pair (alpha >= 1/255): dx, dy, 5 products and 2
# sums for the quadratic form, the -0.5 scale, the power > 0 test (12 FP32
# ops) and one exp; pairs that blend add more, which this lower bound
# leaves out.
OPS_PER_PAIR = 13
# Per evaluated pair that is not taken: no more than a test against the
# entry's box, where alpha >= 1/255 can hold (dx, dy and two compares).
OPS_PER_CULLED_PAIR = 4
# The backward repeats those per evaluated pair and adds, per blended pair:
# cg = g.rgb (5), w = alpha T (1), prefix += cg w (2), dL/dalpha (5), the
# clamp gate (1), dpower (1), d mean2d (2 x 6), d conic (3 x 4), d opacity
# (2), d rgb (3 x 2): 47 operations.
OPS_PER_BLENDED_BWD = 47


def pair_ops(pairs: int, taken: int) -> int:
    """FP32 operations the blend needs for `pairs` evaluated (pixel, entry)
    pairs of which `taken` pass the 1/255 test."""
    return OPS_PER_PAIR * taken + OPS_PER_CULLED_PAIR * (pairs - taken)


def bound_ms(nbytes, ops):
    """The least time for `nbytes` moved and `ops` FP32 operations at the
    H100's peaks: (ms, what bounds it, a printable line)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_PER_S * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_bytes, t_ops), by, (f"bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f} ms, "
                                      f"operations {t_ops:.4f} ms)")
