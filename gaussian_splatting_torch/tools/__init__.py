"""Measurement tools of the port: the per-stage profiler and its probe kernels."""
