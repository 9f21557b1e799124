"""CUDA kernel launches per event step in the profiled stretch of the
ReadUntil loop's engine advances (T steps each)."""

from benchmark.metrics.common import stretch_steps


def read(rec):
    p = rec.get("profile")
    return p["kernels"] / stretch_steps(rec) if p and p["kernels"] else None
