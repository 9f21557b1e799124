"""CUDA kernel launches in the profiled stretch per event step."""

from benchmark.metrics.common import stretch_steps


def read(rec):
    p = rec.get("profile")
    return p["kernels"] / stretch_steps(rec) if p and p["kernels"] else None
