"""Device milliseconds of kernels, copies and memsets per event step in
the profiled stretch of the ReadUntil loop's engine advances (summed, not
their union)."""

from benchmark.metrics.common import stretch_steps


def read(rec):
    p = rec.get("profile")
    return 1e3 * p["device_s"] / stretch_steps(rec) if p and p["device_s"] \
        else None
