"""Percent of their roofline the hand-written kernels reach in the
profiled stretch of the ReadUntil loop: the least time of all their calls
(the bytes each call needs at 3.35 TB/s) over their summed device time."""

from benchmark.metrics.common import roofline


def read(rec):
    return roofline(rec)
