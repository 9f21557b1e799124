"""Share of the window in the mapper's ``add_chunks``: chunks routed to
their channels, new reads' slot resets, and the streaming event detection,
stall profile and normalisation of each chunk (program span
``realtime.add_chunks``)."""

from benchmark.metrics.common import span_s


def read(rec):
    s = span_s(rec, "realtime.add_chunks")
    return s / rec["window_s"] if s else None
