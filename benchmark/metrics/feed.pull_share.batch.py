"""Share of the window the mapper spent pulling reads from the
benchmark's read feed (its buffer of reads made before the window; the
producer process once the buffer runs dry): the benchmark's own cost,
inside ``host_loop.refill_share.batch``."""

from benchmark.metrics.common import span_s


def read(rec):
    return span_s(rec, "feed") / rec["window_s"]
