"""Share of the window the ReadUntil loop spent pulling reads from the
benchmark's read feed as the channels started them (its buffer of reads
made before the window; the producer processes once it runs dry): the
benchmark's own cost, inside ``rt_loop.chunks``."""

from benchmark.metrics.common import span_s


def read(rec):
    return span_s(rec, "feed") / rec["window_s"]
