"""Share of the window spent deciding: the success and give-up checks of
every channel and the decided reads' PAF records, each of which detects
its whole signal again on the host (program spans ``realtime.decide`` and
``realtime.make_paf``)."""

from benchmark.metrics.common import span_s


def read(rec):
    s = span_s(rec, "realtime.decide", "realtime.make_paf")
    return s / rec["window_s"] if s else None
