"""Host milliseconds a tick of the ReadUntil loop spends in the engine:
the events popped and advanced (T steps of the pooled engine) and the
readout the decisions wait for (program spans ``realtime.advance`` and
``realtime.readout``), over the program's ``rt_ticks``."""

from benchmark.metrics.common import span_s


def read(rec):
    n = rec.get("counts", {}).get("rt_ticks")
    s = span_s(rec, "realtime.advance", "realtime.readout")
    return 1e3 * s / n if n and s else None
