"""Host milliseconds in the engine per event step: the benchmark's spans around PooledEngine.advance, readout_start and readout_get (the readout waits for the device), over the event steps dispatched in the window."""

from benchmark.metrics.common import span_s, window_steps


def read(rec):
    steps = window_steps(rec)
    if not steps:
        return None
    return 1e3 * span_s(rec, "advance", "readout_issue",
                        "readout_wait") / steps
