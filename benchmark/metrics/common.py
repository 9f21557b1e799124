"""Arithmetic the per-layer metric readers share.  A reader's ``rec`` is
its driver's record of the window: ``window_s``, the entry mapper's
``B`` and ``T``, the program's counters and the benchmark's spans summed
over the window, and with ``--trace 1`` the profiled stretch
(``harness/profile.py``)."""

from __future__ import annotations

from benchmark.roofline.bytes import HBM_BYTES_PER_S
from benchmark.roofline.kernels import FAMILIES


def window_steps(rec):
    """Event steps the window dispatched (B * T slot-events a block)."""
    d = rec["counters"]["disp_events"]
    return d / rec["B"] if d else None


def stretch_steps(rec):
    p = rec.get("profile")
    return p["calls"] * rec["T"] if p else None


def span_s(rec, *names) -> float:
    return sum(rec["spans"].get(n, {}).get("seconds", 0.0) for n in names)


def roofline(rec):
    """Percent: the least time the hand-written kernels' calls in the
    stretch need (their bytes at the HBM rate) over their device time;
    None where a family launched there has no byte count or no device
    time."""
    p = rec.get("profile")
    if not p:
        return None
    fams = [f for f in FAMILIES if p["family_launches"].get(f)]
    if not fams or any(f not in p["family_bytes"] or not p["family_s"].get(f)
                       for f in fams):
        return None
    least = sum(p["family_bytes"][f] for f in fams) / HBM_BYTES_PER_S
    return 100.0 * least / sum(p["family_s"][f] for f in fams)
