"""The profiled stretch of a traced run, and what its trace says.

A stretch is ``calls`` consecutive calls of one span (the engine's
advance: ``calls`` blocks of the host loop), starting at the first such
call after ``start_at``.  It synchronises the card at both ends and
records ``torch.profiler``'s device activity only (kernels, copies,
memsets and the CUDA runtime calls; no host operators, which would slow
the host loop it measures).  The benchmark's spans keep their host
intervals meanwhile; a ``cudaDeviceSynchronize`` at the start, timed on
the host's clock, puts them on the trace's, so each device idle gap is
labelled by the host span it fell in.  Each hand-written kernel call's
bytes are counted from its arguments: from their shapes at the call,
and from the indices it keeps (a gather's distinct rows) once the
stretch is over, when the kept tensors are let go again.
"""

from __future__ import annotations

import json
import os
import sys
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_union(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, t_lo, t_hi):
    """(start, length) of each gap in [t_lo, t_hi] that no interval
    covers."""
    gaps, at = [], t_lo
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, s - at))
        at = max(at, e)
    if t_hi > at:
        gaps.append((at, t_hi - at))
    return gaps


def label_of(t, spans) -> str:
    """The host span (name, start, end) that holds time t, innermost
    (latest start) first; "host loop" outside every span."""
    best = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or s > best[1]):
            best = (name, s, e)
    return best[0] if best else "host loop"


def sync_offset_us(evs, t_a: float, t_b: float):
    """The trace's clock minus the host's (microseconds): the first
    ``cudaDeviceSynchronize`` in the trace is the one timed on the host
    from ``t_a`` to ``t_b`` (seconds); their midpoints are matched.  None
    where the trace has no such call."""
    for e in sorted(evs, key=lambda e: float(e.get("ts", 0))):
        if "cudaDeviceSynchronize" in str(e.get("name", "")) and "dur" in e:
            mid = float(e["ts"]) + float(e["dur"]) / 2
            return mid - (t_a + t_b) / 2 * 1e6
    return None


def summarize(evs, wall_s: float, family_of, spans=()) -> dict:
    """The numbers a stretch's chrome-trace events give: device busy time
    (union) and summed time, kernel launches, device time by hand-written
    family, the top device operations and the idle gaps by host span
    (``spans``: (name, start, end) on the trace's clock)."""
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    spans = list(spans)
    iv = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
          for e in dev]
    by_name, by_family = {}, {}
    for e in dev:
        name = e.get("name", "?")
        d = float(e.get("dur", 0)) * 1e-6
        by_name[name] = by_name.get(name, 0.0) + d
        if e.get("cat") == "kernel":
            fam = family_of(name)
            if fam:
                by_family[fam] = by_family.get(fam, 0.0) + d
    t_lo = min((s for s, _ in iv), default=0.0)
    t_hi = max((e for _, e in iv), default=0.0)
    if spans:  # the stretch's host extent, where the trace has it
        t_lo = min(t_lo, min(s for _, s, _ in spans))
        t_hi = max(t_hi, max(e for _, _, e in spans))
    gaps = {}
    edges = sorted({t for _, s, e in spans for t in (s, e)})
    for at, ln in idle_gaps(iv, t_lo, t_hi) if iv else ():
        # split the gap where a host span starts or ends inside it
        cuts = [at] + [t for t in edges if at < t < at + ln] + [at + ln]
        for a, b in zip(cuts, cuts[1:]):
            lab = label_of(a, spans)
            gaps[lab] = gaps.get(lab, 0.0) + (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        wall_s=wall_s,
        busy_s=busy_union(iv) * 1e-6,
        device_s=sum(by_name.values()),
        kernels=sum(1 for e in dev if e.get("cat") == "kernel"),
        family_s=by_family,
        device_ops=[[n, s] for n, s in top],
        idle_gaps=[[n, s] for n, s in sorted(gaps.items(),
                                             key=lambda kv: -kv[1])[:10]],
    )


class Stretch:
    """Profiles ``calls`` calls of span ``name`` once ``start_at`` (host
    time) has passed; install ``hook`` in ``Spans.hooks``, and call
    ``finish`` once the window has closed.  ``peak_before`` is the
    device's allocation peak before the stretch kept any tensor; the peak
    is reset once they are let go."""

    def __init__(self, spans, name: str, calls: int, start_at: float,
                 work_dir: str, counts: dict):
        self.spans, self.name, self.calls = spans, name, calls
        self.start_at, self.work_dir, self.counts = start_at, work_dir, counts
        self.state = "idle"
        self.k = 0
        self.out = None
        self.peak_before = 0
        self.tally_s = 0.0

    def hook(self, name):
        if name != self.name or self.state == "done":
            return
        import torch

        if self.state == "idle":
            if time.time() < self.start_at:
                return
            from torch.profiler import ProfilerActivity, profile

            from ..roofline.kernels import Calls

            on_card = torch.cuda.is_available()
            if on_card:
                torch.cuda.synchronize()
                self.peak_before = torch.cuda.max_memory_allocated()
            self.counts0 = dict(self.counts)
            self.capture = Calls().__enter__()
            self.prof = profile(activities=[
                ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU])
            self.prof.__enter__()
            self.sync = (0.0, 0.0)
            if on_card:
                t_a = time.perf_counter()
                torch.cuda.synchronize()
                self.sync = (t_a, time.perf_counter())
            self.spans.intervals = []
            self.t0 = time.perf_counter()
            self.state = "on"
            return
        self.k += 1
        if self.k >= self.calls:
            self._stop()

    def _stop(self):
        import torch

        on_card = torch.cuda.is_available()
        if on_card:
            torch.cuda.synchronize()
        self.calls = self.k
        self.wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.host_spans, self.spans.intervals = self.spans.intervals, None
        self.capture.__exit__(None, None, None)
        self.launches = {k: self.counts[k] - self.counts0[k]
                         for k in self.counts}
        # the kept indices' distinct rows: device work after the stretch,
        # then the tensors go and the allocation peak starts again
        t0 = time.perf_counter()
        self.tally = self.capture.tally()
        del self.capture
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.tally_s = time.perf_counter() - t0
        self.state = "done"

    def finish(self):
        """Read the trace (after the window: it takes host time)."""
        from ..roofline.kernels import FAMILIES, family_of

        if self.state == "on":  # the window closed inside the stretch
            self._stop()
        print(f"stretch: {self.state}, {self.k} of {self.calls} calls",
              file=sys.stderr, flush=True)
        if self.state != "done" or not self.calls:
            return None
        path = os.path.join(self.work_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        os.remove(path)
        evs = trace["traceEvents"] if isinstance(trace, dict) else trace
        off = sync_offset_us(evs, *self.sync)
        spans = [] if off is None else [
            (n, s * 1e6 + off, e * 1e6 + off) for n, s, e in self.host_spans]
        self.out = summarize(evs, self.wall, family_of, spans)
        print(f"stretch: {len(evs)} trace events, {self.out['kernels']} "
              f"kernels, {len(spans)} host spans placed, tally "
              f"{self.tally_s:.3f} s", file=sys.stderr, flush=True)
        self.out["calls"] = self.calls
        self.out["tally_s"] = self.tally_s
        # a family's bytes count only where every launch of it was taken
        self.out["family_bytes"] = {
            fam: b for fam, (b, n) in self.tally.items()
            if n and n == sum(self.launches.get(c, 0)
                              for c in FAMILIES[fam][2])}
        self.out["family_launches"] = {
            fam: sum(self.launches.get(c, 0) for c in FAMILIES[fam][2])
            for fam in FAMILIES}
        del self.prof
        return self.out
