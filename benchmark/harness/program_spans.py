"""The program's own spans (``uncalled_tpu_torch.tracing``) read beside a
profiled stretch, and the three per-span numbers of a window.

In a stretch the program's spans are placed on the trace's clock with the
offset of ``profile.sync_offset_us``, narrowed by the readouts' copies
where the trace has them (``readout_offset_us``).  Each device event (kernel, copy,
memset) is put down to the innermost span holding its launch: the
``cuda_runtime`` (or ``cuda_driver``) event with the event's
``correlation``, whose timestamp is on the trace's host clock.  Each idle gap of the device is
put down to the innermost span it falls in, as ``profile.summarize`` puts
it down to the benchmark's spans; the benchmark's spans take part too,
so the program's spans, which open inside them, win where both hold.

Over a window, the program's span totals (``tracing.snapshot()``'s
``totals``, under the record's key ``program``) give, per event step:

* ``issue_ms_per_step``: ``engine.step`` seconds, the host's cost of
  issuing the pooled step's work;
* ``readout_wait_ms_per_step``: ``engine.readout_wait`` seconds, the
  host's one wait on the device;
* ``host_self_ms_per_step``: ``host_loop.block`` self seconds (the block
  less its child spans and the consumer's time) plus ``host_loop.pack``
  and ``host_loop.harvest``: host-loop work outside the engine.  A
  profiled stretch starts and stops inside a block (the benchmark's
  ``advance`` span holds the profiler's start, its stop and the byte
  tally); the record's ``profile.hook_s`` says how long, and it is taken
  off.
"""

from __future__ import annotations

from bisect import bisect_right

from ..metrics.common import window_steps
from .profile import DEVICE_CATS, idle_gaps

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "host loop"  # the label outside every span, as label_of's


def _corr(e):
    return (e.get("args") or {}).get("correlation")


def clip(spans, t_a: float, t_b: float):
    """The program's spans (name, start, end, parent, block) that overlap
    [t_a, t_b], cut to it, as (name, start, end, depth); open spans end at
    t_b.  Depth counts the span's ancestors."""
    depth = []
    out = []
    for name, s, e, parent, _ in spans:
        d = depth[parent] + 1 if parent >= 0 else 0
        depth.append(d)
        e = t_b if e is None else e
        if e < t_a or s > t_b:
            continue
        out.append((name, max(s, t_a), min(e, t_b), d))
    return out


def shift(spans, off_us: float):
    """Spans (name, start, end, depth) from host seconds to the trace's
    microseconds."""
    return [(n, s * 1e6 + off_us, e * 1e6 + off_us, d)
            for n, s, e, d in spans]


def timeline(spans):
    """(cuts, labels): the innermost span's name holds on [cuts[i],
    cuts[i + 1]); None outside every span.  ``spans`` are (name, start,
    end, depth), nested (a span that crosses the end of the one it opened
    in is cut to it); on equal starts the longer span is the outer one,
    then the shallower."""
    cuts, labels, stack = [], [], []

    def mark(t, label):
        if cuts and cuts[-1] == t:
            labels[-1] = label
        else:
            cuts.append(t)
            labels.append(label)

    def pop_to(t):
        while stack and stack[-1][1] <= t:
            _, end = stack.pop()
            mark(end, stack[-1][0] if stack else None)

    for name, s, e, _ in sorted(spans, key=lambda x: (x[1], -x[2], x[3])):
        pop_to(s)
        if stack:
            e = min(e, stack[-1][1])
        mark(s, name)
        stack.append((name, e))
    pop_to(float("inf"))
    return cuts, labels


def label_at(cuts, labels, t):
    i = bisect_right(cuts, t) - 1
    return (labels[i] if i >= 0 else None) or OUTSIDE


def breakdown(evs, program, bench=(), steps: int = 1) -> dict:
    """What a stretch's trace events give each span.  ``program`` and
    ``bench`` are spans (name, start, end, depth) on the trace's clock
    (the benchmark's with depth -1).  ``spans``: for each label, host ms a
    step (the program's spans' inclusive time), launches (kernels) and
    device events a step, device ms a step and its top three device ops;
    ``idle_s``: the idle gaps' seconds by label; ``unmatched``: device
    events with no launch call in the trace (put down to ``host loop``)."""
    dev = [e for e in evs if e.get("cat") in DEVICE_CATS]
    launch_ts = {_corr(e): float(e["ts"]) for e in evs
                 if e.get("cat") in LAUNCH_CATS and _corr(e) is not None}
    cuts, labels = timeline(list(program) + [(n, s, e, -1)
                                             for n, s, e, *_ in bench])
    rows = {}

    def row(label):
        r = rows.get(label)
        if r is None:
            r = rows[label] = dict(host_s=0.0, launches=0, events=0,
                                   device_s=0.0, ops={})
        return r

    for n, s, e, _ in program:
        row(n)["host_s"] += (e - s) * 1e-6
    unmatched = 0
    for e in dev:
        t = launch_ts.get(_corr(e))
        if t is None:
            unmatched += 1
        r = row(OUTSIDE if t is None else label_at(cuts, labels, t))
        d = float(e.get("dur", 0)) * 1e-6
        r["events"] += 1
        r["launches"] += e.get("cat") == "kernel"
        r["device_s"] += d
        name = e.get("name", "?")
        r["ops"][name] = r["ops"].get(name, 0.0) + d
    iv = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
          for e in dev]
    ends = iv + [(s, e) for _, s, e, _ in program] + [
        (s, e) for _, s, e, *_ in bench]
    idle = {}
    if ends:
        t_lo = min(s for s, _ in ends)
        t_hi = max(e for _, e in ends)
        for at, ln in idle_gaps(iv, t_lo, t_hi):
            # split the gap where the innermost span changes inside it
            i = bisect_right(cuts, at)
            edge = [t for t in cuts[i:bisect_right(cuts, at + ln)]
                    if t < at + ln]
            for a, b in zip([at] + edge, edge + [at + ln]):
                lab = label_at(cuts, labels, a)
                idle[lab] = idle.get(lab, 0.0) + (b - a) * 1e-6
    table = {}
    for lab, r in sorted(rows.items(), key=lambda kv: -kv[1]["device_s"]):
        top = sorted(r["ops"].items(), key=lambda kv: -kv[1])[:3]
        table[lab] = dict(
            host_ms=1e3 * r["host_s"] / steps,
            launches=r["launches"] / steps, events=r["events"] / steps,
            device_ms=1e3 * r["device_s"] / steps,
            top_ops=[[n, 1e3 * s / steps] for n, s in top])
    return dict(spans=table,
                idle_s=dict(sorted(idle.items(), key=lambda kv: -kv[1])),
                launches=sum(r["launches"] for r in rows.values()),
                events=sum(r["events"] for r in rows.values()),
                device_s=sum(r["device_s"] for r in rows.values()),
                unmatched=unmatched)


def sync_spread_us(evs, t_a: float, t_b: float):
    """How uncertain the offset of ``profile.sync_offset_us`` is: the
    host-timed synchronise's length (``t_a`` to ``t_b``, seconds) less the
    trace's (microseconds); None where the trace has no such call."""
    for e in sorted(evs, key=lambda e: float(e.get("ts", 0))):
        if "cudaDeviceSynchronize" in str(e.get("name", "")) and "dur" in e:
            return (t_b - t_a) * 1e6 - float(e["dur"])
    return None


def readout_offset_us(evs, spans, off_us: float, slack_us: float = 1e4):
    """The trace's clock minus the host's (microseconds), read from the
    readouts: each ``engine.readout_wait`` span (``spans``: the program's,
    on the host's clock) holds its one device-to-host copy call, so the
    offsets that put every such call inside its span, intersected, bound
    the offset.  ``off_us`` (the synchronise's offset) finds each span's
    call, within ``slack_us``.  Gives (offset, width of the bound, spans
    used), or None where no span has exactly one such call or the bounds
    do not meet."""
    dtoh = {_corr(e) for e in evs
            if e.get("cat") == "gpu_memcpy" and "DtoH" in str(e.get("name"))}
    calls = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
             for e in evs if e.get("cat") in LAUNCH_CATS
             and "Memcpy" in str(e.get("name")) and _corr(e) in dtoh]
    lo, hi, n = float("-inf"), float("inf"), 0
    for name, s, e, *_ in spans:
        if name != "engine.readout_wait" or e is None:
            continue
        s_us, e_us = s * 1e6, e * 1e6
        near = [c for c in calls if c[0] >= s_us + off_us - slack_us
                and c[1] <= e_us + off_us + slack_us]
        if len(near) != 1:
            continue
        lo = max(lo, near[0][1] - e_us)
        hi = min(hi, near[0][0] - s_us)
        n += 1
    if not n or lo > hi:
        return None
    return (lo + hi) / 2, hi - lo, n


def _total(rec, name, key="seconds"):
    return rec["program"].get(name, {}).get(key, 0.0)


def issue_ms_per_step(rec):
    steps = window_steps(rec)
    if not rec.get("program") or not steps:
        return None
    return 1e3 * _total(rec, "engine.step") / steps


def readout_wait_ms_per_step(rec):
    steps = window_steps(rec)
    if not rec.get("program") or not steps:
        return None
    return 1e3 * _total(rec, "engine.readout_wait") / steps


def host_self_ms_per_step(rec):
    steps = window_steps(rec)
    if not rec.get("program") or not steps:
        return None
    hook_s = (rec.get("profile") or {}).get("hook_s", 0.0)
    return 1e3 * (_total(rec, "host_loop.block", "self_seconds")
                  + _total(rec, "host_loop.pack")
                  + _total(rec, "host_loop.harvest") - hook_s) / steps


WINDOW_METRICS = {
    "engine.issue_ms_per_step.batch": issue_ms_per_step,
    "engine.readout_wait_ms_per_step.batch": readout_wait_ms_per_step,
    "host_loop.self_ms_per_step.batch": host_self_ms_per_step,
}
