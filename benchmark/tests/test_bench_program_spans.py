"""The program's spans read beside a stretch, on synthetic chrome-trace
events: launches and device time go to the innermost program span that
holds the launch call, they add up to the stretch's totals, and an idle
gap takes the innermost span's name; the three window numbers."""

import pytest

from benchmark.harness import program_spans as ps


def _ev(cat, name, ts, dur, corr=None):
    e = dict(cat=cat, name=name, ts=ts, dur=dur)
    if corr is not None:
        e["args"] = dict(correlation=corr)
    return e


def _launch(ts, corr, name="cudaLaunchKernel"):
    return _ev("cuda_runtime", name, ts, 1, corr)


# one block on the trace's clock (us): pack, an advance (upload, one step
# of two phases), the readout's wait; the benchmark's spans around the
# engine's calls
PROGRAM = [("host_loop.block", 0, 200, 0), ("host_loop.pack", 0, 10, 1),
           ("engine.advance", 12, 150, 1), ("engine.upload", 12, 20, 2),
           ("engine.step", 20, 150, 2), ("step.probs", 20, 60, 3),
           ("step.sort", 60, 150, 3), ("engine.readout_wait", 160, 190, 1)]
BENCH = [("advance", 11, 151), ("readout_wait", 159, 191)]
EVENTS = [
    _ev("cuda_runtime", "cudaDeviceSynchronize", -50, 10),
    _launch(15, 1, "cudaMemcpyAsync"), _ev("gpu_memcpy", "Memcpy HtoD", 16, 2, 1),
    _launch(25, 2), _ev("kernel", "k_probs", 30, 10, 2),
    _launch(61, 3), _ev("kernel", "k_sort", 70, 20, 3),
    _launch(62, 4), _ev("kernel", "k_sort", 90, 10, 4),
    _launch(165, 5, "cudaMemcpyAsync"), _ev("gpu_memcpy", "Memcpy DtoH", 170, 5, 5),
    # in the benchmark's advance, after the program's has closed
    _launch(150.5, 6), _ev("kernel", "k_tail", 152, 3, 6),
    # in the block, in none of its children
    _launch(195, 7), _ev("kernel", "k_self", 196, 2, 7),
    # outside every span, and one with no launch call in the trace
    _ev("cuda_driver", "cuLaunchKernel", 205, 1, 8),
    _ev("kernel", "k_out", 206, 1, 8), _ev("kernel", "k_lost", 50, 1, 9),
]


def test_device_events_go_to_the_innermost_launching_span():
    got = ps.breakdown(EVENTS, PROGRAM, BENCH, steps=2)
    sp = got["spans"]
    want = {"step.probs": (1, 1, 10), "step.sort": (2, 2, 30),
            "engine.upload": (0, 1, 2), "engine.readout_wait": (0, 1, 5),
            "advance": (1, 1, 3), "host_loop.block": (1, 1, 2),
            "host loop": (2, 2, 2)}
    for name, (launches, events, dev_us) in want.items():
        assert sp[name]["launches"] == launches / 2, name
        assert sp[name]["events"] == events / 2, name
        assert sp[name]["device_ms"] == pytest.approx(dev_us * 1e-3 / 2)
    assert sp["step.sort"]["top_ops"] == [["k_sort", pytest.approx(0.015)]]
    assert got["unmatched"] == 1
    # every device event once: the stretch's kernels and device time
    dev = [e for e in EVENTS if e["cat"] in ("kernel", "gpu_memcpy")]
    assert got["launches"] == sum(e["cat"] == "kernel" for e in dev) == 7
    assert got["events"] == len(dev)
    assert got["device_s"] == pytest.approx(sum(e["dur"] for e in dev) * 1e-6)
    assert sum(r["launches"] for r in sp.values()) * 2 == got["launches"]
    # host ms a step: the program's spans' inclusive time
    assert sp["engine.step"]["host_ms"] == pytest.approx(130e-3 / 2)
    assert sp["engine.step"]["launches"] == 0  # its phases hold them


def test_idle_gaps_take_the_innermost_span():
    idle = ps.breakdown(EVENTS, PROGRAM, BENCH)["idle_s"]
    want = {"step.sort": 60, "step.probs": 29, "engine.readout_wait": 25,
            "host_loop.block": 13, "host_loop.pack": 10, "engine.upload": 6,
            "host loop": 6, "advance": 2, "readout_wait": 2}
    assert idle == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    assert list(idle)[0] == "step.sort"
    # span edges 0 .. 200, device to 207: 207 us less 54 busy
    assert sum(idle.values()) == pytest.approx(153e-6)
    # the benchmark's spans alone label the same gaps as before
    old = ps.breakdown(EVENTS, [], BENCH)["idle_s"]
    assert list(old)[0] == "advance"
    assert sum(old.values()) == pytest.approx((207 - 11 - 54) * 1e-6)


def test_timeline_nests_equal_starts():
    # a step and its first phase start at one instant; the phase is inner
    cuts, labels = ps.timeline([("step.probs", 0, 5, 3), ("engine.step", 0, 9, 2),
                                ("advance", 0, 9, -1)])
    assert ps.label_at(cuts, labels, 0) == "step.probs"
    assert ps.label_at(cuts, labels, 6) == "engine.step"
    assert ps.label_at(cuts, labels, 9) == "host loop"
    assert ps.label_at(cuts, labels, -1) == "host loop"


def test_program_spans_are_clipped_and_placed():
    from uncalled_tpu_torch import tracing

    tracing.enable()
    try:
        blk = tracing.block()
        ph = tracing.phases("engine.step")
        ph("probs")
        ph("sort")
        ph.end()
        blk.close()
        tracing.span("host_loop.refill")  # still open at the snapshot
        snap = tracing.snapshot()
    finally:
        tracing.disable()
    spans = snap["spans"]
    t_a, t_b = spans[1][1], spans[4][1] + 5.0
    got = ps.clip(spans, t_a, t_b)
    assert [(n, d) for n, _, _, d in got] == [
        ("host_loop.block", 0), ("engine.step", 1), ("step.probs", 2),
        ("step.sort", 2), ("host_loop.refill", 0)]
    assert got[0][1] == t_a and got[-1][2] == t_b
    # past the block only the open refill, which lasts to the end
    assert ps.clip(spans, t_b + 1, t_b + 2) == [
        ("host_loop.refill", t_b + 1, t_b + 2, 0)]
    placed = ps.shift(got, -5.0)
    assert placed[3][1] == pytest.approx(spans[3][1] * 1e6 - 5.0)


def test_readout_copies_narrow_the_offset():
    # host spans (s); each readout wait holds one device-to-host copy call
    spans = [("engine.readout_wait", 1.0, 1.0002, -1, 1),
             ("engine.step", 1.5, 1.6, -1, 1),
             ("engine.readout_wait", 2.0, 2.0003, -1, 2)]
    true = 500.0  # us: trace = host * 1e6 + 500
    evs = [_ev("cuda_runtime", "cudaMemcpyAsync", 1.00005e6 + true, 100, 1),
           _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 0, 1, 1),
           _ev("cuda_runtime", "cudaMemcpyAsync", 2.0001e6 + true, 150, 2),
           _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 0, 1, 2),
           # a host-to-device copy in between is no readout
           _ev("cuda_runtime", "cudaMemcpyAsync", 1.5e6 + true, 5, 3),
           _ev("gpu_memcpy", "Memcpy HtoD", 0, 1, 3)]
    # the synchronise put the spans 3 ms off
    off, width, n = ps.readout_offset_us(evs, spans, true + 3000)
    assert n == 2
    # bounds: [true - 50, true + 50] and [true - 50, true + 100]
    assert off == pytest.approx(true) and width == pytest.approx(100)
    assert ps.readout_offset_us(evs, spans, true + 3e4) is None
    assert ps.readout_offset_us(evs[2:], spans[1:2], true) is None


def test_sync_spread():
    assert ps.sync_spread_us(EVENTS, 2.0, 2.000012) == pytest.approx(2.0)
    assert ps.sync_spread_us(EVENTS[1:], 2.0, 2.1) is None


def test_window_numbers_from_the_program_totals():
    tot = {"engine.step": dict(seconds=0.5, calls=80, self_seconds=0.0),
           "engine.readout_wait": dict(seconds=0.01, calls=10,
                                       self_seconds=0.01),
           "host_loop.block": dict(seconds=1.0, calls=10, self_seconds=0.02),
           "host_loop.pack": dict(seconds=0.01, calls=10, self_seconds=0.01),
           "host_loop.harvest": dict(seconds=0.03, calls=12,
                                     self_seconds=0.03)}
    rec = dict(B=4, T=8, counters=dict(disp_events=4 * 8 * 10), program=tot)
    got = {k: fn(rec) for k, fn in ps.WINDOW_METRICS.items()}
    assert got == pytest.approx({"engine.issue_ms_per_step.batch": 6.25,
                                 "engine.readout_wait_ms_per_step.batch": 0.125,
                                 "host_loop.self_ms_per_step.batch": 0.75})
    # a profiled stretch's own start and stop ran inside a block
    rec["profile"] = dict(hook_s=0.02)
    assert ps.host_self_ms_per_step(rec) == pytest.approx(0.5)
    # a program without the tracer, or the tracer off: nothing to read
    for r in (dict(rec, program=None), {k: v for k, v in rec.items()
                                        if k != "program"}):
        assert all(fn(r) is None for fn in ps.WINDOW_METRICS.values())
