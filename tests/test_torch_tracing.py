"""The port's tracer (``uncalled_tpu_torch/tracing.py``) on the CPU: the
PAF lines do not move with it on, every span it keeps is closed and lies
in its parent, the step's phases tile each step, a block is its children,
its consumer time and its self time, ``t_refill`` is the refill spans'
sum, and with the tracer off nothing is kept.  A few golden reads at
B = 2 with the slot handoff (the conf defaults; too narrow to drain) and
at B = 4 without it."""

import json
import os
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")
RIDS = ["sim_0005_Escherichia_coli_3483_+", "sim_0008_Escherichia_coli_1891_+",
        "sim_0009_Escherichia_coli_2589_+", "sim_0002_Escherichia_coli_6254_+",
        "sim_0003_Escherichia_coli_6188_-"]
PHASES = ("probs", "candidates", "compact", "extend", "ended", "sort",
          "seed_rows", "tracker", "sources", "assemble", "record_table",
          "decide", "release")
BLOCK_CHILDREN = {"host_loop.consumer", "host_loop.pack", "host_loop.harvest",
                  "host_loop.refill", "engine.advance", "engine.readout_issue",
                  "engine.readout_wait"}
PARENT = {"host_loop.dsp": "host_loop.refill",
          "engine.reset": "host_loop.refill",
          "engine.upload": "engine.advance",
          "engine.step": "engine.advance",
          **{"step." + p: "engine.step" for p in PHASES + ("switch",)},
          **{n: "host_loop.block" for n in BLOCK_CHILDREN}}

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)


class Read:
    def __init__(self, id, signal):
        self.id = id
        self.signal = np.asarray(signal, dtype=np.float32)
        self.channel, self.number, self.start_sample = 1, 0, 0

    @property
    def raw_len(self):
        return len(self.signal)


@pytest.fixture(scope="module")
def assets():
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    with open(os.path.join(FX, "golden_pafs.json")) as f:
        golden = json.load(f)
    sigs = np.load(os.path.join(FX, "golden_reads.npz"), allow_pickle=True)
    return (load_bwa_index(PREFIX), load_default(),
            load_uncl(PREFIX + ".uncl"), golden, sigs)


def _map(assets, handoff, trace):
    """(lines, mapper, snapshot) of RIDS mapped with a fresh mapper, the
    tracer on over the whole run where ``trace``."""
    from uncalled_tpu_torch import tracing
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping.batch import BatchMapper

    fmi, model, th, _, sigs = assets
    conf = Conf()
    conf.engine.pool_slots_per_read = 512
    conf.engine.batch_reads = 2 if handoff else 4
    conf.engine.slot_handoff = handoff
    bm = BatchMapper(fmi, model, th, conf, device="cpu")
    assert bm.eng.params.handoff == handoff
    tracing.enable()  # empties the tracer
    if not trace:
        tracing.disable()
    try:
        lines = {p.rd_name: p.to_line()
                 for p in bm.map_reads([Read(r, sigs[r]) for r in RIDS])}
    finally:
        snap = tracing.snapshot()
        tracing.disable()
    # the checks below read one mapper: no drain, no eject tier
    assert bm._drain_mapper is None and bm._next_mapper is None
    return lines, bm, snap


@pytest.fixture(scope="module", params=[True, False], ids=["handoff",
                                                           "no_handoff"])
def runs(request, assets):
    ho = request.param
    return ho, _map(assets, ho, False), _map(assets, ho, True)


def test_lines_identical_with_the_tracer_on(runs, assets):
    ho, (off, bm_off, _), (on, bm_on, _) = runs
    assert on == off
    golden = assets[3]
    for rid in RIDS:
        assert on[rid] == golden[rid], rid
    if ho:
        assert bm_on.n_handoff > 0 and bm_on.n_handoff == bm_off.n_handoff


def test_spans_nest_and_tile(runs):
    ho, _, (_, bm, snap) = runs
    spans = snap["spans"]
    names = Counter(s[0] for s in spans)
    assert set(PARENT) - {"step.switch"} <= set(names), names
    assert ("step.switch" in names) == ho
    kids = defaultdict(list)
    for i, (name, start, end, parent, blk) in enumerate(spans):
        assert end is not None and start <= end, name
        if parent < 0:
            # outside every block: the loop's first refill alone
            assert name in ("host_loop.block", "host_loop.refill"), name
            continue
        pname, pstart, pend, _, pblk = spans[parent]
        assert PARENT[name] == pname, (name, pname)
        assert pstart <= start and end <= pend, name
        assert blk == pblk
        kids[parent].append(i)
    for i, (name, start, end, _, blk) in enumerate(spans):
        ch = sorted(kids[i], key=lambda j: spans[j][1])
        # children never overlap: the parent is its children plus self
        for a, b in zip(ch, ch[1:]):
            assert spans[a][2] <= spans[b][1], (spans[a][0], spans[b][0])
        if name == "engine.step":
            # the phases tile the step: no gap, no overlap
            ph = [spans[j] for j in ch]
            assert [p[0] for p in ph][-len(PHASES):] == [
                "step." + p for p in PHASES]
            assert ph[0][1] == start and ph[-1][2] == end
            assert all(a[2] == b[1] for a, b in zip(ph, ph[1:]))
        if name == "host_loop.block":
            assert {spans[j][0] for j in ch} <= BLOCK_CHILDREN
            assert blk >= 1
    # a block's self time: the block less its children and consumer time
    self_s = sum(e - s - sum(spans[j][2] - spans[j][1] for j in kids[i])
                 for i, (n, s, e, _, _) in enumerate(spans)
                 if n == "host_loop.block")
    tot = snap["totals"]["host_loop.block"]
    assert tot["self_seconds"] == pytest.approx(self_s, rel=1e-9, abs=1e-12)
    assert 0 <= tot["self_seconds"] <= tot["seconds"]
    # T steps an advance, one advance a dispatched block
    steps = Counter(spans[p][0] for n, _, _, p, _ in spans
                    if n == "engine.step")
    adv = [i for i, s in enumerate(spans) if s[0] == "engine.advance"]
    assert steps == {"engine.advance": bm.T * len(adv)}
    assert all(sum(spans[j][0] == "engine.step" for j in kids[i]) == bm.T
               for i in adv)
    assert len(adv) * bm.eng.params.B * bm.T == bm.disp_events
    assert snap["totals"]["engine.step"]["calls"] == bm.T * len(adv)


def test_t_refill_is_the_refill_spans(runs):
    _, (_, bm_off, snap_off), (_, bm, snap) = runs
    refills = [e - s for n, s, e, _, _ in snap["spans"]
               if n == "host_loop.refill"]
    assert refills and bm.t_refill == sum(refills)
    assert snap["totals"]["host_loop.refill"]["seconds"] == bm.t_refill
    assert bm_off.t_refill > 0  # counted with the tracer off too


def test_tracer_off_keeps_nothing(runs):
    from uncalled_tpu_torch import tracing

    _, (_, _, snap), _ = runs
    assert snap == dict(spans=[], totals={})
    assert not tracing.TRACER.on
    assert tracing.span("x") is tracing.NOOP
    assert tracing.phases("engine.step") is tracing.NOOP
    assert tracing.block() is tracing.NOOP


def test_tracer_closes_what_is_left_open():
    """disable() ends the open spans at one instant; a span closed after
    it, or its parent closed first, ends once; enable() starts afresh."""
    from uncalled_tpu_torch import tracing

    tracing.enable()
    try:
        outer = tracing.block()
        ph = tracing.phases("engine.step")
        ph("probs")
        ph("sort")
        tracing.span("inner")  # never closed by its site
        ph.end()  # closes "inner" and "step.sort" with the step
        left = tracing.span("host_loop.consumer")
    finally:
        tracing.disable()
    left.close()
    outer.close()
    snap = tracing.snapshot()
    names = [s[0] for s in snap["spans"]]
    assert names == ["host_loop.block", "engine.step", "step.probs",
                     "step.sort", "inner", "host_loop.consumer"]
    sp = {s[0]: s for s in snap["spans"]}
    assert sp["inner"][2] == sp["step.sort"][2] == sp["engine.step"][2]
    assert sp["host_loop.consumer"][2] == sp["host_loop.block"][2]
    assert sp["step.probs"][1] == sp["engine.step"][1]
    assert all(s[4] == 1 for s in snap["spans"])
    assert snap["totals"]["host_loop.block"]["calls"] == 1
    tracing.enable()
    assert tracing.snapshot() == dict(spans=[], totals={})
    tracing.disable()
