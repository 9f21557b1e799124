"""The tracer's spans and counters in the port's simulated ReadUntil loop
(``realtime/sim.py`` ``run_sim_loop`` and ``realtime/mapper.py``
``RealtimeMapper``) on the CPU: the lines do not move with the tracer on,
each loop pass is an ``rt_loop.tick`` that its update and its chunks
tile, the mapper's spans lie in the right parents, and the counters add
up to what the loop emitted and the engine advanced.  The cell
``ecoli_rt.enrich_zymo`` cut to eight channels and 4.5 simulated
seconds, as in ``test_torch_rt_reference.py``."""

from collections import Counter, defaultdict

import pytest
import torch

from test_torch_rt_reference import run_port, world  # noqa: F401

torch.set_num_threads(1)

SECONDS = 4.5
PARENT = {"rt_loop.update": "rt_loop.tick", "rt_loop.chunks": "rt_loop.tick",
          "realtime.advance": "rt_loop.update",
          "realtime.readout": "rt_loop.update",
          "realtime.decide": "rt_loop.update",
          "realtime.add_chunks": "rt_loop.chunks",
          "realtime.dsp": "realtime.add_chunks",
          "realtime.reset": "realtime.add_chunks",
          "engine.advance": "realtime.advance",
          "engine.reset": "realtime.reset"}


@pytest.fixture(scope="module")
def runs(world):  # noqa: F811
    advanced = []

    def count_events(rt):
        orig = rt.eng.advance

        def advance(state, means, on, sb=None):
            advanced.append(int(on.sum()))
            return orig(state, means, on)
        rt.eng.advance = advance

    on = run_port(world, 0.075, 64, 256, SECONDS, trace=True,
                  patch=count_events)
    off = run_port(world, 0.075, 64, 256, SECONDS)
    return on, off, sum(advanced)


def test_lines_identical_with_the_tracer_on(runs):
    from benchmark.drivers.readuntil import strip

    (lines, started, _, _, _), (lines_off, started_off, _, _, _), _ = runs
    assert lines and [strip(l) for l in lines] == [strip(l)
                                                   for l in lines_off]
    assert started == started_off


def test_spans_nest_and_tile(runs):
    (_, _, _, snap, _), _, _ = runs
    spans = snap["spans"]
    names = Counter(s[0] for s in spans)
    assert set(PARENT) | {"rt_loop.tick", "realtime.make_paf"} <= set(names)
    kids = defaultdict(list)
    for i, (name, start, end, parent, _) in enumerate(spans):
        assert end is not None and start <= end, name
        if parent < 0:
            assert name == "rt_loop.tick", name
            continue
        pname, pstart, pend, _, _ = spans[parent]
        if name in PARENT:
            assert PARENT[name] == pname, (name, pname)
        elif name == "realtime.make_paf":  # a decision, or a read replaced
            assert pname in ("rt_loop.update", "realtime.add_chunks")
        assert pstart <= start and end <= pend, name
        kids[parent].append(i)
    ticks = [i for i, s in enumerate(spans) if s[0] == "rt_loop.tick"]
    covered = sum(spans[j][2] - spans[j][1] for i in ticks for j in kids[i])
    total = sum(spans[i][2] - spans[i][1] for i in ticks)
    assert covered >= 0.9 * total
    for i in ticks:
        assert [spans[j][0] for j in kids[i]] == ["rt_loop.update",
                                                  "rt_loop.chunks"]
    # the mapper's update: its advance, readout, decisions and lines
    upd = [i for i, s in enumerate(spans) if s[0] == "rt_loop.update"]
    for i in upd:
        got = [spans[j][0] for j in kids[i]]
        assert got[:3] == ["realtime.advance", "realtime.readout",
                           "realtime.decide"], got
        assert set(got[3:]) <= {"realtime.make_paf"}


def test_counters_add_up(runs):
    (lines, started, rt, snap, counts), _, advanced = runs
    tot = snap["totals"]
    kinds = Counter(l.split("\t")[-1][:2] for l in lines)
    assert {k: counts.get("rt_decisions." + k, 0) for k in kinds} == kinds
    assert sum(v for k, v in counts.items()
               if k.startswith("rt_decisions.")) == len(lines)
    assert counts["rt_ticks"] == tot["rt_loop.tick"]["calls"]
    assert counts["rt_ticks"] == int(round(SECONDS / 0.075)) + 1
    assert counts["rt_events"] == advanced > 0
    assert counts["rt_giveups"] == len(rt.giveups)
    assert counts["rt_resets"] == tot["realtime.reset"]["calls"]
    # a reset for every read the loop delivered a chunk of
    delivered = {c.number for c in rt.channels if c.number >= 0}
    assert counts["rt_resets"] >= len(delivered | {int(l[1:8])
                                                   for l in lines})
    assert counts.get("rt_shed_chunks", 0) == 0


def test_tracer_off_keeps_nothing(runs):
    from uncalled_tpu_torch import tracing

    _, (_, _, _, snap, counts), _ = runs
    assert snap == dict(spans=[], totals={}) and counts == {}
    assert not tracing.TRACER.on
    tracing.count("rt_ticks")
    assert tracing.counts() == {}
