"""The pooled engine's graph runner (``mapping/graphs.py``) off the card:
its cuts, fixed buffers and copies, run eagerly (``graphs=False``), held
to ``pool_advance_block`` on every state key after every event at zero
tolerance, with the handoff on and off and with slot resets and a
migration between blocks; the rule that sends the CPU and the sharded
engine to the eager path; the engine's three counters; a wrapper's
``out=`` and the index copies of the cut."""

import numpy as np
import pytest
import torch

from uncalled_tpu_torch.mapping import graphs
from uncalled_tpu_torch.mapping import pooled as tp
from uncalled_tpu_torch.ops import colgather
from uncalled_tpu_torch.testing import graph_check as gc

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)

KW = dict(B=4, S=8192, SC=10240, CL=2048, RE=1024, RT=2048, R=512, FS=256)


@pytest.fixture(scope="module")
def assets():
    # the simulated golden reads: each decides within 80 events
    ev = gc.golden_events()
    return gc.example_index("cpu"), [ev[r] for r in ev if r.startswith("sim_")]


@pytest.mark.parametrize("handoff,sort_mode", [(True, "flat"),
                                               (False, "bitonic")])
def test_runner_equals_block_every_event(assets, monkeypatch, handoff,
                                         sort_mode):
    """Five blocks of 16 events, reads deciding (and with the handoff
    switching) from the third, the decided slots reset, then both states
    migrated into a narrower pool for the last block: the runner's every
    event equals the eager block's, bit for bit, and so does its state
    after every block."""
    idx, events = assets
    seen = []
    step = tp._pool_event_step

    def record(*a, **k):
        out = step(*a, **k)
        seen.append({key: v.clone() for key, v in out.items()})
        return out

    monkeypatch.setattr(tp, "_pool_event_step", record)
    p = tp.PoolParams(handoff=handoff, sort_mode=sort_mode, **KW)
    dst = tp.PoolParams(handoff=handoff, sort_mode=sort_mode,
                        **dict(KW, B=2, S=4096, SC=5120))
    T, n_blocks = 16, 5
    diffs, counts = gc.compare_blocks(idx, p, events, n_blocks, T, "cpu",
                                      graphs=False, migrate_to=dst)
    assert diffs == [[]] * n_blocks
    assert counts["resets"] >= 2
    assert counts["switched"] >= (2 if handoff else 0)
    # each block ran T eager events, then T through the runner
    assert len(seen) == 2 * T * n_blocks
    for k in range(n_blocks):
        for t in range(T):
            e, g = seen[2 * T * k + t], seen[2 * T * k + T + t]
            assert gc.differ(e, g) == [], (k, t)


def test_rule_sends_cpu_and_sharded_to_eager():
    assert graphs.eligible("cuda", {"n": 1})
    assert not graphs.eligible("cpu", {"n": 1})
    assert not graphs.eligible("cuda", {"n": 1, "shard": object()})
    assert not graphs.eligible(torch.device("cpu"), {})


def _engine(**over):
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    return tp.PooledEngine(load_bwa_index(gc.PREFIX), load_default(),
                           load_uncl(gc.PREFIX + ".uncl"), Conf(),
                           device="cpu", **dict(KW, **over))


def _blocks(events, B, T, n, handoff):
    host = gc._Host(events, B, T, 2 * T if handoff else 0, handoff)
    return [host.block() for _ in range(n)]


def test_cpu_engine_runs_eager(assets):
    _, events = assets
    eng = _engine(sort_mode="flat")
    st = eng.fresh_state()
    for means, on, sb in _blocks(events, 4, 8, 2, eng.params.handoff):
        st = eng.advance(st, means, on, sb)
    assert (eng.graph_captures, eng.graph_steps, eng.eager_steps) == (0, 0,
                                                                      16)
    assert eng._blocks == {}


def test_engine_counters_and_graph_branch(assets, monkeypatch):
    """With the rule forced and the runner eager, the engine's second
    block of a shape is the capture, later ones replays: one capture,
    eager steps for the first block only, and the states equal an eager
    engine's after every block (handoff windows and promotions on)."""
    _, events = assets

    cls = graphs.BlockGraphs

    def runner(*a, **k):
        return cls(*a, **k, graphs=False)

    eng, ref = _engine(sort_mode="flat"), _engine(sort_mode="flat")
    assert eng.params.handoff  # the conf default
    monkeypatch.setattr(graphs, "eligible", lambda dev, idx: True)
    monkeypatch.setattr(graphs, "BlockGraphs", runner)
    s, r = eng.fresh_state(), ref.fresh_state()
    T = 8
    for k, (means, on, sb) in enumerate(_blocks(events, 4, T, 4, True)):
        if k == 2:
            sb = None  # nothing armed: the windows are cleared
        s = eng.advance(s, means, on, sb)
        monkeypatch.setattr(graphs, "eligible", lambda dev, idx: False)
        r = ref.advance(r, means, on, sb)
        monkeypatch.setattr(graphs, "eligible", lambda dev, idx: True)
        assert gc.differ(s, r) == [], k
        if k == 1:
            mask = np.array([True, False, False, True])
            s, r = eng.reset_slots(s, mask), ref.reset_slots(r, mask)
    assert (eng.graph_captures, eng.graph_steps, eng.eager_steps) == (
        1, 3 * T, T)
    assert (ref.graph_captures, ref.graph_steps, ref.eager_steps) == (
        0, 0, 4 * T)
    # another block shape is warmed up and captured on its own
    means, on, sb = _blocks(events, 4, 4, 1, True)[0]
    s = eng.advance(s, means, on, sb)
    s = eng.advance(s, means, on, sb)
    assert (eng.graph_captures, eng.eager_steps) == (2, T + 4)
    assert sorted(eng._blocks) == [(4, 8), (8, 16)]


def test_sharded_engine_stays_eager(tmp_path):
    """A sharded pooled engine (one gloo rank, a (1, 1) mesh) counts its
    steps as eager and keeps no graphs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.parallel import ShardedPooledEngine
    from uncalled_tpu_torch.poremodel import load_default

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("dp", "idx"))
        conf = Conf()
        conf.engine.batch_reads = 4
        eng = ShardedPooledEngine(
            load_bwa_index(gc.PREFIX), load_default(),
            load_uncl(gc.PREFIX + ".uncl"), conf, mesh=mesh, device="cpu",
            S=2048, SC=2560, CL=2048, RE=1024, RT=2048, R=512, FS=256)
        assert not graphs.eligible(eng.device, eng.idx)
        st = eng.fresh_state()
        means = np.full((4, 4), 0.5, np.float32)
        st = eng.advance(st, means, np.ones((4, 4), bool))
        assert (eng.graph_captures, eng.graph_steps, eng.eager_steps) == (
            0, 0, 4)
        assert not getattr(eng, "_blocks", None)
    finally:
        dist.destroy_process_group()


def test_site_out_and_index_copies(monkeypatch):
    """A cut gather: the first call records the result; later calls pass
    the capture's result tensor as ``out=`` and return the capture's
    result; an index lying in a buffer the runner writes eagerly reaches
    the wrapper as a copy, one that does not as itself."""
    got = []

    def fake_gather(kernel, cols, idx, lens=None, out=None):
        got.append((idx, out))
        res = cols[0].index_select(0, idx.long()) if out is None else out
        if out is not None:
            out.copy_(cols[0].index_select(0, idx.long()))
        return res, [torch.int32]

    monkeypatch.setattr(colgather, "gather", fake_gather)
    buf = torch.arange(6, dtype=torch.int32)  # a buffer written eagerly
    own = torch.tensor([5, 0], dtype=torch.int32)
    col = torch.arange(10, 16, dtype=torch.int32)
    rec = graphs._Recorder(None, {graphs._storage(buf)})
    results = []
    for k in range(3):
        buf.copy_(torch.arange(6, dtype=torch.int32).flip(0) if k else
                  torch.arange(6, dtype=torch.int32))
        rec.i = 0
        with graphs._cut_at_sites(rec):
            r1 = colgather.gather("flat_gather", [col], buf[:3])
            r2 = colgather.gather("flat_gather", [col], own)
        results.append((r1[0].clone(), r2[0].clone()))
        assert r1[0] is rec.sites[0].static[0]
    assert len(rec.sites) == 2 and colgather.gather is fake_gather
    assert [s.out for s in rec.sites] == [True, True]
    # the index in the written buffer came as a copy, the other as itself
    assert graphs._storage(got[0][0]) != graphs._storage(buf)
    assert got[1][0] is own
    # later runs wrote into the first run's results
    assert got[2][1] is rec.sites[0].static[0]
    assert results[0][0].tolist() == [10, 11, 12]
    assert results[1][0].tolist() == [15, 14, 13]
    assert results[2][1].tolist() == [15, 10]
    # a replay calls the module attribute with out=
    rec.sites[1].replay()
    assert got[-1][0] is own and got[-1][1] is rec.sites[1].static[0]


def test_site_copy_back():
    """A wrapper without out=: each later result is copied into the
    capture's tensors (here a dict), and a result tensor that already is
    the capture's is left as it is."""
    calls = []

    def fold(x, scale):
        calls.append(x)
        return {"a": x * scale, "b": x}

    x = torch.ones(3)
    site = graphs._Site(tp, "fold", (x, 2), {}, fold(x, 2))
    first = site.result
    y = torch.full((3,), 4.0)
    assert site.call(fold, (y, 3), {}) is first
    assert first["a"].tolist() == [12.0] * 3
    assert first["b"].tolist() == [4.0] * 3  # copied: y is not x
    assert site.call(fold, (x, 1), {})["b"] is x
