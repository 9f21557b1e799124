"""The port's BatchMapper in sampled-SA mode on the CPU: the golden PAF
lines byte for byte on the classic engine (tests/test_engine.py's
FAST_SUBSET) and on the pooled engine (tests/test_pooled.py's first six
reads), and the SA mode carried to every engine built below the entry
(drains, eject tiers, ladder rungs), none of which keeps the full SA."""

import json
import os

import numpy as np
import pytest
import torch

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")
FAST_SUBSET = [
    "sim_0000_Escherichia_coli_3854_+",
    "sim_0003_Escherichia_coli_6188_-",  # reverse strand
    "sim_0006_Escherichia_coli_5000_+",  # regression: ended-parent seeds
]

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


def conf(B, pooled, spr=512):
    from uncalled_tpu_torch.config import Conf

    c = Conf()
    c.engine.batch_reads = B
    c.engine.pooled = pooled
    c.engine.pool_slots_per_read = spr
    c.engine.slot_handoff = False
    c.engine.drain_shrink = False
    return c


def run(bm, sigs, golden, rids):
    got = {p.rd_name: p.to_line()
           for p in bm.map_reads([Read(r, sigs[r]) for r in rids])}
    for rid in rids:
        assert got[rid] == golden[rid], rid


def sampled_everywhere(bm):
    """Every engine of the mapper's chain runs the 1/32 sample."""
    todo, seen = [bm], []
    while todo:
        m = todo.pop()
        if m is None or any(m is x for x in seen):
            continue
        seen.append(m)
        p, idx = m.eng.params, m.eng.idx
        assert p.sampled_sa and p.sa_intv == 32
        assert "sa_samp" in idx and "sa" not in idx
        todo += [m._drain_mapper, m._next_mapper]
    return len(seen)


@pytest.mark.parametrize("pooled", [False, True])
def test_sampled_sa_paf_identical(assets, pooled):
    """The classic engine on FAST_SUBSET (tests/test_engine.py
    test_sampled_sa_paf_identical) and the pooled engine on the first six
    golden reads (tests/test_pooled.py
    test_pooled_sampled_sa_paf_identical), both at B=4."""
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.engine import MapEngine
    from uncalled_tpu_torch.mapping.pooled import PooledEngine

    fmi, model, th, golden, sigs = assets
    bm = BatchMapper(fmi, model, th, conf(4, pooled), device="cpu",
                     sampled_sa=True, sa_intv=32)
    assert isinstance(bm.eng, PooledEngine if pooled else MapEngine)
    run(bm, sigs, golden, list(golden)[:6] if pooled else FAST_SUBSET)
    sampled_everywhere(bm)


def test_sampled_sa_reaches_tiers_and_rungs(assets):
    """A pool too small for the read ejects it to the pooled wide tier,
    and a narrow classic ladder sends reads up two rungs: every engine on
    the way is sampled, and the golden lines hold."""
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.engine import MapEngine
    from uncalled_tpu_torch.mapping.pooled import PooledEngine

    fmi, model, th, golden, sigs = assets
    rid = FAST_SUBSET[0]
    c = conf(2, True)
    c.engine.remap_ladder = ((1024, 2, 128, 256, 0),)
    bm = BatchMapper(fmi, model, th, c, device="cpu", S=128, SC=160,
                     sampled_sa=True)
    run(bm, sigs, golden, [rid])
    assert bm.n_ejected == 1 and isinstance(bm._next_mapper.eng, PooledEngine)
    assert sampled_everywhere(bm) >= 2

    c = conf(4, False)
    c.engine.remap_ladder = ((64, 4, 8, 16, 0), (1024, 4, 48, 128, 0))
    bm = BatchMapper(fmi, model, th, c, device="cpu", P=32, C=32, R=4, CL=8,
                     sampled_sa=True)
    run(bm, sigs, golden, FAST_SUBSET[:1])
    rungs = bm.tiers()
    assert [m._rung for m in rungs] == [0, 1, 2]
    assert all(isinstance(m.eng, MapEngine) for m in rungs)
    assert sampled_everywhere(bm) == 3
