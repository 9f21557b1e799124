"""The port's BatchMapper slot recycling and pooled eject tiers on the CPU
(mirrors of tests/test_pooled.py's slot-recycle and pool-exhaustion
tests)."""

import json
import os

import numpy as np
import pytest
import torch

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")
RID = "sim_0000_Escherichia_coli_3854_+"

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


def conf(B):
    from uncalled_tpu_torch.config import Conf

    c = Conf()
    c.engine.batch_reads = B
    c.engine.pooled = True
    c.engine.pool_slots_per_read = 512
    c.engine.slot_handoff = False
    c.engine.drain_shrink = False
    return c


def test_slots_recycle(assets):
    """More reads than slots: pool segments must not leak across refills."""
    from uncalled_tpu_torch.mapping.batch import BatchMapper

    fmi, model, th, golden, sigs = assets
    rids = [
        "sim_0002_Escherichia_coli_6254_+",
        "sim_0005_Escherichia_coli_3483_+",
        "sim_0008_Escherichia_coli_1891_+",
        "sim_0009_Escherichia_coli_2589_+",
        "sim_0010_Escherichia_coli_4033_+",  # 5 reads through 4 slots
    ]
    bm = BatchMapper(fmi, model, th, conf(4), device="cpu")
    got = {p.rd_name: p.to_line()
           for p in bm.map_reads([Read(r, sigs[r]) for r in rids])}
    for rid in rids:
        assert got[rid] == golden[rid], rid


def test_pool_exhaustion_wide_pool_tier(assets):
    """A pool too small for the read sets the overflow flag, and the pooled
    wide tier restores byte parity."""
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.pooled import PooledEngine

    fmi, model, th, golden, sigs = assets
    c = conf(2)
    c.engine.remap_ladder = ((1024, 2, 128, 256, 0),)
    bm = BatchMapper(fmi, model, th, c, device="cpu", S=128, SC=160)
    got = {p.rd_name: p.to_line()
           for p in bm.map_reads([Read(RID, sigs[RID])])}
    assert bm.ovf_why, "tiny pool must overflow"
    assert isinstance(bm._next_mapper.eng, PooledEngine)
    assert [m.n_ejected for m in bm.tiers()] == [1, 0]
    assert got[RID] == golden[RID]


def test_last_tier_ejects_are_recorded(assets):
    """When every pooled tier trips (tiny pool_wide and pool_max), each
    tier records the overflow and the read goes on to the classic final
    rung, which gives the golden line (mirror of
    tests/test_pooled.py::test_pooled_exhaustion_chains_to_classic_final_rung)."""
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.engine import MapEngine
    from uncalled_tpu_torch.mapping.pooled import PooledEngine

    fmi, model, th, golden, sigs = assets
    c = conf(2)
    c.engine.pool_wide = (96, 256)
    c.engine.pool_max = (112, 256)
    c.engine.remap_ladder = ((1024, 2, 128, 256, 0),)
    bm = BatchMapper(fmi, model, th, c, device="cpu", S=128, SC=160)
    got = {p.rd_name: p.to_line()
           for p in bm.map_reads([Read(RID, sigs[RID])])}
    tiers = bm.tiers()
    assert [m._pool_tier for m in tiers[:3]] == [0, 1, 2]
    assert all(isinstance(m.eng, PooledEngine) for m in tiers[:3])
    assert all(m.ovf_why[RID] & (2 | 8) for m in tiers[:3])
    assert [m.n_ejected for m in tiers] == [1, 1, 1, 0]
    final = tiers[3]
    assert isinstance(final.eng, MapEngine) and final._rung == 1
    assert got[RID] == golden[RID]
