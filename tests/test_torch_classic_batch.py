"""The port's BatchMapper on the classic engine (``conf.engine.pooled =
False``) and its remap ladder, on the CPU: golden PAF lines byte for byte
(mirrors of tests/test_engine.py's FAST_SUBSET and narrow-ladder tests
and of tests/test_pooled.py's pool_wide=() test; the pooled tiers' chain
to the classic final rung is in tests/test_torch_batch_tiers.py).  The
full 14 golden reads, more reads than slots, run on the classic engine on
the card (chip_smoke.py phase 3): several of them climb the default ladder,
whose B=128 rung is slow on the CPU."""

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


def conf(B, pooled):
    from uncalled_tpu_torch.config import Conf

    c = Conf()
    c.engine.batch_reads = B
    c.engine.pooled = pooled
    c.engine.slot_handoff = False
    c.engine.drain_shrink = False
    return c


def run(bm, sigs, golden, rids):
    got = {p.rd_name: p.to_line()
           for p in bm.map_reads([Read(r, sigs[r]) for r in rids])}
    for rid in rids:
        assert got[rid] == golden[rid], rid


def test_classic_paf_identical_fast_subset(assets):
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.engine import MapEngine

    fmi, model, th, golden, sigs = assets
    bm = BatchMapper(fmi, model, th, conf(4, False), device="cpu")
    assert isinstance(bm.eng, MapEngine)
    p = bm.eng.params
    assert (p.B, p.P, p.C, p.R, p.CL) == (4, 1024, 1024, 256, 1024)
    run(bm, sigs, golden, FAST_SUBSET)


def test_remap_ladder_restores_parity(assets):
    """Absurdly narrow budgets trip the overflow flag, and the ladder
    (narrow -> mid -> final rung) still gives the golden lines."""
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.engine import MapEngine

    fmi, model, th, golden, sigs = assets
    c = conf(4, False)
    c.engine.remap_ladder = ((64, 4, 8, 16, 0), (1024, 4, 48, 128, 0))
    bm = BatchMapper(fmi, model, th, c, device="cpu", P=32, C=32, R=4, CL=8)
    run(bm, sigs, golden, FAST_SUBSET)
    # the narrow run really overflowed, and the reads really went up
    assert bm.n_ejected == len(FAST_SUBSET) and bm.ovf_why
    rungs = bm.tiers()
    assert [m._rung for m in rungs] == list(range(len(rungs)))
    assert all(isinstance(m.eng, MapEngine) for m in rungs)
    assert rungs[-1]._rung == 2 and rungs[-1].eng.params.P == 1024


def test_pool_wide_disabled_goes_to_classic_ladder(assets):
    """pool_wide=() routes a pooled entry's ejects straight onto the
    classic remap ladder."""
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.engine import MapEngine

    fmi, model, th, golden, sigs = assets
    rid = FAST_SUBSET[0]
    c = conf(2, True)
    c.engine.pool_slots_per_read = 512
    c.engine.pool_wide = ()
    c.engine.remap_ladder = ((1024, 2, 128, 256, 0),)
    bm = BatchMapper(fmi, model, th, c, device="cpu", S=128, SC=160)
    run(bm, sigs, golden, [rid])
    assert bm.ovf_why, "tiny pool must overflow"
    assert isinstance(bm._next_mapper.eng, MapEngine)
    assert bm._next_mapper._rung == 1
