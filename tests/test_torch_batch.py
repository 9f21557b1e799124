"""The port's BatchMapper on the CPU gives the reference's golden PAF
lines byte for byte (the conf of tests/test_pooled.py, with the slot
handoff and the drain chain off; tests/test_torch_drain_batch.py runs
them, and neither changes a PAF byte)."""

import json
import os

import numpy as np
import pytest
import torch

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")

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


def conf(B=4, spr=512):
    from uncalled_tpu_torch.config import Conf

    c = Conf()
    c.engine.batch_reads = B
    c.engine.pooled = True
    c.engine.pool_slots_per_read = spr
    c.engine.slot_handoff = False
    c.engine.drain_shrink = False
    return c


def test_golden_paf_identical_all(assets):
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.pooled import PooledEngine

    fmi, model, th, golden, sigs = assets
    bm = BatchMapper(fmi, model, th, conf(), device="cpu")
    assert isinstance(bm.eng, PooledEngine)
    got = {p.rd_name: p.to_line()
           for p in bm.map_reads([Read(r, sigs[r]) for r in golden])}
    for rid in golden:
        assert got[rid] == golden[rid], rid
    # the pooled per-read budget is the reference's: nothing may overflow
    assert bm.ovf_why == {}
