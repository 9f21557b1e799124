"""A read that never decides, mapped to the end of its signal: noise_1 of
the golden set cut to its first 2000 samples (a few hundred events; the
whole read runs 2250 events), through the port's ``BatchMapper`` on the
pooled and on the classic engine against the JAX package's.  The line is
unmapped and byte-identical to JAX's; its query length is the events the
read ran.  ``chip_smoke.py`` phase 3 holds the pooled case on the card to
the port's CPU run."""

import os

import numpy as np
import pytest
import torch

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")
CUT = 2000

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


def _conf(Conf, pooled):
    c = Conf()
    c.engine.batch_reads = 4
    c.engine.pooled = pooled
    c.engine.pool_slots_per_read = 512
    c.engine.evt_block = 64
    c.engine.slot_handoff = False
    c.engine.drain_shrink = False
    return c


@pytest.mark.parametrize("pooled", [True, False], ids=["pooled", "classic"])
def test_undecided_read_line_matches_jax(pooled):
    from uncalled_tpu.config import Conf as JConf
    from uncalled_tpu.index.bwa_compat import load_bwa_index as jbwa
    from uncalled_tpu.mapping.batch import BatchMapper as JBM
    from uncalled_tpu.mapping.oracle import load_uncl as juncl
    from uncalled_tpu.poremodel import load_default as jmodel

    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    sigs = np.load(os.path.join(FX, "golden_reads.npz"))
    reads = [Read("noise_1", sigs["noise_1"][:CUT])]
    bm = BatchMapper(load_bwa_index(PREFIX), load_default(),
                     load_uncl(PREFIX + ".uncl"), _conf(Conf, pooled),
                     device="cpu")
    got = [p.to_line() for p in bm.map_reads(reads)]
    jbm = JBM(jbwa(PREFIX), jmodel(), juncl(PREFIX + ".uncl"),
              _conf(JConf, pooled))
    want = [p.to_line() for p in jbm.map_reads(reads)]
    assert got == want
    cols = got[0].split("\t")
    assert cols[0] == "noise_1" and cols[2:11] == ["*"] * 9
    assert 0 < int(cols[1]) < 2250
    assert bm.n_ejected == 0
