"""``BatchMapper`` with ``conf.engine.device_dsp`` (a refill wave's event
detection through ``ops.events.detect_block``) on the port against the JAX
package's, on golden reads: every PAF line byte-identical, on the pooled
and on the classic engine.  The device DSP is the JAX detector's
arithmetic, not the host detector's, so these lines are JAX's, not the
golden ones; tests/test_engine.py's own check of the mode on the classic
engine (mapped locations within 50 bp of the host path's) is held too."""

import os

import numpy as np
import pytest
import torch

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")
RIDS = ["sim_0000_Escherichia_coli_3854_+",
        "sim_0003_Escherichia_coli_6188_-",  # reverse strand
        "sim_0006_Escherichia_coli_5000_+",
        "sim_0009_Escherichia_coli_2589_+",
        "sim_0011_Escherichia_coli_6633_-"]

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


def _conf(Conf, pooled, dsp=True):
    c = Conf()
    c.engine.pooled = pooled
    c.engine.batch_reads = 4
    c.engine.device_dsp = dsp
    c.engine.slot_handoff = False
    c.engine.drain_shrink = False
    return c


# the classic engine maps the first three (tests/test_engine.py's subset);
# more reads cost minutes of the port's CPU steps (the real read climbs the
# classic remap ladder; its detector rows are in tests/test_torch_events.py)
@pytest.mark.parametrize("pooled,n", [(True, 5), (False, 3)],
                         ids=["pooled", "classic"])
def test_device_dsp_lines_match_jax(pooled, n):
    import jax

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

    was = jax.config.jax_enable_x64
    sigs = np.load(os.path.join(FX, "golden_reads.npz"))
    reads = [Read(r, sigs[r]) for r in RIDS[:n]]
    fmi, model, th = (load_bwa_index(PREFIX), load_default(),
                      load_uncl(PREFIX + ".uncl"))
    bm = BatchMapper(fmi, model, th, _conf(Conf, pooled), device="cpu")
    waves = []
    orig = bm._prepare_wave
    bm._prepare_wave = lambda rs: waves.append(len(rs)) or orig(rs)
    got = {p.rd_name: p for p in bm.map_reads(reads)}
    try:
        jbm = JBM(jbwa(PREFIX), jmodel(), juncl(PREFIX + ".uncl"),
                  _conf(JConf, pooled))
        want = {p.rd_name: p.to_line() for p in jbm.map_reads(reads)}
    finally:
        jax.config.update("jax_enable_x64", was)
    assert waves and waves[0] == min(n, 4)  # the first refill: one wave
    assert {k: p.to_line() for k, p in got.items()} == want
    if pooled:
        return
    host = BatchMapper(fmi, model, th, _conf(Conf, pooled, dsp=False),
                       device="cpu")
    for h in host.map_reads(reads):
        d = got[h.rd_name]
        assert d.is_mapped == h.is_mapped and d.fwd == h.fwd, h.rd_name
        if h.is_mapped:
            assert d.rf_name == h.rf_name and abs(d.rf_st - h.rf_st) < 50
