"""The seed-tracker folds' input range on real step states.

The CUDA folds pick the matched cluster as a lexicographic maximum of
order-preserving key words, which equals the plain folds' (and the JAX
kernels') NEG-masked cascade only where every cluster's total, r1 and
evt_en are >= NEG = -2^30 (the precondition stated at
``uncalled_tpu_torch/csrc/tracker_kernel.cu``).  This test maps golden
reads through the port's pooled and classic steps on the CPU and holds
every table that reaches ``tracker_run_compact`` and ``tracker_run`` (the
kernel ``tracker_fold_rows``) to that range, before and after each fold."""

import json
import os

import numpy as np
import pytest
import torch

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")
NEG = -(1 << 30)
READS = [
    "sim_0000_Escherichia_coli_3854_+",
    "sim_0003_Escherichia_coli_6188_-",
    "sim_0006_Escherichia_coli_5000_+",
]

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


def _low(st):
    """The least total, r1 and evt_en of a tracker table."""
    return {k: int(st[k].min()) for k in ("cl_total", "cl_r1", "cl_evt_en")}


@pytest.mark.parametrize("pooled", [True, False])
def test_fold_inputs_stay_above_neg(monkeypatch, assets, pooled):
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping import pooled as pm
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.ops import tracker_kernel as tk

    fmi, model, th, golden, sigs = assets
    seen = []

    def hold(fold):
        def run(*a):
            out = fold(*a)
            seen.append((_low(a[1]), _low(out)))
            return out
        return run

    if pooled:
        monkeypatch.setattr(pm, "tracker_run_compact",
                            hold(pm.tracker_run_compact))
    else:
        monkeypatch.setattr(tk, "tracker_run", hold(tk.tracker_run))
    c = Conf()
    c.engine.batch_reads = 4
    c.engine.pooled = pooled
    bm = BatchMapper(fmi, model, th, c, device="cpu")
    got = {p.rd_name: p.to_line()
           for p in bm.map_reads([Read(r, sigs[r]) for r in READS])}
    assert all(got[r] == golden[r] for r in READS)
    assert len(seen) > 10
    bad = [(i, s) for i, s in enumerate(seen)
           if min(v for d in s for v in d.values()) < NEG]
    assert not bad, bad[:3]
