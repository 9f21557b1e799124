"""Shared fixture for the multi-process dp test: a deterministic tiny
index, a pooled engine and a read batch, built identically in every rank
(``testing/multihost_child.py``) and in the test's single-process JAX
reference (port of ``uncalled_tpu.testing.multihost_fixture``)."""

from __future__ import annotations

import os
import tempfile

import numpy as np

T = 8
SHARD_B = 2  # reads per dp shard (each shard runs an independent pool)


def build_engine(device=None):
    """PooledEngine with per-SHARD params (B=SHARD_B) on a deterministic
    synthetic index: ``pool_advance_block`` with these params is what each
    dp rank runs on its slice.  ``device`` as for every entry point (the
    card by default)."""
    from ..config import Conf
    from ..index.build import build_index
    from ..mapping.pooled import PooledEngine
    from ..mapping.thresholds import load_uncl
    from ..poremodel import load_default

    rng = np.random.default_rng(0)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 2000))
    with tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False) as f:
        f.write(f">mh_ref\n{seq}\n")
        fa = f.name
    try:
        fmi = build_index(fa)
    finally:
        os.unlink(fa)
    repo = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    threshes = load_uncl(
        os.path.join(repo, "tests", "fixtures", "example_index",
                     "example_ref.uncl")
    )
    conf = Conf()
    conf.engine.batch_reads = SHARD_B
    conf.engine.pool_slots_per_read = 64
    eng = PooledEngine(
        fmi, load_default(), threshes, conf, device=device,
        S=128, SC=160, CL=64, R=32, RE=64, RT=128, FS=32, mxu=False,
        sort_mode="flat", tracker_kernel=False, stepkern=False,
    )
    return eng, T


def global_inputs(n_shards: int):
    """Deterministic [n_shards*SHARD_B, T] event-mean batch."""
    rng = np.random.default_rng(1)
    B = n_shards * SHARD_B
    means = rng.normal(90.0, 12.0, (B, T)).astype(np.float32)
    on = np.ones((B, T), bool)
    return means, on


def global_fresh_state(eng, n_shards: int):
    """n_shards independent shard-local pools, concatenated on axis 0
    (the dp-sharded global layout; each shard sees its own fresh pool)."""
    from ..convert import state_to_numpy
    from ..mapping.pooled import make_pool_state

    local = state_to_numpy(make_pool_state(eng.params))
    return {k: np.concatenate([a] * n_shards, axis=0)
            for k, a in local.items()}
