"""The port's pooled step with the in-scan slot handoff, and its state
migration, against the JAX package's: golden-read events with standby
windows armed, so that decided slots switch mid-block; every state key
and dtype compared after every event (zero tolerance)."""

import os

import numpy as np
import pytest
import torch

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)

# primaries deciding at events 34, 38 and 38 (one never decides) and
# their standbys
PRIMARY = ("sim_0000_Escherichia_coli_3854_+", "sim_0003_Escherichia_coli_6188_-",
           "sim_0005_Escherichia_coli_3483_+", "noise_1")
STANDBY = ("sim_0002_Escherichia_coli_6254_+", "sim_0001_Escherichia_coli_3623_-",
           "sim_0007_Escherichia_coli_7193_+", "sim_0006_Escherichia_coli_5000_+")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, t, what=""):
    a = np.asarray(j)
    b = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    assert np.array_equal(a, b), (what, np.argwhere(a != b)[:5])


def _same_state(js, ts, what):
    from uncalled_tpu_torch.convert import state_to_numpy

    got = state_to_numpy(ts)
    assert set(got) == set(js), what
    for k in js:
        _eq(js[k], got[k], f"{what} key {k}")


def _golden_events(rids):
    from uncalled_tpu_torch import native
    from uncalled_tpu_torch.mapping.batch import normalize_events
    from uncalled_tpu_torch.poremodel import load_default

    model = load_default()
    sigs = np.load(os.path.join(FX, "golden_reads.npz"), allow_pickle=True)
    out = []
    for r in rids:
        ev = native.detect_events(sigs[r], 0.0, 40000.0)
        out.append(normalize_events(ev["mean"], model.means_mean,
                                    model.means_stdv)[0])
    return out


def _index():
    from uncalled_tpu.index.bwa_compat import load_bwa_index
    from uncalled_tpu.mapping.engine import device_index
    from uncalled_tpu.mapping.oracle import load_uncl
    from uncalled_tpu.poremodel import load_default

    from uncalled_tpu_torch.convert import index_from_numpy

    idx = device_index(load_bwa_index(PREFIX), load_uncl(PREFIX + ".uncl"),
                       load_default())
    tabs = {k: v for k, v in idx.items() if not isinstance(v, int)}
    meta = {k: v for k, v in idx.items() if isinstance(v, int)}
    tidx = index_from_numpy({k: (v if isinstance(v, int) else np.asarray(v))
                             for k, v in idx.items()})
    return tabs, meta, tidx


def _run_handoff(kw, NE, W, promote_at, jkw=None):
    """NE events of the four primaries with every slot's standby armed
    (windows W wide), one at a time through both steps; at ``promote_at``
    the host promotes slot 0's standby (primary lane fed from the
    standby's stream at its device evt_i).  Returns both final states."""
    import jax
    import jax.numpy as jnp

    from uncalled_tpu.mapping import pooled as jp

    from uncalled_tpu_torch.mapping import pooled as tp

    B = 4
    prim = _golden_events(PRIMARY)
    stby = _golden_events(STANDBY)
    means = np.zeros((B, NE), np.float32)
    on = np.zeros((B, NE), bool)
    for b, e in enumerate(prim):
        m = e[:NE]
        means[b, : len(m)] = m
        on[b, : len(m)] = True
    sb_m = np.zeros((B, W), np.float32)
    sb_o = np.zeros((B, W), bool)
    for b, e in enumerate(stby):
        sb_m[b, : min(W, len(e))] = e[:W]
        sb_o[b, : min(W, len(e))] = True
    armed = np.ones(B, bool)

    jpp = jp.PoolParams(handoff=True, **kw, **(jkw or {}))
    tpp = tp.PoolParams(handoff=True, **kw)
    tabs, meta, tidx = _index()
    adv = jax.jit(lambda s, m, o, sb, t: jp.pool_advance_block(
        dict(t, **meta), jpp, s, m, o, sb=sb))
    js = jax.jit(jp.reset_pool_rows)(jp.make_pool_state(jpp),
                                     jnp.ones(B, bool))
    ts = tp.reset_pool_rows(tp.make_pool_state(tpp), torch.ones(B,
                                                                dtype=bool))
    _same_state(js, ts, "reset")
    for t in range(NE):
        prom = np.zeros(B, bool)
        if t == promote_at:
            assert bool(ts["sw"][0]), "slot 0 must have switched by now"
            prom[0] = True
            e0 = int(ts["evt_i"][0])
            m = stby[0][e0: e0 + NE - t]
            means[0, t:] = 0
            on[0, t:] = False
            means[0, t: t + len(m)] = m
            on[0, t: t + len(m)] = True
        sb = (sb_m, sb_o, armed, prom)
        js = adv(js, means[:, t: t + 1], on[:, t: t + 1],
                 tuple(jnp.asarray(a) for a in sb), tabs)
        ts = tp.pool_advance_block(tidx, tpp, ts, _t(means[:, t: t + 1]),
                                   _t(on[:, t: t + 1]),
                                   sb=tuple(_t(a) for a in sb))
        _same_state(js, ts, f"event {t}")
    return js, ts, jpp, tpp


@pytest.mark.parametrize("sort_mode,S,SC,NE,W", [
    # flat sort; slots 1 and 2 run their standby past the W-wide window
    ("flat", 2048, 2560, 76, 32),
    # bitonic at SC > 8192 (NP = 16384: one merge level, k_lv = 16384)
    ("bitonic", 8192, 10240, 48, 64),
])
def test_handoff_step_matches_jax_every_event(sort_mode, S, SC, NE, W):
    kw = dict(B=4, S=S, SC=SC, CL=2048, RE=1024, RT=2048, R=512, FS=256,
              sort_mode=sort_mode)
    # JAX holds the bitonic sort's merge levels in its Pallas kernel
    # (interpret mode on the CPU)
    jkw = dict(sortkern=True, stepkern_interpret=True) \
        if sort_mode == "bitonic" else None
    js, ts, _, _ = _run_handoff(kw, NE, W, promote_at=44, jkw=jkw)
    got = {k: v.numpy() for k, v in ts.items()}
    # three slots switched; slot 0 was promoted, the others still run
    # their standby; the latch holds the primaries' decisions
    assert list(got["lt_success"]) == [True, True, True, False]
    assert list(got["sw"]) == [False, True, True, False]
    assert (got["lt_dec_evt"][:3] >= 30).all()
    if W == 32:  # slots 1 and 2 stalled at the end of their window
        assert list(got["evt_i"][1:3]) == [W, W]


def test_migrate_pool_state_matches_jax():
    """A handed-off state moved into a narrower, smaller pool: -1 slots
    take fresh values, the rest their source row and pool segment."""
    import jax.numpy as jnp

    from uncalled_tpu.mapping import pooled as jp

    from uncalled_tpu_torch.mapping import pooled as tp

    kw = dict(B=4, S=2048, SC=2560, CL=2048, RE=1024, RT=2048, R=512,
              FS=256, sort_mode="flat")
    js, ts, jpp, tpp = _run_handoff(kw, 40, 64, promote_at=None)
    n_paths = ts["n_paths"].numpy()
    sel = np.array([3, -1, 1], np.int32)
    Sd = 256
    assert n_paths[[3, 1]].sum() <= Sd < n_paths.sum()
    dkw = dict(kw, B=3, S=Sd, SC=320)
    jd = jp.PoolParams(handoff=True, **dkw)
    td = tp.PoolParams(handoff=True, **dkw)
    jm = jp.migrate_pool_state(jpp, jd, js, jnp.asarray(sel))
    tm = tp.migrate_pool_state(tpp, td, ts, _t(sel))
    _same_state(jm, tm, "migrated")
    assert int(tm["n_paths"][1]) == 0 and bool(tm["done"][1])
    assert int((tm["q_rid"] < 3).sum()) == int(n_paths[[3, 1]].sum())
