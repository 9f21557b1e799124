"""The port's classic engine state and step against the JAX engine's: fresh
and reset state, then whole events on the golden reads' normalised events
with every state key and dtype compared after every event (zero
tolerance), at budgets that fit and at budgets that trip every overflow
bit."""

import os

import numpy as np
import pytest
import torch

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)


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


def _eq_state(js, ts, what=""):
    from uncalled_tpu_torch.convert import state_to_numpy

    got = state_to_numpy(ts)
    assert set(got) == set(js), (what, set(got) ^ set(js))
    for k in js:
        _eq(js[k], got[k], f"{what} key {k}")


def test_make_state_and_reset_rows():
    import jax.numpy as jnp

    from uncalled_tpu.mapping import engine as je

    from uncalled_tpu_torch.convert import state_from_numpy
    from uncalled_tpu_torch.mapping import engine as te

    kw = dict(B=5, P=24, CL=12, seed_len=22)
    js = je.make_state(je.EngineParams(**kw))
    _eq_state(js, te.make_state(te.EngineParams(**kw)), "fresh")
    # a state full of non-zero values, reset at two slots
    rng = np.random.default_rng(1)
    full = {}
    for k, v in js.items():
        v = np.asarray(v)
        if v.dtype == np.bool_:
            full[k] = rng.random(v.shape) < 0.5
        elif v.dtype == np.float32:
            full[k] = rng.standard_normal(v.shape).astype(np.float32)
        else:
            full[k] = rng.integers(-99, 99, v.shape).astype(np.int32)
    mask = np.array([True, False, True, False, False])
    want = je.reset_rows({k: jnp.asarray(v) for k, v in full.items()},
                         jnp.asarray(mask))
    got = te.reset_rows(state_from_numpy(full), _t(mask))
    _eq_state({k: np.asarray(v) for k, v in want.items()}, got, "reset")


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


@pytest.mark.parametrize(
    "rids,budgets,NE,refill_at",
    [
        # budgets that hold these reads; slot 0 refills mid-run
        (("sim_0000_Escherichia_coli_3854_+", "sim_0001_Escherichia_coli_3623_-",
          "sim_0003_Escherichia_coli_6188_-", "noise_1"),
         dict(P=256, C=256, CE=0, R=64, CL=64), 56, 30),
        # budgets that trip every overflow bit (1 CL, 2 CE, 4 C, 8 P, 16 R)
        (("sim_0007_Escherichia_coli_7193_+", "sim_0011_Escherichia_coli_6633_-",
          "noise_1", "f41a60f7-de4a-4b17-9f54-387e52d60b65"),
         dict(P=48, C=40, CE=56, R=1, CL=2), 60, None),
    ],
)
def test_classic_step_matches_jax_every_event(rids, budgets, NE, refill_at):
    import jax
    import jax.numpy as jnp

    from uncalled_tpu.index.bwa_compat import load_bwa_index
    from uncalled_tpu.mapping import engine as je
    from uncalled_tpu.mapping.oracle import load_uncl
    from uncalled_tpu.poremodel import load_default

    from uncalled_tpu_torch.convert import index_from_numpy, state_to_numpy
    from uncalled_tpu_torch.mapping import engine as te

    B = 4
    evs = _golden_events(rids)
    means = np.zeros((B, NE), np.float32)
    on = np.zeros((B, NE), bool)
    for b, e in enumerate(evs):
        m = e[:NE]
        means[b, : len(m)] = m
        on[b, : len(m)] = True
    if refill_at is not None:  # slot 0 takes read 0 again from its start
        m = evs[0][: NE - refill_at]
        means[0, refill_at: refill_at + len(m)] = m
        on[0, refill_at: refill_at + len(m)] = True

    jpp = je.EngineParams(B=B, mxu=False, **budgets)
    tpp = te.EngineParams(B=B, **budgets)
    idx = je.device_index(load_bwa_index(PREFIX), load_uncl(PREFIX + ".uncl"),
                          load_default())
    tabs = {k: v for k, v in idx.items() if not isinstance(v, int)}
    meta = {k: v for k, v in idx.items() if isinstance(v, int)}
    adv = jax.jit(lambda s, m, o, t: je.advance_block(
        dict(t, **meta), jpp, s, m, o))
    reset = jax.jit(je.reset_rows)
    tidx = index_from_numpy({k: (v if isinstance(v, int) else np.asarray(v))
                             for k, v in idx.items()})

    all_on = np.ones(B, bool)
    js = reset(je.make_state(jpp), jnp.asarray(all_on))
    ts = te.reset_rows(te.make_state(tpp), _t(all_on))
    ts0 = ts
    _eq_state(js, ts, "reset")
    for t in range(NE):
        if t == refill_at:
            mask = np.array([True, False, False, False])
            js = reset(js, jnp.asarray(mask))
            ts = te.reset_rows(ts, _t(mask))
        js = adv(js, means[:, t: t + 1], on[:, t: t + 1], tabs)
        ts = te._event_step(tidx, tpp, ts, _t(means[:, t]), _t(on[:, t]))
        _eq_state(js, ts, f"event {t}")
    got = state_to_numpy(ts)
    assert got["evt_i"].max() >= 40
    if refill_at is None:
        # every budget really bound, and advance_block over the whole run
        # ends in the same state as the per-event steps
        for bit in (1, 2, 4, 8, 16):
            assert (got["ovf_why"] & bit).any(), bit
        _eq_state(got, te.advance_block(tidx, tpp, ts0, _t(means), _t(on)),
                  "advance_block")
    # the debug taps ride the same step: (state, taps [T, B, ...])
    st_dbg, dbg = te.advance_block(tidx, tpp, ts, _t(means[:, :1]),
                                   _t(on[:, :1]), debug=True)
    _eq_state(state_to_numpy(te.advance_block(
        tidx, tpp, ts, _t(means[:, :1]), _t(on[:, :1]))), st_dbg, "debug")
    assert dbg["seed_ref_en"].shape == (1, B, tpp.R)
