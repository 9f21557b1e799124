"""The sampled-SA path of the port against the JAX package (zero tolerance):
the index tables, the LF-walk lookup (plain version, the CUDA kernel's
step as a numpy replay, the wrapper's launch path off the CPU) and one
pooled and one classic step with ``sampled_sa=True`` on every state key
after every event.  The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py."""

import os

import numpy as np
import pytest
import torch

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")
INTV = 32

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


@pytest.fixture(scope="module")
def indexes():
    """(JAX fmi, JAX sampled index, port sampled index on the CPU)."""
    from uncalled_tpu.index.bwa_compat import load_bwa_index
    from uncalled_tpu.mapping.engine import device_index
    from uncalled_tpu.mapping.oracle import load_uncl
    from uncalled_tpu.poremodel import load_default

    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index as tload
    from uncalled_tpu_torch.mapping import engine as te
    from uncalled_tpu_torch.mapping.thresholds import load_uncl as tuncl
    from uncalled_tpu_torch.poremodel import load_default as tmodel

    fmi = load_bwa_index(PREFIX)
    jidx = device_index(fmi, load_uncl(PREFIX + ".uncl"), load_default(),
                        sampled_sa=True, sa_intv=INTV)
    tidx = te.device_index(tload(PREFIX), tuncl(PREFIX + ".uncl"), tmodel(),
                           device="cpu", sampled_sa=True, sa_intv=INTV)
    return fmi, jidx, tidx


def test_device_index_sampled_matches_jax(indexes):
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping import engine as te
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    fmi, jidx, tidx = indexes
    assert set(tidx) == set(jidx) and "sa" not in tidx
    for k, v in jidx.items():
        if isinstance(v, int):
            assert tidx[k] == v and isinstance(tidx[k], int), k
        else:
            _eq(v, tidx[k], k)
    assert tidx["sa_samp"].shape == ((fmi.n + INTV) // INTV,)
    full = te.device_index(load_bwa_index(PREFIX), load_uncl(PREFIX + ".uncl"),
                           load_default(), device="cpu")
    assert "sa" in full and "sa_samp" not in full
    _eq(fmi.sa_full[::INTV], tidx["sa_samp"])


def _rows(fmi, case):
    from uncalled_tpu_torch.ops.sa_lookup import walk_model

    n, primary = fmi.n, fmi.primary
    if case == "seeded":  # the JAX package's own case (test_engine.py)
        return np.random.default_rng(3).integers(0, n + 1, (4, 64)).astype(
            np.int32)
    if case == "edges":  # ends, the primary row and the longest walks
        steps, _ = walk_model(fmi.sa_full, INTV)
        longest = np.argsort(-steps, kind="stable")[:64]
        edge = [0, 1, n - 1, n, primary - 1, primary, primary + 1]
        return np.concatenate([edge, longest]).astype(np.int32)
    return np.arange(n + 1, dtype=np.int32)  # every row


@pytest.mark.parametrize("case", ["seeded", "edges", "all"])
def test_sa_lookup_plain_matches_jax(indexes, case):
    import jax.numpy as jnp

    from uncalled_tpu.mapping.engine import _sa_lookup

    from uncalled_tpu_torch.ops.sa_lookup import sa_lookup, walk_model

    fmi, jidx, tidx = indexes
    rows = _rows(fmi, case)
    want = np.asarray(_sa_lookup(jidx, jnp.asarray(rows), INTV))
    got = sa_lookup(tidx, _t(rows), INTV)
    _eq(want, got)
    # the model from the full SA: sa_full where the walk meets a sampled row,
    # sa_full + n + 1 where it passes the primary row first
    steps, value = walk_model(fmi.sa_full, INTV)
    assert np.array_equal(value[rows], want.astype(np.int64))
    crossed = value[rows] != fmi.sa_full[rows]
    assert np.array_equal(want[~crossed], fmi.sa_full[rows][~crossed])
    assert np.array_equal(want[crossed],
                          fmi.sa_full[rows][crossed] + fmi.n + 1)
    if case == "edges":
        # the walk is not bounded by intv - 1 (rows are sampled by row,
        # not by text position)
        assert steps[rows].max() == 201 and crossed.any()
    if case == "all":
        assert np.isclose(steps.mean(), 29.8947, atol=1e-4)
        assert np.array_equal(np.flatnonzero(value != fmi.sa_full),
                              np.flatnonzero(fmi.sa_full < 52))


def test_sa_lookup_other_intv_matches_jax():
    """An intv that is not a power of two (the kernel's general path) on
    every row of the example index: the index tables, the lookup and the
    walk model against JAX."""
    import jax.numpy as jnp

    from uncalled_tpu.index.bwa_compat import load_bwa_index
    from uncalled_tpu.mapping.engine import _sa_lookup, device_index
    from uncalled_tpu.mapping.oracle import load_uncl
    from uncalled_tpu.poremodel import load_default

    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index as tload
    from uncalled_tpu_torch.mapping import engine as te
    from uncalled_tpu_torch.mapping.thresholds import load_uncl as tuncl
    from uncalled_tpu_torch.ops.sa_lookup import sa_lookup, walk_model
    from uncalled_tpu_torch.poremodel import load_default as tmodel

    intv = 24
    fmi = load_bwa_index(PREFIX)
    jidx = device_index(fmi, load_uncl(PREFIX + ".uncl"), load_default(),
                        sampled_sa=True, sa_intv=intv)
    tidx = te.device_index(tload(PREFIX), tuncl(PREFIX + ".uncl"), tmodel(),
                           device="cpu", sampled_sa=True, sa_intv=intv)
    _eq(jidx["sa_samp"], tidx["sa_samp"])
    rows = np.arange(fmi.n + 1, dtype=np.int32)
    want = np.asarray(_sa_lookup(jidx, jnp.asarray(rows), intv))
    _eq(want, sa_lookup(tidx, _t(rows), intv))
    _, value = walk_model(fmi.sa_full, intv)
    assert np.array_equal(value, want.astype(np.int64))


def _kernel_walk(idx, r, intv):
    """csrc/sa_lookup.cu's loop for one row, step for step in numpy ints:
    one bucket row (j = r - (r > primary)) serves the base and the occ
    count; LF(primary) = 0.  Returns (value, steps)."""
    n, primary = idx["n"], idx["primary"]
    occ = np.asarray(idx["occ_rows"]).view(np.uint32)
    L2 = np.asarray(idx["L2"]).astype(np.int64)
    samp = np.asarray(idx["sa_samp"])
    even = 0x55555555

    def count_word(word, inc, c):
        x = int(word) ^ (c * even)
        nx = ~x & 0xFFFFFFFF
        m = nx & (nx >> 1) & even
        pm = 0 if inc <= 0 else 0xFFFFFFFF if inc >= 16 else \
            (0xFFFFFFFF << ((16 - inc) * 2)) & 0xFFFFFFFF
        return bin(m & pm).count("1")

    r, steps = min(max(int(r), 0), n), 0
    pow2 = (intv & (intv - 1)) == 0  # the kernel's mask-and-shift path
    while (r & (intv - 1) if pow2 else r % intv) != 0:
        if r == primary:
            r = 0
        else:
            j = r - (r > primary)
            row = occ[j >> 5]
            pos = j & 31
            word = int(row[4] if pos < 16 else row[5])
            c = (word >> ((15 - (pos & 15)) * 2)) & 3
            if r >= n:
                o = int(L2[c + 1] - L2[c])
            else:
                rem = j & 31
                o = int(row[c]) + count_word(row[4], rem + 1, c) + \
                    count_word(row[5], rem - 15, c)
            r = int(L2[c]) + o
        steps += 1
    slot = r >> (intv.bit_length() - 1) if pow2 else r // intv
    return int(samp[slot]) + steps, steps


def test_kernel_step_model_matches_jax(indexes):
    """The kernel's fused step (one bucket row for base and occ) on every
    row of a stride through the index plus the edge rows, against JAX and
    against the walk lengths of walk_model."""
    import jax.numpy as jnp

    from uncalled_tpu.mapping.engine import _sa_lookup

    from uncalled_tpu_torch.ops.sa_lookup import walk_model

    fmi, jidx, _ = indexes
    rows = np.concatenate([_rows(fmi, "edges"),
                           np.arange(0, fmi.n + 1, 7)]).astype(np.int32)
    want = np.asarray(_sa_lookup(jidx, jnp.asarray(rows), INTV))
    idx = {k: (v if isinstance(v, int) else np.asarray(v))
           for k, v in jidx.items()}
    got = np.array([_kernel_walk(idx, r, INTV) for r in rows])
    steps, _ = walk_model(fmi.sa_full, INTV)
    assert np.array_equal(got[:, 0], want)
    assert np.array_equal(got[:, 1], steps[rows])


def test_sa_lookup_launch_off_the_cpu(monkeypatch):
    """A tensor off the CPU goes to the launcher with the table sizes and
    counts one launch; the plain version never runs there; tables that do
    not cover n, wrong dtypes and a bad intv raise."""
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import sa_lookup as sl

    seen = []

    def fake_launch(name, *args):
        seen.append((name, tuple(a.shape for a in args[:5]), args[5:]))

    def refuse(*a):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(_cuda, "launch", fake_launch)
    monkeypatch.setattr(_cuda, "COUNTS", dict.fromkeys(_cuda.COUNTS, 0))
    monkeypatch.setattr(sl, "sa_lookup_plain", refuse)

    def meta(*shape, dt=torch.int32):
        return torch.empty(shape, dtype=dt, device="meta")

    n, primary = 9_400_001, 4_123_457
    idx = {"occ_rows": meta((n + 31) // 32, 6), "sa_samp": meta(n // 32 + 1),
           "L2": meta(5), "n": n, "primary": primary}
    out = sl.sa_lookup(idx, meta(64, 256), 32)
    assert out.shape == (64, 256) and out.dtype == torch.int32
    assert sl.sa_lookup(idx, meta(0), 32).shape == (0,)  # nothing launched
    assert seen == [("sa_lookup_i32",
                     (((n + 31) // 32, 6), (n // 32 + 1,), (5,), (64, 256),
                      (64, 256)), (16384, n, primary, 32))]
    assert _cuda.COUNTS == dict(dict.fromkeys(_cuda.COUNTS, 0), sa_lookup=1)
    bad = [
        ({"sa_samp": meta(n // 32)}, meta(6144), 32),  # misses row n
        ({"occ_rows": meta(n // 32 - 1, 6)}, meta(6144), 32),
        ({"occ_rows": meta((n + 31) // 32, 4)}, meta(6144), 32),
        ({}, meta(6144, dt=torch.int64), 32),
        ({"L2": meta(5, dt=torch.float32)}, meta(6144), 32),
        ({}, meta(6144), 0),
    ]
    for over, rows, intv in bad:
        with pytest.raises((TypeError, ValueError)):
            sl.sa_lookup(dict(idx, **over), rows, intv)
    assert _cuda.COUNTS["sa_lookup"] == 1


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


def _events(rids, B, NE):
    means = np.zeros((B, NE), np.float32)
    on = np.zeros((B, NE), bool)
    for b, e in enumerate(_golden_events(rids)):
        m = e[:NE]
        means[b, : len(m)] = m
        on[b, : len(m)] = True
    return means, on


RIDS = ("sim_0000_Escherichia_coli_3854_+", "sim_0001_Escherichia_coli_3623_-",
        "sim_0003_Escherichia_coli_6188_-", "noise_1")


def _eq_state(js, ts, what):
    from uncalled_tpu_torch.convert import state_to_numpy

    got = state_to_numpy(ts)
    assert set(got) == set(js), (what, set(got) ^ set(js))
    for k in js:
        _eq(js[k], got[k], f"{what} key {k}")


def test_pool_step_sampled_matches_jax_every_event(indexes):
    import jax
    import jax.numpy as jnp

    from uncalled_tpu.mapping import pooled as jp

    from uncalled_tpu_torch.mapping import pooled as tp

    _, jidx, tidx = indexes
    B, NE = 4, 48
    means, on = _events(RIDS, B, NE)
    kw = dict(B=B, S=4096, SC=5120, CL=2048, RE=1024, RT=2048, R=512,
              FS=256, sampled_sa=True, sa_intv=INTV)
    jpp, tpp = jp.PoolParams(**kw), tp.PoolParams(**kw)
    tabs = {k: v for k, v in jidx.items() if not isinstance(v, int)}
    meta = {k: v for k, v in jidx.items() if isinstance(v, int)}
    adv = jax.jit(lambda s, m, o, t: jp.pool_advance_block(
        dict(t, **meta), jpp, s, m, o))
    js = jax.jit(jp.reset_pool_rows)(jp.make_pool_state(jpp),
                                     jnp.ones(B, bool))
    ts = tp.reset_pool_rows(tp.make_pool_state(tpp),
                            torch.ones(B, dtype=bool))
    for t in range(NE):
        js = adv(js, means[:, t: t + 1], on[:, t: t + 1], tabs)
        ts = tp.pool_advance_block(tidx, tpp, ts, _t(means[:, t: t + 1]),
                                   _t(on[:, t: t + 1]))
        _eq_state(js, ts, f"event {t}")
    assert int(np.asarray(js["evt_i"]).max()) >= 40
    assert int(np.asarray(js["cl_valid"]).sum()) > 0  # seed rows were looked up


def test_classic_step_sampled_matches_jax_every_event(indexes):
    import jax
    import jax.numpy as jnp

    from uncalled_tpu.mapping import engine as je

    from uncalled_tpu_torch.mapping import engine as te

    _, jidx, tidx = indexes
    B, NE = 4, 48
    means, on = _events(RIDS, B, NE)
    budgets = dict(P=256, C=256, CE=0, R=64, CL=64, sampled_sa=True,
                   sa_intv=INTV)
    jpp = je.EngineParams(B=B, mxu=False, **budgets)
    tpp = te.EngineParams(B=B, **budgets)
    tabs = {k: v for k, v in jidx.items() if not isinstance(v, int)}
    meta = {k: v for k, v in jidx.items() if isinstance(v, int)}
    adv = jax.jit(lambda s, m, o, t: je.advance_block(
        dict(t, **meta), jpp, s, m, o))
    all_on = np.ones(B, bool)
    js = jax.jit(je.reset_rows)(je.make_state(jpp), jnp.asarray(all_on))
    ts = te.reset_rows(te.make_state(tpp), _t(all_on))
    for t in range(NE):
        js = adv(js, means[:, t: t + 1], on[:, t: t + 1], tabs)
        ts = te._event_step(tidx, tpp, ts, _t(means[:, t]), _t(on[:, t]))
        _eq_state(js, ts, f"event {t}")
    assert int(np.asarray(js["evt_i"]).max()) >= 40
    assert int(np.asarray(js["cl_valid"]).sum()) > 0
