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


EVEN = 0x55555555
U32 = 0xFFFFFFFF


def lf_pre(r, j, n, primary, L2):
    """csrc/sa_lookup.cu's ``lf_pre`` in numpy (int64, any shape): what the
    step takes from r and j = r - (r >= primary) while the bucket row loads.
    The 64-bit mask of the bucket's bases 0 ... j & 31 (word 0 high, MSB
    first) is laid out as x / y are (word 0's bases on the even bits, word
    1's on the odd); ``bit`` marks base j & 31 there.  For r == n and the
    primary row the mask and the checkpoints' ``keep`` are 0 and each base's
    addend is its LF (L2[c + 1], 0); else L2[c], plus (j & 31) + 1 for base
    0.  Returns (mask, bit, keep, [4, *] addends)."""
    r, j = np.asarray(r, np.int64), np.asarray(j, np.int64)
    L2 = np.asarray(L2, np.int64)
    pos = j & 31
    pm = np.left_shift(np.uint64(2**64 - 1), (62 - 2 * pos).astype(np.uint64))
    pm0 = (pm >> np.uint64(32)).astype(np.int64)
    pm1 = (pm & np.uint64(U32)).astype(np.int64)
    prim = r == primary
    fixed = prim | (r >= n)
    mask = np.where(fixed, 0, (pm0 & EVEN) | (pm1 & (U32 ^ EVEN)))
    bit = np.left_shift(np.int64(1), np.where(pos < 16, 30 - 2 * pos,
                                              63 - 2 * pos))
    keep = np.where(fixed, 0, U32)
    add = np.stack([np.where(fixed, np.where(prim, 0, L2[c + 1]),
                             L2[c] + (pos + 1 if c == 0 else 0))
                    for c in range(4)])
    return mask, bit, keep, add


def lf_counts(w0, w1, mask):
    """The kernel's three popcounts under ``mask`` over the bucket's words
    interleaved into x (each base's low bit) and y (its high bit): the
    counts of bases 1, 2, 3 ([3, *]) and of 1 + 2 + 3, from which base 0's
    follows."""
    w0, w1 = np.asarray(w0, np.int64), np.asarray(w1, np.int64)
    x = (w0 & EVEN) | ((w1 << 1) & (U32 ^ EVEN))
    y = ((w0 >> 1) & EVEN) | (w1 & (U32 ^ EVEN))

    def pc(v):
        return np.bitwise_count(v.astype(np.uint32)).astype(np.int64)

    n1, n12, n3 = pc(x & ~y & mask), pc((x ^ y) & mask), pc(x & y & mask)
    return x, y, np.stack([n1, n12 - n1, n3]), n12 + n3


def lf_post(pre, row):
    """csrc/sa_lookup.cu's ``lf_post`` in numpy: LF from the bucket row
    ``row`` ([*, 6] of uint32 values: the checkpoints of bases 0-3, then the
    two words): the four candidate LF values, then the select by the base's
    two bits (bit ``bit`` of y, then of x).  int32, wrapped as the kernel
    adds."""
    mask, bit, keep, add = pre
    row = np.asarray(row, np.int64)
    x, y, n123, nz = lf_counts(row[..., 4], row[..., 5], mask)
    ck = row[..., :4] & keep[..., None]
    v = [add[0] + ck[..., 0] - nz] + [add[c] + ck[..., c] + n123[c - 1]
                                       for c in (1, 2, 3)]
    lo, hi = (x & bit) != 0, (y & bit) != 0
    lf = np.where(hi, np.where(lo, v[3], v[2]), np.where(lo, v[1], v[0]))
    return (lf & U32 ^ 2**31) - 2**31


def _kernel_walk(idx, rows, intv):
    """csrc/sa_lookup.cu's ``sa_lookup_kernel`` in numpy, every row at
    once: rows clamped to [0, n]; while a row is live and within the step
    cap, its bucket row j >> 5 of j = r - (r >= primary) (in [0, n - 1]),
    then lf_pre and lf_post.  Returns (values, steps)."""
    n, primary = idx["n"], idx["primary"]
    words = np.asarray(idx["occ_rows"]).view(np.uint32).astype(np.int64)
    samp = np.asarray(idx["sa_samp"]).astype(np.int64)
    r = np.clip(np.asarray(rows, np.int64), 0, n)
    steps = np.zeros_like(r)
    pow2 = (intv & (intv - 1)) == 0  # the kernel's mask-and-shift path

    def live(v):
        return (v & (intv - 1) if pow2 else v % intv) != 0

    going = live(r)
    while going.any():
        g = np.flatnonzero(going)
        j = r[g] - (r[g] >= primary)
        assert ((j >= 0) & (j < n)).all()
        r[g] = lf_post(lf_pre(r[g], j, n, primary, idx["L2"]),
                       words[j >> 5])
        steps[g] += 1
        going[g] = live(r[g]) & (steps[g] <= n)
    slot = r >> (intv.bit_length() - 1) if pow2 else r // intv
    return samp[slot] + steps, steps


def test_kernel_step_model_matches_jax(indexes):
    """The kernel's fused step (one bucket row for base and occ) on every
    row of the index plus the edge rows, against JAX, the plain version
    and the walk lengths of walk_model."""
    import jax.numpy as jnp

    from uncalled_tpu.mapping.engine import _sa_lookup

    from uncalled_tpu_torch.ops.sa_lookup import sa_lookup_plain, walk_model

    fmi, jidx, tidx = indexes
    rows = np.concatenate([_rows(fmi, "edges"), _rows(fmi, "all")]).astype(
        np.int32)
    want = np.asarray(_sa_lookup(jidx, jnp.asarray(rows), INTV))
    idx = {k: (v if isinstance(v, int) else np.asarray(v))
           for k, v in jidx.items()}
    got, got_steps = _kernel_walk(idx, rows, INTV)
    steps, _ = walk_model(fmi.sa_full, INTV)
    assert np.array_equal(got, want)
    assert np.array_equal(got, sa_lookup_plain(tidx, _t(rows), INTV).numpy())
    assert np.array_equal(got_steps, steps[rows])


def test_kernel_step_model_other_intv():
    """The kernel's step at intv 24 (its divide path) on every row of the
    example index, against the plain version and the walk lengths."""
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping import engine as te
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.ops.sa_lookup import sa_lookup_plain, walk_model
    from uncalled_tpu_torch.poremodel import load_default

    fmi = load_bwa_index(PREFIX)
    tidx = te.device_index(fmi, load_uncl(PREFIX + ".uncl"), load_default(),
                           device="cpu", sampled_sa=True, sa_intv=24)
    rows = np.arange(fmi.n + 1, dtype=np.int32)
    idx = {k: (v if isinstance(v, int) else v.numpy())
           for k, v in tidx.items()}
    got, got_steps = _kernel_walk(idx, rows, 24)
    assert np.array_equal(got, sa_lookup_plain(tidx, _t(rows), 24).numpy())
    assert np.array_equal(got_steps, walk_model(fmi.sa_full, 24)[0])


@pytest.mark.parametrize("case", ["seeded", "example", "fixed"])
def test_three_popcounts_match_count_word(indexes, case):
    """The kernel's counts (three popcounts over the interleaved words,
    base 0's by difference) equal count_word's two-word sum (the plain
    version's ``_occ_count`` with zero checkpoints) for every rem in 0..31
    and every base, and its base bits the plain version's base: on seeded
    random words with the all-0, all-1 and alternating words, and on every
    bucket row of the example index.  On the example index LF from
    lf_pre / lf_post equals the plain step (``_lf_local``) on every row,
    and rows n and primary give L2[c + 1] and 0."""
    from uncalled_tpu_torch.mapping.engine import _occ_count
    from uncalled_tpu_torch.ops.sa_lookup import _lf_local

    fmi, _, tidx = indexes
    occ = tidx["occ_rows"].numpy()
    n, primary = tidx["n"], tidx["primary"]
    if case == "fixed":
        r = np.array([n, primary], np.int64)
        j = r - (r >= primary)
        word = occ.view(np.uint32)[(n - 1) >> 5, 4 + ((n - 1) & 31) // 16]
        c = (int(word) >> (2 * (15 - ((n - 1) & 15)))) & 3
        # the index's L2, and one whose totals disagree with the counts (on
        # a consistent index _occ's full count at r == n is also the count
        # through row n - 1, so only this L2 tells the two apart)
        for L2 in (tidx["L2"], tidx["L2"] + _t(np.array([0, 1, 3, 7, 15],
                                                        np.int32))):
            lf = lf_post(lf_pre(r, j, n, primary, L2.numpy()),
                         occ.view(np.uint32)[j >> 5])
            assert lf.tolist() == [int(L2[c + 1]), 0]
            want = _lf_local(tidx["occ_rows"], L2, _t(r.astype(np.int32)), n,
                             primary, 0)
            assert np.array_equal(lf, want.numpy())
        return
    if case == "seeded":
        rng = np.random.default_rng(13)
        words = np.concatenate([
            np.array([[0, 0], [U32, U32], [EVEN, EVEN], [U32 ^ EVEN, EVEN],
                      [EVEN, U32 ^ EVEN], [0, U32]], np.uint32),
            rng.integers(0, 2**32, (250, 2), dtype=np.uint32)])
    else:
        words = occ[:, 4:].view(np.uint32)
        r = np.arange(n + 1, dtype=np.int64)
        j = r - (r >= primary)
        lf = lf_post(lf_pre(r, j, n, primary, tidx["L2"].numpy()),
                     occ.view(np.uint32)[j >> 5])
        want = _lf_local(tidx["occ_rows"], tidx["L2"], _t(r.astype(np.int32)),
                         n, primary, 0)
        assert np.array_equal(lf, want.numpy())
    # every word pair x every rem x every base
    R = len(words)
    rem = np.broadcast_to(np.arange(32)[None, :, None], (R, 32, 4))
    base = np.broadcast_to(np.arange(4)[None, None, :], (R, 32, 4))
    w = np.broadcast_to(words.astype(np.int64)[:, None, None, :],
                        (R, 32, 4, 2))
    mask, bit, _, _ = lf_pre(rem, rem, 2**30, -1, np.zeros(5, np.int64))
    x, y, n123, nz = lf_counts(w[..., 0], w[..., 1], mask)
    counts = np.stack([rem + 1 - nz, *n123])  # [4, R, 32, 4]
    got = np.take_along_axis(counts, base[None], 0)[0]
    row = np.zeros((R, 32, 4, 6), np.int64)
    row[..., 4:] = w
    row = (row ^ 2**31) - 2**31  # as int32
    k = _t(rem.astype(np.int32))
    want = _occ_count({"n": 2**30, "L2": torch.zeros(5, dtype=torch.int32)},
                      k, _t(base.astype(np.int32)), k,
                      _t(row.astype(np.int32))).numpy()
    assert np.array_equal(got, want)
    # the base at rem: bit ``bit`` of y (high) and of x (low)
    c = 2 * ((y & bit) != 0) + ((x & bit) != 0)
    word = np.where(rem < 16, w[..., 0], w[..., 1])
    assert np.array_equal(c, (word >> (2 * (15 - (rem & 15)))) & 3)


def test_sa_lookup_launch_off_the_cpu(monkeypatch):
    """A tensor off the CPU goes to the launcher with the table sizes and
    counts one launch; the plain version never runs there; tables that do
    not cover n, a primary row outside [1, n], wrong dtypes and a bad intv
    raise."""
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
        ({"primary": 0}, meta(6144), 32),  # not an FM index's primary row
        ({"primary": n + 1}, meta(6144), 32),
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
