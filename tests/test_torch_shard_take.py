"""The row-sharded FM primitives of the port against the JAX package (zero
tolerance): ``_shard_take`` against JAX's under ``shard_map`` on an
idx-only mesh of 2 and of 4 devices (``occ_rows``, ``sa`` and ``sa_samp``;
padding rows and rows in no shard), the sharded ``sa_lookup`` against
JAX's ``_sa_lookup`` under ``shard_map`` on every row of the example
index (intv 32 and 24), the plain versions of both kernels (``shard_take``,
``sa_walk_step``) against the JAX formulas, numpy replays of the two CUDA
kernels' index arithmetic, and the wrappers' launch path off the CPU.

The idx ranks of the port run here as threads of one process, each with
its own block of the tables; a stand-in for the idx group sums their
tensors at each all-reduce.  The real collectives run in
tests/test_torch_sharded.py (four ``gloo`` ranks).  The CUDA kernels are
held against the plain versions on the card by chip_smoke.py.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from uncalled_tpu_torch.ops.shard_take import ShardContext

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(j, t, what=""):
    a = np.asarray(j)
    b = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a, b), (what, np.argwhere(a != b)[:5])


def _pad(a, mult):
    extra = (-len(a)) % mult
    return np.pad(a, [(0, extra)] + [(0, 0)] * (a.ndim - 1)) if extra else a


class ThreadAxis:
    """A stand-in idx group for ranks that are threads: all_reduce sums
    the ranks' tensors."""

    def __init__(self, n):
        self.n = n
        self.bar = threading.Barrier(n)
        self.parts = [None] * n


class ThreadShard(ShardContext):
    def __init__(self, axis, rank):
        super().__init__(None, rank)
        self.axis = axis

    def all_reduce(self, t, host=False):
        a = self.axis
        a.parts[self.rank] = t.clone()
        a.bar.wait()
        total = sum(a.parts[1:], a.parts[0].clone())
        a.bar.wait()
        self.calls += 1
        t.copy_(total)
        return (t, total) if host else t


def on_ranks(nix, fn):
    """fn(rank, ShardContext) on nix threads; their results in rank order."""
    axis = ThreadAxis(nix)
    out, errs = [None] * nix, []

    def run(k):
        try:
            out[k] = fn(k, ThreadShard(axis, k))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)
            axis.bar.abort()

    ths = [threading.Thread(target=run, args=(k,)) for k in range(nix)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=120)
    if errs:
        raise errs[0]
    return out


@pytest.fixture(scope="module")
def tables():
    """(n, primary, numpy tables: occ_rows, L2, the full SA and its 1/32
    and 1/24 samples)."""
    from uncalled_tpu.index.bwa_compat import load_bwa_index
    from uncalled_tpu.mapping.engine import device_index
    from uncalled_tpu.mapping.oracle import load_uncl
    from uncalled_tpu.poremodel import load_default

    fmi = load_bwa_index(PREFIX)
    th, model = load_uncl(PREFIX + ".uncl"), load_default()
    full = device_index(fmi, th, model)
    t = {k: np.asarray(v) for k, v in full.items() if not isinstance(v, int)}
    for intv in (32, 24):
        t[f"sa_samp{intv}"] = np.asarray(device_index(
            fmi, th, model, sampled_sa=True, sa_intv=intv)["sa_samp"])
    return int(full["n"]), int(full["primary"]), t


def query_rows(n_rows, nix, rng):
    """Seeded rows over the padded table plus the edges: rows in no shard
    (negative, at and past the padded end) and the padding rows."""
    padded = n_rows + (-n_rows) % nix
    edges = np.array([-(2**31), -7, -1, 0, 1, n_rows - 1, n_rows,
                      padded - 1, padded, padded + 5, 2**31 - 1])
    rows = np.concatenate([edges, rng.integers(-50, padded + 50, 3989)])
    return rows.astype(np.int32).reshape(-1, 5)


def jax_shard_take(tbl, rows, nix):
    """JAX's _shard_take under shard_map on an idx-only mesh of nix
    devices (the table row-sharded, the rows replicated)."""
    from jax import shard_map

    from uncalled_tpu.mapping.engine import _shard_take

    mesh = jax.make_mesh((nix,), ("idx",), devices=jax.devices()[:nix])
    spec = P("idx", None) if tbl.ndim == 2 else P("idx")
    fn = shard_map(
        lambda t, r: _shard_take({"tbl": t, "shard_axis": "idx"}, "tbl", r),
        mesh=mesh, in_specs=(spec, P()), out_specs=P(), check_vma=False)
    return np.asarray(fn(jnp.asarray(_pad(tbl, nix)), jnp.asarray(rows)))


@pytest.mark.parametrize("nix", [2, 4])
@pytest.mark.parametrize("key", ["occ_rows", "sa", "sa_samp32"])
def test_shard_take_matches_jax(tables, key, nix):
    from uncalled_tpu_torch.mapping.engine import _shard_take

    _, _, t = tables
    tbl = t[key]
    rows = query_rows(len(tbl), nix, np.random.default_rng(nix))
    want = jax_shard_take(tbl, rows, nix)
    padded = _pad(tbl, nix)
    per = len(padded) // nix

    def rank(k, sh):
        idx = {key: _t(padded[k * per: (k + 1) * per]), "shard": sh}
        return _shard_take(idx, key, _t(rows))

    for got in on_ranks(nix, rank):
        _eq(want, got, key)
    assert want.shape == rows.shape + tbl.shape[1:]


def jax_sa_lookup(n, primary, t, rows, intv, nix):
    from jax import shard_map

    from uncalled_tpu.mapping.engine import _sa_lookup

    mesh = jax.make_mesh((nix,), ("idx",), devices=jax.devices()[:nix])

    def fn(occ, samp, L2, r):
        idx = {"occ_rows": occ, "sa_samp": samp, "L2": L2, "n": n,
               "primary": primary, "shard_axis": "idx"}
        return _sa_lookup(idx, r, intv)

    run = shard_map(fn, mesh=mesh,
                    in_specs=(P("idx", None), P("idx"), P(), P()),
                    out_specs=P(), check_vma=False)
    return np.asarray(run(jnp.asarray(_pad(t["occ_rows"], nix)),
                          jnp.asarray(_pad(t[f"sa_samp{intv}"], nix)),
                          jnp.asarray(t["L2"]), jnp.asarray(rows)))


@pytest.mark.parametrize("intv", [32, 24])
def test_sharded_sa_lookup_matches_jax(tables, intv):
    """Every row of the example index through the sharded walk (rounds of
    one sa_walk_step and one sum over idx) on 2 idx ranks, against JAX's
    walk under shard_map (two psums a step) and the unsharded lookup."""
    from uncalled_tpu_torch.ops import sa_lookup as sl

    n, primary, t = tables
    nix = 2
    rows = np.arange(n + 1, dtype=np.int32)
    want = jax_sa_lookup(n, primary, t, rows, intv, nix)
    occ = _pad(t["occ_rows"], nix)
    samp = _pad(t[f"sa_samp{intv}"], nix)
    po, ps = len(occ) // nix, len(samp) // nix
    whole = {"occ_rows": _t(t["occ_rows"]), "sa_samp": _t(t[f"sa_samp{intv}"]),
             "L2": _t(t["L2"]), "n": n, "primary": primary}
    _eq(want, sl.sa_lookup_plain(whole, _t(rows), intv))

    def rank(k, sh):
        idx = {"occ_rows": _t(occ[k * po: (k + 1) * po]),
               "sa_samp": _t(samp[k * ps: (k + 1) * ps]), "L2": _t(t["L2"]),
               "n": n, "primary": primary, "shard": sh}
        got = sl.sa_lookup(idx, _t(rows), intv)
        return got, sh.calls

    res = on_ranks(nix, rank)
    steps, _ = sl.walk_model(np.asarray(t["sa"]), intv)
    for got, calls in res:
        _eq(want, got, f"intv {intv}")
        # one sum a round, fewer rounds than the longest walk's steps, and
        # the sample's take
        assert 2 <= calls <= int(steps.max()) + 1


def jax_step(n, primary, t, r, intv):
    """One step of JAX's walk (the while_loop body of _sa_lookup, unsharded:
    its base read and _occ through the whole table)."""
    from uncalled_tpu.mapping.engine import _occ

    idx = {"occ_rows": jnp.asarray(t["occ_rows"]), "L2": jnp.asarray(t["L2"]),
           "n": n, "primary": primary}
    r = jnp.asarray(r)
    live = (r % intv) != 0
    j = jnp.maximum(r - (r > primary), 0)
    row = jnp.take(idx["occ_rows"], j >> 5, axis=0)
    pos = j & 31
    word = jnp.where(pos < 16, row[..., 4], row[..., 5])
    sh = ((15 - (pos & 15)) * 2).astype(jnp.uint32)
    base = (jax.lax.shift_right_logical(
        jax.lax.bitcast_convert_type(word, jnp.uint32), sh)
        & jnp.uint32(3)).astype(jnp.int32)
    oh4 = base[..., None] == jnp.arange(4, dtype=jnp.int32)
    L2b = jnp.sum(jnp.where(oh4, idx["L2"][:4], 0), axis=-1, dtype=jnp.int32)
    lf = jnp.where(r == primary, 0, L2b + _occ(idx, r, base))
    return np.asarray(jnp.where(live, lf, r))


@pytest.mark.parametrize("nix", [2, 4])
@pytest.mark.parametrize("intv", [32, 24])
def test_walk_step_plain_matches_jax(tables, intv, nix):
    """One round on every row: the blocks' sa_walk_step_plain summed over
    the idx ranks is, for each row, (JAX's walk step applied k times, k):
    every live row moves at least one step, and stops where it is resolved
    or its next bucket row lies in another block.  Each block answers only
    the rows it owns (the resolved rows on block 0 only)."""
    from uncalled_tpu_torch.ops.sa_lookup import _owned, sa_walk_step_plain

    n, primary, t = tables
    r = np.arange(n + 1, dtype=np.int32)
    occ = _pad(t["occ_rows"], nix)
    per = len(occ) // nix
    parts = [sa_walk_step_plain(_t(occ[k * per: (k + 1) * per]), _t(t["L2"]),
                                _t(r), n, primary, intv, k * per).numpy()
             for k in range(nix)]
    r1, k1 = sum(parts)
    live = r % intv != 0
    assert (k1[live] >= 1).all() and (k1[~live] == 0).all()
    want, prev = r.copy(), r.copy()  # prev: the row before the last step
    for step in range(int(k1.max())):
        nxt = jax_step(n, primary, t, want, intv)
        prev = np.where(step < k1, want, prev)
        want = np.where(step < k1, nxt, want)
    assert np.array_equal(r1, want)

    def block_of(x):
        own = [_owned(_t(x), primary, k * per, per)[0].numpy()
               for k in range(nix)]
        assert (np.sum(own, 0) == 1).all()  # one owner for every row
        return np.argmax(own, 0)

    moved = k1 > 0
    stopped = (r1 % intv == 0) | (block_of(r1) != block_of(prev))
    assert stopped[moved].all()
    for k, (pr, pk) in enumerate(parts):
        own = block_of(r) == k
        assert (pk[live & ~own] == 0).all() and (pr[live & ~own] == 0).all()
        assert (pr[~live] == (r[~live] if k == 0 else 0)).all()


@pytest.mark.parametrize("nix", [2, 4])
def test_shard_take_plain_matches_jax_formula(tables, nix):
    """Each block's shard_take_plain is the local half of JAX's
    _shard_take: clamp the local index, take, zero the rows not owned."""
    from uncalled_tpu_torch.ops.shard_take import shard_take_plain

    _, _, t = tables
    for key in ("occ_rows", "sa"):
        tbl = _pad(t[key], nix)
        per = len(tbl) // nix
        rows = query_rows(len(t[key]), nix, np.random.default_rng(7))
        for k in range(nix):
            blk = jnp.asarray(tbl[k * per: (k + 1) * per])
            local = jnp.asarray(rows) - k * per
            ok = (local >= 0) & (local < per)
            g = jnp.take(blk, jnp.clip(local, 0, per - 1), axis=0)
            m = ok if g.ndim == ok.ndim else ok[..., None]
            want = np.asarray(jnp.where(m, g, jnp.zeros((), g.dtype)))
            _eq(want, shard_take_plain(_t(tbl[k * per: (k + 1) * per]),
                                       _t(rows), k * per), (key, k))


def test_shard_take_kernel_model(tables):
    """csrc/shard.cu's indexing replayed in numpy: the 32-bit unsigned
    ownership test (row - lo mod 2^32 below per); F = 6 a warp of 32 rows,
    lane l moving the warp's 8-byte words l, l + 32 and l + 64 (word w is
    part w % 3 of the warp's row w // 3, whose index comes from lane
    w // 3), the last warp cut at N; F = 1 one thread a row; zeros where the
    row is not owned.  Against the plain version on both blocks of a split
    in 2, with rows in no shard and at the int32 extremes, N not a
    multiple of 32."""
    _, _, t = tables
    for key in ("occ_rows", "sa"):
        _kernel_model_case(t, key)


def _kernel_model_case(t, key):
    from uncalled_tpu_torch.ops.shard_take import shard_take_plain

    tbl = _pad(t[key], 2)
    per = len(tbl) // 2
    rows = query_rows(len(t[key]), 2, np.random.default_rng(3))
    rows = np.concatenate([rows.reshape(-1), np.array(
        [-(2**31), -1, 0, per - 1, per, 2 * per - 1, 2 * per, 2**31 - 1],
        np.int32)]).astype(np.int32)
    N = len(rows)
    assert N % 32
    for lo in (0, per):
        blk = np.ascontiguousarray(tbl[lo: lo + per])
        F = blk.shape[1] if blk.ndim == 2 else 1
        assert F == (6 if key == "occ_rows" else 1)
        r = (rows.astype(np.uint32) - np.uint32(lo)).astype(np.uint32)
        if F == 6:
            words = blk.view(np.int64).reshape(-1)
            out = np.zeros(3 * N, np.int64)
            for r0 in range(0, N, 32):
                nrow = min(32, N - r0)
                rl = np.full(32, 0xFFFFFFFF, np.uint32)
                rl[:nrow] = r[r0: r0 + nrow]
                for q in range(3):
                    word = np.arange(32) + 32 * q
                    row = word // 3
                    rr = rl[row]
                    own = rr < np.uint32(per)
                    src = np.where(own, rr.astype(np.int64) * 3
                                   + (word - row * 3), 0)
                    v = np.where(own, words[src], 0)
                    keep = row < nrow
                    out[r0 * 3 + word[keep]] = v[keep]
            out = out.view(np.int32)
        else:
            own = r < np.uint32(per)
            out = np.where(own, blk[np.where(own, r, 0)], 0)
        want = shard_take_plain(_t(blk), _t(rows), lo).numpy()
        assert np.array_equal(out.reshape(want.shape).astype(np.int32), want)


def test_walk_step_kernel_model(tables):
    """csrc/sa_lookup.cu's sa_walk_step loop replayed in numpy on every row
    with the kernel's step (``lf_pre`` / ``lf_post`` of
    tests/test_torch_sa_lookup.py: the 64-bit mask from j, three popcounts,
    the select by the base's bits) and its block rules (the primary row
    stepped only by block 0, a foreign bucket row or a resolved row ending
    the run, each load at the owned bucket row or clamped into the block,
    the kept-row rule), both blocks of a split in 2, intv 32 and 24, against
    the plain version."""
    from test_torch_sa_lookup import lf_post, lf_pre

    from uncalled_tpu_torch.ops.sa_lookup import sa_walk_step_plain

    n, primary, t = tables
    occ = _pad(t["occ_rows"], 2)
    per = len(occ) // 2
    words = occ.view(np.uint32).astype(np.int64)
    r0 = np.arange(n + 1, dtype=np.int64)
    for intv in (32, 24):
        pow2 = (intv & (intv - 1)) == 0

        def live(v):
            return (v & (intv - 1) if pow2 else v % intv) != 0

        for lo in (0, per):
            def at(v):
                """j, owned, and the block row the kernel loads (the
                unsigned b clamped to per - 1)."""
                j = v - (v >= primary)
                b = (j >> 5) - lo
                own = np.where(v == primary, lo == 0, (b >= 0) & (b < per))
                return j, own, np.where((b < 0) | (b >= per), per - 1, b)

            r, steps = r0.copy(), np.zeros_like(r0)
            j, own, blk = at(r)
            going = live(r) & own
            while going.any():
                g = np.flatnonzero(going)
                r[g] = lf_post(lf_pre(r[g], j[g], n, primary, t["L2"]),
                               words[lo + blk[g]])
                steps[g] += 1
                j, own, blk = at(r)
                going[g] = live(r[g]) & own[g] & (steps[g] <= n)
            kept = (steps > 0) | (~live(r) & (lo == 0))
            got = sa_walk_step_plain(_t(occ[lo: lo + per]), _t(t["L2"]),
                                     _t(r0.astype(np.int32)), n, primary,
                                     intv, lo).numpy()
            assert np.array_equal(np.where(kept, r, 0).astype(np.int32),
                                  got[0])
            assert np.array_equal(steps.astype(np.int32), got[1])


def test_launch_off_the_cpu(monkeypatch):
    """Tensors off the CPU go to the launchers with their sizes and count
    one launch each; the plain versions never run there; wrong dtypes,
    shapes and blocks raise."""
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import sa_lookup as sl
    from uncalled_tpu_torch.ops import shard_take as st

    seen = []

    def fake_launch(name, *args):
        seen.append((name, tuple(a.shape for a in args if hasattr(a, "shape")),
                     tuple(a for a in args if not hasattr(a, "shape"))))

    def refuse(*a):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(_cuda, "launch", fake_launch)
    monkeypatch.setattr(_cuda, "COUNTS", dict.fromkeys(_cuda.COUNTS, 0))
    monkeypatch.setattr(st, "shard_take_plain", refuse)
    monkeypatch.setattr(sl, "sa_walk_step_plain", refuse)

    def meta(*shape, dt=torch.int32):
        return torch.empty(shape, dtype=dt, device="meta")

    n, primary, per = 9_400_001, 4_123_457, 146_876
    out = st.shard_take(meta(per, 6), meta(245760), per)
    assert out.shape == (245760, 6) and out.dtype == torch.int32
    assert st.shard_take(meta(per), meta(64, 96), 0).shape == (64, 96)
    assert st.shard_take(meta(per, 6), meta(0), 0).shape == (0, 6)
    out = sl.sa_walk_step(meta(per, 6), meta(5), meta(3072), n, primary, 32,
                          per)
    assert out.shape == (2, 3072)
    assert seen == [
        ("shard_take_i32", ((per, 6), (245760,), (245760, 6)),
         (245760, 6, per, per)),
        ("shard_take_i32", ((per,), (64, 96), (64, 96)), (6144, 1, 0, per)),
        ("sa_walk_step_i32", ((per, 6), (5,), (3072,), (2, 3072)),
         (3072, n, primary, 32, per, per)),
    ]
    assert _cuda.COUNTS == dict(dict.fromkeys(_cuda.COUNTS, 0),
                                shard_take=2, sa_walk_step=1)
    bad = [
        lambda: st.shard_take(meta(per, 6), meta(64, dt=torch.int64), 0),
        lambda: st.shard_take(meta(per, 6, dt=torch.float32), meta(64), 0),
        lambda: st.shard_take(meta(per, 6, 2), meta(64), 0),
        lambda: st.shard_take(meta(per, 6), meta(64), -1),
        lambda: st.shard_take(meta(per, 4), meta(64), 0),
        lambda: st.shard_take(meta(per * 6 + 1)[1:].view(per, 6), meta(64),
                              0),
        lambda: sl.sa_walk_step(meta(per, 4), meta(5), meta(64), n, primary,
                                32, 0),
        lambda: sl.sa_walk_step(meta(per, 6), meta(5), meta(64), n, primary,
                                0, 0),
        lambda: sl.sa_walk_step(meta(per, 6), meta(5, dt=torch.int64),
                                meta(64), n, primary, 32, 0),
    ]
    for fn in bad:
        with pytest.raises((TypeError, ValueError)):
            fn()
    assert len(seen) == 3
