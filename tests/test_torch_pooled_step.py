"""The port's pooled step against the JAX step: the flat helpers on seeded
inputs, then whole events on the golden reads' normalised events with
every state key and dtype compared after every event (zero tolerance)."""

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


# f32 specials the sort order must place exactly.  Subnormals are left
# out: XLA on the CPU (and the TPU) flushes them to zero, PyTorch and CUDA
# keep them, and the step's seed probabilities (sums of log-probabilities)
# never fall in that range.
SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0, -1.0,
                    2.0**-126, -(2.0**-126)], np.float32)


def test_f32_sort_key_roundtrip():
    import jax.numpy as jnp

    from uncalled_tpu.mapping import pooled as jp

    from uncalled_tpu_torch.mapping import pooled as tp

    rng = np.random.default_rng(0)
    x = np.concatenate([SPECIAL, rng.standard_normal(500).astype(np.float32)])
    x = np.concatenate([x, np.array([0x7FC01234, -0x1], np.int32).view(
        np.float32)])
    jk = jp._f32_sort_key(jnp.asarray(x))
    tk = tp._f32_sort_key(_t(x))
    _eq(jk, tk)
    _eq(jp._f32_from_sort_key(jk), tp._f32_from_sort_key(tk))


@pytest.mark.parametrize("seed", [0, 1])
def test_sort1d_with_ties(seed):
    import jax.numpy as jnp

    from uncalled_tpu.mapping import pooled as jp

    from uncalled_tpu_torch.mapping import pooled as tp

    rng = np.random.default_rng(seed)
    N = 3000
    k0 = rng.integers(0, 5, N).astype(np.int32)  # heavy ties
    k1 = rng.integers(-3, 3, N).astype(np.int32)
    k2 = rng.choice(SPECIAL, N)  # -0 == +0, NaNs equal and largest
    k3 = np.arange(N, dtype=np.int32)
    pay = rng.standard_normal(N).astype(np.float32)
    want = jp._sort1d(tuple(jnp.asarray(k) for k in (k0, k1, k2, k3)),
                      (jnp.asarray(pay),), num_keys=4)
    got = tp._sort1d(tuple(_t(k) for k in (k0, k1, k2, k3)), (_t(pay),),
                     num_keys=4)
    for a, b in zip(want, got):
        _eq(a, b)


def test_flat_helpers():
    import jax.numpy as jnp

    from uncalled_tpu.mapping import pooled as jp

    from uncalled_tpu_torch.mapping import pooled as tp

    rng = np.random.default_rng(3)
    # segmented running max (non-decreasing segment ids, as in the step)
    seg = np.cumsum(rng.random(4096) < 0.1).astype(np.int32)
    vals = rng.integers(-(2**31), 2**31 - 1, 4096, dtype=np.int64).astype(
        np.int32)
    for n in (4096, 1000):
        _eq(jp._seg_running_max(jnp.asarray(seg[:n]), jnp.asarray(vals[:n])),
            tp.seg_running_max(_t(seg[:n]), _t(vals[:n])))
    # bucket_of / seg_broadcast over sorted starts with empty segments and
    # starts past the output width
    cnt = rng.integers(0, 9, 40).astype(np.int32)
    cnt[[3, 4, 17]] = 0
    starts = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
    for w in (int(starts[-1]) + 5, int(starts[20])):
        _eq(jp._bucket_of(jnp.asarray(starts[:-1]), w),
            tp._bucket_of(_t(starts[:-1]), w))
        fi = rng.integers(-50, 50, 40).astype(np.int32)
        fb = rng.random(40) < 0.5
        for a, b in zip(
            jp._seg_broadcast([jnp.asarray(fi), jnp.asarray(fb)],
                              jnp.asarray(starts), w),
            tp._seg_broadcast([_t(fi), _t(fb)], _t(starts), w),
        ):
            _eq(a, b)
    # stable compaction and the lazy compaction map
    for p_true, N, w in ((0.3, 5000, 2000), (0.01, 3000, 4000),
                         (0.0, 300, 50), (1.0, 2600, 2600)):
        v = rng.random(N) < p_true
        for a, b in zip(jp._compact1d(jnp.asarray(v), w),
                        tp._compact1d(_t(v), w)):
            _eq(a, b)
        q = rng.integers(-4, N + 10, 700).astype(np.int32)
        _eq(jp._CompactMap(jnp.asarray(v)).at(jnp.asarray(q), False),
            tp._CompactMap(_t(v)).at(_t(q)))


def _seg_case(case, rng):
    """(seg_id, vals) of one case of test_seg_running_max_tiles, numpy
    int32; a 2-D case restarts its segment ids in every row."""
    from uncalled_tpu_torch.ops.seg_scan import TILE

    def vals(shape):
        return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(
            np.int32)

    def segs(shape, p):
        return np.cumsum(rng.random(shape) < p, -1).astype(np.int32)

    n = dict(tile_minus_1=TILE - 1, tile=TILE, tile_plus_1=TILE + 1).get(
        case, 3 * TILE + 17)
    if case == "one_segment":
        return np.full(n, 7, np.int32), vals(n)
    if case == "singletons":
        return np.arange(n, dtype=np.int32) - 5, vals(n)
    if case == "int32_extremes":
        v = rng.choice(np.array([-(2**31), 2**31 - 1, -(2**31) + 1, 0],
                                np.int32), n)
        v[: n // 3] = -(2**31)  # whole segments at INT32_MIN
        return segs(n, 0.002), v
    if case == "rows":  # [B, N], rows of 1.22 tiles: each row ends mid-tile
        shape = (6, TILE + TILE // 4 - 3)
        return segs(shape, 0.01), vals(shape)
    return segs(n, 0.02), vals(n)


@pytest.mark.parametrize("case", ["tile_minus_1", "tile", "tile_plus_1",
                                  "tiles", "one_segment", "singletons",
                                  "int32_extremes", "rows"])
def test_seg_running_max_tiles(case):
    """The segmented running max's tiled plain version (the kernel's
    composition) against the JAX two-level scan, row by row for 2-D."""
    import jax.numpy as jnp

    from uncalled_tpu.mapping import pooled as jp

    from uncalled_tpu_torch.mapping import engine as te
    from uncalled_tpu_torch.ops import seg_scan

    seg, vals = _seg_case(case, np.random.default_rng(
        ["tile_minus_1", "tile", "tile_plus_1", "tiles", "one_segment",
         "singletons", "int32_extremes", "rows"].index(case)))
    rows = seg.reshape(-1, seg.shape[-1])
    want = np.stack([np.asarray(jp._seg_running_max(jnp.asarray(s),
                                                    jnp.asarray(v)))
                     for s, v in zip(rows, vals.reshape(rows.shape))])
    got = te.seg_running_max(_t(seg), _t(vals))
    _eq(want.reshape(seg.shape), got, case)
    _eq(want.reshape(seg.shape),
        seg_scan.seg_running_max_plain(_t(seg), _t(vals)), case)


def test_seg_running_max_launch(monkeypatch):
    """Off the CPU the wrapper launches the kernel once, on the tensors it
    was given, and never runs the plain version; it refuses what the
    kernel does not take."""
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import seg_scan

    seen = []

    def fake_launch(name, *args):
        seen.append((name, [(tuple(a.shape), a.dtype) for a in args[:4]],
                     args[4:]))

    def refuse(*a):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(_cuda, "launch", fake_launch)
    monkeypatch.setattr(_cuda, "COUNTS", dict.fromkeys(_cuda.COUNTS, 0))
    monkeypatch.setattr(seg_scan, "seg_running_max_plain", refuse)
    SC = 368640
    seg = torch.empty(SC, dtype=torch.int32, device="meta")
    out = seg_scan.seg_running_max(seg, seg.clone())
    assert out.shape == (SC,) and out.dtype == torch.int32
    (name, shapes, ints), = seen
    assert name == "seg_running_max_i32"
    assert shapes[:3] == [((SC,), torch.int32)] * 3
    assert shapes[3] == ((2 * -(-SC // seg_scan.TILE),), torch.int32)
    assert ints == (1, SC)
    assert _cuda.COUNTS == dict(dict.fromkeys(_cuda.COUNTS, 0),
                                seg_running_max=1)
    s2 = torch.empty((64, 1280), dtype=torch.int32, device="meta")
    seg_scan.seg_running_max(s2, s2.clone())
    assert seen[-1][2] == (64, 1280)
    with pytest.raises(TypeError):
        seg_scan.seg_running_max(seg, seg.long())
    with pytest.raises(ValueError):
        seg_scan.seg_running_max(seg, seg[:-1].clone())
    with pytest.raises(ValueError):
        seg_scan.seg_running_max(s2[:, ::2], s2[:, ::2].clone())


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
    "rids,S,SC,CL,NE,refill_at",
    [
        # four decidable reads on an ample pool; slot 0 refills mid-run
        (("sim_0000_Escherichia_coli_3854_+", "sim_0001_Escherichia_coli_3623_-",
          "sim_0002_Escherichia_coli_6254_+", "sim_0003_Escherichia_coli_6188_-"),
         4096, 5120, 2048, 72, 40),
        # path and candidate pools that bind: physical cuts (bits 8, 2)
        (("sim_0007_Escherichia_coli_7193_+", "sim_0011_Escherichia_coli_6633_-",
          "noise_1", "f41a60f7-de4a-4b17-9f54-387e52d60b65"),
         512, 640, 2048, 64, None),
        # a 4-cluster table: evictions (bit 1)
        (("sim_0001_Escherichia_coli_3623_-", "sim_0007_Escherichia_coli_7193_+",
          "sim_0011_Escherichia_coli_6633_-", "noise_1"),
         4096, 5120, 4, 64, None),
    ],
)
def test_pool_step_matches_jax_every_event(rids, S, SC, CL, NE, refill_at):
    import jax
    import jax.numpy as jnp

    from uncalled_tpu.index.bwa_compat import load_bwa_index
    from uncalled_tpu.mapping import pooled as jp
    from uncalled_tpu.mapping.engine import device_index
    from uncalled_tpu.mapping.oracle import load_uncl
    from uncalled_tpu.poremodel import load_default

    from uncalled_tpu_torch.convert import (
        index_from_numpy,
        state_from_numpy,
        state_to_numpy,
    )
    from uncalled_tpu_torch.mapping import pooled as tp

    B = 4
    evs = _golden_events(rids)
    means = np.zeros((B, 2 * NE), np.float32)
    on = np.zeros((B, 2 * NE), bool)
    for b, e in enumerate(evs):
        m = e[: 2 * NE]
        means[b, : len(m)] = m
        on[b, : len(m)] = True
    if refill_at is not None:  # slot 0 takes read 0 again from its start
        m = evs[0][: NE - refill_at]
        means[0, refill_at: refill_at + len(m)] = m
        on[0, refill_at: refill_at + len(m)] = True

    kw = dict(B=B, S=S, SC=SC, CL=CL, RE=1024, RT=2048, R=512, FS=256)
    jpp = jp.PoolParams(**kw)
    tpp = tp.PoolParams(**kw)
    idx = device_index(load_bwa_index(PREFIX), load_uncl(PREFIX + ".uncl"),
                       load_default())
    tabs = {k: v for k, v in idx.items() if not isinstance(v, int)}
    meta = {k: v for k, v in idx.items() if isinstance(v, int)}
    adv = jax.jit(lambda s, m, o, t: jp.pool_advance_block(
        dict(t, **meta), jpp, s, m, o))
    reset = jax.jit(jp.reset_pool_rows)
    tidx = index_from_numpy({k: (v if isinstance(v, int) else np.asarray(v))
                             for k, v in idx.items()})

    js = reset(jp.make_pool_state(jpp), jnp.ones(B, bool))
    ts = tp.reset_pool_rows(tp.make_pool_state(tpp), torch.ones(B,
                                                                dtype=bool))
    for k, v in state_to_numpy(ts).items():
        _eq(js[k], v, k)
    for t in range(NE):
        if t == refill_at:
            mask = np.array([True, False, False, False])
            js = reset(js, jnp.asarray(mask))
            ts = tp.reset_pool_rows(ts, _t(mask))
        js = adv(js, means[:, t: t + 1], on[:, t: t + 1], tabs)
        ts = tp.pool_advance_block(tidx, tpp, ts, _t(means[:, t: t + 1]),
                                   _t(on[:, t: t + 1]))
        got = state_to_numpy(ts)
        assert set(got) == set(js)
        for k in js:
            _eq(js[k], got[k], f"event {t} key {k}")
    got = state_to_numpy(ts)
    assert got["evt_i"].max() >= 40
    if S == 512:  # the binding caps really bound
        assert (got["ovf_why"] & 8).any()
    if CL == 4:
        assert (got["ovf_why"] & 1).any()
    # round trip through numpy keeps dtypes
    again = state_from_numpy(got)
    for k in got:
        _eq(got[k], again[k], k)
