"""The port's bitonic merge level and hybrid bitonic sort against the JAX
package's (the Pallas merge kernel in interpret mode), zero tolerance."""

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, t, what=""):
    a = np.asarray(j)
    b = t.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    assert np.array_equal(a, b), (what, np.argwhere(a != b)[:5])


def _tie_keys(rng, n, iota=True):
    """Tie-heavy NK = 5 keys as in the step (read, start, end, prob key,
    creation index); without the iota, whole tuples tie too."""
    ks = [rng.integers(0, 5, n), rng.integers(0, 9, n),
          rng.integers(-3, 3, n), rng.integers(-2, 2, n)]
    ks.append(np.arange(n) if iota else rng.integers(0, 2, n))
    return [k.astype(np.int32) for k in ks]


@pytest.mark.parametrize("NP,k_lv,C,iota", [
    (16384, 16384, 128, True),
    (32768, 16384, 128, True),   # two chunks, the second descending
    (32768, 16384, 128, False),  # whole-tuple ties must never swap
    (32768, 32768, 128, True),
])
def test_merge_level_matches_pallas(NP, k_lv, C, iota):
    import jax.numpy as jnp

    from uncalled_tpu.ops.sortkern import merge_level as jml

    from uncalled_tpu_torch.ops.sortkern import merge_level, merge_level_plain

    rng = np.random.default_rng(NP + k_lv + iota)
    ks = _tie_keys(rng, NP, iota)
    want = jml(tuple(jnp.asarray(k) for k in ks), k_lv, C, interpret=True)
    tin = [_t(k) for k in ks]
    got = merge_level(tin, k_lv, C)
    for q, (w, g) in enumerate(zip(want, got)):
        _eq(w, g, f"key {q}")
    # the caller's keys are left as they were
    for k, t in zip(ks, tin):
        _eq(k, t)
    for g, p in zip(got, merge_level_plain(tin, k_lv, C)):
        assert torch.equal(g, p)


def test_merge_level_rejects_bad_shapes():
    from uncalled_tpu_torch.ops.sortkern import merge_level

    k = torch.zeros(16384, dtype=torch.int32)
    for k_lv, C in ((16384, 100), (12288, 128), (16384, 16384)):
        with pytest.raises(ValueError):
            merge_level([k], k_lv, C)


@pytest.mark.parametrize("n,kernel", [
    (16384, True), (20000, True),  # 20000 pads to 32768 with full ties
    (122880, False),  # the step's SC; JAX's XLA pass loop
])
def test_sort1d_bitonic_matches_jax(n, kernel):
    import jax.numpy as jnp

    from uncalled_tpu.mapping import pooled as jp

    from uncalled_tpu_torch.mapping import pooled as tp

    rng = np.random.default_rng(n)
    ks = _tie_keys(rng, n)
    want = jp._sort1d_bitonic(tuple(jnp.asarray(k) for k in ks),
                              kernel=kernel, kernel_interpret=kernel)
    got = tp._sort1d_bitonic(tuple(_t(k) for k in ks))
    for q, (w, g) in enumerate(zip(want, got)):
        _eq(w, g, f"key {q}")


def test_sort1d_bitonic_special_floats():
    """A seed-probability key through the f32 sort key (+/-0 equal, every
    NaN equal and largest, +/-inf), as the step sorts it, against JAX's
    bitonic sort and the port's flat sort."""
    import jax.numpy as jnp

    from uncalled_tpu.mapping import pooled as jp

    from uncalled_tpu_torch.mapping import pooled as tp

    rng = np.random.default_rng(7)
    n = 20000
    rid = rng.integers(0, 9, n).astype(np.int32)
    k1 = rng.integers(0, 50, n).astype(np.int32)
    k2 = rng.integers(0, 50, n).astype(np.int32)
    prob = rng.normal(size=n).astype(np.float32)
    special = np.concatenate([
        np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf], np.float32),
        np.array([0x7FC01234, -0x1], np.int32).view(np.float32),
    ])
    m = rng.random(n) < 0.1
    prob[m] = special[rng.integers(0, len(special), m.sum())]
    iota = np.arange(n, dtype=np.int32)

    jk = jp._f32_sort_key(jnp.asarray(prob))
    want = jp._sort1d_bitonic(tuple(map(jnp.asarray, (rid, k1, k2))) + (
        jk, jnp.asarray(iota)), kernel=True, kernel_interpret=True)
    tkey = tp._f32_sort_key(_t(prob))
    got = tp._sort1d_bitonic((_t(rid), _t(k1), _t(k2), tkey, _t(iota)))
    for q, (w, g) in enumerate(zip(want, got)):
        _eq(w, g, f"key {q}")
    _eq(jp._f32_from_sort_key(want[3]), tp._f32_from_sort_key(got[3]))
    # the same order as the flat sort on the raw floats
    flat = tp._sort1d((_t(rid), _t(k1), _t(k2), _t(prob), _t(iota)))
    for q in (0, 1, 2, 4):
        assert torch.equal(flat[q], got[q]), q


def _jax_rowsort(ks, width, k_level):
    """The JAX sort's row sort (``rowsort`` inside
    ``uncalled_tpu.mapping.pooled._sort1d_bitonic``): lax.sort along rows,
    row r descending iff (r*width & k_level) != 0."""
    import jax
    import jax.numpy as jnp

    NP = ks[0].shape[0]
    G = NP // width
    desc = ((jnp.arange(G, dtype=jnp.int32) * np.int32(width))
            & np.int32(k_level)) != 0
    desc = desc[:, None]
    ops = tuple(jnp.where(desc, ~a.reshape(G, width), a.reshape(G, width))
                for a in ks)
    res = jax.lax.sort(ops, dimension=1, num_keys=len(ops))
    return [jnp.where(desc, ~r, r).reshape(NP) for r in res]


def _level_input(ks, k_lv):
    """What merge level k_lv takes: runs of k_lv/2 sorted by numpy, run r
    descending iff r is odd (the state after level k_lv/2)."""
    h = k_lv // 2
    v = np.stack(ks)
    for r in range(v.shape[1] // h):
        c = v[:, r * h:(r + 1) * h]
        c = c[:, np.lexsort(c[::-1])]
        v[:, r * h:(r + 1) * h] = c[:, ::-1] if r % 2 else c
    return list(v)


@pytest.mark.parametrize("NP,k_lv,C,iota", [
    (16384, 16384, 1, True),
    (32768, 16384, 1, False),   # whole tuples tie; two chunks
    (32768, 16384, 2, True),
    (32768, 32768, 2, False),
    (32768, 16384, 64, True),
    (16384, 16384, 64, False),
])
def test_merge_level_to_small_strides_matches_jax(NP, k_lv, C, iota):
    """The passes down to C < 128, then the row sort of width C, finish the
    level as JAX's kernel at C = 128 and its row sort of width 128 do."""
    import jax.numpy as jnp

    from uncalled_tpu.ops.sortkern import merge_level as jml

    from uncalled_tpu_torch.ops import sortkern as sk

    rng = np.random.default_rng(NP + k_lv + C + iota)
    ks = _level_input(_tie_keys(rng, NP, iota), k_lv)
    want = jml(tuple(jnp.asarray(k) for k in ks), k_lv, 128, interpret=True)
    want = _jax_rowsort(want, 128, k_lv)
    tin = [_t(k) for k in ks]
    got = sk.merge_level_plain(tin, k_lv, C)
    assert all(torch.equal(g, p) for g, p in zip(got,
                                                 sk.merge_level(tin, k_lv, C)))
    if C > 1:
        got = sk.rowsort_plain(got, C, k_lv)
    for q, (w, g) in enumerate(zip(want, got)):
        _eq(w, g, f"key {q}")


@pytest.mark.parametrize("width,k_level,iota", [
    (1, 2, True), (2, 2, False), (64, 16384, True), (128, 256, False),
    (8192, 8192, True), (8192, 16384, False), (16384, 16384, True),
])
def test_rowsort_matches_jax(width, k_level, iota):
    import jax.numpy as jnp

    from uncalled_tpu_torch.ops.sortkern import rowsort_plain

    rng = np.random.default_rng(width + k_level + iota)
    ks = _tie_keys(rng, 16384, iota)
    want = _jax_rowsort([jnp.asarray(k) for k in ks], width, k_level)
    got = rowsort_plain([_t(k) for k in ks], width, k_level)
    for q, (w, g) in enumerate(zip(want, got)):
        _eq(w, g, f"key {q}")


@pytest.mark.parametrize("n,W,iota", [
    (8192, 8192, True), (5000, 8192, False), (20000, 2048, True),
    (32768, 8192, False),
])
def test_sort_runs_plain_matches_jax_rows(n, W, iota):
    """The run sort's plain version: the padded keys through JAX's row
    sort at width W (level W, or NP when W == NP)."""
    import jax.numpy as jnp

    from uncalled_tpu_torch.ops import sortkern as sk

    rng = np.random.default_rng(n + W)
    ks = _tie_keys(rng, n, iota)
    NP = 1 << (max(n, 8192) - 1).bit_length()
    pad = [jnp.pad(jnp.asarray(k), (0, NP - n), constant_values=2**31 - 1)
           for k in ks]
    want = _jax_rowsort(pad, W, W if W < NP else NP)
    got = sk.sort_runs(tuple(_t(k) for k in ks), NP, W)
    assert got.shape == (len(ks), NP) and got.dtype == torch.int32
    for q, w in enumerate(want):
        _eq(w, got[q], f"key {q}")


@pytest.mark.parametrize("n,W", [(20000, 256), (122880, 2048), (70000, 8192)])
def test_sort1d_network_matches_jax(monkeypatch, n, W):
    """The card's composition (run sort, then every level to stride 1),
    here through the plain versions, against JAX's bitonic sort."""
    import jax.numpy as jnp

    from uncalled_tpu.mapping import pooled as jp

    from uncalled_tpu_torch.mapping import pooled as tp
    from uncalled_tpu_torch.ops import sortkern as sk

    monkeypatch.setattr(sk, "RUN_TILE", W)
    rng = np.random.default_rng(n + W)
    ks = _tie_keys(rng, n, iota=n != 20000)
    want = jp._sort1d_bitonic(tuple(jnp.asarray(k) for k in ks))
    NP = 1 << (max(n, 8192) - 1).bit_length()
    got = tp._sort1d_network(tuple(_t(k) for k in ks), NP)
    for q, (w, g) in enumerate(zip(want, got)):
        _eq(w, g, f"key {q}")


# ---------------------------------------------------------------------------
# the card's launch schedule, replayed with numpy
# ---------------------------------------------------------------------------

def _network(NP):
    return [(k, s) for k in (1 << j for j in range(1, NP.bit_length()))
            for s in (1 << j for j in range(k.bit_length() - 2, -1, -1))]


def _lex(x, y):
    """(x < y, x == y) over [NK, n] tuples, lexicographically."""
    lt = np.zeros(x.shape[1], bool)
    eq = np.ones(x.shape[1], bool)
    for a, b in zip(x, y):
        lt |= eq & (a < b)
        eq &= a == b
    return lt, eq


def _replay(sched, keys, NP):
    """The schedule as the kernels run it: a device-memory launch and a
    tile's strides below E swap both elements of a pair in one thread;
    a tile's wider strides let each side keep its own (csrc/sortkern.cu
    keep_side: the smaller when lower == ascending, else the larger)."""
    v = np.full((len(keys), NP), 2**31 - 1, np.int32)
    v[:, :len(keys[0])] = keys
    i = np.arange(NP)
    for launch in sched:
        kind, a = launch[:2]
        E = 16 if a > 4096 else 8 if a > 2048 else 4
        for k, s in sk_passes(launch):
            if kind == "global" or s < E:
                lo = i[(i & s) == 0]
                hi = lo | s
                lt, eq = _lex(v[:, hi], v[:, lo])
                swap = np.where((lo & k) == 0, lt, ~(lt | eq))
                x, y = v[:, lo], v[:, hi]
                v[:, lo], v[:, hi] = (np.where(swap, y, x),
                                      np.where(swap, x, y))
            else:
                p = v[:, i ^ s]
                lt, eq = _lex(p, v)
                take = np.where(((i & s) == 0) == ((i & k) == 0), lt,
                                ~(lt | eq))
                v = np.where(take, p, v)
    return v


def sk_passes(launch):
    from uncalled_tpu_torch.ops.sortkern import passes

    return passes(launch)


# NP = 262144: the realtime engine at 512 channels (SC = 184320 at 288
# pool slots a read, 245760 at the default 384)
@pytest.mark.parametrize("NP", [8192, 16384, 32768, 131072, 262144])
@pytest.mark.parametrize("tile", [256, 512, 1024, 2048, 4096, 8192])
def test_schedule_runs_the_network(NP, tile):
    """For every run width and fused-stride count: the launches cover each
    pass of the bitonic network exactly once, in order; every tile launch
    stays inside its tile and every device-memory launch fuses at most r
    consecutive strides of one level, all at least a tile wide.  The
    default schedule, replayed as the kernels run it, gives np.lexsort's
    order on tie-heavy keys with padding."""
    from uncalled_tpu_torch.ops import sortkern as sk

    for W in (w for w in (256, 1024, 2048, 4096, 8192) if w <= NP):
        for r in (1, 2, 3, 4):
            sched = sk.sort_schedule(NP, W, tile, r)
            assert [p for L in sched for p in sk.passes(L)] == _network(NP)
            assert sched[0] == ("runs", W, 2, 1, W, 1)
            for kind, a, kf, sf, kl, sl in sched[1:]:
                assert kf == kl
                if kind == "global":
                    assert 1 <= a <= r and sl >= tile and sf == sl << (a - 1)
                else:
                    assert (kind, a) == ("tile", tile) and sf < tile
            levels = sum(1 for k in (2 * W << j for j in range(20))
                         if k <= NP)
            assert sum(L[0] == "tile" for L in sched) == levels
    rng = np.random.default_rng(NP + tile)
    n = NP - 77
    keys = np.stack(_tie_keys(rng, n, iota=False))
    keys[1, rng.random(n) < 0.05] = 2**31 - 1
    W = min(sk.RUN_TILE, NP)
    sched = sk.sort_schedule(NP, W, min(tile, NP), sk.FUSE_R)
    got = _replay(sched, keys, NP)
    want = keys[:, np.lexsort(keys[::-1])]
    assert np.array_equal(got[:, :n], want)


def test_shapes_rejected():
    """Shapes the network or the kernels do not take."""
    from uncalled_tpu_torch.ops import sortkern as sk

    k = torch.zeros(1024, dtype=torch.int32)
    for k_lv, C in ((1024, 3), (768, 1), (1024, 1024), (2048, 1)):
        with pytest.raises(ValueError):
            sk.merge_level([k], k_lv, C)
    for NP, W in ((1000, 256), (1024, 2048), (512, 256), (2048, 96)):
        with pytest.raises(ValueError):
            sk.sort_runs([k], NP, W)
    assert sk.tile_for(8192, 131072, 5) == 8192
    assert sk.tile_for(8192, 131072, 8) == 4096  # 8 planes of 8192: 256 KB
    assert sk.tile_for(8192, 2048, 5) == 2048
    for tile, NP in ((128, 8192), (8192, 128), (3000, 8192)):
        with pytest.raises(ValueError):
            sk.tile_for(tile, NP, 5)


def _meta(n, dt=torch.int32):
    return torch.empty(n, dtype=dt, device="meta")


@pytest.fixture
def stand_in(monkeypatch):
    """A stand-in launcher that records each sort launch off the CPU; the
    plain versions and torch.sort must not run."""
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import sortkern as sk

    calls = []

    def fake_launch(name, src, nk, N, buf, NP, q, n):
        assert name == "sort_net_i32" and len(q) == 6 * n
        assert buf.shape == (nk, NP) and len(src) == nk
        kinds = {v: k for k, v in sk._KIND.items()}
        calls.append([(kinds[q[6 * i]], *q[6 * i + 1: 6 * i + 6])
                      for i in range(n)])

    def refuse(*a, **k):
        raise AssertionError("a plain version ran off the CPU")

    monkeypatch.setattr(_cuda, "launch", fake_launch)
    monkeypatch.setattr(_cuda, "COUNTS", dict.fromkeys(_cuda.COUNTS, 0))
    for name in ("merge_level_plain", "sort_runs_plain", "rowsort_plain"):
        monkeypatch.setattr(sk, name, refuse)
    monkeypatch.setattr(torch, "sort", refuse)
    return calls


@pytest.mark.parametrize("n", [5000, 122880, 184320])
def test_card_sort_launches_only_the_network(stand_in, n):
    """Off the CPU the bitonic sort is the run sort and one merge level a
    level to stride 1, on one buffer: the launches are sort_schedule's."""
    from uncalled_tpu_torch.mapping import pooled as tp
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import sortkern as sk

    keys = tuple(_meta(n) for _ in range(5))
    out = tp._sort1d_bitonic(keys)
    NP = 1 << (max(n, 8192) - 1).bit_length()
    W = min(sk.RUN_TILE, NP)
    assert [L for c in stand_in for L in c] == sk.sort_schedule(
        NP, W, sk.MERGE_TILE, sk.FUSE_R)
    levels = (NP // W).bit_length() - 1
    assert _cuda.COUNTS["sort_runs"] == 1
    assert _cuda.COUNTS["merge_level"] == levels == len(stand_in) - 1
    assert [tuple(o.shape) for o in out] == [(n,)] * 5


def test_card_wrappers_refuse(monkeypatch, stand_in):
    from uncalled_tpu_torch.ops import sortkern as sk

    monkeypatch.setattr(sk, "MERGE_TILE", 8192)

    with pytest.raises(ValueError):  # nine planes
        sk.sort_runs([_meta(100)] * 9, 8192, 8192)
    with pytest.raises(TypeError):  # int64 keys
        sk.sort_runs([_meta(100, torch.int64)], 8192, 8192)
    with pytest.raises(ValueError):  # lengths differ
        sk.sort_runs([_meta(100), _meta(99)], 8192, 8192)
    with pytest.raises(ValueError):  # 8 planes of 8192 do not fit a block
        sk.sort_runs([_meta(100)] * 8, 8192, 8192)
    with pytest.raises(ValueError):  # run width below the kernel's tile
        sk.sort_runs([_meta(100)], 8192, 128)
    with pytest.raises(ValueError):  # NP below a tile
        sk.merge_level([_meta(128)], 128, 1)
    with pytest.raises(ValueError):  # one plane shorter
        sk.merge_level([_meta(8192), _meta(4096)], 8192, 1)
    assert stand_in == []
    sk.merge_level([_meta(8192)] * 8, 8192, 1)  # tile cut to 4096
    assert stand_in == [[("global", 1, 8192, 4096, 8192, 4096),
                         ("tile", 4096, 8192, 2048, 8192, 1)]]
