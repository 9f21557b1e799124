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
