"""The port's per-row and shared-table gathers (plain versions on the CPU)
against the JAX MXU gather kernels, run as the JAX package's own tests run
them (Pallas interpret mode), at monolithic and chunked table sizes.  Zero
tolerance: dtypes equal, integers and bools equal, floats as raw bits (NaN
payloads, signed zeros and infinities included); out-of-range indices
clamp.  The CUDA kernel is held against these plain versions on the card
by chip_smoke.py."""

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interp(monkeypatch):
    from uncalled_tpu.ops import mxu_gather

    monkeypatch.setattr(mxu_gather, "_INTERPRET", True)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, t):
    a, b = np.asarray(j), t.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    assert np.array_equal(a, b)


SPECIAL = np.concatenate([
    np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32),
    np.array([0x7FC01234, -0x003FFFFF, 0x7F800001], np.int32).view(
        np.float32),  # NaN payloads, a signalling NaN
])


def _table(rng, shape, dt):
    if dt == "i32":
        return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(
            np.int32)
    if dt == "bool":
        return rng.random(shape) < 0.5
    t = rng.standard_normal(shape).astype(np.float32)
    flat = t.reshape(-1)
    flat[rng.integers(0, flat.size, max(8, flat.size // 20))] = rng.choice(
        SPECIAL, max(8, flat.size // 20))
    return t


def _idx(rng, B, N, K):
    """Indices over the table, a few of them out of range on both sides."""
    idx = rng.integers(0, N, (B, K)).astype(np.int32)
    idx[:, :4] = [-7, -1, N, N + 5][: min(4, K)]
    return idx


SHAPES = [
    # (B, N, F, K) -- monolithic (N <= 4096) and chunked (4096 < N <= 8192)
    (5, 640, 4, 129),
    (8, 48, 2, 300),
    (4, 5000, 3, 300),
]


@pytest.mark.parametrize("dt", ["i32", "f32", "bool"])
@pytest.mark.parametrize("B,N,F,K", SHAPES)
def test_row_gather_matches_jax(B, N, F, K, dt):
    import jax.numpy as jnp

    from uncalled_tpu.ops import mxu_gather as JG

    from uncalled_tpu_torch.ops import mxu_gather as TG

    rng = np.random.default_rng(N * 7 + F)
    tbl = _table(rng, (B, N, F), dt)
    idx = _idx(rng, B, N, K)
    _eq(JG.row_gather(jnp.asarray(tbl), jnp.asarray(idx), force=True),
        TG.row_gather(_t(tbl), _t(idx)))
    # the 2-D table form ([B, N] -> [B, K]), one field of the same table
    _eq(JG.row_gather(jnp.asarray(tbl[:, :, 0]), jnp.asarray(idx), force=True),
        TG.row_gather(_t(tbl[:, :, 0]), _t(idx)))


@pytest.mark.parametrize("B,N,F,K", SHAPES)
def test_row_gather_fields_matches_jax(B, N, F, K):
    import jax.numpy as jnp

    from uncalled_tpu.ops import mxu_gather as JG

    from uncalled_tpu_torch.ops import mxu_gather as TG

    rng = np.random.default_rng(N + K)
    tbl = _table(rng, (B, N, F), "i32")
    idx = _idx(rng, B, N, K)
    want = JG.row_gather_fields(jnp.asarray(tbl), jnp.asarray(idx), force=True)
    got = TG.row_gather_fields(_t(tbl), _t(idx))
    assert len(got) == len(want) == F
    for w, g in zip(want, got):
        _eq(w, g.contiguous())


@pytest.mark.parametrize("N,F,dt", [(1024, 2, "i32"), (1280, 2, "f32"),
                                    (5000, 1, "f32"), (700, 0, "bool")])
def test_shared_gather_matches_jax(N, F, dt):
    """Shared tables [N, F] (the k-mer range table is [1024, 2]) and the 1-D
    form [N] (F = 0)."""
    import jax.numpy as jnp

    from uncalled_tpu.ops import mxu_gather as JG

    from uncalled_tpu_torch.ops import mxu_gather as TG

    rng = np.random.default_rng(N + F)
    tbl = _table(rng, (N, F) if F else (N,), dt)
    idx = _idx(rng, 6, N, 200)
    _eq(JG.shared_gather(jnp.asarray(tbl), jnp.asarray(idx), force=True),
        TG.shared_gather(_t(tbl), _t(idx)))
