"""The port's expanded seed-tracker fold ``tracker_run`` (plain version on
the CPU) against the JAX ``tracker_run`` kernel in Pallas interpret mode,
in the three occupancy regimes of tests/test_tracker_kernel.py (normal,
full table with evictions, near-empty with bursty rows) and on the
adversarial tie case of chip_smoke.py.  Zero tolerance.
The CUDA kernel is held against this plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch
from test_tracker_kernel import _rand_state

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "seed,fill,B,CL,R",
    [
        (0, 0.3, 16, 128, 24),   # normal occupancy
        (1, 1.0, 16, 128, 24),   # full table: eviction path
        (2, 0.02, 8, 256, 48),   # near-empty, bursty rows
        (3, "ties", 24, 128, 4),  # chip_smoke.tracker_tie_case
    ],
)
def test_tracker_run_matches_jax(seed, fill, B, CL, R):
    import jax.numpy as jnp

    from uncalled_tpu.ops.tracker_kernel import tracker_run as jrun

    from uncalled_tpu_torch.ops.tracker_kernel import tracker_run

    if fill == "ties":
        # equal keys across lane and warp boundaries, matches at index 0
        # and CL-1, int32 extremes, a wrapped r2, every slot free or
        # occupied, collisions; row 1 gated off in every third read
        from chip_smoke import tracker_tie_case

        st, _, rows = tracker_tie_case(B, CL, seed)
        ref_en, mc, evt, row_ok, rows_r = rows
    else:
        rng = np.random.default_rng(seed)
        st = _rand_state(rng, B, CL, fill)
        # rows near existing cluster coordinates: matches, collisions and
        # insertions all occur (the JAX test's streams)
        base = rng.integers(0, 5000, (B, R)).astype(np.int32)
        near = st["cl_r1"][:, :R] + rng.integers(-3, 40, (B, R))
        use_near = rng.random((B, R)) < 0.6
        mc = rng.integers(1, 30, (B, R)).astype(np.int32)
        ref_en = np.where(use_near, near + mc - 1, base).astype(np.int32)
        evt = (st["cl_evt_en"][:, :R] + rng.integers(-2, 30, (B, R))).astype(
            np.int32)
        rows_r = rng.integers(0, R + 1, B).astype(np.int32)
        # gated rows inside each read's count; none past it (the precondition)
        row_ok = (np.arange(R)[None, :] < rows_r[:, None]) & (
            rng.random((B, R)) < 0.95)

    want = jrun(
        7, {k: jnp.asarray(v) for k, v in st.items()}, jnp.asarray(ref_en),
        jnp.asarray(mc), jnp.asarray(evt), jnp.asarray(row_ok),
        jnp.asarray(rows_r), interpret=True,
    )
    got = tracker_run(7, {k: _t(v) for k, v in st.items()}, _t(ref_en),
                      _t(mc), _t(evt), _t(row_ok), _t(rows_r))
    assert set(got) == set(st)
    for k in st:
        a, b = np.asarray(want[k]), got[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        assert np.array_equal(a, b), k
    if fill in (1.0, "ties"):
        assert (np.asarray(want["ovf_why"]) & 1).any()  # evictions happened
