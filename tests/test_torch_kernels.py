"""The plain PyTorch versions of the four ported kernels against the JAX
functions they replace, run as the JAX package's own tests run them
(Pallas interpret mode on the CPU).  Zero tolerance: integers equal,
floats equal as raw bits.  The CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch


# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(j, t):
    a, b = np.asarray(j), t.numpy() if isinstance(t, torch.Tensor) else t
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    assert np.array_equal(a, b)


@pytest.mark.parametrize(
    "n,f,k,dt", [(1024, 1, 700, "i32"), (65536, 4, 2048, "i32"),
                 (9216, 2, 513, "f32"), (300, 10, 64, "i32"),
                 (4096, 1, 900, "f32")],
)
def test_flat_gather_plain_matches_jax(monkeypatch, n, f, k, dt):
    import jax.numpy as jnp

    from uncalled_tpu.ops import flat_gather as FG

    from uncalled_tpu_torch.ops import flat_gather as TG

    monkeypatch.setattr(FG, "_INTERPRET", True)
    rng = np.random.default_rng(n + f + k)
    if dt == "i32":
        tbl = rng.integers(-(2**31), 2**31, (n, f), dtype=np.int64).astype(
            np.int32)
    else:
        tbl = rng.standard_normal((n, f)).astype(np.float32)
        tbl[rng.random((n, f)) < 0.05] = np.nan
        tbl[rng.random((n, f)) < 0.05] = -0.0
    idx = rng.integers(-5, n + 7, (k,)).astype(np.int32)  # out of range too
    for force in (True, False):
        # the JAX fields form takes 32-bit payloads as int32
        want = FG.flat_gather_fields(jnp.asarray(tbl.view(np.int32)),
                                     jnp.asarray(idx), force=force)
        got = TG.flat_gather_fields(_t(tbl), _t(idx))
        assert got.shape == (f, k) and got.dtype == _t(tbl).dtype
        for c in range(f):
            _eq(want[c], got[c].view(torch.int32))
        _eq(FG.flat_gather(jnp.asarray(tbl), jnp.asarray(idx), force=force),
            TG.flat_gather(_t(tbl), _t(idx)))
        if f == 1:
            _eq(FG.flat_gather(jnp.asarray(tbl[:, 0]), jnp.asarray(idx),
                               force=force),
                TG.flat_gather(_t(tbl[:, 0]), _t(idx)))


def _pair_keys(case, k, na, nb):
    """Seeded keys, or the adversarial cases chip_smoke.py also runs on the
    card: one cell for every key, runs of 32 and of 33 equal cells (a warp's
    width and one more), every key out of the domain."""
    rng = np.random.default_rng(k + na)
    a = rng.integers(-2, na + 3, (k,)).astype(np.int32)  # out of domain too
    b = rng.integers(-3, nb + 6, (k,)).astype(np.int32)
    if case == "all equal":
        a[:], b[:] = na - 1, nb - 1
    elif case.startswith("runs of"):
        w = int(case.split()[-1])
        cell = np.repeat(rng.integers(0, na * nb, k // w + 1), w)[:k]
        a, b = (cell // nb).astype(np.int32), (cell % nb).astype(np.int32)
        b[::97] = nb  # a few dropped keys inside the runs
    elif case == "all out of domain":
        a = np.where(rng.random(k) < 0.5, -1, na).astype(np.int32)
    return a, b


@pytest.mark.parametrize("case,k,na,nb", [
    # the seeded cases keep the ids they had before the adversarial ones
    pytest.param("seeded", 5000, 17, 1024, id="5000-17-1024"),
    pytest.param("seeded", 4096, 256, 1024, id="4096-256-1024"),
    ("all equal", 4096, 256, 1024), ("runs of 32", 4096, 256, 1024),
    ("runs of 33", 4096, 256, 1024), ("all out of domain", 4096, 256, 1024),
    ("seeded", 4093, 256, 1024),  # K not a multiple of 4
    ("seeded", 0, 256, 1024),  # no keys: all zeros
])
def test_pair_counts_plain_matches_jax(monkeypatch, case, k, na, nb):
    import jax.numpy as jnp

    from uncalled_tpu.ops import flat_gather as FG

    from uncalled_tpu_torch.ops import flat_gather as TG

    monkeypatch.setattr(FG, "_INTERPRET", True)
    a, b = _pair_keys(case, k, na, nb)
    got = TG.pair_counts(_t(a), _t(b), na, nb)
    assert int(got.sum()) == int(((a >= 0) & (a < na) & (b >= 0)
                                  & (b < nb)).sum())
    for force in (True, False):
        _eq(FG.pair_counts(jnp.asarray(a), jnp.asarray(b), na, nb,
                           force=force), got)


def test_pair_counts_launch_off_the_cpu(monkeypatch):
    """Off the CPU the wrapper makes one launch and no fill: it hands the
    kernel an uninitialised [na, nb] output (the kernel zeroes it) and
    counts one launch; bad dtypes, shapes and domains raise."""
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import flat_gather as fg

    seen = []

    def fake_launch(name, *args):
        seen.append((name, args[0].shape, args[2:6], args[6].shape))

    def refuse(*a, **k):
        raise AssertionError("the plain version or a fill ran off the CPU")

    monkeypatch.setattr(_cuda, "launch", fake_launch)
    monkeypatch.setattr(_cuda, "COUNTS", dict.fromkeys(_cuda.COUNTS, 0))
    monkeypatch.setattr(fg, "pair_counts_plain", refuse)
    monkeypatch.setattr(fg.torch, "zeros", refuse)

    def meta(*shape, dt=torch.int32):
        return torch.empty(shape, dtype=dt, device="meta")

    out = fg.pair_counts(meta(122880), meta(122880), 256, 1024)
    assert out.shape == (256, 1024) and out.dtype == torch.int32
    assert seen == [("pair_counts_i32", (122880,),
                     (122880, 256, 1024, fg.PAIR_THREADS), (256, 1024))]
    assert _cuda.COUNTS == dict(dict.fromkeys(_cuda.COUNTS, 0),
                                pair_counts=1)
    for a, b, na, nb in (
        (meta(8, dt=torch.int64), meta(8), 4, 4),  # dtype
        (meta(8), meta(7), 4, 4),  # shapes differ
        (meta(2, 4), meta(2, 4), 4, 4),  # not flat
        (meta(8), meta(8), 2**16, 2**15),  # counters past int32
    ):
        with pytest.raises((TypeError, ValueError)):
            fg.pair_counts(a, b, na, nb)
    assert _cuda.COUNTS["pair_counts"] == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_assemble_plain_matches_jax(seed):
    import jax.numpy as jnp

    from uncalled_tpu.ops.stepkern import ring_assemble

    from uncalled_tpu_torch.ops.stepkern import ring_assemble as tring

    rng = np.random.default_rng(seed)
    S, RING = 512, 23
    old = rng.normal(size=(S, RING)).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32)
    old.reshape(-1)[rng.integers(0, old.size, 400)] = rng.choice(special, 400)
    nan_payload = np.array([0x7FC00123, -0x003FFFFF], np.int32).view(
        np.float32)
    old.reshape(-1)[rng.integers(0, old.size, 20)] = rng.choice(nan_payload,
                                                                20)
    rsrc = rng.integers(-1, S, S).astype(np.int32)
    rslot = rng.integers(-1, RING, S).astype(np.int32)
    rval = (rng.normal(size=S) * 100).astype(np.float32)
    rval[rng.integers(0, S, 40)] = rng.choice(special, 40)
    keep = rng.integers(0, 2, S).astype(bool)
    want = ring_assemble(jnp.asarray(old), jnp.asarray(rsrc),
                         jnp.asarray(rslot), jnp.asarray(rval),
                         jnp.asarray(keep), interpret=True)
    _eq(want, tring(_t(old), _t(rsrc), _t(rslot), _t(rval), _t(keep)))


def _ring_model(old, rsrc, rslot, rval, keep):
    """numpy model of csrc/stepkern.cu: thread t writes flat words 4t ...
    4t+3 of the output rounded up to a multiple of four words; slot and
    lane advance word by word, and words past S*RING repeat the last."""
    S, RING = old.shape
    total = S * RING
    ob, vb = old.view(np.int32), rval.view(np.int32)
    out = np.full(-(-total // 4) * 4, 12345, np.int32)
    for t in range(len(out) // 4):
        i, j = divmod(4 * t, RING)
        for w in range(4):
            sl, ln = (i, j) if 4 * t + w < total else (S - 1, RING - 1)
            j += 1
            if j == RING:
                i, j = i + 1, 0
            src = min(rsrc[sl], S - 1)
            if not keep[sl]:
                v = 0
            elif ln == rslot[sl]:
                v = vb[sl]
            else:
                v = ob[src, ln] if src >= 0 else 0
            out[4 * t + w] = v
    return out[:total].reshape(S, RING).view(np.float32)


@pytest.mark.parametrize("S,RING", [(28, 23), (29, 23), (30, 23), (31, 23),
                                    (33, 3), (5, 32), (1, 2)])
def test_ring_flat_mapping_tails(S, RING):
    """The kernel's flat four-word mapping at S*RING % 4 = 0, 3, 2, 1 (and
    RING < 4, where four words span more than two slots) against the
    plain version and the JAX kernel in interpret mode.  The JAX kernel
    takes S % 4 == 0: it gets the slots padded with dropped rows and
    copies of the last ring row, so its clamp of rsrc reads what S's does."""
    import jax.numpy as jnp

    from uncalled_tpu.ops.stepkern import ring_assemble

    from uncalled_tpu_torch.ops.stepkern import ring_assemble as tring

    rng = np.random.default_rng(S * 100 + RING)
    old = rng.integers(-2**31, 2**31 - 1, (S, RING), dtype=np.int64).astype(
        np.int32)
    old.reshape(-1)[rng.integers(0, old.size, 8)] = [0, -2**31, 0x7F800000,
                                                     -8388608, 0x7FC00123,
                                                     -1, 0, -2**31]
    old = old.view(np.float32)
    rsrc = rng.integers(-1, S + 3, S).astype(np.int32)
    rslot = rng.integers(-1, RING, S).astype(np.int32)
    rval = rng.integers(-2**31, 2**31 - 1, S, dtype=np.int64).astype(
        np.int32).view(np.float32)
    keep = rng.random(S) < 0.8
    model = _ring_model(old, rsrc, rslot, rval, keep)
    _eq(model, tring(_t(old), _t(rsrc), _t(rslot), _t(rval), _t(keep)))
    S4 = -(-S // 4) * 4
    pad = S4 - S
    want = ring_assemble(
        jnp.asarray(np.concatenate([old, np.repeat(old[-1:], pad, 0)])),
        jnp.asarray(np.concatenate([rsrc, np.full(pad, -1, np.int32)])),
        jnp.asarray(np.concatenate([rslot, np.full(pad, -1, np.int32)])),
        jnp.asarray(np.concatenate([rval, np.zeros(pad, np.float32)])),
        jnp.asarray(np.concatenate([keep, np.zeros(pad, bool)])),
        interpret=True)
    _eq(np.asarray(want)[:S], model)


def test_ring_wrapper_launch_off_the_cpu(monkeypatch):
    """Off the CPU the wrapper hands the kernel a flat output of S*RING
    words rounded up to four and returns its [S, RING] head."""
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import stepkern as sk

    seen = []

    def fake_launch(name, *args):
        seen.append((name, args[5].shape, args[6:]))

    def refuse(*a):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(_cuda, "launch", fake_launch)
    monkeypatch.setattr(_cuda, "COUNTS", dict.fromkeys(_cuda.COUNTS, 0))
    monkeypatch.setattr(sk, "ring_assemble_plain", refuse)

    def meta(*shape, dt=torch.int32):
        return torch.empty(shape, dtype=dt, device="meta")

    S, RING = 98303, 23
    out = sk.ring_assemble(meta(S, RING, dt=torch.float32), meta(S),
                           meta(S), meta(S, dt=torch.float32),
                           meta(S, dt=torch.bool))
    assert out.shape == (S, RING) and out.dtype == torch.float32
    assert out.is_contiguous()
    assert seen == [("ring_assemble_i32", (2260972,), (S, RING))]  # 2260969
    assert _cuda.COUNTS["ring_assemble"] == 1
    with pytest.raises(ValueError):
        sk.ring_assemble(meta(S, 33, dt=torch.float32), meta(S), meta(S),
                         meta(S, dt=torch.float32), meta(S, dt=torch.bool))


def _rand_state(rng, B, CL, fill):
    occ = rng.random((B, CL)) < fill
    return {
        "cl_valid": occ & (rng.random((B, CL)) < 0.9),
        "cl_count": occ,
        "cl_ref_st": rng.integers(0, 5000, (B, CL)).astype(np.int32),
        "cl_r1": rng.integers(0, 5000, (B, CL)).astype(np.int32),
        "cl_r2e": rng.integers(0, 5000, (B, CL)).astype(np.int32),
        "cl_evt_st": rng.integers(0, 800, (B, CL)).astype(np.int32),
        "cl_evt_en": rng.integers(0, 800, (B, CL)).astype(np.int32),
        "cl_total": rng.integers(1, 300, (B, CL)).astype(np.int32),
        "len_sum": (rng.random(B) * 100).astype(np.float32),
        "n_cl": rng.integers(0, CL, B).astype(np.int32),
        "mm_len": rng.integers(0, 200, B).astype(np.int32),
        "mm_ref_st": rng.integers(0, 5000, B).astype(np.int32),
        "mm_r1": rng.integers(0, 5000, B).astype(np.int32),
        "mm_r2e": rng.integers(0, 5000, B).astype(np.int32),
        "mm_evt_st": rng.integers(0, 800, B).astype(np.int32),
        "mm_evt_en": rng.integers(0, 800, B).astype(np.int32),
        "ovf": rng.random(B) < 0.05,
        "ovf_why": rng.integers(0, 4, B).astype(np.int32),
    }


@pytest.mark.parametrize(
    "seed,fill,CL", [(3, 0.3, 128), (4, 0.97, 128), (5, 1.0, 16),
                     (6, 0.0, 8), (7, "ties", 128)],
)
def test_tracker_fold_plain_matches_jax(seed, fill, CL):
    """Contested rows (near existing clusters: matches, ties, zombies) and
    small tables that force evictions; "ties": chip_smoke.tracker_tie_case
    (equal keys across lane and warp boundaries, matches at index 0 and
    CL-1, int32 extremes, a wrapped r2, every slot free or occupied,
    collisions), which phase 2 also runs through the CUDA kernels."""
    import jax.numpy as jnp

    from uncalled_tpu.ops.tracker_kernel import tracker_run_compact

    from uncalled_tpu_torch.ops.tracker_kernel import (
        tracker_run_compact as tfold,
    )

    if fill == "ties":
        from chip_smoke import tracker_tie_case

        st, rows, _ = tracker_tie_case(24, CL, seed)
        rr_ref_en, rr_mc, rr_evt, st_w, rows_eff = rows
    else:
        B, RT = 16, 256
        rng = np.random.default_rng(seed)
        st = _rand_state(rng, B, CL, fill)
        counts = rng.integers(0, 24, B).astype(np.int32)
        st_w = np.minimum(np.concatenate([[0], np.cumsum(counts)[:-1]]),
                          RT - 1).astype(np.int32)
        rows_eff = np.minimum(counts, RT - st_w).astype(np.int32)
        owner = np.repeat(np.arange(B), rows_eff)[:RT]
        rr_mc = rng.integers(1, 30, RT).astype(np.int32)
        rr_ref_en = rng.integers(0, 5000, RT).astype(np.int32)
        rr_evt = rng.integers(0, 800, RT).astype(np.int32)
        n_own = len(owner)
        pick = rng.integers(0, CL, n_own)
        near = rng.random(n_own) < 0.6
        rr_ref_en[:n_own] = np.where(
            near, st["cl_r1"][owner, pick] + rr_mc[:n_own] - 1
            + rng.integers(-2, 30, n_own), rr_ref_en[:n_own])
        rr_evt[:n_own] = np.where(
            near, st["cl_evt_en"][owner, pick] + rng.integers(-1, 25, n_own),
            rr_evt[:n_own])
    want = tracker_run_compact(
        7, {k: jnp.asarray(v) for k, v in st.items()},
        jnp.asarray(rr_ref_en), jnp.asarray(rr_mc), jnp.asarray(rr_evt),
        jnp.asarray(st_w), jnp.asarray(rows_eff), interpret=True,
    )
    got = tfold(7, {k: _t(v) for k, v in st.items()}, _t(rr_ref_en),
                _t(rr_mc), _t(rr_evt), _t(st_w), _t(rows_eff))
    assert set(got) == set(st)
    for k in st:
        _eq(want[k], got[k])
    if fill == "ties" or fill >= 0.97:
        assert np.asarray(want["ovf_why"] & 1).any()  # evictions happened
