"""The seed-tracker folds' host-side launch logic and a numpy model of the
CUDA kernel's per-row reduction (``csrc/tracker_kernel.cu``).

- ``fold_launch`` picks the form (table in shared or in device memory),
  the threads and the dynamic shared-memory bytes by CL; every choice fits
  the 232,448 bytes a block may take on the H100.
- Off the CPU the wrappers go to the launcher with that choice and count
  the form that ran; they never take the plain fold there.
- The model replays the kernel's row update: the order-preserving key
  words, each thread's strided clusters, the warp and block cascades, the
  decoding of the winner and the update from the broadcast result.  On the
  adversarial tie case (ties across lanes and warps, matches at index 0
  and CL-1, int32 extremes, a wrapped r2, every slot free or occupied,
  collisions) and on random tables it equals the plain folds bit for bit,
  at several thread counts.

Zero tolerance.  The CUDA kernels themselves are held against the plain
folds on the card by chip_smoke.py (phase 2, both forms)."""

import numpy as np
import pytest
import torch
from chip_smoke import I32_MAX, I32_MIN, TIE_SCENARIOS, tracker_tie_case
from test_tracker_kernel import _rand_state

from uncalled_tpu_torch.ops import _cuda
from uncalled_tpu_torch.ops import tracker_kernel as tk

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)

NEG = -(1 << 30)
M32 = (1 << 32) - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "CL,B,form,threads,smem",
    [
        (1, 1, "shared", 32, 624),
        (16, 1, "shared", 32, 912),
        (31, 1, "shared", 32, 1312),      # CL < 32: lanes without clusters
        (129, 1, "shared", 64, 4336),     # not a multiple of the threads
        (1000, 1, "shared", 256, 29104),  # not a multiple of 16 either
        (1024, 64, "shared", 256, 29696),   # classic rung 0 (B=64)
        (2048, 128, "shared", 512, 59392),  # classic rungs 1-2
        (2048, 256, "shared", 256, 55296),  # pooled main (16 warps an SM)
        (4096, 32, "shared", 1024, 118784),  # classic final rung
        (8192, 1, "shared", 1024, 221184),  # the threshold
        (8193, 1, "device", 1024, 16384),   # the threshold + 1
        (16384, 16, "device", 1024, 16384),  # pooled wide tier
        (65536, 4, "device", 1024, 16384),   # pooled max tier
        (16384, 1024, "device", 64, 1024),   # a wide batch: fewer threads
    ],
)
def test_fold_launch_choices(CL, B, form, threads, smem):
    fl = tk.fold_launch(CL, B)
    assert (fl.form, fl.threads, fl.smem) == (form, threads, smem)
    # layout: 2 x warps x 48-byte partials, 13 staging bytes a thread,
    # 25 bytes a cluster (six i32 fields at CL rounded to 4, one flags
    # byte at CL rounded to 16)
    tbl = 24 * (-(-CL // 4) * 4) + -(-CL // 16) * 16
    assert smem == 2 * (threads // 32) * 48 + 13 * threads + (
        tbl if form == "shared" else 0)
    assert smem <= tk.SHARED_LIMIT == 232_448


def test_fold_launch_every_width_fits():
    for CL in range(1, 2 * tk.SHARED_MAX_CL + 2):
        for B in (1, 256):
            fl = tk.fold_launch(CL, B)
            assert fl.smem <= tk.SHARED_LIMIT
            assert fl.form == ("shared" if CL <= tk.SHARED_MAX_CL
                               else "device")
            t = fl.threads
            assert t & (t - 1) == 0 and 32 <= t <= 1024
            # the smallest power of two >= CL/4 (four clusters a
            # thread) ...
            if B == 1:
                assert t == 1024 or 4 * t >= CL
                assert t == 32 or 4 * (t // 2) < CL
            # ... but at most 16 warps an SM over the card's 132 SMs
            assert t == 32 or B * t <= 132 * 16 * 32
            assert t <= tk.fold_launch(CL, 1).threads
    for CL in (0, -1):
        with pytest.raises(ValueError):
            tk.fold_launch(CL, 1)


def _meta_state(B, CL):
    st = {}
    for k in tk._TABLES:
        st[k] = torch.empty((B, CL), dtype=tk._DTYPE.get(k, tk.I32),
                            device="meta")
    for k in tk._SCALARS:
        st[k] = torch.empty(B, dtype=tk._DTYPE.get(k, tk.I32), device="meta")
    return st


@pytest.mark.parametrize("CL", [1024, 2048, 4096, 16384, 65536])
def test_wrappers_launch_off_the_cpu(monkeypatch, CL):
    """A tensor off the CPU goes to the launcher, with fold_launch's choice,
    and counts its form; the plain folds never run there."""
    calls = []

    def fake_launch(name, ptrs, *ints):
        assert len(ptrs) == 41
        calls.append((name, *ints))

    def no_plain(*a):
        raise AssertionError("plain fold off the CPU")

    monkeypatch.setattr(_cuda, "launch", fake_launch)
    monkeypatch.setattr(_cuda, "COUNTS", dict.fromkeys(_cuda.COUNTS, 0))
    monkeypatch.setattr(tk, "tracker_run_compact_plain", no_plain)
    monkeypatch.setattr(tk, "tracker_run_plain", no_plain)
    B, RT, R = 2, 48, 8

    def meta(*shape, dt=tk.I32):
        return torch.empty(shape, dtype=dt, device="meta")

    st = _meta_state(B, CL)
    out = tk.tracker_run_compact(25, st, meta(RT), meta(RT), meta(RT),
                                 meta(B), meta(B))
    assert set(out) == set(st) and out["cl_total"].shape == (B, CL)
    tk.tracker_run(25, st, meta(B, R), meta(B, R), meta(B, R),
                   meta(B, R, dt=tk.U8), meta(B))
    fl = tk.fold_launch(CL, B)
    shared = int(fl.form == "shared")
    assert calls == [
        ("tracker_fold_compact", B, CL, RT, 25, fl.threads, shared, fl.smem),
        ("tracker_fold_rows", B, CL, R, 25, fl.threads, shared, fl.smem),
    ]
    want = dict.fromkeys(_cuda.COUNTS, 0)
    want.update({"tracker_fold": 1, "tracker_fold_rows": 1,
                 f"tracker_fold_{fl.form}": 1,
                 f"tracker_fold_rows_{fl.form}": 1})
    assert _cuda.COUNTS == want
    with pytest.raises(ValueError):  # a row stream of the wrong length
        tk.tracker_run_compact(25, st, meta(RT), meta(RT + 1), meta(RT),
                               meta(B), meta(B))


# ---------------------------------------------------------------------------
# numpy model of csrc/tracker_kernel.cu's fold_row
# ---------------------------------------------------------------------------

def _w(x):
    """int32 wrap of a Python or numpy int64."""
    return (np.int64(x) + 2**31) % 2**32 - 2**31


def _flip(x):
    return (np.asarray(x, np.int64) & M32) ^ 0x80000000


def _unflip(u):
    return _w(int(u) ^ 0x80000000)


def _cascade(W, op):
    """warp_reduce's cascade along axis 0 of [n, ..., words]: the max (or
    min) of word j among the entries tied on words < j; an entry off the
    tie offers 0 to a max and ~0 to a min."""
    tie = np.ones(W.shape[:-1], bool)
    out = []
    for j in range(W.shape[-1]):
        col = np.where(tie, W[..., j], 0 if op == "max" else M32)
        b = col.max(0) if op == "max" else col.min(0)
        out.append(b)
        tie &= W[..., j] == b
    return np.stack(out, -1)


def _reduce(match, evict, nc, af, threads):
    """The kernel's three levels: each thread's strided clusters
    (c = k * threads + t), each warp's 32 threads, the block's warps.  A
    thread's strict scan equals the cascade over its clusters."""
    CL = match.shape[0]
    k = -(-CL // threads)
    pad = k * threads - CL

    def grid(a, fill):
        a = np.concatenate([a, np.full((pad, a.shape[1]), fill, a.dtype)])
        return a.reshape(k, threads, a.shape[1])

    m = _cascade(grid(match, 0), "max")  # [threads, 4]
    e = _cascade(grid(evict, M32), "min")
    m = _cascade(m.reshape(-1, 32, 4).swapaxes(0, 1), "max")  # [warps, 4]
    e = _cascade(e.reshape(-1, 32, 2).swapaxes(0, 1), "min")
    m, e = _cascade(m, "max"), _cascade(e, "min")
    return ([int(x) for x in m], [int(x) for x in e], int(nc.sum()),
            bool(af.any()))


def _model_row(t, sc, ren, mcv, e2, min_aln_len, threads):
    CL = t["cl_r1"].shape[0]
    r2, r2e = _w(ren - mcv + 1), ren
    v, cnt = t["cl_valid"], t["cl_count"]
    r1, e1, tot = (t[k].astype(np.int64) for k in
                   ("cl_r1", "cl_evt_en", "cl_total"))
    c = np.arange(CL, dtype=np.int64)
    considered = v & ((r1 < r2) | ((r1 == r2) & (e1 <= e2)))
    dr, de = _w(r2 - r1), _w(e2 - e1)
    trunc12 = np.where(de >= 0, de // 12, -(-de // 12))  # C's de / 12
    in_range = (e1 <= e2) & (dr <= de) & (dr >= trunc12)
    elig = considered & in_range
    zero = np.zeros(CL, np.int64)
    match = np.stack([np.where(elig, _flip(tot), zero),
                      np.where(elig, _flip(r1), zero),
                      np.where(elig, _flip(e1), zero),
                      np.where(elig, M32 ^ c, zero)], 1)
    evict = np.stack([_flip(np.where(cnt, tot, NEG)),
                      (c << 2) | (cnt.astype(np.int64) << 1)
                      | v.astype(np.int64)], 1)
    (mt, mr, me, mi), (eh, el), nc, af = _reduce(
        match, evict, (v & (r1 == r2) & (e1 == e2)).astype(np.int64),
        ~cnt, threads)
    if mi:
        m = M32 ^ mi
        a_r2e = int(t["cl_r2e"][m])
        tot_m, r1_m, e1_m = _unflip(mt), _unflip(mr), _unflip(me)
        assert (tot_m, r1_m, e1_m) == (tot[m], r1[m], e1[m])
        overlaps, grows = r2 < a_r2e, r2e > a_r2e
        growth = (_w(r2e - a_r2e) if grows else 0) if overlaps else mcv
        lost = nc - int(r1_m == r2 and e1_m == e2) > 0
        new_r2e = r2e if (grows or not overlaps) else a_r2e
        new_tot = _w(tot_m + growth)
        t["cl_r1"][m], t["cl_r2e"][m], t["cl_evt_en"][m] = r2, new_r2e, e2
        t["cl_total"][m] = new_tot
        if lost:
            t["cl_valid"][m] = False
        f = np.float32
        sc["len_sum"] = (sc["len_sum"] + f(growth)) + f(0) - f(0)
        sc["n_cl"] = _w(sc["n_cl"] - int(lost))
        if growth > 0 and new_tot >= min_aln_len and new_tot > sc["mm_len"]:
            sc.update(mm_len=new_tot, mm_ref_st=int(t["cl_ref_st"][m]),
                      mm_r1=r2, mm_r2e=new_r2e,
                      mm_evt_st=int(t["cl_evt_st"][m]), mm_evt_en=e2)
    else:
        m = el >> 2
        evicted_len = _unflip(eh) if el & 2 else 0
        if not af:
            sc["ovf"], sc["ovf_why"] = True, sc["ovf_why"] | 1
        for k, val in (("cl_valid", True), ("cl_count", True),
                       ("cl_r1", r2), ("cl_r2e", r2e), ("cl_ref_st", r2),
                       ("cl_evt_st", e2), ("cl_evt_en", e2),
                       ("cl_total", mcv)):
            t[k][m] = val
        f = np.float32
        sc["len_sum"] = (sc["len_sum"] + f(0)) + f(mcv) - f(evicted_len)
        sc["n_cl"] = _w(sc["n_cl"] + 1 - (el & 1))
        if mcv >= min_aln_len and mcv > sc["mm_len"]:
            sc.update(mm_len=mcv, mm_ref_st=r2, mm_r1=r2, mm_r2e=r2e,
                      mm_evt_st=e2, mm_evt_en=e2)


def _model_fold(min_aln_len, st, rows, threads):
    """rows[b]: read b's (ref_en, mc, evt, ok) in order."""
    out = {k: v.copy() for k, v in st.items()}
    for b, rb in enumerate(rows):
        t = {k: out[k][b] for k in tk._TABLES}  # views: updated in place
        sc = {k: out[k][b].item() for k in tk._SCALARS}
        sc["len_sum"] = np.float32(sc["len_sum"])
        for ren, mcv, e2, ok in rb:
            if ok:
                _model_row(t, sc, int(ren), int(mcv), int(e2), min_aln_len,
                           threads)
            else:
                f = np.float32
                sc["len_sum"] = (sc["len_sum"] + f(0)) + f(0) - f(0)
        for k in tk._SCALARS:
            out[k][b] = sc[k]
    return out


def _compact_rows(ren, mc, evt, st_w, rows_eff):
    RT = len(ren)
    out = []
    for s, n in zip(st_w, rows_eff):
        gi = np.clip(s + np.arange(max(int(n), 0)), 0, RT - 1)
        out.append([(ren[i], mc[i], evt[i], True) for i in gi])
    return out


def _expanded_rows(ren, mc, evt, row_ok, rows_r):
    return [[(ren[b, r], mc[b, r], evt[b, r], row_ok[b, r])
             for r in range(min(int(rows_r[b]), ren.shape[1]))]
            for b in range(ren.shape[0])]


def _same(want, got):
    assert set(want) == set(got)
    for k in want:
        a, b = want[k].numpy(), got[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        assert np.array_equal(a, b), k


def test_key_words_preserve_order():
    """The cascade over flip()ed words orders like the signed tuples,
    extremes included; ~index prefers the first index and is never 0."""
    vals = np.array([I32_MIN, I32_MIN + 1, NEG - 1, NEG, NEG + 1, -1, 0, 1,
                     2**30, I32_MAX - 1, I32_MAX], np.int64)
    x, y = (a.ravel() for a in np.meshgrid(vals, vals))
    W = np.stack([_flip(x), _flip(y)], 1)
    rng = np.random.default_rng(0)
    for _ in range(200):
        pick = rng.choice(len(x), 7)
        for op, want in (("max", max(zip(x[pick], y[pick]))),
                         ("min", min(zip(x[pick], y[pick])))):
            got = _cascade(W[pick], op)
            assert (_unflip(got[0]), _unflip(got[1])) == want
    idx = np.array([0, 1, 31, 32, 65535])
    assert np.all(np.diff(M32 ^ idx) < 0) and (M32 ^ idx).min() > 0


@pytest.mark.parametrize("CL", [8, 40, 128, 300, 2048])
def test_model_matches_plain_on_ties(CL):
    B = 2 * len(TIE_SCENARIOS)
    st, comp, exp = tracker_tie_case(B, CL, seed=CL)
    tst = {k: _t(v) for k, v in st.items()}
    want_c = tk.tracker_run_compact_plain(7, tst, *[_t(a) for a in comp])
    want_e = tk.tracker_run_plain(7, tst, *[_t(a) for a in exp])
    assert (want_c["ovf_why"].numpy() & 1).any()  # evictions happened
    for threads in sorted({32, tk.fold_launch(CL, B).threads, 1024}):
        _same(want_c, _model_fold(7, st, _compact_rows(*comp), threads))
        _same(want_e, _model_fold(7, st, _expanded_rows(*exp), threads))


@pytest.mark.parametrize("seed,fill,CL", [(0, 0.3, 256), (1, 1.0, 64),
                                          (2, 0.02, 96)])
def test_model_matches_plain_on_random_tables(seed, fill, CL):
    B, R = 8, 24
    rng = np.random.default_rng(seed)
    st = _rand_state(rng, B, CL, fill)
    pick = rng.integers(0, CL, (B, R))
    mc = rng.integers(1, 30, (B, R)).astype(np.int32)
    ref_en = np.where(
        rng.random((B, R)) < 0.6,
        np.take_along_axis(st["cl_r1"], pick, 1) + mc - 1
        + rng.integers(-2, 30, (B, R)),
        rng.integers(0, 5000, (B, R))).astype(np.int32)
    evt = (np.take_along_axis(st["cl_evt_en"], pick, 1)
           + rng.integers(-1, 25, (B, R))).astype(np.int32)
    rows_r = rng.integers(0, R + 1, B).astype(np.int32)
    row_ok = (np.arange(R)[None, :] < rows_r[:, None]) & (
        rng.random((B, R)) < 0.95)
    args = (ref_en, mc, evt, row_ok, rows_r)
    want = tk.tracker_run_plain(7, {k: _t(v) for k, v in st.items()},
                                *[_t(a) for a in args])
    _same(want, _model_fold(7, st, _expanded_rows(*args),
                            tk.fold_launch(CL, B).threads))
