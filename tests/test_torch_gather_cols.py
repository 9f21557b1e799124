"""The column-descriptor gathers (``flat_gather_cols``, ``row_gather_cols``
and ``row_gather`` over segment tables) against the JAX fields gathers on
the table the descriptor describes, run through the Pallas kernels in
interpret mode as the JAX package's own tests run them.  Zero tolerance:
integers and bools equal, floats as raw bits (NaN payloads and -0.0
included); out-of-range indices clamp on both sides.

The descriptor's encoding (the pointers, byte strides, kinds, constants
and bounds the CUDA launcher receives) is also replayed here, address by
address over the tensors' storage, the way the kernel reads it; the CUDA
kernel itself is held against the plain versions on the card by
chip_smoke.py."""

import ctypes

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interp(monkeypatch):
    from uncalled_tpu.ops import flat_gather, mxu_gather

    monkeypatch.setattr(flat_gather, "_INTERPRET", True)
    monkeypatch.setattr(mxu_gather, "_INTERPRET", True)


SPECIAL = np.concatenate([
    np.array([0.0, -0.0, np.inf, -np.inf, np.nan], np.float32),
    np.array([0x7FC01234, -0x003FFFFF, 0x7F800001], np.int32).view(
        np.float32),  # NaN payloads, a signalling NaN
])


def _arr(rng, shape, dt):
    if dt == "i32":
        return rng.integers(-(2**31), 2**31, shape, dtype=np.int64).astype(
            np.int32)
    if dt == "bool":
        return rng.random(shape) < 0.5
    a = rng.standard_normal(shape).astype(np.float32)
    flat = a.reshape(-1)
    n = max(8, flat.size // 8)
    flat[rng.integers(0, flat.size, n)] = rng.choice(SPECIAL, n)
    return a


def _bits(a):
    """numpy int32 payload of a column segment (f32 as bits, bool 0/1)."""
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32)
    return a.astype(np.int32)


def _const(c, dt):
    if dt == "f32":
        return np.array([c], np.float32).view(np.int32)[0]
    return np.int32(int(c))


def _table(cols, lens, dts, B=None):
    """The int32 table [N, F] (or [B, N, F]) a numpy column list
    describes; a 1-D segment in the per-row form is shared by every row."""
    out = []
    for col, dt in zip(cols, dts):
        parts = []
        for seg, n in zip(col, lens):
            shape = (n,) if B is None else (B, n)
            if np.isscalar(seg):
                parts.append(np.full(shape, _const(seg, dt), np.int32))
            else:
                parts.append(np.broadcast_to(_bits(seg), shape))
        out.append(np.concatenate(parts, -1))
    return np.ascontiguousarray(np.stack(out, -1))


def _torch_cols(cols, views):
    """The same columns as torch tensors; ``views`` maps a column's numpy
    base array to the torch tensor it is a view of."""
    out = []
    for col in cols:
        segs = []
        for seg in col:
            if np.isscalar(seg):
                segs.append(seg.item() if isinstance(seg, np.generic)
                            else seg)
            else:
                segs.append(views(seg))
        out.append(segs)
    return out


def _check(got, want_fields, dts):
    assert len(got) == len(want_fields) == len(dts)
    for g, w, dt in zip(got, want_fields, dts):
        w = np.asarray(w)
        assert g.dtype == {"i32": torch.int32, "f32": torch.float32,
                           "bool": torch.bool}[dt]
        assert tuple(g.shape) == w.shape
        assert np.array_equal(_bits(g.numpy()), w)


def _idx(rng, shape, N):
    idx = rng.integers(0, N, shape).astype(np.int32)
    flat = idx.reshape(-1)
    flat[: 4] = [-7, -1, N, N + 5][: min(4, flat.size)]
    return idx


# ---------------------------------------------------------------------------
# flat form
# ---------------------------------------------------------------------------

def _flat_case(name, rng):
    """(numpy columns, torch columns, dtypes, lens for the call or None)."""
    if name in ("i32", "f32", "bool"):
        N = 700
        arrs = [_arr(rng, (N,), name) for _ in range(3)]
        cols = [[a] for a in arrs]
        return cols, [[torch.from_numpy(a)] for a in arrs], [name] * 3, None
    if name == "strided":
        # [:, c] of a [N, 4] f32 table (vector-eligible), [:, 1] of a
        # [N, 5] int32 table, a bool column and a row of a [2, N] buffer
        N = 900
        t4 = _arr(rng, (N, 4), "f32")
        t5 = _arr(rng, (N, 5), "i32")
        tb = _arr(rng, (N,), "bool")
        t2 = _arr(rng, (2, N), "i32")
        T4, T5, TB = map(torch.from_numpy, (t4, t5, tb))
        T2 = torch.from_numpy(t2).T  # [N, 2] view of the [2, N] buffer
        cols = [[t4[:, c]] for c in range(4)] + [[t5[:, 1]], [tb], [t2[1]]]
        tcols = [[T4[:, c]] for c in range(4)] + [[T5[:, 1]], [TB],
                                                   [T2[:, 1]]]
        return cols, tcols, ["f32"] * 4 + ["i32", "bool", "i32"], None
    if name == "segments":
        # the unified record table's shape: five segments, fills as
        # constants, a head/gap pair of one tensor, bool and f32 columns
        a_i, h_i, f_i, d_i = (_arr(rng, (n,), "i32") for n in (96, 40, 64,
                                                               128))
        a_b, d_b = _arr(rng, (96,), "bool"), _arr(rng, (128,), "bool")
        a_f, h_f, f_f = (_arr(rng, (n,), "f32") for n in (96, 40, 64))
        cols = [
            [a_i, h_i, h_i, f_i, d_i],
            [a_i, np.int32(1), np.int32(1), np.int32(1), d_i],
            [a_b, False, False, False, d_b],
            [d_i[:96], -1, -1, -1, np.int32(-7)],
            [a_f, h_f, h_f, f_f, 0.0],
            [a_f, -0.0, float("nan"), 2.5, a_f[:32].repeat(4)],
        ]
        base = {}

        def views(seg):
            key = id(seg)
            if key not in base:
                base[key] = torch.from_numpy(np.ascontiguousarray(seg))
            return base[key]

        return (cols, _torch_cols(cols, views),
                ["i32", "i32", "bool", "i32", "f32", "f32"], None)
    if name == "lens":
        # a segment constant in every column needs lens
        a, d = _arr(rng, (50,), "i32"), _arr(rng, (50,), "f32")
        cols = [[a, 5, 9], [d, -3, 1.5]]
        tcols = [[torch.from_numpy(a), 5, 9], [torch.from_numpy(d), -3, 1.5]]
        return cols, tcols, ["i32", "f32"], [50, 20, 10]
    raise KeyError(name)


def _call_lens(cols, lens):
    if lens is not None:
        return lens
    out = []
    for s in range(len(cols[0])):
        out.append(next(np.shape(c[s])[-1] for c in cols
                        if not np.isscalar(c[s])))
    return out


@pytest.mark.parametrize("case", ["i32", "f32", "bool", "strided",
                                  "segments", "lens"])
def test_flat_gather_cols_matches_jax(case):
    import jax.numpy as jnp

    from uncalled_tpu.ops import flat_gather as FG

    from uncalled_tpu_torch.ops import flat_gather as TG

    rng = np.random.default_rng(sum(map(ord, case)))
    cols, tcols, dts, lens = _flat_case(case, rng)
    L = _call_lens(cols, lens)
    tbl = _table(cols, L, dts)
    N, F = tbl.shape
    assert FG.fits(N, F)
    idx = _idx(rng, (333,), N)
    want = FG.flat_gather_fields(jnp.asarray(tbl), jnp.asarray(idx),
                                 force=True)
    got = TG.flat_gather_cols(tcols, torch.from_numpy(idx), lens=lens)
    _check(got, want, dts)
    _check(TG.flat_gather_cols_plain(tcols, torch.from_numpy(idx), lens),
           want, dts)


# ---------------------------------------------------------------------------
# per-row form
# ---------------------------------------------------------------------------

def _row_case(name, rng, B):
    if name in ("i32", "f32", "bool"):
        W = 300
        arrs = [_arr(rng, (B, W), name) for _ in range(3)]
        return ([[a] for a in arrs], [[torch.from_numpy(a)] for a in arrs],
                [name] * 3, None)
    if name == "strided":
        # the classic parent pack: [B, W] fields (a bool among them) beside
        # ring columns r[:, :, c] of a [B, W, 23] f32 ring
        W = 200
        ring = _arr(rng, (B, W, 23), "f32")
        fi = _arr(rng, (B, W), "i32")
        fb = _arr(rng, (B, W), "bool")
        R, FI, FB = map(torch.from_numpy, (ring, fi, fb))
        cols = [[fi], [fb], [ring[:, :, 0]], [ring[:, :, 7]],
                [ring[:, :, 22]]]
        tcols = [[FI], [FB], [R[:, :, 0]], [R[:, :, 7]], [R[:, :, 22]]]
        return cols, tcols, ["i32", "bool", "f32", "f32", "f32"], None
    if name == "shared":
        # the classic tbl4: per-read prob rows [B, 64, 4] beside shared
        # threshold rows [12, 4], as a 1-D shared segment and as a
        # stride-0 expand of the batch dim
        probs = _arr(rng, (B, 64, 4), "f32")
        th = _arr(rng, (12, 4), "f32")
        P, TH = torch.from_numpy(probs), torch.from_numpy(th)
        cols = [[probs[:, :, c], th[:, c]] for c in range(4)]
        tcols = [[P[:, :, c], TH[:, c]] for c in range(2)] + [
            [P[:, :, c], TH[None].expand(B, 12, 4)[:, :, c]]
            for c in range(2, 4)]
        return cols, tcols, ["f32"] * 4, None
    if name == "segments":
        a, h, f, d = (_arr(rng, (B, n), "i32") for n in (40, 17, 33, 50))
        sh = _arr(rng, (33,), "i32")  # shared by every row
        ab, db = _arr(rng, (B, 40), "bool"), _arr(rng, (B, 50), "bool")
        af = _arr(rng, (B, 40), "f32")
        cols = [
            [a, h, h, f, d],
            [a, 1, 1, sh, d],
            [ab, False, True, False, db],
            [af, 0.0, -0.0, 3.0, -1.0],
            [d[:, :40], -1, -1, -1, np.int32(2**31 - 1)],
        ]
        base = {}

        def views(seg):
            key = id(seg)
            if key not in base:
                base[key] = torch.from_numpy(np.ascontiguousarray(seg))
            return base[key]

        return (cols, _torch_cols(cols, views),
                ["i32", "i32", "bool", "f32", "i32"], None)
    raise KeyError(name)


@pytest.mark.parametrize("case", ["i32", "f32", "bool", "strided", "shared",
                                  "segments"])
def test_row_gather_cols_matches_jax(case):
    import jax.numpy as jnp

    from uncalled_tpu.ops import mxu_gather as JG

    from uncalled_tpu_torch.ops import mxu_gather as TG

    rng = np.random.default_rng(sum(map(ord, case)) + 1)
    B = 5
    cols, tcols, dts, lens = _row_case(case, rng, B)
    L = _call_lens(cols, lens)
    tbl = _table(cols, L, dts, B=B)
    idx = _idx(rng, (B, 77), tbl.shape[1])
    want = JG.row_gather_fields(jnp.asarray(tbl), jnp.asarray(idx),
                                force=True)
    got = TG.row_gather_cols(tcols, torch.from_numpy(idx), lens=lens)
    _check(got, want, dts)


def test_row_gather_segment_tables_match_jax():
    """``row_gather`` over [per-read, shared-by-expand] segment tables (the
    classic tbl4) equals the JAX gather of the concatenated table."""
    import jax.numpy as jnp

    from uncalled_tpu.ops import mxu_gather as JG

    from uncalled_tpu_torch.ops import mxu_gather as TG

    rng = np.random.default_rng(4)
    B = 6
    probs = _arr(rng, (B, 64, 4), "f32")
    th = _arr(rng, (12, 4), "f32")
    idx = _idx(rng, (B, 90), 76)
    want = JG.row_gather(
        jnp.asarray(np.concatenate([probs, np.broadcast_to(th, (B, 12, 4))],
                                   1)), jnp.asarray(idx), force=True)
    got = TG.row_gather([torch.from_numpy(probs),
                         torch.from_numpy(th)[None].expand(B, 12, 4)],
                        torch.from_numpy(idx))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.array_equal(np.asarray(want).view(np.int32),
                          got.numpy().view(np.int32))


# ---------------------------------------------------------------------------
# what the wrappers refuse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["flat", "row"])
def test_gather_cols_raises(form):
    from uncalled_tpu_torch.ops import flat_gather as TG
    from uncalled_tpu_torch.ops import mxu_gather as MG

    if form == "flat":
        fn, shape = TG.flat_gather_cols, (40,)
        idx = torch.zeros(9, dtype=torch.int32)
    else:
        fn, shape = MG.row_gather_cols, (3, 40)
        idx = torch.zeros((3, 9), dtype=torch.int32)

    def col(dt=torch.int32, n=None):
        s = shape if n is None else shape[:-1] + (n,)
        return torch.zeros(s, dtype=dt)

    with pytest.raises(ValueError, match="columns"):
        fn([col() for _ in range(17)], idx)
    with pytest.raises(ValueError, match="columns"):
        fn([], idx)
    for bad in (torch.int64, torch.float64, torch.int16):
        with pytest.raises(TypeError, match="int32, float32 or bool"):
            fn([col(), col(bad)], idx)
    with pytest.raises(TypeError, match="one dtype"):
        fn([[col(), col(torch.float32)]], idx)
    with pytest.raises(ValueError, match="long"):
        fn([[col(), col(n=5)], [col(n=41), col(n=5)]], idx)
    with pytest.raises(ValueError, match="segments"):
        fn([[col(), col()], [col()]], idx)
    with pytest.raises(ValueError, match="segments"):
        fn([[col(n=1)] * 6], idx)
    with pytest.raises(ValueError, match="needs lens"):
        fn([[col(), 1], [col(), 2]], idx)
    with pytest.raises(ValueError, match="on meta"):
        fn([col(), col().to("meta")], idx)
    with pytest.raises(ValueError, match="idx"):
        fn([col()], idx.to(torch.int64))
    # 16 columns is the limit, not an error
    assert len(fn([col() for _ in range(16)], idx)) == 16


# ---------------------------------------------------------------------------
# the descriptor as the kernel reads it
# ---------------------------------------------------------------------------

def _memory(tensors):
    """Address -> bytes over the storages of ``tensors``: a read outside
    them fails the test instead of touching memory."""
    spans = []
    for t in tensors:
        st = t.untyped_storage()
        spans.append((st.data_ptr(), np.frombuffer(
            ctypes.string_at(st.data_ptr(), st.nbytes()), np.uint8)))

    def read(addr, size):
        for base, buf in spans:
            if base <= addr and addr + size <= base + buf.size:
                return buf[addr - base: addr - base + size]
        raise AssertionError(f"read of {size} bytes at {addr:#x} lies "
                             "outside every segment's storage")
    return read


def _tensors(cols):
    return [t for c in cols for t in (c if isinstance(c, (list, tuple))
                                      else [c])
            if isinstance(t, torch.Tensor)]


def _kernel_model(meta, tensors, idx2d):
    """The CUDA kernel's reads replayed from the launcher's int64 meta
    array over the storage of ``tensors``: for each (b, k) the clamped
    index, its segment, and each column's load at pointer + b * bstride +
    r * estride (a bool byte, a 32-bit word, four words for a 16-byte
    load, or the constant) -> [F, B, K] int32."""
    from uncalled_tpu_torch.ops.colgather import REC

    F, nseg, B, K = meta[:4]
    assert idx2d.shape == (B, K)
    bound = meta[4: 5 + nseg]
    rec = meta[5 + nseg:]
    read = _memory(tensors)
    out = np.zeros((F, B, K), np.int32)
    for b in range(B):
        for k in range(K):
            i = min(max(int(idx2d[b, k]), 0), bound[nseg] - 1)
            s = max(j for j in range(nseg) if i >= bound[j])
            r = i - bound[s]
            f = 0
            while f < F:
                ptr, bst, est, kind, konst = rec[REC * (s * F + f):
                                                 REC * (s * F + f + 1)]
                at = ptr + b * bst + r * est
                if kind == 16:
                    out[f: f + 4, b, k] = read(at, 16).view(np.int32)
                    f += 4
                    continue
                if kind == 0:
                    out[f, b, k] = konst
                elif kind == 1:
                    out[f, b, k] = int(read(at, 1)[0] != 0)
                else:
                    assert kind == 4
                    out[f, b, k] = read(at, 4).view(np.int32)[0]
                f += 1
    return out


@pytest.mark.parametrize("form,case", [
    ("flat", "strided"), ("flat", "segments"), ("flat", "lens"),
    ("row", "strided"), ("row", "shared"), ("row", "segments"),
])
def test_descriptor_encoding_reads_the_plain_table(form, case):
    """Every pointer, byte stride, kind and bound the launcher receives
    reads, address by address, the table the plain version builds."""
    from uncalled_tpu_torch.ops import colgather as cg

    rng = np.random.default_rng(7)
    if form == "flat":
        _, tcols, _, lens = _flat_case(case, rng)
        idx = torch.from_numpy(_idx(rng, (1, 40), 10**6))
    else:
        _, tcols, _, lens = _row_case(case, rng, 3)
        idx = torch.from_numpy(_idx(rng, (3, 25), 10**6))
    rows = form == "row"
    segs, dtypes, lens = cg.describe(tcols, idx if rows else idx[0], rows,
                                     lens)
    N = sum(lens)
    idx = torch.remainder(idx, N + 6) - 3  # out of range on both sides
    tbl = cg.pack_plain(segs, lens, idx.device, B=3 if rows else None)
    ix = idx.clamp(0, N - 1).long()
    if rows:
        want = torch.gather(tbl, 1, ix[:, :, None].expand(-1, -1, len(segs)))
    else:
        want = tbl.index_select(0, ix[0])[None]
    want = want.permute(2, 0, 1).numpy()
    meta = cg.encode(segs, lens, *idx.shape)
    assert np.array_equal(_kernel_model(meta, _tensors(segs), idx.numpy()),
                          want)


def test_launch_path_through_the_kernel_model(monkeypatch):
    """The wrappers' launch path (descriptor, chunks of 16 fields, output
    slices, counts, unpacking) on the CPU, with the kernel model standing
    in for the CUDA launcher."""
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import colgather as cg
    from uncalled_tpu_torch.ops import flat_gather as TG
    from uncalled_tpu_torch.ops import mxu_gather as MG

    calls, tensors = [], []

    def fake_launch(name, meta, idx2d, out):
        calls.append(name)
        out.copy_(torch.from_numpy(
            _kernel_model(meta, tensors, idx2d.numpy())).view(out.shape))

    monkeypatch.setattr(_cuda, "launch", fake_launch)
    monkeypatch.setattr(_cuda, "COUNTS", dict.fromkeys(_cuda.COUNTS, 0))
    rng = np.random.default_rng(11)
    # a flat [N, 23] f32 table: two launches (16 + 7 fields)
    tbl = torch.from_numpy(_arr(rng, (300, 23), "f32"))
    idx = torch.from_numpy(_idx(rng, (50,), 300))
    tensors.append(tbl)
    got = cg.gather_table("flat_gather", [tbl], idx).view(torch.float32)
    assert torch.equal(got.view(torch.int32),
                       TG.flat_gather_fields_plain(tbl, idx).view(
                           torch.int32))
    # per-row segment tables: [B, 40, 20] beside a shared [9, 20] expand
    B = 3
    t1 = torch.from_numpy(_arr(rng, (B, 40, 20), "i32"))
    t2 = torch.from_numpy(_arr(rng, (9, 20), "i32"))[None].expand(B, 9, 20)
    ridx = torch.from_numpy(_idx(rng, (B, 30), 49))
    tensors += [t1, t2]
    got = cg.gather_table("row_gather", [t1, t2], ridx).permute(1, 2, 0)
    assert torch.equal(got, MG.row_gather_plain([t1, t2], ridx))
    # a shared [N, 4] f32 table (16-byte loads) and a per-row bool table
    t4 = torch.from_numpy(_arr(rng, (49, 4), "f32"))
    tb = torch.from_numpy(_arr(rng, (B, 49, 2), "bool"))
    tensors += [t4, tb]
    got = cg.gather_table("row_gather", [t4], ridx).permute(1, 2, 0)
    assert torch.equal(got, MG.shared_gather_plain(t4, ridx).view(
        torch.int32))
    got = cg.gather_table("row_gather", [tb], ridx).permute(1, 2, 0)
    assert torch.equal(got != 0, MG.row_gather_plain(tb, ridx))
    # one descriptor launch with bool, f32 and constant segments
    cols = [[torch.from_numpy(_arr(rng, (B, 40), "bool")), True],
            [torch.from_numpy(_arr(rng, (B, 40), "f32")), -0.0],
            [t1[:, :, 3], t2[:, :, 5]]]
    tensors += _tensors(cols)
    got = cg.unpack(*cg.gather("row_gather", cols, ridx, lens=[40, 9]))
    want = MG.row_gather_cols_plain(cols, ridx, lens=[40, 9])
    _check(got, [_bits(w.numpy()) for w in want], ["bool", "f32", "i32"])
    assert calls == ["flat_gather_cols_i32"] * 2 + ["row_gather_cols_i32"] * 5
    assert _cuda.COUNTS["flat_gather"] == 2 and _cuda.COUNTS["row_gather"] == 5


def test_encode_takes_16_byte_loads_only_where_they_fit():
    from uncalled_tpu_torch.ops import colgather as cg

    idx = torch.zeros(4, dtype=torch.int32)

    def kinds(cols):
        segs, _, lens = cg.describe(cols, idx, False)
        meta = cg.encode(segs, lens, 1, 4)
        return meta[5 + len(lens) + 3:: cg.REC]

    t4 = torch.zeros((64, 4), dtype=torch.float32)
    t5 = torch.zeros((64, 5), dtype=torch.int32)
    t8 = torch.zeros((64, 8), dtype=torch.int32)
    assert kinds([t4[:, c] for c in range(4)]) == [16, 4, 4, 4]
    # 20-byte rows, a shifted quad, a reordered quad, a bool in the quad
    assert kinds([t5[:, c] for c in range(4)]) == [4] * 4
    assert kinds([t8[:, c] for c in range(1, 5)]) == [4] * 4
    assert kinds([t4[:, c] for c in (1, 0, 2, 3)]) == [4] * 4
    assert kinds([t8[:, c] for c in range(8)]) == [16, 4, 4, 4] * 2
    assert kinds([t8[:, 0], t8[:, 1], t8[:, 2],
                  torch.zeros(64, dtype=torch.bool)]) == [4, 4, 4, 1]
