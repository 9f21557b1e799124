"""The port's FM-range arithmetic equals the JAX package's, on numpy
arrays and on CPU tensors (zero tolerance: integers equal, the f32
overlap as raw bits, dtypes equal), and the ``Range`` wrapper behaves
the same."""

import numpy as np
import pytest
import torch

from uncalled_tpu import ranges as JR
from uncalled_tpu_torch import ranges as R

torch.set_num_threads(1)


def _cases(dtype, n=4000):
    """tests/test_ranges.py's cases: some ranges invalid, many touching."""
    rng = np.random.default_rng(7)
    ast = rng.integers(0, 50, n)
    aen = ast + rng.integers(-3, 30, n)
    bst = rng.integers(0, 50, n)
    ben = bst + rng.integers(-3, 30, n)
    return tuple(a.astype(dtype) for a in (ast, aen, bst, ben))


def _flat(res):
    """The arrays of an op's result, nested pairs flattened."""
    if isinstance(res, tuple):
        return [x for r in res for x in _flat(r)]
    return [res]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


OPS = ("is_valid2", "length2", "intersects", "intersect", "merge",
       "recp_overlap", "split")


def _call(mod, op, args):
    if op.endswith("2"):
        return getattr(mod, op[:-1])(*args[:2])
    return getattr(mod, op)(*args)


def _same(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if want.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
@pytest.mark.parametrize("op", OPS)
def test_ops_equal_jax(op, dtype, kind):
    args = _cases(dtype)
    want = _flat(_call(JR, op, args))
    targs = tuple(torch.from_numpy(a) for a in args) if kind == "tensor" \
        else args
    got = _flat(_call(R, op, targs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if kind == "tensor":
            assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        _same(g, w)


def _ref_intersects(a, b):
    (as_, ae), (bs, be) = a, b
    return as_ <= ae and bs <= be and not (as_ > be or ae < bs)


def _ref_split(a, b):
    # range.cpp:53-69: returns the left part, mutates self to the right part
    left = (1, 0)
    st, en = a
    if st < b[0]:
        left = (st, b[0] - 1)
    if st <= b[1]:
        if en > b[1]:
            st = b[1] + 1
        else:
            st, en = 1, 0
    return left, (st, en)


def test_reference_semantics_on_tensors():
    """The tensors' values are range.cpp's (tests/test_ranges.py's
    literal transcription), pair by pair."""
    args = tuple(torch.from_numpy(a) for a in _cases(np.int64, 1000))
    ok = R.intersects(*args)
    ist, ien = R.intersect(*args)
    mst, men = R.merge(*args)
    ov = R.recp_overlap(*args)
    (lst, len_), (rst, ren) = R.split(*args)
    for i in range(len(args[0])):
        a = (int(args[0][i]), int(args[1][i]))
        b = (int(args[2][i]), int(args[3][i]))
        hit = _ref_intersects(a, b)
        assert bool(ok[i]) == hit
        want_i = (max(a[0], b[0]), min(a[1], b[1])) if hit else (1, 0)
        want_m = (min(a[0], b[0]), max(a[1], b[1])) if hit else (1, 0)
        assert (int(ist[i]), int(ien[i])) == want_i
        assert (int(mst[i]), int(men[i])) == want_m
        want_ov = np.float32(want_i[1] - want_i[0] + 1) / np.float32(
            want_m[1] - want_m[0] + 1) if hit else np.float32(0)
        assert float(ov[i]) == float(want_ov)
        el, er = _ref_split(a, b)
        assert (int(lst[i]), int(len_[i])) == el
        assert (int(rst[i]), int(ren[i])) == er


def test_tensor_with_scalars():
    """A tensor beside plain ints broadcasts as numpy does, on the
    tensor's device."""
    ast, aen, _, _ = _cases(np.int64, 64)
    t = torch.from_numpy
    for op in ("intersect", "merge", "recp_overlap", "split"):
        got = _flat(getattr(R, op)(t(ast), t(aen), 12, 30))
        want = _flat(getattr(JR, op)(ast, aen, np.int64(12), np.int64(30)))
        for g, w in zip(got, want):
            assert isinstance(g, torch.Tensor)
            _same(g, w)


def test_scalar_wrapper():
    for M in (R, JR):
        a = M.Range(10, 20)
        b = M.Range(15, 30)
        assert a.intersects(b)
        assert a.intersect(b) == M.Range(15, 20)
        assert a.merge(b) == M.Range(10, 30)
        assert abs(a.recp_overlap(b) - 6 / 21) < 1e-6
        assert not M.Range().is_valid()  # default is the invalid (1, 0)
        assert M.Range(5, 5).length() == 1
        assert M.Range(1, 2) < M.Range(1, 3) < M.Range(2, 2)
        d = M.Range(10, 20)
        assert not d.intersects(M.Range(21, 25))
        assert d.intersect(M.Range(21, 25)) == M.Range()
        assert d.same_range(M.Range(10, 20)) and not d.same_range(b)
    assert R.INVALID == JR.INVALID == (1, 0)
    rng = np.random.default_rng(5)
    for _ in range(200):
        s = rng.integers(0, 40, 4)
        e = s + rng.integers(-2, 20, 4)
        pa, pb = R.Range(int(s[0]), int(e[0])), R.Range(int(s[1]), int(e[1]))
        ja, jb = JR.Range(int(s[0]), int(e[0])), JR.Range(int(s[1]), int(e[1]))
        assert pa.intersects(pb) == ja.intersects(jb)
        assert vars(pa.intersect(pb)) == vars(ja.intersect(jb))
        assert vars(pa.merge(pb)) == vars(ja.merge(jb))
        assert pa.recp_overlap(pb) == ja.recp_overlap(jb)
        assert (pa < pb) == (ja < jb)
        assert pa.length() == ja.length() and pa.is_valid() == ja.is_valid()
