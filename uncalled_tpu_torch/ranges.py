"""Closed-interval (FM SA range) arithmetic.

Re-design of the reference's ``Range`` primitive (range.hpp:34-65,
range.cpp:40-120) as vectorized structure-of-arrays functions: every op
takes/returns ``(start, end)`` integer array pairs and broadcasts, so
interval math can run elementwise on device (no per-object methods in
the hot path).  Each op takes numpy arrays (or scalars) and gives numpy
results, or takes torch tensors, on the CPU or the card, and gives tensors
on the input's device with the same values: the arithmetic is written once
against the namespace ``_ns`` picks from the arguments' type.  A thin
scalar :class:`Range` dataclass keeps the reference's object API for
host-side code and tests.

Conventions (identical to the reference):
  * intervals are CLOSED ``[start, end]``; ``length = end - start + 1``
  * invalid/empty is encoded as ``start > end`` (default ``(1, 0)``,
    range.cpp:41)
  * ``intersect``/``merge`` of non-overlapping ranges yield the invalid
    range (range.cpp:107-119)
  * ``recp_overlap = |intersection| / |union|`` for overlapping ranges,
    else 0 (range.cpp:93-99)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

INVALID = (1, 0)  # start > end, range.cpp:41


class _Numpy:
    maximum = staticmethod(np.maximum)
    minimum = staticmethod(np.minimum)
    where = staticmethod(np.where)
    ones_like = staticmethod(np.ones_like)
    zeros_like = staticmethod(np.zeros_like)

    @staticmethod
    def f32(x):
        return x.astype(np.float32)


class _Torch:
    maximum = staticmethod(torch.maximum)
    minimum = staticmethod(torch.minimum)
    where = staticmethod(torch.where)
    ones_like = staticmethod(torch.ones_like)
    zeros_like = staticmethod(torch.zeros_like)

    @staticmethod
    def f32(x):
        return x.to(torch.float32)


def _ns(*xs):
    """The namespace for these arguments, and the arguments in it: torch
    when any is a tensor (the others become tensors on its device), else
    numpy."""
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    if dev is None:
        return _Numpy, xs
    return _Torch, tuple(torch.as_tensor(x, device=dev) for x in xs)


def is_valid(st, en):
    return st <= en


def length(st, en):
    """Closed-interval length (valid ranges only, range.cpp:49-51)."""
    return en - st + 1


def intersects(ast, aen, bst, ben):
    """Both valid and overlapping (range.cpp:43-47)."""
    return (ast <= aen) & (bst <= ben) & (ast <= ben) & (bst <= aen)


def intersect(ast, aen, bst, ben):
    """Elementwise intersection; invalid (1, 0) where disjoint
    (range.cpp:71-77)."""
    xp, (ast, aen, bst, ben) = _ns(ast, aen, bst, ben)
    ok = intersects(ast, aen, bst, ben)
    st = xp.maximum(ast, bst)
    en = xp.minimum(aen, ben)
    return xp.where(ok, st, xp.ones_like(st)), xp.where(ok, en,
                                                        xp.zeros_like(en))


def merge(ast, aen, bst, ben):
    """Elementwise union hull of OVERLAPPING ranges; invalid where
    disjoint (range.cpp:79-85: merge of non-intersecting is invalid)."""
    xp, (ast, aen, bst, ben) = _ns(ast, aen, bst, ben)
    ok = intersects(ast, aen, bst, ben)
    st = xp.minimum(ast, bst)
    en = xp.maximum(aen, ben)
    return xp.where(ok, st, xp.ones_like(st)), xp.where(ok, en,
                                                        xp.zeros_like(en))


def recp_overlap(ast, aen, bst, ben):
    """Reciprocal overlap |A∩B| / |A∪B| in f32; 0 where disjoint
    (range.cpp:93-99)."""
    xp, (ast, aen, bst, ben) = _ns(ast, aen, bst, ben)
    ok = intersects(ast, aen, bst, ben)
    ist, ien = intersect(ast, aen, bst, ben)
    mst, men = merge(ast, aen, bst, ben)
    num = xp.f32(length(ist, ien))
    lm = length(mst, men)
    den = xp.f32(xp.maximum(lm, xp.ones_like(lm)))
    q = num / den
    return xp.where(ok, q, xp.zeros_like(q))


def split(ast, aen, bst, ben):
    """Remove B from A (range.cpp:53-69 ``split_range``): returns the
    LEFT remainder and the RIGHT remainder (the reference mutates self to
    the right part and returns the left).  Either may be invalid."""
    xp, (ast, aen, bst, ben) = _ns(ast, aen, bst, ben)
    has_left = ast < bst
    lst = xp.where(has_left, ast, xp.ones_like(ast))
    len_ = xp.where(has_left, bst - 1, xp.zeros_like(aen))
    touches = ast <= ben
    rst = xp.where(touches, xp.where(aen > ben, ben + 1, xp.ones_like(ast)),
                   ast)
    ren = xp.where(touches, xp.where(aen > ben, aen, xp.zeros_like(aen)), aen)
    return (lst, len_), (rst, ren)


@dataclass(frozen=True)
class Range:
    """Scalar convenience wrapper (host-side API parity, range.hpp:34-65)."""

    start: int = 1
    end: int = 0

    def is_valid(self) -> bool:
        return self.start <= self.end

    def length(self) -> int:
        return self.end - self.start + 1

    def intersects(self, o: "Range") -> bool:
        return bool(intersects(self.start, self.end, o.start, o.end))

    def intersect(self, o: "Range") -> "Range":
        st, en = intersect(self.start, self.end, o.start, o.end)
        return Range(int(st), int(en))

    def merge(self, o: "Range") -> "Range":
        st, en = merge(self.start, self.end, o.start, o.end)
        return Range(int(st), int(en))

    def recp_overlap(self, o: "Range") -> float:
        return float(recp_overlap(self.start, self.end, o.start, o.end))

    def same_range(self, o: "Range") -> bool:
        return self.start == o.start and self.end == o.end

    def __lt__(self, o: "Range") -> bool:
        # strict-weak order by (start, end), range.cpp:122-125
        return (self.start, self.end) < (o.start, o.end)
