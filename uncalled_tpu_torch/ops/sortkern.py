"""One bitonic merge level of the pooled candidate sort (port of
``uncalled_tpu.ops.sortkern``).

``merge_level(ks, k_lv, C)`` runs every XOR pass s = k_lv/2, ..., C of
merge level ``k_lv`` over the int32 key tuple ``ks`` (each [NP]): the
partner of i is i ^ s, a chunk sorts ascending iff (i & k_lv) == 0, the
comparison is lexicographic over the whole tuple, and ties never swap.
``pooled._sort1d_bitonic`` calls it once per level at strides >= C and
finishes each level with a row sort of width C.

A plain PyTorch version (the XLA pass loop of the JAX
``_sort1d_bitonic``, restricted to one level) plus a hand-written CUDA
kernel (``csrc/sortkern.cu``), bit-exact to each other.  Both return new
tensors and leave the caller's keys as they were.
"""

from __future__ import annotations

import torch

from . import _cuda

I32 = torch.int32
MAX_NK = 8


def _lex_lt(a, b):
    """Lexicographic a < b over tuples of int32 tensors."""
    out = eq = None
    for x, y in zip(a, b):
        lt = x < y
        if out is None:
            out, eq = lt, x == y
        else:
            out = out | (eq & lt)
            eq = eq & (x == y)
    return out


def _check_shape(ks, k_lv: int, C: int) -> int:
    NP = ks[0].shape[0]
    if not (NP % k_lv == 0 and k_lv % (2 * C) == 0 and C % 128 == 0):
        raise ValueError(f"merge_level: NP={NP} k_lv={k_lv} C={C} (need "
                         "NP % k_lv == 0, k_lv % 2C == 0, C % 128 == 0)")
    return NP


def merge_level_plain(ks, k_lv: int, C: int):
    NP = _check_shape(ks, k_lv, C)
    dev = ks[0].device
    s = k_lv // 2
    while s >= C:
        G = NP // (2 * s)
        up = ((torch.arange(G, dtype=I32, device=dev) * (2 * s))
              & k_lv) == 0
        v = [k.reshape(G, 2, s) for k in ks]
        a = [x[:, 0, :] for x in v]
        b = [x[:, 1, :] for x in v]
        swap = torch.where(up[:, None], _lex_lt(b, a), _lex_lt(a, b))
        ks = [
            torch.stack([torch.where(swap, bb, aa), torch.where(swap, aa, bb)],
                        1).reshape(NP)
            for aa, bb in zip(a, b)
        ]
        s //= 2
    return list(ks)


def merge_level(ks, k_lv: int, C: int):
    """All stride >= C XOR passes of bitonic merge level ``k_lv`` over the
    int32 key tuple ``ks`` (each [NP]; NP % k_lv == 0, k_lv % (2C) == 0,
    C % 128 == 0).  Returns the new key list."""
    ks = list(ks)
    if ks[0].device.type == "cpu":
        return merge_level_plain(ks, k_lv, C)
    NP = _check_shape(ks, k_lv, C)
    dev = ks[0].device
    if not 1 <= len(ks) <= MAX_NK:
        raise ValueError(f"merge_level: {len(ks)} keys (1..{MAX_NK})")
    if k_lv & (k_lv - 1) or C & (C - 1):
        raise ValueError("merge_level: k_lv and C must be powers of two")
    for q, k in enumerate(ks):
        _cuda.check(k, f"merge_level.keys[{q}]", (I32,), 1, dev)
        if k.shape[0] != NP:
            raise ValueError(f"merge_level: key {q} has length {k.shape[0]}")
    buf = torch.stack(ks)  # the kernel sorts this copy in place
    out = list(buf.unbind(0))
    _cuda.launch("merge_level_i32", out, len(out), NP, k_lv, C)
    _cuda.COUNTS["merge_level"] += 1
    return out
