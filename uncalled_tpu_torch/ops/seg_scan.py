"""The segmented running max of both steps' sources phase.

``out[..., i] = max(vals[..., j] for j <= i with seg_id[..., j] ==
seg_id[..., i])`` along the last dimension of a non-decreasing int32
``seg_id`` (each row of a 2-D input on its own) and int32 ``vals``: the
end of each k-mer run's reach (``run_end``) in ``_pool_event_step`` and
``_event_step``.  It stands for the JAX steps' ``associative_scan`` of
``_segmax`` (``uncalled_tpu.mapping.pooled._seg_running_max`` and the
classic step's scan).

Pairs ``(s, m)`` compose by ``_segmax``: ``(sa, ma) o (sb, mb) = (sb, sa
== sb ? max(ma, mb) : mb)``, associative on non-decreasing ``s``, with
``(any, INT32_MIN)`` its identity on the left.  :func:`seg_running_max_plain`
composes them as the kernel does: an inclusive scan of each TILE-wide tile,
each tile's carry in the fold of the row's earlier tiles' aggregates.
:func:`seg_running_max` runs it for CPU tensors and launches the
hand-written kernel (``csrc/seg_scan.cu``) for CUDA ones, where it raises on
anything the kernel does not take; there is no fallback.
"""

from __future__ import annotations

import torch

from . import _cuda

I32 = torch.int32
NEG = -(2**31)
_I32_MAX = 2**31 - 1
# the kernel's tile: 256 threads, 8 consecutive elements each
TILE = 256 * 8
# the kernel's grid has one block row a row, at most gridDim.y's limit
_ROWS_MAX = 65535


def _segmax(sa, ma, sb, mb):
    """``(sa, ma) o (sb, mb)`` elementwise; the seg of the result is sb."""
    return torch.where(sa == sb, torch.maximum(ma, mb), mb)


def _scan(s, m):
    """Inclusive scan of the pairs along the last dimension (log steps:
    position i takes ``(s, m)[i - d] o (s, m)[i]`` for d = 1, 2, 4, ...)."""
    d = 1
    while d < m.shape[-1]:
        m = torch.cat([m[..., :d], _segmax(s[..., :-d], m[..., :-d],
                                           s[..., d:], m[..., d:])], -1)
        d *= 2
    return m


def seg_running_max_plain(seg_id, vals):
    """The running max along the last dimension, by tiles: each tile's
    inclusive scan, then each tile's carry in (the exclusive scan of the
    row's tile aggregates) composed on its left."""
    shape = vals.shape
    n = shape[-1]
    rows = vals.numel() // max(n, 1)
    if vals.numel() == 0:
        return vals.clone()
    w = min(TILE, n)  # one tile of the row's width below a whole tile
    tiles = -(-n // w)
    pad = tiles * w - n
    s = seg_id.reshape(rows, n)
    m = vals.reshape(rows, n)
    if pad:  # past a row's end: (INT32_MAX, INT32_MIN), seen by no output
        s = torch.cat([s, s.new_full((rows, pad), _I32_MAX)], 1)
        m = torch.cat([m, m.new_full((rows, pad), NEG)], 1)
    s = s.reshape(rows, tiles, w)
    m = _scan(s, m.reshape(rows, tiles, w))
    # tile t's carry in: the row's tiles before it, the identity for t = 0
    agg_s, agg_m = s[:, :, -1], m[:, :, -1]
    c_m = _scan(agg_s, agg_m)
    c_s = torch.cat([agg_s.new_zeros((rows, 1)), agg_s[:, :-1]], 1)
    c_m = torch.cat([c_m.new_full((rows, 1), NEG), c_m[:, :-1]], 1)
    out = _segmax(c_s[:, :, None], c_m[:, :, None], s, m)
    return out.reshape(rows, tiles * w)[:, :n].reshape(shape)


def seg_running_max(seg_id, vals):
    """The segmented running max of int32 ``seg_id`` and ``vals`` (same
    shape, 1-D or 2-D) along the last dimension; on the card the two
    launches of ``csrc/seg_scan.cu`` (the tiles' aggregates, then the
    scan), on the current stream."""
    if vals.device.type == "cpu":
        return seg_running_max_plain(seg_id, vals)
    dev = vals.device
    _cuda.check(vals, "seg_running_max.vals", (I32,), vals.dim(), dev)
    _cuda.check(seg_id, "seg_running_max.seg_id", (I32,), vals.dim(), dev)
    if vals.dim() not in (1, 2) or seg_id.shape != vals.shape:
        raise ValueError(f"seg_running_max: seg_id {tuple(seg_id.shape)} "
                         f"and vals {tuple(vals.shape)}: expected one 1-D "
                         "or 2-D shape")
    n = vals.shape[-1]
    rows = vals.numel() // max(n, 1)
    if n > _I32_MAX - TILE or rows > _ROWS_MAX:
        raise ValueError(f"seg_running_max: {rows} rows of {n} elements, "
                         f"past the kernel's int32 offsets or {_ROWS_MAX} "
                         "rows")
    out = torch.empty_like(vals)
    if vals.numel():
        # the tiles' aggregates, (seg, max) pairs
        scratch = torch.empty(2 * rows * -(-n // TILE), dtype=I32, device=dev)
        _cuda.launch("seg_running_max_i32", seg_id, vals, out, scratch, rows,
                     n)
        _cuda.COUNTS["seg_running_max"] += 1
    return out
