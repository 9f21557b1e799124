"""The column descriptor behind every gather of the port
(``csrc/gather.cuh``): its checks, its plain version and its launch.

A gather reads F <= ``MAX_COLS`` columns that stay where they lie::

    out[f, b, k] = col_f[b, clamp(idx[b, k], 0, N-1)]

A column is one tensor or a list of 1 to ``MAX_SEGS`` segments laid end
to end; the segment lengths are shared by every column of the call and
sum to N.  A segment is a tensor of any strides (int32, float32 moved as
its bits, or bool) or a Python scalar, a constant of the column's dtype.
In the flat form (``rows=False``, one shared table, idx [K]) a tensor
segment is [Ns]; in the per-row form (idx [B, K]) it is [B, Ns], or [Ns]
(or a stride-0 ``expand``) for a segment every row shares.

The plain version materialises the packed int32 table the descriptor
describes -- ``torch.cat`` of the segments (constants by ``torch.full``),
``torch.stack`` of the columns -- which is what the call sites built
before the kernel read columns in place; the wrappers then take their
plain gather.  The kernel reads every segment through its pointer and
strides and copies nothing.
"""

from __future__ import annotations

import struct

import torch

from . import _cuda

I32, F32, BOOL = torch.int32, torch.float32, torch.bool
MAX_COLS, MAX_SEGS = 16, 5

# segment kinds of gather.cuh; a tensor segment's kind is its element
# size (1: bool, 4: 32 bits) unless it heads a 16-byte load
_CONST, _WORD, _VEC4 = 0, 4, 16
_SIZES = {I32: 4, F32: 4, BOOL: 1}
REC = 5  # meta entries per segment: pointer, batch and element stride
#          in bytes, kind, constant


def _const_bits(c, dtype) -> int:
    """The 32 bits a constant segment of a ``dtype`` column holds."""
    if isinstance(c, torch.Tensor):
        raise TypeError("gather: a constant segment is a Python scalar")
    if dtype == F32:
        return struct.unpack("<i", struct.pack("<f", float(c)))[0]
    if dtype == BOOL:
        return int(bool(c))
    c = int(c)
    if not -2**31 <= c < 2**31:
        raise ValueError(f"gather: constant {c} is not an int32")
    return c


def describe(cols, idx, rows: bool, lens=None):
    """Check ``cols`` against what the kernel takes and normalise them:
    returns (segs, dtypes, lens) with ``segs[f][s]`` a tensor or a
    constant's 32 bits.  ``lens`` gives the segment lengths where some
    segment is a constant in every column.  Raises on anything the kernel
    does not take, on the CPU as on the card.  It runs on the host before
    every launch, so it touches each tensor as few times as it can."""
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"gather: {len(cols)} columns, the kernel takes "
                         f"1 to {MAX_COLS}")
    cols = [c if isinstance(c, (list, tuple)) else (c,) for c in cols]
    nseg = len(cols[0])
    if not 1 <= nseg <= MAX_SEGS or any(len(c) != nseg for c in cols):
        raise ValueError(f"gather: every column needs the same 1 to "
                         f"{MAX_SEGS} segments, got {[len(c) for c in cols]}")
    if idx.dtype != I32 or idx.dim() != (2 if rows else 1):
        raise ValueError(f"gather: idx must be {2 if rows else 1}-D int32, "
                         f"got {idx.dim()}-D {idx.dtype}")
    B, dev = idx.shape[0], idx.device
    seg_lens = [None] * nseg if lens is None else [int(n) for n in lens]
    if len(seg_lens) != nseg:
        raise ValueError(f"gather: {len(seg_lens)} lengths for {nseg} "
                         "segments")
    segs, dtypes = [], []
    for f, col in enumerate(cols):
        dt = None
        for s, t in enumerate(col):
            if not isinstance(t, torch.Tensor):
                continue
            if dt is None:
                dt = t.dtype
            elif t.dtype != dt:
                raise TypeError(f"gather: column {f} needs one dtype over "
                                f"its tensor segments, got {dt} and "
                                f"{t.dtype}")
            if t.device != dev:
                raise ValueError(f"gather: column {f} is on {t.device}, idx "
                                 f"on {dev}")
            shape = t.shape
            if not (len(shape) == 1
                    or (rows and len(shape) == 2 and shape[0] == B)):
                raise ValueError(f"gather: column {f} segment {s} has shape "
                                 f"{tuple(shape)}")
            n = shape[-1]
            if seg_lens[s] is None:
                seg_lens[s] = n
            elif seg_lens[s] != n:
                raise ValueError(f"gather: segment {s} is {seg_lens[s]} "
                                 f"long, column {f}'s {n}")
        if dt is None:
            raise TypeError(f"gather: column {f} needs one dtype over its "
                            "tensor segments, got none")
        if dt not in _SIZES:
            raise TypeError(f"gather: column {f} is {dt} (int32, float32 "
                            "or bool)")
        dtypes.append(dt)
        segs.append([t if isinstance(t, torch.Tensor) else _const_bits(t, dt)
                     for t in col])
    if any(n is None for n in seg_lens):
        raise ValueError("gather: a segment that is constant in every "
                         "column needs lens")
    if sum(seg_lens) == 0:
        raise ValueError("gather: empty table")
    if sum(seg_lens) >= 2**31:
        raise ValueError("gather: table longer than int32 indices reach")
    return segs, dtypes, seg_lens


def pack_plain(segs, lens, device, B=None):
    """The packed int32 table the descriptor describes: [N, F], or
    [B, N, F] for the per-row form."""
    cols = []
    for col in segs:
        parts = []
        for t, n in zip(col, lens):
            shape = (n,) if B is None else (B, n)
            if isinstance(t, int):
                parts.append(torch.full(shape, t, dtype=I32, device=device))
                continue
            v = t.view(I32) if t.dtype == F32 else t.to(I32)
            parts.append(v[None].expand(shape) if v.dim() < len(shape)
                         else v)
        cols.append(torch.cat(parts, -1) if len(parts) > 1 else parts[0])
    return torch.stack(cols, -1)


def _meta(recs, lens, B: int, K: int):
    """The kernel's argument, the int64 meta array: F, nseg, B, K, the
    nseg + 1 bounds, then ``recs[s]`` for each segment s: ``REC`` entries
    per column (device pointer, 0 for a constant; batch and element
    stride in bytes; kind; constant)."""
    F, nseg = len(recs[0]) // REC, len(lens)
    meta = [F, nseg, B, K, 0]
    for n in lens:
        meta.append(meta[-1] + n)
    for r in recs:
        at = len(meta)
        meta += r
        # four side-by-side 32-bit fields of one 16-byte aligned row move
        # as one 16-byte load
        for f in range(0, F - 3, 4):
            q = at + REC * f
            ptr, bst, est, kind = meta[q: q + 4]
            if kind == _WORD and not (ptr | bst | est) % 16 and all(
                    meta[q + REC * j: q + REC * j + 4]
                    == [ptr + 4 * j, bst, est, _WORD] for j in (1, 2, 3)):
                meta[q + 3] = _VEC4
    return meta


def encode(segs, lens, B: int, K: int):
    """The meta array of a described column list (``describe``)."""
    recs = []
    for s in range(len(lens)):
        r = []
        for c in segs:
            t = c[s]
            if isinstance(t, int):
                r += (0, 0, 0, _CONST, t)
                continue
            es = _SIZES[t.dtype]
            st = t.stride()
            r += (t.data_ptr(), st[0] * es if len(st) == 2 else 0,
                  st[-1] * es, es, 0)
        recs.append(r)
    return _meta(recs, lens, B, K)


def _launch(kernel: str, meta, idx, out) -> None:
    """One launch of ``kernel`` ("flat_gather": idx [K], or "row_gather":
    idx [B, K]) into ``out`` [F, *idx.shape] int32, counted in
    ``_cuda.COUNTS[kernel]``."""
    idx2d = idx.contiguous() if idx.dim() == 2 else idx.contiguous()[None]
    if idx2d.shape[0] > 65535:
        raise ValueError(f"gather: {idx2d.shape[0]} batch rows (at most "
                         "65535)")
    _cuda.launch(kernel + "_cols_i32", meta, idx2d, out)
    _cuda.COUNTS[kernel] += 1


def gather(kernel: str, cols, idx, lens=None, out=None):
    """One launch of ``kernel`` on ``cols``: the [F, *idx.shape] int32
    result (written into ``out`` when given) and the columns' dtypes."""
    segs, dtypes, lens = describe(cols, idx, kernel == "row_gather", lens)
    shape = (len(segs),) + tuple(idx.shape)
    if out is None:
        out = torch.empty(shape, dtype=I32, device=idx.device)
    elif out.dtype != I32 or out.shape != shape or not out.is_contiguous():
        raise ValueError(f"gather: out {out.dtype} {tuple(out.shape)}, "
                         f"expected contiguous int32 {shape}")
    B, K = (idx.shape if idx.dim() == 2 else (1, idx.shape[0]))
    _launch(kernel, encode(segs, lens, B, K), idx, out)
    return out, dtypes


def gather_table(kernel: str, tables, idx):
    """The gather of a table given as segment tables laid end to end
    along N, each [Ns, F] (shared) or, for "row_gather", [B, Ns, F] (a
    stride-0 batch dim is shared too): the [F, *idx.shape] int32 result,
    one launch per ``MAX_COLS`` fields.  Field f of a table is its strided
    view ``t[..., f]``; the descriptor is built straight from the tables'
    strides, without a view per field (it runs before every launch of the
    packed-table wrappers)."""
    rows = kernel == "row_gather"
    F, dt = tables[0].shape[-1], tables[0].dtype
    es = _SIZES.get(dt)
    if es is None:
        raise TypeError(f"gather: {dt} table (int32, float32 or bool)")
    if idx.dtype != I32 or idx.dim() != (2 if rows else 1):
        raise ValueError(f"gather: idx must be {2 if rows else 1}-D int32, "
                         f"got {idx.dim()}-D {idx.dtype}")
    B, K = (idx.shape if rows else (1, idx.shape[0]))
    lens, segs = [], []
    for t in tables:
        per_row = rows and t.dim() == 3
        if (t.dtype != dt or t.device != idx.device or t.shape[-1] != F
                or t.dim() != 2 + per_row or (per_row and t.shape[0] != B)):
            raise ValueError(f"gather: segment table {t.dtype} "
                             f"{tuple(t.shape)} on {t.device} does not fit "
                             f"{dt} [.., F={F}] at idx {tuple(idx.shape)}")
        st = t.stride()
        lens.append(t.shape[-2])
        segs.append((t.data_ptr(), st[0] * es if per_row else 0, st[-2] * es,
                     st[-1] * es))
    if not 0 < sum(lens) < 2**31 or not 1 <= len(lens) <= MAX_SEGS:
        raise ValueError(f"gather: segment lengths {lens}")
    out = torch.empty((F,) + tuple(idx.shape), dtype=I32, device=idx.device)
    for f0 in range(0, F, MAX_COLS):
        f1 = min(F, f0 + MAX_COLS)
        recs = [[x for f in range(f0, f1)
                 for x in (ptr + f * fs, bst, est, es, 0)]
                for ptr, bst, est, fs in segs]
        _launch(kernel, _meta(recs, lens, B, K), idx, out[f0:f1])
    return out


def unpack(g, dtypes):
    """The columns of an int32 [F, ...] result in their own dtypes (f32 as
    its bits, bool as ``!= 0``)."""
    return [v.view(F32) if dt == F32 else (v != 0 if dt == BOOL else v)
            for v, dt in zip(g, dtypes)]
