"""Per-row and shared-table gathers (port of ``uncalled_tpu.ops.mxu_gather``).

``row_gather``: ``out[b, k(, f)] = tbl[b, clamp(idx[b, k], 0, N-1)(, f)]``;
``shared_gather``: ``out[b, k(, f)] = tbl[clamp(idx[b, k], 0, N-1)(, f)]``;
``row_gather_fields``: ``row_gather`` of an int32 [B, N, F] table as the
list of its F fields, each [B, K] (fields-major is the kernel's layout).
Tables are f32, int32 or bool; f32 moves as its raw 32-bit pattern, so NaN
payloads and -0.0 survive.

``row_gather_cols``: the column-descriptor form (``colgather``): F <= 16
columns read where they lie (views, bools, shared and per-row segments,
constants); the table forms above are its packed-table case.

Each function is a plain PyTorch version plus the hand-written CUDA kernel
``csrc/row_gather.cu``.  The wrapper runs the plain version for tensors on
the CPU and launches the kernel for tensors on the card, for every table
size N: the JAX package's route to XLA's take above N = 8192 is a TPU cost
rule for the same function, and the card has no VMEM bound that needs it.
"""

from __future__ import annotations

import torch

from . import colgather as cg

I32, F32 = torch.int32, torch.float32


def row_gather_plain(tbl, idx):
    if isinstance(tbl, (list, tuple)):  # segment tables, end to end
        tbl = torch.cat(tbl, 1) if len(tbl) > 1 else tbl[0]
    ix = idx.clamp(0, tbl.shape[1] - 1).to(torch.int64)
    if tbl.dim() == 3:
        ix = ix[:, :, None].expand(-1, -1, tbl.shape[2])
    return torch.gather(tbl, 1, ix)


def shared_gather_plain(tbl, idx):
    ix = idx.clamp(0, tbl.shape[0] - 1).to(torch.int64)
    return tbl.index_select(0, ix.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(tbl.shape[1:])
    )


def row_gather_fields_plain(tbl, idx):
    g = row_gather_plain(tbl, idx)
    return [g[:, :, f] for f in range(tbl.shape[2])]


def row_gather_cols_plain(cols, idx, lens=None):
    segs, dtypes, lens = cg.describe(cols, idx, rows=True, lens=lens)
    tbl = cg.pack_plain(segs, lens, idx.device, B=idx.shape[0])
    return cg.unpack(row_gather_plain(tbl, idx).permute(2, 0, 1), dtypes)


def _from_i32(t, dtype):
    if dtype == F32:
        return t.view(F32)
    if dtype == torch.bool:
        return t != 0
    return t


def row_gather(tbl, idx):
    """Per-row gather from tbl [B, N] or [B, N, F] at idx [B, K] int32
    (clamped) -> [B, K] or [B, K, F], the table's dtype.  ``tbl`` may also
    be a list of segment tables laid end to end along N, each [B, Ns(, F)]
    (a stride-0 ``expand`` of a shared table reads it once for every row):
    the kernel reads them where they lie, the plain version concatenates
    them."""
    segs = list(tbl) if isinstance(tbl, (list, tuple)) else [tbl]
    if segs[0].device.type == "cpu":
        return row_gather_plain(tbl, idx)
    squeeze = segs[0].dim() == 2
    if any(t.dim() != segs[0].dim() or t.shape[0] != idx.shape[0]
           for t in segs):
        raise ValueError("row_gather: every segment table must be "
                         "[B, Ns] or [B, Ns, F] with idx's B")
    out = cg.gather_table(
        "row_gather", [t[:, :, None] if squeeze else t for t in segs], idx)
    out = _from_i32(out, segs[0].dtype)
    return out[0] if squeeze else out.permute(1, 2, 0)


def shared_gather(tbl, idx):
    """Shared-table gather from tbl [N] or [N, F] at idx [B, K] int32
    (clamped) -> [B, K] or [B, K, F], the table's dtype."""
    if tbl.device.type == "cpu":
        return shared_gather_plain(tbl, idx)
    squeeze = tbl.dim() == 1
    out = _from_i32(cg.gather_table(
        "row_gather", [tbl[:, None] if squeeze else tbl], idx), tbl.dtype)
    return out[0] if squeeze else out.permute(1, 2, 0)


def row_gather_fields(tbl, idx):
    """Per-row gather from an int32 [B, N, F] table at idx [B, K] int32
    (clamped) -> list of F int32 [B, K] fields."""
    if tbl.device.type == "cpu":
        return row_gather_fields_plain(tbl, idx)
    if tbl.dtype != I32:
        raise TypeError(f"row_gather_fields: {tbl.dtype} table (int32)")
    return list(cg.gather_table("row_gather", [tbl], idx))


def row_gather_cols(cols, idx, lens=None):
    """Per-row gather of F <= 16 columns at idx [B, K] int32 (clamped) with
    one launch, reading each column where it lies:
    ``out[f][b, k] = col_f[b, clamp(idx[b, k], 0, N-1)]``.  A column is a
    [B, N] tensor of any strides (int32, float32 or bool) or a list of
    segments ([B, Ns] tensors, [Ns] tensors shared by every row, or scalar
    constants; the same lengths in every column; see ``colgather``).
    Returns the F gathered [B, K] columns, each in its column's dtype."""
    if idx.device.type == "cpu":
        return row_gather_cols_plain(cols, idx, lens)
    return cg.unpack(*cg.gather("row_gather", cols, idx, lens))
