"""Per-row and shared-table gathers (port of ``uncalled_tpu.ops.mxu_gather``).

``row_gather``: ``out[b, k(, f)] = tbl[b, clamp(idx[b, k], 0, N-1)(, f)]``;
``shared_gather``: ``out[b, k(, f)] = tbl[clamp(idx[b, k], 0, N-1)(, f)]``;
``row_gather_fields``: ``row_gather`` of an int32 [B, N, F] table as the
list of its F fields, each [B, K] (fields-major is the kernel's layout).
Tables are f32, int32 or bool; f32 moves as its raw 32-bit pattern, so NaN
payloads and -0.0 survive.

Each function is a plain PyTorch version plus the hand-written CUDA kernel
``csrc/row_gather.cu``.  The wrapper runs the plain version for tensors on
the CPU and launches the kernel for tensors on the card, for every table
size N: the JAX package's route to XLA's take above N = 8192 is a TPU cost
rule for the same function, and the card has no VMEM bound that needs it.
"""

from __future__ import annotations

import torch

from . import _cuda

I32, F32 = torch.int32, torch.float32


def row_gather_plain(tbl, idx):
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


def _to_i32(t):
    if t.dtype == F32:
        return t.view(I32)
    if t.dtype == torch.bool:
        return t.to(I32)
    if t.dtype == I32:
        return t
    raise TypeError(f"row_gather: unsupported dtype {t.dtype} "
                    "(float32/int32/bool)")


def _from_i32(t, dtype):
    if dtype == F32:
        return t.view(F32)
    if dtype == torch.bool:
        return t != 0
    return t


def _gather_i32(tbl, idx, shared: bool):
    """Kernel launch: tbl [B, N, F] (or [N, F] when ``shared``) int32,
    idx [B, K] int32 -> [F, B, K] int32."""
    dev = tbl.device
    _cuda.check(tbl, "row_gather.tbl", (I32,), 2 if shared else 3, dev)
    _cuda.check(idx, "row_gather.idx", (I32,), 2, dev)
    B, K = idx.shape
    N, F = tbl.shape[-2:]
    if N == 0:
        raise ValueError("row_gather: empty table")
    if not shared and tbl.shape[0] != B:
        raise ValueError(f"row_gather: table batch {tbl.shape[0]} != {B}")
    out = torch.empty((F, B, K), dtype=I32, device=dev)
    _cuda.launch("row_gather_i32", tbl, int(shared), N, F, idx, B, K, out)
    _cuda.COUNTS["row_gather"] += 1
    return out


def row_gather(tbl, idx):
    """Per-row gather from tbl [B, N] or [B, N, F] at idx [B, K] int32
    (clamped) -> [B, K] or [B, K, F], the table's dtype."""
    if tbl.device.type == "cpu":
        return row_gather_plain(tbl, idx)
    squeeze = tbl.dim() == 2
    t3 = tbl[:, :, None] if squeeze else tbl
    out = _from_i32(
        _gather_i32(_to_i32(t3).contiguous(), idx.contiguous(), False),
        tbl.dtype,
    )
    return out[0] if squeeze else out.permute(1, 2, 0)


def shared_gather(tbl, idx):
    """Shared-table gather from tbl [N] or [N, F] at idx [B, K] int32
    (clamped) -> [B, K] or [B, K, F], the table's dtype."""
    if tbl.device.type == "cpu":
        return shared_gather_plain(tbl, idx)
    squeeze = tbl.dim() == 1
    t2 = tbl[:, None] if squeeze else tbl
    out = _from_i32(
        _gather_i32(_to_i32(t2).contiguous(), idx.contiguous(), True),
        tbl.dtype,
    )
    return out[0] if squeeze else out.permute(1, 2, 0)


def row_gather_fields(tbl, idx):
    """Per-row gather from an int32 [B, N, F] table at idx [B, K] int32
    (clamped) -> list of F int32 [B, K] fields."""
    if tbl.device.type == "cpu":
        return row_gather_fields_plain(tbl, idx)
    return list(_gather_i32(tbl.contiguous(), idx.contiguous(), False))
