"""Flat shared-table gather and pair count (port of
``uncalled_tpu.ops.flat_gather``).

Each function is a plain PyTorch version plus a hand-written CUDA kernel
(``csrc/flat_gather.cu``).  The wrapper runs the plain version for tensors
on the CPU and launches the kernel for tensors on the card, where it
raises on anything the kernel does not take; there is no fallback.

The TPU computed the gather as two one-hot MXU contractions and the pair
count as an int8 one-hot matmul; on the card both are direct.  The gather
is the column-descriptor gather of ``colgather``: ``flat_gather_cols``
reads fields where they lie (views, bools, segments and constants), and
``flat_gather_fields`` / ``flat_gather`` are its packed-table case (the F
strided columns of one [N, F] table).  The pair count is one cooperative
launch that zeroes its output, crosses a grid barrier and counts with one
atomic per run of equal cells among each thread's four keys.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import colgather as cg

I32, F32 = torch.int32, torch.float32
# threads a block of the pair-count launch (one block per SM at most;
# chip_smoke.py times 256, 512 and 1024)
PAIR_THREADS = 256


def flat_gather_fields_plain(tbl, idx):
    """``out[f, k] = tbl[clamp(idx[k], 0, N-1), f]`` -> [F, K]."""
    ix = idx.clamp(0, tbl.shape[0] - 1).to(torch.int64)
    return tbl.index_select(0, ix).T.contiguous()


def flat_gather_fields(tbl, idx):
    """Row gather from a flat [N, F] table (int32 or float32; floats move as
    their bits) at [K] int32 indices, clamped; fields-major [F, K] result,
    so ``out[f]`` is a contiguous field."""
    if tbl.device.type == "cpu":
        return flat_gather_fields_plain(tbl, idx)
    if tbl.dtype not in (I32, F32) or tbl.dim() != 2:
        raise TypeError(f"flat_gather: {tbl.dim()}-D {tbl.dtype} table "
                        "(2-D int32 or float32)")
    return cg.gather_table("flat_gather", [tbl], idx).view(tbl.dtype)


def flat_gather_cols_plain(cols, idx, lens=None):
    segs, dtypes, lens = cg.describe(cols, idx, rows=False, lens=lens)
    tbl = cg.pack_plain(segs, lens, idx.device)
    return cg.unpack(flat_gather_fields_plain(tbl, idx), dtypes)


def flat_gather_cols(cols, idx, lens=None):
    """Gather F <= 16 columns of one shared flat table at [K] int32
    indices (clamped) with one launch, reading each column where it lies:
    ``out[f][k] = col_f[clamp(idx[k], 0, N-1)]``.  A column is an [N]
    tensor of any strides (int32, float32 or bool) or a list of segments
    ([Ns] tensors or scalar constants, the same lengths in every column;
    see ``colgather``).  Returns the F gathered [K] columns, each in its
    column's dtype."""
    if idx.device.type == "cpu":
        return flat_gather_cols_plain(cols, idx, lens)
    return cg.unpack(*cg.gather("flat_gather", cols, idx, lens))


def flat_gather(tbl, idx):
    """``out[k(, f)] = tbl[clamp(idx[k])(, f)]`` for a flat [N] or [N, F]
    table; [K] or [K, F] result."""
    if tbl.dim() == 1:
        return flat_gather_fields(tbl[:, None], idx)[0]
    return flat_gather_fields(tbl, idx).T


def pair_counts_plain(a, b, na: int, nb: int):
    """``out[i, j] = #{c : a[c] == i and b[c] == j}``; keys outside
    [0, na) x [0, nb) are dropped."""
    ok = (a >= 0) & (a < na) & (b >= 0) & (b < nb)
    key = torch.where(ok, a.to(torch.int64) * nb + b, na * nb)
    out = torch.zeros(na * nb + 1, dtype=I32, device=a.device)
    out.index_add_(0, key, torch.ones_like(key, dtype=I32))
    return out[: na * nb].view(na, nb)


def pair_counts(a, b, na: int, nb: int):
    """Pair histogram of two flat int32 key vectors -> [na, nb] int32."""
    if a.device.type == "cpu":
        return pair_counts_plain(a, b, na, nb)
    _cuda.check(a, "pair_counts.a", (I32,), 1, a.device)
    _cuda.check(b, "pair_counts.b", (I32,), 1, a.device)
    if a.shape != b.shape:
        raise ValueError("pair_counts: a and b differ in shape")
    if not (0 <= na and 0 <= nb and na * nb < 2**31):
        raise ValueError(f"pair_counts: [{na}, {nb}] counters (na * nb must "
                         "be below 2^31)")
    # no fill here: the kernel zeroes out in the same launch
    out = torch.empty((na, nb), dtype=I32, device=a.device)
    _cuda.launch("pair_counts_i32", a, b, a.shape[0], na, nb, PAIR_THREADS,
                 out)
    _cuda.COUNTS["pair_counts"] += 1
    return out
