"""The shard-local row gather of a row-sharded table, and the idx axis it
answers on (the sharded engines, ``parallel/sharded.py``).

Port of the local half of ``uncalled_tpu.mapping.engine._shard_take``: each
rank of the idx axis holds one contiguous block of ``per`` rows of a big
FM table (``occ_rows``, ``sa`` or ``sa_samp``), answers the indices that
fall in its block and zeroes the rest; an ``all_reduce(SUM)`` over the idx
process group (:meth:`ShardContext.all_reduce`) combines the answers.
Every table is int32, so one owner's word plus zeros is exact in any order.

``shard_take`` runs the plain version for tensors on the CPU and launches
the hand-written kernel (``csrc/shard.cu``: a warp of 32 rows for the
6-word ``occ_rows``, one thread a row for the 1-word tables) for tensors on
the card, where it raises on anything the kernel does not take; there is
no fallback.
"""

from __future__ import annotations

import time

import torch

from . import _cuda

I32 = torch.int32
_I32_MAX = 2**31 - 1


class ShardContext:
    """The idx axis of a (dp, idx) mesh, as the row-sharded tables see it:
    the idx process group, its size and this rank's index in it (its block
    of a table of ``per`` local rows starts at global row ``rank * per``).
    It takes the place of the JAX index's ``shard_axis``.

    :meth:`all_reduce` sums over the group by ``torch.distributed``'s
    ``all_reduce``, on whatever backend the group runs; every table is
    int32, so the sums are exact and equal on every rank.

    ``calls`` counts the reductions and ``walk_steps`` the steps of the
    longest row of each sharded LF-walk; with ``timed`` set, ``seconds``
    sums the reductions' wall time between two device synchronisations (a
    measurement mode: the synchronisations cost time of their own)."""

    def __init__(self, group, rank: int, size: int = 1):
        self.group = group
        self.rank = int(rank)
        self.size = int(size)
        self.calls = 0
        self.walk_steps = 0
        self.seconds = 0.0
        self.timed = False

    @classmethod
    def of(cls, group) -> "ShardContext":
        """The context of this rank in ``group``."""
        import torch.distributed as dist

        return cls(group, dist.get_rank(group), dist.get_world_size(group))

    def all_reduce(self, t: torch.Tensor, host: bool = False):
        """Sum ``t`` over the idx group, in place; returns ``t``, or with
        ``host`` (``t``, a host copy of the sum) for a caller that tests
        the sum on the host."""
        import torch.distributed as dist

        if self.timed:
            _sync(t)
            t0 = time.perf_counter()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        h = t.cpu() if host else None
        self.calls += 1
        if self.timed:
            _sync(t)
            self.seconds += time.perf_counter() - t0
        return (t, h) if host else t


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def shard_take_plain(tbl, rows, lo: int):
    """``tbl[rows - lo]`` where ``lo <= rows < lo + per`` (``per`` =
    ``tbl.shape[0]``), zero rows elsewhere; ``rows`` int32 of any shape ->
    ``rows.shape + tbl.shape[1:]``."""
    per = tbl.shape[0]
    local = rows.to(torch.int64) - lo
    ok = (local >= 0) & (local < per)
    g = tbl.index_select(0, local.clamp(0, per - 1).reshape(-1)).reshape(
        rows.shape + tbl.shape[1:])
    m = ok.view(ok.shape + (1,) * (tbl.dim() - 1))
    return torch.where(m, g, torch.zeros((), dtype=g.dtype, device=g.device))


def shard_take(tbl, rows, lo: int):
    """The shard-local gather of :func:`shard_take_plain`, on the card one
    launch of ``csrc/shard.cu``; ``tbl`` is an int32 [per] or [per, F]
    block (F = 1 or 6, the widths of the sharded tables; an F = 6 block
    8-byte aligned), ``rows`` int32 of any shape."""
    if rows.device.type == "cpu":
        return shard_take_plain(tbl, rows, lo)
    dev = rows.device
    _cuda.check(rows, "shard_take.rows", (I32,), rows.dim(), dev)
    if tbl.dim() not in (1, 2):
        raise ValueError(f"shard_take: table is {tbl.dim()}-D, expected 1-D "
                         "or 2-D")
    _cuda.check(tbl, "shard_take.tbl", (I32,), tbl.dim(), dev)
    per = tbl.shape[0]
    F = tbl.shape[1] if tbl.dim() == 2 else 1
    if F not in (1, 6):
        raise ValueError(f"shard_take: rows of {F} words; the kernel takes "
                         "1 or 6")
    if F == 6 and tbl.storage_offset() % 2:
        raise ValueError("shard_take: a [per, 6] block must start 8-byte "
                         "aligned (three 8-byte words a row)")
    if not (0 <= lo and lo + per <= _I32_MAX
            and rows.numel() <= _I32_MAX):
        raise ValueError(f"shard_take: block [{lo}, {lo + per}) or "
                         f"{rows.numel()} rows out of the kernel's range")
    out = torch.empty(rows.shape + tbl.shape[1:], dtype=I32, device=dev)
    if rows.numel():
        _cuda.launch("shard_take_i32", tbl, rows, out, rows.numel(), F, lo,
                     per)
        _cuda.COUNTS["shard_take"] += 1
    return out
