"""SA lookup from the 1/intv row sample by LF-walk (port of
``uncalled_tpu.mapping.engine._sa_lookup``).

With ``sampled_sa`` the index keeps ``sa_samp = sa_full[::intv]`` on the
device instead of the full SA (0.125 byte per FM row at intv = 32 against
4).  Row ``r`` then steps ``LF(r) = L2[c] + occ(c, r)`` (``LF(primary) =
0``) until ``r % intv == 0`` and reads ``sa_samp[r / intv] + steps``, as
libbwa's ``bwt_sa`` does.  The walk's length is not bounded by intv: the SA
is sampled by row, not by text position (the example index's longest walk
is 201 steps at intv = 32).  The JAX function keeps ``sa_samp[0] = n``, so a
walk that passes the primary row (SA 0) ends at ``SA + n + 1``; both
versions here compute the JAX function bit for bit, and :func:`walk_model`
says from the full SA which rows do so.

``sa_lookup`` runs the plain version for tensors on the CPU and launches
the hand-written kernel (``csrc/sa_lookup.cu``: one thread walks one row
in registers, the whole walk in one launch) for tensors on the card, where
it raises on anything the kernel does not take; there is no fallback.

Under the sharded engines (``idx["shard"]``: ``occ_rows`` and ``sa_samp``
row-sharded over the idx ranks) the walk runs in rounds:
:func:`sa_walk_step` (the ``sa_walk_step`` kernel on the card) walks each
live row on the rank that owns its bucket row, for as long as the row stays
live and in that rank's block, and gives (row, steps) there and zeros on
the other ranks; a sum over idx combines them, and the rounds go on while
any row is live; the last read is ``sa_samp`` through the sharded row
gather.  Within a step the base read and ``_occ``'s row are the same
bucket row for r != primary, and LF(primary) = 0, so one rank computes a
step alone, and one collective a hand-over between blocks gives the values
of the JAX walk under ``shard_map``, which spends two a step.  Every rank
of an idx group holds the same rows, so their round counts agree.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda

I32 = torch.int32


def sa_lookup_plain(idx, rows, intv: int):
    """SA values of FM rows ``rows`` (int32, already clamped to [0, n]) by
    LF-walk on ``idx["sa_samp"]``; loops until every row is resolved."""
    from ..mapping.engine import _occ, _u32

    n, primary = idx["n"], idx["primary"]
    L2 = idx["L2"][:4]
    r = rows.to(I32)
    steps = torch.zeros_like(r)
    while True:
        live = (r % intv) != 0
        if not bool(live.any()):
            break
        # base at bwt index j = r - (r > primary); MSB-first 2-bit packing
        # inside the interleaved bucket words (the layout of _occ)
        j = (r - (r > primary).to(I32)).clamp(min=0)
        row = idx["occ_rows"].index_select(0, (j >> 5).reshape(-1)).reshape(
            j.shape + (6,))
        pos = j & 31
        word = torch.where(pos < 16, row[..., 4], row[..., 5])
        sh = ((15 - (pos & 15)) * 2).to(torch.int64)
        base = ((_u32(word) >> sh) & 3).to(I32)
        lf = L2.index_select(0, base.reshape(-1)).reshape(base.shape) + _occ(
            idx, r, base)
        lf = torch.where(r == primary, 0, lf)
        r = torch.where(live, lf, r)
        steps = steps + live.to(I32)
    samp = idx["sa_samp"].index_select(
        0, torch.div(r, intv, rounding_mode="floor").reshape(-1))
    return samp.reshape(r.shape) + steps


def sa_lookup(idx, rows, intv: int):
    """SA values of FM rows ``rows`` ([*] int32 in [0, n]) from the 1/intv
    sample ``idx["sa_samp"]``, bit for bit the JAX ``_sa_lookup``."""
    if idx.get("shard") is not None:
        return _sa_lookup_sharded(idx, rows, intv)
    if rows.device.type == "cpu":
        return sa_lookup_plain(idx, rows, intv)
    dev = rows.device
    occ, samp, L2 = idx["occ_rows"], idx["sa_samp"], idx["L2"]
    n, primary = int(idx["n"]), int(idx["primary"])
    _cuda.check(rows, "sa_lookup.rows", (I32,), rows.dim(), dev)
    _cuda.check(occ, "sa_lookup.occ_rows", (I32,), 2, dev)
    _cuda.check(samp, "sa_lookup.sa_samp", (I32,), 1, dev)
    _cuda.check(L2, "sa_lookup.L2", (I32,), 1, dev)
    if intv < 1:
        raise ValueError(f"sa_lookup: intv {intv}")
    # every load the walk can make lies inside the tables (the kernel's
    # bucket row index r - (r >= primary) stays in [0, n - 1])
    if (occ.shape[1] != 6 or occ.shape[0] * 32 < n or L2.shape[0] < 5
            or samp.shape[0] <= n // intv or occ.data_ptr() % 8
            or not 1 <= primary <= n):
        raise ValueError(
            f"sa_lookup: tables occ_rows {tuple(occ.shape)}, sa_samp "
            f"{tuple(samp.shape)}, L2 {tuple(L2.shape)}, primary {primary} "
            f"do not cover n={n} at intv={intv}")
    out = torch.empty_like(rows)
    if rows.numel():
        _cuda.launch("sa_lookup_i32", occ, samp, L2, rows, out, rows.numel(),
                     n, primary, intv)
        _cuda.COUNTS["sa_lookup"] += 1
    return out


def _sa_lookup_sharded(idx, rows, intv: int):
    """The LF-walk over row-sharded ``occ_rows`` and ``sa_samp``: rounds of
    one :func:`sa_walk_step` and one sum over idx, until every row is
    resolved."""
    from ..mapping.engine import _shard_take

    sh = idx["shard"]
    occ = idx["occ_rows"]
    lo = sh.rank * occ.shape[0]
    r = rows.to(I32).contiguous()
    # the exit test and the step counts run on the host copy each sum
    # leaves (no device sync of their own)
    r_host = r.cpu()
    steps = torch.zeros_like(r_host)
    while bool(((r_host % intv) != 0).any()):
        part, host = sh.all_reduce(sa_walk_step(
            occ, idx["L2"], r, idx["n"], idx["primary"], intv, lo),
            host=True)
        r, r_host = part[0], host[0]
        steps += host[1]
    if steps.numel():
        sh.walk_steps += int(steps.max())
    return _shard_take(idx, "sa_samp", torch.div(
        r, intv, rounding_mode="floor")) + steps.to(r.device)


def _owned(r, primary: int, lo: int, per: int):
    """Rows of the block [lo, lo + per) of bucket rows: r's bucket row
    (j = r - (r > primary)) lies in it; the primary row is block 0's."""
    j = (r - (r > primary).to(I32)).clamp(min=0)
    b = (j >> 5) - lo
    return torch.where(r == primary, lo == 0, (b >= 0) & (b < per)), b


def _lf_local(occ, L2, r, n: int, primary: int, lo: int):
    """LF(r) from the block ``occ`` (global bucket rows from ``lo``) for rows
    the block owns; LF(primary) = 0."""
    from ..mapping.engine import _occ_count, _u32

    per = occ.shape[0]
    j = (r - (r > primary).to(I32)).clamp(min=0)
    b = ((j >> 5) - lo).clamp(0, per - 1)
    row = occ.index_select(0, b.reshape(-1)).reshape(j.shape + (6,))
    pos = j & 31
    word = torch.where(pos < 16, row[..., 4], row[..., 5])
    sh = ((15 - (pos & 15)) * 2).to(torch.int64)
    base = ((_u32(word) >> sh) & 3).to(I32)
    # for r != primary, _occ's index kk = r - (r >= primary) is j
    lf = L2[:4].index_select(0, base.reshape(-1)).reshape(base.shape) + \
        _occ_count({"n": n, "L2": L2}, r, base, j, row)
    return torch.where(r == primary, 0, lf)


def sa_walk_step_plain(occ, L2, r, n: int, primary: int, intv: int,
                       lo: int):
    """The walk as far as the block ``occ`` ([per, 6], global bucket rows
    [lo, lo + per)) of a row-sharded ``occ_rows`` reaches: [2, *r.shape]
    of (row, steps).  A live row the block owns (its bucket row lies in
    the block; the primary row is block 0's) steps LF while it stays live
    and owned: (walked row, steps taken).  A resolved row (r % intv == 0)
    is (r, 0) on block 0.  Every other row is (0, 0).  The sum over the
    blocks is the JAX walk up to each row's first row in another block."""
    per = occ.shape[0]
    live = (r % intv) != 0
    own0, _ = _owned(r, primary, lo, per)
    active = live & own0
    cur, steps = r.clone(), torch.zeros_like(r)
    while bool(active.any()):
        cur = torch.where(active, _lf_local(occ, L2, cur, n, primary, lo),
                          cur)
        steps += active.to(I32)
        own, _ = _owned(cur, primary, lo, per)
        active = active & ((cur % intv) != 0) & own
    keep = (steps > 0) | (~live & (lo == 0))
    return torch.stack([torch.where(keep, cur, 0), steps])


def sa_walk_step(occ, L2, r, n: int, primary: int, intv: int, lo: int):
    """:func:`sa_walk_step_plain`, on the card one launch of
    ``csrc/sa_lookup.cu``'s ``sa_walk_step`` kernel; ``r`` int32 of any
    shape, each row in [0, n]."""
    if r.device.type == "cpu":
        return sa_walk_step_plain(occ, L2, r, n, primary, intv, lo)
    dev = r.device
    _cuda.check(r, "sa_walk_step.r", (I32,), r.dim(), dev)
    _cuda.check(occ, "sa_walk_step.occ_rows", (I32,), 2, dev)
    _cuda.check(L2, "sa_walk_step.L2", (I32,), 1, dev)
    if intv < 1:
        raise ValueError(f"sa_walk_step: intv {intv}")
    if occ.shape[1] != 6 or L2.shape[0] < 5 or occ.data_ptr() % 8 or lo < 0:
        raise ValueError(
            f"sa_walk_step: block occ_rows {tuple(occ.shape)} at bucket row "
            f"{lo}, L2 {tuple(L2.shape)}")
    out = torch.empty((2,) + tuple(r.shape), dtype=I32, device=dev)
    if r.numel():
        _cuda.launch("sa_walk_step_i32", occ, L2, r, out, r.numel(), n,
                     primary, intv, lo, occ.shape[0])
        _cuda.COUNTS["sa_walk_step"] += 1
    return out


def walk_model(sa_full, intv: int):
    """From the full SA (numpy [n + 1]): each row's walk length and the
    value the lookup gives it (``sa_full`` where the walk meets a sampled
    row first; ``sa_full + n + 1`` where it passes the primary row).  The
    walk from row r visits SA values ``sa_full[r], sa_full[r] - 1, ...``
    until one of them sits on a sampled row; position 0 (the primary row)
    steps on to row 0, whose sampled value is n."""
    sa = np.asarray(sa_full, dtype=np.int64)
    n1 = sa.shape[0]
    sampled = np.zeros(n1, dtype=bool)
    sampled[sa[::intv]] = True
    pos = np.arange(n1, dtype=np.int64)
    prev = np.maximum.accumulate(np.where(sampled, pos, -1))
    steps_at = np.where(prev >= 0, pos - prev, pos + 1)
    steps = steps_at[sa]
    value = sa + n1 * (prev[sa] < 0)
    return steps.astype(np.int32), value
