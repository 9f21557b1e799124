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
    # every load the walk can make lies inside the tables
    if (occ.shape[1] != 6 or occ.shape[0] * 32 < n or L2.shape[0] < 5
            or samp.shape[0] <= n // intv or occ.data_ptr() % 8):
        raise ValueError(
            f"sa_lookup: tables occ_rows {tuple(occ.shape)}, sa_samp "
            f"{tuple(samp.shape)}, L2 {tuple(L2.shape)} do not cover "
            f"n={n} at intv={intv}")
    out = torch.empty_like(rows)
    if rows.numel():
        _cuda.launch("sa_lookup_i32", occ, samp, L2, rows, out, rows.numel(),
                     n, primary, intv)
        _cuda.COUNTS["sa_lookup"] += 1
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
