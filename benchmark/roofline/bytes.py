"""The least bytes a call of each hand-written kernel must move, from the
call's own arguments: each input byte it needs read once and each output
byte written once (``chip_smoke.py``'s counts, kept with the benchmark).
A gather needs only the table rows its indices name, so its count reads
the indices: ``gather_plan`` takes what the shapes say at the call, and
``gather_bytes`` counts the distinct rows later (it launches device work,
which must not fall inside a profiled stretch).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA's data sheet


def _distinct(x) -> int:
    import torch

    return int(torch.unique(x).numel())


def gather_cols(cols, idx, lens=None, rows: bool = False) -> int:
    """A column gather (``colgather.gather``): F columns of one table of
    segments laid end to end, at [K] (flat) or [B, K] (per-row) int32
    indices, clamped.  Each index read once, each int32 output once, and in
    each segment each distinct row once per tensor column: per batch row
    for a per-row segment, once in all for a shared one; nothing for a
    constant."""
    return gather_bytes(gather_plan(cols, idx, lens, rows), idx)


def gather_plan(cols, idx, lens=None, rows: bool = False) -> dict:
    """What a column gather's count needs of its columns, from their
    shapes alone: the segments' lengths, the indices' and columns'
    bytes, and for each segment the element sizes of its shared and its
    per-row tensor columns."""
    import torch

    cols = [c if isinstance(c, (list, tuple)) else (c,) for c in cols]
    nseg = len(cols[0])
    seg_lens = [None] * nseg if lens is None else [int(n) for n in lens]
    for col in cols:
        for s, t in enumerate(col):
            if isinstance(t, torch.Tensor) and seg_lens[s] is None:
                seg_lens[s] = t.shape[-1]
    shared, per_row = [0] * nseg, [0] * nseg
    for col in cols:
        for s, t in enumerate(col):
            if not isinstance(t, torch.Tensor):
                continue
            if rows and t.dim() == 2 and t.stride(0) != 0:
                per_row[s] += t.element_size()
            else:
                shared[s] += t.element_size()
    return dict(seg_lens=seg_lens, rows=rows, shared=shared,
                per_row=per_row, fixed=idx.numel() * 4 * (1 + len(cols)))


def gather_bytes(plan, idx) -> int:
    """A planned gather's bytes: the fixed part and each segment's
    distinct rows times its columns' element sizes."""
    import torch

    seg_lens = plan["seg_lens"]
    N = sum(seg_lens)
    ix = idx.clamp(0, N - 1).long()
    ends = torch.tensor(seg_lens, device=idx.device).cumsum(0)
    seg = torch.searchsorted(ends, ix, right=True)
    keys = (ix + torch.arange(ix.shape[0], device=ix.device)[:, None] * N
            if plan["rows"] else ix)
    total = plan["fixed"]
    for s in range(len(seg_lens)):
        m = seg == s
        if plan["per_row"][s]:
            total += plan["per_row"][s] * _distinct(keys[m])
        if plan["shared"][s]:
            total += plan["shared"][s] * _distinct(ix[m])
    return total


def gather_table(tables, idx, rows: bool = False) -> int:
    """A packed-table gather (``colgather.gather_table``): segment tables
    [Ns, F] (or [B, Ns, F] per row) laid end to end, all F fields; one
    launch per 16 fields, each reading the indices."""
    return gather_bytes(gather_table_plan(tables, idx, rows), idx)


def gather_table_plan(tables, idx, rows: bool = False) -> dict:
    F = tables[0].shape[-1]
    cols = [[t[..., f] for t in tables] for f in range(F)]
    plan = gather_plan(cols, idx, [t.shape[-2] for t in tables], rows)
    plan["fixed"] += (-(-F // 16) - 1) * idx.numel() * 4
    return plan


def pair_counts(a, b, na, nb) -> int:
    """Two int32 key vectors in, an [na, nb] int32 histogram out."""
    return a.numel() * 8 + na * nb * 4


def ring_assemble(old, rsrc, rslot, rval, keep) -> int:
    """The old ring read and the new one written; per slot its source,
    target slot, value (int32/f32) and keep flag (bool)."""
    return old.numel() * old.element_size() * 2 + rsrc.numel() * 13


def tracker_fold(min_aln_len, st, ref_en, mc, evt, st_w, rows_eff) -> int:
    """The [B, CL] tracker state read and written; three int32 streams
    over the rows that carry seeds; two int32 words a read."""
    return tracker_fold_fixed(st, rows_eff) + int(rows_eff.sum()) * 12


def tracker_fold_fixed(st, rows_eff) -> int:
    """``tracker_fold``'s bytes that its shapes give."""
    tb = sum(v.numel() * v.element_size() for v in st.values())
    return 2 * tb + rows_eff.numel() * 8


def sort_runs(keys, NP, W) -> int:
    """NK int32 key rows of N read, an [NK, NP] buffer written."""
    keys = list(keys)
    return len(keys) * (keys[0].numel() + NP) * 4


def merge_level(buf, k_lv, C) -> int:
    """The [NK, NP] buffer read and written in place."""
    return 2 * buf.numel() * 4
