"""The seed-tracker folds (port of ``uncalled_tpu.ops.tracker_kernel``).

Each read's seed rows fold in order into the read's [CL] cluster table:
``SeedTracker::add_seed`` (seed_tracker.cpp:157-232) with
``SeedCluster::update`` (:56-73), the zombie quirk, insert-or-evict, the
f32 ``len_sum`` in the reference's operation order and the best-cluster
``mm_*`` snapshot.  Two forms of the same fold:

- ``tracker_run_compact`` (the pooled step): read b's rows are
  ``rr_*[st_w[b] : st_w[b] + rows_eff[b]]`` of compact [RT] streams;
- ``tracker_run`` (the classic step): read b's rows are ``[b, r]`` of
  [B, R] streams for ``r < min(rows_r[b], R)``, each gated by ``row_ok``.

The plain versions are the row-by-row ``engine._tracker_add`` fold as the
JAX steps run it without the kernel: every read steps through the batch's
maximum row count, rows past its own count gated off.  The CUDA kernels
(``csrc/tracker_kernel.cu``, one per-row update shared by both) fold each
read in its own block over its own rows only; a gated-off row changes
nothing (it maps ``len_sum`` to ``((x + 0) + 0) - 0``, which is ``x`` for
every value the fold produces: it never makes -0.0).
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ..mapping.engine import TRACKER_KEYS, _tracker_add
from . import _cuda

I32, F32, U8 = torch.int32, torch.float32, torch.bool

_TABLES = (
    "cl_valid", "cl_count", "cl_ref_st", "cl_r1", "cl_r2e",
    "cl_evt_st", "cl_evt_en", "cl_total",
)
_SCALARS = (
    "len_sum", "n_cl", "mm_len", "mm_ref_st", "mm_r1", "mm_r2e",
    "mm_evt_st", "mm_evt_en", "ovf", "ovf_why",
)
_DTYPE = {"cl_valid": U8, "cl_count": U8, "len_sum": F32, "ovf": U8}


def _check_state(st, dev):
    """Raise unless the tracker state is what the kernels take; (B, CL)."""
    B, CL = st["cl_valid"].shape
    for k in _TABLES:
        _cuda.check(st[k], k, (_DTYPE.get(k, I32),), 2, dev)
        if tuple(st[k].shape) != (B, CL):
            raise ValueError(f"tracker.{k}: shape {tuple(st[k].shape)}")
    for k in _SCALARS:
        _cuda.check(st[k], k, (_DTYPE.get(k, I32),), 1, dev)
        if st[k].shape[0] != B:
            raise ValueError(f"tracker.{k}: length {st[k].shape[0]} != {B}")
    return B, CL


def tracker_run_compact_plain(min_aln_len, st, rr_ref_en, rr_mc, rr_evt,
                              st_w, rows_eff):
    p = SimpleNamespace(min_aln_len=int(min_aln_len))
    RT = rr_ref_en.shape[0]
    n = int(rows_eff.max()) if rows_eff.numel() else 0
    st = {k: st[k] for k in TRACKER_KEYS}
    for r in range(n):
        gi = (st_w + r).clamp(0, RT - 1)
        st = _tracker_add(
            p, st, rr_ref_en.index_select(0, gi), rr_mc.index_select(0, gi),
            rr_evt.index_select(0, gi), r < rows_eff,
        )
    return st


def tracker_run_compact(min_aln_len, st, rr_ref_en, rr_mc, rr_evt, st_w,
                        rows_eff):
    """Fold this event's compact [RT] seed-row streams into the [B, CL]
    tracker state ``st`` (a dict with TRACKER_KEYS); returns the new dict."""
    dev = rr_ref_en.device
    if dev.type == "cpu":
        return tracker_run_compact_plain(
            min_aln_len, st, rr_ref_en, rr_mc, rr_evt, st_w, rows_eff
        )
    B, CL = _check_state(st, dev)
    RT = rr_ref_en.shape[0]
    for t, name in ((rr_ref_en, "rr_ref_en"), (rr_mc, "rr_mc"),
                    (rr_evt, "rr_evt")):
        _cuda.check(t, "tracker." + name, (I32,), 1, dev)
        if t.shape[0] != RT:
            raise ValueError(f"tracker.{name}: length {t.shape[0]} != {RT}")
    for t, name in ((st_w, "st_w"), (rows_eff, "rows_eff")):
        _cuda.check(t, "tracker." + name, (I32,), 1, dev)
        if t.shape[0] != B:
            raise ValueError(f"tracker.{name}: length {t.shape[0]} != {B}")
    out = {k: torch.empty_like(st[k]) for k in _TABLES + _SCALARS}
    ptrs = (
        [st[k] for k in _TABLES] + [st[k] for k in _SCALARS]
        + [out[k] for k in _TABLES] + [out[k] for k in _SCALARS]
        + [rr_ref_en, rr_mc, rr_evt, st_w, rows_eff]
    )
    _cuda.launch("tracker_fold_compact", ptrs, B, CL, RT, int(min_aln_len))
    _cuda.COUNTS["tracker_fold"] += 1
    return out


def tracker_run_plain(min_aln_len, st, ref_en, mc, evt, row_ok, rows_r):
    p = SimpleNamespace(min_aln_len=int(min_aln_len))
    R = ref_en.shape[1]
    n = min(int(rows_r.max()), R) if rows_r.numel() else 0
    st = {k: st[k] for k in TRACKER_KEYS}
    for r in range(n):
        st = _tracker_add(p, st, ref_en[:, r], mc[:, r], evt[:, r],
                          row_ok[:, r])
    return st


def tracker_run(min_aln_len, st, ref_en, mc, evt, row_ok, rows_r):
    """Fold this event's [B, R] seed-row streams (ref_en, mc, evt int32,
    row_ok bool) into the [B, CL] tracker state ``st`` (a dict with
    TRACKER_KEYS); returns the new dict.  Read b folds rows
    ``r < min(rows_r[b], R)`` gated by ``row_ok``.  Precondition (the
    classic step meets it): ``row_ok[b, r]`` is False for ``r >= rows_r[b]``,
    so the result equals the fold of every read to the batch maximum."""
    dev = ref_en.device
    if dev.type == "cpu":
        return tracker_run_plain(min_aln_len, st, ref_en, mc, evt, row_ok,
                                 rows_r)
    B, CL = _check_state(st, dev)
    R = ref_en.shape[-1]
    for t, name, dt in ((ref_en, "ref_en", I32), (mc, "mc", I32),
                        (evt, "evt", I32), (row_ok, "row_ok", U8)):
        _cuda.check(t, "tracker." + name, (dt,), 2, dev)
        if tuple(t.shape) != (B, R):
            raise ValueError(f"tracker.{name}: shape {tuple(t.shape)} != "
                             f"{(B, R)}")
    _cuda.check(rows_r, "tracker.rows_r", (I32,), 1, dev)
    if rows_r.shape[0] != B:
        raise ValueError(f"tracker.rows_r: length {rows_r.shape[0]} != {B}")
    out = {k: torch.empty_like(st[k]) for k in _TABLES + _SCALARS}
    ptrs = (
        [st[k] for k in _TABLES] + [st[k] for k in _SCALARS]
        + [out[k] for k in _TABLES] + [out[k] for k in _SCALARS]
        + [ref_en, mc, evt, row_ok, rows_r]
    )
    _cuda.launch("tracker_fold_rows", ptrs, B, CL, R, int(min_aln_len))
    _cuda.COUNTS["tracker_fold_rows"] += 1
    return out
