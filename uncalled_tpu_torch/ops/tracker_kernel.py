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
(``csrc/tracker_kernel.cu``, one kernel template for both) fold each read
in its own block over its own rows only; a gated-off row changes nothing
(it maps ``len_sum`` to ``((x + 0) + 0) - 0``, which is ``x`` for every
value the fold produces: it never makes -0.0).  :func:`fold_launch` picks
the kernel's form and launch shape by CL: the table in shared memory for
the whole fold up to ``SHARED_MAX_CL``, in device memory above it.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

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

# Shared memory one block may take on the H100 (227 KB, opt-in above 48 KB).
SHARED_LIMIT = 232_448
# The widest table kept in shared memory: the largest power of two whose
# table (25 bytes a cluster), row staging and partials fit SHARED_LIMIT
# at 1024 threads (221,184 bytes at 8192).  Wider tables (the pooled eject
# tiers' 16384 and 65536) take the device-memory form.
SHARED_MAX_CL = 8192
_PARTIAL_BYTES = 48  # sizeof(Partial) in csrc/tracker_kernel.cu


class FoldLaunch(NamedTuple):
    form: str  # "shared" (table in shared memory) or "device"
    threads: int
    smem: int  # dynamic shared-memory bytes


def fold_smem_bytes(CL: int, threads: int, shared: bool) -> int:
    """The kernel's dynamic shared memory: two [threads/32] halves of warp
    partials, the staged rows (ren, mc, evt i32 and row_ok u8 a thread)
    and, in the shared form, the table (six i32 fields at CL rounded up to
    4, the valid and count flags in one byte at CL rounded up to 16)."""
    n = 2 * (threads // 32) * _PARTIAL_BYTES + 13 * threads
    if shared:
        n += 24 * (-(-CL // 4) * 4) + -(-CL // 16) * 16
    return n


_SMS, _WARPS_PER_SM = 132, 16  # the H100's SMs; fold_launch's target


def fold_launch(CL: int, B: int) -> FoldLaunch:
    """Form and launch shape of both folds at table width CL for B reads.

    Threads: the smallest power of two >= CL/4 in [32, 1024] (about four
    clusters a thread keep the row's scan short while few warps share an
    SM and the row is a latency chain), halved while B blocks would put
    more than _WARPS_PER_SM warps on each of the _SMS SMs (then the row is
    bound by instruction issue, and every warp pays the reductions and the
    update whatever its share of clusters; chip_smoke.py times the pooled
    fold at each width).  The table lives in shared memory for
    CL <= SHARED_MAX_CL, else in device memory."""
    if CL < 1:
        raise ValueError(f"tracker: CL={CL}, expected >= 1")
    threads = 32
    while threads < 1024 and 4 * threads < CL:
        threads *= 2
    while threads > 32 and B * threads > _SMS * _WARPS_PER_SM * 32:
        threads //= 2
    shared = CL <= SHARED_MAX_CL
    smem = fold_smem_bytes(CL, threads, shared)
    if smem > SHARED_LIMIT:
        raise ValueError(f"tracker: CL={CL} needs {smem} B of shared memory")
    return FoldLaunch("shared" if shared else "device", threads, smem)


def _launch(kernel, count, ptrs, B, CL, n, min_aln_len):
    fl = fold_launch(CL, B)
    _cuda.launch(kernel, ptrs, B, CL, n, int(min_aln_len), fl.threads,
                 int(fl.form == "shared"), fl.smem)
    _cuda.COUNTS[count] += 1
    _cuda.COUNTS[f"{count}_{fl.form}"] += 1


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
    _launch("tracker_fold_compact", "tracker_fold", ptrs, B, CL, RT,
            min_aln_len)
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
    _launch("tracker_fold_rows", "tracker_fold_rows", ptrs, B, CL, R,
            min_aln_len)
    return out
