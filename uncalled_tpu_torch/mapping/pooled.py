"""Pooled mapping engine in PyTorch: one flat path pool for the whole batch.

Port of ``uncalled_tpu.mapping.pooled`` (see its docstring for the design):
all reads' live paths sit in one structure-of-arrays pool of S slots,
sorted by (owner read, creation order), so every per-read quantity is a
boundary read of a global cumulative sum and per-path work is elementwise
or a flat gather.  Semantics are the reference mapper's event loop
(mapper.cpp:433-663) exactly as the JAX step replays it; the state is a
dict of tensors with the JAX state's keys and dtypes, and every event
leaves it bit-identical to the JAX step's (tests/test_torch_pooled_step.py).

On the card hand-written CUDA kernels carry the step: the flat gather
behind every ``_flat_take`` and ``flat_gather_cols`` (which reads the
fields it gathers where they lie, with no pack), the per-read k-mer pair
count, the ring assembly, the compact seed-tracker fold and, in the
bitonic candidate sort, the run sort and the merge levels.  The step
does no host synchronisation: every shape is static, so on the card
``PooledEngine`` replays it as CUDA graphs with the hand-written kernels
launched between them (``graphs``).

Both candidate sorts run: ``sort_mode="bitonic"`` (the default on the
card, as JAX's on its accelerator) and ``"flat"`` (the CPU default).  The
in-scan slot handoff (``handoff``) runs, and ``migrate_pool_state`` moves
reads into a narrower engine for the straggler drain.  With
``sampled_sa`` the SA rows are looked up by LF-walk on the 1/``sa_intv``
row sample (``ops.sa_lookup``, its own kernel on the card).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np
import torch

from .. import tracing
from ..config import Conf
from ..device import resolve
from ..kmer import KMER_COUNT
from ..ops.flat_gather import flat_gather, flat_gather_cols, pair_counts
from ..ops import sortkern
from ..ops.sa_lookup import sa_lookup
from ..ops.seg_scan import seg_running_max
from ..ops.sortkern import (
    merge_level,
    merge_level_,
    sort_runs,
    sort_runs_plain,
)
from ..ops.sortkern import rowsort_plain as _rowsort
from ..ops.stepkern import ring_assemble
from ..ops.tracker_kernel import tracker_run_compact
from . import graphs
from .engine import (
    F32,
    I32,
    INT32_MAX,
    READOUT_KEYS,
    TRACKER_KEYS,
    _extend,
    _f32_sort_key,
    _fm_bin,
    _match_probs,
    _ring_read,
    _shard_take,
    _tracker_decide,
    device_index,
    f32_const,
    popcount32,
    readout_get,
    readout_start,
)


@dataclass(frozen=True)
class PoolParams:
    """Static parameters of the pooled engine (the JAX PoolParams fields)."""

    B: int = 256  # read slots
    S: int = 98304  # path pool slots (whole batch)
    SC: int = 131072  # candidate pool slots per event
    FS: int = 256  # full-range sources kept per read per event
    RE: int = 1024  # seed-group entries per event (whole batch)
    RT: int = 6144  # expanded seed rows per event (whole batch)
    R: int = 1024  # seed rows per read per event
    CL: int = 2048  # seed-cluster table capacity per read
    PC: int = 10000  # per-read path budget (the reference's max_paths)
    seed_len: int = 22
    min_rep_len: int = 0
    max_rep_copy: int = 50
    max_consec_stay: int = 8
    max_stay_frac: float = 0.5
    min_seed_prob: float = -3.75
    min_aln_len: int = 25
    min_mean_conf: float = 6.0
    min_top_conf: float = 1.85
    exact_probs: bool = True
    sort_mode: str = "flat"
    # TPU routing flags of the JAX engine, kept so the two PoolParams
    # share their fields; the port ignores them (on the card the kernels
    # are the only path, on the CPU the plain versions are)
    mxu: bool = False
    tracker_kernel: bool = False
    stepkern: bool = False
    stepkern_interpret: bool = False
    sortkern: bool = False
    handoff: bool = False
    sampled_sa: bool = False
    sa_intv: int = 32

    @staticmethod
    def from_conf(conf: Conf, **over) -> "PoolParams":
        mp, st, en = conf.mapper, conf.seed_tracker, conf.engine
        kw = dict(
            B=en.batch_reads,
            handoff=getattr(en, "slot_handoff", False),
            PC=mp.max_paths,
            seed_len=mp.seed_len,
            min_rep_len=mp.min_rep_len,
            max_rep_copy=mp.max_rep_copy,
            max_consec_stay=mp.max_consec_stay,
            max_stay_frac=mp.max_stay_frac,
            min_seed_prob=mp.min_seed_prob,
            min_aln_len=st.min_aln_len,
            min_mean_conf=st.min_mean_conf,
            min_top_conf=st.min_top_conf,
        )
        kw.update(over)
        if "S" not in over:
            kw["S"] = max(4096, kw["B"] * en.pool_slots_per_read)
        if "SC" not in over:
            kw["SC"] = kw["S"] + kw["S"] // 4
        # RE/RT are batch-total per-event row budgets: scale with B
        if "RE" not in over:
            kw["RE"] = max(1024, 4 * kw["B"])
        if "RT" not in over:
            kw["RT"] = max(6144, 24 * kw["B"])
        return PoolParams(**kw)


# readout fields a slot handoff latches for the finished read
LATCH_KEYS = (
    "success", "dec_evt", "evt_i", "ovf", "ovf_why",
    "dm_flags", "dm_valid", "dm_paths", "dm_rows", "dm_cl",
    "mm_len", "mm_ref_st", "mm_r1", "mm_r2e", "mm_evt_st", "mm_evt_en",
)

# per-read fields the in-scan switch resets for the standby read: exactly
# reset_pool_rows' recipe (n_paths kept: the read still owns its emptied
# slots)
_SWITCH_RESET = (
    "cl_valid", "cl_count", "cl_ref_st", "cl_r1", "cl_r2e", "cl_evt_st",
    "cl_evt_en", "cl_total", "len_sum", "n_cl", "mm_len", "mm_ref_st",
    "mm_r1", "mm_r2e", "mm_evt_st", "mm_evt_en", "evt_i", "success",
    "dec_evt", "ovf", "ovf_why", "dm_flags", "dm_valid", "dm_paths",
    "dm_rows", "dm_cl",
)


def make_pool_state(p: PoolParams, device="cpu"):
    """Fresh pooled state: empty pool, B empty read slots."""
    B, S, CL = p.B, p.S, p.CL

    def z(*s):
        return torch.zeros(s, dtype=I32, device=device)

    def zb(*s):
        return torch.zeros(s, dtype=torch.bool, device=device)

    return {
        # flat path pool (rid == B marks a dead slot; sorted by rid)
        "q_rid": torch.full((S,), B, dtype=I32, device=device),
        "q_start": z(S),
        "q_end": z(S),
        "q_kmer": z(S),
        "q_total": z(S),
        "q_consec": z(S),
        "q_moves": z(S),
        "q_sa": zb(S),
        "q_cum": torch.zeros((S, p.seed_len + 1), dtype=F32, device=device),
        "n_paths": z(B),
        "cl_valid": zb(B, CL),
        "cl_count": zb(B, CL),
        "cl_ref_st": z(B, CL),
        "cl_r1": z(B, CL),
        "cl_r2e": z(B, CL),
        "cl_evt_st": z(B, CL),
        "cl_evt_en": z(B, CL),
        "cl_total": z(B, CL),
        "len_sum": torch.zeros((B,), dtype=F32, device=device),
        "n_cl": z(B),
        "mm_len": z(B),
        "mm_ref_st": z(B),
        "mm_r1": z(B),
        "mm_r2e": z(B),
        "mm_evt_st": z(B),
        "mm_evt_en": z(B),
        "evt_i": z(B),
        "done": torch.ones((B,), dtype=torch.bool, device=device),
        "success": zb(B),
        "dec_evt": z(B),
        # pool-exhaustion overflow bits: 2=candidate pool, 4=full-source
        # cap, 8=path pool, 16=seed-row caps, 1=CL evict
        "ovf": zb(B),
        "ovf_why": z(B),
        "dm_flags": z(B),
        "dm_valid": z(B),
        "dm_paths": z(B),
        "dm_rows": z(B),
        "dm_cl": z(B),
        # pool-global demand high-water [flags, valid, keep, entries, rows]
        "dm_pool": z(5),
        # slot-handoff latch (PoolParams.handoff): sw marks a slot that
        # switched to its standby read mid-block; lt_* hold the finished
        # read's readout fields until the host harvests and promotes it
        "sw": zb(B),
        **{"lt_" + k: (zb(B) if k in ("success", "ovf") else z(B))
           for k in LATCH_KEYS},
    }


def reset_pool_rows(state, mask):
    """Reset read slots where mask[B]: per-read scalars/tables go fresh
    (zeros); the read's pool slots are emptied in place (q_total = 0; the
    next event's assembly drops them); n_paths and dm_pool are kept."""
    B = state["done"].shape[0]
    out = {}
    for k, v in state.items():
        if k in ("dm_pool", "n_paths") or (k.startswith("q_")
                                           and k != "q_total"):
            out[k] = v
        elif k == "q_total":
            rid = state["q_rid"]
            hit = mask.index_select(0, rid.clamp(max=B - 1)) & (rid < B)
            out[k] = torch.where(hit, 0, v)
        elif k == "done":
            out[k] = v & ~mask
        else:
            m = mask.view((B,) + (1,) * (v.dim() - 1))
            out[k] = torch.where(m, torch.zeros((), dtype=v.dtype,
                                                device=v.device), v)
    return out


# ---------------------------------------------------------------------------
# flat-array helpers
# ---------------------------------------------------------------------------

def _iota(n, device):
    return torch.arange(n, dtype=I32, device=device)


def _csum(x):
    return torch.cumsum(x, 0, dtype=I32)


def _excl(x):
    """(exclusive int32 cumsum of x, the same padded with the total)."""
    c = _csum(x)
    ex = c - x.to(I32)
    return ex, torch.cat([ex, c[-1:]])


def _f32_from_sort_key(k):
    """Inverse of the monotone part of :func:`_f32_sort_key`."""
    return (k ^ torch.where(k < 0, INT32_MAX, 0).to(I32)).view(F32)


def _sort1d(keys, payloads=(), num_keys=None):
    """Ascending lexicographic sort of flat arrays by ``keys[:num_keys]``
    (float keys in lax.sort's order), as stable passes from the least to
    the most significant key; returns every key and payload permuted.
    Equal key tuples keep their input order, so callers that need
    lax.sort's result make the key tuple total (the step appends an iota
    key)."""
    nk = num_keys or len(keys)
    perm = None
    for k in reversed(keys[:nk]):
        kk = _f32_sort_key(k) if k.dtype == F32 else k
        if perm is not None:
            kk = kk.index_select(0, perm)
        order = torch.sort(kk, stable=True).indices
        perm = order if perm is None else perm.index_select(0, order)
    return tuple(a.index_select(0, perm) for a in (*keys, *payloads))


def _sort1d_bitonic(keys):
    """Flat ascending lexicographic sort of int32 key tuples by a bitonic
    network (the JAX ``_sort1d_bitonic`` on its kernel path): keys pad with
    INT32_MAX to NP = the next power of two >= max(N, 8192).  Every key is
    compared, so the result equals a full lexicographic sort of the tuples
    exactly, whatever schedule runs the network.

    On the card (:func:`_sort1d_network`): the run sort, then each merge
    level to stride 1, all on one [NK, NP] buffer.  On the CPU, the JAX
    composition: row sorts build runs of 8192 in alternating directions;
    each level k_lv = 16384 ... NP runs its stride >= C passes in
    ``merge_level`` (C = 128 for k_lv <= 32768, else 1024) and finishes
    with a row sort of width C."""
    N = keys[0].shape[0]
    C0 = 8192
    NP = 1 << (max(N, C0) - 1).bit_length()
    if keys[0].device.type != "cpu":
        return _sort1d_network(keys, NP)
    W0 = min(C0, NP)
    ks = sort_runs_plain(keys, NP, W0)
    k_lv = 2 * W0
    while k_lv <= NP:
        C = 128 if k_lv <= 32768 else 1024
        ks = merge_level(ks, k_lv, C)
        ks = _rowsort(ks, min(C, NP), k_lv)
        k_lv *= 2
    return tuple(k[:N] for k in ks)


def _sort1d_network(keys, NP):
    """The card's bitonic sort: ``sort_runs`` in runs of
    ``sortkern.RUN_TILE``, then ``merge_level_`` to stride 1 at every level
    above, in place on the run sort's buffer; the first N of each plane."""
    N = keys[0].shape[0]
    W = min(sortkern.RUN_TILE, NP)
    buf = sort_runs(keys, NP, W)
    k_lv = 2 * W
    while k_lv <= NP:
        merge_level_(buf, k_lv, 1)
        k_lv *= 2
    return tuple(buf[q, :N] for q in range(len(keys)))


def _flat_take(tbl, idx):
    """Flat shared-table gather (clamped indices) through the flat-gather
    kernel; [N] -> [K], [N, F] -> [K, F]."""
    return flat_gather(tbl.contiguous(), idx.contiguous())


def _bucket_of(starts, w_out):
    """For sorted segment starts [G], the segment id of each output slot
    j in [0, w_out): r[j] = (# starts <= j) - 1."""
    sidx = torch.where(starts < w_out, starts, w_out).to(torch.int64)
    hist = torch.zeros(w_out + 1, dtype=I32, device=starts.device)
    hist.index_add_(0, sidx, torch.ones_like(sidx, dtype=I32))
    return _csum(hist[:w_out]) - 1


def _seg_broadcast(fields, starts, w_out):
    """Broadcast per-segment values onto contiguous ranges:
    out_f[j] = f[max {g : starts[g] <= j}] for each i32/bool field [G]
    (``starts`` sorted, starts[0] == 0; a trailing [G+1]-th start is
    ignored).  Per-segment diffs scattered at the starts and re-summed;
    duplicate starts (empty segments) telescope to the later segment;
    starts at or past w_out are dropped."""
    if starts.shape[0] == fields[0].shape[0] + 1:
        starts = starts[:-1]
    offc = starts.clamp(max=w_out).to(torch.int64)
    out = []
    for f in fields:
        fi = f.to(I32)
        diff = torch.cat([fi[:1], fi[1:] - fi[:-1]])
        acc = torch.zeros(w_out + 1, dtype=I32, device=f.device)
        acc.index_add_(0, offc, diff)
        v = _csum(acc[:w_out])
        out.append(v != 0 if f.dtype == torch.bool else v)
    return out


def _compaction_table(valid):
    """src[j] = index of the j-th True of ``valid`` [N], or N-1 where j is
    past the True count (the JAX two-level compaction's value there)."""
    N = valid.shape[0]
    pos = _csum(valid) - 1
    tgt = torch.where(valid, pos, N).to(torch.int64)
    src = torch.full((N + 1,), N - 1, dtype=I32, device=valid.device)
    src.scatter_(0, tgt, _iota(N, valid.device))
    src[N:].fill_(N - 1)  # a fill: the graphs capture no host copy
    return src[:N], pos[-1] + 1


class _CompactMap:
    """Stable-compaction map over a flat validity mask: ``at(q)`` is the
    source index of the clamp(q, 0, N-1)-th True element (N-1 past the
    True count)."""

    def __init__(self, valid):
        self._N = valid.shape[0]
        self._src, _ = _compaction_table(valid)

    def at(self, q):
        return _flat_take(self._src, q.clamp(0, self._N - 1))


def _compact1d(valid, w_out):
    """Stable flat compaction indices: src[j] = index of the j-th True
    (N-1 past the count), ok[j] = j < count; [w_out] each."""
    N = valid.shape[0]
    src, total = _compaction_table(valid)
    if w_out <= N:
        src = src[:w_out]
    else:
        src = torch.cat([src, torch.full((w_out - N,), N - 1, dtype=I32,
                                         device=valid.device)])
    return src, _iota(w_out, valid.device) < total


# ---------------------------------------------------------------------------
# the pooled event step
# ---------------------------------------------------------------------------

def _switch_to_standby(st, ev, ev_on, sb):
    """The in-scan slot handoff (PoolParams.handoff), at the start of an
    event: a done slot with an armed standby latches its readout fields
    (lt_*) and restarts as the standby read this very event.  Its per-read
    state resets as reset_pool_rows resets it (n_paths kept; the caller
    empties its pool rows), and its event source flips to the 0-based
    standby window ``sb = (sb_m [B, W], sb_o [B, W], sb_armed [B])``,
    indexed by the post-reset evt_i.  Returns (state, ev, ev_on, swm), swm
    the slots that switched now."""
    sb_m, sb_o, sb_armed = sb
    W = sb_m.shape[1]
    swm = st["done"] & sb_armed & (~st["sw"])
    use_sb = st["sw"] | swm
    evt = st["evt_i"]
    rel = torch.where(swm, 0, evt.clamp(0, W - 1)).to(torch.int64)[:, None]
    sb_ev = torch.gather(sb_m, 1, rel)[:, 0]
    sb_ok = torch.gather(sb_o, 1, rel)[:, 0] & (torch.where(swm, 0, evt) < W)
    ev = torch.where(use_sb, sb_ev, ev)
    ev_on = torch.where(use_sb, sb_ok, ev_on)
    st = dict(st)
    for k in LATCH_KEYS:
        st["lt_" + k] = torch.where(swm, st[k], st["lt_" + k])
    st["sw"] = use_sb
    for k in _SWITCH_RESET:
        v = st[k]
        m = swm.view(swm.shape + (1,) * (v.dim() - 1))
        st[k] = torch.where(m, torch.zeros((), dtype=v.dtype,
                                           device=v.device), v)
    st["done"] = st["done"] & (~swm)
    return st, ev, ev_on, swm


def _pool_event_step(idx, p: PoolParams, st, ev, ev_on, sb=None,
                     ph=tracing.NOOP):
    """One event for every slot.  ``ph`` marks the step's phases, one
    marker at each section below; the last, ``release``, runs on past the
    return, while the step's tensors are freed (``tracing.phases``)."""
    dev = ev.device
    B, S, SC, SL = p.B, p.S, p.SC, p.seed_len
    KMASK = KMER_COUNT - 1
    PATH_MASK = (1 << SL) - 1
    TAIL_MOVE = 1 << (SL - 1)
    RING = SL + 1
    PC = p.PC
    n = idx["n"]
    stay_frac_max = f32_const(p.max_stay_frac * SL)
    min_seed_prob = f32_const(p.min_seed_prob)

    def iota(m):
        return _iota(m, dev)

    def full(m, v, dtype=I32):
        return torch.full((m,), v, dtype=dtype, device=dev)

    def nxt1(a, fill):
        return torch.cat([a[1:], torch.full((1,), fill, dtype=a.dtype,
                                            device=dev)])

    swm = None
    if p.handoff and sb is not None:
        ph("switch")
        st, ev, ev_on, swm = _switch_to_standby(st, ev, ev_on, sb)

    ph("probs")
    alive = (~st["done"]) & ev_on  # [B]
    probs = _match_probs(idx, ev, p.exact_probs)  # [B, 1024] f32

    rid = st["q_rid"]  # [S], B = dead
    ridc = rid.clamp(max=B - 1)
    owned = rid < B

    # per-read segment boundaries in slot space
    off = torch.cat([full(1, 0), _csum(st["n_paths"])])  # [B+1]
    if swm is not None:
        # empty the switching reads' pool rows in place (q_total = 0 kills
        # their flags and carry; the assembly drops them)
        (sw_slot,) = _seg_broadcast([swm], off, S)
        st["q_total"] = torch.where(sw_slot & owned, 0, st["q_total"])
    q_start, q_end, q_kmer = st["q_start"], st["q_end"], st["q_kmer"]
    q_total, q_consec, q_moves = st["q_total"], st["q_consec"], st["q_moves"]
    q_sa, q_cum = st["q_sa"], st["q_cum"]
    al_slot, run_slot = _seg_broadcast([alive, alive | st["done"]], off, S)
    slot_alive = owned & al_slot & (q_total > 0)

    # ---- candidate flags in creation order -------------------------------
    ph("candidates")
    pv = slot_alive
    fmlen = q_end - q_start + 1
    # stay + move probs are 4-wide rows of one [B*256, 4] view of probs
    KQ = KMER_COUNT // 4
    p4 = probs.reshape(B * KQ, 4)
    ridq = ridc * KQ
    stay_p = _ring_read(_flat_take(p4, ridq + (q_kmer >> 2)), q_kmer & 3)
    mv_p = _flat_take(p4, ridq + (q_kmer & (KQ - 1)))  # [S, 4]
    fm_bin = _fm_bin(fmlen)
    NT4 = idx["threshes"].shape[0] // 4
    gt = _flat_take(idx["threshes"].reshape(NT4, 4), fm_bin >> 2)
    thresh = _ring_read(gt, fm_bin & 3)
    stay_f = pv & (q_consec < p.max_consec_stay) & (stay_p >= thresh)
    # NaN-threshold polarity parity (mapper.cpp:471,489)
    mv_f = pv[:, None] & ~(mv_p < thresh[:, None])
    flags = torch.cat([stay_f[:, None], mv_f], 1)  # [S, 5]

    # ---- compact to the candidate pool (global, order-preserving) --------
    ph("compact")
    flat = flags.reshape(5 * S)
    cflags = flags.sum(1, dtype=I32)  # [S]
    pstart, pstart_pad = _excl(cflags)
    total_flags = pstart_pad[-1]
    cb = _flat_take(pstart_pad, off)  # cand-space read starts [B+1]
    n_flags_r = cb[1:] - cb[:-1]

    cidx, cval = _compact1d(flat, SC)
    cpar = torch.where(cval, torch.div(cidx, 5, rounding_mode="trunc"), S)
    move = torch.where(cval, torch.remainder(cidx, 5), 0)
    cpar_g = cpar.clamp(max=S - 1)
    cut_cand = (cb[1:].clamp(max=SC) - cb[:-1].clamp(max=SC)) != n_flags_r

    # ---- parent fields + FM extension ------------------------------------
    ph("extend")
    cumnow_p = _ring_read(q_cum, q_total % RING)
    wslot_p = torch.where(q_total + 1 >= SL, (q_total + 1 - SL) % RING, 0)
    wstart_p = _ring_read(q_cum, wslot_p)
    (cs, ce_, ck, ctot, ccons, cmvs, csa, ccum, cwst,
     cp_stay, cp_m0, cp_m1, cp_m2, cp_m3) = flat_gather_cols(
        [q_start, q_end, q_kmer, q_total, q_consec, q_moves, q_sa, cumnow_p,
         wstart_p, stay_p, mv_p[:, 0], mv_p[:, 1], mv_p[:, 2], mv_p[:, 3]],
        cpar_g,
    )
    # candidates are created in slot order: read-contiguous with bounds cb
    (crid,) = _seg_broadcast([iota(B)], cb, SC)
    crid = torch.where(cval, crid, B)

    is_mv = move >= 1
    mvbase = (move - 1).clamp(0, 3)
    nk = torch.where(is_mv, ((ck << 2) & KMASK) | mvbase, ck)
    ns_m, ne_m = _extend(idx, cs, ce_, mvbase)
    ns = torch.where(is_mv, ns_m, cs)
    ne = torch.where(is_mv, ne_m, ce_)
    cv_fm = cval & ((~is_mv) | (ns <= ne))

    # within-read FM-valid count -> the reference's max_paths budget
    vcum, vcum_pad = _excl(cv_fm)
    cb_c = cb.clamp(max=SC)
    vbase_b = _flat_take(vcum_pad, cb_c)  # [B+1]
    (wv_base,) = _seg_broadcast([vbase_b[:-1]], cb, SC)
    wvalid = vcum - wv_base
    cvalid = cv_fm & (wvalid < PC)
    n_valid_r = vbase_b[1:] - vbase_b[:-1]
    # read boundaries in SORTED-candidate space
    _, ccum2_pad = _excl(cvalid)
    svb = _flat_take(ccum2_pad, cb_c)  # [B+1]
    svb_c = svb.clamp(max=SC)

    prob = torch.where(
        move == 0, cp_stay,
        torch.where(
            move == 1, cp_m0,
            torch.where(move == 2, cp_m1,
                        torch.where(move == 3, cp_m2, cp_m3)),
        ),
    )
    new_tot = ctot + 1
    newcum = ccum + prob
    seedprob = torch.where(
        new_tot >= SL, (newcum - cwst) / SL, newcum / new_tot.to(F32)
    )
    nmoves = ((cmvs << 1) | is_mv.to(I32)) & PATH_MASK
    nmoves = torch.where(ctot >= SL, nmoves | TAIL_MOVE, nmoves)
    nconsec = torch.where(is_mv, 0, ccons + 1)

    # ---- ended parents (budget-break parity, mapper.cpp:455-520) ---------
    ph("ended")
    k_i = pstart  # [S] global compacted position of each stay flag
    is_last = nxt1(rid, B) != rid
    seg_end_c, tot_valid_slot = _seg_broadcast([cb[1:], n_valid_r], off, S)
    wv_pad = torch.cat([wvalid, full(1, 0)])
    v1 = _flat_take(wv_pad, k_i.clamp(max=SC))
    inseg1 = (k_i < seg_end_c) & (k_i < SC)
    vb = torch.where(inseg1, v1, tot_valid_slot)
    vb_next = torch.where(
        is_last, tot_valid_slot, torch.cat([vb[1:], tot_valid_slot[-1:]])
    )
    child_any = vb_next.clamp(max=PC) > vb.clamp(max=PC)
    reached = (k_i < SC) & (vb < PC)
    pmc = popcount32(q_moves)
    tot_q = q_total
    wslot_q = torch.where(tot_q >= SL, (tot_q - SL) % RING, 0)
    wstart_q = _ring_read(q_cum, wslot_q)
    pseedprob = torch.where(
        tot_q >= SL,
        (cumnow_p - wstart_q) / SL,
        cumnow_p / tot_q.clamp(min=1).to(F32),
    )
    ended = pv & (~child_any) & (~q_sa) & reached
    e_rep = (fmlen <= p.max_rep_copy) & (pmc >= p.min_rep_len)
    e_unique = (
        (fmlen == 1) & ((q_moves & 1) == 1) & ((SL - pmc) <= stay_frac_max)
    )
    e_valid = (
        ended
        & (tot_q.clamp(max=SL) == SL)
        & (pseedprob >= min_seed_prob)
        & (e_unique | e_rep)
    )
    e_rows = torch.where(e_valid, fmlen.clamp(max=p.max_rep_copy), 0)

    # ---- sort candidates by (read, fm_start, fm_end, seed_prob) ----------
    ph("sort")
    # the last key is the creation index: full ties keep creation order
    rid_key = torch.where(cvalid, crid, B)
    k1 = torch.where(cvalid, ns, INT32_MAX)
    k2 = torch.where(cvalid, ne, INT32_MAX)
    if p.sort_mode == "bitonic":
        rks, k1s, k2s, k3i, perm = _sort1d_bitonic(
            (rid_key, k1, k2, _f32_sort_key(seedprob), iota(SC))
        )
        k3s = _f32_from_sort_key(k3i)
    else:
        rks, k1s, k2s, k3s, perm = _sort1d(
            (rid_key, k1, k2, seedprob, iota(SC)), (), num_keys=5
        )
    svalid = rks < B
    ns_s, ne_s, seedprob_s = k1s, k2s, k3s
    rid_s = rks.clamp(max=B - 1)
    (nk_s, prob_s, ntot_s, nmoves_s, ncons_s, csa_s, newcum_s,
     cpar_s) = flat_gather_cols(
        [nk, prob, new_tot, nmoves, nconsec, csa, newcum, cpar_g], perm,
    )

    same_next = nxt1(rks, B) == rks
    dup = (
        svalid
        & nxt1(svalid, False)
        & same_next
        & (ns_s == nxt1(ns_s, -1))
        & (ne_s == nxt1(ne_s, -1))
    )

    # candidate seed validity (non-ended branch of is_seed_valid)
    smc = popcount32(nmoves_s)
    seed_c = (
        svalid
        & (~dup)
        & (ntot_s >= SL)
        & (seedprob_s >= min_seed_prob)
        & ((ne_s - ns_s + 1) == 1)
        & ((nmoves_s & 1) == 1)
        & ((SL - smc) <= stay_frac_max)
    )

    # ---- seed rows: ended groups (pool order) then candidates (sorted) ---
    ph("seed_rows")
    MRC = p.max_rep_copy
    RE = min(p.RE, S + SC)
    RT = min(p.RT, RE * MRC)
    R = p.R
    ent_rows_all = torch.cat([e_rows, seed_c.to(I32)])
    ent_st_all = torch.cat([q_start, ns_s])
    ent_mc_all = torch.cat([pmc, smc])
    ent_ended = torch.cat([full(S, True, torch.bool),
                           full(SC, False, torch.bool)])
    endv = e_rows > 0
    _, endcum_pad = _excl(endv)
    end_b = _flat_take(endcum_pad, off.clamp(max=S))
    ended_r = end_b[1:] - end_b[:-1]
    sdv = seed_c
    _, sdcum_pad = _excl(sdv)
    sd_b = _flat_take(sdcum_pad, svb_c)
    seeds_r = sd_b[1:] - sd_b[:-1]
    want_ent = ended_r + seeds_r
    off_ent = torch.cat([full(1, 0), _csum(want_ent)])
    n_ent = off_ent[-1]
    rows_cut_global = n_ent > RE
    endc_src, _ = _compact1d(endv, RE)
    sdc_src, _ = _compact1d(sdv, RE)

    e_j = iota(RE)
    e_b = _bucket_of(off_ent[:-1], RE).clamp(0, B - 1)
    e_ok = e_j < n_ent.clamp(max=RE)
    eb_off, eb_end, eb_endst, eb_sdst = flat_gather_cols(
        [off_ent[:-1], ended_r, end_b[:-1], sd_b[:-1]], e_b
    )
    e_r = e_j - eb_off
    e_is_end = e_r < eb_end
    src_end = _flat_take(endc_src, (eb_endst + e_r).clamp(0, RE - 1))
    src_sd = _flat_take(sdc_src, (eb_sdst + (e_r - eb_end)).clamp(0, RE - 1))
    eperm = torch.where(e_is_end, src_end, S + src_sd).clamp(0, S + SC - 1)
    g_rows, g_st, g_mc, g_end = flat_gather_cols(
        [ent_rows_all, ent_st_all, ent_mc_all, ent_ended], eperm
    )
    g_rid = e_b
    g_rows = torch.where(e_ok, g_rows, 0)

    # expand entries -> rows ([RE, MRC] grid, compact to RT)
    row_val = (iota(MRC)[None, :] < g_rows[:, None]).reshape(RE * MRC)
    rsrc, r_ok = _compact1d(row_val, RT)
    r_ent = torch.div(rsrc, MRC, rounding_mode="trunc")
    r_off = torch.remainder(rsrc, MRC)
    rr_rid, rr_st, rr_mc, rr_end = flat_gather_cols(
        [g_rid, g_st, g_mc, g_end], r_ent
    )
    rr_rid = torch.where(r_ok, rr_rid, B)
    sa_row = (rr_st + r_off).clamp(0, n)
    if p.sampled_sa:
        ref_en_flat = n - sa_lookup(idx, sa_row, p.sa_intv)
    else:
        ref_en_flat = n - _shard_take(idx, "sa", sa_row)
    rr_evti = _flat_take(st["evt_i"], rr_rid.clamp(max=B - 1))
    rr_evt = torch.where(rr_end, rr_evti - 1, rr_evti)

    # rows -> per-read windows of the compact row stream
    growc_pad = torch.cat([full(1, 0), _csum(g_rows)])
    rw_b = _flat_take(growc_pad, off_ent.clamp(max=RE))  # [B+1]
    want_rows_r = rw_b[1:] - rw_b[:-1]
    st_w = rw_b[:-1].clamp(max=RT)
    rows_r = rw_b[1:].clamp(max=RT) - st_w  # actual rows
    rows_cut_r = (want_rows_r > R) | (rows_r != want_rows_r)
    rows_eff = torch.where(alive, rows_r.clamp(max=R), 0)

    ph("tracker")
    tstate = tracker_run_compact(
        p.min_aln_len, {k: st[k] for k in TRACKER_KEYS}, ref_en_flat,
        rr_mc, rr_evt, st_w, rows_eff,
    )

    # ---- sources (mapper.cpp:544-624) -------------------------------------
    ph("sources")
    source_prob = idx["threshes"][0]
    kpass = prob_s >= source_prob
    prev_k = torch.cat([full(1, -1), nk_s[:-1]])
    prev_r = torch.cat([full(1, -1), rks[:-1]])
    first_seg = svalid & ((nk_s != prev_k) | (rks != prev_r))
    seg_id = _csum(first_seg)
    run_end = seg_running_max(seg_id, ne_s)

    km_st, km_en = flat_gather_cols([idx["kmer_st"], idx["kmer_en"]], nk_s)
    head_st = km_st
    head_en = ns_s - 1
    head_v = first_seg & kpass & (head_st <= head_en)

    nxt_same = nxt1(svalid, False) & same_next & (nxt1(nk_s, -1) == nk_s)
    gap_st = run_end + 1
    gap_en = torch.where(nxt_same, nxt1(ns_s, 0) - 1, km_en)
    gap_v = svalid & (~dup) & kpass & (gap_st <= gap_en)

    # k-mer presence per read
    present = pair_counts(
        torch.where(svalid, rid_s, B), nk_s, B, KMER_COUNT
    ) > 0
    full_v = (
        (~present)
        & (probs >= source_prob)
        & (idx["kmer_st"] <= idx["kmer_en"])[None, :]
        & alive[:, None]
    )

    # ---- assemble the new pool --------------------------------------------
    ph("assemble")
    child_keep = svalid & (~dup)
    _, ckcum_pad = _excl(child_keep)
    # n_cands per read includes dups (the reference's budget_left)
    nc_r = (vbase_b[1:] - vbase_b[:-1]).clamp(max=PC)

    hg_v = torch.stack([head_v, gap_v], 1).reshape(2 * SC)
    _, hgcum_pad = _excl(hg_v)
    hg_end_b = _flat_take(hgcum_pad, svb_c * 2)  # [B+1]
    n_hg_r = hg_end_b[1:] - hg_end_b[:-1]

    # full sources: per-read compaction to FS slots (kmer order kept)
    FS = p.FS
    iota_k = iota(KMER_COUNT)[None, :].expand(B, KMER_COUNT)
    fkey = torch.where(full_v, iota_k, KMER_COUNT)
    fkey_s = torch.sort(fkey, 1).values[:, :FS]
    f_kmer = fkey_s.clamp(max=KMER_COUNT - 1)
    n_full_r = full_v.sum(1, dtype=I32)
    cut_full = n_full_r > FS

    # carried slots: owned reads not advancing this step keep their paths
    carried = owned & (~run_slot) & (q_total > 0)

    nd_b = _flat_take(ckcum_pad, svb_c)  # [B+1] nondup boundaries
    nondup_r = nd_b[1:] - nd_b[:-1]
    hgk_r = torch.minimum(n_hg_r, (PC - nc_r).clamp(min=0))
    fk_r = torch.minimum(
        n_full_r.clamp(max=FS), (PC - nc_r - hgk_r).clamp(min=0)
    )
    ccar_pad = torch.cat([full(1, 0), _csum(carried)])
    car_b = _flat_take(ccar_pad, off)  # [B+1]
    carried_r = car_b[1:] - car_b[:-1]
    want_r = nondup_r + hgk_r + fk_r + carried_r
    off_new = torch.cat([full(1, 0), _csum(want_r)])
    total_keep = off_new[-1]
    kept_r = torch.minimum((S - off_new[:-1]).clamp(min=0), want_r)
    cut_pool_r = kept_r != want_r

    # one compaction map over child_keep ++ hg: A sources at [0, SC), H
    # at [SC, 3SC)
    ah_map = _CompactMap(torch.cat([child_keep, hg_v]))

    j_out = iota(S)
    bj = _bucket_of(off_new[:-1], S).clamp(0, B - 1)
    keep = j_out < total_keep.clamp(max=S)
    g_off, g_nd, g_hgk, g_fk, g_ckst, g_hgst, g_old = _seg_broadcast(
        [off_new[:-1], nondup_r, hgk_r, fk_r, nd_b[:-1], hg_end_b[:-1],
         off[:-1]],
        off_new, S,
    )
    r_in = j_out - g_off
    cls_A = keep & (r_in < g_nd)
    cls_H = keep & (~cls_A) & (r_in < g_nd + g_hgk)
    cls_F = keep & (~cls_A) & (~cls_H) & (r_in < g_nd + g_hgk + g_fk)
    new_rid = torch.where(keep, bj, B)

    n_ck = ckcum_pad[-1]
    q_ah = torch.where(cls_H, n_ck + g_hgst + (r_in - g_nd), g_ckst + r_in)
    idx_AH = ah_map.at(q_ah)
    # H sources arrive interleaved (SC + 2c + b); the unified table keeps
    # head/gap as contiguous [SC] blocks: remap to SC + b*SC + c
    h_off = idx_AH - SC
    idx_AH = torch.where(
        cls_H, SC + (h_off & 1) * SC + (h_off >> 1), idx_AH
    )
    idx_F = (bj * FS + (r_in - g_nd - g_hgk)).clamp(0, B * FS - 1)
    idx_D = (g_old + (r_in - g_nd - g_hgk - g_fk)).clamp(0, S - 1)

    # ---- unified record table: one row gather serves all four classes.
    ph("record_table")
    # Schema: start, end, kmer, total, consec, moves, sa, ringsrc (pool
    # row to copy the prob ring from; -1 = zeros), ringslot (ring slot to
    # overwrite; -1 = none), ringval.
    fkm_full = f_kmer.reshape(B * FS)
    f_st_full, f_en_full = flat_gather_cols(
        [idx["kmer_st"], idx["kmer_en"]], fkm_full
    )
    f_rid_full = torch.div(iota(B * FS), FS, rounding_mode="trunc")
    f_prob_full = _ring_read(
        _flat_take(p4, f_rid_full * KQ + (fkm_full >> 2)), fkm_full & 3
    )
    NU = 3 * SC + B * FS + S
    BFS = B * FS

    # each column in its five segments A = SC, H = 2 * SC (head, gap),
    # F = BFS, D = S, read where they lie; fills are segment constants
    src_u = torch.where(
        cls_A | cls_H, idx_AH,
        torch.where(cls_F, 3 * SC + idx_F, 3 * SC + BFS + idx_D),
    )
    (g_start, g_end, g_kmer, g_total, g_consec, g_moves, g_sa, g_rsrc,
     g_rslot, g_rval) = flat_gather_cols(
        [[ns_s, head_st, gap_st, f_st_full, q_start],
         [ne_s, head_en, gap_en, f_en_full, q_end],
         [nk_s, nk_s, nk_s, fkm_full, q_kmer],
         [ntot_s, 1, 1, 1, q_total],
         [ncons_s, 0, 0, 0, q_consec],
         [nmoves_s, 1, 1, 1, q_moves],
         [csa_s | seed_c, False, False, False, q_sa],
         [cpar_s, -1, -1, -1, iota(S)],
         [ntot_s % RING, 1, 1, 1, -1],
         [newcum_s, prob_s, prob_s, f_prob_full, 0.0]],
        src_u.clamp(max=NU - 1),
    )

    nq_cum = ring_assemble(q_cum, g_rsrc, g_rslot, g_rval, keep)

    out = dict(st)
    out["q_rid"] = new_rid
    out["q_start"] = torch.where(keep, g_start, 0)
    out["q_end"] = torch.where(keep, g_end, -1)
    out["q_kmer"] = torch.where(keep, g_kmer, 0)
    out["q_total"] = torch.where(keep, g_total, 0)
    out["q_consec"] = torch.where(keep, g_consec, 0)
    out["q_moves"] = torch.where(keep, g_moves, 0)
    out["q_sa"] = keep & g_sa
    out["q_cum"] = nq_cum
    out["n_paths"] = kept_r
    for k, v in tstate.items():
        m = alive.view((B,) + (1,) * (v.dim() - 1))
        out[k] = torch.where(m, v, st[k])

    # overflow flags: physical pool cuts only (the per-read budget is the
    # reference's); bits 2=candidate pool, 4=full-source cap, 8=path
    # pool, 16=row caps, 1=CL evict (tracker)
    rows_cut = rows_cut_r | rows_cut_global
    ovf_ev = cut_cand | cut_full | cut_pool_r | rows_cut
    out["ovf"] = out["ovf"] | (ovf_ev & alive)
    why = (
        cut_cand.to(I32) * 2 | cut_full.to(I32) * 4
        | cut_pool_r.to(I32) * 8 | rows_cut.to(I32) * 16
    )
    out["ovf_why"] = out["ovf_why"] | torch.where(alive, why, 0)

    def upd(cur, v):
        return torch.maximum(cur, torch.where(alive, v, 0))

    out["dm_flags"] = upd(st["dm_flags"], n_flags_r)
    out["dm_valid"] = upd(st["dm_valid"], n_valid_r)
    out["dm_paths"] = upd(st["dm_paths"], want_r)
    out["dm_rows"] = upd(st["dm_rows"], want_rows_r)
    out["dm_cl"] = upd(st["dm_cl"], out["n_cl"])
    if "shard" in idx:
        # the sharded engines keep the [5] telemetry vector inert, as the
        # JAX step does under shard_map, where per-shard maxima vary and
        # cannot be a replicated carry
        out["dm_pool"] = st["dm_pool"]
    else:
        out["dm_pool"] = torch.maximum(
            st["dm_pool"],
            torch.stack([total_flags, ccum2_pad[-1] + cvalid[-1].to(I32),
                         total_keep, n_ent, rw_b[-1]]),
        )

    ph("decide")
    dec = _tracker_decide(p, out) & alive
    out["done"] = st["done"] | dec
    out["success"] = st["success"] | dec
    out["dec_evt"] = torch.where(dec, st["evt_i"], st["dec_evt"])
    out["evt_i"] = st["evt_i"] + alive.to(I32)
    ph("release")
    return out


def migrate_pool_state(src_p: PoolParams, dst_p: PoolParams, state, sel):
    """Move selected reads' state into a (smaller) pooled engine's shape.

    ``sel`` [B_dst] int32 holds source read rows (-1 = an empty
    destination slot, which takes fresh values).  Per-read arrays are
    gathered by row; each read's contiguous pool segment moves to its new
    exclusive-cumsum offset; ``dm_pool`` starts fresh (the host absorbs
    the source's before it migrates).  This lets the straggler drain
    continue reads on a narrow batch instead of restarting them."""
    Bs, Ss = src_p.B, src_p.S
    Bd, Sd = dst_p.B, dst_p.S
    dev = state["n_paths"].device
    valid = sel >= 0
    selc = sel.clamp(0, Bs - 1).to(torch.int64)
    fresh = make_pool_state(dst_p, dev)
    out = {}
    for k, v in state.items():
        if k.startswith("q_"):
            continue
        if k == "dm_pool":
            out[k] = fresh[k]
            continue
        g = v.index_select(0, selc)
        w = valid.view(valid.shape + (1,) * (g.dim() - 1))
        out[k] = torch.where(w, g, fresh[k])
    n_new = torch.where(valid, state["n_paths"].index_select(0, selc), 0)
    out["n_paths"] = n_new
    zero = torch.zeros(1, dtype=I32, device=dev)
    off_src = torch.cat([zero, _csum(state["n_paths"])])
    new_off = torch.cat([zero, _csum(n_new)])
    j = _iota(Sd, dev)
    k_read = _bucket_of(new_off[:-1], Sd).clamp(0, Bd - 1)
    within = j - _flat_take(new_off, k_read)
    src_b = _flat_take(off_src.index_select(0, selc), k_read)
    src_idx = (src_b + within).clamp(0, Ss - 1)
    ok = j < new_off[-1]
    flds = ["q_start", "q_end", "q_kmer", "q_total", "q_consec", "q_moves",
            "q_sa"]
    got = flat_gather_cols([state[f] for f in flds], src_idx)
    for f, g in zip(flds, got):
        out[f] = ok & g if f == "q_sa" else torch.where(ok, g, fresh[f])
    out["q_rid"] = torch.where(ok, k_read, Bd)
    cum = state["q_cum"].index_select(0, src_idx.to(torch.int64))
    out["q_cum"] = torch.where(ok[:, None], cum, 0.0)
    return out


def widen_pool_state(p: PoolParams, state):
    """``state`` in ``p``'s shape, where ``p`` has as many read slots and
    pools and cluster tables at least as large: each array keeps its
    values in its leading corner and the rest takes fresh ones (dead pool
    slots at the pool's tail, free cluster entries after the used ones),
    which is the state ``p``'s engine would hold had it run the same
    events from the start without a cut.  ``dm_pool`` starts fresh."""
    out = make_pool_state(p, state["n_paths"].device)
    for k, f in out.items():
        if k != "dm_pool":
            f[tuple(slice(0, n) for n in state[k].shape)] = state[k]
    return out


def _block_windows(p: PoolParams, state, means, sb):
    """A block's start: with ``p.handoff``, the state with the promoted
    slots' sw latch cleared and the windows (sb_m, sb_o, sb_armed) its
    events read (nothing armed where ``sb`` is None); else (state, None)."""
    if not p.handoff:
        return state, None
    if sb is None:
        B, T = means.shape
        sb = _zero_windows(B, T, means.device)
    sb_m, sb_o, sb_armed, promote = sb
    state = dict(state)
    state["sw"] = state["sw"] & (~promote)
    return state, (sb_m, sb_o, sb_armed)


def pool_advance_block(idx, p: PoolParams, state, means, on, sb=None):
    """Advance all read slots through T events: means/on are [B, T].

    With ``p.handoff``, ``sb`` = (sb_means [B, W], sb_on [B, W], sb_armed
    [B], promote [B]): the standby windows (0-based event windows of the
    slots' next reads), which slots have one armed, and which switched
    slots the host has promoted to the primary lane (their sw latch
    clears before the first event)."""
    state, win = _block_windows(p, state, means, sb)
    for t in range(means.shape[1]):
        ph = tracing.phases("engine.step")
        state = _pool_event_step(idx, p, state, means[:, t], on[:, t],
                                 sb=win, ph=ph)
        ph.end()
    return state


def _zero_windows(B, T, device):
    """Standby windows with nothing armed: W = 2T zeros, no slot armed,
    none promoted."""
    return (
        torch.zeros((B, 2 * T), dtype=F32, device=device),
        torch.zeros((B, 2 * T), dtype=torch.bool, device=device),
        torch.zeros((B,), dtype=torch.bool, device=device),
        torch.zeros((B,), dtype=torch.bool, device=device),
    )


class PooledEngine:
    """Host wrapper with the JAX PooledEngine's interface (BatchMapper's
    engine), on ``device`` (default: the CUDA card)."""

    READOUT_KEYS = READOUT_KEYS

    def __init__(self, fmi, model, threshes, conf: Conf | None = None,
                 device=None, index=None, **over):
        self.device = resolve(device)
        self.conf = conf or Conf()
        # the JAX engine's accelerator rule: the bitonic sort with its
        # merge kernel on the card, the flat sort on the CPU
        over.setdefault("sort_mode",
                        "bitonic" if self.device.type == "cuda" else "flat")
        # genome-scaled pool caps (the JAX engine's sizing for >= 150 Mb
        # indexes; the 4.7 Mb bench keeps the lean shapes)
        if getattr(fmi, "n", 0) >= 150_000_000:
            over.setdefault("R", 2048)
            over.setdefault("CL", 4096)
            b_ = over.get("B", self.conf.engine.batch_reads)
            over.setdefault("RE", max(2048, 4 * b_))
            over.setdefault("RT", max(12288, 24 * b_))
            if "S" not in over:
                over["S"] = max(4096, b_ * max(
                    512, self.conf.engine.pool_slots_per_read
                ))
        self.params = p = PoolParams.from_conf(self.conf, **over)
        if p.handoff:
            # latched fields and the switch flag ride the packed readout
            self.READOUT_KEYS = READOUT_KEYS + ("sw",) + tuple(
                "lt_" + k for k in LATCH_KEYS)
        self._zero_sb = {}  # (B, T) -> standby windows with nothing armed
        self._blocks = {}  # (T, W) -> the graphs of that block shape
        self.graph_captures = self.graph_steps = self.eager_steps = 0
        self.fmi = fmi
        self.model = model
        # ``index``: an engine's device index, shared (see ``widened``)
        self.idx = index if index is not None else device_index(
            fmi, threshes, model, device=self.device,
            sampled_sa=p.sampled_sa, sa_intv=p.sa_intv,
        )

    def widened(self, **sizes) -> "PooledEngine":
        """An engine like this one with the pool sizes ``sizes`` (fields of
        :class:`PoolParams`, none smaller than this engine's) and the same
        index on the device; its step counters go on from this one's.
        :func:`widen_pool_state` carries a state over to it."""
        eng = PooledEngine(self.fmi, self.model, None, self.conf,
                           device=self.device, index=self.idx,
                           **{**asdict(self.params), **sizes})
        eng.graph_captures = self.graph_captures
        eng.graph_steps = self.graph_steps
        eng.eager_steps = self.eager_steps
        return eng

    def fresh_state(self):
        return make_pool_state(self.params, self.device)

    @tracing.traced("engine.reset")
    def reset_slots(self, state, mask):
        return reset_pool_rows(
            state, torch.as_tensor(np.asarray(mask, bool), device=self.device)
        )

    def check_migrate(self):
        """Raises where this engine's state cannot move to a drain mapper
        (the sharded entry's ``ValueError``); this engine's always can."""

    def migrate(self, state, sel, dst: "PooledEngine"):
        """Relocate reads ``sel`` (numpy [B_dst], -1 = empty) into
        ``dst``'s state shape; see :func:`migrate_pool_state`."""
        self.check_migrate()
        sel = torch.as_tensor(np.asarray(sel, np.int32), device=self.device)
        return migrate_pool_state(self.params, dst.params, state, sel)

    @tracing.traced("engine.advance")
    def advance(self, state, means, on, sb=None):
        """T events for every slot (means/on [B, T]); with the handoff on,
        ``sb`` = (sb_means [B, 2T], sb_on [B, 2T], armed [B], promote [B])
        host arrays, or None for windows with nothing armed (kept on the
        device per (B, T)).

        On the card with an unsharded index (``graphs.eligible``) the first
        block of each shape runs eagerly, and every later one replays the
        step's CUDA graphs (``graphs.BlockGraphs``, captured at the second):
        the state returned is then the runner's buffers, which the next
        ``advance`` overwrites.  ``graph_captures``, ``graph_steps`` and
        ``eager_steps`` count the captures and the events of each path."""
        T = np.shape(means)[1]
        W = 0
        if self.params.handoff:
            W = 2 * T if sb is None else np.shape(sb[0])[1]
        blk = self._blocks.get((T, W))
        if blk is not None:
            self.graph_captures += not blk.captured
            self.graph_steps += T
            return blk.run(state, means, on, sb)
        with tracing.span("engine.upload"):
            means = torch.as_tensor(np.asarray(means, np.float32),
                                    device=self.device)
            on = torch.as_tensor(np.asarray(on, bool), device=self.device)
            if self.params.handoff and sb is not None:
                sb = tuple(
                    torch.as_tensor(np.asarray(a, dt), device=self.device)
                    for a, dt in zip(sb, (np.float32, bool, bool, bool)))
        if self.params.handoff and sb is None:
            key = tuple(means.shape)
            sb = self._zero_sb.get(key)
            if sb is None:
                sb = self._zero_sb[key] = _zero_windows(*key, self.device)
        out = pool_advance_block(self.idx, self.params, state, means, on,
                                 sb=sb)
        self.eager_steps += T
        if graphs.eligible(self.device, self.idx):
            self._blocks[(T, W)] = graphs.BlockGraphs(
                self.idx, self.params, T, W, self.device)
        return out

    def readout_start(self, state):
        return readout_start(state, self.READOUT_KEYS)

    def readout_get(self, packed):
        return readout_get(packed, self.READOUT_KEYS)

    def readout(self, state):
        return self.readout_get(self.readout_start(state))
