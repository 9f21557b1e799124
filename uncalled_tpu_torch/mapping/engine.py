"""The classic batched mapping engine and the helpers both engines share,
in PyTorch (port of ``uncalled_tpu.mapping.engine``).

The helper layer (the device index tables, FM-index occurrence counts and
backward extension, the clz threshold bin, the f64 match probabilities,
the seed-tracker row update and decision, the packed per-read readout)
serves ``pooled._pool_event_step`` and the classic step alike.  The
classic engine ``MapEngine`` advances B reads through one event per step
with fixed per-read budgets ([B, P] paths, C candidates, R seed rows, a
[B, CL] cluster table): it is the entry engine of ``BatchMapper`` with
``conf.engine.pooled = False`` and every rung of the remap ladder.  On the
card its gathers run on the ``row_gather`` kernel, its seed-row fold on
``tracker_fold_rows`` and, with ``sampled_sa``, its SA lookup on
``sa_lookup``; the step does no host synchronisation.  Every
function is bit-exact to its JAX counterpart (tests/test_torch_engine.py,
tests/test_torch_classic_step.py).

Integer rules: every integer tensor is int32 as in the JAX package;
unsigned 32-bit word arithmetic (popcounts, logical shifts) runs on int64
with a 32-bit mask, because torch has no popcount and shifts int32
arithmetically.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing
from ..config import Conf
from ..convert import index_from_numpy
from ..device import resolve
from ..kmer import KMER_COUNT
from ..ops.mxu_gather import row_gather, row_gather_cols, shared_gather
from ..ops.sa_lookup import sa_lookup
from ..ops.seg_scan import seg_running_max
from ..ops.shard_take import shard_take

I32, F32, F64 = torch.int32, torch.float32, torch.float64
INT32_MAX = 2**31 - 1
NEG = -(2**30)
_EVEN = 0x55555555
_U32 = 0xFFFFFFFF


def f32_const(x: float) -> float:
    """``x`` rounded to float32, as JAX's weakly typed python floats compare
    against f32 arrays (a float32 value, whatever the promotion rules)."""
    return float(np.float32(x))


def index_arrays(fmi, threshes, model, sampled_sa=False, sa_intv=32) -> dict:
    """The device index tables as numpy: interleaved occ bucket rows
    ``[ckpt_A, ckpt_C, ckpt_G, ckpt_T, word0, word1]`` per 32-base block,
    the full SA (``"sa"``) or, with ``sampled_sa``, its every
    ``sa_intv``-th row (``"sa_samp"``, looked up by LF-walk), k-mer ranges,
    L2, thresholds and the pore-model tables."""
    nb = (fmi.n + 31) // 32
    words = np.zeros(2 * nb, dtype=np.uint32)
    words[: len(fmi.bwt_words)] = fmi.bwt_words
    occ_rows = np.zeros((nb, 6), dtype=np.int32)
    occ_rows[:, :4] = fmi.ckpt[:nb]
    occ_rows[:, 4] = words[0::2].view(np.int32)
    occ_rows[:, 5] = words[1::2].view(np.int32)
    if sampled_sa:
        sa_arrs = {"sa_samp": np.asarray(fmi.sa_full[::sa_intv],
                                         dtype=np.int32)}
    else:
        sa_arrs = {"sa": np.asarray(fmi.sa_full, dtype=np.int32)}
    return {
        "occ_rows": occ_rows,
        **sa_arrs,
        "kmer_st": np.asarray(fmi.kmer_ranges[:, 0], dtype=np.int32),
        "kmer_en": np.asarray(fmi.kmer_ranges[:, 1], dtype=np.int32),
        "kmer_rng2": np.asarray(fmi.kmer_ranges[:, :2], dtype=np.int32),
        "L2": np.asarray(fmi.L2, dtype=np.int32),
        "threshes": np.asarray(threshes, dtype=np.float32),
        "means": np.asarray(model.means, dtype=np.float32),
        "vars_x2": np.asarray(model.vars_x2, dtype=np.float32),
        "lognorm": np.asarray(model.lognorm_denoms, dtype=np.float32),
        "n": int(fmi.n),
        "primary": int(fmi.primary),
    }


def device_index(fmi, threshes, model, device=None, sampled_sa=False,
                 sa_intv=32):
    """Index tables for one index + model + threshold preset, on ``device``
    (default: the CUDA card).  With ``sampled_sa`` the full int32 SA stays
    on the host and the device keeps a 1/``sa_intv`` row sample; the steps
    look SA rows up by LF-walk (``ops.sa_lookup``)."""
    return index_from_numpy(
        index_arrays(fmi, threshes, model, sampled_sa, sa_intv),
        device=resolve(device),
    )


# ---------------------------------------------------------------------------
# bit helpers
# ---------------------------------------------------------------------------

def _u32(x: torch.Tensor) -> torch.Tensor:
    """The 32 bits of an int32 tensor as a non-negative int64."""
    return x.to(torch.int64) & _U32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Population count of the 32 bits of ``x`` (SWAR on int64) -> int32."""
    v = _u32(x)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & _U32) >> 24).to(I32)


# ---------------------------------------------------------------------------
# FM-index primitives
# ---------------------------------------------------------------------------

def _shard_take(idx, key, rows):
    """Row gather from a possibly row-sharded table (port of the JAX
    ``_shard_take``).  With no shard context in ``idx`` it is the plain
    take; under the sharded engines (``idx["shard"]``, a
    :class:`~uncalled_tpu_torch.ops.shard_take.ShardContext`) each idx rank
    answers the rows of its block (the ``shard_take`` kernel on the card)
    and a sum over the idx group (``ShardContext.all_reduce``) combines
    the answers."""
    tbl = idx[key]
    sh = idx.get("shard")
    if sh is None:
        return tbl.index_select(0, rows.reshape(-1)).reshape(
            rows.shape + tbl.shape[1:])
    return sh.all_reduce(
        shard_take(tbl, rows.contiguous(), sh.rank * tbl.shape[0]))


def _occ(idx, k, c):
    """# occurrences of base c in BWT rows [0, k] (BWA bwt_occ semantics:
    k<0 -> 0, k>=n -> full count, rows >= primary shift by one because the
    sentinel is not stored).  k/c int32 of any (equal) shape."""
    n, primary = idx["n"], idx["primary"]
    kk = torch.where(k >= primary, k - 1, k).clamp(0, n - 1)
    row = _shard_take(idx, "occ_rows", kk >> 5)  # [*, 6] bucket row
    return _occ_count(idx, k, c, kk, row)


def _occ_count(idx, k, c, kk, row):
    """:func:`_occ` from the bucket row ``row`` ([*, 6]) that holds BWT
    index ``kk`` (k shifted past the primary row and clamped to [0, n))."""
    n = idx["n"]
    is_neg = k < 0
    is_full = k >= n
    oh4 = c[..., None] == torch.arange(4, dtype=I32, device=k.device)
    base_cnt = torch.where(oh4, row[..., :4], 0).sum(-1, dtype=I32)
    rem = kk & 31
    pat = (_u32(c) * _EVEN) & _U32

    def count_word(word_i32, inc):
        x = _u32(word_i32) ^ pat
        nx = (~x) & _U32
        m = nx & (nx >> 1) & _EVEN
        # include the first `inc` (MSB-first) bases of the word
        sh = (16 - inc.clamp(0, 16).to(torch.int64)) * 2
        pm = torch.bitwise_left_shift(torch.full_like(sh, _U32), sh) & _U32
        pm = torch.where(inc <= 0, 0, pm)
        pm = torch.where(inc >= 16, _U32, pm)
        return popcount32(m & pm)

    out = base_cnt + count_word(row[..., 4], rem + 1) + count_word(
        row[..., 5], rem - 15
    )
    l2diff = idx["L2"][1:5] - idx["L2"][0:4]  # per-base totals, [4]
    full_cnt = torch.where(oh4, l2diff, 0).sum(-1, dtype=I32)
    out = torch.where(is_full, full_cnt, out)
    return torch.where(is_neg, 0, out)


def _extend(idx, start, end, base):
    """Backward-extend FM intervals (bwa_index.hpp:158-162); the two occ
    probes (start-1 and end) run as one doubled-shape _occ call."""
    q = torch.cat([start - 1, end])
    o2 = _occ(idx, q, torch.cat([base, base]))
    n0 = start.shape[0]
    os_, oe = o2[:n0], o2[n0:]
    oh4 = base[..., None] == torch.arange(4, dtype=I32, device=base.device)
    L2b = torch.where(oh4, idx["L2"][:4], 0).sum(-1, dtype=I32)
    return L2b + os_ + 1, L2b + oe


def _fm_bin(fmlen):
    """64 - bit_length(fmlen): the clz-based threshold bin
    (mapper.cpp:161-167), as bit smear + popcount."""
    x = _u32(fmlen.clamp(min=1))
    for s in (1, 2, 4, 8, 16):
        x = x | (x >> s)
    return 64 - popcount32(x)


def _match_probs(idx, ev, exact):
    """[B, 1024] log match probs with the reference's f32/f64 choreography
    (pore_model.hpp:163-165): the difference in f32, squared in f64."""
    d = ev[:, None].to(F32) - idx["means"][None, :]
    if exact:
        d64 = d.to(F64)
        return (
            -(d64 * d64) / idx["vars_x2"].to(F64) - idx["lognorm"].to(F64)
        ).to(F32)
    return -(d * d) / idx["vars_x2"] - idx["lognorm"]


def _ring_read(ring, slot):
    """``ring[..., slot[...]]`` with the JAX one-hot-sum result: a selected
    -0.0 reads as +0.0 and an out-of-range slot reads 0."""
    width = ring.shape[-1]
    ok = (slot >= 0) & (slot < width)
    v = torch.gather(
        ring, -1, slot.clamp(0, width - 1).to(torch.int64)[..., None]
    )[..., 0]
    return torch.where(ok & (v != 0), v, torch.zeros((), dtype=ring.dtype,
                                                      device=ring.device))


# ---------------------------------------------------------------------------
# seed tracker (SeedTracker::add_seed, seed_tracker.cpp:157-232)
# ---------------------------------------------------------------------------

TRACKER_KEYS = (
    "cl_valid", "cl_count", "cl_ref_st", "cl_r1", "cl_r2e",
    "cl_evt_st", "cl_evt_en", "cl_total", "len_sum", "n_cl",
    "mm_len", "mm_ref_st", "mm_r1", "mm_r2e", "mm_evt_st", "mm_evt_en",
    "ovf", "ovf_why",
)


def _tracker_add(p, st, ref_en, mc, evt, row_ok):
    """Add one seed row per read (all [B]) to the [B, CL] cluster tables."""
    r2 = ref_en - mc + 1  # new.ref_en_start
    r2e = ref_en  # new.ref_en_end
    e2 = evt

    v = st["cl_valid"]
    r1 = st["cl_r1"]
    e1 = st["cl_evt_en"]
    tot = st["cl_total"]
    CL = v.shape[1]
    iota = torch.arange(CL, dtype=I32, device=v.device)[None, :]

    considered = v & (
        (r1 < r2[:, None]) | ((r1 == r2[:, None]) & (e1 <= e2[:, None]))
    )
    dr = r2[:, None] - r1
    de = e2[:, None] - e1
    in_range = (e1 <= e2[:, None]) & (dr <= de) & (
        dr >= torch.div(de, 12, rounding_mode="floor")
    )
    elig = considered & in_range

    # the reference scan's pick: max total_len, ties -> largest r1, then
    # largest evt_en, then the first index
    m1 = torch.where(elig, tot, NEG).amax(1)
    t1 = elig & (tot == m1[:, None])
    m2 = torch.where(t1, r1, NEG).amax(1)
    t2 = t1 & (r1 == m2[:, None])
    m3 = torch.where(t2, e1, NEG).amax(1)
    t3 = t2 & (e1 == m3[:, None])
    any_match = elig.any(1) & row_ok
    match_idx = torch.argmax(t3.to(I32), 1).to(I32)  # first True
    onehot = (iota == match_idx[:, None]) & any_match[:, None]

    # SeedCluster::update (seed_tracker.cpp:56-73)
    a_r2e = st["cl_r2e"]
    overlaps = r2[:, None] < a_r2e
    grows = r2e[:, None] > a_r2e
    growth = torch.where(
        overlaps, torch.where(grows, r2e[:, None] - a_r2e, 0), mc[:, None]
    )
    new_r1 = torch.where(onehot, r2[:, None], r1)
    new_r2e = torch.where(onehot & (grows | ~overlaps), r2e[:, None], a_r2e)
    new_e1 = torch.where(onehot, e2[:, None], e1)
    new_tot = torch.where(onehot, tot + growth, tot)
    upd_len = torch.where(onehot, growth, 0).sum(1, dtype=I32)

    # set-reinsertion collision quirk (oracle.py:168-173): the updated
    # cluster is dropped from the matchable set ("zombie") but keeps
    # counting in all_lens
    occupied = st["cl_count"]
    coll = (
        v & (~onehot) & (r1 == r2[:, None]) & (e1 == e2[:, None])
    ).any(1)
    lost = any_match & coll

    # insertion when no match: a free slot, else evict the smallest
    do_insert = row_ok & ~any_match
    free = ~occupied
    evict_key = torch.where(free, NEG, tot)
    ins_idx = torch.argmin(evict_key, 1).to(I32)  # first min
    ins1h = (iota == ins_idx[:, None]) & do_insert[:, None]
    evicted_len = torch.where(ins1h & occupied, tot, 0).sum(1, dtype=I32)
    evicted_n = (ins1h & v).sum(1, dtype=I32)

    out = dict(st)
    if "ovf" in st:
        evict = do_insert & ~free.any(1)
        out["ovf"] = st["ovf"] | evict
        out["ovf_why"] = st["ovf_why"] | evict.to(I32)
    out["cl_valid"] = (v & ~(lost[:, None] & onehot) & ~ins1h) | ins1h
    out["cl_count"] = occupied | ins1h
    out["cl_r1"] = torch.where(ins1h, r2[:, None], new_r1)
    out["cl_r2e"] = torch.where(ins1h, r2e[:, None], new_r2e)
    out["cl_ref_st"] = torch.where(ins1h, r2[:, None], st["cl_ref_st"])
    out["cl_evt_st"] = torch.where(ins1h, e2[:, None], st["cl_evt_st"])
    out["cl_evt_en"] = torch.where(ins1h, e2[:, None], new_e1)
    out["cl_total"] = torch.where(ins1h, mc[:, None], new_tot)

    out["len_sum"] = (
        st["len_sum"]
        + torch.where(any_match, upd_len, 0).to(F32)
        + torch.where(do_insert, mc, 0).to(F32)
        - evicted_len.to(F32)
    )
    out["n_cl"] = st["n_cl"] + do_insert.to(I32) - evicted_n - lost.to(I32)

    # max_map: replace when a cluster's length changed and exceeds it
    def sum1h(a):
        return torch.where(onehot, a, 0).sum(1, dtype=I32)

    cand_len = torch.where(
        any_match, sum1h(new_tot), torch.where(do_insert, mc, NEG)
    )
    changed = torch.where(any_match, upd_len > 0, do_insert)
    better = changed & (cand_len >= p.min_aln_len) & (cand_len > st["mm_len"])
    src = {
        "mm_len": cand_len,
        "mm_ref_st": torch.where(any_match, sum1h(out["cl_ref_st"]), r2),
        "mm_r1": torch.where(any_match, sum1h(out["cl_r1"]), r2),
        "mm_r2e": torch.where(any_match, sum1h(out["cl_r2e"]), r2e),
        "mm_evt_st": torch.where(any_match, sum1h(out["cl_evt_st"]), e2),
        "mm_evt_en": torch.where(any_match, sum1h(out["cl_evt_en"]), e2),
    }
    for k, val in src.items():
        out[k] = torch.where(better, val, st[k])
    return out


def _tracker_decide(p, st):
    """SeedTracker::get_final (seed_tracker.cpp:129-143).  Float divisions
    are unguarded on purpose, as in the reference (inf/nan compare the same
    way)."""
    tot = torch.where(st["cl_count"], st["cl_total"], NEG)
    first_i = torch.argmax(tot, 1)
    masked = torch.where(
        torch.arange(tot.shape[1], device=tot.device)[None, :]
        == first_i[:, None],
        NEG, tot,
    )
    second = masked.amax(1)
    top = st["mm_len"].to(F32)
    mean = st["len_sum"] / st["n_cl"].to(F32)
    n_lens = st["cl_count"].sum(1, dtype=I32)  # all_lens incl. zombies
    ok = (st["mm_len"] >= p.min_aln_len) & (n_lens >= 2)
    conf = torch.zeros_like(ok)
    if p.min_mean_conf > 0:
        conf = conf | (top / mean >= f32_const(p.min_mean_conf))
    if p.min_top_conf > 0:
        conf = conf | (top / second.to(F32) >= f32_const(p.min_top_conf))
    return ok & conf


# ---------------------------------------------------------------------------
# packed [K, B] readout
# ---------------------------------------------------------------------------

READOUT_KEYS = (
    "done", "success", "dec_evt", "evt_i", "ovf", "ovf_why",
    "dm_flags", "dm_valid", "dm_paths", "dm_rows", "dm_cl",
    "mm_len", "mm_ref_st", "mm_r1", "mm_r2e", "mm_evt_st", "mm_evt_en",
)


@tracing.traced("engine.readout_issue")
def readout_start(state, keys=READOUT_KEYS):
    """The per-read lifecycle and decision fields packed as one [K, B] int32
    tensor (one device-to-host copy per block)."""
    return torch.stack([state[k].to(I32) for k in keys])


def readout_get(packed, keys=READOUT_KEYS) -> dict:
    """A :func:`readout_start` result -> host numpy dict (bools restored).
    The copy is the host's one wait on the device."""
    with tracing.span("engine.readout_wait"):
        host = packed.cpu()
    out = dict(zip(keys, host.numpy()))
    for k in ("done", "success", "ovf", "sw", "lt_success", "lt_ovf"):
        if k in out:
            out[k] = out[k].astype(bool)
    return out


# ---------------------------------------------------------------------------
# sort key and segmented running max (both steps)
# ---------------------------------------------------------------------------

def _f32_sort_key(x):
    """int32 key reproducing lax.sort's f32 order exactly: monotone
    sign-magnitude flip, +/-0 equal (key 0), every NaN equal and largest
    (key INT32_MAX): -inf < finite (-0 == +0) < +inf < nan."""
    i = x.view(I32)
    mono = i ^ torch.where(i < 0, INT32_MAX, 0).to(I32)
    return torch.where(
        torch.isnan(x), INT32_MAX, torch.where(x == 0, 0, mono)
    ).to(I32)


# ---------------------------------------------------------------------------
# the classic engine: parameters and state
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EngineParams:
    """Static parameters of the classic engine (the JAX EngineParams
    fields)."""

    B: int = 64  # read slots
    P: int = 1024  # path budget per read
    C: int = 1024  # candidate budget per event (pre-dedup children)
    CE: int = 0  # candidate extension width (>= C; 0 = auto C + C//4)
    R: int = 256  # seed SA-row budget per event
    CL: int = 1024  # seed-cluster table capacity
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
    # TPU routing flag of the JAX engine, kept so the two EngineParams
    # accept the same overrides; the port ignores it (on the card every
    # gather runs on the row_gather kernel, on the CPU on its plain version)
    mxu: bool = False
    sampled_sa: bool = False
    sa_intv: int = 32

    @staticmethod
    def from_conf(conf: Conf, **over) -> "EngineParams":
        mp, st, en = conf.mapper, conf.seed_tracker, conf.engine
        kw = dict(
            B=en.batch_reads,
            P=en.max_paths,
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
        return EngineParams(**kw)


def make_state(p: EngineParams, device="cpu"):
    """Fresh engine state for B empty read slots (the JAX state's keys and
    dtypes)."""
    B, P, CL = p.B, p.P, p.CL

    def z(*s):
        return torch.zeros(s, dtype=I32, device=device)

    def zb(*s):
        return torch.zeros(s, dtype=torch.bool, device=device)

    return {
        # path table; p_total = 0 marks an empty slot
        "p_start": z(B, P),
        "p_end": z(B, P),
        "p_kmer": z(B, P),
        "p_total": z(B, P),
        "p_consec": z(B, P),
        "p_moves": z(B, P),
        "p_sa": zb(B, P),
        "p_cum": torch.zeros((B, P, p.seed_len + 1), dtype=F32,
                             device=device),  # cumulative-sum ring
        # seed-cluster table (cl_count: the length still counts, zombies
        # included; cl_valid: matchable)
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
        # sticky budget overflow: 1=CL evict, 2=CE flags, 4=C candidates,
        # 8=P paths, 16=R seed rows
        "ovf": zb(B),
        "ovf_why": z(B),
        # sticky per-read demand maxima (exact until the first cut)
        "dm_flags": z(B),
        "dm_valid": z(B),
        "dm_paths": z(B),
        "dm_rows": z(B),
        "dm_cl": z(B),
    }


def reset_rows(state, mask):
    """Reset read slots where mask[B] is True: fresh (zero) state there, and
    done=False."""
    B = mask.shape[0]
    out = {}
    for k, v in state.items():
        m = mask.view((B,) + (1,) * (v.dim() - 1))
        out[k] = torch.where(m, torch.zeros((), dtype=v.dtype,
                                            device=v.device), v)
    out["done"] = state["done"] & ~mask
    return out


# ---------------------------------------------------------------------------
# classic step helpers
# ---------------------------------------------------------------------------

def _compact_idx(valid, w_out):
    """Stable-compaction gather indices: src[j] = index of the j-th True of
    valid[B, W] (order kept; W-1 past the count), ok[j] = j < count.  The
    JAX sort of (index if valid else W) moves the True indices to the front
    in order; here each True index is scattered to its rank."""
    B, W = valid.shape
    dev = valid.device
    rank = torch.cumsum(valid, 1, dtype=I32) - 1
    tgt = torch.where(valid, rank, W).to(torch.int64)
    src = torch.full((B, W + 1), W, dtype=I32, device=dev)
    src.scatter_(1, tgt, torch.arange(W, dtype=I32, device=dev).expand(B, W))
    skey = src[:, : min(w_out, W)]
    return skey.clamp(max=W - 1), skey < W


def _sort_perm(k1, k2, kf):
    """Row-wise permutation of ``lax.sort((k1, k2, kf, iota), dimension=1,
    num_keys=4)``: ascending by the int32 keys k1, k2, then the f32 key kf
    in lax.sort's order, ties in index order.  Two stable passes: kf, then
    (k1, k2) packed into one int64 key."""
    o1 = torch.sort(_f32_sort_key(kf), dim=1, stable=True).indices
    k12 = (k1.to(torch.int64) << 32) + (k2.to(torch.int64) + 2**31)
    o2 = torch.sort(torch.gather(k12, 1, o1), dim=1, stable=True).indices
    return torch.gather(o1, 1, o2).to(I32)


def _path_seedprob(p: EngineParams, st):
    """Each live path's seed_prob_ recomputed from the cumulative-sum ring
    (identical f32 ops to the values stored at child creation)."""
    SL = p.seed_len
    RING = SL + 1
    tot = st["p_total"]
    cum_now = _ring_read(st["p_cum"], tot % RING)
    wslot = torch.where(tot >= SL, (tot - SL) % RING, 0)
    wstart = _ring_read(st["p_cum"], wslot)
    return torch.where(
        tot >= SL,
        (cum_now - wstart) / SL,
        cum_now / tot.clamp(min=1).to(F32),
    )


# ---------------------------------------------------------------------------
# per-event step (the batched map_next, mapper.cpp:433-663)
# ---------------------------------------------------------------------------

def _event_step(idx, p: EngineParams, st, ev, ev_on, debug=False):
    from ..ops.tracker_kernel import tracker_run

    dev = ev.device
    B, P, C, R, SL = p.B, p.P, p.C, p.R, p.seed_len
    # CE: physical candidate width; the budget C counts only FM-valid
    # candidates (mapper.cpp:486-510)
    CE = p.CE if p.CE else C + max(C // 4, 256)
    CE = min(CE, 5 * P)  # cannot exceed the flag count
    KMASK = KMER_COUNT - 1
    KQ = KMER_COUNT // 4
    PATH_MASK = (1 << SL) - 1
    TAIL_MOVE = 1 << (SL - 1)
    RING = SL + 1
    n = idx["n"]
    stay_frac_max = f32_const(p.max_stay_frac * SL)
    min_seed_prob = f32_const(p.min_seed_prob)

    def iota(m):
        return torch.arange(m, dtype=I32, device=dev)

    def nxt(a, fill):
        return torch.cat(
            [a[:, 1:], torch.full((B, 1), fill, dtype=a.dtype, device=dev)], 1
        )

    alive = (~st["done"]) & ev_on
    probs = _match_probs(idx, ev, p.exact_probs)  # [B, 1024]

    # ---- candidate flags in creation order (stay, then moves A..T) ----
    pv = st["p_total"] > 0
    fmlen = st["p_end"] - st["p_start"] + 1
    # one F=4 gather of 3P rows: a path's 4 move probs are one row of
    # probs viewed [B, 256, 4]; the stay prob and the fm-bin threshold are
    # one lane of such a row (thresholds after the prob rows: a second
    # segment, shared by every read)
    NT4 = idx["threshes"].shape[0] // 4
    tbl4 = [probs.reshape(B, KQ, 4),
            idx["threshes"].reshape(NT4, 4)[None].expand(B, NT4, 4)]
    fm_bin = _fm_bin(fmlen)
    allk3 = torch.cat(
        [st["p_kmer"] >> 2, st["p_kmer"] & (KQ - 1), KQ + (fm_bin >> 2)], 1
    )
    g3 = row_gather(tbl4, allk3)  # [B, 3P, 4]
    # the JAX lane pick is a one-hot sum: a selected -0.0 reads +0.0
    stay_p = _ring_read(g3[:, :P], st["p_kmer"] & 3)
    mv_p = g3[:, P: 2 * P]
    thresh = _ring_read(g3[:, 2 * P:], fm_bin & 3)
    stay_f = pv & (st["p_consec"] < p.max_consec_stay) & (stay_p >= thresh)
    # NaN-threshold polarity parity (mapper.cpp:471,489)
    mv_f = pv[:, :, None] & ~(mv_p < thresh[:, :, None])
    flags = torch.cat([stay_f[:, :, None], mv_f], 2)  # [B, P, 5]

    # ---- compact to CE candidate slots in creation order ----
    flat = flags.reshape(B, P * 5)
    pos = torch.cumsum(flat, 1, dtype=I32) - flat.to(I32)
    cidx, cval = _compact_idx(flat, CE)
    cpar = torch.where(cval, torch.div(cidx, 5, rounding_mode="trunc"), P)
    move = torch.where(cval, cidx % 5, 0)  # 0 = stay, 1..4 = move base+1
    cpar_g = cpar.clamp(max=P - 1)

    # ---- parent state (two ring slots per parent ride the pack) ----
    cumnow_p = _ring_read(st["p_cum"], st["p_total"] % RING)
    wslot_p = torch.where(
        st["p_total"] + 1 >= SL, (st["p_total"] + 1 - SL) % RING, 0
    )
    wstart_p = _ring_read(st["p_cum"], wslot_p)
    cs, ce, ck, ctot, ccons, cmvs, csa, ccum, cwst = row_gather_cols(
        [st["p_start"], st["p_end"], st["p_kmer"], st["p_total"],
         st["p_consec"], st["p_moves"], st["p_sa"], cumnow_p, wstart_p],
        cpar_g,
    )

    is_mv = move >= 1
    base = (move - 1).clamp(0, 3)
    nk = torch.where(is_mv, ((ck << 2) & KMASK) | base, ck)
    ns_m, ne_m = _extend(idx, cs, ce, base)
    ns = torch.where(is_mv, ns_m, cs)
    ne = torch.where(is_mv, ne_m, ce)
    cv_fm = cval & ((~is_mv) | (ns <= ne))
    # exact budget: the reference appends only FM-valid candidates and
    # breaks at max_paths appended (mapper.cpp:455-520)
    vpos = torch.cumsum(cv_fm, 1, dtype=I32) - cv_fm.to(I32)
    cvalid = cv_fm & (vpos < C)
    total_valid_fm = cv_fm.sum(1, dtype=I32)

    prob = row_gather(probs, nk)
    new_tot = ctot + 1
    newcum = ccum + prob  # f32, the reference's sums_[l] = sums_[l-1]+prob
    seedprob = torch.where(
        new_tot >= SL, (newcum - cwst) / SL, newcum / new_tot.to(F32)
    )
    nmoves = ((cmvs << 1) | is_mv.to(I32)) & PATH_MASK
    nmoves = torch.where(ctot >= SL, nmoves | TAIL_MOVE, nmoves)
    nconsec = torch.where(is_mv, 0, ccons + 1)

    # ---- ended parents (no budget-kept valid child, reached before the
    # candidate budget filled; mapper.cpp:455-520) ----
    k_i = pos[:, ::5]  # compacted position of each parent's stay slot
    n_flags = pos[:, -1] + flat[:, -1].to(I32)
    k_next = torch.cat([k_i[:, 1:], n_flags[:, None]], 1)
    vpos_pad = torch.cat([vpos, total_valid_fm[:, None]], 1)
    vb2 = row_gather(vpos_pad, torch.cat([k_i, k_next], 1).clamp(max=CE))
    vb, vb_next = vb2[:, :P], vb2[:, P:]
    child_any = vb_next.clamp(max=C) > vb.clamp(max=C)
    reached = (k_i < CE) & (vb < C)
    pmc = popcount32(st["p_moves"])
    pseedprob = _path_seedprob(p, st)
    ended = pv & (~child_any) & (~st["p_sa"]) & reached & alive[:, None]
    e_rep = (fmlen <= p.max_rep_copy) & (pmc >= p.min_rep_len)
    e_unique = (
        (fmlen == 1)
        & ((st["p_moves"] & 1) == 1)
        & ((SL - pmc) <= stay_frac_max)
    )
    e_valid = (
        ended
        & (st["p_total"].clamp(max=SL) == SL)
        & (pseedprob >= min_seed_prob)
        & (e_unique | e_rep)
    )
    e_rows = torch.where(e_valid, fmlen.clamp(max=p.max_rep_copy), 0)

    # ---- sort candidates by (fm_start, fm_end, seed_prob, creation) ----
    k1 = torch.where(cvalid, ns, INT32_MAX)
    k2 = torch.where(cvalid, ne, INT32_MAX)
    perm = _sort_perm(k1, k2, seedprob)
    ns_s, ne_s, seedprob_s, nk_s, prob_s, ntot_s, nmoves_s = row_gather_cols(
        [k1, k2, seedprob, nk, prob, new_tot, nmoves], perm
    )
    svalid = ns_s != INT32_MAX

    dup = (
        svalid
        & nxt(svalid, False)
        & (ns_s == nxt(ns_s, -1))
        & (ne_s == nxt(ne_s, -1))
    )

    # ---- candidate seed validity (non-ended branch of is_seed_valid) ----
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

    # ---- seed rows: ended groups (parent order) then candidates ----
    g_st = torch.cat([st["p_start"], ns_s], 1)  # [B, P+CE]
    g_rows = torch.cat([e_rows, seed_c.to(I32)], 1)
    g_mc = torch.cat([pmc, smc], 1)
    g_evt = torch.cat(
        [(st["evt_i"] - 1)[:, None].expand(B, P),
         st["evt_i"][:, None].expand(B, CE)], 1
    )
    g_cum = torch.cumsum(g_rows, 1, dtype=I32)
    total_rows = g_cum[:, -1]
    row_ids = iota(R)
    # grp[b, r] = #{g_cum[b] <= r} (the JAX compare-count; g_cum is sorted)
    grp = torch.searchsorted(
        g_cum, row_ids[None, :].expand(B, R).contiguous(), right=True,
        out_int32=True,
    ).clamp(max=P + CE - 1)
    row_ok = (row_ids[None, :] < total_rows[:, None]) & alive[:, None]
    g_cum_prev, g_st_g, row_mc, row_evt = row_gather_cols(
        [torch.cat([torch.zeros((B, 1), dtype=I32, device=dev),
                    g_cum[:, :-1]], 1), g_st, g_mc, g_evt],
        grp,
    )
    sa_row = (g_st_g + (row_ids[None, :] - g_cum_prev)).clamp(0, n)
    if p.sampled_sa:
        ref_en = n - sa_lookup(idx, sa_row, p.sa_intv)
    else:
        ref_en = n - _shard_take(idx, "sa", sa_row)

    # the row fold: each read's rows r < total_rows in order (rows_r = 0
    # for reads that do not advance)
    tstate = tracker_run(
        p.min_aln_len, {k: st[k] for k in TRACKER_KEYS}, ref_en, row_mc,
        row_evt, row_ok, torch.where(alive, total_rows, 0),
    )

    # ---- sources (mapper.cpp:544-624) ----
    source_prob = idx["threshes"][0]
    kpass = prob_s >= source_prob
    prev_k = torch.cat(
        [torch.full((B, 1), -1, dtype=I32, device=dev), nk_s[:, :-1]], 1
    )
    first_seg = svalid & (nk_s != prev_k)
    seg_id = torch.cumsum(first_seg, 1, dtype=I32)
    run_end = seg_running_max(seg_id, ne_s)

    km_rng = shared_gather(idx["kmer_rng2"], nk_s)  # [B, CE, 2]
    km_st = km_rng[:, :, 0]
    km_en = km_rng[:, :, 1]
    head_st = km_st
    head_en = ns_s - 1
    head_v = first_seg & kpass & (head_st <= head_en)

    nxt_same = nxt(svalid, False) & (nxt(nk_s, -1) == nk_s)
    gap_st = run_end + 1
    gap_en = torch.where(nxt_same, nxt(ns_s, 0) - 1, km_en)
    gap_v = svalid & (~dup) & kpass & (gap_st <= gap_en)

    # presence of a k-mer among the candidates: a scatter of cvalid into a
    # [B, 1024] bitmap (an OR, so order does not matter; the JAX step's
    # broadcast compare-any over [B, CE, 1024] is the same function)
    hit = cvalid & (nk >= 0) & (nk < KMER_COUNT)
    present = torch.zeros((B, KMER_COUNT + 1), dtype=torch.bool, device=dev)
    present.scatter_(1, torch.where(hit, nk, KMER_COUNT).to(torch.int64),
                     torch.ones_like(hit))
    present = present[:, :KMER_COUNT]
    full_v = (
        (~present)
        & (probs >= source_prob)
        & (idx["kmer_st"] <= idx["kmer_en"])[None, :]
    )

    # ---- assemble the new path table in the reference's creation order:
    # children (sorted, deduped), head/gap sources interleaved, full
    # sources; source slots start at n_cands (the reference's
    # budget_left() counts all sorted candidates, dups included) ----
    child_keep = svalid & (~dup)
    n_cands = svalid.sum(1, dtype=I32)
    hg_v = torch.stack([head_v, gap_v], 2).reshape(B, 2 * CE)
    src_concat = torch.cat([hg_v, full_v], 1)

    def inter(h, g):
        return torch.stack([h, g.expand_as(h)], 2).reshape(B, 2 * CE)

    def bc(a):
        return a[None, :].expand(B, KMER_COUNT).to(I32)

    src_start = torch.cat([inter(head_st, gap_st), bc(idx["kmer_st"])], 1)
    src_end = torch.cat([inter(head_en, gap_en), bc(idx["kmer_en"])], 1)
    src_kmer = torch.cat([inter(nk_s, nk_s), bc(iota(KMER_COUNT))], 1)
    src_prob = torch.cat([inter(prob_s, prob_s), probs], 1)

    # merge children + sources by gather: slot j holds child j
    # (j < n_nondup) or source j - n_cands
    child_src, child_ok = _compact_idx(child_keep, P)
    src_src, src_ok = _compact_idx(src_concat, P)
    out_j = iota(P)[None, :]
    as_child = child_ok
    k_src = (out_j - n_cands[:, None]).clamp(0, P - 1)
    src_of, src_hit = row_gather_cols([src_src, src_ok], k_src)
    src_okj = src_hit & (out_j >= n_cands[:, None])
    # child fields in two hops: sorted-order fields by child_src, then
    # candidate-order fields by the composed index ci = perm[child_src]
    c_start, c_end, c_kmer, c_tot, c_mvs, c_seedc, ci = row_gather_cols(
        [ns_s, ne_s, nk_s, ntot_s, nmoves_s, seed_c, perm], child_src
    )
    c_cons, c_sa0, c_newcum, c_par = row_gather_cols(
        [nconsec, csa, newcum, cpar_g], ci
    )
    c_sa = c_sa0 | c_seedc
    child_ring0 = row_gather(st["p_cum"], c_par)  # [B, P, RING]
    ring_iota = iota(RING)[None, None, :]
    child_ring = torch.where(
        ring_iota == (c_tot % RING)[:, :, None], c_newcum[:, :, None],
        child_ring0,
    )
    s_start, s_end, s_kmer, s_prob = row_gather_cols(
        [src_start, src_end, src_kmer, src_prob], src_of
    )
    # a source's ring is zeros with slot 1 = prob, built as the JAX step
    # builds it: (lane == 1) * prob, so the other lanes read 0 * prob
    src_ring = (ring_iota == 1).to(F32) * torch.where(
        src_okj, s_prob, 0.0
    )[:, :, None]
    new_paths = {
        "p_start": torch.where(as_child, c_start,
                               torch.where(src_okj, s_start, 0)),
        "p_end": torch.where(as_child, c_end, torch.where(src_okj, s_end, -1)),
        "p_kmer": torch.where(as_child, c_kmer,
                              torch.where(src_okj, s_kmer, 0)),
        "p_total": torch.where(as_child, c_tot, src_okj.to(I32)),
        "p_consec": torch.where(as_child, c_cons, 0),
        "p_moves": torch.where(as_child, c_mvs, src_okj.to(I32)),
        "p_sa": as_child & c_sa,
        "p_cum": torch.where(as_child[:, :, None], child_ring, src_ring),
    }

    # ---- merge, decide, advance lifecycle ----
    out = dict(st)
    for part in (new_paths, tstate):
        for k, v in part.items():
            m = alive.view((B,) + (1,) * (v.dim() - 1))
            out[k] = torch.where(m, v, st[k])

    # budget-overflow detection: any event where a fixed width cut work
    # the reference's loop would do (no flag: the result provably equals
    # the wide engine's)
    n_src = src_concat.sum(1, dtype=I32)
    cut_flags = n_flags > CE
    cut_valid = total_valid_fm > C
    cut_paths = (n_cands + n_src) > P
    cut_rows = total_rows > R
    out["ovf"] = out["ovf"] | (
        (cut_flags | cut_valid | cut_paths | cut_rows) & alive
    )
    why = (
        cut_flags.to(I32) * 2 | cut_valid.to(I32) * 4
        | cut_paths.to(I32) * 8 | cut_rows.to(I32) * 16
    )
    out["ovf_why"] = out["ovf_why"] | torch.where(alive, why, 0)

    def upd(cur, v):
        return torch.maximum(cur, torch.where(alive, v, 0))

    out["dm_flags"] = upd(st["dm_flags"], n_flags)
    out["dm_valid"] = upd(st["dm_valid"], total_valid_fm)
    out["dm_paths"] = upd(st["dm_paths"], n_cands + n_src)
    out["dm_rows"] = upd(st["dm_rows"], total_rows)
    out["dm_cl"] = upd(st["dm_cl"], out["n_cl"])

    dec = _tracker_decide(p, out) & alive
    out["done"] = st["done"] | dec
    out["success"] = st["success"] | dec
    out["dec_evt"] = torch.where(dec, st["evt_i"], st["dec_evt"])
    out["evt_i"] = st["evt_i"] + alive.to(I32)
    if not debug:
        return out
    # the per-event debug taps (debug.py), computed only when asked: every
    # seed row the tracker saw, and the path-DAG snapshot for the _paths.tsv
    # dump (mapper.cpp:1016-1078): parent slot in the PREVIOUS table (P = no
    # parent / source) and each path's newest match prob
    (c_prob,) = row_gather_cols([prob], ci)
    dbg = {
        "seed_ref_en": torch.where(row_ok, ref_en, -1),
        "seed_mc": row_mc,
        "seed_evt": row_evt,
        "seed_rows": total_rows,
        "n_paths": (new_paths["p_total"] > 0).sum(1, dtype=I32),
        "n_cand": cvalid.sum(1, dtype=I32),
        "dec": dec,
        "p_parent": torch.where(as_child, c_par, P),
        "p_prob": torch.where(as_child, c_prob,
                              torch.where(src_okj, s_prob, 0.0)),
        "p_fm_start": new_paths["p_start"],
        "p_fm_len": new_paths["p_end"] - new_paths["p_start"] + 1,
        "p_kmer": new_paths["p_kmer"],
        "p_total": new_paths["p_total"],
        "p_moves": new_paths["p_moves"],
    }
    return out, dbg


def advance_block(idx, p: EngineParams, state, means, on, debug=False):
    """Advance all read slots through T events: means/on are [B, T]; on[b, t]
    marks a real event for slot b at step t.  With ``debug`` returns
    (state, dbg), each debug tap stacked [T, B, ...]."""
    if not debug:
        for t in range(means.shape[1]):
            state = _event_step(idx, p, state, means[:, t], on[:, t])
        return state
    taps = []
    for t in range(means.shape[1]):
        state, dbg = _event_step(idx, p, state, means[:, t], on[:, t],
                                 debug=True)
        taps.append(dbg)
    if not taps:
        return state, {}
    return state, {k: torch.stack([d[k] for d in taps]) for k in taps[0]}


class MapEngine:
    """Host wrapper of the classic engine with the JAX MapEngine's
    interface (BatchMapper's engine), on ``device`` (default: the CUDA
    card).

        eng = MapEngine(fmi, model, threshes, conf)
        state = eng.fresh_state()
        state = eng.advance(state, means, on)   # [B, T] f32 / bool
        host  = eng.readout(state)              # numpy dict
    """

    READOUT_KEYS = READOUT_KEYS

    def __init__(self, fmi, model, threshes, conf: Conf | None = None,
                 device=None, **over):
        self.device = resolve(device)
        self.conf = conf or Conf()
        self.params = p = EngineParams.from_conf(self.conf, **over)
        self.fmi = fmi
        self.model = model
        self.idx = device_index(
            fmi, threshes, model, device=self.device,
            sampled_sa=p.sampled_sa, sa_intv=p.sa_intv,
        )

    def fresh_state(self):
        return make_state(self.params, self.device)

    def reset_slots(self, state, mask):
        return reset_rows(
            state, torch.as_tensor(np.asarray(mask, bool), device=self.device)
        )

    def advance(self, state, means, on):
        means = torch.as_tensor(np.asarray(means, np.float32),
                                device=self.device)
        on = torch.as_tensor(np.asarray(on, bool), device=self.device)
        return advance_block(self.idx, self.params, state, means, on)

    def readout_start(self, state):
        return readout_start(state, self.READOUT_KEYS)

    def readout_get(self, packed):
        return readout_get(packed, self.READOUT_KEYS)

    def readout(self, state):
        return self.readout_get(self.readout_start(state))
