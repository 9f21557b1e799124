"""Mapper debugging: per-read dumps + parser.

The reference compiles with -DDEBUG_SEEDS/PATHS/EVENTS to make Mapper write
`<prefix><read>_events.tsv` / `_seeds.bed` dumps (mapper.cpp:873-1078) that
uncalled/debug.py parses for inspection. Here the batched engine's debug tap
(advance_block(..., debug=True)) provides the same information without a
special build: every seed row the tracker saw, per event, plus the event
stream and normalization.

dump_read() writes the reference-shaped files; DebugParser reads them back.
"""

from __future__ import annotations

import os

import numpy as np

from .kmer import K, kmer_to_str


def dump_read(bm, read, dbg_prefix: str, max_events: int = 0):
    """Map one read with full debug taps; writes
    `<prefix><read_id>_events.tsv` and `<prefix><read_id>_seeds.bed`.

    Returns (paf, n_seed_rows)."""
    import torch

    from .mapping.engine import MapEngine, advance_block

    slot = bm._prepare(read)
    means = slot.means
    if max_events:
        means = means[:max_events]
    eng = bm.eng
    if not isinstance(eng, MapEngine):
        # the per-event debug tap is a classic-engine feature; build a
        # wide classic engine for the dump (P=2048 covers the measured
        # p90 of honest-read path demand; raise via conf for monsters)
        if not hasattr(bm, "_dbg_engine"):
            bm._dbg_engine = MapEngine(
                bm.fmi, bm.model, bm.threshes, bm.conf,
                device=bm.eng.device, B=1, P=2048, C=2048, R=512, CL=2048,
            )
        eng = bm._dbg_engine
    state = eng.fresh_state()
    mask = np.zeros(eng.params.B, bool)
    mask[0] = True
    state = eng.reset_slots(state, mask)
    T = len(means)
    pad = np.zeros((eng.params.B, T), np.float32)
    on = np.zeros((eng.params.B, T), bool)
    pad[0, :] = means
    on[0, :] = True
    state, dbg = advance_block(
        eng.idx, eng.params, state,
        torch.as_tensor(pad, device=eng.device),
        torch.as_tensor(on, device=eng.device), debug=True,
    )
    dbg = {k: v.cpu().numpy() for k, v in dbg.items()}

    os.makedirs(os.path.dirname(dbg_prefix) or ".", exist_ok=True)
    base = dbg_prefix + read.id

    # _events.tsv: event index, normalized mean (reference dbg_events_out)
    with open(base + "_events.tsv", "w") as f:
        f.write("evt\tnorm_mean\n")
        for i, m in enumerate(means):
            f.write(f"{i}\t{m:.5f}\n")

    # _seeds.bed: ref name, start, end, evt, move count (dbg_seeds_out shape)
    ref_en = np.asarray(dbg["seed_ref_en"])[:, 0, :]
    mc = np.asarray(dbg["seed_mc"])[:, 0, :]
    evt = np.asarray(dbg["seed_evt"])[:, 0, :]
    dec = np.asarray(dbg["dec"])[:, 0]
    n = bm.fmi.n
    n_rows = 0
    with open(base + "_seeds.bed", "w") as f:
        for t in range(T):
            for r in range(ref_en.shape[1]):
                if ref_en[t, r] < 0:
                    continue
                sa_en = int(ref_en[t, r])
                ln = int(mc[t, r]) + K - 1
                fwd = sa_en - ln + 1 < n // 2
                loc = sa_en - ln + 1 if fwd else n - sa_en - K + 1
                name, off, _ = bm.fmi.translate_loc(max(loc, 0))
                f.write(
                    f"{name}\t{off}\t{off + ln}\t{int(evt[t, r])}\t"
                    f"{int(mc[t, r])}\t{'+' if fwd else '-'}\n"
                )
                n_rows += 1
            if dec[t]:
                break

    # _paths.tsv: the per-event path DAG (mapper.cpp:1016-1078 layout):
    # id=evt:slot, parent=prev_evt:slot (self when source), fm_start,
    # fm_len, kmer, full_len (events since path birth), match_prob
    # (newest event's match prob), moves bitstring (newest first)
    P = eng.params.P
    SL = eng.params.seed_len
    p_par = np.asarray(dbg["p_parent"])[:, 0, :]
    p_st = np.asarray(dbg["p_fm_start"])[:, 0, :]
    p_ln = np.asarray(dbg["p_fm_len"])[:, 0, :]
    p_km = np.asarray(dbg["p_kmer"])[:, 0, :]
    p_tot = np.asarray(dbg["p_total"])[:, 0, :]
    p_pr = np.asarray(dbg["p_prob"])[:, 0, :]
    p_mv = np.asarray(dbg["p_moves"])[:, 0, :]
    with open(base + "_paths.tsv", "w") as f:
        f.write(
            "id\tparent\tfm_start\tfm_len\tkmer\tfull_len\tmatch_prob\t"
            "moves\n"
        )
        for t in range(T):
            for j in range(P):
                if p_tot[t, j] <= 0:
                    continue
                par = int(p_par[t, j])
                parent = f"{t - 1}:{par}" if par < P else f"{t}:{j}"
                nbits = min(int(p_tot[t, j]), SL)
                moves = "".join(
                    str((int(p_mv[t, j]) >> b) & 1) for b in range(nbits)
                )
                f.write(
                    f"{t}:{j}\t{parent}\t{p_st[t, j]}\t{p_ln[t, j]}\t"
                    f"{kmer_to_str(int(p_km[t, j]))}\t{p_tot[t, j]}\t"
                    f"{p_pr[t, j]:.5f}\t{moves or 0}\n"
                )
            if dec[t]:
                break

    ro = eng.readout(state)
    paf = bm._finalize(slot, ro, 0)
    return paf, n_rows


class DebugParser:
    """Parse dump_read() outputs back into arrays (uncalled/debug.py role)."""

    def __init__(self, dbg_prefix: str, read_id: str):
        base = dbg_prefix + read_id
        self.events = np.loadtxt(
            base + "_events.tsv", skiprows=1, dtype=np.float64
        ).reshape(-1, 2)
        seeds = []
        with open(base + "_seeds.bed") as f:
            for line in f:
                name, st, en, evt, mc, strand = line.split()
                seeds.append((name, int(st), int(en), int(evt), int(mc),
                              strand == "+"))
        self.seeds = seeds
        # path DAG: {(evt, slot): row dict}; absent file = dump predates
        # the paths tap
        self.paths = {}
        if os.path.exists(base + "_paths.tsv"):
            with open(base + "_paths.tsv") as f:
                next(f)
                for line in f:
                    pid, parent, fm_st, fm_ln, kmer, full, prob, mv = (
                        line.split()
                    )
                    evt, slot = (int(x) for x in pid.split(":"))
                    pevt, pslot = (int(x) for x in parent.split(":"))
                    self.paths[(evt, slot)] = dict(
                        parent=(pevt, pslot), fm_start=int(fm_st),
                        fm_len=int(fm_ln), kmer=kmer, full_len=int(full),
                        match_prob=float(prob), moves=mv,
                    )

    def path_ancestry(self, evt: int, slot: int):
        """Walk a path's parent chain back to its source (the reference
        debug flow reconstructs seed ancestry the same way from
        _paths.tsv parent ids)."""
        chain = []
        key = (evt, slot)
        while key in self.paths:
            row = self.paths[key]
            chain.append((key, row))
            if row["parent"] == key:
                break
            key = row["parent"]
        return chain

    def seed_clusters(self, max_evt_gap: int = 50):
        """Greedy re-clustering of the dumped seeds (debug.py:543-652 role):
        groups seeds whose ref/evt deltas look collinear."""
        clusters = []
        for name, st, en, evt, mc, fwd in sorted(self.seeds, key=lambda s: s[3]):
            placed = False
            for cl in clusters:
                if cl["name"] != name or cl["fwd"] != fwd:
                    continue
                dre = en - cl["en"]
                dev = evt - cl["evt"]
                if 0 <= dre <= max(dev, 0) and dev <= max_evt_gap:
                    cl["en"] = max(cl["en"], en)
                    cl["evt"] = evt
                    cl["n"] += 1
                    cl["len"] += max(dre, 0)
                    placed = True
                    break
            if not placed:
                clusters.append(
                    dict(name=name, st=st, en=en, evt=evt, fwd=fwd, n=1,
                         len=en - st)
                )
        return sorted(clusters, key=lambda c: -c["len"])


# ---------------------------------------------------------------------------
# basecalled-alignment comparison (reference debug.py:520-549)
# ---------------------------------------------------------------------------

import re as _re

_CIG_RE = _re.compile(r"(\d+)([MIDNSHP=X])")
_CIG_INCR_RD = set("MIS=X")
_CIG_INCR_RF = set("MDN=X")


def cigar_query_to_refs(paf_entry):
    """query-bp -> [ref offsets] from a basecalled PAF's cg cigar
    (reference debug.py:520-549 _cig_query_to_refs).  Ref offsets are
    relative to the alignment's rf_st; returns None without a cigar."""
    cig = paf_entry.tags.get("cg", (None,))[0]
    if cig is None:
        return None
    ops = _CIG_RE.findall(cig)
    if not paf_entry.is_fwd:
        ops = list(reversed(ops))
    qr_rfs: dict[int, list[int]] = {}
    qr_i, rf_i = paf_entry.qr_st, 0
    for l, c in ops:
        l = int(l)
        incr_qr = c in _CIG_INCR_RD
        incr_rf = c in _CIG_INCR_RF
        qr_j = qr_i + (l if incr_qr else 1)
        rf_j = rf_i + (l if incr_rf else 1)
        for qr, rf in zip(range(qr_i, qr_j), range(rf_i, rf_j)):
            qr_rfs.setdefault(qr, []).append(rf)
        if incr_qr:
            qr_i = qr_j
        if incr_rf:
            rf_i = rf_j
    return qr_rfs


BCE_STRIDE = 5  # samples per basecalled-event move slot (ref debug.py:16)
BCE_K = 4  # basecaller k-mer length (ref debug.py:17)


def bc_aln_from_moves(bc_paf, bce_samp_st: int, bce_moves_packed,
                      min_samp: int = 0, max_samp: int | None = None):
    """Per-sample reference coordinates from a guppy MOVE TABLE — the
    reference's basecalled-alignment debug layer (debug.py:483-517
    parse_bc_aln): each move-table slot covers BCE_STRIDE raw samples;
    the cumulative move count is the basecalled query coordinate, which
    the minimap2 cigar (cigar_query_to_refs) places on the reference.
    The result is the (sample -> reference position) series used to
    adjudicate mapper-vs-basecaller disagreement visually.

    ``bce_moves_packed`` is the packed-bit move table as stored by guppy
    (np.uint8 array; np.unpackbits order, one bit per stride slot);
    ``bce_samp_st`` the raw sample index of the first slot.  Returns
    (samples[N] i64, refs[N] i64) with refs shifted to k-mer starts
    (``- BCE_K + 1``, matching the reference), or None without a cigar.
    """
    qr_to_rfs = cigar_query_to_refs(bc_paf)
    if not qr_to_rfs:
        return None
    moves = np.unpackbits(np.asarray(bce_moves_packed, np.uint8))
    if max_samp is not None:
        bce_en = int((max_samp - bce_samp_st + 1) // BCE_STRIDE)
        moves = moves[:bce_en]
    bce_qrs = np.cumsum(moves)
    samps = bce_samp_st + BCE_STRIDE * np.arange(len(bce_qrs), dtype=np.int64)
    out_s: list[int] = []
    out_r: list[int] = []
    for samp, qr in zip(samps, bce_qrs):
        if samp < min_samp:
            continue
        for rf in qr_to_rfs.get(int(qr), ()):
            out_s.append(int(samp))
            out_r.append(int(rf))
    return (
        np.asarray(out_s, np.int64),
        np.asarray(out_r, np.int64) - BCE_K + 1,
    )


def compare_seeds_to_basecall(parser: "DebugParser", bc_paf_path: str,
                              read_id: str, bp_per_evt: float = 0.45):
    """Score dumped seeds against a basecalled alignment (the reference
    debug flow's ground-truthing): for each seed, translate its event
    index to an approximate query bp (bp_per_evt ~ pore rate / event
    rate), look up where the cigar places that query position on the
    reference, and report the distance.  Returns a list of dicts plus
    summary stats; None if no cigar alignment exists for the read."""
    from .pafstats import parse_paf

    bc = None
    for p in parse_paf(bc_paf_path):
        if p.qr_name == read_id and p.is_mapped:
            bc = p
            break
    if bc is None:
        return None
    qr_rfs = cigar_query_to_refs(bc)
    if not qr_rfs:
        return None

    rows = []
    errs = []
    for name, st, en, evt, mc, fwd in parser.seeds:
        if name != bc.rf_name:
            rows.append(dict(evt=evt, seed_st=st, err=None, off_ref=True))
            continue
        qr = int(evt * bp_per_evt)
        refs = qr_rfs.get(qr)
        if refs is None:
            # nearest cigar-covered query position
            near = min(qr_rfs, key=lambda q: abs(q - qr), default=None)
            refs = qr_rfs.get(near, [])
        if not refs:
            continue
        expect = bc.rf_st + (
            refs[0] if bc.is_fwd else (bc.rf_en - bc.rf_st) - refs[0]
        )
        err = min(abs(st - expect), abs(en - expect))
        rows.append(dict(evt=evt, seed_st=st, expect=expect, err=err,
                         off_ref=False))
        errs.append(err)
    errs = np.asarray(errs)
    summary = dict(
        n_seeds=len(rows),
        n_scored=len(errs),
        median_err=float(np.median(errs)) if len(errs) else None,
        frac_within_100=float((errs <= 100).mean()) if len(errs) else None,
    )
    return rows, summary
