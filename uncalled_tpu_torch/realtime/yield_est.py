"""Post-simulation enrichment accounting.

Role parity with the reference's sim_scripts/est_genome_yield.py and
est_bed_yield.py, re-expressed over record tables: the control run's
reads (a :class:`SeqsumProfile` structured array) are JOINED with the
simulation PAF's alignment records, the per-alignment salvage estimate
is computed as one vectorized expression, and the four yield totals are
masked sums — no per-read accumulator walk.

Semantics preserved exactly (tests/test_yield_est.py golden outputs):
an ejected alignment salvages ``bases/sec * (est_bp/450 + delay/4000 +
eject_t - template_delay)`` of its read; a non-ejected alignment keeps
the full (genome mode) or covered/uncovered (BED mode) base counts.
"""

from __future__ import annotations

import sys

import numpy as np

from ..pafstats import parse_paf
from .sim_utils import SeqsumProfile


def ref_seq_names(prefix: str) -> set[str]:
    """Reference sequence names from our index or a BWA .ann file."""
    import os

    if os.path.exists(prefix + ".utidx.npz") or prefix.endswith(".utidx.npz"):
        from ..index.fmindex import FMIndex

        return set(FMIndex.load(prefix).ref_names)
    names = set()
    with open(prefix + ".ann") as f:
        nrefs = int(f.readline().split()[1])
        for _ in range(nrefs):
            names.add(f.readline().split()[1])
            f.readline()
    return names


_ALN_FIELDS = [
    ("row", np.int64),      # index into the control profile's reads table
    ("est_bp", np.float64),  # the mapper's basecalled-length estimate
    ("ejected", bool),
    ("eject_t", np.float64),
    ("delay_t", np.float64),
]


def _aln_table(profile: SeqsumProfile, unc_paf: str) -> np.ndarray:
    """Simulation alignments joined to control-profile rows.

    One record per PAF line whose read id appears in the profile; reads
    with several alignments contribute several records (the reference
    replays every alignment of a read).
    """
    row_of = {rid: i for i, rid in enumerate(profile.ids)}
    recs = []
    for p in parse_paf(unc_paf):
        i = row_of.get(p.qr_name)
        if i is None:
            continue
        ej = p.tags.get("ej", (None, 0))[0]
        dl = p.tags.get("dl", (0, 0))[0]
        recs.append((i, p.qr_len, ej is not None, ej or 0.0, dl))
    return np.array(recs, dtype=_ALN_FIELDS)


def _salvaged_bp(profile: SeqsumProfile, alns: np.ndarray) -> np.ndarray:
    """Per-alignment salvage estimate for EJECTED alignments (garbage for
    the rest — mask before use): the bases sequenced before the eject
    took effect, at the control read's own bases/second rate."""
    rd = profile.reads[alns["row"]]
    bpps = rd["bases"] / rd["tmpl_dur"]
    return bpps * (
        alns["est_bp"] / 450.0 + alns["delay_t"] / 4000.0
        + alns["eject_t"] - rd["tmpl_delay"]
    )


def _report(ut: float, uo: float, ct: float, co: float, sim_speed: float,
            out) -> dict:
    ut, uo, ct, co = (x / 1e6 for x in (ut, uo, ct, co))
    res = {
        "unc_on_bp": ut / sim_speed,
        "unc_total_bp": (ut + uo) / sim_speed,
        "cnt_on_bp": ct,
        "cnt_total_bp": ct + co,
    }
    for k in ("unc_on_bp", "unc_total_bp", "cnt_on_bp", "cnt_total_bp"):
        out.write("%s\t%.6f\n" % (k, res[k]))
    return res


def est_genome_yield(unc_paf: str, seq_sum: str, minimap_paf: str,
                     index_prefix: str, deplete: bool, sim_speed: float = 1.0,
                     out=None):
    """On/off-target base yield with vs without adaptive sampling, where
    "on target" is a whole reference sequence (minimap2 primary hit in /
    out of the index's sequence set, flipped by ``deplete``)."""
    out = out or sys.stdout
    ref_seqs = ref_seq_names(index_prefix)

    ctl = SeqsumProfile(seq_sum)
    ctl.rm_scans()

    # truth: which control reads are on-target, as a [len(ctl)] mask
    tgt_reads = set()
    for p in parse_paf(minimap_paf):
        if p.is_mapped and p.tags.get("tp", ("P",))[0] == "P":
            hit = p.rf_name in ref_seqs
            if hit != deplete:
                tgt_reads.add(p.qr_name)
    on = np.fromiter(
        (rid in tgt_reads for rid in ctl.ids), bool, count=len(ctl)
    )
    bases = ctl.reads["bases"].astype(np.float64)

    alns = _aln_table(ctl, unc_paf)
    a_on = on[alns["row"]] if len(alns) else np.zeros(0, bool)
    a_bases = bases[alns["row"]] if len(alns) else np.zeros(0)
    # ejected: salvage, capped at the read's own length; kept: full read
    unc_bp = np.where(
        alns["ejected"],
        np.minimum(a_bases, _salvaged_bp(ctl, alns)),
        a_bases,
    )
    return _report(
        ut=float(unc_bp[a_on].sum()),
        uo=float(unc_bp[~a_on].sum()),
        ct=float(bases[on].sum()),
        co=float(bases[~on].sum()),
        sim_speed=sim_speed, out=out,
    )


def est_bed_yield(unc_paf: str, cov_bed: str, seq_sum: str,
                  sim_speed: float = 1.0, out=None):
    """Like :func:`est_genome_yield` with per-base BED targets: each read
    carries its covered base count (``bedtools intersect`` output rows
    ``chrom start end read_id``), a kept read splits into covered /
    uncovered bases, and an ejected read's whole salvage lands on
    whichever side the read touches (uncapped, like the reference)."""
    out = out or sys.stdout

    # BED rows -> covered bases per read id
    tgt_bp: dict[str, int] = {}
    with open(cov_bed) as f:
        for line in f:
            t = line.split()
            if len(t) >= 4:
                tgt_bp[t[3]] = tgt_bp.get(t[3], 0) + int(t[2]) - int(t[1])

    ctl = SeqsumProfile(seq_sum)
    ctl.rm_scans()
    bases = ctl.reads["bases"].astype(np.float64)
    on_bp = np.fromiter(
        (tgt_bp.get(rid, 0) for rid in ctl.ids), np.float64, count=len(ctl)
    )

    alns = _aln_table(ctl, unc_paf)
    a_on_bp = on_bp[alns["row"]] if len(alns) else np.zeros(0)
    a_bases = bases[alns["row"]] if len(alns) else np.zeros(0)
    salvage = _salvaged_bp(ctl, alns) if len(alns) else np.zeros(0)
    ej = alns["ejected"]
    # kept alignments split covered/uncovered; ejected ones put the whole
    # salvage on the covered side iff the read has any covered bases
    ut = float(np.where(ej, np.where(a_on_bp > 0, salvage, 0.0),
                        a_on_bp).sum())
    uo = float(np.where(ej, np.where(a_on_bp > 0, 0.0, salvage),
                        a_bases - a_on_bp).sum())
    return _report(
        ut=ut, uo=uo,
        ct=float(on_bp.sum()),
        co=float(bases.sum() - on_bp.sum()),
        sim_speed=sim_speed, out=out,
    )
