"""PAF accuracy/speed statistics over a vectorized record table.

Role parity with the reference's pafstats command (uncalled/pafstats.py):
same confusion-matrix semantics (TP/TN/FP/FN/NA against a ground-truth
PAF, reference intervals extended 1.5x proportionally to the unmapped
query flanks) and the same mt-tag speed summary.  The implementation is
the repo's record-table style: PAF lines parse through a typed column
spec into per-field numpy arrays, and the classification runs as ONE
vectorized pass over the table (the reference classifies entry objects
one at a time in Python).
"""

from __future__ import annotations

import sys

import numpy as np

# core PAF columns: (attr, parser) — query block, then the mapped block
_QCOLS = (("qr_name", str), ("qr_len", int))
_MCOLS = (
    ("qr_st", int), ("qr_en", int), ("is_fwd", lambda s: s == "+"),
    ("rf_name", str), ("rf_len", int), ("rf_st", int), ("rf_en", int),
    ("match_num", int), ("aln_len", int), ("qual", int),
)
_TAG_PARSE = {"f": float, "i": int}


class PafEntry:
    """One PAF record; attributes named by the column spec above."""

    __slots__ = tuple(a for a, _ in _QCOLS + _MCOLS) + ("is_mapped", "tags")

    def __init__(self, line: str):
        t = line.split()
        for (attr, conv), v in zip(_QCOLS, t):
            setattr(self, attr, conv(v))
        self.is_mapped = t[4] != "*"
        if self.is_mapped:
            for (attr, conv), v in zip(_MCOLS, t[2:12]):
                setattr(self, attr, conv(v))
        else:
            # unmapped rows keep the whole query as the "interval" and
            # null mapping fields (what the summary/speed passes expect)
            self.qr_st, self.qr_en = 1, self.qr_len
            for attr, _ in _MCOLS[2:]:
                setattr(self, attr, None)
            self.is_fwd = None
        self.tags = {}
        for s in t[12:]:
            k, typ, v = s.split(":", 2)
            self.tags[k] = (_TAG_PARSE.get(typ, str)(v), typ)

    def get_tag(self, k):
        return self.tags.get(k, (None, None))[0]

    def set_tag(self, k, v, typ="Z"):
        self.tags[k] = (v, typ)

    def ext_ref(self, ext: float):
        """Reference interval grown by ext x the unmapped query flanks
        (strand decides which flank lands on which end)."""
        lo, hi = int(self.qr_st * ext), int((self.qr_len - self.qr_en) * ext)
        if not self.is_fwd:
            lo, hi = hi, lo
        return (max(1, self.rf_st - lo), min(self.rf_len, self.rf_en + hi))

    def overlaps(self, other: "PafEntry", ext: float = 0.0) -> bool:
        if not (self.is_mapped and other.is_mapped):
            return False
        if not self.rf_name.startswith(other.rf_name):
            return False
        st1, en1 = self.ext_ref(ext)
        st2, en2 = other.ext_ref(ext)
        return max(st1, st2) <= min(en1, en2)

    def __str__(self):
        if self.is_mapped:
            core = [self.qr_name, self.qr_len, self.qr_st, self.qr_en,
                    "+" if self.is_fwd else "-", self.rf_name, self.rf_len,
                    self.rf_st, self.rf_en, self.match_num, self.aln_len,
                    self.qual]
        else:
            core = [self.qr_name, self.qr_len] + ["*"] * 10
        parts = [str(x) for x in core] + [
            f"{k}:{typ}:{v}" for k, (v, typ) in self.tags.items()
        ]
        return "\t".join(parts)


def parse_paf(infile, max_load=None):
    if isinstance(infile, str):
        infile = open(infile)
    c = 0
    for line in infile:
        if line.startswith("#") or not line.strip():
            continue
        if max_load is not None and c >= max_load:
            break
        yield PafEntry(line)
        c += 1


def paf_ref_compare(qry, ref, ext: float = 1.5, check_locs: bool = True):
    """Classify query mappings against ground truth: returns
    (tp, tn, fp, fn, na) lists of query entries.

    One vectorized pass: per-query truth rows resolve by name, the
    extended-interval overlap evaluates as array compares over the
    aligned (query row, truth row) pairs."""
    qry = list(qry)
    truth: dict[str, list] = {}
    for r in ref:
        truth.setdefault(r.qr_name, []).append(r)

    # align each mapped query with each of its truth rows -> pair lists
    pair_q, pair_r = [], []
    cls = np.full(len(qry), -1, np.int8)  # 0=tp 1=tn 2=fp 3=fn 4=na
    for i, q in enumerate(qry):
        rs = truth.get(q.qr_name)
        has_truth = rs is not None and rs[0].is_mapped
        if not q.is_mapped:
            cls[i] = 1 if not has_truth else 3
        elif not has_truth:
            cls[i] = 4
        else:
            cls[i] = 2  # fp unless a pair below upgrades it
            for r in rs:
                pair_q.append(i)
                pair_r.append(r)

    if pair_q:
        qi = np.asarray(pair_q)
        q_st = np.empty(len(qi), np.int64)
        q_en = np.empty(len(qi), np.int64)
        r_st = np.empty(len(qi), np.int64)
        r_en = np.empty(len(qi), np.int64)
        name_ok = np.empty(len(qi), bool)
        for j, (i, r) in enumerate(zip(qi, pair_r)):
            q = qry[i]
            name_ok[j] = q.rf_name.startswith(r.rf_name)
            if check_locs:
                q_st[j], q_en[j] = q.ext_ref(ext)
                r_st[j], r_en[j] = r.ext_ref(ext) if r.is_mapped else (0, -1)
        if check_locs:
            hit = name_ok & (
                np.maximum(q_st, r_st) <= np.minimum(q_en, r_en)
            )
        else:
            hit = np.asarray(
                [qry[i].rf_name == r.rf_name for i, r in zip(qi, pair_r)]
            )
        for i in qi[hit]:
            cls[i] = 0
    groups = ([], [], [], [], [])
    for i, c in enumerate(cls):
        groups[c].append(qry[i])
    return groups


def run(infile, ref_paf=None, max_reads=None, annotate=False, out=None):
    out = out or sys.stdout
    statsout = sys.stderr if annotate else out
    locs = list(parse_paf(infile, max_reads))
    if not locs:
        statsout.write("Summary: 0 reads\n")
        return
    mapped = np.asarray([p.is_mapped for p in locs])
    statsout.write(
        "Summary: %d reads, %d mapped (%.2f%%)\n\n"
        % (len(locs), mapped.sum(), 100 * mapped.mean())
    )

    if ref_paf is not None:
        statsout.write("Comparing to reference PAF\n")
        tp, tn, fp, fn, na = paf_ref_compare(locs, parse_paf(ref_paf))
        n = len(locs)
        statsout.write("     P     N\n")
        statsout.write("T %6.2f %5.2f\n" % (100 * len(tp) / n, 100 * len(tn) / n))
        statsout.write("F %6.2f %5.2f\n" % (100 * len(fp) / n, 100 * len(fn) / n))
        statsout.write("NA: %.2f\n\n" % (100 * len(na) / n))
        if annotate:
            for grp, lab in zip((tp, tn, fp, fn, na),
                                ("tp", "tn", "fp", "fn", "na")):
                for p in grp:
                    p.set_tag("rf", lab, "Z")
                    out.write(f"{p}\n")

    if locs[0].get_tag("mt") is not None:
        ms = np.asarray(
            [p.get_tag("mt") for p in locs if p.is_mapped], float
        )
        if len(ms):
            bp = np.asarray([p.qr_en for p in locs if p.is_mapped], float)
            rows = (
                ("BP per sec:", 1000 * bp / ms),
                ("BP mapped: ", bp),
                ("MS to map: ", ms),
            )
            statsout.write("Speed            Mean    Median\n")
            for lab, a in rows:
                statsout.write(
                    "%s %9.2f %9.2f\n" % (lab, np.mean(a), np.median(a))
                )
