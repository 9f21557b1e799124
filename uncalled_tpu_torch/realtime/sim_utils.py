"""Sim pattern builder: reconstruct a ClientSim schedule from real runs.

Role parity with the reference's sim pattern builder
(uncalled/sim_utils.py:20-442): given the sequencing summaries of an
UNCALLED run and a control run plus the UNCALLED PAF, derive the per
channel activity pattern (active intervals between mux scans, short
inter-read gaps, ejection delays) and assign the control run's reads to
channels proportionally to the UNCALLED run's channel activity.

The implementation here is organized around a structured numpy record
table per run (``SeqsumProfile.reads``) and a set of small pure helpers
(block merging, scan assembly, shift arithmetic, proportional allocation)
rather than the reference's parallel attribute arrays and in-place
channel re-sorting; the observable schedule is behavior-identical
(pinned by tests/test_sim_utils.py's golden snapshot).
"""

from __future__ import annotations

import sys
from collections import deque

import numpy as np

from ..pafstats import parse_paf

SAMP_RATE = 4000
PORE_BP_PER_SEC = 450.0

_SEQSUM_FIELDS = [
    ("ch", np.int32),
    ("mux", np.int32),
    ("st", np.float64),
    ("dur", np.float64),
    ("en", np.float64),
    ("tmpl_delay", np.float64),  # template_start - start_time
    ("tmpl_dur", np.float64),
    ("bases", np.int64),
    ("gap_st", np.float64),  # end of the previous read on this channel
    ("gap_len", np.float64),  # idle time before this read
    ("eject_delay", np.float64),  # inf = not ejected
]


def _to_samples(sec: float, speed: float = 1.0) -> int:
    return int(np.round(sec * SAMP_RATE * speed))


# ---------------------------------------------------------------------------
# mux-scan detection
# ---------------------------------------------------------------------------

def _merge_blocks(starts, ends, max_gap):
    """Coalesce time-sorted reads into activity blocks: a new block starts
    when a read begins more than ``max_gap`` after the running block end."""
    run_end = np.maximum.accumulate(ends)
    brk = np.flatnonzero(starts[1:] - run_end[:-1] > max_gap) + 1
    seg = np.concatenate([[0], brk, [len(starts)]])
    return [
        (starts[a], float(np.max(ends[a:b])))
        for a, b in zip(seg[:-1], seg[1:])
    ]


class _ScanAssembler:
    """Stitch dominant-mux activity blocks into 4-block mux scans.

    A scan is four consecutive blocks dominated by mux 1, 2, 3, 4 in
    order.  Blocks may extend the current segment (same mux, close in
    time); a mux-1 block can restart a partial scan; anything else
    resets.  Completed scans keep the idle gaps immediately before and
    after, so the caller can widen each scan window to the surrounding
    quiet period (reference sim_utils.py:20-97).
    """

    def __init__(self, max_intv_gap):
        self.max_gap = max_intv_gap
        self.segs = []  # [(st, en)] of the partial scan, one per mux
        self.lead_gap = 0.0
        self.prev_block_end = 0.0
        self.scans = []  # completed: (segs, lead_gap, tail_gap)

    def _complete(self, tail_gap=None):
        if len(self.segs) == 4:
            if tail_gap is None:
                self.scans.append((self.segs, self.lead_gap, None))
            else:
                self.scans.append((self.segs, self.lead_gap, tail_gap))
        self.segs = []

    def feed(self, bst, ben, mux):
        segs = self.segs
        if segs and bst - segs[-1][1] > self.max_gap:
            self._complete()
            segs = self.segs
        if mux is None:  # no dominant mux: reset (recording the tail gap)
            if len(segs) == 4:
                self._complete(tail_gap=bst - segs[-1][1])
            self.segs = []
        else:
            if mux != 4 and len(segs) == 4:
                self._complete(tail_gap=bst - segs[-1][1])
                segs = self.segs
            if segs and mux == len(segs):
                # same mux as the open segment: extend or restart
                if ben - segs[-1][1] < self.max_gap:
                    segs[-1] = (segs[-1][0], ben)
                elif mux == 1:
                    segs[0] = (bst, ben)
                    self.lead_gap = bst - self.prev_block_end
            elif mux - 1 == len(segs):
                segs.append((bst, ben))
                if len(segs) == 1:
                    self.lead_gap = bst - self.prev_block_end
            else:
                self.segs = []
        self.prev_block_end = ben

    def windows(self):
        return [
            (segs[0][0] - lead, segs[-1][1] + tail)
            for segs, lead, tail in self.scans
            if tail is not None
        ]


def find_scans(sts, ens, mxs, max_block_gap=1, max_intv_gap=20,
               min_mux_frac=0.95):
    """Detect mux-scan windows (incl. surrounding idle time) from read
    start/end/mux arrays.  See _ScanAssembler for the block grammar."""
    order = np.argsort(sts)
    sts, ens, mxs = sts[order], ens[order], mxs[order]
    asm = _ScanAssembler(max_intv_gap)
    for bst, ben in _merge_blocks(sts, ens, max_block_gap):
        in_block = mxs[(sts >= bst) & (sts < ben)]
        counts = np.bincount(in_block, minlength=6)
        # dominant mux must carry >= min_mux_frac of the block's reads;
        # ties break toward the higher mux (reference max((count, mux)))
        top = int(np.flatnonzero(counts == counts.max())[-1])
        dom = top if counts[top] / max(len(in_block), 1) >= min_mux_frac else None
        asm.feed(bst, ben, dom)
    return asm.windows()


# ---------------------------------------------------------------------------
# per-run profile
# ---------------------------------------------------------------------------

class SeqsumProfile:
    """One run's reads as a structured record table (time-sorted)."""

    def __init__(self, fname: str, min_st: float = 0, max_en: float = np.inf,
                 num_channels: int = 512):
        self.num_channels = num_channels
        ids, recs = [], []
        with open(fname) as f:
            header = f.readline().split()
            col = {name: header.index(name) for name in (
                "channel", "start_time", "duration", "mux", "read_id",
                "template_start", "template_duration",
                "sequence_length_template")}
            for line in f:
                t = line.split()
                st = float(t[col["start_time"]])
                dur = float(t[col["duration"]])
                if st < min_st or st + dur > max_en:
                    continue
                ids.append(t[col["read_id"]])
                recs.append((
                    int(t[col["channel"]]), int(t[col["mux"]]), st, dur,
                    st + dur, float(t[col["template_start"]]) - st,
                    float(t[col["template_duration"]]),
                    int(t[col["sequence_length_template"]]),
                    0.0, 0.0, np.inf,
                ))
        reads = np.array(recs, dtype=_SEQSUM_FIELDS)
        order = np.argsort(reads["st"])
        self.reads = reads[order]
        self.ids = np.array(ids, dtype=object)[order]
        self.duration = float(np.max(self.reads["en"])) if len(reads) else 0.0

    # convenience views (time-sorted)
    @property
    def sts(self):
        return self.reads["st"]

    @property
    def ens(self):
        return self.reads["en"]

    @property
    def mxs(self):
        return self.reads["mux"]

    def __len__(self):
        return len(self.reads)

    def channel_counts(self):
        """Reads per channel id 1..num_channels, as an array."""
        return np.bincount(
            self.reads["ch"], minlength=self.num_channels + 1
        )[1:]

    def rm_scans(self):
        """Drop reads inside mux scans and close the time gaps.

        Returns the scan boundary times in the collapsed timeline (one
        per scan, plus the final end-of-run time).  A read straddling a
        scan start keeps its start but its end shifts — the reference
        does the same (sim_utils.py:168-193).
        """
        r = self.reads
        scans = find_scans(r["st"], r["en"], r["mux"])
        if scans:
            scan_st = np.array([s for s, _ in scans])
            scan_en = np.array([e for _, e in scans])
            shift_after = np.concatenate([[0.0], np.cumsum(scan_en - scan_st)])
            inside = np.zeros(len(r), bool)
            for st, en in scans:
                inside |= (r["st"] >= st) & (r["en"] <= en)
            # each time shifts by the total length of scans starting at
            # or before it (searchsorted over scan starts)
            r["st"] -= shift_after[np.searchsorted(scan_st, r["st"], "right")]
            r["en"] -= shift_after[np.searchsorted(scan_st, r["en"], "right")]
            bounds = list(scan_st - shift_after[:-1])
            self.reads = r = r[~inside]
            self.ids = self.ids[~inside]
        else:
            bounds = []
        bounds.append(float(np.max(r["en"])) if len(r) else 0.0)
        return np.array(bounds)

    def compute_gaps(self):
        """Per-channel idle gap before each read (gap_st / gap_len)."""
        r = self.reads
        for ch in range(1, self.num_channels + 1):
            at = np.flatnonzero(r["ch"] == ch)
            if len(at) == 0:
                continue
            prev_en = np.concatenate([[0.0], r["en"][at[:-1]]])
            r["gap_st"][at] = prev_en
            r["gap_len"][at] = r["st"][at] - prev_en

    def compute_eject_delays(self, paf_path: str):
        """Ejection latency per read from the UNCALLED PAF's ej/ub tags:
        observed template time minus (mapped bp at pore speed + decision
        time); inf where the read was not ejected."""
        by_id = {rid: i for i, rid in enumerate(self.ids)}
        r = self.reads
        r["eject_delay"] = np.inf
        for p in parse_paf(paf_path):
            i = by_id.get(p.qr_name)
            if i is None:
                continue
            tag = p.tags.get("ej") or p.tags.get("ub")
            if tag is None:
                continue
            seen = r["dur"][i] - r["tmpl_delay"][i]
            r["eject_delay"][i] = max(
                0, seen - (p.qr_len / PORE_BP_PER_SEC + tag[0])
            )


# ---------------------------------------------------------------------------
# schedule construction
# ---------------------------------------------------------------------------

def _emit_channel_pattern(client, ch, rows, scan_bounds, active_thresh,
                          med_delay, sp):
    """Intervals / gaps / delays for one channel.

    Walks the channel's reads between scan boundaries: every idle period
    >= active_thresh closes an active interval; shorter idles become gap
    entries and ejected reads delay entries within their scan interval
    (reference sim_utils.py:283-340).
    """
    if len(rows) == 0:
        return
    speed = sp.sim_speed
    gap_st = rows["gap_st"]
    gap_len = rows["gap_len"]

    def emit(intv, start_sec, end_sec):
        client.add_intv(
            ch, intv,
            _to_samples(start_sec - scan_bounds[intv], speed),
            _to_samples(end_sec, speed),
        )

    sc = 0
    open_at = 0.0
    for i in np.flatnonzero(gap_len >= active_thresh):
        active_end = gap_st[i]
        while sc + 1 < len(scan_bounds) and scan_bounds[sc + 1] < active_end:
            emit(sc, open_at, sp.scan_intv_time)
            open_at = scan_bounds[sc + 1]
            sc += 1
        if open_at != active_end:
            emit(sc, open_at, active_end - scan_bounds[sc])
        open_at = active_end + gap_len[i]
        while sc + 1 < len(scan_bounds) and scan_bounds[sc + 1] < open_at:
            sc += 1

    last_end = float(np.max(rows["en"]))
    while sc < len(scan_bounds) - 1 and scan_bounds[sc] < last_end:
        emit(sc, open_at,
             min(last_end - scan_bounds[sc], sp.scan_intv_time))
        open_at = scan_bounds[sc + 1]
        sc += 1

    for intv in range(len(scan_bounds) - 1):
        in_intv = (gap_st > scan_bounds[intv]) & (
            gap_st + gap_len <= scan_bounds[intv + 1]
        )
        for ln in gap_len[in_intv]:
            if 0 < ln < active_thresh:
                client.add_gap(ch, intv, _to_samples(ln))
        for dl in rows["eject_delay"][in_intv]:
            if dl != np.inf:
                client.add_delay(ch, intv, _to_samples(med_delay))


def _proportional_targets(weights, total, floor):
    """Integer read targets per slot: a floor per active slot plus the
    remainder split proportionally to ``weights``; rounding drift is
    settled +-1 per slot from the END of the array (this mirrors the
    reference's adjustment order so channel assignment is identical,
    sim_utils.py:372-386)."""
    floored = np.where(weights > 0, float(floor), 0.0)
    ideal = total * weights / max(np.sum(weights), 1)
    room = np.clip(ideal - floored, 0, np.inf)
    share = np.sum(ideal - floored) * room / max(np.sum(room), 1)
    tgt = np.round(floored + share).astype(int)
    step = -1 if np.sum(tgt) > total else 1
    i = len(tgt) - 1
    while np.sum(tgt) != total:
        tgt[i] += step
        i -= 1
    return tgt


def _allocate_reads(unc_counts, ctl_prof):
    """Match control reads to channel slots.

    Channels are ranked by activity in both runs (least active first,
    independently per run — the reference compares the i-th least active
    control channel against the i-th least active UNCALLED channel's
    target, sim_utils.py:388-416); surplus reads from over-provisioned
    slots refill under-provisioned ones through a FIFO pool.

    Returns [(channel_id, [(read_id, template_delay), ...])].
    """
    ctl_counts = ctl_prof.channel_counts()
    # rank both runs least-active-first (reference chsort order)
    unc_rank = np.argsort(unc_counts)
    ctl_rank = np.argsort(ctl_counts)
    targets = _proportional_targets(
        unc_counts[unc_rank], int(np.sum(ctl_counts)),
        ctl_prof._min_ch_reads,
    )
    surplus_rank = np.flip(np.argsort(ctl_counts[ctl_rank] - targets), 0)

    unc_ch = (unc_rank + 1)[surplus_rank]  # destination channel ids
    ctl_ch = (ctl_rank + 1)[surplus_rank]  # source channel ids
    targets = targets[surplus_rank]
    surplus = ctl_counts[ctl_rank][surplus_rank] - targets

    r = ctl_prof.reads
    pool = deque()
    assignment = []
    for dest, src, tgt, extra in zip(unc_ch, ctl_ch, targets, surplus):
        at = np.flatnonzero(r["ch"] == src)
        reads = [
            (ctl_prof.ids[i], float(r["tmpl_delay"][i])) for i in at
        ]
        if extra >= 0:
            take, spare = reads[:tgt], reads[tgt:]
            if extra > 0 and spare:
                pool.append(spare)
        else:
            take = reads
            while len(take) < tgt and pool:
                need = tgt - len(take)
                head = pool[0]
                if len(head) > need:
                    take += head[:need]
                    pool[0] = head[need:]
                else:
                    take += pool.popleft()
            if len(take) < tgt:
                raise RuntimeError(
                    "not enough control reads to fill channels"
                )
        assignment.append((int(dest), take))
    return assignment


def load_sim(client, conf):
    """Populate ``client`` (ClientSim) from conf.simulator's run files."""
    sp = conf.simulator
    n_ch = len(client.channels)

    sys.stderr.write("Loading UNCALLED seqsum...\n")
    unc = SeqsumProfile(sp.unc_seqsum, num_channels=n_ch)
    scan_bounds = unc.rm_scans()
    unc.compute_gaps()
    unc.compute_eject_delays(sp.unc_paf)
    ejected = unc.reads["eject_delay"]
    ejected = ejected[ejected != np.inf]
    med_delay = float(np.median(ejected)) if len(ejected) else 0.0

    sys.stderr.write("Generating pattern...\n")
    gaps = unc.reads["gap_len"]
    active_thresh = float(np.median(gaps) + np.std(gaps))
    for ch in range(1, n_ch + 1):
        _emit_channel_pattern(
            client, ch, unc.reads[unc.reads["ch"] == ch], scan_bounds,
            active_thresh, med_delay, sp,
        )

    sys.stderr.write("Loading control seqsum...\n")
    ctl = SeqsumProfile(sp.ctl_seqsum, num_channels=n_ch)
    ctl.rm_scans()
    ctl._min_ch_reads = sp.min_ch_reads

    sys.stderr.write("Ordering reads...\n")
    for ch, reads in sorted(_allocate_reads(unc.channel_counts(), ctl)):
        for rid, tmpl_delay in reads:
            client.add_read(ch, rid, _to_samples(tmpl_delay))
