"""The plain reference mapper: one read at a time, on the host.

A frozen copy of the port's sequential oracle
(``uncalled_tpu_torch.mapping.oracle.OracleMapper``, stable tie order),
which follows UNCALLED's per-read mapping state machine
(mapper.cpp:433-663 ``map_next``, seed_tracker.cpp:157-232) and gives the
reference rig's PAF lines.  It reads only what the benchmark makes: the
read's raw signal, the reference's own index (``fm.RefFM``) and
thresholds (``params``), the pore model file and the configuration's
parameters.  ``hi`` is the precision the reference keeps in float64
(event detection, normalization, match probabilities); the control runs
it at float32.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np

from .events import detect_events, normalize

F32 = np.float32
F64 = np.float64
K = 5
KMER_COUNT = 4 ** K


class Paf:
    """A PAF record with the ch and st tags, formatted as the port's
    ``Paf.to_line``."""

    def __init__(self, name, channel, start_sample):
        self.rd_name = name
        self.rd_len = 0
        self.is_mapped = False
        self.tags = [("ch", int(channel)), ("st", int(start_sample))]

    def set_mapped(self, rd_st, rd_en, rf_name, rf_st, rf_en, rf_len, fwd,
                   matches):
        self.is_mapped = True
        self.core = (int(rd_st), int(rd_en), "+" if fwd else "-", rf_name,
                     int(rf_len), int(rf_st), int(rf_en), int(matches),
                     int(rf_en) - int(rf_st) + 1, 255)

    def to_line(self) -> str:
        if self.is_mapped:
            core = (self.rd_name, self.rd_len) + self.core
        else:
            core = (self.rd_name, self.rd_len) + ("*",) * 9 + (255,)
        return "\t".join([str(x) for x in core]
                         + [f"{t}:i:{v}" for t, v in self.tags])


def kmer_comp(kmer):
    return kmer ^ (KMER_COUNT - 1)


def pore_model(path: str) -> SimpleNamespace:
    """The complement-indexed r9.4.1 model the mapper scores with
    (pore_model.hpp:39-203): level means and 2 sd^2 by complemented k-mer,
    log normalisers, and the level means' mean and stdv accumulated in
    float32 in table order (the normalizer's targets)."""
    d = np.load(path)
    means0 = d["level_mean"].astype(F32)
    sds0 = d["level_stdv"].astype(F32)
    idx = kmer_comp(np.arange(KMER_COUNT))
    means = np.empty_like(means0)
    sds = np.empty_like(sds0)
    means[idx] = means0
    sds[idx] = sds0
    vars_x2 = (2.0 * sds * sds).astype(F32)
    lognorm = np.log(np.sqrt(np.pi * vars_x2.astype(F64))).astype(F32)
    mm = F32(0.0)
    for v in means[idx]:
        mm += v
    mm = F32(mm / F32(KMER_COUNT))
    ms = F32(0.0)
    for v in means:
        d = F64(F32(v - mm))
        ms = F32(F64(ms) + d * d)
    ms = F32(np.sqrt(ms / F32(KMER_COUNT)))
    return SimpleNamespace(means=means, vars_x2=vars_x2,
                           lognorm_denoms=lognorm, means_mean=float(mm),
                           means_stdv=float(ms))


def match_probs(samp, means, vars_x2, lognorm, hi=F64):
    """match_prob of every k-mer: f32 subtraction, pow and divide in
    ``hi``, f32 store (pore_model.hpp:163-165)."""
    d = (F32(samp) - means).astype(F32).astype(hi)
    return (-(d * d) / vars_x2.astype(hi) - lognorm.astype(hi)).astype(F32)


@dataclass
class SeedCluster:
    ref_st: int
    ref_en_start: int
    ref_en_end: int
    evt_st: int
    evt_en: int
    total_len: int

    def sort_key(self):
        # std::set ordered by decreasing ref_en_.start, then decreasing evt_en
        return (-self.ref_en_start, -self.evt_en)


class SeedTracker:
    def __init__(self, prms):
        self.prms = prms
        self.reset()

    def reset(self):
        self.clusters: list[SeedCluster] = []  # kept sorted by sort_key
        self.all_lens: list[int] = []  # multiset of cluster lengths (sorted)
        self.len_sum = 0.0
        self.max_map: SeedCluster | None = None

    def _insert_len(self, ln):
        bisect.insort(self.all_lens, ln)

    def _remove_len(self, ln):
        i = bisect.bisect_left(self.all_lens, ln)
        del self.all_lens[i]

    def add_seed(self, ref_en: int, ref_len: int, evt_st: int):
        new = SeedCluster(ref_en - ref_len + 1, ref_en - ref_len + 1,
                          ref_en, evt_st, evt_st, ref_len)
        keys = [c.sort_key() for c in self.clusters]
        i = bisect.bisect_left(keys, new.sort_key())

        e2, r2 = new.evt_en, new.ref_en_start
        match_idx = -1
        j = i
        while j < len(self.clusters):
            c = self.clusters[j]
            e1, r1 = c.evt_en, c.ref_en_start
            higher_sup = match_idx < 0 or self.clusters[match_idx].total_len < c.total_len
            in_range = (
                e1 <= e2 and (r2 - r1) <= (e2 - e1) and (r2 - r1) >= (e2 - e1) // 12
            )
            if higher_sup and in_range:
                match_idx = j
            elif r2 - r1 >= e2:
                break
            j += 1

        if match_idx >= 0:
            a = self.clusters.pop(match_idx)
            prev_len = a.total_len
            # SeedCluster::update (seed_tracker.cpp:56-73)
            if new.ref_en_start < a.ref_en_end:
                if new.ref_en_end > a.ref_en_end:
                    growth = new.ref_en_end - a.ref_en_end
                    a.ref_en_start, a.ref_en_end = new.ref_en_start, new.ref_en_end
                else:
                    growth = 0
                    a.ref_en_start = new.ref_en_start
            else:
                growth = new.total_len
                a.ref_en_start, a.ref_en_end = new.ref_en_start, new.ref_en_end
            a.evt_en = new.evt_en
            a.total_len += growth

            if a.total_len != prev_len:
                self.len_sum += a.total_len - prev_len
                self._remove_len(prev_len)
                self._insert_len(a.total_len)
                if (a.total_len >= self.prms.min_aln_len and
                        (self.max_map is None or a.total_len > self.max_map.total_len)):
                    self.max_map = SeedCluster(**vars(a))
            # reinsert (set semantics: drop if an equivalent key exists)
            keys = [c.sort_key() for c in self.clusters]
            k = a.sort_key()
            ins = bisect.bisect_left(keys, k)
            if ins < len(keys) and keys[ins] == k:
                return a  # insertion failed; cluster silently lost
            self.clusters.insert(ins, a)
            return a
        else:
            self._insert_len(new.total_len)
            self.len_sum += new.total_len
            if (new.total_len >= self.prms.min_aln_len and
                    (self.max_map is None or new.total_len > self.max_map.total_len)):
                self.max_map = SeedCluster(**vars(new))
            k = new.sort_key()
            ins = bisect.bisect_left(keys, k)
            if ins < len(keys) and keys[ins] == k:
                return new  # set insert fails; stats already updated (parity)
            self.clusters.insert(ins, new)
            return new

    def get_final(self) -> SeedCluster | None:
        if (self.max_map is None or self.max_map.total_len < self.prms.min_aln_len
                or len(self.all_lens) < 2):
            return None
        mean_len = self.len_sum / len(self.clusters)
        second_len = self.all_lens[-2]
        top = self.max_map.total_len
        p = self.prms
        if (p.min_mean_conf > 0 and top / mean_len >= p.min_mean_conf) or (
            p.min_top_conf > 0 and top / second_len >= p.min_top_conf
        ):
            return self.max_map
        return None


class RefMapper:
    """Maps one whole-signal read at a time.  ``prm`` is the
    configuration's ``conf`` object (its event_detector, seed_tracker,
    mapper and reads sections)."""

    def __init__(self, fmi, model, threshes, prm: dict, hi=F64):
        self.fmi = fmi
        self.model = model
        self.threshes = np.asarray(threshes, F32)
        self.hi = hi
        self.mp = SimpleNamespace(**prm["mapper"])
        self.st = SimpleNamespace(**prm["seed_tracker"])
        self.min_mean = prm["event_detector"]["min_mean"]
        self.max_mean = prm["event_detector"]["max_mean"]
        rd = prm["reads"]
        self.bp_per_samp = float(rd["bp_per_sec"]) / rd["sample_rate"]
        self.path_mask = (1 << self.mp.seed_len) - 1
        self.tail_move = 1 << (self.mp.seed_len - 1)

    def thresh_of(self, fmlen):
        return self.threshes[64 - int(fmlen).bit_length()]

    def map_read(self, read) -> Paf:
        mp = self.mp
        fmi = self.fmi
        model = self.model
        hi = self.hi

        paf = Paf(read.id, read.channel, read.start_sample)
        # f32 product then truncation (read_buffer.cpp:263-266)
        paf.rd_len = int(F32(F32(len(read.signal)) * F32(self.bp_per_samp)))

        means, total_events, len_sum = detect_events(
            read.signal, self.min_mean, self.max_mean, hi)
        if total_events == 0:
            return paf
        mean_evt_len = F32(len_sum) / F32(total_events)

        # global normalization over all event means (Normalizer::set_signal)
        # onto the pore model's own level mean and stdv (mapper.cpp:94)
        n = len(means)
        if n == 0:
            return paf
        norm_means = normalize(means, model.means_mean, model.means_stdv, hi)

        tracker = SeedTracker(self.st)
        # path state arrays (structure-of-arrays over live paths)
        p_start = np.zeros(0, dtype=np.int64)
        p_end = np.zeros(0, dtype=np.int64)
        p_kmer = np.zeros(0, dtype=np.int64)
        p_len = np.zeros(0, dtype=np.int64)
        p_consec = np.zeros(0, dtype=np.int64)
        p_moves = np.zeros(0, dtype=np.int64)
        p_sa_checked = np.zeros(0, dtype=bool)
        p_sums = np.zeros((0, mp.seed_len + 1), dtype=F32)
        p_seedprob = np.zeros(0, dtype=F32)

        kmer_st = fmi.kmer_ranges[:, 0]
        kmer_en = fmi.kmer_ranges[:, 1]
        source_prob = self.threshes[0]
        fmsize = fmi.n

        def is_seed_valid(length, seedprob, fmlen, moves, ended):
            if length != mp.seed_len or seedprob < mp.min_seed_prob:
                return False
            mc = bin(int(moves)).count("1")
            if (fmlen == 1 and (moves & 1) == 1
                    and (mp.seed_len - mc) <= mp.max_stay_frac * mp.seed_len):
                return True
            return ended and fmlen <= mp.max_rep_copy and mc >= mp.min_rep_len

        def update_seeds(st, en, length, seedprob, moves, evt, ended):
            if not is_seed_valid(length, seedprob, en - st + 1, moves, ended):
                return False
            mc = bin(int(moves)).count("1")
            for s in range(int(st), int(en) + 1):
                sa_end = fmsize - int(fmi.sa_full[s])
                tracker.add_seed(sa_end, mc, evt - int(ended))
            return True

        for event_i in range(min(n, mp.max_events)):
            event = norm_means[event_i]
            probs = match_probs(event, model.means, model.vars_x2,
                                model.lognorm_denoms, hi)

            # ---- candidate generation (children of surviving paths) ----
            cands = []  # tuples in creation order
            budget = mp.max_paths
            for pi in range(len(p_start)):
                if p_len[pi] == 0:
                    continue
                child_found = False
                thresh = self.thresh_of(p_end[pi] - p_start[pi] + 1)
                kmer = int(p_kmer[pi])
                if p_consec[pi] < mp.max_consec_stay and probs[kmer] >= thresh:
                    cands.append((pi, int(p_start[pi]), int(p_end[pi]), kmer, 0))
                    child_found = True
                    if len(cands) >= budget:
                        break
                for b in range(4):
                    nk = ((kmer << 2) & (KMER_COUNT - 1)) | b
                    if probs[nk] < thresh:
                        continue
                    ns, ne = fmi.extend(p_start[pi], p_end[pi], b)
                    ns, ne = int(ns), int(ne)
                    if ns > ne:
                        continue
                    cands.append((pi, ns, ne, nk, 1))
                    child_found = True
                    if len(cands) >= budget:
                        break
                if not child_found and not p_sa_checked[pi]:
                    update_seeds(p_start[pi], p_end[pi], p_len[pi],
                                 p_seedprob[pi], p_moves[pi], event_i, True)
                if len(cands) >= budget:
                    break

            # materialize child state as mutable records
            # record: [start, end, kmer, length, consec, moves, sa_checked,
            #          sums, seedprob]
            def child_state(pi, ns, ne, nk, move):
                plen = int(p_len[pi])
                length = plen + (plen < mp.seed_len)
                moves = ((int(p_moves[pi]) << 1) | move) & self.path_mask
                consec = (int(p_consec[pi]) + (1 - move)) * (1 - move)
                prob = probs[nk]
                if plen == mp.seed_len:
                    sums = np.empty(mp.seed_len + 1, dtype=F32)
                    sums[: mp.seed_len] = p_sums[pi, 1:]
                    sums[mp.seed_len] = F32(sums[mp.seed_len - 1] + prob)
                    seedprob = F32((sums[mp.seed_len] - sums[0]) / mp.seed_len)
                    moves |= self.tail_move
                else:
                    sums = p_sums[pi].copy()
                    sums[length] = F32(sums[length - 1] + prob)
                    seedprob = F32(sums[length] / length)
                return [ns, ne, nk, length, consec, moves,
                        bool(p_sa_checked[pi]), sums, seedprob]

            new_paths = [child_state(*c) for c in cands]

            # ---- sort, dedup, and source creation (mapper.cpp:527-624) ----
            # full-tie order: candidates with identical (start, end,
            # seedprob) — pervasive on real reads (38% of bench events) —
            # are deduped keeping the LAST (mapper.cpp:568-571), and the
            # survivor's length/moves/consec history is observable
            # downstream.  The reference's own tie order is a build
            # artifact (any build substitutes a sort); this is the stable
            # refinement (creation order), the mapper's stated tie order.
            sorted_paths = sorted(new_paths,
                                  key=lambda r: (r[0], r[1], r[8]))
            sources = []
            sources_added = np.zeros(KMER_COUNT, dtype=bool)

            def make_source(st, en, kmer):
                sums = np.zeros(mp.seed_len + 1, dtype=F32)
                sums[1] = probs[kmer]
                return [st, en, kmer, 1, 0, 1, False, sums, probs[kmer]]

            def budget_left():
                return len(sorted_paths) + len(sources) < mp.max_paths

            nsorted = len(sorted_paths)
            prev_kmer = -1
            unchecked = None
            valid_mask = [True] * nsorted
            for i in range(nsorted):
                st, en, kmer = sorted_paths[i][0], sorted_paths[i][1], sorted_paths[i][2]
                if kmer != prev_kmer and budget_left() and probs[kmer] >= source_prob:
                    sources_added[kmer] = True
                    if int(kmer_st[kmer]) <= st - 1:
                        sources.append(make_source(int(kmer_st[kmer]), st - 1, kmer))
                    unchecked = [en + 1, int(kmer_en[kmer])]
                prev_kmer = kmer
                # duplicate-range removal: best (last) survives
                if (i < nsorted - 1
                        and sorted_paths[i + 1][0] == st
                        and sorted_paths[i + 1][1] == en):
                    valid_mask[i] = False
                    continue
                if budget_left() and probs[kmer] >= source_prob and unchecked:
                    sst, sen = unchecked
                    if i < nsorted - 1 and sorted_paths[i + 1][2] == kmer:
                        sen = sorted_paths[i + 1][0] - 1
                        if unchecked[0] <= sorted_paths[i + 1][1]:
                            unchecked[0] = sorted_paths[i + 1][1] + 1
                    if sst <= sen:
                        sources.append(make_source(sst, sen, kmer))
                # seed report for this (non-duplicate) candidate
                r = sorted_paths[i]
                if update_seeds(r[0], r[1], r[3], r[8], r[5], event_i, False):
                    r[6] = True  # sa_checked propagates to children

            # full-range sources for k-mers without candidates
            for kmer in range(KMER_COUNT):
                if not budget_left():
                    break
                if (not sources_added[kmer] and probs[kmer] >= source_prob
                        and kmer_st[kmer] <= kmer_en[kmer]):
                    sources.append(make_source(int(kmer_st[kmer]),
                                               int(kmer_en[kmer]), kmer))

            keep = [sorted_paths[i] for i in range(nsorted) if valid_mask[i]]
            keep += sources

            if keep:
                p_start = np.array([p[0] for p in keep], dtype=np.int64)
                p_end = np.array([p[1] for p in keep], dtype=np.int64)
                p_kmer = np.array([p[2] for p in keep], dtype=np.int64)
                p_len = np.array([p[3] for p in keep], dtype=np.int64)
                p_consec = np.array([p[4] for p in keep], dtype=np.int64)
                p_moves = np.array([p[5] for p in keep], dtype=np.int64)
                p_sa_checked = np.array([p[6] for p in keep], dtype=bool)
                p_sums = np.stack([p[7] for p in keep])
                p_seedprob = np.array([p[8] for p in keep], dtype=F32)
            else:
                p_start = p_start[:0]; p_end = p_end[:0]; p_kmer = p_kmer[:0]
                p_len = p_len[:0]; p_consec = p_consec[:0]
                p_moves = p_moves[:0]; p_sa_checked = p_sa_checked[:0]
                p_sums = p_sums[:0]; p_seedprob = p_seedprob[:0]

            # ---- decision ----
            sc = tracker.get_final()
            if sc is not None:
                self._set_ref_loc(paf, sc, event_i, mean_evt_len)
                return paf

        return paf  # FAILURE (unmapped)

    def _set_ref_loc(self, paf: Paf, sc: SeedCluster, event_i: int,
                     mean_evt_len: np.float32):
        fmi = self.fmi
        bp_per_samp = F32(self.bp_per_samp)

        def event_to_bp(evt_i, last=False):
            # parity with mapper.cpp:703-706: the u32 argument wraps (e.g.
            # evt_st - seed_len underflows for early decisions), and the
            # multiply chain is float32: ((u32->f32 * mel) * bp_per_samp),
            # + last*(KLEN-1), truncated back to an integer.
            e = np.uint32(np.int64(evt_i) & 0xFFFFFFFF)
            v = F32(F32(F32(e) * mean_evt_len) * bp_per_samp) + F32(
                int(last) * (K - 1)
            )
            return int(v)

        fwd = sc.ref_st < fmi.n // 2
        if fwd:
            sa_st = sc.ref_st
        else:
            sa_st = fmi.n - (sc.ref_en_end + K - 1)

        rd_st = event_to_bp(sc.evt_st - self.mp.seed_len)
        rd_en = event_to_bp(sc.evt_en, True)
        rd_len = event_to_bp(event_i, True)
        rf_name, rf_st, rf_len = fmi.translate_loc(sa_st)
        rf_en = rf_st + (sc.ref_en_end - sc.ref_st + K)
        match_count = sc.total_len + K - 1

        paf.rd_len = rd_len
        paf.set_mapped(rd_st, rd_en, rf_name, rf_st, rf_en, rf_len, fwd,
                       match_count)
