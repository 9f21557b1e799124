"""The plain reference of the ReadUntil loop: one read replayed alone.

The channels of a simulated ReadUntil run share nothing but the batch, so
the line a read gets can be worked out from that read alone: its signal,
the sample at which the simulated pore starts it, and (for a read still
undecided when it ends) the sample at which the next read on its channel
starts.  ``replay`` walks the loop's grid of ticks from the run's start
and, on each tick in the loop's order,

1. pops up to T normalised events, maps them one by one with the
   sequential mapper's per-event step (``Stepper``) and stops at a
   decision; then, with no decision, checks the give-up rules
   (``max_events``, ``max_chunks``, the chunk timeout on the simulated
   clock);
2. delivers the chunks the pore completed by the tick's sample count
   (a chunk is shed, counted but not detected, while the normaliser
   holds ``max_event_backlog`` unread events): each goes through a
   streaming event detector (``StreamDetector``), the 25-event stall
   profiler (``Profiler``) and a rolling normaliser of 6000 events
   (``RollingNorm``), which scales each event when it is popped.

It then applies the loop's decision rule (ended: ``en``; mapped XOR
deplete: ``ej`` with the eject delay as ``dl``, or ``mx`` in a mux scan;
otherwise ``kp``, each with the simulated seconds since the channel's
last chunk) and gives the PAF line without the wall-clock tags.  Plain
Python and NumPy, float64 where UNCALLED keeps doubles; it imports none
of the program.
"""

from __future__ import annotations

from collections import deque
from types import SimpleNamespace

import numpy as np

from .events import FLT_MAX, FLT_MIN, PEAK_HEIGHT, THRESH1, THRESH2, W1, W2
from .mapper import KMER_COUNT, Paf, RefMapper, SeedTracker, match_probs

F32 = np.float32
F64 = np.float64
_BIG = np.int64(1) << 32


class StreamDetector:
    """UNCALLED's t-test event detector fed a chunk at a time: prefix sums
    grow left to right across chunks, and the two peak detectors, the open
    event's start and the event counts carry over from chunk to chunk."""

    def __init__(self, min_mean, max_mean, hi=F64):
        self.min_mean, self.max_mean, self.hi = min_mean, max_mean, hi
        self.S = np.zeros(1, hi)
        self.SQ = np.zeros(1, hi)
        self.n = 0
        # [threshold, window, masked_to, peak_pos, peak_value, valid_peak]
        self.dets = [[F32(THRESH1), W1, 0, -1, FLT_MAX, False],
                     [F32(THRESH2), W2, 0, -1, FLT_MAX, False]]
        self.evt_st = 0
        self.total_events = 0
        self.len_sum = 0.0

    def _tstat(self, i: np.ndarray, w: int) -> np.ndarray:
        """The window-w t-statistic the detector sees at samples i
        (boundary m = i - 5; 0 before the windows fill)."""
        hi, S, SQ = self.hi, self.S, self.SQ
        m = i - 5
        ok = ((i + 2) > 2 * w) & (m >= 0)
        t = np.zeros(len(i), F32)
        m = m[ok]
        # the ring buffer's wrap: the left window starts at m + 2w for m < w
        left = np.where(m >= w, m - w, m + 2 * w)
        right = m + w
        wf32 = F32(w)
        whi = hi(F32(w))
        mean1 = ((S[m] - S[left]) / whi).astype(F32)
        mean2 = (S[right] - S[m]).astype(F32) / wf32
        comb = ((SQ[m] - SQ[left]) / whi - (mean1 * mean1).astype(hi)
                + ((SQ[right] - SQ[m]).astype(F32) / wf32).astype(hi)
                - (mean2 * mean2).astype(hi)).astype(F32)
        inner = np.maximum(comb, FLT_MIN) / wf32
        t[ok] = (np.abs((mean2 - mean1).astype(hi))
                 / np.sqrt(inner.astype(hi))).astype(F32)
        return t

    def _peak(self, k, cur, m, m_cmp) -> bool:
        d = self.dets[k]
        if d[2] >= m_cmp:
            return False
        if d[3] == -1:
            if cur < d[4]:
                d[4] = cur
            elif cur - d[4] > PEAK_HEIGHT:
                d[4], d[3] = cur, m
            return False
        if cur > d[4]:
            d[4], d[3] = cur, m
        if k == 0 and d[4] > d[0]:  # a short peak masks the long detector
            self.dets[1][2:6] = [d[3] + d[1], -1, FLT_MAX, False]
        if d[4] - cur > PEAK_HEIGHT and d[4] > d[0]:
            d[5] = True
        if d[5] and (m - d[3]) > d[1] // 2:
            d[3], d[4], d[5] = -1, cur, False
            return True
        return False

    def add(self, chunk: np.ndarray) -> list:
        """The means (as float) of the events this chunk closes that pass
        the mean filter."""
        xf = np.asarray(chunk, F32)
        x = xf.astype(self.hi)
        # sequential sums, continued from the last one
        self.S = np.concatenate([self.S[:-1], np.cumsum(
            np.concatenate([self.S[-1:], x]))])
        self.SQ = np.concatenate([self.SQ[:-1], np.cumsum(
            np.concatenate([self.SQ[-1:], (xf * xf).astype(self.hi)]))])
        i = np.arange(self.n, self.n + len(xf))
        self.n += len(xf)
        t1, t2 = self._tstat(i, W1), self._tstat(i, W2)
        out = []
        for j, ij in enumerate(i.tolist()):
            m = ij - 5
            m_cmp = m if m >= 0 else m + int(_BIG)  # u32 wrap of buf_mid
            p1 = self._peak(0, t1[j], m, m_cmp)
            p2 = self._peak(1, t2[j], m, m_cmp)
            if p1 or p2:
                evt_en = m - W1 + 1
                length = F32(evt_en - self.evt_st)
                mean = F32((self.S[evt_en] - self.S[self.evt_st]) / length)
                self.total_events += 1
                self.len_sum += float(length)
                if self.min_mean <= mean <= self.max_mean:
                    out.append(float(mean))
                self.evt_st = evt_en
        return out


class Ring:
    """A ring of float32 values with the running mean and sum of squared
    deviations of what it holds, in doubles (UNCALLED's Normalizer)."""

    def __init__(self, size: int):
        self.v = np.zeros(size, F32)
        self.size = size
        self.n = self.rd = self.wr = 0
        self.mean = self.varsum = 0.0
        self.full, self.empty = False, True

    def push(self, x: float) -> bool:
        if self.full:
            return False
        old = float(self.v[self.wr])
        self.v[self.wr] = F32(x)
        if self.n == self.size:  # replace the oldest value's share
            m0 = self.mean
            self.mean += (x - old) / self.size
            self.varsum += (x + old - m0 - self.mean) * (x - old)
        else:
            self.n += 1
            d = x - self.mean
            self.mean += d / self.n
            self.varsum += d * (x - self.mean)
        self.wr = (self.wr + 1) % self.size
        self.empty = False
        self.full = self.wr == self.rd
        return True

    def unread(self) -> int:
        if self.rd < self.wr:
            return self.wr - self.rd
        return 0 if self.empty else self.n - self.rd + self.wr

    def take(self) -> np.float32:
        x = self.v[self.rd]
        self.rd = (self.rd + 1) % self.size
        self.empty = self.rd == self.wr
        self.full = False
        return x

    def stdv(self) -> float:
        return float(np.sqrt(self.varsum / self.n)) if self.n else 0.0

    def skip(self, keep: int) -> int:
        """Drop all unread values but the newest ``keep``."""
        if keep >= self.unread():
            return 0
        self.full, self.empty = False, keep == 0
        rd = self.wr - keep if keep <= self.wr else self.n - (keep - self.wr)
        n = rd - self.rd if rd > self.rd else self.n - self.rd + rd
        self.rd = rd
        return n


class Profiler:
    """The stall mask: events pass WIN_MID late, and none passes while the
    stdv of the last 25 is under ``stdv_min`` or for 24 events after."""

    def __init__(self, win: int = 25, stdv_min: float = 5.0):
        self.win, self.mid, self.stdv_min = win, win // 2, F32(stdv_min)
        self.ring = Ring(win)
        self.held = deque()
        self.mask = 0
        self.primed = False
        self.next = 0.0

    def add(self, mean: float):
        """The event that passes now, or None."""
        self.ring.push(mean)
        self.held.append(mean)
        if self.ring.unread() <= self.mid:
            return None
        if F32(self.ring.stdv()) < self.stdv_min:
            self.mask = self.win - 1
        elif self.mask > 0:
            self.mask -= 1
        if self.ring.full:
            self.next = self.held.popleft()
            self.ring.take()
            self.primed = True
        return self.next if self.primed and self.mask == 0 else None


class RollingNorm:
    """Rolling normaliser: events scaled onto the model's mean and stdv
    with the statistics of the ring at the moment each is popped."""

    def __init__(self, size, tgt_mean, tgt_stdv):
        self.ring = Ring(size)
        self.tgt_mean, self.tgt_stdv = tgt_mean, tgt_stdv

    def pop(self) -> np.float32:
        scale = F32(self.tgt_stdv / self.ring.stdv())
        shift = F32(F64(self.tgt_mean) - F64(scale) * self.ring.mean)
        return F32(scale * F32(self.ring.take()) + shift)


class Stepper:
    """The sequential mapper's state for one read, fed one normalised event
    at a time (``RefMapper.map_read``'s per-event step, with the children
    of all live paths and their path state worked out as arrays).  Paths
    are in the mapper's order; a step makes the candidates in creation
    order (each path's stay, then its four moves), cuts them at the path
    budget, sorts them stably by (start, end, seed probability), drops
    duplicate ranges but the last, adds sources, and asks the seed tracker
    for a decision."""

    def __init__(self, rm: RefMapper):
        self.rm, self.mp = rm, rm.mp
        self.tracker = SeedTracker(rm.st)
        L = self.mp.seed_len
        self.p = dict(st=np.zeros(0, np.int64), en=np.zeros(0, np.int64),
                      kmer=np.zeros(0, np.int64), len=np.zeros(0, np.int64),
                      consec=np.zeros(0, np.int64),
                      moves=np.zeros(0, np.int64),
                      sa=np.zeros(0, bool), sums=np.zeros((0, L + 1), F32),
                      prob=np.zeros(0, F32))
        self.event_i = 0

    def _seeds(self, st, en, length, prob, moves, ended):
        """UNCALLED's update_seeds for one path: add its seed to the
        tracker where it is one; True where it was."""
        mp = self.mp
        if length != mp.seed_len or prob < mp.min_seed_prob:
            return False
        fmlen = en - st + 1
        mc = bin(moves).count("1")
        if not ((fmlen == 1 and (moves & 1) == 1
                 and (mp.seed_len - mc) <= mp.max_stay_frac * mp.seed_len)
                or (ended and fmlen <= mp.max_rep_copy
                    and mc >= mp.min_rep_len)):
            return False
        fmi = self.rm.fmi
        evt = self.event_i - int(ended)
        for s in range(st, en + 1):
            self.tracker.add_seed(fmi.n - int(fmi.sa_full[s]), mc, evt)
        return True

    def step(self, event):
        """Map one event; the seed cluster decided on, or None."""
        rm, mp, p = self.rm, self.mp, self.p
        fmi, model, L = rm.fmi, rm.model, mp.seed_len
        probs = match_probs(event, model.means, model.vars_x2,
                            model.lognorm_denoms, rm.hi)
        P = len(p["st"])
        # ---- children of every path, in creation order ----
        fmlen = (p["en"] - p["st"] + 1).astype(F64)
        thresh = rm.threshes[64 - np.frexp(fmlen)[1]] if P else \
            np.zeros(0, F32)
        stay = (p["consec"] < mp.max_consec_stay) & (probs[p["kmer"]]
                                                     >= thresh)
        nk = ((p["kmer"][:, None] << 2) & (KMER_COUNT - 1)) | np.arange(4)
        base = np.broadcast_to(np.arange(4), nk.shape)
        ns, ne = fmi.extend(np.broadcast_to(p["st"][:, None], nk.shape),
                            np.broadcast_to(p["en"][:, None], nk.shape),
                            base)
        move = ~(probs[nk] < thresh[:, None]) & (ns <= ne)
        flags = np.concatenate([stay[:, None], move], 1)  # [P, 5]
        flat = np.flatnonzero(flags.reshape(-1))
        done = P  # paths whose children were all made
        if len(flat) >= mp.max_paths:  # the budget cuts inside a path
            flat = flat[:mp.max_paths]
            done = int(flat[-1]) // 5
        ended = np.flatnonzero(~flags[:done].any(1) & ~p["sa"][:done])
        for i in ended.tolist():
            self._seeds(int(p["st"][i]), int(p["en"][i]), int(p["len"][i]),
                        p["prob"][i], int(p["moves"][i]), True)
        par, slot = flat // 5, flat % 5
        mv = (slot > 0).astype(np.int64)
        b = np.maximum(slot - 1, 0)
        c_st = np.where(mv == 1, ns[par, b], p["st"][par])
        c_en = np.where(mv == 1, ne[par, b], p["en"][par])
        c_kmer = np.where(mv == 1, nk[par, b], p["kmer"][par])
        plen = p["len"][par]
        c_len = plen + (plen < L)
        c_moves = ((p["moves"][par] << 1) | mv) & rm.path_mask
        c_consec = (p["consec"][par] + (1 - mv)) * (1 - mv)
        pr = probs[c_kmer]
        c_sums = p["sums"][par].copy()
        c_prob = np.zeros(len(par), F32)
        full = plen == L
        if full.any():  # the window of L sums slides
            sh = c_sums[full]
            sh[:, :L] = p["sums"][par[full], 1:]
            sh[:, L] = sh[:, L - 1] + pr[full]
            c_sums[full] = sh
            c_prob[full] = (sh[:, L] - sh[:, 0]) / F32(L)
            c_moves[full] |= rm.tail_move
        grow = ~full
        if grow.any():
            r = np.flatnonzero(grow)
            ln = c_len[r]
            c_sums[r, ln] = c_sums[r, ln - 1] + pr[r]
            c_prob[r] = c_sums[r, ln] / ln.astype(F32)
        c_sa = p["sa"][par].copy()
        # ---- stable sort, duplicates, sources ----
        order = np.lexsort((c_prob, c_en, c_st))
        st_l, en_l, km_l = (c_st[order].tolist(), c_en[order].tolist(),
                            c_kmer[order].tolist())
        n = len(order)
        kmer_st = fmi.kmer_ranges[:, 0]
        kmer_en = fmi.kmer_ranges[:, 1]
        src_prob = rm.threshes[0]
        src = []  # (st, en, kmer)
        added = np.zeros(KMER_COUNT, bool)
        keep = np.ones(n, bool)
        prev, unchecked = -1, None
        for i in range(n):
            st, en, km = st_l[i], en_l[i], km_l[i]
            ok = probs[km] >= src_prob
            if km != prev and n + len(src) < mp.max_paths and ok:
                added[km] = True
                if int(kmer_st[km]) <= st - 1:
                    src.append((int(kmer_st[km]), st - 1, km))
                unchecked = [en + 1, int(kmer_en[km])]
            prev = km
            if i < n - 1 and st_l[i + 1] == st and en_l[i + 1] == en:
                keep[i] = False
                continue
            if n + len(src) < mp.max_paths and ok and unchecked:
                sst, sen = unchecked
                if i < n - 1 and km_l[i + 1] == km:
                    sen = st_l[i + 1] - 1
                    if unchecked[0] <= en_l[i + 1]:
                        unchecked[0] = en_l[i + 1] + 1
                if sst <= sen:
                    src.append((sst, sen, km))
            j = int(order[i])
            if self._seeds(st, en, int(c_len[j]), c_prob[j],
                           int(c_moves[j]), False):
                c_sa[j] = True
        room = mp.max_paths - n - len(src)
        if room > 0:
            whole = np.flatnonzero(~added & (probs >= src_prob)
                                   & (kmer_st <= kmer_en))[:room]
            src += [(int(kmer_st[k]), int(kmer_en[k]), int(k))
                    for k in whole]
        kept = order[keep]
        s_km = np.array([k for _, _, k in src], np.int64)
        s_sums = np.zeros((len(src), L + 1), F32)
        s_sums[:, 1] = probs[s_km]
        one = np.ones(len(src), np.int64)
        p["st"] = np.concatenate([c_st[kept],
                                  np.array([s for s, _, _ in src], np.int64)])
        p["en"] = np.concatenate([c_en[kept],
                                  np.array([e for _, e, _ in src], np.int64)])
        p["kmer"] = np.concatenate([c_kmer[kept], s_km])
        p["len"] = np.concatenate([c_len[kept], one])
        p["consec"] = np.concatenate([c_consec[kept], 0 * one])
        p["moves"] = np.concatenate([c_moves[kept], one])
        p["sa"] = np.concatenate([c_sa[kept], np.zeros(len(src), bool)])
        p["sums"] = np.concatenate([c_sums[kept], s_sums])
        p["prob"] = np.concatenate([c_prob[kept], probs[s_km]])
        self.event_i += 1
        return self.tracker.get_final()


def tick_grid(tick: float):
    """The simulated clock's readings, one a pass: 0, then ``tick`` added
    once a pass, as the loop's clock adds it."""
    t = 0.0
    while True:
        yield t
        t += tick


def replay(rm: RefMapper, read, channel: int, start: int, rt: dict,
           next_start=None, next_len=0, hi=F64) -> str:
    """The line the loop gives ``read`` (``id``, ``signal``), started on
    ``channel`` at sample ``start``, without the wall-clock tags; the next
    read on the channel starts at ``next_start`` with ``next_len`` samples
    (None: not before this read's line).  ``rt`` holds the loop's
    settings: ``T``, ``tick``, ``time_coef`` (samples a simulated
    millisecond), ``chunk_len``, ``max_chunks``, ``max_events``,
    ``chunk_timeout`` (ms), ``max_event_backlog``, ``norm_len``,
    ``profiler`` ([window, stdv_min]), ``deplete``, ``eject_delay``
    (samples)."""
    rt = SimpleNamespace(**rt)
    sig = np.asarray(read.signal, F32)
    CL = rt.chunk_len
    chunks = [(start + a, sig[a: a + CL]) for a in range(0, len(sig), CL)]
    end = start + len(sig)  # the channel moves on from the read here
    next_due = None if next_start is None else next_start + min(CL,
                                                                next_len)
    det = StreamDetector(rm.min_mean, rm.max_mean, hi)
    prof = Profiler(*rt.profiler)
    norm = RollingNorm(rt.norm_len, rm.model.means_mean,
                       rm.model.means_stdv)
    mapper = Stepper(rm)
    c = n_chunks = samples = 0
    last_chunk = None  # the clock's reading at the read's last chunk
    last_any = None  # ... at the channel's last chunk
    replaced = False
    for now in tick_grid(rt.tick):
        # ---- the mapper's update, then the decision ----
        sc, ended = None, replaced
        if not replaced and last_chunk is not None:
            for _ in range(rt.T):
                if norm.ring.empty:
                    break
                sc = mapper.step(norm.pop())
                if sc is not None:
                    break
            ended = sc is None and (
                mapper.event_i >= rt.max_events
                or (now - last_chunk) * 1000.0 > rt.chunk_timeout
                or n_chunks >= rt.max_chunks)
        if sc is not None or ended:
            return _line(rm, read, channel, chunks[0][0], sc, mapper, det,
                         samples, now - last_any, rt)
        # ---- the chunks the pore completed by now ----
        s = int((now - 0.0) * 1000.0 * rt.time_coef)
        while c < len(chunks) and s < end and \
                s >= chunks[c][0] + len(chunks[c][1]):
            x = chunks[c][1]
            c += 1
            n_chunks += 1
            samples += len(x)
            last_chunk = last_any = now
            if rt.max_event_backlog and \
                    norm.ring.unread() >= rt.max_event_backlog:
                continue  # shed: counted, never detected
            queued = 0
            for m in det.add(x):
                e = prof.add(m)
                if e is None:
                    continue
                if not norm.ring.push(e):  # full: keep the newest queued
                    norm.ring.skip(queued)
                    if not norm.ring.push(e):
                        break
                queued += 1
        if next_due is not None and s >= next_due and last_chunk is not None:
            replaced = True  # ended by the next read's first chunk
            last_any = now
        if last_chunk is None and s >= end:
            return "undelivered"  # the pore never gave the loop a chunk


def _line(rm, read, channel, start, sc, mapper, det, samples, t, rt) -> str:
    """The decided read's PAF line: mapped where ``sc`` is a cluster, else
    ended unmapped; then the loop's decision tag."""
    paf = Paf(read.id, channel, start)
    if sc is None:
        paf.rd_len = int(F32(F32(samples) * F32(rm.bp_per_samp)))
        kind = "en"
    else:
        mel = F32(F32(det.len_sum) / F32(det.total_events))
        rm._set_ref_loc(paf, sc, mapper.event_i - 1, mel)
        kind = "ej" if rt.deplete else "kp"
        if kind == "ej":
            paf.tags.append(("dl", int(rt.eject_delay)))
    return paf.to_line() + f"\t{kind}:f:{t:f}"


_W: dict = {}  # a worker's reference, genomes and settings


def _init(spec, seed, mix, rt, hi):
    from ..traffic.reads import MODEL_NPZ, load_levels
    from . import fm
    from .mapper import pore_model

    p = spec["paths"]
    genome = np.load(p["genome"])
    idx = fm.RefFM(spec["name"], len(genome), fm.full_text(genome),
                   np.load(p["sa"], mmap_mode="r"), np.load(p["bwt"]))
    _W.update(genome=genome, other=np.load(p["other"]), seed=seed, mix=mix,
              rt=rt, hi=getattr(np, hi), levels=load_levels(),
              mapper=RefMapper(idx, pore_model(MODEL_NPZ), spec["threshes"],
                               spec["conf"], hi=getattr(np, hi)))


def _replay(item):
    from ..traffic.zymo import make_mixed_read

    n, channel, start, next_start, next_len = item
    r = make_mixed_read(_W["genome"], _W["other"], _W["seed"], n, _W["mix"],
                        _W["levels"])
    return n, replay(_W["mapper"], r, channel, start, _W["rt"], next_start,
                     next_len, _W["hi"])


def reference_lines(spec, seed, mix, items, rt, workers, hi="float64"):
    """Read number -> the reference's line, for each (number, channel,
    start, next start, next read's samples) of ``items``, each read made
    again from (seed, number) in worker processes.  ``spec``:
    ``check.prepare``'s, with the other genome's file as
    ``paths["other"]``."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    if not items:
        return {}
    with ProcessPoolExecutor(min(workers, len(items)),
                             mp_context=multiprocessing.get_context("spawn"),
                             initializer=_init,
                             initargs=(spec, seed, mix, rt, hi)) as ex:
        return dict(ex.map(_replay, list(items)))
