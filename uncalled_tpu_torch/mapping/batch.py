"""Host orchestration for batch mapping: reads -> events -> engine -> PAF.

Port of ``uncalled_tpu.mapping.batch.BatchMapper``: B read slots advance
T events per block; finished slots are harvested and refilled from the
read queue (longest reads first), one block in flight while the host
harvests the previous one.  The entry engine is the pooled engine
(``conf.engine.pooled``) or the classic ``MapEngine``.  Reads that trip a
budget are ejected early and rerun wider: a pooled entry's ejects go to
the pooled wide tiers (``conf.engine.pool_wide``, ``pool_max``) and then
to the remap ladder's final rung; a classic entry's go up the classic
remap ladder (``conf.engine.remap_ladder``), each read to the first rung
whose budgets cover its observed demand.  The last rung runs the
reference's budgets and ignores its own overflow flags.

Not in this port yet: the in-scan slot handoff and the straggler drain
chain (both raise unless ``conf.engine.slot_handoff`` and ``drain_shrink``
are off; neither changes a PAF byte).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..config import Conf
from ..kmer import K
from ..ops.events import detect_events_np
from .engine import MapEngine
from .paf import Paf, Tag
from .pooled import PooledEngine

F32 = np.float32
F64 = np.float64


def normalize_events(means: np.ndarray, tgt_mean: float, tgt_stdv: float):
    """Global z-score onto the model distribution; f64 accumulation in
    sequential order like the reference (normalizer.cpp:46-118)."""
    n = len(means)
    if n == 0:
        return means.astype(F32), F32(1), F32(0)
    m64 = means.astype(F64)
    gmean = np.cumsum(m64)[-1] / n
    varsum = np.cumsum((m64 - gmean) ** 2)[-1]
    scale = F32(tgt_stdv / np.sqrt(varsum / n))
    shift = F32(tgt_mean - scale * gmean)
    return (scale * means.astype(F32) + shift).astype(F32), scale, shift


@dataclass
class _Slot:
    read: object = None
    means: np.ndarray = None  # normalized event means
    fed: int = 0  # events fed to the device so far
    mean_evt_len: np.float32 = F32(0)
    t_start: float = 0.0  # wall-clock when the read entered its slot


class BatchMapper:
    """Map an iterable of reads, yielding Paf records (order of completion)."""

    def __init__(self, fmi, model, threshes, conf: Conf | None = None,
                 emit_timing: bool = False, device=None, _rung: int = 0,
                 _pool_tier: int = 0, engine=None, _B_entry: int = 0,
                 **over):
        self.conf = conf or Conf()
        en = self.conf.engine
        if en.slot_handoff or en.drain_shrink:
            raise NotImplementedError(
                "the slot handoff and the drain chain are not ported yet: "
                "set conf.engine.slot_handoff = conf.engine.drain_shrink = "
                "False"
            )
        if engine is None:
            if en.pooled and _rung == 0:
                # drop classic per-read budget knobs the pool doesn't have
                pover = {k: v for k, v in over.items()
                         if k not in ("P", "C", "CE", "R")}
                engine = PooledEngine(fmi, model, threshes, self.conf,
                                      device=device, **pover)
            else:
                engine = MapEngine(fmi, model, threshes, self.conf,
                                   device=device, **over)
        self.eng = engine
        self.fmi = fmi
        self.model = model
        self.threshes = threshes
        self.T = en.evt_block
        self.emit_timing = emit_timing
        # position on the remap ladder: rung 0 is the entry engine, rungs
        # 1..len(remap_ladder) are built lazily from conf; the pooled eject
        # tiers sit at the last rung's position
        self._rung = _rung
        self._pool_tier = _pool_tier
        self._B_entry = _B_entry or self.eng.params.B
        self._dsp_pool = None
        self._next_mapper = None
        self.ovf_why: dict = {}  # read id -> overflow bits at harvest
        self.demand: dict = {}  # read id -> (flags, valid, paths, rows, cl)
        self.disp_events = 0  # B*T per advance
        self.useful_events = 0  # per-read evt_i at harvest
        self.n_ejected = 0  # reads this mapper sent on to the next tier
        self.pool_hw = np.zeros(5, np.int64)

    def _pool_tiers(self):
        """Enabled pooled eject tiers, a truthy prefix of
        (pool_wide, pool_max)."""
        tiers = []
        for t in (self.conf.engine.pool_wide, self.conf.engine.pool_max):
            if not t:
                break
            tiers.append(t)
        return tiers

    def _get_next(self) -> "BatchMapper":
        """The next (wider) rung, built lazily and cached: for a pooled
        engine with pooled tiers left, the same engine with wider pools on
        a narrow slot array (the JAX mapper's sizing, batch.py _get_next);
        otherwise the classic engine at the remap ladder's next budgets."""
        en = self.conf.engine
        if self._next_mapper is None:
            tiers = self._pool_tiers()
            if (isinstance(self.eng, PooledEngine)
                    and self._pool_tier < len(tiers)):
                slots, CLw = tiers[self._pool_tier]
                Bw = max(2, self._B_entry // (16 * (2 ** self._pool_tier)))
                if slots >= 512:
                    Bw = max(8 // (1 + self._pool_tier), Bw)
                SCw = min(5 * Bw * slots,
                          max(Bw * slots + Bw * slots // 4, 24576))
                self._next_mapper = BatchMapper(
                    self.fmi, self.model, self.threshes, self.conf,
                    emit_timing=self.emit_timing,
                    _rung=max(len(en.remap_ladder) - 1, 0),
                    _pool_tier=self._pool_tier + 1,
                    _B_entry=self._B_entry,
                    engine=PooledEngine(
                        self.fmi, self.model, self.threshes, self.conf,
                        device=self.eng.device,
                        B=Bw, S=Bw * slots, SC=SCw,
                        CL=CLw, R=max(1024, self.eng.params.R), FS=512,
                        RE=2048, RT=max(8192, self.eng.params.RT),
                    ),
                )
                self._next_mapper.T = min(2 * self.T, 128)
                return self._next_mapper
            P, B, R, CL, CE = en.remap_ladder[self._rung]
            self._next_mapper = BatchMapper(
                self.fmi, self.model, self.threshes, self.conf,
                emit_timing=self.emit_timing, device=self.eng.device,
                _rung=self._rung + 1, B=B, P=P, C=P, R=R, CL=CL, CE=CE,
            )
        return self._next_mapper

    def _rung_fits(self, rung_i: int, why: int, dm) -> bool:
        """Could ladder rung ``rung_i`` hold a read whose overflow bits and
        demand lower bounds are (why, dm)?  Demand maxima are exact until
        the first budget cut, so a rung whose budgets do not cover the
        observed demand would overflow again; the last rung always fits
        (its budgets are the reference's)."""
        ladder = self.conf.engine.remap_ladder
        if rung_i >= len(ladder):
            return True
        P, _, R, CL, CE = ladder[rung_i]
        CE = CE if CE else P + max(P // 4, 256)
        fl, va, pa, rw, cl_dm = dm
        if fl > CE or va > P or pa > P or rw > R or cl_dm > CL:
            return False
        # after a cluster-table eviction (bit 1) the observed dm_cl is
        # capped at the tripped table's CL, so the true demand exceeds it
        if (why & 1) and CL <= max(self.eng.params.CL, cl_dm):
            return False
        return True

    def tiers(self) -> list:
        """This mapper and the eject tiers built below it, in order."""
        out, m = [], self
        while m is not None:
            out.append(m)
            m = m._next_mapper
        return out

    # ------------------------------------------------------------- events
    def _prepare(self, read) -> _Slot:
        ed = self.conf.event_detector
        from .. import native

        ev = native.detect_events(read.signal, ed.min_mean, ed.max_mean)
        if ev is None:  # no native lib: python oracle fallback (slow)
            ev = detect_events_np(read.signal, ed.min_mean, ed.max_mean)
        if ev["total_events"] > 0:
            mel = F32(ev["len_sum"]) / F32(ev["total_events"])
        else:
            mel = F32(0)
        norm, _, _ = normalize_events(
            ev["mean"], self.model.means_mean, self.model.means_stdv
        )
        cap = self.conf.mapper.max_events
        return _Slot(read=read, means=norm[:cap], fed=0, mean_evt_len=mel)

    # ---------------------------------------------------------------- paf
    def _event_to_bp(self, evt_i, mel, last=False):
        # parity with mapper.cpp:703-706 (u32 wrap + f32 multiply chain)
        e = np.uint32(np.int64(int(evt_i)) & 0xFFFFFFFF)
        bp_per_samp = F32(self.conf.reads.bp_per_samp)
        v = F32(F32(F32(e) * mel) * bp_per_samp) + F32(int(last) * (K - 1))
        return int(v)

    def _finalize(self, slot: _Slot, ro, b) -> Paf:
        read = slot.read
        paf = Paf(rd_name=read.id)
        if self.emit_timing:
            paf.set_float(Tag.MAP_TIME, (time.time() - slot.t_start) * 1000.0)
        paf.set_int(Tag.CHANNEL, read.channel)
        paf.set_int(Tag.READ_START, read.start_sample)
        paf.rd_len = int(F32(F32(read.raw_len)
                             * F32(self.conf.reads.bp_per_samp)))
        if not ro["success"][b]:
            return paf

        mel = slot.mean_evt_len
        ref_st = int(ro["mm_ref_st"][b])
        ref_en_end = int(ro["mm_r2e"][b])
        evt_st = int(ro["mm_evt_st"][b])
        evt_en = int(ro["mm_evt_en"][b])
        total_len = int(ro["mm_len"][b])
        event_i = int(ro["dec_evt"][b])

        fwd = ref_st < self.fmi.n // 2
        sa_st = ref_st if fwd else self.fmi.n - (ref_en_end + K - 1)
        rd_st = self._event_to_bp(evt_st - self.conf.mapper.seed_len, mel)
        rd_en = self._event_to_bp(evt_en, mel, True)
        rd_len = self._event_to_bp(event_i, mel, True)
        rf_name, rf_st, rf_len = self.fmi.translate_loc(sa_st)
        rf_en = rf_st + (ref_en_end - ref_st + K)
        paf.rd_len = rd_len
        paf.set_mapped(
            rd_st, rd_en, rf_name, rf_st, rf_en, rf_len, fwd, total_len + K - 1
        )
        return paf

    # --------------------------------------------------------------- main
    def map_reads(self, reads):
        """Generator over Paf results; ``reads`` is any iterable of
        Read-likes.  A materialized sequence is scheduled longest-first
        (LPT); output is in completion order either way."""
        if hasattr(reads, "__len__"):
            reads = sorted(reads, key=lambda r: len(r.signal), reverse=True)
        B = self.eng.params.B
        yield from self._run(iter(reads), [None] * B, self.eng.fresh_state())

    def _run(self, it, slots, state):
        """Core slot loop (see the module docstring)."""
        B, T = self.eng.params.B, self.T
        pending = 0

        def refill(state):
            nonlocal pending
            mask = np.zeros(B, bool)
            incoming = []
            for b in range(B):
                if slots[b] is None:
                    try:
                        incoming.append((b, next(it)))
                    except StopIteration:
                        break
            if incoming:
                if len(incoming) > 3:
                    # the native detector is a ctypes call (GIL released)
                    # and normalization is numpy: prep parallelizes
                    from concurrent.futures import ThreadPoolExecutor

                    if self._dsp_pool is None:
                        self._dsp_pool = ThreadPoolExecutor(max_workers=8)
                    new_slots = list(self._dsp_pool.map(
                        self._prepare, [r for _, r in incoming]
                    ))
                else:
                    new_slots = [self._prepare(r) for _, r in incoming]
                now = time.time()
                for (b, _), s in zip(incoming, new_slots):
                    s.t_start = now
                    slots[b] = s
                    mask[b] = True
                    pending += 1
                state = self.eng.reset_slots(state, mask)
            return state

        remap = (
            self.conf.engine.remap_wide
            and self._rung < len(self.conf.engine.remap_ladder)
        )
        overflowed = []
        state = refill(state)
        # one block in flight: dispatch block k+1 and its readout before
        # fetching block k's readout, so host harvest/refill overlaps the
        # device; done slots are frozen by the engine's alive mask
        pend = None
        while pending or pend is not None:
            new_pend = None
            if pending:
                means = np.zeros((B, T), np.float32)
                on = np.zeros((B, T), bool)
                snap = []
                for b, s in enumerate(slots):
                    if s is None:
                        continue
                    nxt = s.means[s.fed : s.fed + T]
                    means[b, : len(nxt)] = nxt
                    on[b, : len(nxt)] = True
                    s.fed += len(nxt)
                    snap.append((b, s, s.fed))
                state = self.eng.advance(state, means, on)
                self.disp_events += B * T
                new_pend = (self.eng.readout_start(state), snap)
            if pend is not None:
                ro = self.eng.readout_get(pend[0])
                for b, s, fed_after in pend[1]:
                    if slots[b] is not s:
                        continue  # harvested at an earlier block
                    exhausted = fed_after >= len(s.means)
                    dm = (
                        int(ro["dm_flags"][b]), int(ro["dm_valid"][b]),
                        int(ro["dm_paths"][b]), int(ro["dm_rows"][b]),
                        int(ro["dm_cl"][b]),
                    )
                    # early eject: once the sticky overflow flag is set
                    # this run's result is discarded for a wider rerun
                    if remap and ro["ovf"][b]:
                        self.ovf_why[s.read.id] = int(ro["ovf_why"][b])
                        self.demand[s.read.id] = dm
                        overflowed.append(
                            (s.read, int(ro["ovf_why"][b]), dm))
                        self.useful_events += int(ro["evt_i"][b])
                        slots[b] = None
                        pending -= 1
                    elif ro["done"][b] or exhausted:
                        if ro["ovf"][b]:
                            self.ovf_why[s.read.id] = int(ro["ovf_why"][b])
                        self.demand[s.read.id] = dm
                        self.useful_events += int(ro["evt_i"][b])
                        yield self._finalize(s, ro, b)
                        slots[b] = None
                        pending -= 1
                # refill resets slots on the latest dispatched state, so
                # new reads join the block after the in-flight one
                state = refill(state)
            pend = new_pend

        if "dm_pool" in state:
            np.maximum(self.pool_hw, state["dm_pool"].cpu().numpy(),
                       out=self.pool_hw)
        if not overflowed:
            return
        self.n_ejected += len(overflowed)
        if (isinstance(self.eng, PooledEngine)
                and self._pool_tier < len(self._pool_tiers())):
            # pooled ejects are physical pool cuts (the per-read budget is
            # already the reference's): all go to the next pooled tier
            yield from self._get_next().map_reads(
                [read for read, _, _ in overflowed]
            )
            return
        # remap pass, demand-routed: each read goes to the first rung whose
        # budgets cover its observed demand (the last rung always does)
        ladder = self.conf.engine.remap_ladder
        groups: dict = {}
        for read, why, dm in overflowed:
            j = self._rung
            while not self._rung_fits(j, why, dm):
                j += 1
            groups.setdefault(min(j, len(ladder) - 1), []).append(read)
        for j in sorted(groups):
            m = self
            while m._rung <= j:
                m = m._get_next()
            yield from m.map_reads(groups[j])
