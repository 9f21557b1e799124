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

At the conf defaults two protocols run around the engine, and neither
changes a PAF byte.  The in-scan slot handoff
(``conf.engine.slot_handoff``, pooled engines): each occupied slot
carries a standby read whose first 2T events ride every block, and a
slot whose read decides mid-block switches to it on the device.  The
straggler drain chain (``drain_shrink``): once the input is spent and
few reads remain, they continue on a mapper B/``drain_div`` wide, by
state migration between pooled engines and by restart on the classic
entry; drains chain.  With ``conf.engine.device_dsp`` a refill wave's
event detection runs on the card (``ops.events.detect_block``, one
kernel launch a signal block for the whole wave).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import tracing
from ..config import Conf
from ..kmer import K
from ..ops.events import detect_events_np
from .engine import MapEngine
from .paf import Paf, Tag
from .pooled import LATCH_KEYS, PooledEngine

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
        self._over = dict(over)
        # the SA mode reaches every engine built below this one (eject
        # tiers, drains, ladder rungs), so a sampled-SA mapper keeps no
        # full SA on the device anywhere
        p = self.eng.params
        self._sa = dict(sampled_sa=p.sampled_sa, sa_intv=p.sa_intv)
        self._drain_mapper = None
        self.ovf_why: dict = {}  # read id -> overflow bits at harvest
        self.demand: dict = {}  # read id -> (flags, valid, paths, rows, cl)
        self.disp_events = 0  # B*T per advance
        self.useful_events = 0  # per-read evt_i at harvest
        self.n_ejected = 0  # reads this mapper sent on to the next tier
        # host seconds in drain migrations (device syncs included) and in
        # refills (DSP included; on tracing.clock, the host_loop.refill
        # spans' clock)
        self.t_migrate = 0.0
        self.t_refill = 0.0
        self.n_migrate = 0  # drain migrations attempted
        self.n_handoff = 0  # device switches harvested (swap branch)
        # pool-global demand high-water [flags, valid, keep, entries, rows]
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
                        **self._sa,
                    ),
                )
                self._next_mapper.T = min(2 * self.T, 128)
                return self._next_mapper
            P, B, R, CL, CE = en.remap_ladder[self._rung]
            self._next_mapper = BatchMapper(
                self.fmi, self.model, self.threshes, self.conf,
                emit_timing=self.emit_timing, device=self.eng.device,
                _rung=self._rung + 1, B=B, P=P, C=P, R=R, CL=CL, CE=CE,
                **self._sa,
            )
        return self._next_mapper

    def _get_drain(self) -> "BatchMapper":
        """Straggler-drain mapper, built lazily and cached: the same rung
        B/drain_div slots wide (at least 4), with twice the event block
        (at most 128).  An eject tier's drain inherits the tier's per-read
        pool geometry (slots per read, CL, R, FS, RE, RT; migration needs
        equal CL) and keeps the tier's SC floor, since a monster read's
        flag burst does not shrink with B; the entry rung's drain takes
        the conf's sizing at the narrower B.  Drains chain."""
        if self._drain_mapper is None:
            Bd = max(4, self.eng.params.B // self.conf.engine.drain_div)
            if self._pool_tier > 0:
                pp = self.eng.params
                slots = pp.S // pp.B
                self._drain_mapper = BatchMapper(
                    self.fmi, self.model, self.threshes, self.conf,
                    emit_timing=self.emit_timing, _rung=self._rung,
                    _pool_tier=self._pool_tier, _B_entry=self._B_entry,
                    engine=PooledEngine(
                        self.fmi, self.model, self.threshes, self.conf,
                        device=self.eng.device, B=Bd, S=Bd * slots,
                        SC=min(5 * Bd * slots,
                               max(Bd * slots + Bd * slots // 4, pp.SC)),
                        CL=pp.CL, R=pp.R, FS=pp.FS, RE=pp.RE, RT=pp.RT,
                        **self._sa,
                    ),
                )
            else:
                self._drain_mapper = BatchMapper(
                    self.fmi, self.model, self.threshes, self.conf,
                    emit_timing=self.emit_timing, device=self.eng.device,
                    _rung=self._rung, **{**self._over, **self._sa, "B": Bd},
                )
            self._drain_mapper.T = min(2 * self.T, 128)
        return self._drain_mapper

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


    @tracing.traced("host_loop.dsp")
    def _prepare_wave(self, reads) -> list:
        """Event detection for a refill wave on the engine's device
        (``conf.engine.device_dsp``): one ``detect_block`` stream of
        ``signal_block`` samples over all the wave's reads at once, then
        the mean filter and normalization on the host.  The detector equals
        the JAX ``detect_block`` bit for bit (ops/events.py), which is not
        the host detector's f64 arithmetic, so this mode's lines are the
        JAX mode's, not the reference's byte for byte."""
        from ..ops.events import detect_block, make_detector_state

        sb = self.conf.engine.signal_block
        dev = self.eng.device
        Bw = len(reads)
        L = max(r.raw_len for r in reads)
        nb = max(-(-L // sb), 1)
        sigs = np.zeros((Bw, nb * sb), np.float32)
        for i, r in enumerate(reads):
            sigs[i, : r.raw_len] = r.signal
        sig_d = torch.from_numpy(sigs).to(dev)
        state = make_detector_state(Bw, dev)
        means = [[] for _ in reads]
        lens = [[] for _ in reads]
        ed = self.conf.event_detector
        for b in range(nb):
            state, out = detect_block(
                state, sig_d[:, b * sb: (b + 1) * sb].contiguous())
            fired = out["fired"].cpu().numpy()
            m = out["mean"].cpu().numpy()
            ln = out["length"].cpu().numpy()
            st = out["start"].cpu().numpy()
            for i, r in enumerate(reads):
                # drop events born in the zero padding past the signal
                keep = fired[i] & (st[i] < r.raw_len)
                means[i].append(m[i][keep])
                lens[i].append(ln[i][keep])
        slots = []
        cap = self.conf.mapper.max_events
        for i, r in enumerate(reads):
            mm = np.concatenate(means[i]) if means[i] else np.zeros(0, F32)
            ll = np.concatenate(lens[i]) if lens[i] else np.zeros(0, F32)
            mask = (mm >= ed.min_mean) & (mm <= ed.max_mean)
            mm, ll = mm[mask], ll[mask]
            mel = F32(ll.sum()) / F32(len(ll)) if len(ll) else F32(0)
            norm, _, _ = normalize_events(
                mm, self.model.means_mean, self.model.means_stdv)
            slots.append(
                _Slot(read=r, means=norm[:cap], fed=0, mean_evt_len=mel))
        return slots

    @tracing.traced("host_loop.dsp")
    def _prepare_many(self, reads) -> list:
        """_prepare over a refill wave; more than 3 reads go to host
        threads (the native detector is a ctypes call that releases the
        GIL, and normalization is numpy)."""
        if len(reads) <= 3:
            return [self._prepare(r) for r in reads]
        from concurrent.futures import ThreadPoolExecutor

        if self._dsp_pool is None:
            self._dsp_pool = ThreadPoolExecutor(max_workers=8)
        return list(self._dsp_pool.map(self._prepare, reads))

    # --------------------------------------------------------------- main
    def map_reads(self, reads):
        """Generator over Paf results; ``reads`` is any iterable of
        Read-likes.  A materialized sequence is scheduled longest-first
        (LPT); output is in completion order either way."""
        if hasattr(reads, "__len__"):
            reads = sorted(reads, key=lambda r: len(r.signal), reverse=True)
        B = self.eng.params.B
        yield from self._run(iter(reads), [None] * B, self.eng.fresh_state(),
                             0, False, None)

    def _try_migrate(self, dm, state, keep):
        """Drain by migration: move the stragglers' device state into the
        narrow mapper ``dm`` instead of restarting them.  Returns the
        migrated state; None where migration does not apply (classic
        engines, more reads than drain slots, unequal CL or seed length);
        "nofit" when their pool segments exceed the drain's pool."""
        self.n_migrate += 1
        if not (isinstance(self.eng, PooledEngine)
                and isinstance(dm.eng, PooledEngine)):
            return None
        ps, pd = self.eng.params, dm.eng.params
        if len(keep) > pd.B or ps.CL != pd.CL or ps.seed_len != pd.seed_len:
            return None
        self.eng.check_migrate()
        # one device round trip for the high-water absorb and the fit check
        got = torch.cat([state["dm_pool"], state["n_paths"]]).cpu().numpy()
        np.maximum(self.pool_hw, got[:5], out=self.pool_hw)
        n_paths = got[5:]
        if int(n_paths[keep].sum()) > pd.S:
            return "nofit"  # the caller may wait for fewer stragglers
        sel = np.full(pd.B, -1, np.int32)
        sel[: len(keep)] = keep
        return self.eng.migrate(state, sel, dm.eng)

    def _absorb_hw(self, state):
        """Fold the device's pool-global demand high-water into the host
        record (at a run's end and before a migration)."""
        if "dm_pool" in state:
            np.maximum(self.pool_hw, state["dm_pool"].cpu().numpy(),
                       out=self.pool_hw)

    def _run(self, it, slots, state, pending, input_done, ovf_sink):
        """Core slot loop.  ``ovf_sink`` non-None routes budget ejects to
        the caller's list (drain mappers hand ejects up, so only the entry
        mapper's ladder is ever built).

        One block is in flight: block k+1 and its readout are dispatched
        before block k's readout is fetched, so host harvest and refill
        overlap the device; done slots are frozen by the engine's alive
        mask, and refilled reads join the block after the in-flight one.

        Slot-handoff protocol (pooled engines with ``handoff``): each
        occupied slot carries a standby read whose 0-based [0, 2T) event
        window rides every advance; when the primary decides mid-block the
        device latches its result and restarts the slot as the standby.
        The host sees the switch one block late, emits the latched PAF,
        makes the standby the primary at exactly fed = evt_i + T (the
        in-flight block's standby consumption is deterministic), and arms
        the next read.  ``pending`` counts a standby from its arming.
        """
        B, T = self.eng.params.B, self.T
        ho = bool(getattr(self.eng.params, "handoff", False))
        standby: dict = {}  # b -> armed standby _Slot
        promote_pending = np.zeros(B, bool)
        ready: list = []  # (b, slot): standbys that enter the classic way
        returned: list = []  # disarmed standbys' reads, queued again
        stale = np.zeros(B, bool)  # freed slots whose device rows live on

        def _pull():
            """Next read: disarmed standbys first, then the input iterator
            (StopIteration only when both are dry)."""
            nonlocal input_done
            if returned:
                return returned.pop(0)
            try:
                return next(it)
            except StopIteration:
                input_done = True
                raise

        def refill(state):
            t0 = tracing.clock()
            sp = tracing.span("host_loop.refill", t0)
            try:
                return _refill(state)
            finally:
                t1 = tracing.clock()
                sp.close(t1)
                self.t_refill += t1 - t0

        def _refill(state):
            nonlocal pending
            mask = stale.copy()  # latch-fallback slots: rows still alive
            stale[:] = False
            # standbys whose primary never switched (exhausted or ejected
            # reads) enter their slot the classic way: a fresh reset, which
            # also wipes any device-side switch state
            while ready:
                b, s = ready.pop()
                assert slots[b] is None
                s.t_start = time.time()
                slots[b] = s
                mask[b] = True  # pending was counted when it was armed
            incoming = []
            for b in range(B):
                if slots[b] is None:
                    try:
                        incoming.append((b, _pull()))
                    except StopIteration:
                        break
            if incoming:
                now = time.time()
                reads = [r for _, r in incoming]
                if self.conf.engine.device_dsp and len(reads) > 1:
                    prepped = self._prepare_wave(reads)
                else:
                    prepped = self._prepare_many(reads)
                for (b, _), s in zip(incoming, prepped):
                    s.t_start = now
                    slots[b] = s
                    mask[b] = True
                    pending += 1
            if ho:
                _arm_standbys()
            return self.eng.reset_slots(state, mask) if mask.any() else state

        def _arm_standbys():
            """Attach the next queued read to every occupied slot that
            lacks a standby (the device sees it through the standby window
            at the next dispatch)."""
            nonlocal pending
            incoming = []
            for b in range(B):
                if slots[b] is None or b in standby:
                    continue
                # never arm past the end of the input: disarmed reads
                # would be armed again and cycle with the disarm
                if input_done:
                    break
                try:
                    incoming.append((b, _pull()))
                except StopIteration:
                    break
            now = time.time()
            for (b, _), s in zip(
                    incoming, self._prepare_many([r for _, r in incoming])):
                s.t_start = now
                standby[b] = s
                pending += 1

        remap = (
            self.conf.engine.remap_wide
            and self._rung < len(self.conf.engine.remap_ladder)
        )
        overflowed = [] if ovf_sink is None else ovf_sink
        drained = []
        en = self.conf.engine
        # drain at the entry rung and at pooled eject tiers; classic ladder
        # rungs stay drain-free.  A drain that would not narrow the batch
        # (the B/div shrink floors at 4) is not built.
        can_drain = (
            en.drain_shrink
            and B >= en.drain_min_batch
            and (self._rung == 0 or self._pool_tier > 0)
            and max(4, B // en.drain_div) < B
        )

        def harvest(s, ro, b):
            """Record a finished or ejected read's overflow bits, demand and
            events from readout ``ro`` (the live or the latched fields)."""
            dm = (int(ro["dm_flags"][b]), int(ro["dm_valid"][b]),
                  int(ro["dm_paths"][b]), int(ro["dm_rows"][b]),
                  int(ro["dm_cl"][b]))
            self.demand[s.read.id] = dm
            self.useful_events += int(ro["evt_i"][b])
            if ro["ovf"][b]:
                self.ovf_why[s.read.id] = int(ro["ovf_why"][b])
            return dm

        def emit_latched(s, ro, b):
            """The latched (lt_*) readout of a switched-away primary: a Paf
            to yield, or None when the read went to the eject list."""
            lt = {k: ro["lt_" + k] for k in LATCH_KEYS}
            dm = harvest(s, lt, b)
            if lt["ovf"][b] and remap:
                overflowed.append((s.read, int(lt["ovf_why"][b]), dm))
                return None
            return self._finalize(s, lt, b)

        state = refill(state)
        drain_cont = None
        zeros_b = np.zeros(B, bool)
        nofit_at = None  # straggler count at the last "nofit" migration
        pend = None  # the block in flight: (readout, [(b, slot, fed)])
        while pending or pend is not None or returned:
            blk = tracing.block()
            if returned and not pending and pend is None:
                state = refill(state)  # re-admit disarmed standbys
            thresh = max(4, B // en.drain_div)
            if (ho and can_drain and input_done and standby
                    and pending - len(standby) <= thresh
                    and (nofit_at is None
                         or pending - len(standby) < nofit_at)):
                # tail mode: lingering standbys must not starve the drain.
                # Stop feeding their windows and queue them again; one the
                # in-flight block already switched to is caught at harvest
                # by the latch fallback below.
                for b in list(standby):
                    returned.append(standby.pop(b).read)
                    pending -= 1  # counted again when pulled
            want_drain = (
                can_drain and input_done and pending <= thresh
                # standby windows and unpromoted switches do not migrate
                and not standby and not promote_pending.any() and not ready
                # a "nofit" attempt idles the device (the pipeline must be
                # dry): retry only once the straggler count has dropped
                and (nofit_at is None or pending < nofit_at)
            )
            if pend is None and pending and want_drain:
                # straggler drain: continue the remaining reads on a narrow
                # mapper, by state migration when pooled, by restart else
                dm = self._get_drain()
                keep = [b for b in range(B) if slots[b] is not None]
                t0 = time.time()
                mig = self._try_migrate(dm, state, keep)
                self.t_migrate += time.time() - t0
                if mig == "nofit":
                    nofit_at = pending
                    if (self._pool_tier > 0
                            or pending > max(4, B // (2 * en.drain_div))):
                        # path-heavy stragglers: stay wide until fewer
                        # remain rather than re-running them all; tier
                        # monsters never restart
                        mig = None
                        want_drain = False
                    else:
                        mig = None
                        drained = [s.read for s in slots if s is not None]
                elif mig is not None:
                    dslots = [slots[b] for b in keep]
                    dslots += [None] * (dm.eng.params.B - len(keep))
                    drain_cont = (dm, dslots, mig, len(keep))
                else:
                    drained = [s.read for s in slots if s is not None]
                if mig is not None or drained:
                    slots = [None] * B
                    pending = 0
                    blk.close()
                    break
            new_pend = None
            if pending and not want_drain:
                pk = tracing.span("host_loop.pack")
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
                sb = None
                if ho and (standby or promote_pending.any()):
                    W = 2 * T
                    sb_m = np.zeros((B, W), np.float32)
                    sb_o = np.zeros((B, W), bool)
                    armed = np.zeros(B, bool)
                    for b, ss in standby.items():
                        w = ss.means[:W]
                        sb_m[b, : len(w)] = w
                        sb_o[b, : len(w)] = True
                        armed[b] = True
                    prom = promote_pending.copy()
                    promote_pending[:] = False
                    sb = (sb_m, sb_o, armed, prom)
                pk.close()
                if sb is None:
                    state = self.eng.advance(state, means, on)
                else:
                    state = self.eng.advance(state, means, on, sb=sb)
                self.disp_events += B * T
                new_pend = (self.eng.readout_start(state), snap)
            if pend is not None:
                ro = self.eng.readout_get(pend[0])
                # harvest, less the time the caller holds each yield
                hv = tracing.span("host_loop.harvest")
                ro_sw = ro["sw"] if (ho and "sw" in ro) else zeros_b
                for b, s, fed_after in pend[1]:
                    if slots[b] is not s:
                        continue  # harvested at an earlier block
                    if ho and b in standby and ro_sw[b]:
                        # the device switched this slot to its standby:
                        # emit the latched primary and promote the standby
                        # at the deterministic offset (evt_i at readout + T
                        # events of the in-flight block)
                        paf = emit_latched(s, ro, b)
                        if paf is not None:
                            hv.close()
                            with tracing.span("host_loop.consumer"):
                                yield paf
                            hv = tracing.span("host_loop.harvest")
                        ss = standby.pop(b)
                        ss.fed = min(int(ro["evt_i"][b]) + T, len(ss.means))
                        slots[b] = ss
                        promote_pending[b] = True
                        pending -= 1
                        self.n_handoff += 1
                        continue  # the promoted read reports next block
                    if ho and ro_sw[b] and not promote_pending[b]:
                        # latch fallback: the device switched, but the
                        # standby was disarmed (tail mode) before this
                        # harvest.  Emit the primary from the latch; the
                        # standby, already queued again, reruns from its
                        # start after the slot's reset.
                        paf = emit_latched(s, ro, b)
                        if paf is not None:
                            hv.close()
                            with tracing.span("host_loop.consumer"):
                                yield paf
                            hv = tracing.span("host_loop.harvest")
                        slots[b] = None
                        stale[b] = True
                        pending -= 1
                        continue
                    exhausted = fed_after >= len(s.means)
                    # early eject: once the sticky overflow flag is set
                    # this run's result is discarded for a wider rerun
                    if remap and ro["ovf"][b]:
                        dm = harvest(s, ro, b)
                        overflowed.append((s.read, int(ro["ovf_why"][b]), dm))
                    elif ro["done"][b] or exhausted:
                        harvest(s, ro, b)
                        paf = self._finalize(s, ro, b)
                        hv.close()
                        with tracing.span("host_loop.consumer"):
                            yield paf
                        hv = tracing.span("host_loop.harvest")
                    else:
                        continue
                    slots[b] = None
                    pending -= 1
                    if ho and b in standby:
                        # the unswitched standby takes the slot classically
                        ready.append((b, standby.pop(b)))
                hv.close()
                # refill resets slots on the latest dispatched state, so
                # new reads join the block after the in-flight one
                state = refill(state)
            pend = new_pend
            blk.close()

        self._absorb_hw(state)
        if drain_cont is not None:
            dm, dslots, mig, dn = drain_cont
            # disarmed standbys enter through the drain's own input
            yield from dm._run(iter(returned), dslots, mig, dn, not returned,
                               overflowed)
            returned = []
        elif drained:
            dm = self._get_drain()
            yield from dm._run(iter(drained + returned),
                               [None] * dm.eng.params.B,
                               dm.eng.fresh_state(), 0, False, overflowed)
            returned = []
        assert not returned, "disarmed standbys must enter a mapper again"

        if ovf_sink is not None or not overflowed:
            return  # a drain's ejects are routed by the mapper above it
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
