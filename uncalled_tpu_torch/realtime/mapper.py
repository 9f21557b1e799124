"""Channel-pinned realtime mapping: the reference RealtimePool re-expressed
as batched device dispatch.

The reference pins one Mapper per channel and load-balances worker threads
over active channels (realtime_pool.cpp:48-390). Here every channel owns a
device read slot; each update() advances all channels' pending events in one
engine block on the card (``device``, default ``"cuda"``), so "load
balancing" disappears into batching (SURVEY §5.8).

Per-read give-up budgets follow mapper.cpp:381-431: max_events, max_chunks,
and a chunk timeout measured on the sim/sample clock instead of wall time
(deterministic; the reference uses wall time, which makes its sim runs
load-dependent).

A slot cannot re-run a read's history, so a read its pooled engine cuts
for room (a path, candidate, seed-row or cluster pool full) is lost to
mapping.  The pools therefore start at the conf's sizes and grow with the
demand the engine reports: after each update, every pool whose demand
since the last growth passed ``GROW_AT`` of it doubles until it no longer
does, and the state moves over to the wider engine
(``PooledEngine.widened``, ``widen_pool_state``), which replays its own
CUDA graphs from its second block.  A read's seed rows are capped only by
the batch's row pool (``R`` = ``RT``), which grows too."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import tracing
from ..config import Conf
from ..kmer import K
from ..mapping.batch import BatchMapper
from ..mapping.paf import Paf, Tag
from ..mapping.pooled import PooledEngine, widen_pool_state
from .signal import ChannelDSP

F32 = np.float32
GROW_AT = 0.75  # share of a pool its demand may reach before it doubles


@dataclass
class _Channel:
    number: int = -1  # active read number (-1 = idle)
    read_id: str = ""
    start_sample: int = 0
    dsp: ChannelDSP = None
    n_chunks: int = 0
    last_chunk_t: float = 0.0
    samples: int = 0
    done_reported: bool = True
    # wall-clock timing tags (reference mapper.cpp:235,313-316,374:
    # qt = read start -> first events mapped, mt = accumulated mapping
    # time, wt = everything else until the decision). Under batched
    # dispatch each advance's wall time is shared by all active channels.
    t_start: float = 0.0
    mt_acc: float = 0.0
    qt: float = -1.0
    shed_chunks: int = 0  # chunks dropped by backlog shedding


class RealtimeMapper:
    """update(chunks, now) -> finished (channel, number, Paf) triples."""

    def __init__(self, fmi, model, threshes, conf: Conf | None = None,
                 device=None, **over):
        self.conf = conf or Conf()
        n_ch = self.conf.reads.num_channels
        self.conf.engine.batch_reads = n_ch
        # channel slots are pinned to the pore — there is no read queue
        # to stand by, so the slot-handoff machinery (sb windows, lt_*
        # readout rows) is pure overhead here
        over.setdefault("handoff", False)
        self.bm = BatchMapper(fmi, model, threshes, self.conf,
                              device=device, **over)
        self.eng = self.bm.eng
        self.grows: list = []  # (update number, {field: (old, new)})
        self.n_updates = 0
        if isinstance(self.eng, PooledEngine):
            p = self.eng.params
            if p.R < p.RT:
                self.eng = self.bm.eng = self.eng.widened(R=p.RT)
        self.state = self.eng.fresh_state()
        self.channels = [_Channel() for _ in range(n_ch)]
        self.T = self.conf.engine.evt_block
        self._pending: list = []  # ended-by-replacement reads awaiting emit
        # give-up accounting for the ovf valve (VERDICT r4 #4): every
        # not-success end records (read_id, ovf_cut?, n_chunks fed) so
        # the sim bench can price the valve's enrichment cost (a cut
        # read keeps sequencing with unknown status instead of being
        # ejected — the reference never drops a read for memory)
        self.giveups: list = []

    def _start_read(self, c: int, chunk, now: float):
        ch = self.channels[c]
        ch.number = chunk.number
        ch.read_id = getattr(chunk, "read_id", f"ch{c+1}_rd{chunk.number}")
        ch.start_sample = chunk.start
        ch.dsp = ChannelDSP(
            self.conf,
            tgt_mean=self.bm.model.means_mean,
            tgt_stdv=self.bm.model.means_stdv,
        )
        ch.n_chunks = 0
        ch.samples = 0
        ch.done_reported = False
        import time

        ch.t_start = time.perf_counter()
        ch.mt_acc = 0.0
        ch.qt = -1.0
        ch.shed_chunks = 0
        mask = np.zeros(len(self.channels), bool)
        mask[c] = True
        self.state = self.eng.reset_slots(self.state, mask)

    @tracing.traced("realtime.add_chunks")
    def add_chunks(self, chunks, now: float):
        """Route incoming chunks; a new read number resets the channel
        (realtime_pool.cpp:74-104)."""
        for c_num, chunk in chunks:
            c = c_num - 1
            ch = self.channels[c]
            if chunk.number != ch.number:
                # a new read arriving over an unfinished one ends it
                # unmapped (realtime_pool.cpp:77-82 reset + set_ended)
                if ch.number >= 0 and not ch.done_reported:
                    paf = self._make_paf(c, ch, None, False)
                    paf.ended = True
                    self._pending.append((c + 1, ch.number, paf))
                    ch.done_reported = True
                    # replacement-ended reads count in the give-up
                    # telemetry too (never an ovf cut)
                    self.giveups.append((ch.read_id, False, ch.n_chunks))
                    tracing.count("rt_giveups")
                with tracing.span("realtime.reset"):
                    self._start_read(c, chunk, now)
                tracing.count("rt_resets")
            ch = self.channels[c]
            ch.n_chunks += 1
            ch.samples += len(chunk.signal)
            ch.last_chunk_t = now
            # backlog shedding (mapper.cpp:282-287: add_chunk returns
            # false while the previous chunk is unprocessed, dropping the
            # incoming one): when this channel's unconsumed event queue
            # is already deep, drop the chunk instead of falling further
            # behind the pore
            cap = self.conf.realtime.max_event_backlog
            if cap and ch.dsp.norm.unread_size() >= cap:
                ch.shed_chunks += 1
                tracing.count("rt_shed_chunks")
                continue
            with tracing.span("realtime.dsp"):
                ch.dsp.process_chunk(chunk.signal)

    def update(self, now: float):
        """Advance all channels by up to T events; return finished reads."""
        B, T = len(self.channels), self.T
        sp = tracing.span("realtime.advance")
        means = np.zeros((B, T), np.float32)
        on = np.zeros((B, T), bool)
        active = False
        for c, ch in enumerate(self.channels):
            if ch.number < 0 or ch.done_reported or ch.dsp is None:
                continue
            ev = ch.dsp.pop_all(T)
            if len(ev):
                means[c, : len(ev)] = ev
                on[c, : len(ev)] = True
                active = True
        if active:
            import time

            t0 = time.perf_counter()
            self.state = self.eng.advance(self.state, means, on)
            dt_ms = (time.perf_counter() - t0) * 1000.0
            for c, ch in enumerate(self.channels):
                if on[c].any():
                    if ch.qt < 0:
                        ch.qt = (t0 - ch.t_start) * 1000.0
                    ch.mt_acc += dt_ms
            tracing.count("rt_events", int(on.sum()))
        sp.close()
        with tracing.span("realtime.readout"):
            ro = self.eng.readout(self.state)
        self.n_updates += 1
        if isinstance(self.eng, PooledEngine):
            self._fit_pools(ro)

        out = list(self._pending)
        self._pending = []
        mp = self.conf.mapper
        due = []  # (slot, channel, success) of the reads decided now
        sp = tracing.span("realtime.decide")
        for c, ch in enumerate(self.channels):
            if ch.number < 0 or ch.done_reported:
                continue
            success = bool(ro["success"][c]) and bool(ro["done"][c])
            # give-up: max_events / chunk timeout (ms; the CLI-effective
            # default 4e6 ms effectively disables it) / max_chunks.
            # A PHYSICAL pool cut (ovf) also gives up: the read's path
            # set is no longer the reference's, so an eject decision off
            # it could be wrong — ending it unmapped keeps the channel
            # sequencing (the conservative ReadUntil outcome).  The
            # batch mapper instead REMAPS such reads on a wider tier;
            # a realtime slot cannot re-run its history, so the valve
            # is give-up.  The pools grow ahead of the demand
            # (_fit_pools), so that this does not fire.
            timed_out = (
                int(ro["evt_i"][c]) >= mp.max_events
                or (now - ch.last_chunk_t) * 1000.0 > mp.chunk_timeout
                or ch.n_chunks >= self.conf.reads.max_chunks
                or bool(ro["ovf"][c])
            )
            if not (success or timed_out):
                continue
            due.append((c, ch, success))
        sp.close()
        for c, ch, success in due:
            paf = self._make_paf(c, ch, ro, success)
            if not success:
                paf.ended = True
                self.giveups.append(
                    (ch.read_id, bool(ro["ovf"][c]), ch.n_chunks)
                )
                tracing.count("rt_giveups")
            ch.done_reported = True
            out.append((c + 1, ch.number, paf))
        return out

    def _fit_pools(self, ro):
        """Double each pool whose demand passed ``GROW_AT`` of it, and move
        the state to an engine of the new sizes."""
        p = self.eng.params
        flags, valid, keep, ent, rows = (
            int(x) for x in self.state["dm_pool"].cpu().numpy())
        RE = min(p.RE, p.S + p.SC)  # the step's effective budgets
        demand = dict(S=(keep, p.S), SC=(max(flags, valid), p.SC),
                      RE=(ent, RE), RT=(rows, min(p.RT, RE * p.max_rep_copy)),
                      CL=(int(ro["dm_cl"].max()), p.CL))
        new = {}
        for k, (d, cap) in demand.items():
            size = getattr(p, k)
            while d > GROW_AT * cap:
                size, cap = 2 * size, 2 * cap
            if size != getattr(p, k):
                new[k] = size
        if not new:
            return
        with tracing.span("realtime.grow"):
            if "S" in new:
                new["SC"] = max(new.get("SC", p.SC), new["S"] + new["S"] // 4)
            if "RT" in new:
                new["R"] = new["RT"]
            self.grows.append((self.n_updates, {
                k: (getattr(p, k), v) for k, v in new.items()}))
            self.eng = self.bm.eng = self.eng.widened(**new)
            self.state = widen_pool_state(self.eng.params, self.state)
        tracing.count("rt_grows")

    @tracing.traced("realtime.make_paf")
    def _make_paf(self, c: int, ch: _Channel, ro, success: bool) -> Paf:
        import time

        paf = Paf(rd_name=ch.read_id)
        paf.set_int(Tag.CHANNEL, c + 1)
        paf.set_int(Tag.READ_START, ch.start_sample)
        # timing tags; rt is never stamped, matching the reference (its
        # RECEIVE_TIME write is commented out, read_buffer.cpp:258)
        total_ms = (time.perf_counter() - ch.t_start) * 1000.0
        paf.set_float(Tag.MAP_TIME, ch.mt_acc)
        if ch.qt >= 0:
            paf.set_float(Tag.QUEUE_TIME, ch.qt)
            paf.set_float(
                Tag.WAIT_TIME, max(total_ms - ch.mt_acc - ch.qt, 0.0)
            )
        else:
            paf.set_float(Tag.WAIT_TIME, max(total_ms - ch.mt_acc, 0.0))
        paf.rd_len = int(
            F32(F32(ch.samples) * F32(self.conf.reads.bp_per_samp))
        )
        if not success:
            return paf
        det = ch.dsp
        # mean event length from the full detected prefix
        from .. import native
        from ..ops.events import detect_events_np

        ed = self.conf.event_detector
        full = det.signal[0] if det.signal else np.zeros(0, np.float32)
        ev = native.detect_events(full, ed.min_mean, ed.max_mean)
        if ev is None:
            ev = detect_events_np(full, ed.min_mean, ed.max_mean)
        mel = (
            F32(ev["len_sum"]) / F32(ev["total_events"])
            if ev["total_events"]
            else F32(0)
        )
        ref_st = int(ro["mm_ref_st"][c])
        ref_en_end = int(ro["mm_r2e"][c])
        fwd = ref_st < self.bm.fmi.n // 2
        sa_st = ref_st if fwd else self.bm.fmi.n - (ref_en_end + K - 1)
        rd_st = self.bm._event_to_bp(
            int(ro["mm_evt_st"][c]) - self.conf.mapper.seed_len, mel
        )
        rd_en = self.bm._event_to_bp(int(ro["mm_evt_en"][c]), mel, True)
        rd_len = self.bm._event_to_bp(int(ro["dec_evt"][c]), mel, True)
        rf_name, rf_st, rf_len = self.bm.fmi.translate_loc(sa_st)
        rf_en = rf_st + (ref_en_end - ref_st + K)
        paf.rd_len = rd_len
        paf.set_mapped(
            rd_st, rd_en, rf_name, rf_st, rf_en, rf_len, fwd,
            int(ro["mm_len"][c]) + K - 1,
        )
        return paf
