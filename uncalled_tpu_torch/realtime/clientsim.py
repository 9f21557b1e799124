"""Simulated MinKNOW device (the fake sequencer for ReadUntil testing).

Behavioral port of the reference ClientSim (src/client_sim.cpp/.hpp):
per-channel activity intervals with start/end bounds, cyclic inter-read gap
and ejection-delay lists, pre-chunked reads replayed on a sample-count clock
derived from wall time x sim_speed, global mux-scan windows when every
channel's interval ends, unblock (truncate after a sampled delay + extra
ejection gap) and stop_receiving (silence remaining chunks).

All times are in samples (reference: time_coef_ = sample_rate/1000,
client_sim.cpp:33-36).
"""

from __future__ import annotations

import sys
import time as _time
from collections import deque
from dataclasses import dataclass

import numpy as np

from ..config import Conf


@dataclass
class SimChunk:
    channel: int
    number: int
    start: int
    signal: np.ndarray
    read_id: str = ""


class ScanIntv:
    """Activity interval: alternating active/inactive bounds + cyclic gap
    and delay samples (client_sim.hpp:97-182)."""

    def __init__(self, channel: int, intv: int):
        self.channel = channel
        self.intv = intv
        self.start_time = 2**32 - 1
        self.active = False
        self.gaps: list[int] = []
        self.delays: list[int] = []
        self.bounds: deque[int] = deque()
        self.g = 0
        self.d = 0

    def set_active(self, st: int, en: int):
        if st == 0:
            self.active = True
        else:
            self.bounds.append(st)
        self.bounds.append(en)

    def start(self, t: int):
        self.start_time = t

    def get_end(self) -> int:
        return self.bounds[-1] if self.bounds else 0

    def is_active(self, t: int) -> bool:
        while self.bounds and (t - self.start_time) >= self.bounds[0]:
            self.bounds.popleft()
            self.active = not self.active
        return self.active

    def next_gap(self) -> int:
        if not self.gaps:
            if self.active:
                self.active = False
                if self.bounds:
                    self.bounds.popleft()
            return 0
        gap = self.gaps[self.g]
        self.g = (self.g + 1) % len(self.gaps)
        return gap

    def next_delay(self) -> int:
        if not self.delays:
            return 0
        d = self.delays[self.d]
        self.d = (self.d + 1) % len(self.delays)
        return d


class SimRead:
    """A read pre-sliced into chunks (client_sim.hpp:184-249)."""

    def __init__(self, read, offs: int, chunk_len: int, number: int):
        sig = read.signal[offs:]
        self.duration = len(sig)
        self.number = number
        self.id = read.id
        self.chunks = [
            sig[i : i + chunk_len] for i in range(0, len(sig), chunk_len)
        ]
        self.chunk_starts = [0] * len(self.chunks)
        self.start_t = 0
        self.end_t = 0
        self.c = 0

    def start(self, t: int):
        self.start_t = t
        self.end_t = t + self.duration
        i = t
        for j, ch in enumerate(self.chunks):
            self.chunk_starts[j] = i
            i += len(ch)
        self.c = 0

    def started(self, t: int) -> bool:
        return self.start_t != 0 and self.start_t <= t

    def chunk_ready(self, t: int) -> bool:
        return (
            self.started(t)
            and self.c < len(self.chunks)
            and t >= self.chunk_starts[self.c] + len(self.chunks[self.c])
        )

    def pop_chunk(self):
        ch = self.chunks[self.c]
        st = self.chunk_starts[self.c]
        self.c += 1
        return st, ch

    def get_end(self) -> int:
        return self.end_t

    def ended(self, t: int) -> bool:
        return self.started(t) and t >= self.end_t

    def stop_receiving(self):
        self.c = len(self.chunks)

    def unblock(self, t: int, delay: int):
        self.end_t = min(t + delay, self.start_t + self.duration)


class SimChannel:
    """One channel: interval queue + read source (client_sim.hpp:250-370).
    The reads come from ``draw(k)``, the channel's k-th read; by default
    the reads loaded by ``load_read``, in turn and round again."""

    def __init__(self, channel: int):
        self.channel = channel
        self.intvs: deque[ScanIntv] = deque()
        self.reads: list[SimRead | None] = []
        self.read: SimRead | None = None  # the read on the channel
        self.n_drawn = 0
        self.extra_gap = 0
        self.read_count = 0
        self.active = False
        self.draw = lambda k: self.reads[k % len(self.reads)]
        self.started = {}  # read number -> (channel, start, samples)

    def current(self) -> SimRead:
        if self.read is None:
            self._next_read()
        return self.read

    def _next_read(self):
        self.read = self.draw(self.n_drawn)
        self.n_drawn += 1

    def _start_read(self, t: int):
        rd = self.current()
        rd.start(t)
        self.started[rd.number] = (self.channel, t, rd.duration)

    def is_dead(self) -> bool:
        return not self.intvs

    def _intv(self, i: int) -> ScanIntv:
        while i >= len(self.intvs):
            self.intvs.append(ScanIntv(self.channel, len(self.intvs)))
        return self.intvs[i]

    def is_active(self, t: int) -> bool:
        if self.is_dead():
            return False
        if self.intvs[0].is_active(t):
            if not self.active:
                self._start_read(t + self.intvs[0].next_gap())
                self.active = True
        elif self.active:
            self._next_read()
            self.active = False
        return self.active

    def start(self, t: int) -> bool:
        if not self.is_dead():
            self.extra_gap = 0
            self.intvs[0].start(t)
        return self.is_active(t)

    def reserve_read(self) -> int:
        i = self.read_count
        self.read_count += 1
        return i

    def load_read(self, i: int, sim_read: SimRead):
        while len(self.reads) < self.read_count:
            self.reads.append(None)
        self.reads[i] = sim_read

    def chunk_ready(self, t: int) -> bool:
        if not self.intvs[0].is_active(t):
            return False
        end = self.current().get_end()
        while t >= end:
            self._next_read()
            self._start_read(end + self.intvs[0].next_gap() + self.extra_gap)
            self.extra_gap = 0
            end = self.read.get_end()
        return self.read.chunk_ready(t)

    def read_number(self) -> int:
        return self.current().number

    def intv_ended(self, t: int) -> bool:
        return self.is_dead() or self.intvs[0].get_end() <= t

    def next_intv(self, t: int):
        self.intvs.popleft()
        if not self.is_dead():
            self.intvs[0].start(t)

    def stop_receiving_read(self):
        self.current().stop_receiving()

    def unblock(self, t: int, ej_time: int) -> int:
        delay = self.intvs[0].next_delay()
        self.current().unblock(t, delay)
        self.extra_gap = ej_time
        return delay


class ClientSim:
    """The fake MinKNOW: same surface as the live client
    (get_read_chunks / unblock_read / stop_receiving_read / is_running /
    should_eject / get_runtime)."""

    def __init__(self, conf: Conf | None = None, clock=None):
        self.conf = conf or Conf()
        sp = self.conf.simulator
        rd = self.conf.reads
        sample_rate = rd.sample_rate
        self.chunk_len = rd.chunk_len
        self.time_coef = sample_rate / 1000.0 * sp.sim_speed
        self.ej_time = int(sp.ej_time * sample_rate)
        self.scan_time = int(sp.scan_time * sample_rate)
        self.channels = [SimChannel(c + 1) for c in range(rd.num_channels)]
        self.read_locs: dict[str, tuple[int, int, int]] = {}
        # read number -> (channel, start sample, samples), at each start
        self.started = {}
        for ch in self.channels:
            ch.started = self.started
        self.is_running_ = False
        self.in_scan = False
        self.scan_start = 0
        self._t0 = None
        self._clock = clock or _time.monotonic

    # ---------------------------------------------------- pattern population
    def add_intv(self, ch: int, i: int, st: int, en: int):
        self.channels[ch - 1]._intv(i).set_active(st, en)

    def add_gap(self, ch: int, i: int, length: int):
        self.channels[ch - 1]._intv(i).gaps.append(length)

    def add_delay(self, ch: int, i: int, length: int):
        self.channels[ch - 1]._intv(i).delays.append(length)

    def add_read(self, ch: int, read_id: str, offs: int = 0):
        i = self.channels[ch - 1].reserve_read()
        self.read_locs[read_id] = (ch, i, offs)

    def load_pattern_files(self, prefix: str) -> bool:
        """Populate the schedule from the reference's file-based pattern
        format: `<prefix>_itvs.txt` (ch i st en), `_gaps.txt` (ch i len),
        `_delays.txt` (ch i len), `_reads.txt` (ch read_id offs) —
        whitespace-separated, one entry per line (client_sim.cpp:44-208).
        Returns False (with a stderr note) on a missing file, like the
        reference."""
        import sys as _sys

        def rows(path, kinds):
            try:
                f = open(path)
            except OSError:
                _sys.stderr.write(f"Error: failed to open {path}\n")
                return None
            with f:
                out = []
                toks = f.read().split()
                n = len(kinds)
                for at in range(0, len(toks) - n + 1, n):
                    out.append(tuple(k(t) for k, t in
                                     zip(kinds, toks[at : at + n])))
                return out

        itvs = rows(prefix + "_itvs.txt", (int, int, int, int))
        gaps = rows(prefix + "_gaps.txt", (int, int, int))
        delays = rows(prefix + "_delays.txt", (int, int, int))
        reads = rows(prefix + "_reads.txt", (int, str, int))
        if None in (itvs, gaps, delays, reads):
            return False
        for ch, i, st, en in itvs:
            self.add_intv(ch, i, st, en)
        for ch, i, ln in gaps:
            self.add_gap(ch, i, ln)
        for ch, i, ln in delays:
            self.add_delay(ch, i, ln)
        for ch, rd, offs in reads:
            self.add_read(ch, rd, offs)
        return True

    def load_reads(self, reads):
        """Attach Read objects previously registered via add_read."""
        number = 0
        for read in reads:
            if read.id not in self.read_locs:
                continue
            ch, i, offs = self.read_locs[read.id]
            self.channels[ch - 1].load_read(
                i, SimRead(read, offs, self.chunk_len, number=read.number or number)
            )
            number += 1

    def set_read_source(self, draw):
        """Draw reads as the channels need them, in place of the reads
        loaded up front: ``draw(channel, k)`` gives ``channel``'s k-th read
        (an object with ``id``, ``signal`` and ``number``)."""
        def sim_read(c, k):
            read = draw(c, k)
            return SimRead(read, 0, self.chunk_len, number=read.number)

        for ch in self.channels:
            ch.draw = lambda k, c=ch.channel: sim_read(c, k)

    # ----------------------------------------------------------- run surface
    def run(self):
        self.is_running_ = True
        self.in_scan = False
        self._t0 = self._clock()
        for ch in self.channels:
            ch.start(0)
        return True

    def get_time(self) -> int:
        """Sample-count clock (client_sim.cpp:301-303)."""
        return int((self._clock() - self._t0) * 1000.0 * self.time_coef)

    def get_runtime(self) -> float:
        return self._clock() - self._t0

    def is_running(self) -> bool:
        return self.is_running_

    def should_eject(self) -> bool:
        return not self.in_scan

    def get_read_chunks(self):
        """All due chunks as (channel, SimChunk); advances the mux-scan
        state machine (client_sim.cpp:221-277)."""
        out = []
        if not self.is_running_:
            return out
        t = self.get_time()
        intvs_ended = True
        next_intv = False
        if self.in_scan:
            if t - self.scan_start >= self.scan_time:
                intvs_ended = self.in_scan = False
                next_intv = True
                sys.stderr.write(f"{t} ending mux scan\n")
            else:
                return out
        self.is_running_ = False
        for c, ch in enumerate(self.channels):
            if ch.is_dead():
                continue
            if next_intv:
                ch.next_intv(t)
                if ch.is_dead():
                    continue
            self.is_running_ = True
            if not ch.is_active(t):
                intvs_ended = ch.intv_ended(t) and intvs_ended
                continue
            intvs_ended = False
            while ch.chunk_ready(t):
                st, sig = self.reads_pop(ch)
                out.append(
                    (
                        c + 1,
                        SimChunk(
                            c + 1, ch.read_number(), st, sig,
                            read_id=ch.read.id,
                        ),
                    )
                )
        if intvs_ended and not self.in_scan:
            sys.stderr.write(f"{t} starting mux scan\n")
            self.scan_start = t
        self.in_scan = intvs_ended
        return out

    @staticmethod
    def reads_pop(ch: SimChannel):
        return ch.read.pop_chunk()

    def get_number(self, ch: int) -> int:
        return self.channels[ch - 1].read_number()

    def stop_receiving_read(self, ch: int, number: int):
        if self.get_number(ch) == number:
            self.channels[ch - 1].stop_receiving_read()

    def unblock_read(self, ch: int, number: int) -> int:
        if self.get_number(ch) != number:
            return 0
        return self.channels[ch - 1].unblock(self.get_time(), self.ej_time)
