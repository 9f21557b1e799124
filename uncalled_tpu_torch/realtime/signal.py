"""Streaming per-channel signal processing for the realtime path.

Replicates the reference's realtime chunk pipeline (mapper.cpp:307-367):
raw chunk -> event detection -> EventProfiler stall mask (25-event window,
events delayed by WIN_MID and dropped while masked, event_profiler.hpp:71-114)
-> rolling-window Normalizer (6000 events; scale/shift from the rolling
mean/stdv at pop time, normalizer.cpp:46-152) -> normalized means for the
device engine, with the overflow skip rule (mapper.cpp:336-351).

Event detection reuses the whole-prefix native detector: the detector's
output over a longer prefix extends its output over a shorter one (all state
is prefix-determined), so re-detecting the accumulated signal and taking the
new events is exactly the streaming result.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..config import Conf
from ..ops.events import detect_events_np

F32 = np.float32


class RollingStats:
    """The reference Normalizer's ring buffer + rolling mean/variance
    (normalizer.cpp:46-152). Doubles throughout, like the reference."""

    def __init__(self, length: int):
        # ring stores f32 values (reference: std::vector<float> signal_);
        # statistics accumulate in f64
        self.sig = np.zeros(length, dtype=np.float32)
        self.len = length
        self.n = 0
        self.rd = 0
        self.wr = 0
        self.mean = 0.0
        self.varsum = 0.0
        self.is_full = False
        self.is_empty = True

    def push(self, v: float) -> bool:
        if self.is_full:
            return False
        old = float(self.sig[self.wr])
        self.sig[self.wr] = F32(v)
        if self.n == self.len:
            oldmean = self.mean
            self.mean += (v - old) / self.len
            self.varsum += (v + old - oldmean - self.mean) * (v - old)
        else:
            self.n += 1
            d1 = v - self.mean
            self.mean += d1 / self.n
            self.varsum += d1 * (v - self.mean)
        self.wr = (self.wr + 1) % self.len
        self.is_empty = False
        self.is_full = self.wr == self.rd
        return True

    def unread_size(self) -> int:
        if self.rd < self.wr:
            return self.wr - self.rd
        if self.is_empty:
            return 0
        return (self.n - self.rd) + self.wr

    def stdv(self) -> float:
        return float(np.sqrt(self.varsum / self.n)) if self.n else 0.0

    def pop_raw(self) -> float:
        v = self.sig[self.rd]
        self.rd = (self.rd + 1) % self.len
        self.is_empty = self.rd == self.wr
        self.is_full = False
        return v

    def skip_unread(self, nkeep: int) -> int:
        """Drop all unread but the newest nkeep (normalizer.cpp:120-152)."""
        if nkeep >= self.unread_size():
            return 0
        self.is_full = False
        self.is_empty = nkeep == 0
        new_rd = self.wr - nkeep if nkeep <= self.wr else self.n - (nkeep - self.wr)
        nskip = new_rd - self.rd if new_rd > self.rd else (self.n - self.rd) + new_rd
        self.rd = new_rd
        return nskip


class EventProfiler:
    """25-event stall-mask window (event_profiler.hpp:71-114). Events are
    delayed by WIN_MID and suppressed while the window stdv < win_stdv_min."""

    def __init__(self, win_len: int = 25, win_stdv_min: float = 5.0):
        self.win_len = win_len
        self.win_mid = win_len // 2
        self.stdv_min = win_stdv_min
        self.window = RollingStats(win_len)
        self.events: deque[float] = deque()
        self.to_mask = 0
        self.is_full = False
        self.next_mean = 0.0

    def add_event(self, mean: float) -> bool:
        """Returns True when a (non-masked) delayed event is ready; its mean
        is in self.next_mean."""
        self.window.push(mean)
        self.events.append(mean)
        if self.window.unread_size() <= self.win_mid:
            return False
        # float32 compare like the reference (win_stdv_ is float)
        if F32(self.window.stdv()) < F32(self.stdv_min):
            self.to_mask = self.win_len - 1
        elif self.to_mask > 0:
            self.to_mask -= 1
        if self.window.is_full:
            self.next_mean = self.events.popleft()
            self.window.pop_raw()
            self.is_full = True
        return self.is_full and self.to_mask == 0


class StreamNormalizer:
    """Rolling 6000-event normalizer; values are scaled at pop time with the
    current window statistics (normalizer.cpp:105-118: at(rd))."""

    def __init__(self, length: int, tgt_mean: float, tgt_stdv: float):
        self.rs = RollingStats(length)
        self.tgt_mean = tgt_mean
        self.tgt_stdv = tgt_stdv

    def push(self, v: float) -> bool:
        return self.rs.push(v)

    def pop(self) -> np.float32:
        # Normalizer::at(rd_) then advance (normalizer.cpp:105-118):
        # scale/shift rounded to f32, applied to the stored f32 value
        scale = F32(self.tgt_stdv / self.rs.stdv())
        shift = F32(np.float64(self.tgt_mean) - np.float64(scale) * self.rs.mean)
        return F32(scale * F32(self.rs.pop_raw()) + shift)

    def empty(self) -> bool:
        return self.rs.is_empty

    def unread_size(self) -> int:
        return self.rs.unread_size()

    def skip_unread(self, nkeep: int = 0) -> int:
        return self.rs.skip_unread(nkeep)


@dataclass
class ChannelDSP:
    """Per-channel streaming state: signal accumulator + profiler + norm."""

    conf: Conf
    signal: list = field(default_factory=list)
    n_detected: int = 0  # events already taken from the detector output
    profiler: EventProfiler = None
    norm: StreamNormalizer = None
    skipped: int = 0

    # normalization targets; None = conf defaults.  The mapper passes
    # the pore model's own mean/stdv (mapper.cpp:94 set_target(model...))
    tgt_mean: float = None
    tgt_stdv: float = None
    # (offset, range, digitisation) mid-stream calibration for data
    # sources delivering uncalibrated ints (EventDetector::set_calibration,
    # event_detector.cpp:155-162); None = already-calibrated pA floats
    calibration: tuple = None

    def __post_init__(self):
        ep = self.conf.event_profiler
        nm = self.conf.normalizer
        self.profiler = EventProfiler(ep.win_len, ep.win_stdv_min)
        self.norm = StreamNormalizer(
            nm.len,
            nm.tgt_mean if self.tgt_mean is None else self.tgt_mean,
            nm.tgt_stdv if self.tgt_stdv is None else self.tgt_stdv,
        )

    def process_chunk(self, chunk: np.ndarray) -> int:
        """Push one raw chunk; returns the number of events queued
        (mapper.cpp:307-367 incl. the overflow skip)."""
        from .. import native

        self.signal.append(np.asarray(chunk, dtype=np.float32))
        full = np.concatenate(self.signal) if len(self.signal) > 1 else self.signal[0]
        if len(self.signal) > 1:
            self.signal = [full]
        ed = self.conf.event_detector
        ev = native.detect_events(full, ed.min_mean, ed.max_mean,
                                  calibration=self.calibration)
        if ev is None:
            ev = detect_events_np(full, ed.min_mean, ed.max_mean,
                                  calibration=self.calibration)
        new_means = ev["mean"][self.n_detected :]
        self.n_detected = len(ev["mean"])

        nevents = 0
        for m in new_means:
            if not self.profiler.add_event(float(m)):
                continue
            evt_mean = self.profiler.next_mean
            if not self.norm.push(evt_mean):
                nskip = self.norm.skip_unread(nevents)
                self.skipped += nskip
                if not self.norm.push(evt_mean):
                    return nevents
            nevents += 1
        return nevents

    def pop_all(self, cap: int) -> np.ndarray:
        """Drain up to cap normalized event means."""
        out = []
        while not self.norm.empty() and len(out) < cap:
            out.append(self.norm.pop())
        return np.asarray(out, dtype=np.float32)
