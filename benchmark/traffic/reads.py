"""Simulated nanopore reads: one general generator, driven by a mix's
parameters (``params`` of a cell's file).

Read ``i`` of a run is a function of (seed, i) alone, so a read can be made
again anywhere (the reference's workers do) and the same seed gives the
same stream whatever the order in which the program pulls it.  The signal
model is that of ``uncalled_tpu_torch.testing.simulate``: the r9.4.1
template 5-mer levels, clipped lognormal dwells around ``mean_dwell``
samples a k-mer, Gaussian level noise, and with ``mismatch`` a model the
mapper does not have (per-read calibration jitter, extra noise, stalls,
fast skips and a slow baseline wander).

Mix parameters (all required):

* ``read_len_bp``: [lo, hi], a read's length uniform in it (bases);
* ``mismatch``: the mismatch knobs below, or null for the plain model:
  ``noise``, ``drift_scale_sd``, ``drift_shift_sd``, ``stall_p``,
  ``skip_p``, ``slow_drift``;
* ``mean_dwell``: samples a k-mer, on average.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np

K = 5
MODEL_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "r94_5mer_model.npz")
STREAM_READS = 2  # SeedSequence key of the read stream


def load_levels(path: str = MODEL_NPZ):
    """Template (uncomplemented) level means and stdvs by k-mer, as the
    mapper's model rounds them (vars_x2 = 2 sd^2 in f32)."""
    d = np.load(path)
    means = d["level_mean"].astype(np.float32)
    sd = d["level_stdv"].astype(np.float32)
    vars_x2 = (2.0 * sd * sd).astype(np.float32)
    return means, np.sqrt(vars_x2 / 2.0)


def kmers_of(codes: np.ndarray) -> np.ndarray:
    """All overlapping 5-mers, packed MSB-first (AAAAA = 0)."""
    c = codes.astype(np.int64)
    n = len(c) - K + 1
    out = np.zeros(max(n, 0), np.int64)
    for i in range(K):
        out |= c[i: i + n] << (2 * (K - 1 - i))
    return out


def signal_of(codes, levels, rng, mean_dwell, noise=1.0, drift_scale=1.0,
              drift_shift=0.0, stall_p=0.0, skip_p=0.0, slow_drift=0.0):
    """Raw current (pA, f32) for a 5'->3' base sequence."""
    means, sds = levels
    km = kmers_of(codes)
    lv, sd = means[km], sds[km]
    dwells = np.maximum(
        2, rng.lognormal(np.log(mean_dwell * 0.85), 0.45, len(km))
    ).astype(np.int64)
    if stall_p > 0:
        stalls = rng.random(len(km)) < stall_p
        dwells[stalls] = dwells[stalls] * rng.integers(5, 21, int(stalls.sum()))
    if skip_p > 0:
        dwells[rng.random(len(km)) < skip_p] = 1
    idx = np.repeat(np.arange(len(km)), dwells)
    out = (lv[idx] * drift_scale + drift_shift
           + rng.normal(0.0, noise * np.maximum(sd[idx], 1.0))
           ).astype(np.float32)
    if slow_drift > 0:
        t = np.linspace(0.0, 1.0, len(out), dtype=np.float32)
        phase = rng.uniform(0, 2 * np.pi)
        out += np.float32(slow_drift) * np.sin(
            2 * np.pi * rng.uniform(0.5, 2.0) * t + phase).astype(np.float32)
    return out


@dataclass
class Read:
    """What the mappers read of a read (the port's ``SimRead`` fields)."""
    id: str
    signal: np.ndarray
    number: int
    ref_start: int
    fwd: bool
    channel: int = 1
    start_sample: int = 0

    @property
    def raw_len(self):
        return len(self.signal)


def make_read(codes: np.ndarray, seed: int, i: int, params: dict,
              levels) -> Read:
    """Read ``i`` of the stream of ``seed`` over genome ``codes``."""
    rng = np.random.default_rng([seed, STREAM_READS, i])
    lo, hi = params["read_len_bp"]
    L = min(int(rng.integers(lo, hi + 1)), len(codes) - K)
    st = int(rng.integers(0, len(codes) - L + 1))
    frag = codes[st: st + L]
    fwd = bool(rng.integers(2))
    if not fwd:
        frag = (3 - frag)[::-1]
    mm = params["mismatch"]
    if mm:
        sig = signal_of(
            frag, levels, rng, params["mean_dwell"],
            noise=mm["noise"],
            drift_scale=float(rng.normal(1.0, mm["drift_scale_sd"])),
            drift_shift=float(rng.normal(0.0, mm["drift_shift_sd"])),
            stall_p=mm["stall_p"], skip_p=mm["skip_p"],
            slow_drift=mm["slow_drift"])
    else:
        sig = signal_of(frag, levels, rng, params["mean_dwell"])
    return Read(f"r{i:07d}_{st}_{'+' if fwd else '-'}", sig, i, st, fwd)


def _produce(q, codes, seed, params, first, step):
    """A producer process: reads ``first``, ``first + step``, ... into
    ``q`` until it is ended (``put`` blocks while the queue is full)."""
    levels = load_levels()
    i = first
    while True:
        q.put(make_read(codes, seed, i, params, levels))
        i += step


class ReadStream:
    """An endless stream of reads, pulled one at a time as slots free (a
    closed loop); ``stop()`` ends it at the next pull.  It has no length,
    so a mapper takes it in the order given.

    With ``ahead`` > 0, ``PRODUCERS`` processes make the reads (producer k
    those whose number is k modulo their count), and a thread of this
    process takes the first ``ahead`` of them, in order, into a local
    buffer while set-up goes on; ``fill()`` waits until they are all
    there.  Pulls then cost the consumer almost nothing until the buffer
    runs dry, and after that a pipe read and an unpickling (well under a
    millisecond) each.  ``close()`` ends the producers.  Without ``ahead``
    each pull makes its read (about a millisecond and a half).  ``wait_s``
    and ``waits`` add up the seconds and pulls spent in the stream while
    ``timing`` is true."""

    PRODUCERS = 4
    QUEUE = 64  # reads each producer makes ahead of the buffer

    def __init__(self, codes, seed, params, levels=None, ahead=0):
        self.codes, self.seed, self.params = codes, seed, params
        self.levels = levels or load_levels()
        self.pulled = 0
        self._stopped = False
        self.timing, self.wait_s, self.waits = False, 0.0, 0
        self._qs, self._procs, self._taker = [], [], None
        if ahead:
            import multiprocessing as mp
            import threading
            from collections import deque

            ctx = mp.get_context("spawn")
            self._buf = deque()
            n = self.PRODUCERS
            self._qs = [ctx.Queue(maxsize=self.QUEUE) for _ in range(n)]
            self._procs = [ctx.Process(target=_produce, daemon=True, args=(
                q, codes, seed, params, k, n))
                for k, q in enumerate(self._qs)]
            for p in self._procs:
                p.start()
            self._taker = threading.Thread(target=self._take, args=(ahead,),
                                           daemon=True)
            self._taker.start()

    def _next_made(self, i) -> Read:
        return self._qs[i % len(self._qs)].get(timeout=600.0)

    def _take(self, n):
        for i in range(n):
            self._buf.append(self._next_made(i))

    def fill(self):
        """Wait until the first ``ahead`` reads are in the local buffer."""
        if self._taker is not None:
            self._taker.join()

    def close(self):
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            p.join()
        if self._taker is not None:
            self._taker.join()
        for q in self._qs:
            q.close()
            q.join_thread()
        self._qs, self._procs = [], []

    def stop(self):
        self._stopped = True

    def __iter__(self):
        return self

    def _get(self) -> Read:
        while not self._buf:
            if not self._taker.is_alive():
                return self._next_made(self.pulled)
            time.sleep(0.0002)  # the taker has not got this one yet
        return self._buf.popleft()

    def __next__(self) -> Read:
        if self._stopped:
            raise StopIteration
        t0 = time.perf_counter()
        if self._qs:
            r = self._get()
            assert r.number == self.pulled, (r.number, self.pulled)
        else:
            r = make_read(self.codes, self.seed, self.pulled, self.params,
                          self.levels)
        if self.timing:
            self.wait_s += time.perf_counter() - t0
            self.waits += 1
        self.pulled += 1
        return r
