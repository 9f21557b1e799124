"""Reads of a mock community: a share from the indexed genome (the target),
the rest from a genome the index does not hold (the other members).

Read ``i`` of a run is a function of (seed, i) alone: whether it is on
target, drawn from (seed, i), then ``reads.make_read`` over that genome.
Its name carries the stream position and the side it came from
(``r<7 digits>_<start>_<strand>_on`` or ``..._off``).

Mix parameters: those of ``reads.make_read`` and ``on_target`` (the share
of reads from the target genome).
"""

from __future__ import annotations

import numpy as np

from .reads import ReadStream, load_levels, make_read

STREAM_SIDE = 5  # SeedSequence key of the on/off-target draw


def on_target(seed: int, i: int, share: float) -> bool:
    return bool(np.random.default_rng([seed, STREAM_SIDE, i]).random()
                < share)


def make_mixed_read(target, other, seed: int, i: int, params: dict, levels):
    """Read ``i`` of the community stream of ``seed``."""
    on = on_target(seed, i, params["on_target"])
    r = make_read(target if on else other, seed, i, params, levels)
    r.id += "_on" if on else "_off"
    return r


def _produce(q, genomes, seed, params, first, step):
    """A producer process: reads ``first``, ``first + step``, ... into
    ``q`` until it is ended."""
    levels = load_levels()
    i = first
    while True:
        q.put(make_mixed_read(*genomes, seed, i, params, levels))
        i += step


class MixedStream(ReadStream):
    """``reads.ReadStream`` over the community: the same producers, buffer
    and pulls, with each read made by :func:`make_mixed_read`."""

    def __init__(self, target, other, seed, params, levels=None, ahead=0):
        self.other = other
        super().__init__(target, seed, params, levels, ahead=0)
        if ahead:
            self._start(ahead)

    def _start(self, ahead):
        import multiprocessing as mp
        import threading
        from collections import deque

        ctx = mp.get_context("spawn")
        self._buf = deque()
        n = self.PRODUCERS
        self._qs = [ctx.Queue(maxsize=self.QUEUE) for _ in range(n)]
        self._procs = [ctx.Process(target=_produce, daemon=True, args=(
            q, (self.codes, self.other), self.seed, self.params, k, n))
            for k, q in enumerate(self._qs)]
        for p in self._procs:
            p.start()
        self._taker = threading.Thread(target=self._take, args=(ahead,),
                                       daemon=True)
        self._taker.start()

    def __next__(self):
        if not self._qs:  # no producers: made here
            if self._stopped:
                raise StopIteration
            r = make_mixed_read(self.codes, self.other, self.seed,
                                self.pulled, self.params, self.levels)
            self.pulled += 1
            return r
        return super().__next__()
