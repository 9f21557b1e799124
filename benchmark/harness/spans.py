"""Spans the benchmark times around its calls into the program's layers.

``Spans.wrap(obj, method, name)`` replaces a bound method on one object
by a timed one; the seconds add up under ``name`` while ``Spans.on`` is
true.  While ``intervals`` is a list (a profiled stretch), each call's
(name, start, end) on ``time.perf_counter``'s clock goes into it, so a
device idle gap can be labelled by the host span it fell in.
"""

from __future__ import annotations

import time
from collections import defaultdict


class Spans:
    def __init__(self):
        self.on = False
        self.total = defaultdict(float)
        self.count = defaultdict(int)
        self.intervals = None  # [(name, start, end)] while profiled
        self.hooks = []  # fn(name) called before each span starts

    def wrap(self, obj, method: str, name: str):
        orig = getattr(obj, method)

        def timed(*a, **k):
            for h in self.hooks:
                h(name)
            t0 = time.perf_counter()
            out = orig(*a, **k)
            t1 = time.perf_counter()
            if self.on:
                self.total[name] += t1 - t0
                self.count[name] += 1
            if self.intervals is not None:
                self.intervals.append((name, t0, t1))
            return out

        setattr(obj, method, timed)

    def snapshot(self) -> dict:
        return {k: dict(seconds=self.total[k], calls=self.count[k])
                for k in self.total}
