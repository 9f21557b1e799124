"""Spans of the host loop, the engine and the pooled step, kept in memory.

The tracer is off by default.  ``enable()`` turns it on and forgets what
it kept before; ``disable()`` turns it off and closes every span still
open at that instant; ``snapshot()`` gives what it kept.  Nothing is
written out while it runs.

A span has a name, a start and an end on :data:`clock`
(``time.perf_counter``), its parent (the index of the span it opened
inside, -1 for none) and the number of the host loop's block it belongs
to: ``block()`` opens a ``host_loop.block`` span under a new number, and
every span opened after it carries that number, so all the spans of one
block share it.  Per-name totals hold seconds, calls and self seconds (a
span's time less that of the spans opened inside it).

The sites::

    with tracing.span("engine.upload"):          # a region
        ...
    @tracing.traced("engine.advance")            # a whole function
    def advance(...): ...
    ph = tracing.phases("engine.step")           # sequential markers:
    ph("probs")                                  # "step.probs" opens where
    ...                                          # the step opened, each
    ph("decide")                                 # marker closes the phase
    ph.end()                                     # before it, and the
                                                 # phases tile the step

While the tracer is off, ``span``, ``block`` and ``phases`` test one
attribute and return the shared no-op :data:`NOOP`; ``traced`` calls the
function straight through.

There is one tracer a process, driven from the host loop's thread alone
(the DSP pool's threads record nothing).  Closing a span closes the
spans still open inside it at the same instant, so a step that raises
leaves no span open once an enclosing span closes.
"""

from __future__ import annotations

import functools
import time

clock = time.perf_counter


class _Noop:
    """What every site gets while the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, name):  # a phase marker
        pass

    def close(self, t=None):
        pass

    def end(self):
        pass


NOOP = _Noop()


class Span:
    __slots__ = ("tracer", "i", "name", "start", "end", "parent", "block",
                 "child_s")

    def __init__(self, tracer, i, name, start, parent, block):
        self.tracer, self.i, self.name = tracer, i, name
        self.start, self.end = start, None
        self.parent, self.block = parent, block
        self.child_s = 0.0  # seconds of the spans closed inside it

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.tracer.close(self)
        return False

    def close(self, t=None):
        """End the span at ``t`` (default: now); a no-op once ended."""
        self.tracer.close(self, t)


class Phases:
    """Sequential phase spans inside one step span (see ``phases``)."""

    __slots__ = ("tracer", "step", "prefix", "cur")

    def __init__(self, tracer, name):
        self.tracer = tracer
        self.step = tracer.open(name)
        self.prefix = name.rsplit(".", 1)[-1] + "."
        self.cur = None

    def __call__(self, name):
        if self.cur is None:  # the first phase starts with the step
            t = self.step.start
        else:
            t = clock()
            self.tracer.close(self.cur, t)
        self.cur = self.tracer.open(self.prefix + name, t)

    def end(self):
        self.tracer.close(self.step)  # the open phase ends with it


class Tracer:
    def __init__(self):
        self.on = False
        self._clear()

    def _clear(self):
        self.spans = []  # every span opened, in the order they opened
        self.totals = {}  # name -> [seconds, calls, self seconds]
        self.counts = {}  # counter name -> sum
        self.stack = []  # the open spans, innermost last
        self.n_block = 0

    def enable(self):
        self.disable()
        self._clear()
        self.on = True

    def disable(self):
        if self.stack:
            self.close(self.stack[0])
        self.on = False

    def open(self, name, t=None) -> Span:
        stack = self.stack
        sp = Span(self, len(self.spans), name, clock() if t is None else t,
                  stack[-1].i if stack else -1, self.n_block)
        self.spans.append(sp)
        stack.append(sp)
        return sp

    def close(self, sp, t=None):
        if sp.end is not None:  # ended already (by disable or its parent)
            return
        if t is None:
            t = clock()
        while True:
            top = self.stack.pop()
            top.end = t
            d = t - top.start
            tot = self.totals.get(top.name)
            if tot is None:
                tot = self.totals[top.name] = [0.0, 0, 0.0]
            tot[0] += d
            tot[1] += 1
            tot[2] += d - top.child_s
            if top.parent >= 0:
                self.spans[top.parent].child_s += d
            if top is sp:
                return

    def snapshot(self) -> dict:
        """``spans``: (name, start, end, parent, block) in the order they
        opened (end None while open); ``totals``: name -> seconds, calls,
        self_seconds over the closed spans."""
        return dict(
            spans=[(s.name, s.start, s.end, s.parent, s.block)
                   for s in self.spans],
            totals={k: dict(seconds=v[0], calls=v[1], self_seconds=v[2])
                    for k, v in self.totals.items()})


TRACER = Tracer()


def enable():
    TRACER.enable()


def disable():
    TRACER.disable()


def snapshot() -> dict:
    return TRACER.snapshot()


def counts() -> dict:
    """Counter name -> the sum counted while the tracer was on."""
    return dict(TRACER.counts)


def count(name, n=1):
    """Add ``n`` to counter ``name`` (nothing while the tracer is off)."""
    if TRACER.on:
        TRACER.counts[name] = TRACER.counts.get(name, 0) + n


def span(name, t=None):
    """A span opened now (or at ``t``, a :data:`clock` reading), to close
    with ``with`` or ``close``."""
    return TRACER.open(name, t) if TRACER.on else NOOP


def block():
    """The ``host_loop.block`` span of one pass of the host loop, under
    the next block number."""
    if not TRACER.on:
        return NOOP
    TRACER.n_block += 1
    return TRACER.open("host_loop.block")


def phases(name):
    """Span ``name`` and a marker: ``ph(x)`` closes the phase before it
    and opens ``<last part of name>.x``, the first at the span's start;
    ``ph.end()`` closes the last phase and the span at one instant."""
    return Phases(TRACER, name) if TRACER.on else NOOP


def traced(name):
    """Decorator: each call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*a, **k):
            if not TRACER.on:
                return fn(*a, **k)
            with TRACER.open(name):
                return fn(*a, **k)
        return run
    return wrap
