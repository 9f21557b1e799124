"""Piecewise CUDA-graph replay of the pooled engine's event step.

Eagerly the pooled step issues about 1150 launches an event, some 35 of
them the hand-written kernels' and the rest PyTorch ops, and on the card
the host's issue paces the engine, not the device.  ``BlockGraphs`` runs
the blocks of one shape of one ``PooledEngine`` from fixed buffers:

- The step, ``pooled._pool_event_step`` as ``pool_advance_block`` calls
  it, is captured once as a chain of CUDA graphs ("pieces") in one
  memory pool, and replayed in capture order at every event.  A piece is
  the step's PyTorch ops between two cuts; the step is cut at each call
  of a hand-written wrapper (:data:`SITES`) and at each phase marker, so
  that each piece lies in one phase of ``tracing``'s step spans.
- Every hand-written wrapper runs eagerly between the pieces at every
  event, called through its module attribute as the step calls it, on
  the arguments it had at capture (the same tensors, whose contents the
  replays renew).  Its result reaches the tensors the next pieces were
  captured on: through the wrapper's own ``out=`` (``colgather.gather``)
  or by one copy after the call.
- The state, the block's event columns, the standby windows and the
  promotions live in fixed buffers: a block copies in only what is not
  already its buffer; the step reads event column ``t`` of a device
  counter, and writes its new state back over the buffers it read (one
  foreach copy at the end of the last piece).  The state ``run`` returns
  is those buffers, valid until the next block.
- An index argument of a wrapper (a gather's ``idx``, the fold's
  ``rows_eff``) is read-only; one that lies in a buffer the runner writes
  by an eager copy is passed as a copy made inside the piece before the
  call, so that any index a wrapper has taken is written by replays
  only and never in place through an eager op.

The capture runs each piece as soon as it is captured and each wrapper
on its results, so the capturing block's first event is computed as the
eager step computes it.  Off the card ``BlockGraphs(..., graphs=False)``
runs the same cuts, buffers and copies with no graph (each piece's ops
run as the step reaches them): the CPU tests hold it to
``pool_advance_block``.
"""

from __future__ import annotations

import contextlib
import gc
import warnings

import numpy as np
import torch

from .. import tracing
from ..ops import colgather
from . import pooled

# the hand-written wrappers the pooled step reaches, by module attribute;
# each call is a cut
SITES = (
    (colgather, "gather"),
    (colgather, "gather_table"),
    (pooled, "pair_counts"),
    (pooled, "ring_assemble"),
    (pooled, "tracker_run_compact"),
    (pooled, "sort_runs"),
    (pooled, "merge_level_"),
    (pooled, "sa_lookup"),
)

# the read-only index argument of a wrapper: (position, keyword)
_INDEX_ARG = {
    "gather": (2, "idx"),
    "gather_table": (2, "idx"),
    "tracker_run_compact": (6, "rows_eff"),
}


def eligible(device, idx) -> bool:
    """The rule that sends a block to the graphs: CUDA tensors and an
    unsharded index (the sharded walk syncs with the host)."""
    return torch.device(device).type == "cuda" and idx.get("shard") is None


def _tensors(x) -> list:
    """The tensors of a wrapper's result, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = x.values()
    elif not isinstance(x, (list, tuple)):
        return []
    return [t for v in x for t in _tensors(v)]


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


class _Site:
    """One wrapper call of the step: the wrapper's module attribute, its
    arguments, the result the step saw at capture and the tensors of it
    that later pieces read."""

    __slots__ = ("mod", "name", "args", "kwargs", "result", "static",
                 "out")

    def __init__(self, mod, name, args, kwargs, result):
        self.mod, self.name = mod, name
        self.args, self.kwargs = args, dict(kwargs)
        self.result = result
        self.static = _tensors(result)
        # colgather.gather writes into its out=: no copy after the call
        self.out = mod is colgather and name == "gather"
        if self.out and "out" not in self.kwargs:
            self.kwargs["out"] = self.static[0]

    def call(self, fn, args, kwargs):
        """``fn`` on ``args``, its result in the capture's tensors; returns
        the capture's result."""
        if self.out:
            kwargs = dict(kwargs, out=self.static[0])
            fn(*args, **kwargs)
            return self.result
        new = _tensors(fn(*args, **kwargs))
        if len(new) != len(self.static):
            raise RuntimeError(f"graph step: {self.name} gave {len(new)} "
                               f"tensors, {len(self.static)} at capture")
        dst, src = [], []
        for s, n in zip(self.static, new):
            if n.data_ptr() != s.data_ptr():
                dst.append(s)
                src.append(n)
        if len(dst) == 1:
            dst[0].copy_(src[0])
        elif dst:
            torch._foreach_copy_(dst, src)
        return self.result

    def replay(self):
        self.call(getattr(self.mod, self.name), self.args, self.kwargs)


class _Recorder:
    """Cuts one function into pieces and wrapper calls.  With ``pool`` it
    captures each piece as a CUDA graph in that pool (and runs it at
    once); without, the pieces run eagerly and the wrapper calls are
    recorded at the first run and matched at each later one."""

    def __init__(self, pool, written: set):
        self.pool = pool
        self.written = written  # storages the runner writes by eager copy
        self.actions = []  # ("graph", g) | ("call", site) | ("mark", name)
        self.sites = []
        self.i = 0  # the next call of an eager run
        self.g = None
        self.inside = False  # inside a wrapper: its own calls pass through

    # -- pieces ------------------------------------------------------------
    def begin(self):
        """Open the next piece."""
        if self.pool is not None:
            self.g = torch.cuda.CUDAGraph()
            self.g.capture_begin(pool=self.pool,
                                 capture_error_mode="thread_local")

    def cut(self):
        """Close the open piece and run it."""
        if self.pool is None:
            return
        g, self.g = self.g, None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            g.capture_end()
        if any("empty" in str(w.message) for w in caught):
            return  # nothing ran between the two cuts
        g.replay()
        self.actions.append(("graph", g))

    def abort(self):
        """End a capture that raised, so the stream leaves capture mode."""
        g, self.g = self.g, None
        if g is not None:
            with contextlib.suppress(RuntimeError):
                g.capture_end()

    def mark(self, name):
        if self.pool is not None:
            self.cut()
            self.actions.append(("mark", name))
            self.begin()

    # -- wrapper calls -----------------------------------------------------
    def _own_indices(self, name, args, kwargs):
        """Pass an index that lies in a buffer the runner writes eagerly as
        a copy taken in the current piece."""
        spec = _INDEX_ARG.get(name)
        if spec is None:
            return args, kwargs
        pos, kw = spec
        if kw in kwargs:
            t = kwargs[kw]
            if isinstance(t, torch.Tensor) and _storage(t) in self.written:
                kwargs = dict(kwargs, **{kw: t.clone()})
        elif len(args) > pos:
            t = args[pos]
            if isinstance(t, torch.Tensor) and _storage(t) in self.written:
                args = args[:pos] + (t.clone(),) + args[pos + 1:]
        return args, kwargs

    def call(self, mod, name, fn, args, kwargs):
        args, kwargs = self._own_indices(name, args, kwargs)
        if self.pool is None and self.i < len(self.sites):
            site = self.sites[self.i]
            if site.mod is not mod or site.name != name:
                raise RuntimeError(f"graph step: call {self.i} is {name}, "
                                   f"{site.name} at the first run")
            self.i += 1
            self.inside = True
            try:
                return site.call(fn, args, kwargs)
            finally:
                self.inside = False
        self.cut()
        self.inside = True
        try:
            res = fn(*args, **kwargs)
        finally:
            self.inside = False
        site = _Site(mod, name, args, kwargs, res)
        if not site.out:
            self.written.update(_storage(t) for t in site.static)
        self.sites.append(site)
        self.i += 1
        if self.pool is not None:
            self.actions.append(("call", site))
            self.begin()
        return res


class _CutPhases:
    """The step's phase marker while it is cut: each marker is a cut,
    and goes on to the tracer's marker of the step."""

    __slots__ = ("rec", "ph")

    def __init__(self, rec, ph):
        self.rec, self.ph = rec, ph

    def __call__(self, name):
        self.ph(name)
        self.rec.mark(name)


@contextlib.contextmanager
def _cut_at_sites(rec):
    """Route every site's calls to ``rec`` while the step runs."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in SITES]

    def router(mod, name, fn):
        def route(*args, **kwargs):
            if rec.inside:
                return fn(*args, **kwargs)
            return rec.call(mod, name, fn, args, kwargs)
        return route

    for mod, name, fn in saved:
        setattr(mod, name, router(mod, name, fn))
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


class BlockGraphs:
    """``pool_advance_block`` for blocks of T events (standby windows W
    wide with the handoff) from fixed buffers; see the module docstring.
    ``graphs`` False runs the same plumbing with no graph."""

    def __init__(self, idx, p, T: int, W: int, device, graphs: bool = True):
        self.idx, self.p, self.T, self.W = idx, p, T, W
        self.device = torch.device(device)
        self.graphs = graphs
        self.st = None  # the state buffers, allocated at the first block
        self.prologue = self.step = None  # the recorded actions
        self._eager = [None, None]  # the eager runs' recorders
        self.captured = False  # a block has run (and been captured)

    # -- buffers -----------------------------------------------------------
    def _alloc(self, state):
        B, T, W, dev = self.p.B, self.T, self.W, self.device
        self.st = {k: torch.empty_like(v) for k, v in state.items()}
        self.means = torch.empty((B, T), dtype=torch.float32, device=dev)
        self.on = torch.empty((B, T), dtype=torch.bool, device=dev)
        self.t = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.sb = None
        self.sb_live = True  # the windows hold something to clear
        if self.p.handoff:
            self.sb = pooled._zero_windows(B, W // 2, dev)
        self.st_storages = {_storage(t) for t in self.st.values()}
        self.written = {_storage(t) for t in self._buffers()}

    def _buffers(self):
        yield from self.st.values()
        yield self.means
        yield self.on
        if self.sb is not None:
            yield from self.sb

    def _load(self, state, means, on, sb):
        """Copy the block's inputs into the buffers (what already is its
        buffer is left as it is)."""
        if self.st is None:
            self._alloc(state)
        dst, src = [], []
        for k, buf in self.st.items():
            v = state[k]
            if v is not buf:
                dst.append(buf)
                src.append(v)
        if dst:
            torch._foreach_copy_(dst, src)
        self.means.copy_(torch.from_numpy(np.asarray(means, np.float32)))
        self.on.copy_(torch.from_numpy(np.asarray(on, bool)))
        if self.sb is None:
            return
        if sb is not None:
            for buf, a, dt in zip(self.sb, sb, (np.float32, bool, bool,
                                                bool)):
                buf.copy_(torch.from_numpy(np.asarray(a, dt)))
            self.sb_live = True
        elif self.sb_live:
            for buf in self.sb:
                buf.zero_()
            self.sb_live = False

    # -- what is captured --------------------------------------------------
    def _prologue(self, ph):
        """The block's start: t = 0 and pool_advance_block's promotions."""
        self.t.zero_()
        st, self.win = pooled._block_windows(self.p, self.st, self.means,
                                             self.sb)
        if st["sw"] is not self.st["sw"]:
            self.st["sw"].copy_(st["sw"])

    def _step(self, ph):
        """One event: column t of the block, the step, its new state
        written over the buffers it read, t + 1."""
        ev = self.means.index_select(1, self.t)[:, 0]
        ev_on = self.on.index_select(1, self.t)[:, 0]
        out = pooled._pool_event_step(self.idx, self.p, self.st, ev, ev_on,
                                      sb=self.win, ph=ph)
        dst, src = [], []
        for k, buf in self.st.items():
            v = out[k]
            if v is not buf:
                if _storage(v) in self.st_storages:
                    raise RuntimeError(f"graph step: the new {k} lies in a "
                                       "state buffer")
                dst.append(buf)
                src.append(v)
        torch._foreach_copy_(dst, src)
        self.t += 1

    # -- running -----------------------------------------------------------
    def _record(self, fn, ph, pool):
        rec = _Recorder(pool, self.written)
        with _cut_at_sites(rec):
            if pool is not None:
                rec.begin()
            try:
                fn(_CutPhases(rec, ph))
                rec.cut()
            except BaseException:
                rec.abort()
                raise
        return rec

    def _capture(self):
        """Capture the prologue and the step, running both once.  The
        cyclic garbage collector is run first and kept off meanwhile: it
        may free another runner's graphs, and destroying a graph while
        this thread captures ends the capture in an error."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        pool = torch.cuda.graph_pool_handle()
        gc.collect()
        was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                self.prologue = self._record(self._prologue, tracing.NOOP,
                                             pool).actions
                ph = tracing.phases("engine.step")
                self.step = self._record(self._step, ph, pool).actions
                ph.end()
        finally:
            if was_on:
                gc.enable()
        cur.wait_stream(side)

    def _eager_run(self, fn, which, ph):
        """One eager run of the prologue (0) or the step (1): the first
        records the wrapper calls, each later one matches them."""
        rec = self._eager[which]
        if rec is None:
            rec = self._eager[which] = _Recorder(None, self.written)
        rec.i = 0
        with _cut_at_sites(rec):
            fn(_CutPhases(rec, ph))
        if rec.i != len(rec.sites):
            raise RuntimeError(f"graph step: {rec.i} calls, "
                               f"{len(rec.sites)} at the first run")

    @staticmethod
    def _replay(actions, ph):
        for kind, a in actions:
            if kind == "mark":
                ph(a)
            else:  # a graph or a wrapper call
                a.replay()

    def run(self, state, means, on, sb=None) -> dict:
        """One block: ``state`` and the host arrays ``means``/``on`` [B, T]
        (and with the handoff ``sb`` = (sb_means [B, W], sb_on [B, W],
        armed [B], promote [B]) or None for nothing armed); returns the
        new state, which is this runner's buffers."""
        with tracing.span("engine.upload"):
            self._load(state, means, on, sb)
        first = 0
        if not self.graphs:
            self._eager_run(self._prologue, 0, tracing.NOOP)
        elif self.step is None:
            self._capture()
            first = 1
        else:
            self._replay(self.prologue, tracing.NOOP)
        for _ in range(first, self.T):
            ph = tracing.phases("engine.step")
            if self.graphs:
                self._replay(self.step, ph)
            else:
                self._eager_run(self._step, 1, ph)
            ph.end()
        self.captured = True
        return dict(self.st)
