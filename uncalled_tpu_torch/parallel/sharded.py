"""Sharded FM-index mapping engines over ``torch.distributed`` (port of
``uncalled_tpu.parallel.sharded``: the >1 Gb layout).

The replicated engines keep ~1-5 bytes of device memory per reference
base; beyond ~1 Gb the index must shard.  Layout, on a 2-D
``DeviceMesh`` with dimensions ``(dp, idx)``:

* ``dp``: read slots (the batch dimension of all engine state), and the
  pooled engine's pool segments and its batch-total budgets (S, SC, RE,
  RT), split over the dp ranks; reads are independent, so no collective
  runs on this axis inside a step.
* ``idx``: the big FM tables (``occ_rows``, and ``sa_samp`` or ``sa``),
  row-sharded in contiguous blocks, padded to the idx multiple; each rank
  answers the occ and SA queries that fall in its block and a sum over
  the idx group combines the answers (``mapping.engine._shard_take``, the
  ``shard_take`` kernel; the LF-walk in rounds of local runs, one sum a
  round, ``ops.sa_lookup``).

It runs SPMD, one process per rank.  Every rank runs the same
``BatchMapper`` loop over the same reads: ``advance`` takes the global
host ``[B, T]`` arrays and feeds the rank's dp slice, and the readout is
gathered over dp, so every rank's host loop makes the same decisions.
The engines use the groups of the mesh they are given and pick no backend.
Eject tiers, drains and ladder rungs built from a sharded entry are
ordinary single-device engines on each rank, as in the JAX package.

Byte-exactness: the sharded gathers give the replicated takes' values,
so the golden PAF lines hold (tests/test_torch_sharded.py, four ``gloo``
ranks against JAX's sharded engines on a (2, 2) CPU mesh).
"""

from __future__ import annotations

import os
from dataclasses import replace

import numpy as np
import torch

from ..config import Conf
from ..convert import index_from_numpy
from ..device import resolve
from ..mapping.engine import (
    EngineParams, MapEngine, index_arrays, make_state, readout_get,
    readout_start, reset_rows,
)
from ..mapping.pooled import (
    PooledEngine, PoolParams, make_pool_state, reset_pool_rows,
)
from ..ops.shard_take import ShardContext

DRAIN_MIGRATION_REFUSED = (
    "a sharded entry engine cannot hand its state to a drain mapper (the "
    "JAX package's migrate_pool_state fails on dp-sharded state); set "
    "conf.engine.drain_shrink = False"
)


def _pad_rows(a: np.ndarray, mult: int) -> np.ndarray:
    extra = (-len(a)) % mult
    if extra:
        pad = [(0, extra)] + [(0, 0)] * (a.ndim - 1)
        a = np.pad(a, pad)
    return a


def _rank_device(device) -> torch.device:
    """``device``, or by default this rank's CUDA card
    (``cuda:{LOCAL_RANK % device_count}``); raises without a card unless
    the caller asks for the CPU."""
    if device is not None:
        return resolve(device)
    resolve("cuda")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


class _Axes:
    """The two axes of the mesh as this rank sees them: sizes, process
    groups and this rank's index in each group."""

    def __init__(self, mesh, dp_axis: str, idx_axis: str):
        import torch.distributed as dist

        names = tuple(mesh.mesh_dim_names or ())
        for a in (dp_axis, idx_axis):
            if a not in names:
                raise ValueError(f"mesh dimensions {names} lack {a!r}")
        self.ndp = mesh.size(names.index(dp_axis))
        self.nix = mesh.size(names.index(idx_axis))
        self.dp_group = mesh.get_group(dp_axis)
        self.idx_group = mesh.get_group(idx_axis)
        self.dp_rank = dist.get_rank(self.dp_group)
        self.idx_rank = dist.get_rank(self.idx_group)


class _ShardedBase:
    """What both sharded engines share: the tables split over idx, the dp
    slice of the host arrays and the readout gathered over dp."""

    def _build_index(self, fmi, threshes, model, big_keys, sampled_sa,
                     sa_intv):
        ax = self._ax
        base = index_arrays(fmi, threshes, model, sampled_sa=sampled_sa,
                            sa_intv=sa_intv)
        local, self._padded = {}, {}
        for k in big_keys:
            a = _pad_rows(np.asarray(base[k]), ax.nix)
            per = len(a) // ax.nix
            self._padded[k] = len(a)
            local[k] = a[ax.idx_rank * per: (ax.idx_rank + 1) * per]
        small = {k: v for k, v in base.items() if k not in big_keys}
        self.idx = index_from_numpy({**small, **local}, device=self.device)
        self.idx["shard"] = ShardContext.of(ax.idx_group)
        self._tables = {k: self.idx[k] for k in big_keys}

    def local_rows(self, key: str) -> int:
        """This rank's rows of the sharded table ``key`` (its padded row
        count over the idx ranks)."""
        return int(self._tables[key].shape[0])

    def padded_rows(self, key: str) -> int:
        """All rows of the sharded table ``key``, padded to the idx
        multiple."""
        return self._padded[key]

    def _dp_slice(self, a):
        Bl = self._p_local.B
        r = self._ax.dp_rank
        return a[r * Bl: (r + 1) * Bl]

    def _host_block(self, means, on):
        means = np.asarray(means, np.float32)
        on = np.asarray(on, bool)
        return (torch.as_tensor(np.ascontiguousarray(self._dp_slice(means)),
                                device=self.device),
                torch.as_tensor(np.ascontiguousarray(self._dp_slice(on)),
                                device=self.device))

    def _local_mask(self, mask):
        return torch.as_tensor(
            np.ascontiguousarray(self._dp_slice(np.asarray(mask, bool))),
            device=self.device)

    def readout_start(self, state):
        """The packed [K, B] readout of every dp shard: the rank's [K, B/ndp]
        gathered over dp on the device (both ``gloo`` and NCCL take CUDA
        tensors), shard order on axis 1."""
        import torch.distributed as dist

        loc = readout_start(state, self.READOUT_KEYS).contiguous()
        parts = [torch.empty_like(loc) for _ in range(self._ax.ndp)]
        dist.all_gather(parts, loc, group=self._ax.dp_group)
        return torch.cat(parts, 1)

    def readout_get(self, packed):
        return readout_get(packed, self.READOUT_KEYS)

    def readout(self, state):
        return self.readout_get(self.readout_start(state))


class ShardedMapEngine(_ShardedBase, MapEngine):
    """The classic engine over a (dp, idx) mesh with row-sharded
    ``occ_rows`` and ``sa_samp``: MapEngine's fresh_state / advance /
    readout surface for ``BatchMapper``; the state is this rank's dp slice.

    ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` with
    dimensions ``dp_axis`` and ``idx_axis``; ``device`` defaults to this
    rank's card."""

    def __init__(self, fmi, model, threshes, conf: Conf | None = None,
                 mesh=None, dp_axis: str = "dp", idx_axis: str = "idx",
                 device=None, **over):
        if mesh is None:
            raise ValueError("ShardedMapEngine needs a DeviceMesh")
        self.conf = conf or Conf()
        over.setdefault("mxu", False)
        over.setdefault("sampled_sa", True)
        self.params = p = EngineParams.from_conf(self.conf, **over)
        ax = _Axes(mesh, dp_axis, idx_axis)
        if p.B % ax.ndp:
            raise ValueError(f"batch {p.B} not divisible by dp={ax.ndp}")
        if not p.sampled_sa:
            raise ValueError("ShardedMapEngine shards the 1/sa_intv SA "
                             "sample; sampled_sa must be True")
        self.device = _rank_device(device)
        self.mesh = mesh
        self._ax = ax
        self.fmi = fmi
        self.model = model
        self._p_local = replace(p, B=p.B // ax.ndp)
        self._build_index(fmi, threshes, model, ("occ_rows", "sa_samp"),
                          True, p.sa_intv)

    def fresh_state(self):
        return make_state(self._p_local, self.device)

    def reset_slots(self, state, mask):
        return reset_rows(state, self._local_mask(mask))

    def advance(self, state, means, on):
        from ..mapping.engine import advance_block

        m, o = self._host_block(means, on)
        return advance_block(self.idx, self._p_local, state, m, o)


class ShardedPooledEngine(_ShardedBase, PooledEngine):
    """The pooled engine over a (dp, idx) mesh: read slots and their pool
    segments split over dp, the occ buckets and the SA (the 1/sa_intv
    sample by default) over idx.  Every batch-total budget (B, S, SC, RE,
    RT) is split over the dp ranks and must divide by their count, so each
    rank runs the standard step on its B/ndp-read pool; per-read budgets
    (PC, R, FS, CL) are untouched.  Physical-cut ``ovf`` flags can differ
    from the unsharded engine where a burst overflows a rank's share of a
    budget but not the whole; those reads rerun on the eject tiers.

    The defaults pinned are the JAX engine's: the flat candidate sort, no
    slot handoff (its ``advance`` has no standby lane), the sampled SA;
    ``mxu``, ``tracker_kernel``, ``stepkern`` and ``sortkern`` are
    accepted so both packages take the same overrides (on the card the
    port's kernels are its only path).  The genome-scaled sizing of
    ``PooledEngine`` (n >= 150 M) is skipped, as in JAX, so params and
    state shapes equal JAX's."""

    def __init__(self, fmi, model, threshes, conf: Conf | None = None,
                 mesh=None, dp_axis: str = "dp", idx_axis: str = "idx",
                 device=None, **over):
        if mesh is None:
            raise ValueError("ShardedPooledEngine needs a DeviceMesh")
        self.conf = conf or Conf()
        for k, v in (("mxu", False), ("sort_mode", "flat"),
                     ("tracker_kernel", False), ("stepkern", False),
                     ("sortkern", False), ("handoff", False),
                     ("sampled_sa", True)):
            over.setdefault(k, v)
        self.params = p = PoolParams.from_conf(self.conf, **over)
        ax = _Axes(mesh, dp_axis, idx_axis)
        for name, v in (("B", p.B), ("S", p.S), ("SC", p.SC),
                        ("RE", p.RE), ("RT", p.RT)):
            if v % ax.ndp:
                raise ValueError(f"{name}={v} not divisible by dp={ax.ndp}")
        self.device = _rank_device(device)
        self.mesh = mesh
        self._ax = ax
        self.fmi = fmi
        self.model = model
        n = ax.ndp
        self._p_local = replace(p, B=p.B // n, S=p.S // n, SC=p.SC // n,
                                RE=p.RE // n, RT=p.RT // n)
        self._build_index(
            fmi, threshes, model,
            ("occ_rows", "sa_samp" if p.sampled_sa else "sa"),
            p.sampled_sa, p.sa_intv)
        self.graph_captures = self.graph_steps = self.eager_steps = 0

    def fresh_state(self):
        # the dead-slot marker q_rid is the local B: each rank's step runs
        # B/ndp read slots and its read ids are rank-local
        return make_pool_state(self._p_local, self.device)

    def reset_slots(self, state, mask):
        return reset_pool_rows(state, self._local_mask(mask))

    def check_migrate(self):
        raise ValueError(DRAIN_MIGRATION_REFUSED)

    def advance(self, state, means, on):
        """Eager always: the sharded walk syncs with the host, so no block
        of a sharded engine is captured (``graphs.eligible``)."""
        from ..mapping.pooled import pool_advance_block

        m, o = self._host_block(means, on)
        self.eager_steps += m.shape[1]
        return pool_advance_block(self.idx, self._p_local, state, m, o)
