"""The bitonic candidate sort's kernels (port of ``uncalled_tpu.ops.sortkern``
and of the row sorts around it in ``uncalled_tpu.mapping.pooled``).

The network over int32 key tuples ``ks`` (each [NP], NP a power of two):
level k = 2, 4, ..., NP runs the XOR passes s = k/2, ..., 1; the partner of
i is i ^ s, a chunk sorts ascending iff (i & k) == 0, the comparison is
lexicographic over the whole tuple, and ties never swap.

- ``merge_level(ks, k_lv, C)``: the passes s = k_lv/2, ..., C of level
  ``k_lv`` (C a power of two >= 1; at C = 1 the level is finished).
- ``sort_runs(keys, NP, W)``: the keys padded with INT32_MAX to NP and
  sorted in runs of W, run r descending iff (r*W & k) != 0 with k = W (NP
  when W == NP): levels 2 ... W.
- ``rowsort_plain(ks, width, k_level)``: the row sort that finishes a level
  from stride ``width`` down, by stable ``torch.sort`` passes: the plain
  version of a level's tail and, with the padding, of ``sort_runs``.

Plain PyTorch versions (the XLA pass loop of the JAX ``_sort1d_bitonic``
and its ``lax.sort`` rows) plus one hand-written CUDA source
(``csrc/sortkern.cu``) that runs a *schedule*: launches, each a contiguous
stretch of the network's passes on one [NK, NP] buffer
(:func:`level_schedule`, :func:`run_schedule`; :func:`passes` lists a
launch's passes, which the CPU tests replay with numpy).  A pass changes
no bit where it swaps equal tuples, so kernel and plain versions are
bit-exact.
"""

from __future__ import annotations

import torch

from . import _cuda

I32 = torch.int32
INT32_MAX = 2**31 - 1
MAX_NK = 8
SMEM_MAX = 232448  # dynamic shared memory a block may take (bytes)
# the card's schedule (chip_smoke.py phase 2 sweeps them; the fastest on
# the H100 at the step's NP = 131072, PERF.md): run sort width,
# shared-memory tile of a level's tail, strides per device-memory launch
RUN_TILE = 1024
MERGE_TILE = 1024
FUSE_R = 3
_KIND = {"runs": 0, "tile": 1, "global": 2}


def _lex_lt(a, b):
    """Lexicographic a < b over tuples of int32 tensors."""
    out = eq = None
    for x, y in zip(a, b):
        lt = x < y
        if out is None:
            out, eq = lt, x == y
        else:
            out = out | (eq & lt)
            eq = eq & (x == y)
    return out


def _pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def _check_shape(ks, k_lv: int, C: int) -> int:
    NP = ks[0].shape[0]
    if not (_pow2(k_lv) and _pow2(C) and NP % k_lv == 0
            and k_lv % (2 * C) == 0):
        raise ValueError(f"merge_level: NP={NP} k_lv={k_lv} C={C} (need "
                         "powers of two, NP % k_lv == 0, k_lv % 2C == 0)")
    return NP


def _check_keys(ks, name: str, n: int, dev) -> None:
    if not 1 <= len(ks) <= MAX_NK:
        raise ValueError(f"{name}: {len(ks)} keys (1..{MAX_NK})")
    for q, k in enumerate(ks):
        _cuda.check(k, f"{name}.keys[{q}]", (I32,), 1, dev)
        if k.shape[0] != n:
            raise ValueError(f"{name}: key {q} has length {k.shape[0]}, "
                             f"expected {n}")


def tile_for(tile: int, NP: int, nk: int) -> int:
    """The shared-memory tile a launch takes: ``tile`` cut to NP and to the
    largest power of two whose nk planes fit in a block (at least 256)."""
    t = min(tile, NP)
    while nk * t * 4 > SMEM_MAX:
        t //= 2
    if t < 256 or not _pow2(t):
        raise ValueError(f"sortkern: tile {tile} at NP={NP} nk={nk} "
                         "(needs a power of two >= 256)")
    return t


def passes(launch):
    """The (k, s) passes of one launch, in network order."""
    _, _, kf, sf, kl, sl = launch
    out, k = [], kf
    while k <= kl:
        s = sf if k == kf else k // 2
        last = sl if k == kl else 1
        while s >= last:
            out.append((k, s))
            s //= 2
        k *= 2
    return out


def level_schedule(NP: int, k_lv: int, C: int, tile: int, r: int):
    """Launches of merge level ``k_lv``'s passes s = k_lv/2 ... C: the
    strides >= ``tile`` as device-memory launches of at most ``r`` strides
    each (balanced, wider first), the rest as one shared-memory tile
    launch.  Each launch is (kind, tile or strides, k_first, s_first,
    k_last, s_last)."""
    strides = []
    s = k_lv // 2
    while s >= C:
        strides.append(s)
        s //= 2
    wide = [s for s in strides if s >= tile]
    rest = [s for s in strides if s < tile]
    out = []
    n = -(-len(wide) // r)
    i = 0
    for j in range(n):
        size = len(wide) // n + (j < len(wide) % n)
        out.append(("global", size, k_lv, wide[i], k_lv, wide[i + size - 1]))
        i += size
    if rest:
        out.append(("tile", tile, k_lv, rest[0], k_lv, rest[-1]))
    return out


def run_schedule(NP: int, W: int):
    """The run sort: levels 2 ... W in one launch of W-element tiles."""
    return [("runs", W, 2, 1, W, 1)]


def sort_schedule(NP: int, W: int, tile: int, r: int):
    """The whole sort on the card: the runs of W, then each level 2W ... NP
    to stride 1 (what ``pooled._sort1d_bitonic`` launches)."""
    out = list(run_schedule(NP, W))
    k = 2 * W
    while k <= NP:
        out += level_schedule(NP, k, 1, tile, r)
        k *= 2
    return out


def _launch(sched, src, N: int, buf) -> None:
    """Run ``sched`` on ``buf``; ``src`` (the planes kind "runs" reads) is
    the buffer's own rows for a schedule without one."""
    src = src or list(buf.unbind(0))
    q = []
    for kind, a, kf, sf, kl, sl in sched:
        q += [_KIND[kind], a, kf, sf, kl, sl]
    _cuda.launch("sort_net_i32", src, buf.shape[0], N, buf, buf.shape[1], q,
                 len(sched))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def rowsort_plain(ks, width: int, k_level: int):
    """Row-parallel ascending lexicographic sort of [NP] int32 key tuples
    viewed as [NP/width, width] rows; row r descends iff (r*width &
    k_level) != 0, by the bitwise-NOT trick (~ reverses int32 order).
    Stable passes along dim 1, two keys per int64 pass (high key in the
    upper 32 bits, low key offset into [0, 2^32))."""
    NP = ks[0].shape[0]
    G = NP // width
    dev = ks[0].device
    desc = (((torch.arange(G, dtype=I32, device=dev) * width) & k_level)
            != 0)[:, None]
    ops = [torch.where(desc, torch.bitwise_not(a.reshape(G, width)),
                       a.reshape(G, width)) for a in ks]
    packed = []
    for q in range(len(ops) % 2, len(ops), 2):
        packed.append((ops[q].to(torch.int64) << 32)
                      + (ops[q + 1].to(torch.int64) + 2**31))
    if len(ops) % 2:
        packed.insert(0, ops[0])
    perm = None
    for k in reversed(packed):
        kk = k if perm is None else torch.gather(k, 1, perm)
        order = torch.sort(kk, dim=1, stable=True).indices
        perm = order if perm is None else torch.gather(perm, 1, order)
    return [torch.where(desc, torch.bitwise_not(r), r).reshape(NP)
            for r in (torch.gather(a, 1, perm) for a in ops)]


def _check_runs(keys, NP: int, W: int) -> int:
    N = keys[0].shape[0]
    if not (_pow2(NP) and _pow2(W) and W <= NP and N <= NP):
        raise ValueError(f"sort_runs: N={N} NP={NP} W={W} (need powers of "
                         "two NP and W, W <= NP, N <= NP)")
    return N


def sort_runs_plain(keys, NP: int, W: int):
    """The keys padded with INT32_MAX to NP, sorted in runs of W in the
    network's directions (the first row sort of the JAX sort)."""
    N = _check_runs(keys, NP, W)
    ks = [torch.cat([k, torch.full((NP - N,), INT32_MAX, dtype=I32,
                                   device=k.device)]) if NP > N else k
          for k in keys]
    return rowsort_plain(ks, W, W if W < NP else NP)


def merge_level_plain(ks, k_lv: int, C: int):
    NP = _check_shape(ks, k_lv, C)
    dev = ks[0].device
    s = k_lv // 2
    while s >= C:
        G = NP // (2 * s)
        up = ((torch.arange(G, dtype=I32, device=dev) * (2 * s))
              & k_lv) == 0
        v = [k.reshape(G, 2, s) for k in ks]
        a = [x[:, 0, :] for x in v]
        b = [x[:, 1, :] for x in v]
        swap = torch.where(up[:, None], _lex_lt(b, a), _lex_lt(a, b))
        ks = [
            torch.stack([torch.where(swap, bb, aa), torch.where(swap, aa, bb)],
                        1).reshape(NP)
            for aa, bb in zip(a, b)
        ]
        s //= 2
    return list(ks)


# ---------------------------------------------------------------------------
# wrappers: the plain version for CPU tensors, the kernel otherwise
# ---------------------------------------------------------------------------

def sort_runs(keys, NP: int, W: int):
    """``sort_runs_plain`` into a new [NK, NP] int32 buffer: on the card one
    launch that reads the keys where they lie (1-D int32, contiguous, one
    length N <= NP; W >= 256 and its tile must fit a block)."""
    keys = list(keys)
    if keys[0].device.type == "cpu":
        return torch.stack(sort_runs_plain(keys, NP, W))
    N = _check_runs(keys, NP, W)
    dev = keys[0].device
    _check_keys(keys, "sort_runs", N, dev)
    if tile_for(W, NP, len(keys)) != W:
        raise ValueError(f"sort_runs: W={W} does not fit a block at "
                         f"NK={len(keys)}")
    buf = torch.empty((len(keys), NP), dtype=I32, device=dev)
    _launch(run_schedule(NP, W), keys, N, buf)
    _cuda.COUNTS["sort_runs"] += 1
    return buf


def merge_level_(buf, k_lv: int, C: int) -> None:
    """``merge_level`` in place on the rows of a [NK, NP] int32 buffer: on
    the card the launches of :func:`level_schedule` (NP >= 256)."""
    if buf.device.type == "cpu":
        buf.copy_(torch.stack(merge_level_plain(list(buf.unbind(0)), k_lv,
                                                C)))
        return
    _cuda.check(buf, "merge_level.buf", (I32,), 2, buf.device)
    NK, NP = buf.shape
    _check_shape([buf[0]], k_lv, C)
    if not 1 <= NK <= MAX_NK:
        raise ValueError(f"merge_level: {NK} keys (1..{MAX_NK})")
    tile = tile_for(MERGE_TILE, NP, NK)
    _launch(level_schedule(NP, k_lv, C, tile, FUSE_R), [], 0, buf)
    _cuda.COUNTS["merge_level"] += 1


def merge_level(ks, k_lv: int, C: int):
    """All stride >= C XOR passes of bitonic merge level ``k_lv`` over the
    int32 key tuple ``ks`` (each [NP]; k_lv and C powers of two, NP % k_lv
    == 0, k_lv % (2C) == 0).  Returns new keys; the caller's stay as they
    were."""
    ks = list(ks)
    if ks[0].device.type == "cpu":
        return merge_level_plain(ks, k_lv, C)
    NP = _check_shape(ks, k_lv, C)
    _check_keys(ks, "merge_level", NP, ks[0].device)
    buf = torch.stack(ks)
    merge_level_(buf, k_lv, C)
    return list(buf.unbind(0))
