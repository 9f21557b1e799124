"""One rank of a multi-process run of the port's sharded engines.

    python -m uncalled_tpu_torch.testing.multihost_child \\
        <rank> <world> <init-file> <outdir> <case> [--device D] [--backend B]

Every rank joins one ``torch.distributed`` process group (a file store at
``<init-file>``), builds the mesh its case needs, runs the case and writes
``<outdir>/<case>.rank<rank>.json``; rank 0 also writes the gathered state
of the cases that compare one (``<outdir>/<case>.npz``).  ``--device``
defaults to the card (``cuda``: every rank on ``cuda:{rank % count}``);
``--backend`` defaults to ``gloo``, which takes CPU and CUDA tensors.
Each rank runs one intra-op thread.  Cases:

``sharded``  world 4 on a (2, 2) ``(dp, idx)`` mesh, or world 1 on (1, 1):
    the split of the tables, the divisibility errors, the golden reads of
    the JAX package's tests/test_sharded.py through ``BatchMapper`` on
    both sharded engines (:data:`GOLDEN_CASES`), the drain chain's refusal
    to migrate a sharded entry's state (:data:`DRAIN_READS`), and one
    ``advance`` of four golden reads on the pooled engine from a fresh
    state, its state gathered over dp;
``golden``  the split of the tables, the golden cases and the time of a
    sum over idx;
``multihost``  the dp-only layout of tests/test_multihost.py: each rank
    advances its ``SHARD_B`` reads of ``multihost_fixture`` one block, from
    the fresh state and from it with every slot reset, and rank 0 writes
    the ten decision keys of both gathered over the ranks;
``real``  the pooled sharded engine at real size on the index, thresholds
    and reads named by ``<outdir>/real.json`` (``chip_smoke.py`` phase 9).

The functions a rank runs are importable (``chip_smoke.py`` runs
:func:`golden_cases` in its own process at world size 1).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
PREFIX = os.path.join(FIXTURES, "example_index", "example_ref")

GOLDEN_SUBSET = [
    "sim_0000_Escherichia_coli_3854_+",
    "sim_0003_Escherichia_coli_6188_-",
]
MORE_READS = GOLDEN_SUBSET + [
    "sim_0002_Escherichia_coli_6254_+",
    "sim_0005_Escherichia_coli_3483_+",
]
# the cases of tests/test_sharded.py: name -> (engine, conf fields, engine
# overrides, read ids)
GOLDEN_CASES = {
    "classic": ("map", dict(batch_reads=4, remap_wide=False),
                dict(B=4, P=1024, C=1024, R=48, CL=128), GOLDEN_SUBSET),
    "pooled": ("pooled", dict(batch_reads=4, pooled=True,
                              pool_slots_per_read=512), {}, GOLDEN_SUBSET),
    "more_reads": ("pooled", dict(batch_reads=2, pooled=True,
                                  pool_slots_per_read=512,
                                  drain_shrink=False), {}, MORE_READS),
}
ADVANCE_READS = MORE_READS
ADVANCE_EVENTS = 20
# the divisibility checks: engine, overrides
BAD_SPLITS = (
    ("pooled", dict(B=3)), ("pooled", dict(S=4097)), ("pooled", dict(SC=5121)),
    ("pooled", dict(RE=1025)), ("pooled", dict(RT=6145)), ("map", dict(B=3)),
)
# a drain by migration from the sharded entry: B=8 (the smallest batch the
# conf's drain chain shrinks) with noise_1, which never decides, as the
# straggler left when the others have decided
DRAIN_READS = [
    "sim_0000_Escherichia_coli_3854_+", "sim_0001_Escherichia_coli_3623_-",
    "sim_0002_Escherichia_coli_6254_+", "sim_0003_Escherichia_coli_6188_-",
    "sim_0004_Escherichia_coli_5013_+", "sim_0005_Escherichia_coli_3483_+",
    "sim_0006_Escherichia_coli_5000_+", "noise_1",
]
DRAIN_CONF = dict(batch_reads=8, pooled=True, pool_slots_per_read=512)
DECISION_KEYS = ["evt_i", "mm_len", "mm_ref_st", "mm_r1", "mm_r2e", "n_cl",
                 "len_sum", "done", "q_rid", "q_total"]


class Read:
    def __init__(self, id, signal):
        self.id = id
        self.signal = np.asarray(signal, dtype=np.float32)
        self.channel, self.number, self.start_sample = 1, 0, 0

    @property
    def raw_len(self):
        return len(self.signal)


def example_assets():
    """The example index (from the in-repo BWA files), its thresholds, the
    pore model, the golden lines and the golden signals."""
    from ..index.bwa_compat import load_bwa_index
    from ..mapping.thresholds import load_uncl
    from ..poremodel import load_default

    with open(os.path.join(FIXTURES, "golden_pafs.json")) as f:
        golden = json.load(f)
    sigs = np.load(os.path.join(FIXTURES, "golden_reads.npz"),
                   allow_pickle=True)
    return (load_bwa_index(PREFIX), load_default(), load_uncl(PREFIX + ".uncl"),
            golden, sigs)


def make_mesh(world: int, backend: str, dims=("dp", "idx")):
    """The (dp, idx) mesh of the sharded cases: (2, 2) for four ranks,
    (1, 1) for one; a dp-only mesh of every rank for ``dims=("dp",)``."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (world,) if len(dims) == 1 else (max(world // 2, 1),
                                             2 if world > 1 else 1)
    return init_device_mesh("cuda" if backend == "nccl" else "cpu", shape,
                            mesh_dim_names=dims)


def _conf(**fields):
    from ..config import Conf

    conf = Conf()
    for k, v in fields.items():
        setattr(conf.engine, k, v)
    return conf


def sharded_engine(kind, fmi, model, th, conf, mesh, device, **over):
    from ..parallel import ShardedMapEngine, ShardedPooledEngine

    cls = ShardedPooledEngine if kind == "pooled" else ShardedMapEngine
    return cls(fmi, model, th, conf, mesh=mesh, device=device, **over)


def golden_cases(mesh, device, assets=None):
    """Map each case's golden reads through ``BatchMapper`` on a sharded
    entry engine: case -> {"lines": {read id: line}, "seconds": s,
    "ovf_why": {...}}."""
    from ..mapping.batch import BatchMapper

    fmi, model, th, _, sigs = assets or example_assets()
    out = {}
    for name, (kind, cf, over, rids) in GOLDEN_CASES.items():
        conf = _conf(**cf)
        t0 = time.time()
        eng = sharded_engine(kind, fmi, model, th, conf, mesh, device, **over)
        bm = BatchMapper(fmi, model, th, conf, engine=eng)
        lines = {p.rd_name: p.to_line()
                 for p in bm.map_reads([Read(r, sigs[r]) for r in rids])}
        out[name] = dict(lines=lines, seconds=time.time() - t0,
                         ovf_why=dict(bm.ovf_why),
                         ejects=[m.n_ejected for m in bm.tiers()])
    return out


def table_split(mesh, device, assets):
    """Each sharded table's rows on this rank and in all (padded)."""
    fmi, model, th, _, _ = assets
    out = {}
    for kind, over in (("map", dict(B=4, P=64, C=64, R=16, CL=32)),
                       ("pooled", {})):
        conf = _conf(batch_reads=4, pool_slots_per_read=512)
        eng = sharded_engine(kind, fmi, model, th, conf, mesh, device, **over)
        out[kind] = {k: [eng.local_rows(k), eng.padded_rows(k),
                         int(eng._tables[k].numel()
                             * eng._tables[k].element_size())]
                     for k in eng._tables}
        out[kind + "_local_B"] = eng._p_local.B
        if kind == "pooled":
            out["pooled_local_S"] = eng._p_local.S
    return out


def split_errors(mesh, device, assets):
    """The message of each divisibility error (BAD_SPLITS)."""
    fmi, model, th, _, _ = assets
    msgs = []
    for kind, over in BAD_SPLITS:
        try:
            sharded_engine(kind, fmi, model, th,
                           _conf(batch_reads=4, pool_slots_per_read=512),
                           mesh, device, **over)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


def drain_case(mesh, device, assets):
    """The conf's drain chain on a sharded entry (DRAIN_READS): the lines
    emitted and the error that stops the run where the drain would migrate
    the entry's state."""
    from ..mapping.batch import BatchMapper

    fmi, model, th, _, sigs = assets
    conf = _conf(**DRAIN_CONF)
    eng = sharded_engine("pooled", fmi, model, th, conf, mesh, device)
    bm = BatchMapper(fmi, model, th, conf, engine=eng)
    lines, error = {}, None
    try:
        for p in bm.map_reads([Read(r, sigs[r]) for r in DRAIN_READS]):
            lines[p.rd_name] = p.to_line()
    except ValueError as e:
        error = str(e)
    return dict(lines=lines, error=error, n_migrate=bm.n_migrate)


def gather_dp(eng, state):
    """The engine state gathered over dp: every key concatenated on axis 0
    in dp order, ``dm_pool`` (inert and the same on every rank) once."""
    import torch
    import torch.distributed as dist

    out = {}
    for k, v in state.items():
        v = v.contiguous()
        if k == "dm_pool":
            out[k] = v.cpu().numpy()
            continue
        parts = [torch.empty_like(v) for _ in range(eng._ax.ndp)]
        dist.all_gather(parts, v, group=eng._ax.dp_group)
        out[k] = torch.cat(parts, 0).cpu().numpy()
    return out


def advance_case(mesh, device, assets):
    """One advance of a T = evt_block block on the pooled engine (B=4) from
    a fresh state with every slot reset: the first ADVANCE_EVENTS events of
    four golden reads, so that they are still mapping at its end (they
    decide after 23-44); returns (inputs, gathered state)."""
    from ..mapping.batch import BatchMapper

    fmi, model, th, _, sigs = assets
    conf = _conf(**GOLDEN_CASES["pooled"][1])
    eng = sharded_engine("pooled", fmi, model, th, conf, mesh, device)
    bm = BatchMapper(fmi, model, th, conf, engine=eng)
    B, T = eng.params.B, bm.T
    means = np.zeros((B, T), np.float32)
    on = np.zeros((B, T), bool)
    for b, rid in enumerate(ADVANCE_READS[:B]):
        m = bm._prepare(Read(rid, sigs[rid])).means[:ADVANCE_EVENTS]
        means[b, : len(m)] = m
        on[b, : len(m)] = True
    state = eng.reset_slots(eng.fresh_state(), np.ones(B, bool))
    state = eng.advance(state, means, on)
    return dict(means=means, on=on), gather_dp(eng, state)


def sum_ms(mesh, device, n=3072, reps=50):
    """Milliseconds of one sum of an [n] int32 tensor over the idx group as
    the sharded walk makes it: ``ShardContext.all_reduce`` and the host
    copy that the walk's exit test reads."""
    import torch
    import torch.distributed as dist

    from ..ops.shard_take import ShardContext

    sh = ShardContext.of(mesh.get_group("idx"))
    t = torch.zeros(n, dtype=torch.int32, device=device)
    for _ in range(5):
        sh.all_reduce(t, host=True)
    dist.barrier(group=sh.group)
    t0 = time.perf_counter()
    for _ in range(reps):
        sh.all_reduce(t, host=True)
    return dict(ms=(time.perf_counter() - t0) * 1e3 / reps, n=n,
                backend=str(dist.get_backend(sh.group)))


def case_golden(args, mesh, device, assets=None):
    """The table split, the golden cases and the time of one sum over idx
    (``chip_smoke.py`` phase 9 (b))."""
    from ..ops import _cuda

    assets = assets or example_assets()
    res = {"tables": table_split(mesh, device, assets)}
    _cuda.reset_counts()
    res["golden"] = golden_cases(mesh, device, assets)
    res["launches"] = dict(_cuda.COUNTS)
    res["sum_ms"] = sum_ms(mesh, device)
    return res, None


def case_sharded(args, mesh, device):
    """``golden``, the divisibility errors, the drain refusal and one
    advance with its gathered state (the CPU tests)."""
    assets = example_assets()
    res, _ = case_golden(args, mesh, device, assets)
    res["errors"] = split_errors(mesh, device, assets)
    res["drain"] = drain_case(mesh, device, assets)
    inputs, state = advance_case(mesh, device, assets)
    return res, {**{"in_" + k: v for k, v in inputs.items()}, **state}


def case_multihost(args, mesh, device):
    import torch
    import torch.distributed as dist

    from ..mapping.pooled import (
        make_pool_state, pool_advance_block, reset_pool_rows,
    )
    from .multihost_fixture import SHARD_B, build_engine, global_inputs

    eng, T = build_engine(device)
    world = dist.get_world_size()
    means, on = global_inputs(world)
    r = dist.get_rank()
    sl = slice(r * SHARD_B, (r + 1) * SHARD_B)
    fresh = make_pool_state(eng.params, device)
    got = {}
    # the fresh state as the JAX test feeds it (every slot done, so the
    # block changes nothing), and with every slot reset to a live read
    for tag, state in (("", fresh), ("reset_", reset_pool_rows(
            fresh, torch.ones(SHARD_B, dtype=torch.bool, device=device)))):
        out = pool_advance_block(
            eng.idx, eng.params, state,
            torch.as_tensor(means[sl], device=device),
            torch.as_tensor(on[sl], device=device))
        for k in DECISION_KEYS:
            v = out[k].contiguous()
            parts = [torch.empty_like(v) for _ in range(world)]
            dist.all_gather(parts, v)
            got[tag + k] = torch.cat(parts, 0).cpu().numpy()
    return {"shard_B": SHARD_B, "T": T}, got


def block_pass(eng, bm, reads, blocks: int, timed: bool):
    """``blocks`` blocks of T events on the engine from a state with the
    first B of ``reads`` in its slots (the rest empty), outside any
    mapper; with ``timed`` the sums over idx are timed between two device
    synchronisations.  Returns (wall ms per event step, the sums' share of
    the wall, sums per step)."""
    B, T = eng.params.B, bm.T
    means = np.zeros((B, blocks * T), np.float32)
    on = np.zeros((B, blocks * T), bool)
    for b, r in enumerate(reads[:B]):
        m = bm._prepare(r).means[: blocks * T]
        means[b, : len(m)] = m
        on[b, : len(m)] = True
    sh = eng.idx["shard"]
    state = eng.reset_slots(eng.fresh_state(), on[:, 0])
    calls, secs = sh.calls, sh.seconds
    sh.timed = timed
    _sync(eng.device)
    t0 = time.perf_counter()
    for k in range(blocks):
        state = eng.advance(state, means[:, k * T: (k + 1) * T],
                            on[:, k * T: (k + 1) * T])
    _sync(eng.device)
    wall = time.perf_counter() - t0
    sh.timed = False
    steps = blocks * T
    return (wall * 1e3 / steps, (sh.seconds - secs) / wall,
            (sh.calls - calls) / steps)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def case_real(args, mesh, device):
    """The pooled sharded engine at real size (``chip_smoke.py`` phase 9):
    ``real.json`` names the index prefix, the reads (.npz of ids and
    signals) and the engine's conf fields and overrides.  One block warms
    the engine up; one block with the sums timed gives their share of a
    step; the mapping run itself is untimed, every sum as the engine
    makes it."""
    from ..index.fmindex import load_index
    from ..mapping.batch import BatchMapper
    from ..mapping.thresholds import load_uncl
    from ..ops import _cuda
    from ..poremodel import load_default

    with open(os.path.join(args.outdir, "real.json")) as f:
        spec = json.load(f)
    fmi = load_index(spec["prefix"])
    th = load_uncl(spec["prefix"] + ".uncl")
    model = load_default()
    rd = np.load(spec["reads"], allow_pickle=True)
    reads = [Read(str(i), s) for i, s in zip(rd["ids"], rd["signals"])]
    conf = _conf(**spec["conf"])
    eng = sharded_engine("pooled", fmi, model, th, conf, mesh, device,
                         **spec["over"])
    bm = BatchMapper(fmi, model, th, conf, engine=eng)
    sh = eng.idx["shard"]
    block_pass(eng, bm, reads, 1, False)
    timed_ms, share, sums = block_pass(eng, bm, reads, 1, True)
    sh.calls, sh.walk_steps = 0, 0
    _sync(device)
    _cuda.reset_counts()
    t0 = time.time()
    lines = {p.rd_name: p.to_line() for p in bm.map_reads(reads)}
    _sync(device)
    dt = time.time() - t0
    tiers = bm.tiers()
    steps = sum(m.disp_events // m.eng.params.B for m in tiers)
    steps0 = bm.disp_events // eng.params.B
    counts = dict(_cuda.COUNTS)
    return dict(
        lines=lines, seconds=dt, steps=steps, steps_entry=steps0,
        ms_per_step=dt * 1e3 / max(steps, 1),
        collective_calls=sh.calls,
        timed_block=dict(ms_per_step=timed_ms, collective_share=share,
                         sums_per_step=sums, steps=bm.T),
        walk_steps_per_event=sh.walk_steps / max(steps0, 1),
        walk_rounds_per_event=counts["sa_walk_step"] / max(steps0, 1),
        launches=counts,
        launches_per_step={k: v / max(steps, 1) for k, v in counts.items()},
        ovf_why=dict(bm.ovf_why), ejects=[m.n_ejected for m in tiers],
        table_bytes={k: int(t.numel() * t.element_size())
                     for k, t in eng._tables.items()},
        local_rows={k: eng.local_rows(k) for k in eng._tables},
        shapes=dict(B=eng.params.B, S=eng.params.S, SC=eng.params.SC,
                    CL=eng.params.CL, RT=eng.params.RT, T=bm.T,
                    local_B=eng._p_local.B, local_S=eng._p_local.S),
    ), None


CASES = {"sharded": case_sharded, "golden": case_golden,
         "multihost": case_multihost, "real": case_real}


def spawn(world: int, outdir: str, case: str, device: str = "cuda",
          backend: str = "gloo", timeout: float = 600.0):
    """Start ``world`` ranks of ``case`` as processes of this module (their
    output in ``<outdir>/<case>.log<rank>``); :func:`collect` waits."""
    import subprocess

    init = os.path.join(outdir, f"{case}.init")
    if os.path.exists(init):
        os.unlink(init)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for r in range(world):
        log = open(os.path.join(outdir, f"{case}.log{r}"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "uncalled_tpu_torch.testing.multihost_child",
             str(r), str(world), init, outdir, case, "--device", device,
             "--backend", backend, "--timeout", str(timeout)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def collect(procs, outdir: str, case: str, timeout: float):
    """Wait for the ranks (killing all of them if any outlives ``timeout``
    seconds in all); raise unless every rank exited 0.  Returns each
    rank's result dict and rank 0's arrays (or None)."""
    import subprocess

    deadline = time.time() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 0.1))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise RuntimeError(f"{case}: ranks still running after {timeout} s"
                           + _tails(outdir, case, len(procs)))
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"{case}: ranks {bad} failed"
                           + _tails(outdir, case, len(procs)))
    res = []
    for r in range(len(procs)):
        with open(os.path.join(outdir, f"{case}.rank{r}.json")) as f:
            res.append(json.load(f))
    npz = os.path.join(outdir, f"{case}.npz")
    arrays = dict(np.load(npz)) if os.path.exists(npz) else None
    return res, arrays


def _tails(outdir, case, world):
    out = []
    for r in range(world):
        path = os.path.join(outdir, f"{case}.log{r}")
        if os.path.exists(path):
            with open(path) as f:
                out.append(f"\n--- rank {r} ---\n" + f.read()[-3000:])
    return "".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("init_file")
    ap.add_argument("outdir")
    ap.add_argument("case", choices=sorted(CASES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..device import resolve

    torch.set_num_threads(1)
    device = resolve(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    t0 = time.time()
    dist.init_process_group(
        args.backend, init_method="file://" + os.path.abspath(args.init_file),
        rank=args.rank, world_size=args.world,
        timeout=datetime.timedelta(seconds=args.timeout))
    try:
        if device.type == "cuda":
            # one build of the kernels for the ranks that share a checkout
            from ..ops import _cuda

            if args.rank == 0:
                _cuda.build()
            dist.barrier()
        mesh = make_mesh(args.world, args.backend,
                         ("dp",) if args.case == "multihost" else
                         ("dp", "idx"))
        res, arrays = CASES[args.case](args, mesh, device)
        res = dict(res, rank=args.rank, world=args.world,
                   backend=args.backend, device=str(device),
                   seconds_total=time.time() - t0)
        base = os.path.join(args.outdir, f"{args.case}.rank{args.rank}")
        with open(base + ".json", "w") as f:
            json.dump(res, f)
        if args.rank == 0 and arrays is not None:
            np.savez(os.path.join(args.outdir, f"{args.case}.npz"), **arrays)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
