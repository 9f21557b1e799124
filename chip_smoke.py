#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py            # every phase (needs one CUDA card)
    python3 chip_smoke.py --phases 1,2

Phases (each prints its own lines; the last line of stdout is the JSON
verdict, printed only when every phase passed):

1. the card (``nvidia-smi`` name and power limit), torch/CUDA versions,
   and the build of every kernel from ``uncalled_tpu_torch/csrc`` (ptxas's
   registers, stack and spills; the LF-walk kernels' local-memory
   instructions in ``cuobjdump -sass``);
2. each kernel against its plain PyTorch version on the card, on seeded
   inputs at the main paths' full shapes (pooled: B=256, S=98304,
   SC=122880, CL=2048, RT=6144, RING=23 (and an S with S*RING % 4 != 0),
   the bitonic merge levels of the candidate sort at the JAX kernel's
   strides at NP=131072 and the wide tier's NP=32768, the run sort and the
   merge level to stride 1 at NP 8192 ... 131072, padded and with whole
   tuples tied; classic: the
   row gathers of the B=64 rung and the final rung, the row fold at
   B=64/CL=1024/R=256 and B=32/CL=4096/R=1024): bits must be equal;
   kernel, plain and (where one PyTorch call computes the same function)
   library device times (the merge level at its headline stride only; a
   plain version of thousands of launches a call, the row fold's and the
   LF-walk's, by CUDA events); the column gathers at the three sites that
   once packed their fields into a table (pooled parent pack, the
   unified record table's five segments, classic parent pack), each
   against that pack plus one library gather; the whole bitonic sort
   against the flat sort, with its launches, each launch's device time
   and 48 schedules (run width, tile, fused strides) held to it; both
   forms of both tracker folds (the table in
   shared memory up to CL=8192, in device memory above) at the widths the
   mappers use, in three occupancy regimes and on an adversarial tie
   case, with the launches of each form; the timed folds' longest read
   and microseconds a row; the pair count on adversarial keys (one cell,
   runs of 32 and 33, all out of domain, sorted, K % 4 = 3, K = 0, an
   unaligned view) and its device time at three block widths beside an
   empty kernel and an empty cooperative launch with one grid barrier;
   the LF-walk SA lookup on every row of the example index (intv 32 and
   24); the run sort, the merge levels to stride 1 and the whole bitonic
   sort at the realtime engine's SC=184320 (NP=262144), and its compact
   fold (B=512, half the threads a read), pair count into [512, 1024]
   and ring assembly (S=147456); the streaming
   event detector (``csrc/detect.cu``) on seeded pA signal at B=512,
   S=4096 over three carried blocks with rows reset mid-stream and on a
   zero-padded block of reads of random lengths (against the plain version
   on the card) and on the 14 golden reads as rows at S=4096 and S=512
   (against the plain version's outputs and states from the CPU worker
   below), with its device time on the seeded and the padded block, the
   repair rounds of its scan, its bound (the larger of its bytes and its
   f64 operations) and the old design's serial floor (S steps of a serial
   scan, one step timed by a probe on one thread), and its t-stats'
   divisions by the window widths against the division instructions on
   every f32 input and 2^31 f64 ones; the sharded engines'
   two kernels: the shard-local
   row gather (``csrc/shard.cu``) over phase 4's occ_rows split in 2 and
   in 4 (2*SC rows, F=6) and its 1/32 SA sample (RT rows, F=1), every
   block, rows in no shard and the padding rows among them, and the
   sharded LF-walk's local run (``csrc/sa_lookup.cu`` ``sa_walk_step``)
   on every row of the example index at intv 32 and 24 on both blocks of
   a split in 2, its rounds summed into the whole walk against
   ``sa_lookup``; each timed at one rank's shapes in phase 9 (c), the
   walk step with its chain bound (longest local run x a measured
   dependent-load latency), its step's latency on one thread over the
   genome's real LF chain (``probe_lf_chain``) and its floor (the same
   launch on rows that take no step);
3. the 14 golden reads on the example index through ``BatchMapper``, on
   the pooled engine and on the classic engine, each with the full SA and
   with the 1/32 SA sample (the LF-walk kernel, in every engine of the
   chain; noise_1, which never decides, runs whole once: classic with the
   full SA; the pooled engine maps its first NOISE_CUT samples, held to
   the port's CPU run): every PAF line byte-identical to
   ``tests/fixtures/golden_pafs.json``, with every kernel of the path
   launched; a pooled eject tier, a narrow classic remap ladder (one
   read), and pooled tiers that chain to the classic final rung each give
   the golden lines; so do the conf defaults' paths, each shown to have
   run: the slot handoff (B=2, three reads), handoff with the tail-mode
   disarm, the drain chain and the bitonic merge levels (B=8), the drain
   by migration, all 14 reads (noise_1 whole) at B=4 with every block
   after an engine's first replaying the step's CUDA graphs
   (``mapping/graphs.py``), and the classic entry's drain by restart; the
   graph replay against ``pool_advance_block`` bit for bit on every state
   key after every block at the defaults' shapes (B=256, T=32, bitonic),
   with and without the handoff, over 4 and 3 blocks with reads switched,
   promoted and reset between them (``testing/graph_check.py``); then the
   realtime cases on the card, each equal to the port's own result with
   ``device="cpu"`` from the worker (timing tags stripped):
   ``map_ordered`` (chunk-ordered replay), the deplete ``run_sim_loop``
   case of tests/test_realtime.py (4 channels, 6 reads, cut to 10
   simulated seconds), ``BatchMapper`` with ``device_dsp`` on the 13
   golden reads that decide (the detector's launches on this path are the
   kernels line's), and ``dump_read``'s three files; the port's oracle
   (``mapping/oracle.py``, host numpy) on the 14 golden reads, computed by
   the worker, every line byte-identical to the golden one; the FM-range
   arithmetic (``ranges.py``) on tensors on the card, equal to its numpy
   results;
4. pooled at real size: a 4.7 Mb repeat-bearing genome, its index and
   thresholds built here (bench.py's genome and reads: two of its reads
   must be tie_reads.npz's signals bit for bit), 8 warm-up reads with the
   7 tie reads of tests/fixtures/tie_reads.npz (untimed: their lines,
   ``mt`` stripped, must be the reference rig's of tie_pafs.json) + 512
   timed simulated reads at B=256
   (reads/s, ms per event step, mapped/correct fractions, ejects per tier,
   launches per kernel per step, peak device memory, the idle share of one
   profiled block); kernel inputs captured from live steps are re-checked
   against the plain versions bit for bit, and the fold is timed on the
   captured step with the longest read; every read is yielded; then the
   LF-walk lookup on the genome's index (seeded rows at RT and B*R with
   the ends, the primary row and the 64 longest walks, against the plain
   version and the walk model from the full SA; its device time, byte and
   chain bounds, its step's latency and floor as the walk step's, and its
   time warm and after an L2 flush by CUDA events), and the first 256
   timed reads again with the 1/32 SA
   sample at B=256: lines equal to the full SA's, ms and launches per
   step, the SA's and the index's device bytes, live lookups re-checked,
   the lookup's device time a launch inside a profiled step;
5. classic at real size: the same genome and reads, ``pooled = False`` at
   the conf defaults (B=64, P=1024, C=1024, CE=1280, R=256, CL=1024, T=64
   and the default remap ladder), 8 warm-up + 64 timed reads, with the
   same measures plus reads per ladder rung and a profiled block on the
   rung that ran the most steps, and the same re-check of captured kernel
   inputs; every read is yielded;
6. pooled at the conf defaults (slot handoff, drain chain, bitonic sort)
   on the first 320 of phase 4's timed reads at B=256, T=32: reads/s, ms
   per step, slot
   utilisation over every mapper of the chain, handoffs, migrations, the
   drain widths, ejects per tier, launches per kernel per step, peak
   memory, a profiled block; the first full-width sort's run-sort and
   merge-level inputs are re-checked against the plain versions; every
   read is yielded, with the
   very line phase 4 gave it;
7. realtime at 512 channels: bench_sim.py's configuration (288 pool slots
   a read, the first 1024 reads of phase 4's generator dealt by
   ``default_pattern``, ``SimClock`` ticks of 0.3 s, deplete) on phase 4's
   genome, 6 simulated seconds (bench_sim.py runs 30): realtime factor,
   decisions, ej / en / ovf give-ups, eject latency on the sim clock, wall
   ms per update, peak device memory, and the fraction of mapped decisions
   that meet the truth rule (gate 0.90); after the timed window, on the
   live state, the inputs of every pooled kernel (one whole NP=262144
   sort among them) are captured and re-checked against the plain
   versions bit for bit, and one update is traced (device ms, idle share,
   kernels per step);
8. the command line (``uncalled_tpu_torch.__main__.main``, in-process),
   its fast5 input through a stand-in for ``io.fast5.load_fast5`` (an
   .npz of int16 raw data and attributes, calibrated by the port's own
   ``_calibrate``, on every machine: the card's PyTorch installation
   has no h5py):
   ``index`` on the example FASTA (the .uncl byte-identical to the
   in-repo one); on the 13 golden reads that decide, quantized to int16
   and dealt over 4 channels, ``map`` at the CLI's defaults (pooled,
   B=64, the conf defaults), ``map --ord`` and ``map --engine-pooled
   false`` on 4 reads, and ``sim`` on a 4-channel ``--conf`` for 10
   simulated seconds under a SimClock, each equal to the port's own
   ``--device cpu`` run from the worker and each launching its kernels;
   then ``map`` at the CLI's defaults on phase 4's genome (index and
   thresholds saved under one prefix) and 128 of its reads: reads/s from
   the first fast5 read to the last PAF line, ms per event step, mapped
   and correct fractions (every read yielded, mapped >= 0.95), peak
   device memory;

9. the sharded engines (``uncalled_tpu_torch.parallel``) through
   ``BatchMapper``, on the cases of the JAX package's tests/test_sharded.py
   (2 golden reads at B=4 on ``ShardedMapEngine`` and
   ``ShardedPooledEngine``, 4 at B=2 on the pooled one): (a) NCCL at
   world size 1, mesh (1, 1), in this process, every line golden and
   every kernel of both engines launched, the two sharded kernels among
   them; (b) four ``gloo`` ranks on this card (``testing/multihost_child``
   processes), mesh (2, 2): the same lines on every rank, each rank
   holding half the padded rows of occ_rows and the SA sample, and one
   sum over idx timed; (c) four ranks at real size:
   phase 4's index and thresholds saved under a prefix, ``N_SHARDED`` of
   its timed reads at B=256 (128 a dp rank), S=98304, SC=122880, CL=2048,
   RT=6144, T=32, the 1/32 SA sample: every read yielded, each line
   phase 4's (but for reads a rank's share of a budget sent to an eject
   tier), mapped >= 0.95; ms per event step of the untimed run (after a
   block of warm-up), the sums' share of a step (a separate block with
   every sum timed between two synchronisations), walk steps and rounds
   per event, each rank's table bytes, launches per step.  Four ranks on
   one card time gloo through the host, not the layout over NVLink;
10. the reference rig's lines on phase 4's genome: the port's oracle on
    the 7 tie reads in both tie orders, computed by two host workers (one
    process of one thread a tie order, the index built from phase 4's
    .fa, started as soon as phase 4's assets are on disk, so they run
    beside phases 2-9): the stable order's lines must equal tie_pafs.json
    and the introsort order's tie_pafs_stdsort.json (``mt`` stripped);

then the ``{"kernels": [...]}`` line and the verdict.  The CPU references
of the realtime, oracle and CLI checks run in a worker process (this
script with ``--cpu-refs``, no card) beside phases 1-3, and end with the
run.

Imports nothing of JAX.  Exits non-zero without a CUDA card, or when run
outside a checkout of the repository.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# published device-memory rates (bytes/s) by card name; default H100 SXM
_HBM_RATE = (("H200", 4.8e12), ("PCIe", 2.0e12), ("H100", 3.35e12))

B_FULL, SPR, CL_FULL = 256, 384, 2048
S_FULL = B_FULL * SPR  # 98304
SC_FULL = S_FULL + S_FULL // 4  # 122880
RT_FULL = 24 * B_FULL  # 6144
RING = 23
# timed reads of phases 4 (and 6) and 5 (phase 5 cut from 256 to 128 to
# make room for phase 7 in the time limit, and to 64 for phase 8: no
# fewer than its B=64 slots, so the timed run starts with every slot live)
N_POOLED, N_CLASSIC = 512, 64
# phase 6's timed reads: the first of phase 4's (cut from 512 to make room
# for phase 9; more than its 256 slots, so reads wait and the handoff runs)
N_DEFAULTS = 320
N_SAMPLED = 256  # phase 4's sampled-SA run: the first of its timed reads
POOLED_KERNELS = ("flat_gather", "pair_counts", "ring_assemble",
                  "tracker_fold")
CLASSIC_KERNELS = ("row_gather", "tracker_fold_rows")
# the pooled path at the conf defaults (phase 6) adds the bitonic sort's
DEFAULT_KERNELS = POOLED_KERNELS + ("sort_runs", "merge_level")
NK_SORT = 5  # the step's candidate sort keys

KERNELS = {
    "flat_gather": dict(
        route="cuda", source="uncalled_tpu_torch/csrc/flat_gather.cu",
        replaces="uncalled_tpu/ops/flat_gather.py:113"),
    "pair_counts": dict(
        route="cuda", source="uncalled_tpu_torch/csrc/flat_gather.cu",
        replaces="uncalled_tpu/ops/flat_gather.py:376"),
    "ring_assemble": dict(
        route="cuda", source="uncalled_tpu_torch/csrc/stepkern.cu",
        replaces="uncalled_tpu/ops/stepkern.py:71"),
    "tracker_fold": dict(
        route="cuda", source="uncalled_tpu_torch/csrc/tracker_kernel.cu",
        replaces="uncalled_tpu/ops/tracker_kernel.py:224"),
    "row_gather": dict(
        route="cuda", source="uncalled_tpu_torch/csrc/row_gather.cu",
        replaces="uncalled_tpu/ops/mxu_gather.py:95 and :157"),
    "tracker_fold_rows": dict(
        route="cuda", source="uncalled_tpu_torch/csrc/tracker_kernel.cu",
        replaces="uncalled_tpu/ops/tracker_kernel.py:190"),
    "merge_level": dict(
        route="cuda", source="uncalled_tpu_torch/csrc/sortkern.cu",
        replaces="uncalled_tpu/ops/sortkern.py:69"),
    # no Pallas kernel: the XLA row sorts (lax.sort) of the JAX sort
    "sort_runs": dict(
        route="cuda", source="uncalled_tpu_torch/csrc/sortkern.cu",
        replaces="uncalled_tpu/mapping/pooled.py:379-397"),
    # no Pallas kernel: the XLA while_loop of the JAX LF-walk
    "sa_lookup": dict(
        route="cuda", source="uncalled_tpu_torch/csrc/sa_lookup.cu",
        replaces="uncalled_tpu/mapping/engine.py:338-383"),
    # no Pallas kernel: the lax.scan of the JAX streaming event detector
    "detect": dict(
        route="cuda", source="uncalled_tpu_torch/csrc/detect.cu",
        replaces="uncalled_tpu/ops/events.py:338-471"),
    # no Pallas kernel: the local half of the JAX sharded row gather
    # (before its psum over idx)
    "shard_take": dict(
        route="cuda", source="uncalled_tpu_torch/csrc/shard.cu",
        replaces="uncalled_tpu/mapping/engine.py:262-272"),
    # no Pallas kernel: one iteration of the JAX LF-walk under shard_map
    "sa_walk_step": dict(
        route="cuda", source="uncalled_tpu_torch/csrc/sa_lookup.cu",
        replaces="uncalled_tpu/mapping/engine.py:338-381"),
    # no Pallas kernel: the two-level associative_scan of the JAX step's
    # segmented running max
    "seg_running_max": dict(
        route="cuda", source="uncalled_tpu_torch/csrc/seg_scan.cu",
        replaces="uncalled_tpu/mapping/pooled.py:439-484"),
}
# the device event detector (phase 2 at B=512, S=4096 over three blocks);
# its f64 operations a sample and the H100 SXM's FP64 vector peak (NVIDIA
# data sheet), its operation bound
DET_B, DET_S, DET_NB = 512, 4096, 3
DET_F64_OPS, DET_F64_PEAK_TFLOPS = 29, 34.0
# phase 3's realtime cases: simulated seconds of the deplete sim case (the
# JAX test runs 120; its six reads cycle; cut from 20 to 10 for phase 8),
# events in the debug dump
SIM3_SECS, DUMP_EVENTS = 10.0, 256
# phase 7, bench_sim.py's configuration cut from 30 to 10 simulated
# seconds, and to 6 for phase 9: channels, pool slots a read, reads
# dealt, seconds, tick, and the truth-rule gate on the mapped decisions
RT_CH, RT_SPR, RT_READS, RT_SECS, RT_TICK = 512, 288, 1024, 6.0, 0.3
RT_TRUTH_MIN = 0.90
SC_RT = RT_CH * RT_SPR + RT_CH * RT_SPR // 4  # 184320: NP = 262144
# the sampled-SA paths add the LF-walk lookup to each engine's kernels
SAMPLED_POOLED = POOLED_KERNELS + ("sa_lookup",)
SAMPLED_CLASSIC = CLASSIC_KERNELS + ("sa_lookup",)
SA_INTV = 32
# probe.cu holds measurement probes (an empty launch, a pointer chase), no
# kernel of the mapper
STEMS = ("detect", "flat_gather", "probe", "row_gather", "sa_lookup",
         "seg_scan", "shard", "sortkern", "stepkern", "tracker_kernel")
# phase 9, the sharded engines: their two kernels, the reads of (c) (the
# first of phase 4's timed reads), and each rank start's time limit
SHARD_KERNELS = ("shard_take", "sa_walk_step")
N_SHARDED = 64
SHARD_TIMEOUT_S = 420
# the segmented running max's headline widths: SC of the realtime cell
# (S widened to 294,912) and of the batch cell (NP of its sort), and the
# classic step's [B, CE] rows
SEG_SHAPES = ((368640,), (131072,), (64, 1280))
# kernels the pooled step launches inside its graph pieces, with their
# device kernels' names: a replay launches them with no wrapper call, so
# _cuda.COUNTS misses them, and their launches are read off a device trace
IN_GRAPH = {"seg_running_max": ("tile_aggregates", "tile_scan")}


_T0 = time.time()


def log(*a):
    """A line of the run's log, after the seconds since the start."""
    print(f"{time.time() - _T0:7.1f}", *a, flush=True)


def hbm_rate(name: str) -> float:
    for key, rate in _HBM_RATE:
        if key in name:
            return rate
    return 3.35e12


def bits(t):
    """Raw 32-bit (or bool) view for bit-for-bit comparison."""
    import torch

    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    return t


def same_bits(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return set(a) == set(b) and all(same_bits(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(bits(a), bits(b))
    )


def time_ms(fn, reps=20, warm=3):
    """Median milliseconds of ``fn()`` on the card (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return float(np.median(ts))


DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


def trace_events(prof, tag, cats=DEVICE_CATS):
    """Events of the given categories of a torch.profiler run (by default
    the device activity: kernels, memsets, copies), read from its chrome
    trace (written under the build directory; a run exports once)."""
    from uncalled_tpu_torch.ops._cuda import BUILD_DIR

    path = os.path.join(BUILD_DIR, f"trace_{tag}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    evs = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in evs if e.get("cat") in cats]


def window_us(evs, n, cats=DEVICE_CATS):
    """Split a trace's events of ``cats`` by the ``smoke_window_<i>``
    annotations (i < n) their start falls in: (events, events inside a
    window, microseconds of each window).  The annotations' spans on the
    card's timeline are used where the trace has them; else the host's,
    shifted so that the first event does not start before window 0 (the
    two clocks can drift apart over a long process)."""
    def spans(cat):
        w = [None] * n
        for e in evs:
            name = e.get("name", "")
            if e.get("cat") == cat and name.startswith("smoke_window_") \
                    and int(name[13:]) < n:
                t = float(e["ts"])
                w[int(name[13:])] = (t, t + float(e["dur"]))
        return w

    dev = sorted((e for e in evs if e.get("cat") in cats),
                 key=lambda e: float(e["ts"]))
    wins = spans("gpu_user_annotation")
    if None in wins:
        wins = spans("user_annotation")
        if dev and wins[0] is not None:
            lag = max(0.0, wins[0][0] - float(dev[0]["ts"]))
            wins = [w and (w[0] - lag, w[1] - lag) for w in wins]
    us = [0.0] * n
    seen = 0
    for e in dev:
        t = float(e["ts"])
        for i, w in enumerate(wins):
            if w is not None and w[0] <= t <= w[1]:
                us[i] += float(e.get("dur", 0))
                seen += 1
                break
    return len(dev), seen, us


def _median_of_full(trace, tries=6):
    """Call ``trace()`` -> (device events, ms per call of each fn, or None
    for an unusable trace) until three usable traces hold the largest
    event count seen (at most ``tries``); the median of each fn over
    those, or None when no trace was usable.  A profiler trace now and
    then loses device events: a short count marks it."""
    runs = []
    for _ in range(tries):
        n_dev, ms = trace()
        if n_dev and ms is not None:
            runs.append((n_dev, ms))
        n_max = max((n for n, _ in runs), default=0)
        full = [m for n, m in runs if n == n_max]
        if n_max and len(full) >= 3:
            break
    if not runs:
        return None
    return [float(np.median([m[i] for m in full]))
            for i in range(len(full[0]))]


def device_ms(fns, tag="call", sources=None):
    """Device milliseconds per call of each ``fn`` of ``fns``, a list of
    (fn, reps): the sum of the kernels, memsets and copies that start
    inside its window — the card's own time, free of the host's issue
    time that CUDA events around a short call also catch.  One profiler
    session traces every fn in turn, each ``reps`` calls and a synchronize
    inside a ``record_function`` window of its own; a trace counts when
    every device event falls in a window and every window holds some.
    Where no trace does, each fn is traced in sessions of its own and all
    their device events count; a fn whose traces all come back empty (the
    profiler has lost one-block launches) is timed by CUDA events around
    its calls, launch included.  A ``sources`` list gets, for each fn,
    "profiler" or "cuda_events"."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    def windows():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i, (fn, reps) in enumerate(fns):
                with record_function(f"smoke_window_{i}"):
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
        n_dev, seen, us = window_us(
            trace_events(prof, tag, DEVICE_CATS + ("user_annotation",
                                                   "gpu_user_annotation")),
            len(fns))
        if seen != n_dev or not all(us):  # a window lost its kernels
            return n_dev, None
        return n_dev, [u / 1e3 / r for u, (_, r) in zip(us, fns)]

    def alone(fn, reps, name):
        def trace():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            evs = trace_events(prof, name)
            return len(evs), [sum(float(e.get("dur", 0)) for e in evs)
                              / 1e3 / reps]
        return trace

    for fn, _ in fns:
        fn()
    torch.cuda.synchronize()
    ms = _median_of_full(windows)
    src = ["profiler"] * len(fns)
    if ms is None:
        log(f"[timing] {tag}: device events outside the windows in every "
            "trace; one session per call instead")
        ms = []
        for i, (fn, reps) in enumerate(fns):
            one = _median_of_full(alone(fn, reps, f"{tag}_{i}"))
            if one is None:
                log(f"[timing] {tag}_{i}: the profiler recorded no device "
                    "activity; CUDA events around the call instead")
                one = [time_ms(fn, reps=max(reps, 3))]
                src[i] = "cuda_events"
            ms += one
    if sources is not None:
        sources += src
    return ms


# ---------------------------------------------------------------------------
# seeded kernel inputs at the main path's shapes
# ---------------------------------------------------------------------------

def gather_case(rng, dev):
    """The assembly pack: 10 fields over the unified record table
    (3*SC + B*FS + S rows), S indices, some out of range."""
    import torch

    NU = 3 * SC_FULL + B_FULL * 256 + S_FULL
    tbl = rng.integers(-2**31, 2**31 - 1, size=(NU, 10), dtype=np.int64)
    idx = rng.integers(-4, NU + 4, size=S_FULL)
    return (torch.from_numpy(tbl.astype(np.int32)).to(dev),
            torch.from_numpy(idx.astype(np.int32)).to(dev))


def pair_case(rng, dev):
    import torch

    a = rng.integers(-2, B_FULL + 3, size=SC_FULL)
    b = rng.integers(-3, 1024 + 5, size=SC_FULL)
    return (torch.from_numpy(a.astype(np.int32)).to(dev),
            torch.from_numpy(b.astype(np.int32)).to(dev))


def ring_case(rng, dev, S=S_FULL):
    import torch

    old = rng.integers(-2**31, 2**31 - 1, size=(S, RING),
                       dtype=np.int64).astype(np.int32)
    special = np.array([0, -2**31, 0x7F800000, -8388608, 0x7FC00001,
                        -1], np.int64).astype(np.int32)  # +0 -0 inf -inf nan
    old.reshape(-1)[rng.integers(0, old.size, 4096)] = rng.choice(
        special, 4096)
    rsrc = rng.integers(-1, S, size=S).astype(np.int32)
    rslot = rng.integers(-1, RING, size=S).astype(np.int32)
    rval = rng.integers(-2**31, 2**31 - 1, size=S,
                        dtype=np.int64).astype(np.int32)
    rval[rng.integers(0, S, 512)] = rng.choice(special, 512)
    keep = rng.random(S) < 0.9
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (t(old).view(torch.float32), t(rsrc), t(rslot),
            t(rval).view(torch.float32), t(keep))


def tracker_case(rng, dev, B=B_FULL, CL=CL_FULL, RT=RT_FULL, fill=0.7):
    """Contested cluster tables (few distinct keys, many ties) at
    occupancy ``fill`` and row windows that fill most of RT."""
    import torch

    occ = rng.random((B, CL)) < fill
    valid = occ & (rng.random((B, CL)) < 0.9)
    r1 = rng.integers(0, 400, (B, CL))
    tab = {
        "cl_valid": valid, "cl_count": occ,
        "cl_ref_st": r1 - rng.integers(0, 30, (B, CL)),
        "cl_r1": r1, "cl_r2e": r1 + rng.integers(-5, 30, (B, CL)),
        "cl_evt_st": rng.integers(0, 50, (B, CL)),
        "cl_evt_en": rng.integers(0, 120, (B, CL)),
        "cl_total": rng.integers(1, 60, (B, CL)),
    }
    st = {k: torch.from_numpy(np.ascontiguousarray(
        v if v.dtype == bool else v.astype(np.int32))).to(dev)
        for k, v in tab.items()}
    sc = {
        "len_sum": rng.integers(0, 5000, B).astype(np.float32),
        "n_cl": rng.integers(0, CL, B), "mm_len": rng.integers(0, 80, B),
        "mm_ref_st": rng.integers(0, 400, B), "mm_r1": rng.integers(0, 400, B),
        "mm_r2e": rng.integers(0, 400, B), "mm_evt_st": rng.integers(0, 50, B),
        "mm_evt_en": rng.integers(0, 120, B),
        "ovf": rng.random(B) < 0.1, "ovf_why": rng.integers(0, 32, B),
    }
    for k, v in sc.items():
        if v.dtype not in (np.float32, bool):
            v = v.astype(np.int32)
        st[k] = torch.from_numpy(v).to(dev)
    rows = rng.integers(0, 2 * RT // B, B)
    st_w = np.concatenate([[0], np.cumsum(rows)[:-1]])
    rows = np.minimum(rows, np.maximum(RT - st_w, 0))
    st_w = np.minimum(st_w, RT)
    mc = rng.integers(1, 40, RT)
    ren = rng.integers(0, 420, RT) + mc
    evt = rng.integers(0, 130, RT)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa
    return st, t(ren), t(mc), t(evt), t(st_w), t(rows)


def sort_keys_case(rng, dev, n):
    """Step-like candidate sort keys at n slots, tie-heavy: read (few
    values, INT32-max-free), start, end, a seed-probability sort key with
    few values, and the creation index."""
    import torch

    ks = [rng.integers(0, B_FULL + 1, n), rng.integers(0, 40, n),
          rng.integers(0, 40, n), rng.integers(-3, 3, n), np.arange(n)]
    return [torch.from_numpy(k.astype(np.int32)).to(dev) for k in ks]


def row_gather_case(rng, dev, B, N, F, K, f32=False):
    """A per-row table [B, N, F] (or shared [N, F] when B is None) of random
    32-bit patterns (f32 with NaN payloads, signed zeros and infinities
    mixed in) and [B or 64, K] indices, some out of range."""
    import torch

    shape = (N, F) if B is None else (B, N, F)
    tbl = rng.integers(-2**31, 2**31 - 1, size=shape,
                       dtype=np.int64).astype(np.int32)
    if f32:
        special = np.array([0, -2**31, 0x7F800000, -8388608, 0x7FC00001,
                            0x7F800001], np.int64).astype(np.int32)
        tbl.reshape(-1)[rng.integers(0, tbl.size, 4096)] = rng.choice(
            special, 4096)
    idx = rng.integers(-4, N + 4, size=(B or 64, K)).astype(np.int32)
    t = torch.from_numpy(tbl).to(dev)
    return (t.view(torch.float32) if f32 else t,
            torch.from_numpy(idx).to(dev))


def gather_bytes(tbl, idx, shared) -> int:
    """Bytes a clamped gather must move: each distinct table row it reads
    once (per batch row for a per-row table, once in all for a shared
    one), each index once and each output element once."""
    import torch

    N, F = tbl.shape[-2], tbl.shape[-1]
    ix = idx.clamp(0, N - 1).long()
    if not shared:
        ix = ix + torch.arange(ix.shape[0], device=ix.device)[:, None] * N
    rows = int(torch.unique(ix).numel())
    es = tbl.element_size()
    return rows * F * es + idx.numel() * (idx.element_size() + F * es)


def rand32(rng, shape, f32=False):
    """Random 32-bit patterns as int32 numpy; f32 ones with NaN payloads,
    signed zeros and infinities mixed in (return them viewed as f32)."""
    a = rng.integers(-2**31, 2**31 - 1, size=shape,
                     dtype=np.int64).astype(np.int32)
    if f32:
        special = np.array([0, -2**31, 0x7F800000, -8388608, 0x7FC00001,
                            0x7F800001], np.int64).astype(np.int32)
        n = max(8, a.size // 64)
        a.reshape(-1)[rng.integers(0, a.size, n)] = rng.choice(special, n)
        return a.view(np.float32)
    return a


def keep(t):
    """A copy of a captured tensor in its own layout (strides, and a
    stride-0 batch dim stays shared), so a re-check sees what the kernel
    saw; lists copy element by element, constants stay."""
    import torch

    if isinstance(t, (list, tuple)):
        return [keep(x) for x in t]
    if not isinstance(t, torch.Tensor):
        return t
    if t.dim() and t.stride(0) == 0:
        return keep(t[0])[None].expand(t.shape)
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device).copy_(t)


def cols_bytes(cols, lens, idx) -> int:
    """Bytes a column gather must move: in each segment, each distinct row
    it reads once per tensor column (per batch row for a per-row segment,
    once in all for a shared one), nothing for a constant; each index
    once and each int32 output element once."""
    import torch

    rows = idx.dim() == 2
    N = sum(lens)
    ends = torch.tensor(np.cumsum(lens), device=idx.device)
    ix = idx.clamp(0, N - 1).long()
    seg = torch.searchsorted(ends, ix, right=True)
    keys = ix + torch.arange(ix.shape[0], device=ix.device)[:, None] * N \
        if rows else ix
    total = idx.numel() * 4 * (1 + len(cols))
    for s in range(len(lens)):
        m = seg == s
        n_all = int(torch.unique(ix[m]).numel())
        n_row = int(torch.unique(keys[m]).numel())
        for col in cols:
            t = col[s] if isinstance(col, (list, tuple)) else col
            if isinstance(t, torch.Tensor):
                per_row = rows and t.dim() == 2 and t.stride(0) != 0
                total += t.element_size() * (n_row if per_row else n_all)
    return total


def pack_sites(rng, dev):
    """The three call sites that packed their fields before the gather, at
    the main paths' shapes: (label, kernel call, plain call, the old pack
    plus the library gather, columns, lens, idx)."""
    import torch

    from uncalled_tpu_torch.ops import flat_gather as fg
    from uncalled_tpu_torch.ops import mxu_gather as mg

    I32, F32 = torch.int32, torch.float32

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def bits(x):
        return x.view(I32) if x.dtype == F32 else x.to(I32)

    S, SC = S_FULL, SC_FULL
    out = []
    # pooled parent pack: 7 pool fields (a bool among them), 3 f32
    # fields, the 4 move probs as rows of the [4, S] flat-gather output;
    # the step's parent index is sorted (children in slot order)
    q = [t(rand32(rng, S)) for _ in range(6)] + [t(rng.random(S) < 0.3)]
    f3 = [t(rand32(rng, S, True)) for _ in range(3)]
    mv_p = t(rand32(rng, (4, S), True)).T
    cols = q + f3 + [mv_p[:, c] for c in range(4)]
    idx = t(np.sort(rng.integers(0, S, SC)).astype(np.int32))
    ix = idx.clamp(0, S - 1).long()
    out.append((
        f"pooled parent pack F=14 [{S}] at {SC} sorted idx",
        lambda c=cols, i=idx: fg.flat_gather_cols(c, i),
        lambda c=cols, i=idx: fg.flat_gather_cols_plain(c, i),
        lambda c=cols, i=ix: torch.stack([bits(x) for x in c], 1)
        .index_select(0, i),
        cols, [S], idx))

    # the unified record table: ten columns of five segments A = SC,
    # head = gap = SC, F = B*FS, D = S; random rows over all of it
    BFS = B_FULL * 256
    lens = [SC, SC, SC, BFS, S]
    NU = sum(lens)

    def seg(n, f32=False):
        return t(rand32(rng, n, f32))

    a = [seg(SC) for _ in range(7)]  # ns ne nk ntot ncons nmoves cpar
    a_sa = t(rng.random(SC) < 0.2)
    a_f = [seg(SC, True) for _ in range(2)]  # newcum, prob
    hd = [seg(SC) for _ in range(4)]  # head_st head_en gap_st gap_en
    ff = [seg(BFS) for _ in range(3)]  # f_st f_en fkm
    f_prob = seg(BFS, True)
    d = [seg(S) for _ in range(6)] + [t(rng.random(S) < 0.3)]
    iota = torch.arange(S, dtype=I32, device=dev)
    ucols = [
        [a[0], hd[0], hd[2], ff[0], d[0]],
        [a[1], hd[1], hd[3], ff[1], d[1]],
        [a[2], a[2], a[2], ff[2], d[2]],
        [a[3], 1, 1, 1, d[3]],
        [a[4], 0, 0, 0, d[4]],
        [a[5], 1, 1, 1, d[5]],
        [a_sa, False, False, False, d[6]],
        [a[6], -1, -1, -1, iota],
        [a[3], 1, 1, 1, -1],
        [a_f[0], a_f[1], a_f[1], f_prob, 0.0],
    ]
    uidx = t(rng.integers(-4, NU + 4, S).astype(np.int32))
    uix = uidx.clamp(0, NU - 1).long()

    def ucat(col):
        dt = next(x.dtype for x in col if isinstance(x, torch.Tensor))
        return bits(torch.cat([
            x if isinstance(x, torch.Tensor)
            else torch.full((n,), x, dtype=dt, device=dev)
            for x, n in zip(col, lens)]))

    def unified_lib(c=ucols, i=uix):
        return torch.stack([ucat(col) for col in c], 1).index_select(0, i)

    out.append((
        f"unified record table F=10 of 5 segments, N={NU} at {S}",
        lambda c=ucols, i=uidx: fg.flat_gather_cols(c, i),
        lambda c=ucols, i=uidx: fg.flat_gather_cols_plain(c, i),
        unified_lib, ucols, lens, uidx))

    # classic parent pack at rung 0: 6 int32 path fields, the bool p_sa,
    # and the two ring values as columns of a [B, P, 23] f32 ring; the
    # step's parent index is sorted per read
    B, P, CE = 64, 1024, 1280
    pf = [t(rand32(rng, (B, P))) for _ in range(6)] + [
        t(rng.random((B, P)) < 0.3)]
    ring = t(rand32(rng, (B, P, RING), True))
    ccols = pf + [ring[:, :, 5], ring[:, :, 17]]
    cidx = t(np.sort(rng.integers(0, P, (B, CE)), 1).astype(np.int32))
    cix = cidx.clamp(0, P - 1).long()[:, :, None].expand(B, CE, 9)
    out.append((
        f"classic parent pack F=9 [{B}, {P}] (ring columns strided) at "
        f"[{B}, {CE}] sorted idx",
        lambda c=ccols, i=cidx: mg.row_gather_cols(c, i),
        lambda c=ccols, i=cidx: mg.row_gather_cols_plain(c, i),
        lambda c=ccols, i=cix: torch.gather(
            torch.cat([bits(x)[:, :, None] for x in c], 2), 1, i),
        ccols, [P], cidx))
    return out


def tracker_rows_case(rng, dev, B, CL, R, fill):
    """The regimes of tests/test_tracker_kernel.py: tables at occupancy
    ``fill`` (some zombies), [B, R] rows near existing clusters (matches,
    ties, collisions, insertions, evictions at fill 1), rows_r uniform in
    [0, R] and row_ok gating inside each read's count."""
    import torch

    occ = rng.random((B, CL)) < fill
    st = {
        "cl_valid": occ & (rng.random((B, CL)) < 0.9), "cl_count": occ,
        "cl_ref_st": rng.integers(0, 5000, (B, CL)),
        "cl_r1": rng.integers(0, 5000, (B, CL)),
        "cl_r2e": rng.integers(0, 5000, (B, CL)),
        "cl_evt_st": rng.integers(0, 800, (B, CL)),
        "cl_evt_en": rng.integers(0, 800, (B, CL)),
        "cl_total": rng.integers(1, 300, (B, CL)),
        "len_sum": (rng.random(B) * 100).astype(np.float32),
        "n_cl": rng.integers(0, CL, B), "mm_len": rng.integers(0, 200, B),
        "mm_ref_st": rng.integers(0, 5000, B),
        "mm_r1": rng.integers(0, 5000, B), "mm_r2e": rng.integers(0, 5000, B),
        "mm_evt_st": rng.integers(0, 800, B),
        "mm_evt_en": rng.integers(0, 800, B),
        "ovf": rng.random(B) < 0.05, "ovf_why": rng.integers(0, 4, B),
    }
    near = st["cl_r1"][:, :R] + rng.integers(-3, 40, (B, R))
    mc = rng.integers(1, 30, (B, R))
    ref_en = np.where(rng.random((B, R)) < 0.6, near + mc - 1,
                      rng.integers(0, 5000, (B, R)))
    evt = st["cl_evt_en"][:, :R] + rng.integers(-2, 30, (B, R))
    rows_r = rng.integers(0, R + 1, B)
    row_ok = (np.arange(R)[None, :] < rows_r[:, None]) & (
        rng.random((B, R)) < 0.95)

    def t(a):
        a = np.ascontiguousarray(a)
        if a.dtype not in (np.float32, bool):
            a = a.astype(np.int32)
        return torch.from_numpy(a).to(dev)

    return ({k: t(v) for k, v in st.items()}, t(ref_en), t(mc), t(evt),
            t(row_ok), t(rows_r))


I32_MIN, I32_MAX = -2**31, 2**31 - 1
TIE_SCENARIOS = ("lane/warp ties", "match at 0", "match at CL-1",
                 "int32 extremes", "wrapped r2", "every slot free",
                 "all occupied, equal totals", "collisions",
                 "evict int32 min")


def tracker_tie_case(B, CL, seed=0):
    """Adversarial tracker tables and rows for both folds (numpy; the CPU
    tests hold the plain folds against JAX on it, phase 2 the kernels
    against the plain folds).  Read b plays TIE_SCENARIOS[b % 9] with
    variant b // 9: equal (total, r1, evt_en) keys at lane and warp
    boundaries (the first index must win), a match at index 0 (r1
    tie-break) and at CL-1 (evt_en tie-break), totals at INT32_MAX and
    exactly NEG beside invalid clusters of INT32_MIN fields, a wrapped
    r2 = ref_en - mc + 1, every slot free, every slot occupied with equal
    totals (first-index eviction, ovf), colliding keys (zombies, the
    matched cluster's own key), and an occupied INT32_MIN total evicted
    before free slots.  Each read folds 3 rows: the crafted row, the same
    row again (it now collides with the cluster it updated) and one that
    grows it.  Eligible clusters' totals, r1 and evt_en stay >= NEG and
    their evt_en gaps do not wrap: there the plain fold, the JAX kernel
    and the CUDA kernels agree by construction.  Returns (state, compact
    rows (ren, mc, evt [RT], st_w, rows_eff [B]), expanded rows (ren, mc,
    evt, row_ok [B, 4], rows_r [B])); the expanded form gates row 1 off
    in every third read."""
    rng = np.random.default_rng(seed)
    K = 3
    st = {
        "cl_valid": np.ones((B, CL), bool), "cl_count": np.ones((B, CL), bool),
        "cl_ref_st": rng.integers(0, 5000, (B, CL)),
        "cl_r1": np.zeros((B, CL), np.int64),
        "cl_r2e": rng.integers(0, 9000, (B, CL)),
        "cl_evt_st": rng.integers(0, 800, (B, CL)),
        "cl_evt_en": np.zeros((B, CL), np.int64),
        "cl_total": rng.integers(1, 300, (B, CL)),
        "len_sum": (rng.random(B) * 100 + 1).astype(np.float32),
        "n_cl": rng.integers(0, CL, B), "mm_len": rng.integers(0, 20, B),
        "mm_ref_st": rng.integers(0, 5000, B),
        "mm_r1": rng.integers(0, 5000, B), "mm_r2e": rng.integers(0, 5000, B),
        "mm_evt_st": rng.integers(0, 800, B),
        "mm_evt_en": rng.integers(0, 800, B),
        "ovf": np.zeros(B, bool), "ovf_why": rng.integers(0, 4, B) * 2,
    }
    ren = np.zeros(B, np.int64)
    mc = rng.integers(8, 30, B)
    e2 = rng.integers(100, 700, B)
    c = np.arange(CL)
    for b in range(B):
        scen, var = b % len(TIE_SCENARIOS), b // len(TIE_SCENARIOS)
        ren[b] = rng.integers(1000, 4000)
        r2 = ren[b] - mc[b] + 1
        v, cnt = st["cl_valid"][b], st["cl_count"][b]
        r1, e1, tot = st["cl_r1"][b], st["cl_evt_en"][b], st["cl_total"][b]
        # default: occupied, valid, never eligible (r1 > r2)
        r1[:] = r2 + 1 + rng.integers(0, 50, CL)
        e1[:] = e2[b] - rng.integers(0, 30, CL)
        if scen == 0:
            ties = [i for i in (31, 32, 63, 64, 255, 256, 511, 512, 1023,
                                1024, CL - 1) if i < CL]
            ties = sorted(set(ties))[var % len(ties):] or [CL - 1]
            r1[ties], e1[ties], tot[ties] = r2 - 5, e2[b] - 5, 77
        elif scen == 1:
            r1[:], e1[:], tot[:] = r2 - 4, e2[b] - 4, 50
            r1[0], e1[0] = r2 - 3, e2[b] - 3  # largest r1, same total
        elif scen == 2:
            r1[:], e1[:], tot[:] = r2 - 1, e2[b] - 2, 50
            e1[CL - 1] = e2[b] - 1  # largest evt_en, same total and r1
        elif scen == 3:
            r1[:], e1[:], tot[:] = I32_MIN, I32_MIN, I32_MIN
            v[:] = False
            k = (7 * var) % CL
            r1[k], e1[k], tot[k] = r2 - 2, e2[b] - 2, I32_MAX
            if CL > 1:
                j = (k + 1) % CL
                r1[j], e1[j], v[j] = r2 - 2, e2[b] - 2, True
                tot[j] = -(1 << 30)  # exactly NEG
        elif scen == 4:
            ren[b] = I32_MIN + int(rng.integers(0, 5))
            r2 = (ren[b] - mc[b] + 1 + 2**31) % 2**32 - 2**31  # wraps
            r1[:] = I32_MIN  # r1 < r2, but out of range
            k = (5 * var + 3) % CL
            r1[k], e1[k] = r2 - 2, e2[b] - 2
        elif scen == 5:
            v[:], cnt[:] = False, False
        elif scen == 6:
            tot[:] = 9
        elif scen == 7:
            ks = [i for i in (0, 1, 33, CL // 2, CL - 1) if i < CL]
            r1[ks], e1[ks] = r2, e2[b]
            tot[ks] = 40 + np.arange(len(ks))  # the last one matches
            if var % 2:  # only the matched cluster keeps the key
                r1[ks[:-1]] = r2 + 3
            if CL > 2:
                v[ks[0]] = False  # a zombie with the key: not a collision
        else:
            free = c % 3 == 0
            v[free], cnt[free] = False, False
            k = 1 + (var % max(CL - 1, 1)) if CL > 1 else 0
            v[k], cnt[k], tot[k] = False, True, I32_MIN
        st["cl_r2e"][b] = np.where(rng.random(CL) < 0.5, r1 + 20, r1 - 3)
        if scen == 3:  # no growth: the INT32_MAX total never wraps
            st["cl_r2e"][b][k] = r2 + 1000
    # rows: the crafted one, the same again, then one that grows it
    rows = np.stack([ren, ren, ren + 7], 1)
    mcs = np.stack([mc, mc, mc + 7], 1)
    evts = np.stack([e2, e2, e2 + 9], 1)
    st = {k: (a if a.dtype in (np.float32, bool) else
              ((a + 2**31) % 2**32 - 2**31).astype(np.int32))
          for k, a in st.items()}
    i32 = lambda a: ((np.asarray(a, np.int64) + 2**31) % 2**32  # noqa
                     - 2**31).astype(np.int32)
    compact = (i32(rows.reshape(-1)), i32(mcs.reshape(-1)),
               i32(evts.reshape(-1)), i32(np.arange(B) * K),
               i32(np.full(B, K)))
    R = K + 1
    pad = lambda a: np.concatenate([a, a[:, :1]], 1)  # noqa: E731
    row_ok = np.arange(R)[None, :] < K
    row_ok = row_ok & ~((np.arange(B)[:, None] % 3 == 0)
                        & (np.arange(R)[None, :] == 1))
    expanded = (i32(pad(rows)), i32(pad(mcs)), i32(pad(evts)), row_ok,
                i32(np.full(B, K)))
    return st, compact, expanded


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card(out):
    import torch

    from uncalled_tpu_torch.ops import _cuda

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    out["card"] = smi[0] if smi else "unknown"
    log(f"[1] card: {out['card']}")
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    for stem in STEMS:
        _cuda._lib(stem)
    out["build_s"] = time.time() - t0
    log(f"[1] kernels built in {out['build_s']:.2f} s "
        f"(nvcc wall {_cuda.build_seconds:.2f} s)")
    for stem in STEMS:
        with open(os.path.join(_cuda.BUILD_DIR, stem + ".log")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"[1] ptxas {stem}: {line.strip()}")
    out["sa_lookup_local_memory"] = local = sass_local_memory("sa_lookup")
    log("[1] SASS sa_lookup: local-memory instructions (LDL, STL) per "
        "kernel: " + json.dumps(local))


def sass_local_memory(stem):
    """Local-memory instructions (LDL, STL) of each kernel in a built
    library, from ``cuobjdump -sass`` (whose listing is kept beside the
    library); None where the toolkit has no cuobjdump."""
    from uncalled_tpu_torch.ops import _cuda

    exe = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    if not os.path.exists(exe):
        return None
    so = os.path.join(_cuda.BUILD_DIR, f"lib{stem}.so")
    sass = subprocess.run([exe, "-sass", so], capture_output=True, text=True,
                          timeout=120).stdout
    with open(os.path.join(_cuda.BUILD_DIR, stem + ".sass"), "w") as f:
        f.write(sass)
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            # the kernel's name and template flag from its mangled name
            k = re.search(r"\d+([a-z_]+_kernel)ILb([01])E", m.group(1))
            fn = (f"{k.group(1)}<{'true' if k.group(2) == '1' else 'false'}>"
                  if k else m.group(1))
            counts[fn] = 0
        elif fn and re.search(r"\b(LDL|STL)\b", line):
            counts[fn] += 1
    return counts


def phase_kernels(out, rate):
    """Each kernel vs its plain version on seeded full-shape inputs."""
    import torch

    from uncalled_tpu_torch.ops import flat_gather as fg
    from uncalled_tpu_torch.ops import stepkern as sk
    from uncalled_tpu_torch.ops import tracker_kernel as tk

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)
    res = out["kernels"]
    out["kernel_shapes"] = {}
    ok = True

    # flat gather (the assembly pack: F=10, K=S)
    tbl, idx = gather_case(rng, dev)
    got = fg.flat_gather_fields(tbl, idx)
    want = fg.flat_gather_fields_plain(tbl, idx)
    ok &= report(res, "flat_gather", got, want, rate,
                 lambda: fg.flat_gather_fields(tbl, idx),
                 lambda: fg.flat_gather_fields_plain(tbl, idx),
                 lambda: tbl.index_select(0, idx.clamp(0, tbl.shape[0] - 1)),
                 nbytes=gather_bytes(tbl, idx, shared=True),
                 shape=f"tbl {tuple(tbl.shape)} idx {tuple(idx.shape)}")
    # a second main-path shape: one f32 column of the [B*256, 4] prob rows
    p4 = torch.from_numpy(rng.standard_normal((B_FULL * 256, 4)).astype(
        np.float32)).to(dev)
    i2 = torch.from_numpy(rng.integers(0, B_FULL * 256, S_FULL).astype(
        np.int32)).to(dev)
    ok &= check("flat_gather[p4]", fg.flat_gather_fields(p4, i2),
                fg.flat_gather_fields_plain(p4, i2))

    # the three pack sites, read in place; library: the old pack plus one
    # library gather (index_select / torch.gather) in the same run
    for label, kfn, pfn, lfn, cols, lens, idx in pack_sites(rng, dev):
        name = "flat_gather" if idx.dim() == 1 else "row_gather"
        ok &= report(out["kernel_shapes"], name, kfn(), pfn(), rate, kfn,
                     pfn, lfn, nbytes=cols_bytes(cols, lens, idx),
                     key=f"{name}[{label.split(' F=')[0]}]", shape=label)

    # pair count
    a, b = pair_case(rng, dev)
    na, nb = B_FULL, 1024

    def lib_pairs():
        m = (a >= 0) & (a < na) & (b >= 0) & (b < nb)
        key = torch.where(m, a.long() * nb + b, na * nb)
        return torch.bincount(key, minlength=na * nb + 1)

    ok &= report(res, "pair_counts", fg.pair_counts(a, b, na, nb),
                 fg.pair_counts_plain(a, b, na, nb), rate,
                 lambda: fg.pair_counts(a, b, na, nb),
                 lambda: fg.pair_counts_plain(a, b, na, nb), lib_pairs,
                 nbytes=a.numel() * 8 + na * nb * 4,
                 shape=f"keys {a.numel()} -> [{na}, {nb}]")
    for label, x, y in pair_cases(rng, dev, na, nb):
        ok &= check(f"pair_counts[{label}, K={x.numel()}]",
                    fg.pair_counts(x, y, na, nb),
                    fg.pair_counts_plain(x, y, na, nb))
    pair_floor(out, a, b, na, nb)

    # ring assembly
    old, rsrc, rslot, rval, keep = ring_case(rng, dev)
    args = (old, rsrc, rslot, rval, keep)
    ok &= report(res, "ring_assemble", sk.ring_assemble(*args),
                 sk.ring_assemble_plain(*args), rate,
                 lambda: sk.ring_assemble(*args),
                 lambda: sk.ring_assemble_plain(*args), None,
                 nbytes=old.numel() * 8 + S_FULL * 13,
                 shape=f"ring {tuple(old.shape)}")
    # S * RING % 4 == 1: the last thread's four words run past the ring
    tail = tuple(x[: S_FULL - 1] for x in args)
    ok &= check("ring_assemble[S=98303, S*RING % 4 = 1]",
                sk.ring_assemble(*tail), sk.ring_assemble_plain(*tail))

    # tracker fold
    st, ren, mc, evt, st_w, rows = tracker_case(rng, dev)
    targs = (25, st, ren, mc, evt, st_w, rows)
    got = tk.tracker_run_compact(*targs)
    want = tk.tracker_run_compact_plain(*targs)
    tb = sum(st[k].numel() * st[k].element_size() for k in st)
    nrows = int(rows.sum())
    ok &= report(res, "tracker_fold", got, want, rate,
                 lambda: tk.tracker_run_compact(*targs),
                 lambda: tk.tracker_run_compact_plain(*targs), None,
                 nbytes=2 * tb + nrows * 12 + B_FULL * 8, plain_reps=1,
                 shape=f"B={B_FULL} CL={CL_FULL} RT={RT_FULL} rows={nrows}",
                 rows_longest=int(rows.max()))
    # the same fold at other threads per read (fold_launch halves them
    # while B blocks would put more than _WARPS_PER_SM warps on each SM):
    # the evidence for that choice
    keep_w = tk._WARPS_PER_SM
    widths = (4, 8, 16, 32)

    def at(w):
        tk._WARPS_PER_SM = w
        tk.tracker_run_compact(*targs)

    try:
        ms = device_ms([(lambda w=w: at(w), 20) for w in widths],
                       tag="tracker_fold_sweep")
        sweep = {}
        for w, m in zip(widths, ms):
            tk._WARPS_PER_SM = w
            sweep[tk.fold_launch(CL_FULL, B_FULL).threads] = m
    finally:
        tk._WARPS_PER_SM = keep_w
    out["tracker_fold_threads_ms"] = sweep
    log(f"[2] tracker_fold B={B_FULL} CL={CL_FULL} device ms by threads a "
        f"read: {json.dumps(sweep)} (default "
        f"{tk.fold_launch(CL_FULL, B_FULL).threads})")
    # the eject tier's table width (CL=16384, B=16)
    st2, ren2, mc2, evt2, stw2, rows2 = tracker_case(rng, dev, B=16,
                                                     CL=16384, RT=8192)
    t2 = (25, st2, ren2, mc2, evt2, stw2, rows2)
    ok &= check("tracker_fold[tier CL=16384]", tk.tracker_run_compact(*t2),
                tk.tracker_run_compact_plain(*t2))

    # row gather (classic step): the rung-0 parent pack (N <= 4096, the
    # headline), a rung-1/2-sized pack (4096 < N <= 8192), the final
    # rung's seed-row pack (f32 bits), the shared k-mer range table
    from uncalled_tpu_torch.ops import mxu_gather as mg

    for label, B, N, F, K, f32 in (
        ("parent pack", 64, 1024, 9, 1280, False),
        ("rung-1/2 pack", 64, 6144, 4, 512, False),
        ("final rung f32", 32, 12500, 4, 1024, True),
        ("shared kmer_rng2", None, 1024, 2, 1280, False),
    ):
        tbl, idx = row_gather_case(rng, dev, B, N, F, K, f32)
        if B is None:
            fn, plain = mg.shared_gather, mg.shared_gather_plain
            ix = idx.clamp(0, N - 1).long()

            def lib(tbl=tbl, ix=ix):
                return tbl[ix]
        else:
            fn, plain = mg.row_gather, mg.row_gather_plain
            ix = idx.clamp(0, N - 1).long()[:, :, None].expand(B, K, F)

            def lib(tbl=tbl, ix=ix):
                return torch.gather(tbl, 1, ix)
        head = label == "parent pack"
        ok &= report(
            res if head else out["kernel_shapes"], "row_gather",
            fn(tbl, idx), plain(tbl, idx), rate,
            lambda fn=fn, tbl=tbl, idx=idx: fn(tbl, idx),
            lambda plain=plain, tbl=tbl, idx=idx: plain(tbl, idx), lib,
            nbytes=gather_bytes(tbl, idx, shared=B is None),
            key=None if head else f"row_gather[{label}]",
            shape=f"{label}: tbl {tuple(tbl.shape)} idx {tuple(idx.shape)}")
    ring = torch.from_numpy(rand32(rng, (64, 1024, RING), True)).to(dev)
    ri = torch.from_numpy(rng.integers(-3, 1027, (64, 1024)).astype(
        np.int32)).to(dev)
    ok &= check("row_gather[ring F=23, two launches]", mg.row_gather(ring, ri),
                mg.row_gather_plain(ring, ri))
    fl = [torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (64, 1024, 9),
                                        dtype=np.int64).astype(np.int32)
                           ).to(dev)]
    fi = torch.from_numpy(rng.integers(0, 1024, (64, 1280)).astype(
        np.int32)).to(dev)
    ok &= check("row_gather_fields[parent pack]",
                mg.row_gather_fields(fl[0], fi),
                [g.contiguous() for g in mg.row_gather_fields_plain(fl[0],
                                                                    fi)])

    # expanded row fold (classic step): rung 0's shape (the headline, in
    # the normal regime) and the final rung's, in the three regimes
    for B, CL, R in ((64, 1024, 256), (32, 4096, 1024)):
        for regime, fill in (("normal", 0.3), ("full", 1.0),
                             ("near-empty", 0.02)):
            st, ren, mc, evt, row_ok, rows_r = tracker_rows_case(
                rng, dev, B, CL, R, fill)
            targs = (25, st, ren, mc, evt, row_ok, rows_r)
            label = f"B={B} CL={CL} R={R} {regime}"
            if regime != "normal":
                ok &= check(f"tracker_fold_rows[{label}]",
                            tk.tracker_run(*targs),
                            tk.tracker_run_plain(*targs))
                continue
            # rung 0's is the headline; the final rung's is timed beside it
            # (its plain fold, about 14000 launches a call, is not traced)
            head = B == 64
            tb = sum(st[k].numel() * st[k].element_size() for k in st)
            nrows = int(rows_r.clamp(max=R).sum())
            ok &= report(res if head else out["kernel_shapes"],
                         "tracker_fold_rows", tk.tracker_run(*targs),
                         tk.tracker_run_plain(*targs), rate,
                         lambda targs=targs: tk.tracker_run(*targs),
                         (lambda targs=targs: tk.tracker_run_plain(*targs))
                         if head else None,
                         None, nbytes=2 * tb + nrows * 13 + B * 4,
                         plain_reps=3, plain_events=True,
                         shape=f"{label} rows={nrows}",
                         key=None if head else f"tracker_fold_rows[{label}]",
                         rows_longest=int(rows_r.clamp(max=R).max()))
    ok &= seg_scan_checks(out, rate, dev)
    ok &= phase_merge(out, rate, rng, dev)
    ok &= phase_folds(out, dev)
    ok &= realtime_shapes(dev)
    ok &= sa_lookup_example(out, dev)
    ok &= shard_kernels(out, rate, dev)
    return ok


def seg_case(rng, dev, shape, p=0.3):
    """seg_id non-decreasing along the last dimension (runs of mean length
    1 / p, restarting in every row) and int32 vals over the whole range."""
    import torch

    seg = np.cumsum(rng.random(shape) < p, -1).astype(np.int32)
    vals = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    return (torch.from_numpy(seg).to(dev), torch.from_numpy(vals).to(dev))


def seg_cummax(seg, vals):
    """The yardstick the port no longer calls: one int64 torch.cummax of
    (seg_id << 32 | vals + 2^31), unpacked."""
    import torch

    key = (seg.to(torch.int64) << 32) | (vals.to(torch.int64) + 2**31)
    run = torch.cummax(key, -1).values
    return ((run & 0xFFFFFFFF) - 2**31).to(torch.int32)


def seg_scan_checks(out, rate, dev) -> bool:
    """The segmented running max against its plain version, bit for bit,
    and timed beside it and the int64 cummax, at SEG_SHAPES; then the
    tiles' edges, the scalar path, segments across every tile and of one
    element, the int32 extremes, and twenty runs on one input.  Its own
    seed."""
    import torch

    from uncalled_tpu_torch.ops import seg_scan as ss

    rng = np.random.default_rng(20261019)
    ok = True
    for i, shape in enumerate(SEG_SHAPES):
        s, v = seg_case(rng, dev, shape)
        want = ss.seg_running_max_plain(s, v)
        ok &= check(f"seg_running_max[{shape}] against the int64 cummax",
                    seg_cummax(s, v), want)
        ok &= report(
            out["kernels"] if i == 0 else out["kernel_shapes"],
            "seg_running_max", ss.seg_running_max(s, v), want, rate,
            lambda s=s, v=v: ss.seg_running_max(s, v),
            lambda s=s, v=v: ss.seg_running_max_plain(s, v),
            lambda s=s, v=v: seg_cummax(s, v), nbytes=12 * v.numel(),
            key=None if i == 0 else f"seg_running_max[{shape}]",
            shape=f"{shape}, {-(-shape[-1] // ss.TILE)} tiles a row")
    n = SEG_SHAPES[0][0]
    t = ss.TILE
    cases = [(f"n={m}", *seg_case(rng, dev, (m,)))
             for m in (1, 5, t - 1, t, t + 1, 3 * t + 17)]
    cases.append(("[64, 1283] (scalar path)", *seg_case(rng, dev, (64, 1283))))
    s, v = seg_case(rng, dev, (n + 1,))
    cases.append(("unaligned view", s[1:], v[1:]))
    v = seg_case(rng, dev, (n,))[1]
    cases.append(("one segment", torch.full_like(v, 3), v))
    cases.append(("every element its own segment",
                  torch.arange(n, dtype=torch.int32, device=dev), v))
    ext = rng.choice(np.array([-2**31, 2**31 - 1, 0], np.int32), n)
    cases.append(("int32 extremes", seg_case(rng, dev, (n,), 0.001)[0],
                  torch.from_numpy(ext).to(dev)))
    for label, s, v in cases:
        ok &= check(f"seg_running_max[{label}]", ss.seg_running_max(s, v),
                    ss.seg_running_max_plain(s, v))
    s, v = seg_case(rng, dev, (n,), 0.02)
    want = ss.seg_running_max_plain(s, v)
    ok &= check(f"seg_running_max[n={n}, twenty runs]",
                [ss.seg_running_max(s, v) for _ in range(20)], [want] * 20)
    return ok


def realtime_shapes(dev) -> bool:
    """The pooled kernels at the realtime engine's shapes (phase 7: B=512,
    S=147456, SC=184320, RT=12288) against their plain versions, bit for
    bit: the compact fold in its three regimes (fold_launch halves the
    threads a read at B=512), the pair count's adversarial keys into
    [512, 1024] and the ring assembly.  Its own seed."""
    from uncalled_tpu_torch.ops import flat_gather as fg
    from uncalled_tpu_torch.ops import stepkern as sk
    from uncalled_tpu_torch.ops import tracker_kernel as tk

    rng = np.random.default_rng(20261018)
    B, S, RT = RT_CH, RT_CH * RT_SPR, 24 * RT_CH
    fl = tk.fold_launch(CL_FULL, B)
    ok = True
    for regime, fill in FOLD_REGIMES:
        a = (25, *tracker_case(rng, dev, B, CL_FULL, RT,
                               0.7 if fill is None else fill))
        ok &= check(f"tracker_fold[{fl.form}, {fl.threads} threads a read, "
                    f"B={B} CL={CL_FULL} RT={RT} {regime}]",
                    tk.tracker_run_compact(*a),
                    tk.tracker_run_compact_plain(*a))
    for label, x, y in pair_cases(rng, dev, B, 1024, K=SC_RT):
        ok &= check(f"pair_counts[{label}, K={x.numel()} -> [{B}, 1024]]",
                    fg.pair_counts(x, y, B, 1024),
                    fg.pair_counts_plain(x, y, B, 1024))
    args = ring_case(rng, dev, S)
    ok &= check(f"ring_assemble[S={S}]", sk.ring_assemble(*args),
                sk.ring_assemble_plain(*args))
    return ok


def pair_cases(rng, dev, na, nb, K=SC_FULL):
    """The pair count's adversarial inputs (tests/test_torch_kernels.py
    runs the same kinds against the Pallas kernel): one cell for every key,
    runs of 32 and of 33 equal cells (a warp's width and one more), every
    key out of the domain, the seeded keys sorted by (a, b) as the live
    keys nearly are, K % 4 = 3, K = 0, and a view 4 bytes off 16-byte
    alignment (the scalar path)."""
    import torch

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(
            dev)

    a = rng.integers(-2, na + 3, K)
    b = rng.integers(-3, nb + 5, K)
    cases = [("all equal", np.full(K, na - 1), np.full(K, nb - 1))]
    for w in (32, 33):
        cell = np.repeat(rng.integers(0, na * nb, K // w + 1), w)[:K]
        bb = cell % nb
        bb[::97] = nb  # a few dropped keys inside the runs
        cases.append((f"runs of {w}", cell // nb, bb))
    cases.append(("all out of domain",
                  np.where(rng.random(K) < 0.5, -1, na), b))
    order = np.lexsort((b, a))
    cases.append(("sorted", a[order], b[order]))
    cases.append(("K % 4 = 3", a[: K - 5], b[: K - 5]))
    cases.append(("K = 0", a[:0], b[:0]))
    out = [(label, t(x), t(y)) for label, x, y in cases]
    ta, tb = t(a), t(b)
    out.append(("unaligned view", ta[1:], tb[1:]))
    return out


def pair_floor(out, a, b, na, nb):
    """Device ms of the pair count at 256, 512 and 1024 threads a block
    (one block per SM at most), on the seeded and on sorted keys, beside
    an empty kernel (1 x 32 threads, and the pair count's own grid) and an
    empty cooperative launch of that grid, without and with one grid
    barrier: the practical floor of a one-launch pair count."""
    import torch

    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import flat_gather as fg

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    K = a.numel()

    def blocks(T):  # csrc/flat_gather.cu pair_counts_i32's grid
        return max(1, min(sms, -(-max(na * nb // 4 + 1, (K + 3) // 4) // T)))

    order = torch.argsort(a.long() * (nb + 8) + b.long())
    sa_, sb_ = a[order].contiguous(), b[order].contiguous()
    keep = fg.PAIR_THREADS
    widths = (256, 512, 1024)

    def at(w, x, y):
        fg.PAIR_THREADS = w
        fg.pair_counts(x, y, na, nb)

    def empty(nblk, threads, sync):
        return lambda: _cuda.launch("probe_empty", nblk, threads, sync)

    fns = [(lambda w=w: at(w, a, b), 20) for w in widths]
    fns += [(lambda: at(keep, sa_, sb_), 20),
            (empty(1, 32, 0), 20), (empty(blocks(keep), keep, 0), 20),
            (empty(blocks(keep), keep, 2), 20),
            (empty(blocks(keep), keep, 1), 20)]
    try:
        ms = device_ms(fns, tag="pair_counts_floor")
    finally:
        fg.PAIR_THREADS = keep
    res = dict(
        threads_ms=dict(zip(widths, ms[:3])), sorted_keys_ms=ms[3],
        empty_kernel_ms=ms[4], empty_grid_ms=ms[5],
        empty_cooperative_ms=ms[6], grid_barrier_ms=ms[7],
        blocks=blocks(keep), threads=keep,
        blocks_by_threads={w: blocks(w) for w in widths})
    out["pair_counts_floor"] = res
    if "pair_counts" in out["kernels"]:
        out["kernels"]["pair_counts"]["floor_ms"] = ms[4]
    log("[2] pair_counts device ms by threads a block, sorted keys, empty "
        "kernel (1 x 32, the pair count's grid), empty cooperative launch "
        "(the pair count's grid) without and with one grid barrier: "
        + json.dumps(res))


def sa_lookup_example(out, dev):
    """The LF-walk kernel on every row of the example index (n = 20000,
    walks up to 201 steps) against its plain version and the walk model
    from the full SA; the 4.7 Mb genome's rows follow in phase 4."""
    import torch

    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping.engine import device_index
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.ops import sa_lookup as sl
    from uncalled_tpu_torch.poremodel import load_default

    prefix = os.path.join(REPO, "tests", "fixtures", "example_index",
                          "example_ref")
    fmi = load_bwa_index(prefix)
    th = load_uncl(prefix + ".uncl")
    rows = torch.arange(fmi.n + 1, dtype=torch.int32, device=dev)
    ok = True
    # the default intv (a power of two: mask and shift) and one that is
    # not (the kernel's general path: modulo and division)
    for intv in (SA_INTV, 24):
        idx = device_index(fmi, th, load_default(), device=dev,
                           sampled_sa=True, sa_intv=intv)
        got = sl.sa_lookup(idx, rows, intv)
        ok &= check(f"sa_lookup[example index, intv {intv}, all "
                    f"{fmi.n + 1} rows]", got,
                    sl.sa_lookup_plain(idx, rows, intv))
        steps, value = sl.walk_model(fmi.sa_full, intv)
        model_ok = np.array_equal(got.cpu().numpy(), value)
        log(f"[2] sa_lookup[example index, intv {intv}] against the walk "
            f"model: {'equal' if model_ok else 'MISMATCH'} (longest walk "
            f"{int(steps.max())}, rows past the primary row "
            f"{int((value != fmi.sa_full).sum())})")
        ok &= model_ok
    return ok


FOLD_REGIMES = (("normal", None), ("full", 1.0), ("near-empty", 0.02))


def phase_folds(out, dev):
    """Both forms of both tracker folds (ops/tracker_kernel.py
    fold_launch: the table in shared memory up to CL=8192, in device
    memory above) against their plain versions, bit for bit: the compact
    fold at CL 2048 (B=256), 8192 (B=8, the largest shared-memory table),
    16384 (B=16) and 65536 (B=4), the expanded fold at CL 1024, 2048, 4096
    (the ladder's widths; 1024 and 4096 above) and 16384 (B=4, the
    device-memory form, which no classic rung takes), each in the normal,
    full and near-empty regimes and on the adversarial tie case
    (tracker_tie_case).  Its own seed: the earlier cases keep their
    inputs."""
    import torch

    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import tracker_kernel as tk

    rng = np.random.default_rng(20261017)
    before = dict(_cuda.COUNTS)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ok = True
    for B, CL, RT in ((B_FULL, CL_FULL, RT_FULL), (8, 8192, 1024),
                      (16, 16384, 8192), (4, 65536, 1024)):
        form = tk.fold_launch(CL, B).form
        for regime, fill in FOLD_REGIMES:
            if (CL, regime) == (CL_FULL, "normal"):
                continue  # the headline, above
            a = (25, *tracker_case(rng, dev, B, CL, RT,
                                   0.7 if fill is None else fill))
            ok &= check(f"tracker_fold[{form} B={B} CL={CL} {regime}]",
                        tk.tracker_run_compact(*a),
                        tk.tracker_run_compact_plain(*a))
        nb = 9 if CL > 16384 else 18
        st, comp, _ = tracker_tie_case(nb, CL, seed=CL)
        a = (25, {k: t(v) for k, v in st.items()}, *[t(x) for x in comp])
        ok &= check(f"tracker_fold[{form} B={nb} CL={CL} ties]",
                    tk.tracker_run_compact(*a),
                    tk.tracker_run_compact_plain(*a))
    for B, CL, R in ((128, 2048, 512), (4, 16384, 256)):
        form = tk.fold_launch(CL, B).form
        for regime, fill in FOLD_REGIMES:
            a = (25, *tracker_rows_case(rng, dev, B, CL, R,
                                        0.3 if fill is None else fill))
            ok &= check(f"tracker_fold_rows[{form} B={B} CL={CL} R={R} "
                        f"{regime}]", tk.tracker_run(*a),
                        tk.tracker_run_plain(*a))
    for CL in (1024, 2048, 4096, 16384):
        form = tk.fold_launch(CL, 18).form
        st, _, exp = tracker_tie_case(18, CL, seed=CL + 1)
        a = (25, {k: t(v) for k, v in st.items()}, *[t(x) for x in exp])
        ok &= check(f"tracker_fold_rows[{form} B=18 CL={CL} ties]",
                    tk.tracker_run(*a), tk.tracker_run_plain(*a))
    forms = fold_forms({k: _cuda.COUNTS[k] - before[k] for k in before})
    log(f"[2] tracker fold forms launched by phase 2 (checks and timing "
        f"runs): {json.dumps(forms)}")
    out["fold_forms_phase2"] = forms
    return ok and all(forms.values())


def fold_forms(counts):
    """Launches of each form of the two folds in ``counts``."""
    return {k: counts[k] for k in ("tracker_fold_shared",
                                   "tracker_fold_device",
                                   "tracker_fold_rows_shared",
                                   "tracker_fold_rows_device")}


def phase_merge(out, rate, rng, dev):
    """The bitonic candidate sort's kernels at the step's shapes (NK=5
    keys, SC=122880 padded to NP=131072; the wide tier's NP=32768): the
    merge level at the JAX kernel's strides (levels 16384 and 32768 at
    C=128, 65536 and 131072 at C=1024), the run sort and the merge level
    to stride 1 at NP 8192 ... 131072 (with padding, and with whole tuples
    tied), then the whole sort against the flat sort: its launches, each
    launch's device time, and 48 schedules held to the flat sort."""
    import torch

    from uncalled_tpu_torch.ops import sortkern as sk

    res = out["kernels"]
    shapes = out["kernel_shapes"]
    ok = True
    for NP, levels in ((131072, ((16384, 128), (32768, 128), (65536, 1024),
                                 (131072, 1024))),
                       (32768, ((16384, 128), (32768, 128)))):
        ks = sort_keys_case(rng, dev, NP)
        for k_lv, C in levels:
            label = f"NP={NP} k_lv={k_lv} C={C}"
            if (NP, k_lv) != (131072, 16384):  # timed at the headline only
                ok &= check(f"merge_level[{label}]", sk.merge_level(ks, k_lv, C),
                            sk.merge_level_plain(ks, k_lv, C))
                continue
            ok &= report(
                res, "merge_level", sk.merge_level(ks, k_lv, C),
                sk.merge_level_plain(ks, k_lv, C), rate,
                lambda ks=ks, k_lv=k_lv, C=C: sk.merge_level(ks, k_lv, C),
                lambda ks=ks, k_lv=k_lv, C=C: sk.merge_level_plain(ks, k_lv,
                                                                   C),
                None, nbytes=2 * NK_SORT * NP * 4,
                shape=f"NK={NK_SORT} {label}")
    # the run sort (headline: the step's SC padded to NP, runs of RUN_TILE)
    # and the merge level to stride 1, against their plain versions
    # SC_RT: the realtime engine at 512 channels (NP = 262144)
    for n, iota in ((SC_FULL, True), (SC_RT, True), (131072, True),
                    (32768, True), (16384, True), (8192, True),
                    (20000, False), (5000, False)):
        ks = sort_keys_case(rng, dev, n)
        if not iota:  # few values and no creation index: whole tuples tie
            ks[4] = ks[4] % 2
        NP = 1 << (max(n, 8192) - 1).bit_length()
        W = min(sk.RUN_TILE, NP)
        label = f"N={n} NP={NP} W={W}{'' if iota else ' ties'}"
        head = n == SC_FULL
        ok &= report(
            res if head else shapes, "sort_runs", sk.sort_runs(ks, NP, W),
            torch.stack(sk.sort_runs_plain(ks, NP, W)), rate,
            lambda ks=ks, NP=NP, W=W: sk.sort_runs(ks, NP, W),
            lambda ks=ks, NP=NP, W=W: sk.sort_runs_plain(ks, NP, W), None,
            nbytes=NK_SORT * (n + NP) * 4,
            key=None if head else f"sort_runs[{label}]",
            shape=f"NK={NK_SORT} {label}")
        pad = [torch.cat([k, torch.full((NP - n,), 2**31 - 1,
                                        dtype=torch.int32, device=dev)])
               for k in ks]
        for k_lv in sorted({min(2 * W, NP), NP}):
            ok &= check(f"merge_level[{label} k_lv={k_lv} C=1]",
                        sk.merge_level(pad, k_lv, 1),
                        sk.merge_level_plain(pad, k_lv, 1))
    # the whole candidate sort at the realtime engine's SC, against the
    # flat sort
    from uncalled_tpu_torch.mapping import pooled as pm

    ks = sort_keys_case(rng, dev, SC_RT)
    ok &= check(f"sort1d_bitonic vs flat sort at SC={SC_RT} (NP=262144)",
                pm._sort1d_bitonic(ks), pm._sort1d(ks))
    ks = sort_keys_case(rng, dev, 131072)
    ok &= check("merge_level[NP=131072 k_lv=131072 C=1]",
                sk.merge_level(ks, 131072, 1),
                sk.merge_level_plain(ks, 131072, 1))
    ok &= phase_sort(out, rng, dev)
    return ok


def phase_sort(out, rng, dev):
    """The whole candidate sort at SC: bitonic (the run sort and every merge
    level) against the flat sort, bit for bit, at the default schedule and
    at 47 others (the run width W, the tail's tile T, the strides R a
    device-memory launch fuses); device ms of both, the bitonic sort's
    launches and each launch's device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from uncalled_tpu_torch.mapping import pooled as pm
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import sortkern as sk

    ks = sort_keys_case(rng, dev, SC_FULL)
    eq = check("sort1d_bitonic vs flat sort", pm._sort1d_bitonic(ks),
               pm._sort1d(ks))
    before = dict(_cuda.COUNTS)
    pm._sort1d_bitonic(ks)
    calls = {k: _cuda.COUNTS[k] - before[k] for k in ("sort_runs",
                                                      "merge_level")}
    NP = 131072
    sched = sk.sort_schedule(NP, min(sk.RUN_TILE, NP),
                             sk.tile_for(sk.MERGE_TILE, NP, NK_SORT),
                             sk.FUSE_R)
    # each launch's device time: the last of three traced sorts (a trace
    # can lose its first events)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            pm._sort1d_bitonic(ks)
        torch.cuda.synchronize()
    each = [(e["name"][:60], float(e["dur"]) / 1e3)
            for e in sorted(trace_events(prof, "sort_one"),
                            key=lambda e: float(e["ts"]))][-len(sched):]
    bitonic_ms, flat_ms = device_ms(
        [(lambda: pm._sort1d_bitonic(ks), 20), (lambda: pm._sort1d(ks), 20)],
        tag="sort")
    keep = (sk.RUN_TILE, sk.MERGE_TILE, sk.FUSE_R)
    cfgs = [(W, T, R) for W in (512, 1024, 2048, 8192)
            for T in (512, 1024, 2048, 8192) for R in (2, 3, 4)]

    def at(c):
        sk.RUN_TILE, sk.MERGE_TILE, sk.FUSE_R = c
        pm._sort1d_bitonic(ks)

    # every schedule is held to the flat sort; their times, a measurement
    # and not a check, are no longer taken (phase 9's time)
    try:
        sched_ok = True
        for c in cfgs:
            at(c)
            sched_ok &= same_bits(pm._sort1d_bitonic(ks), pm._sort1d(ks))
    finally:
        sk.RUN_TILE, sk.MERGE_TILE, sk.FUSE_R = keep
    out["sort_compare"] = dict(
        n=SC_FULL, equal=eq, bitonic_ms=bitonic_ms, flat_ms=flat_ms,
        bitonic_call_ms=time_ms(lambda: pm._sort1d_bitonic(ks)),
        flat_call_ms=time_ms(lambda: pm._sort1d(ks)),
        wrapper_calls=calls, launches=len(sched), launch_ms=each,
        schedule=[list(x) for x in sched],
        schedule_floor_ms=len(sched) * 2 * NK_SORT * NP * 4
        / hbm_rate(out["card"]) * 1e3,
        default=dict(W=keep[0], T=keep[1], R=keep[2]),
        schedules_checked=len(cfgs), schedules_equal=sched_ok,
    )
    log("[2] whole sort at SC=122880: " + json.dumps(out["sort_compare"]))
    log(f"[2] sort schedules: {len(cfgs)} (W, T, R) equal to the flat sort: "
        f"{sched_ok}; default W={keep[0]} T={keep[1]} R={keep[2]}")
    levels = (NP // min(keep[0], NP)).bit_length() - 1
    return eq and sched_ok and calls == dict(sort_runs=1, merge_level=levels)


def live_fold_time(name, fn, rows_longest, rows_total, shape):
    """Device time of a fold captured from a live step, beside the row
    count of its longest read."""
    ms, = device_ms([(fn, 20)], tag=name + "_live")
    res = dict(shape=shape, rows_longest=rows_longest, rows=rows_total,
               ms=ms, us_per_row=ms * 1e3 / max(rows_longest, 1))
    log(f"[live] {name} on captured step inputs: " + json.dumps(res))
    return res


def check(name, got, want, ph=2) -> bool:
    import torch

    torch.cuda.synchronize()
    eq = same_bits(got, want)
    log(f"[{ph}] {name}: {'bit-equal' if eq else 'MISMATCH'}")
    return eq


def wrapper_counts():
    """The wrapper calls of ``_cuda.COUNTS``, less the kernels IN_GRAPH
    (their count leaves out every replayed launch)."""
    from uncalled_tpu_torch.ops import _cuda

    return {k: v for k, v in _cuda.COUNTS.items() if k not in IN_GRAPH}


def graph_launches(kern, name):
    """The device launches of the IN_GRAPH kernel ``name`` among the traced
    kernel events ``kern``."""
    return [e for e in kern
            if any(t in e.get("name", "") for t in IN_GRAPH[name])]


def report(res, name, got, want, rate, kfn, pfn, lfn, nbytes, shape,
           plain_reps=10, key=None, rows_longest=None, ph=2,
           plain_events=False) -> bool:
    """Check ``got`` against ``want`` and time the kernel, the plain version
    and the library call; ``plain_events`` times the plain version by CUDA
    events instead of tracing it (a plain version of thousands of launches
    a call makes traces of seconds each)."""
    eq = check(key or name, got, want, ph)
    traced = pfn is not None and not plain_events
    fns = [(kfn, 20)]
    if traced:
        fns.append((pfn, plain_reps))
    if lfn is not None:
        fns.append((lfn, 20))
    src = []
    ms, *rest = device_ms(fns, tag=name, sources=src)
    plain_ms, plain_src = (rest.pop(0), src[1]) if traced else (None, None)
    lib_ms = rest.pop(0) if lfn is not None else None
    if pfn is not None and not traced:
        plain_ms = time_ms(pfn, reps=plain_reps, warm=1)
        plain_src = "cuda_events"
    call_ms = time_ms(kfn)
    bound_ms = nbytes / rate * 1e3
    # ms_source: "profiler" (the kernels' device time), or "cuda_events"
    # where the profiler recorded none (wall time of a call, launch
    # included)
    res[key or name] = dict(
        KERNELS[name], launches=0, max_abs_err=0.0 if eq else None,
        ms=ms, ms_source=src[0], plain_ms=plain_ms,
        plain_ms_source=plain_src, bound_ms=bound_ms, bound_by="bytes",
        library_ms=lib_ms, call_ms=call_ms, shape=shape, bytes=nbytes,
    )
    if rows_longest is not None:  # a row chain: its length and per-row time
        res[key or name].update(rows_longest=rows_longest,
                                us_per_row=ms * 1e3 / max(rows_longest, 1))
        log(f"[2] {key or name}: longest read {rows_longest} rows, "
            f"{ms * 1e3 / max(rows_longest, 1):.4f} us a row")
    log(f"[{ph}] {name} {shape}: device ms per call: kernel {ms:.4f}, plain "
        f"{plain_ms if plain_ms is None else round(plain_ms, 4)}, library "
        f"{lib_ms if lib_ms is None else round(lib_ms, 4)}, bound "
        f"{bound_ms:.4f} ({nbytes} B); kernel call incl. host "
        f"{call_ms:.4f} ms (CUDA events)")
    return eq


class _Read:
    def __init__(self, id, signal):
        self.id = id
        self.signal = np.asarray(signal, dtype=np.float32)
        self.channel, self.number, self.start_sample = 1, 0, 0

    @property
    def raw_len(self):
        return len(self.signal)


def _conf(B, spr, T, pooled=True):
    """The configurations of phases 3-5 before the conf defaults ran:
    handoff and drain off."""
    from uncalled_tpu_torch.config import Conf

    conf = Conf()
    conf.engine.batch_reads = B
    conf.engine.pooled = pooled
    conf.engine.pool_slots_per_read = spr
    conf.engine.evt_block = T
    conf.engine.slot_handoff = False
    conf.engine.drain_shrink = False
    return conf


def phase_golden(out, refs):
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    fx = os.path.join(REPO, "tests", "fixtures")
    prefix = os.path.join(fx, "example_index", "example_ref")
    fmi = load_bwa_index(prefix)
    th = load_uncl(prefix + ".uncl")
    with open(os.path.join(fx, "golden_pafs.json")) as f:
        golden = json.load(f)
    sigs = np.load(os.path.join(fx, "golden_reads.npz"), allow_pickle=True)
    # the 13 reads that decide (noise_1, which never decides and runs its
    # 2250 events to the end, runs whole once in this phase: on the classic
    # engine with the full SA, whose step costs about half the pooled one's)
    bm = BatchMapper(fmi, load_default(), th, _conf(4, 512, 64),
                     sort_mode="flat")
    ok, info = golden_run("golden", bm, [r for r in golden if r != "noise_1"],
                          golden, sigs, POOLED_KERNELS)
    out["golden_launches"] = info["launches"]
    # the pooled engine's harvest of a read that never decides, at the end
    # of its signal: noise_1 cut short, held to the port's CPU run
    t0 = time.time()
    got = noise_pooled("cuda")
    want = refs.get("noise_pooled")
    noise_ok = got == want and len(got) == 1 and got[0].split("\t")[4] == "*"
    out["golden_noise_pooled"] = dict(line=got, equal=got == want,
                                      seconds=time.time() - t0)
    log(f"[3] noise_1 cut to {NOISE_CUT} samples, pooled: {got} "
        f"{'equal to' if got == want else 'DIFFERS from'} the port's CPU "
        f"run, unmapped {noise_ok} ({time.time() - t0:.2f} s)")
    ok &= noise_ok
    # the 13 reads with the 1/32 SA sample: the LF-walk kernel looks up
    # every seed row
    bm = BatchMapper(fmi, load_default(), th, _conf(4, 512, 64),
                     sort_mode="flat", sampled_sa=True, sa_intv=SA_INTV)
    s_ok, out["golden_sampled"] = golden_run(
        "golden sampled SA", bm, [r for r in golden if r != "noise_1"],
        golden, sigs, SAMPLED_POOLED)
    ok &= s_ok and sampled_chain(bm)

    # a pool too small for the read: it ejects to the pooled wide tier,
    # which runs on the card and must still give the golden line
    rid = "sim_0000_Escherichia_coli_3854_+"
    t0 = time.time()
    conf = _conf(2, 512, 64)
    conf.engine.remap_ladder = ((1024, 2, 128, 256, 0),)
    bm = BatchMapper(fmi, load_default(), th, conf, S=128, SC=160,
                     sort_mode="flat")
    got = {p.rd_name: p.to_line()
           for p in bm.map_reads([_Read(rid, sigs[rid])])}
    tiers = bm.tiers()
    tier_ok = (got.get(rid) == golden[rid]
               and [m.n_ejected for m in tiers] == [1, 0])
    shapes = [(m.eng.params.B, m.eng.params.S, m.eng.params.CL) for m in tiers]
    log(f"[3] eject tier: ejects {[m.n_ejected for m in tiers]}, tier shapes "
        f"(B, S, CL) {shapes}, golden line "
        f"{'identical' if tier_ok else 'MISMATCH'} ({time.time() - t0:.2f} s)")
    classic_ok = phase_golden_classic(out, fmi, th, golden, sigs)
    defaults_ok = phase_golden_defaults(out, fmi, th, golden, sigs)
    graph_ok = graph_replay_check(out)
    return ok and tier_ok and classic_ok and defaults_ok and graph_ok


def graph_replay_check(out) -> bool:
    """The pooled step's CUDA-graph replay (``graphs.BlockGraphs``) against
    ``pool_advance_block``, bit for bit on every state key after every
    block, at the benchmark cell's shapes (B=256, T=32, 384 pool slots a
    read, bitonic sort) on the example index: the 14 golden reads admitted
    in turn, decided slots reset, and with the handoff standbys armed,
    switched and promoted.  The runner's first block is its capture, each
    later one a replay."""
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping import pooled as tp
    from uncalled_tpu_torch.testing import graph_check as gc

    idx = gc.example_index("cuda")
    events = list(gc.golden_events().values())
    res = out["graph_replay"] = {}
    ok = True
    conf = Conf()
    conf.engine.batch_reads = 256
    for handoff, blocks in ((True, 4), (False, 3)):
        p = tp.PoolParams.from_conf(conf, sort_mode="bitonic",
                                    handoff=handoff)
        t0 = time.time()
        diffs, counts = gc.compare_blocks(idx, p, events, blocks, 32, "cuda")
        good = (all(not d for d in diffs) and counts["resets"] > 0
                and (counts["switched"] > 0 or not handoff))
        res[f"handoff={handoff}"] = dict(differ=diffs, blocks=blocks,
                                         seconds=time.time() - t0, ok=good,
                                         **counts)
        log(f"[3] graph replay against the eager block, B={p.B} T=32 "
            f"handoff {handoff}: keys differing by block {diffs}; "
            f"{counts['switched']} switched, {counts['resets']} reset; "
            f"{'bit-equal' if good else 'FAILED'} "
            f"({time.time() - t0:.2f} s)")
        ok &= good
    return ok


def golden_run(tag, bm, rids, golden, sigs, kernels):
    """Map golden reads ``rids`` with ``bm``, the launch counts set to 0
    just before and read just after: ok when every line is the golden one
    and each of ``kernels`` launched."""
    from uncalled_tpu_torch.ops import _cuda

    reads = [_Read(r, sigs[r]) for r in rids]
    _cuda.reset_counts()
    t0 = time.time()
    got = {p.rd_name: p.to_line() for p in bm.map_reads(reads)}
    dt = time.time() - t0
    counts = wrapper_counts()
    bad = [r for r in rids if got.get(r) != golden[r]]
    gr = graph_counts(bm)
    log(f"[3] {tag}: {len(rids) - len(bad)}/{len(rids)} lines "
        f"byte-identical in {dt:.2f} s; graphs {gr}; launches {counts}")
    for r in bad:
        log(f"[3]   {r}: got {got.get(r)!r}")
    ok = not bad and all(counts[k] > 0 for k in kernels)
    return ok, dict(seconds=dt, reads=len(rids), bad=bad, launches=counts,
                    graphs=gr, ok=ok)


def graph_counts(bm) -> dict:
    """The pooled engines' graph counters summed over a mapper's chain
    (``PooledEngine.advance``: captures, event steps replayed, eager)."""
    ch = _chain(bm)
    return {k: sum(getattr(m.eng, k, 0) for m in ch)
            for k in ("graph_captures", "graph_steps", "eager_steps")}


def sampled_chain(bm) -> bool:
    """Every engine of the mapper's chain keeps the 1/32 SA sample on the
    card and no full SA."""
    ok = all(m.eng.params.sampled_sa and "sa_samp" in m.eng.idx
             and "sa" not in m.eng.idx for m in _chain(bm))
    log(f"[3]   sampled SA in every engine of the chain "
        f"({len(_chain(bm))}): {ok}")
    return ok


def _chain(bm):
    """A mapper and every mapper built below it: its drains and eject
    tiers, and theirs."""
    out, todo = [], [bm]
    while todo:
        m = todo.pop(0)
        if m is not None and all(m is not x for x in out):
            out.append(m)
            todo += [m._drain_mapper, m._next_mapper]
    return out


def _drains(bm):
    """B of the mapper and of each drain in its drain chain."""
    out = []
    while bm is not None:
        out.append(bm.eng.params.B)
        bm = bm._drain_mapper
    return out


def phase_golden_defaults(out, fmi, th, golden, sigs):
    """The golden reads through the conf defaults' paths: the slot handoff,
    the drain chain by migration (pooled) and by restart (classic), and
    the bitonic sort at a pool size where its merge levels launch."""
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.engine import MapEngine
    from uncalled_tpu_torch.mapping.pooled import PooledEngine
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.poremodel import load_default

    model = load_default()
    res = out["golden_defaults"] = {}

    def run(name, conf, rids, cond, **over):
        bm = BatchMapper(fmi, model, th, conf, **over)
        migrated = []
        if isinstance(bm.eng, PooledEngine):
            orig = bm.eng.migrate

            def migrate(state, sel, dst):
                migrated.append(int((np.asarray(sel) >= 0).sum()))
                return orig(state, sel, dst)

            bm.eng.migrate = migrate
        _cuda.reset_counts()
        t0 = time.time()
        got = {p.rd_name: p.to_line()
               for p in bm.map_reads([_Read(r, sigs[r]) for r in rids])}
        dt = time.time() - t0
        counts = wrapper_counts()
        chain = _chain(bm)
        bad = [r for r in rids if got.get(r) != golden[r]]
        info = dict(
            seconds=dt, reads=len(rids), yielded=len(got), bad=bad,
            engine=type(bm.eng).__name__,
            sort_mode=getattr(bm.eng.params, "sort_mode", None),
            handoff=getattr(bm.eng.params, "handoff", False),
            n_handoff=sum(m.n_handoff for m in chain),
            n_migrate=bm.n_migrate, migrated_reads=migrated,
            drains=_drains(bm), graphs=graph_counts(bm), launches=counts)
        passed = (not bad and len(got) == len(rids)
                  and cond(bm, info, counts))
        res[name] = dict(info, ok=passed)
        log(f"[3] defaults/{name}: {len(rids) - len(bad)}/{len(rids)} lines "
            f"byte-identical, {'ok' if passed else 'FAILED'}: "
            + json.dumps(info))
        return passed

    def conf_of(B, spr=None, T=None, pooled=True):
        conf = Conf()
        conf.engine.batch_reads = B
        conf.engine.pooled = pooled
        if spr:
            conf.engine.pool_slots_per_read = spr
        if T:
            conf.engine.evt_block = T
        return conf

    ok = True
    allr = list(golden)
    sims = [r for r in allr if r.startswith("sim_")]
    # Conf() at B=2: too narrow to drain; decided slots switch on the card
    # (three reads, more than the slots: one handoff)
    ok &= run("handoff B=2", conf_of(2), sims[:3],
              lambda bm, i, c: (i["handoff"] and i["n_handoff"] > 0
                                and i["sort_mode"] == "bitonic"
                                and c["sort_runs"] > 0
                                and all(c[k] > 0 for k in POOLED_KERNELS)))
    # B=8 at 2048 slots per read (SC=20480, NP=32768: two merge levels per
    # step): handoff, tail-mode disarm, the drain chain, bitonic merges.
    # The 12 reads that decide: the two that never do add ~100 s of drain
    # tail here and run through the handoff at B=2 above.
    ok &= run("handoff+drain+bitonic B=8", conf_of(8, 2048),
              [r for r in allr if r.startswith("sim_")],
              lambda bm, i, c: (i["n_handoff"] > 0 and len(i["drains"]) > 1
                                and c["sort_runs"] > 0
                                and c["merge_level"] > 0))
    # drain by migration (tests/test_pooled.py): B=8 drains at this scale
    conf = conf_of(8, 512, 16)
    conf.engine.drain_min_batch = 8
    ok &= run("drain by migration B=8", conf, allr[:10],
              lambda bm, i, c: (i["n_migrate"] > 0 and i["migrated_reads"]
                                and isinstance(bm._drain_mapper.eng,
                                               PooledEngine)))
    # all 14 golden reads, noise_1 whole (2250 events, never decides),
    # at Conf() on B=4: every block after an engine's first of its shape
    # replays the step's CUDA graphs (mapping/graphs.py)
    ok &= run("graphs B=4, all 14", conf_of(4), allr,
              lambda bm, i, c: (i["graphs"]["graph_captures"] > 0
                                and i["graphs"]["graph_steps"]
                                >= 10 * i["graphs"]["eager_steps"]))
    # the classic entry drains by restart (tests/test_engine.py)
    ok &= run("classic drain by restart B=64", conf_of(64, pooled=False),
              ["sim_0000_Escherichia_coli_3854_+",
               "sim_0003_Escherichia_coli_6188_-"],
              lambda bm, i, c: (isinstance(bm.eng, MapEngine)
                                and i["drains"][:2] == [64, 32]))
    return ok


def _rungs(bm):
    """Per rung of a mapper's ladder: its budgets, the reads it harvested
    (finished or ejected on), the reads it sent on, and its event steps."""
    out = []
    for m in bm.tiers():
        p = m.eng.params
        out.append(dict(
            rung=m._rung, pool_tier=m._pool_tier,
            engine=type(m.eng).__name__, B=p.B,
            P=getattr(p, "P", None), CL=p.CL, R=p.R,
            harvested=len(m.demand), ejected=m.n_ejected,
            finished=len(m.demand) - m.n_ejected,
            steps=m.disp_events // p.B,
        ))
    return out


def phase_golden_classic(out, fmi, th, golden, sigs):
    """The classic engine and its remap ladder on the golden reads."""
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.engine import MapEngine
    from uncalled_tpu_torch.poremodel import load_default

    model = load_default()
    # the 14 reads at B=4 (more reads than slots) at the conf defaults,
    # noise_1 among them: its one run in this phase
    bm = BatchMapper(fmi, model, th, _conf(4, 512, 64, pooled=False))
    ok, info = golden_run("classic golden", bm, list(golden), golden, sigs,
                          CLASSIC_KERNELS)
    rungs = _rungs(bm)
    log(f"[3] classic golden rungs {rungs}")
    out["golden_classic"] = dict(info, rungs=rungs)
    ok &= isinstance(bm.eng, MapEngine)
    # the 13 reads that decide with the 1/32 SA sample, every rung sampled
    # (noise_1 ran above)
    bm = BatchMapper(fmi, model, th, _conf(4, 512, 64, pooled=False),
                     sampled_sa=True, sa_intv=SA_INTV)
    s_ok, info = golden_run("classic golden sampled SA", bm,
                            [r for r in golden if r != "noise_1"], golden,
                            sigs, SAMPLED_CLASSIC)
    out["golden_classic_sampled"] = dict(info, rungs=_rungs(bm))
    ok &= s_ok and isinstance(bm.eng, MapEngine) and sampled_chain(bm)

    # narrow budgets and a narrow two-rung ladder (tests/test_engine.py
    # test_remap_ladder_restores_parity); one read shows it, climbing both
    # rungs
    fast = ["sim_0000_Escherichia_coli_3854_+"]
    t0 = time.time()
    conf = _conf(4, 512, 64, pooled=False)
    conf.engine.remap_ladder = ((64, 4, 8, 16, 0), (1024, 4, 48, 128, 0))
    bm = BatchMapper(fmi, model, th, conf, P=32, C=32, R=4, CL=8)
    got = {p.rd_name: p.to_line()
           for p in bm.map_reads([_Read(r, sigs[r]) for r in fast])}
    rungs = _rungs(bm)
    ladder_ok = (all(got.get(r) == golden[r] for r in fast)
                 and bm.n_ejected == len(fast)
                 and [r["rung"] for r in rungs] == [0, 1, 2]
                 and rungs[-1]["P"] == 1024)
    log(f"[3] narrow ladder: rungs {rungs}, golden lines "
        f"{'identical' if ladder_ok else 'MISMATCH'} ({time.time() - t0:.2f}"
        " s)")

    # pooled tiers too small as well: the read goes on to the classic
    # final rung (tests/test_pooled.py
    # test_pooled_exhaustion_chains_to_classic_final_rung)
    rid = fast[0]
    t0 = time.time()
    conf = _conf(2, 512, 64)
    conf.engine.pool_wide = (96, 256)
    conf.engine.pool_max = (112, 256)
    conf.engine.remap_ladder = ((1024, 2, 128, 256, 0),)
    bm = BatchMapper(fmi, model, th, conf, S=128, SC=160, sort_mode="flat")
    got = {p.rd_name: p.to_line()
           for p in bm.map_reads([_Read(rid, sigs[rid])])}
    rungs = _rungs(bm)
    final_ok = (got.get(rid) == golden[rid]
                and [r["ejected"] for r in rungs] == [1, 1, 1, 0]
                and isinstance(bm.tiers()[-1].eng, MapEngine))
    log(f"[3] pooled tiers -> classic final rung: rungs {rungs}, golden line "
        f"{'identical' if final_ok else 'MISMATCH'} ({time.time() - t0:.2f} "
        "s)")
    return ok and ladder_ok and final_ok


_ASSETS: dict = {}
_ON_ASSETS: list = []  # called once the assets are on disk


def real_assets():
    """Phase 4's genome, index, thresholds and reads, built once."""
    if not _ASSETS:
        _ASSETS["v"] = build_assets(assets_prefix())
        for f in _ON_ASSETS:
            f()
    return _ASSETS["v"]


def assets_prefix():
    """Where phase 4's genome (.fa) and thresholds (.uncl) are written."""
    from uncalled_tpu_torch.ops._cuda import BUILD_DIR

    return os.path.join(BUILD_DIR, "smoke_assets", "rgen_4700000")


def build_assets(prefix):
    """The 4.7 Mb genome (seed 42), its index and thresholds, and 8 + 512
    mismatched simulated reads (seed 123), built from the port's copies
    (phase 5 maps the first 8 + 16 of the same reads)."""
    from uncalled_tpu_torch.index.build import build_index
    from uncalled_tpu_torch.index.parameterize import build_uncl
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.testing.simulate import (
        realistic_genome,
        simulate_reads,
    )

    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    t0 = time.time()
    seq = realistic_genome(4_700_000, seed=42)
    with open(prefix + ".fa", "w") as f:
        f.write(">bench_ref\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i: i + 80] + "\n")
    t1 = time.time()
    fmi = build_index(prefix + ".fa")
    t2 = time.time()
    build_uncl(fmi, prefix)
    th = load_uncl(prefix + ".uncl")
    t3 = time.time()
    reads = simulate_reads(prefix + ".fa", 8 + N_POOLED, seed=123,
                           read_len_bp=(1000, 4000), mismatch=True)
    t4 = time.time()
    log(f"[4] assets: genome {t1 - t0:.1f} s, index n={fmi.n} {t2 - t1:.1f} s,"
        f" uncl {t3 - t2:.1f} s, reads {t4 - t3:.1f} s")
    return fmi, th, reads


POOLED_HOOKS = {  # a captured kernel -> the module and name the step
    # calls it by: the wrappers a graph replay calls (mapping/graphs.py)
    "tracker_fold": ("pooled", "tracker_run_compact"),
    "ring_assemble": ("pooled", "ring_assemble"),
    "pair_counts": ("pooled", "pair_counts"),
    "flat_gather": ("colgather", "gather"),
    "sort_runs": ("pooled", "sort_runs"),
    "merge_level": ("pooled", "merge_level_"),
    # inside a graph piece: called by eager blocks and captures only
    "seg_running_max": ("pooled", "seg_running_max")}


@contextlib.contextmanager
def capture_pooled(limits, NP=None):
    """Copies of the inputs of the pooled step's kernel calls while the
    block runs: up to limits[name] calls of each kernel named, tracker
    folds only where they carry seed rows, and with NP only the sorts of
    that padded width (the merge levels of the first sort captured).
    The segmented running max is taken from eager steps (not while a
    graph captures), where its segments run past 0.
    Yields {name: [argument tuple, ...]} for pooled_pair."""
    import torch

    import uncalled_tpu_torch.mapping.pooled as pooled
    import uncalled_tpu_torch.ops.colgather as colgather

    mods = dict(pooled=pooled, colgather=colgather)
    cap = {k: [] for k in limits}
    take = dict(
        tracker_fold=lambda *a: int(a[6].sum()) > 0,
        flat_gather=lambda kernel, *a, **k: kernel == "flat_gather",
        sort_runs=lambda keys, n, w: NP is None or n == NP,
        merge_level=lambda buf, k, c: bool(cap.get("sort_runs")) and (
            NP is None or buf.shape[1] == NP),
        seg_running_max=lambda seg, vals: (
            not torch.cuda.is_current_stream_capturing()
            and int(seg[-1]) > 0))
    copy = dict(
        tracker_fold=lambda *a: (a[0], {k: v.clone() for k, v in a[1].items()},
                                 *[x.clone() for x in a[2:]]),
        ring_assemble=lambda *a: tuple(x.clone() for x in a),
        pair_counts=lambda x, y, na, nb: (x.clone(), y.clone(), na, nb),
        flat_gather=lambda kernel, cols, idx, lens=None, out=None: (
            keep(cols), idx.clone(), lens),
        sort_runs=lambda keys, n, w: ([k.clone() for k in keys], n, w),
        merge_level=lambda buf, k, c: (buf.clone(), k, c),
        seg_running_max=lambda seg, vals: (seg.clone(), vals.clone()))
    site = {k: (mods[POOLED_HOOKS[k][0]], POOLED_HOOKS[k][1]) for k in limits}
    orig = {k: getattr(*site[k]) for k in limits}

    def hook(name):
        def f(*a, **kw):
            if len(cap[name]) < limits[name] and take.get(
                    name, lambda *_, **__: True)(*a, **kw):
                cap[name].append(copy[name](*a, **kw))
            return orig[name](*a, **kw)
        return f

    for k in limits:
        setattr(*site[k], hook(k))
    try:
        yield cap
    finally:
        for k, f in orig.items():
            setattr(*site[k], f)


def pooled_pair(name, a):
    """The kernel's and the plain version's results on the same captured
    call (capture_pooled's argument tuples)."""
    import torch

    from uncalled_tpu_torch.ops import flat_gather as fg
    from uncalled_tpu_torch.ops import seg_scan as ss
    from uncalled_tpu_torch.ops import sortkern as sk
    from uncalled_tpu_torch.ops import stepkern as stk
    from uncalled_tpu_torch.ops import tracker_kernel as tk

    if name == "seg_running_max":
        return ss.seg_running_max(*a), ss.seg_running_max_plain(*a)
    if name == "tracker_fold":
        return tk.tracker_run_compact(*a), tk.tracker_run_compact_plain(*a)
    if name == "ring_assemble":
        return stk.ring_assemble(*a), stk.ring_assemble_plain(*a)
    if name == "pair_counts":
        return fg.pair_counts(*a), fg.pair_counts_plain(*a)
    if name == "flat_gather":
        return fg.flat_gather_cols(*a), fg.flat_gather_cols_plain(*a)
    if name == "sort_runs":
        return sk.sort_runs(*a), torch.stack(sk.sort_runs_plain(*a))
    buf, k_lv, C = a
    got = buf.clone()
    sk.merge_level_(got, k_lv, C)
    return got, torch.stack(sk.merge_level_plain(list(buf.unbind(0)), k_lv,
                                                 C))


def recheck_captured(cap, ph) -> bool:
    """Every captured call re-run through its kernel and its plain version
    on the card, bit for bit; each kernel named must have a capture."""
    import torch

    ok = True
    for name, calls in cap.items():
        for i, a in enumerate(calls):
            got, want = pooled_pair(name, a)
            torch.cuda.synchronize()
            eq = same_bits(got, want)
            ok &= eq
            log(f"[{ph}] captured {name}#{i}{capture_shape(name, a)}: "
                f"{'bit-equal' if eq else 'MISMATCH'}")
        if not calls:
            log(f"[{ph}] captured {name}: no call captured")
        ok &= bool(calls)
    return ok


def capture_shape(name, a) -> str:
    """What a captured call ran at: the fold's launch form, the count's
    shape, the sort's width."""
    from uncalled_tpu_torch.ops import tracker_kernel as tk

    if name == "tracker_fold":
        B, CL = a[1]["cl_valid"].shape
        fl = tk.fold_launch(CL, B)
        return f" (B={B} CL={CL} {fl.form}, {fl.threads} threads a read)"
    if name == "pair_counts":
        return f" (keys {a[0].numel()}, [{a[2]}, {a[3]}])"
    if name == "ring_assemble":
        return f" (ring {tuple(a[0].shape)})"
    if name == "sort_runs":
        return f" (NP={a[1]}, W={a[2]})"
    if name == "merge_level":
        return f" (NP={a[0].shape[1]}, k_lv={a[1]}, C={a[2]})"
    if name == "seg_running_max":
        return f" (N={a[0].numel()}, {int(a[0][-1]) + 1} segments)"
    return ""


def phase_real(out, rate):
    import torch

    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import flat_gather as fg
    from uncalled_tpu_torch.ops import tracker_kernel as tk
    from uncalled_tpu_torch.poremodel import load_default

    fmi, th, sim = real_assets()
    model = load_default()
    conf = _conf(B_FULL, SPR, 32)
    bm = BatchMapper(fmi, model, th, conf, sort_mode="flat")
    p = bm.eng.params
    log(f"[4] shapes B={p.B} S={p.S} SC={p.SC} CL={p.CL} R={p.R} RE={p.RE} "
        f"RT={p.RT} FS={p.FS} T={bm.T}")

    # the reads are bench.py's: the two tie reads among them are the
    # fixture's signals bit for bit
    tie_sig, tie_want = tie_fixtures()
    pinned = {rid: sim[i].id == rid and np.array_equal(
        np.asarray(sim[i].signal, np.float32).view(np.uint32),
        tie_sig[rid].view(np.uint32)) for i, rid in TIE_IN_PHASE4.items()}
    log("[4] phase 4's reads " + ", ".join(
        f"sim[{i}] {'is' if pinned[r] else 'is NOT'} {r} of tie_reads.npz"
        for i, r in TIE_IN_PHASE4.items()))
    ok = all(pinned.values())

    # the untimed warm-up: 8 reads and the 7 tie reads, whose lines must be
    # the reference rig's (stable build); capture live kernel inputs (first
    # calls that carry seed rows), to re-check kernel vs plain on real
    # step data
    warm = [_Read(r.id, r.signal) for r in sim[:8]] + [
        _Read(rid, sig) for rid, sig in tie_sig.items()]
    _cuda.reset_counts()
    t0 = time.time()
    with capture_pooled(dict(tracker_fold=3, ring_assemble=3, pair_counts=3,
                             flat_gather=9, seg_running_max=3)) as captured:
        warm_lines = {pf.rd_name: pf.to_line() for pf in bm.map_reads(warm)}
    dt = time.time() - t0
    counts = wrapper_counts()
    tie_eq = {rid: strip_wall(warm_lines.get(rid, "")) == strip_wall(
        tie_want["stable"][rid]) for rid in tie_sig}
    for rid in tie_sig:
        if not tie_eq[rid]:
            log(f"[4] tie read {rid}: the card gives "
                f"{warm_lines.get(rid)!r}, the reference rig "
                f"{tie_want['stable'][rid]!r}")
    tie_ran = all(counts[k] > 0 for k in POOLED_KERNELS)
    out["real_tie_reads"] = dict(pinned=pinned, equal=tie_eq, seconds=dt,
                                 warm_reads=len(warm), launches=counts)
    log(f"[4] warm-up: {len(warm_lines)} reads in {dt:.2f} s; the 7 tie "
        f"reads: {sum(tie_eq.values())}/{len(tie_eq)} lines equal to "
        f"tie_pafs.json (mt stripped); launches "
        + json.dumps({k: v for k, v in counts.items() if v}))
    ok &= all(tie_eq.values()) and tie_ran and len(warm_lines) == len(warm)
    ok &= recheck_captured(captured, 4)
    # the pair count on the live step's keys (most of them out of domain)
    if captured["pair_counts"]:
        pa_ = captured["pair_counts"][-1]
        ms, = device_ms([(lambda: fg.pair_counts(*pa_), 20)],
                        tag="pair_counts_live")
        x, y, na_, nb_ = pa_
        live = dict(ms=ms, keys=x.numel(), in_domain=int(
            ((x >= 0) & (x < na_) & (y >= 0) & (y < nb_)).sum()))
        out["real_pair_counts"] = live
        log("[4] pair_counts on captured step keys: " + json.dumps(live))
    # the step's nine column gathers, the unified record table among them
    ok &= any(len(c[0]) == 5 for c, _, _ in captured["flat_gather"]
              if isinstance(c[0], list))
    # the compact fold on the live step's rows (the real regime: few rows
    # a read), the captured call with the longest read
    if captured["tracker_fold"]:
        a = max(captured["tracker_fold"], key=lambda a: int(a[6].max()))
        out["real_fold"] = live_fold_time(
            "tracker_fold", lambda: tk.tracker_run_compact(*a),
            int(a[6].max()), int(a[6].sum()), tuple(a[1]["cl_valid"].shape))

    # the timed run
    truth = {r.id: (r.ref_name, r.ref_start, r.ref_end, r.fwd) for r in sim}
    timed = [_Read(r.id, r.signal) for r in sim[8:]]
    bm2 = BatchMapper(fmi, model, th, conf, engine=bm.eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    t0 = time.time()
    pafs = list(bm2.map_reads(timed))
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = wrapper_counts()
    tiers = bm2.tiers()
    steps = sum(m.disp_events // m.eng.params.B for m in tiers)
    steps0 = bm2.disp_events // B_FULL
    n_mapped = sum(1 for pf in pafs if pf.is_mapped)
    n_correct = sum(
        1 for pf in pafs if pf.is_mapped and pf.rf_name == truth[pf.rd_name][0]
        and truth[pf.rd_name][1] - 500 <= pf.rf_st <= truth[pf.rd_name][2] + 500
        and pf.fwd == truth[pf.rd_name][3]
    )
    lines_ok = all(len(pf.to_line().split("\t")) >= 12 for pf in pafs)
    real = dict(
        reads=len(timed), yielded=len(pafs), seconds=dt,
        reads_per_s=len(timed) / dt, steps=steps, steps_tier0=steps0,
        ms_per_step=dt * 1e3 / max(steps, 1),
        mapped_frac=n_mapped / len(timed), correct_frac=n_correct / len(timed),
        correct_of_mapped=n_correct / max(n_mapped, 1),
        ejects_per_tier=[m.n_ejected for m in tiers],
        tier_shapes=[(m.eng.params.B, m.eng.params.S, m.eng.params.CL)
                     for m in tiers],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=counts,
        launches_per_step={k: v / max(steps, 1) for k, v in counts.items()},
        useful_frac=bm2.useful_events / max(bm2.disp_events, 1),
        pool_hw=[int(x) for x in bm2.pool_hw],
    )
    out["real"] = real
    out["real_lines"] = {pf.rd_name: pf.to_line() for pf in pafs}
    log("[4] real: " + json.dumps(real))
    log("[4] tracker fold forms: " + json.dumps(fold_forms(counts)))
    out["profile"] = profile_block(bm2, timed)
    log("[4] profile: " + json.dumps(out["profile"]))
    ok &= lines_ok and len(pafs) == len(timed) and n_mapped > 0
    ok &= all(counts[k] > 0 for k in POOLED_KERNELS)
    for k in POOLED_KERNELS:
        if k in out["kernels"]:
            out["kernels"][k]["launches"] = counts[k]
    # the segmented running max in the profiled block's replays
    n_seg = out["profile"]["seg_running_max_launches"]
    log(f"[4] seg_running_max: {n_seg} device launches in the profiled "
        f"block of {bm2.T} steps")
    ok &= n_seg > 0
    if "seg_running_max" in out["kernels"]:
        out["kernels"]["seg_running_max"]["launches"] = n_seg
    dev = torch.device("cuda")
    ok &= sa_lookup_real(out, rate, fmi, th, model, dev)
    ok &= sampled_real(out, fmi, th, model, conf, bm.eng.idx,
                       timed[:N_SAMPLED], dev)
    return ok


def load_latency_ns(dev, n_words=7 << 18, steps=(20000, 60000)):
    """Nanoseconds of one dependent load: one thread follows a random
    single cycle through a 7 MB int32 table (the size of the 4.7 Mb
    genome's occ_rows; in L2 once warm), at two chain lengths, so the
    launch cancels out of the difference."""
    import torch

    from uncalled_tpu_torch.ops import _cuda

    rng = np.random.default_rng(7)
    perm = rng.permutation(n_words)
    nxt = np.empty(n_words, np.int32)
    nxt[perm] = np.roll(perm, -1)
    nxt_t = torch.from_numpy(nxt).to(dev)
    res = torch.empty(1, dtype=torch.int32, device=dev)
    # CUDA events: the difference of two single-thread chains cancels the
    # launch (the profiler lost these one-block launches in a run)
    ms = [time_ms(lambda k=k: _cuda.launch("probe_chase", nxt_t, k, res),
                  reps=5)
          for k in steps]
    return (ms[1] - ms[0]) * 1e6 / (steps[1] - steps[0])


def probe_lf_chain(kernel, occ, samp, L2, n, primary, sa_full, dev,
                   steps=(20000, 60000)):
    """Nanoseconds of one step of an LF-walk kernel (``"sa_lookup"`` or
    ``"sa_walk_step"``), and whether its walks came out right: one thread
    walks the index's real LF chain from the row of SA value k - 1 at
    intv = 2^30, where only row 0 ends a walk, so the walk takes exactly k
    steps (SA values k - 1 ... 0, then the primary row's step to row 0).
    Two k, so the launch cancels out of the difference.  The kernel's own
    loop runs, through its C launcher (no count): ``sa_lookup`` gives
    samp[0] + k, ``sa_walk_step`` over the whole table as one block
    (0, k)."""
    import torch

    from uncalled_tpu_torch.ops import _cuda

    intv = 1 << 30
    assert n < intv
    sa = np.asarray(sa_full)
    res = torch.empty(2, dtype=torch.int32, device=dev)
    ms, ok = [], True
    for k in steps:
        row = torch.tensor([int(np.flatnonzero(sa == k - 1)[0])],
                           dtype=torch.int32, device=dev)
        if kernel == "sa_lookup":
            args = ("sa_lookup_i32", occ, samp, L2, row, res, 1, n, primary,
                    intv)
            want = [int(samp[0]) + k]
        else:
            args = ("sa_walk_step_i32", occ, L2, row, res, 1, n, primary,
                    intv, 0, occ.shape[0])
            want = [0, k]
        # CUDA events: the difference of two single-thread chains cancels
        # the launch (the profiler lost these one-block launches in a run)
        ms.append(time_ms(lambda a=args: _cuda.launch(*a), reps=5))
        ok &= res.cpu().tolist()[:len(want)] == want
    return (ms[1] - ms[0]) * 1e6 / (steps[1] - steps[0]), ok


def queued_ms(fn, flush_mb=0, reps=10):
    """Median milliseconds of ``fn()`` by CUDA events, each call queued
    behind a spin of the card so that the events hold the device's time and
    not the host's issue; with ``flush_mb`` MB written before each call
    (more than the 50 MB L2), the call finds its tables cold."""
    import torch

    junk = torch.empty(flush_mb << 18, dtype=torch.int32, device="cuda")
    fn()
    ts = []
    for i in range(reps):
        junk.fill_(i)
        torch.cuda._sleep(1_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        ts.append(e0.elapsed_time(e1))
    return float(np.median(ts))


def sa_lookup_real(out, rate, fmi, th, model, dev):
    """The LF-walk kernel on the 4.7 Mb genome's index: seeded rows at the
    pooled step's RT = 6144 (the headline) and the classic step's B*R =
    16384, each with rows 0, n, primary, primary +- 1 and the 64 rows of
    the longest walks (found with numpy from sa_full), against the plain
    version and against the walk model from the full SA; then its device
    time, its byte bound (the distinct bucket rows and samples the walks
    read) and its chain bound (longest walk x a measured dependent-load
    latency), and the full SA's index_select as the library call."""
    import torch

    from uncalled_tpu_torch.mapping.engine import device_index
    from uncalled_tpu_torch.ops import sa_lookup as sl

    t0 = time.time()
    idx = device_index(fmi, th, model, device=dev, sampled_sa=True,
                       sa_intv=SA_INTV)
    n, primary = fmi.n, fmi.primary
    steps, value = sl.walk_model(fmi.sa_full, SA_INTV)
    t1 = time.time()
    crossed_all = int((value != fmi.sa_full).sum())
    walks = dict(n=n, primary=primary, mean=float(steps.mean()),
                 p99=float(np.percentile(steps, 99)),
                 longest=int(steps.max()), rows_past_primary=crossed_all,
                 model_s=t1 - t0)
    log("[4] LF-walk lengths over every row of the 4.7 Mb index: "
        + json.dumps(walks))
    out["sa_walks"] = walks
    longest = np.argsort(-steps, kind="stable")[:64]
    edges = np.array([0, n, primary, primary - 1, primary + 1], np.int64)
    rng = np.random.default_rng(20261018)
    sa_full_t = torch.from_numpy(np.asarray(fmi.sa_full, np.int32)).to(dev)
    ok = True
    for label, size in (("RT", RT_FULL), ("B*R", 64 * 256)):
        rows = rng.integers(0, n + 1, size)
        rows[: 69] = np.concatenate([edges, longest])
        rows_t = torch.from_numpy(rows.astype(np.int32)).to(dev)
        got = sl.sa_lookup(idx, rows_t, SA_INTV)
        eq = check(f"sa_lookup[{label} = {size} rows, 4.7 Mb index]", got,
                   sl.sa_lookup_plain(idx, rows_t, SA_INTV), ph=4)
        g = got.cpu().numpy().astype(np.int64)
        model_ok = np.array_equal(g, value[rows])
        crossed = value[rows] != fmi.sa_full[rows]
        full_ok = np.array_equal(g[~crossed], fmi.sa_full[rows][~crossed])
        log(f"[4] sa_lookup[{label}]: against the walk model "
            f"{'equal' if model_ok else 'MISMATCH'}; equal to sa_full on "
            f"{int((~crossed).sum())} rows, sa_full + n + 1 on "
            f"{int(crossed.sum())} (walks past the primary row, as the JAX "
            f"function gives them); longest walk here "
            f"{int(steps[rows].max())}")
        ok &= eq and model_ok and full_ok
        if label != "RT":
            continue
        # bytes: each input once (the rows, the distinct bucket rows and
        # samples the walks read, L2) and the output once.  The walk from a
        # row of SA value s and k steps loads the bucket rows of SA values
        # s - k + 1 ... s and ends on the row of s - k (row 0 below 0).
        sv = np.asarray(fmi.sa_full, np.int64)[rows]
        walk = steps[rows].astype(np.int64)
        inv = np.empty(n + 1, np.int64)
        inv[np.asarray(fmi.sa_full, np.int64)] = np.arange(n + 1)
        pos = (np.repeat(sv - walk + 1, walk) + np.arange(int(walk.sum()))
               - np.repeat(np.cumsum(walk) - walk, walk))
        j = inv[pos]
        buckets = np.unique((j - (j > primary)) >> 5).size
        end_rows = np.where(sv - walk >= 0, inv[np.maximum(sv - walk, 0)], 0)
        ends = np.unique(end_rows // SA_INTV).size
        nbytes = size * 8 + buckets * 24 + ends * 4 + 20
        lat = load_latency_ns(dev)
        chain_ms = int(walk.max()) * lat * 1e-6
        rows_l = rows_t.long()

        def lib():
            return sa_full_t.index_select(0, rows_l)

        # the plain walk (~14000 launches a call) is timed by CUDA events
        ok &= report(out["kernels"], "sa_lookup", got,
                     sl.sa_lookup_plain(idx, rows_t, SA_INTV), rate,
                     lambda: sl.sa_lookup(idx, rows_t, SA_INTV),
                     lambda: sl.sa_lookup_plain(idx, rows_t, SA_INTV), lib,
                     nbytes=nbytes, ph=4, plain_reps=3, plain_events=True,
                     shape=f"{size} rows, n={n}, intv={SA_INTV}")
        ent = out["kernels"]["sa_lookup"]
        ent.update(
            chain_bound_ms=chain_ms, load_latency_ns=lat,
            walk_longest=int(walk.max()), walk_mean=float(walk.mean()),
            walk_visits=int(walk.sum()), distinct_buckets=buckets,
            visit_bound_ms=size * (float(walk.mean()) + 1) * 24 / rate * 1e3)
        # the floor's rows: each of these rows rounded down to a sampled one
        sampled_t = (rows_t // SA_INTV) * SA_INTV
        ok &= lf_step_times(ent, "sa_lookup", 4, idx["occ_rows"],
                            idx["sa_samp"], idx["L2"], fmi, dev,
                            lambda: sl.sa_lookup(idx, sampled_t, SA_INTV))
        # the same call with the 50 MB L2 flushed before it, and warm, both
        # queued behind a spin (CUDA events)
        ent.update(
            cold_ms=queued_ms(lambda: sl.sa_lookup(idx, rows_t, SA_INTV),
                              flush_mb=128),
            warm_queued_ms=queued_ms(
                lambda: sl.sa_lookup(idx, rows_t, SA_INTV)))
        log("[4] sa_lookup bounds: " + json.dumps(
            {k: ent[k] for k in ("ms", "bound_ms", "visit_bound_ms",
                                 "chain_bound_ms", "load_latency_ns",
                                 "step_ns", "floor_ms", "step_model_ms",
                                 "warm_queued_ms", "cold_ms", "walk_longest",
                                 "walk_mean", "distinct_buckets",
                                 "library_ms")}))
    return ok


def lf_step_times(ent, kernel, ph, occ, samp, L2, fmi, dev, fn_floor):
    """Beside an LF-walk kernel's device time (``ent``, its entry of the
    kernels line): its step's latency by :func:`probe_lf_chain` against one
    dependent load's, its floor (the device time of the same launch on rows
    that take no step: the launch and what every row reads and writes), and
    the time the two predict, floor + longest walk x step."""
    step, walked = probe_lf_chain(kernel, occ, samp, L2, fmi.n, fmi.primary,
                                  fmi.sa_full, dev)
    floor, = device_ms([(fn_floor, 20)], tag=f"{kernel}_floor")
    longest = ent.get("walk_longest", ent.get("run_longest"))
    ent.update(step_ns=step, floor_ms=floor,
               step_model_ms=floor + longest * step * 1e-6)
    log(f"[{ph}] {kernel} step: {step:.1f} ns a step on one thread "
        f"(probe_lf_chain, walks {'right' if walked else 'WRONG'}) against "
        f"one dependent load's {ent['load_latency_ns']:.1f} ns (probe_chase);"
        f" floor {floor:.5f} ms; floor + longest {longest} x step "
        f"{ent['step_model_ms']:.5f} ms against the kernel's {ent['ms']:.5f}")
    return walked


def sampled_real(out, fmi, th, model, conf, full_idx, reads, dev):
    """The pooled mapper at B=256 with the 1/32 SA sample on the first
    N_SAMPLED of phase 4's timed reads: every line equal to phase 4's, the
    LF-walk kernel launched (counts set to 0 just before the run, read just
    after), ms and launches per step, the SA's and the whole index's device
    bytes against the full SA's, and live lookup inputs re-checked against
    the plain version."""
    import torch

    import uncalled_tpu_torch.mapping.pooled as pooled
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import sa_lookup as sl

    lines4 = out["real_lines"]
    bm = BatchMapper(fmi, model, th, conf, device=dev, sort_mode="flat",
                     sampled_sa=True, sa_intv=SA_INTV)
    captured = []
    orig = pooled.sa_lookup

    def cap(idx, rows, intv):
        if len(captured) < 3:
            captured.append((rows.clone(), intv))
        return orig(idx, rows, intv)

    pooled.sa_lookup = cap
    torch.cuda.synchronize()
    _cuda.reset_counts()
    t0 = time.time()
    try:
        pafs = list(bm.map_reads(reads))
        torch.cuda.synchronize()
    finally:
        pooled.sa_lookup = orig
    dt = time.time() - t0
    counts = wrapper_counts()
    steps = sum(m.disp_events // m.eng.params.B for m in bm.tiers())
    differ = [pf.rd_name for pf in pafs
              if lines4.get(pf.rd_name) != pf.to_line()]

    def nbytes(d):
        return sum(v.numel() * v.element_size() for v in d.values()
                   if isinstance(v, torch.Tensor))

    idx = bm.eng.idx
    samp = idx["sa_samp"].numel() * 4
    full = full_idx["sa"].numel() * 4
    res = dict(
        reads=len(reads), yielded=len(pafs),
        lines_equal_phase4=len(pafs) - len(differ), seconds=dt,
        reads_per_s=len(reads) / dt, steps=steps,
        ms_per_step=dt * 1e3 / max(steps, 1), launches=counts,
        launches_per_step={k: v / max(steps, 1) for k, v in counts.items()},
        sa_bytes=samp, sa_bytes_full=full, sa_ratio=samp / full,
        index_bytes=nbytes(idx), index_bytes_full=nbytes(full_idx),
        ejects_per_tier=[m.n_ejected for m in bm.tiers()])
    out["sampled"] = res
    log("[4] sampled SA, B=256: " + json.dumps(res))
    for r in differ[:5]:
        log(f"[4]   {r}: {lines4.get(r)!r} (phase 4) vs the sampled line")
    ok = (len(pafs) == len(reads) and not differ and counts["sa_lookup"] > 0
          and all(counts[k] > 0 for k in SAMPLED_POOLED)
          and "sa" not in idx
          and idx["sa_samp"].numel() == -(-(fmi.n + 1) // SA_INTV))
    for i, (rows, intv) in enumerate(captured):
        eq = same_bits(sl.sa_lookup(idx, rows, intv),
                       sl.sa_lookup_plain(idx, rows, intv))
        ok &= eq
        log(f"[4] captured sa_lookup#{i} ({rows.numel()} rows): "
            f"{'bit-equal' if eq else 'MISMATCH'}")
    ok &= bool(captured)
    prof = out["sampled_profile"] = profile_block(bm, reads)
    log("[4] sampled SA profile: " + json.dumps(prof))
    ent = out["kernels"].get("sa_lookup")
    if ent is not None:
        ent["launches"] = counts["sa_lookup"]
        # the walk inside the step, beside its time alone on seeded rows
        n_step = prof["sa_lookup_launches_per_step"]
        ent["in_step_ms"] = (prof["sa_lookup_ms_per_step"] / n_step
                             if n_step else None)
        log(f"[4] sa_lookup in the profiled step: {n_step} launches a step, "
            f"{ent['in_step_ms']} ms a launch (profiler), against "
            f"{ent['ms']:.5f} alone warm (profiler), "
            f"{ent.get('warm_queued_ms')} warm and {ent.get('cold_ms')} "
            "after an L2 flush (CUDA events)")
    return ok


def phase_classic(out):
    """The classic engine at the conf defaults on phase 4's genome and
    reads."""
    import torch

    import uncalled_tpu_torch.mapping.engine as engine
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import mxu_gather as mg
    from uncalled_tpu_torch.ops import tracker_kernel as tk
    from uncalled_tpu_torch.poremodel import load_default

    fmi, th, sim = real_assets()
    model = load_default()
    conf = _conf(64, SPR, 64, pooled=False)
    bm = BatchMapper(fmi, model, th, conf)
    p = bm.eng.params
    log(f"[5] shapes B={p.B} P={p.P} C={p.C} CE={p.CE or 'auto'} R={p.R} "
        f"CL={p.CL} T={bm.T} ladder {conf.engine.remap_ladder}")

    # capture live kernel inputs during the warm-up run
    captured = {"row_gather": [], "row_gather_cols": [],
                "shared_gather": [], "tracker_fold_rows": []}
    orig = (engine.row_gather, engine.row_gather_cols,
            engine.shared_gather, tk.tracker_run)

    def hold(name, n, args):
        if len(captured[name]) < n:
            captured[name].append(tuple(keep(a) for a in args))

    def cap_rg(tbl, idx):
        hold("row_gather", 4, (tbl, idx))
        return orig[0](tbl, idx)

    def cap_rgc(cols, idx, lens=None):
        hold("row_gather_cols", 8, (cols, idx, lens))
        return orig[1](cols, idx, lens)

    def cap_sg(tbl, idx):
        hold("shared_gather", 2, (tbl, idx))
        return orig[2](tbl, idx)

    def cap_tracker(*a):
        if len(captured["tracker_fold_rows"]) < 3 and int(a[6].sum()) > 0:
            captured["tracker_fold_rows"].append(
                (a[0], {k: v.clone() for k, v in a[1].items()},
                 *[x.clone() for x in a[2:]]))
        return orig[3](*a)

    engine.row_gather, engine.row_gather_cols = cap_rg, cap_rgc
    engine.shared_gather, tk.tracker_run = cap_sg, cap_tracker
    warm = [_Read(r.id, r.signal) for r in sim[:8]]
    t0 = time.time()
    n_warm = sum(1 for _ in bm.map_reads(warm))
    log(f"[5] warm-up: {n_warm} reads in {time.time() - t0:.2f} s")
    (engine.row_gather, engine.row_gather_cols, engine.shared_gather,
     tk.tracker_run) = orig

    ok = True
    pairs = {
        "row_gather": (mg.row_gather, mg.row_gather_plain),
        "row_gather_cols": (mg.row_gather_cols, mg.row_gather_cols_plain),
        "shared_gather": (mg.shared_gather, mg.shared_gather_plain),
        "tracker_fold_rows": (tk.tracker_run, tk.tracker_run_plain),
    }
    for name, calls in captured.items():
        fn, plain = pairs[name]
        for i, a in enumerate(calls):
            got, want = fn(*a), plain(*a)
            torch.cuda.synchronize()
            eq = same_bits(got, want)
            ok &= eq
            log(f"[5] captured {name}#{i}: "
                f"{'bit-equal' if eq else 'MISMATCH'}")
        ok &= bool(calls)
    # the step's threshold-and-prob table as two segment tables
    ok &= any(isinstance(a[0], list) for a in captured["row_gather"])
    # the expanded fold on the live step's rows, the longest read
    if captured["tracker_fold_rows"]:
        def longest(a):
            return int(a[6].clamp(max=a[2].shape[1]).max())

        a = max(captured["tracker_fold_rows"], key=longest)
        out["classic_fold"] = live_fold_time(
            "tracker_fold_rows", lambda: tk.tracker_run(*a), longest(a),
            int(a[5].sum()), tuple(a[1]["cl_valid"].shape))

    # the timed run
    truth = {r.id: (r.ref_name, r.ref_start, r.ref_end, r.fwd) for r in sim}
    timed = [_Read(r.id, r.signal) for r in sim[8: 8 + N_CLASSIC]]
    bm2 = BatchMapper(fmi, model, th, conf, engine=bm.eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    t0 = time.time()
    pafs = list(bm2.map_reads(timed))
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = wrapper_counts()
    rungs = _rungs(bm2)
    steps = sum(r["steps"] for r in rungs)
    n_mapped = sum(1 for pf in pafs if pf.is_mapped)
    n_correct = sum(
        1 for pf in pafs if pf.is_mapped and pf.rf_name == truth[pf.rd_name][0]
        and truth[pf.rd_name][1] - 500 <= pf.rf_st <= truth[pf.rd_name][2] + 500
        and pf.fwd == truth[pf.rd_name][3]
    )
    lines_ok = all(len(pf.to_line().split("\t")) >= 12 for pf in pafs)
    real = dict(
        reads=len(timed), yielded=len(pafs), seconds=dt,
        reads_per_s=len(timed) / dt, steps=steps,
        ms_per_step=dt * 1e3 / max(steps, 1),
        mapped_frac=n_mapped / len(timed), correct_frac=n_correct / len(timed),
        correct_of_mapped=n_correct / max(n_mapped, 1),
        rungs=rungs,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=counts,
        launches_per_step={k: v / max(steps, 1) for k, v in counts.items()},
        useful_frac=bm2.useful_events / max(bm2.disp_events, 1),
    )
    out["classic"] = real
    log("[5] classic: " + json.dumps(real))
    log("[5] tracker fold forms: " + json.dumps(fold_forms(counts)))
    # one profiled block on the rung that ran the most event steps, every
    # slot live (the first B of phase 4's timed reads)
    out["classic_profile"] = {}
    m = max(bm2.tiers(), key=lambda m: m.disp_events // m.eng.params.B)
    prof = profile_block(m, [_Read(r.id, r.signal) for r in
                             sim[8: 8 + m.eng.params.B]])
    out["classic_profile"][f"rung {m._rung}"] = prof
    log(f"[5] profile rung {m._rung} (B={m.eng.params.B}, "
        f"P={m.eng.params.P}), the most steps: " + json.dumps(prof))
    ok &= lines_ok and len(pafs) == len(timed) and n_mapped > 0
    ok &= all(counts[k] > 0 for k in CLASSIC_KERNELS)
    for k in CLASSIC_KERNELS:
        if k in out["kernels"]:
            out["kernels"][k]["launches"] = counts[k]
    return ok


def phase_defaults(out):
    """The pooled path at the conf defaults (slot handoff, drain chain,
    bitonic candidate sort) on phase 4's genome and reads at B=256, T=32;
    every timed read's PAF line must equal phase 4's."""
    import torch

    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import sortkern as sk
    from uncalled_tpu_torch.poremodel import load_default

    lines4 = out.get("real_lines")
    if not lines4:
        log("[6] needs phase 4's lines (run phases 4 and 6 together)")
        return False
    fmi, th, sim = real_assets()
    model = load_default()
    conf = Conf()
    conf.engine.batch_reads = B_FULL
    conf.engine.pool_slots_per_read = SPR
    conf.engine.evt_block = 32
    bm = BatchMapper(fmi, model, th, conf)
    p = bm.eng.params
    log(f"[6] shapes B={p.B} S={p.S} SC={p.SC} CL={p.CL} T={bm.T} "
        f"handoff={p.handoff} sort_mode={p.sort_mode} drain_shrink="
        f"{conf.engine.drain_shrink}")
    ok = p.handoff and p.sort_mode == "bitonic" and conf.engine.drain_shrink
    warm = [_Read(r.id, r.signal) for r in sim[:8]]
    t0 = time.time()
    n_warm = sum(1 for _ in bm.map_reads(warm))
    log(f"[6] warm-up: {n_warm} reads in {time.time() - t0:.2f} s")

    # the timed run; the first full-width sort's inputs are captured: the
    # run sort's keys and each merge level's buffer
    truth = {r.id: (r.ref_name, r.ref_start, r.ref_end, r.fwd) for r in sim}
    timed = [_Read(r.id, r.signal) for r in sim[8: 8 + N_DEFAULTS]]
    bm2 = BatchMapper(fmi, model, th, conf, engine=bm.eng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_counts()
    t0 = time.time()
    with capture_pooled(dict(sort_runs=1, merge_level=4),
                        NP=131072) as captured:
        pafs = list(bm2.map_reads(timed))
        torch.cuda.synchronize()
    dt = time.time() - t0
    counts = wrapper_counts()
    chain = _chain(bm2)
    steps = sum(m.disp_events // m.eng.params.B for m in chain)
    disp = sum(m.disp_events for m in chain)
    useful = sum(m.useful_events for m in chain)
    n_mapped = sum(1 for pf in pafs if pf.is_mapped)
    n_correct = sum(
        1 for pf in pafs if pf.is_mapped and pf.rf_name == truth[pf.rd_name][0]
        and truth[pf.rd_name][1] - 500 <= pf.rf_st <= truth[pf.rd_name][2] + 500
        and pf.fwd == truth[pf.rd_name][3]
    )
    differ = [pf.rd_name for pf in pafs
              if lines4.get(pf.rd_name) != pf.to_line()]
    real = dict(
        reads=len(timed), yielded=len(pafs),
        lines_equal_phase4=len(pafs) - len(differ), seconds=dt,
        reads_per_s=len(timed) / dt, steps=steps,
        steps_entry=bm2.disp_events // B_FULL,
        ms_per_step=dt * 1e3 / max(steps, 1),
        mapped_frac=n_mapped / len(timed), correct_frac=n_correct / len(timed),
        slot_utilisation=useful / max(disp, 1),
        n_handoff=sum(m.n_handoff for m in chain),
        n_migrate=sum(m.n_migrate for m in chain),
        t_migrate=sum(m.t_migrate for m in chain),
        t_refill=sum(m.t_refill for m in chain),
        drain_widths=_drains(bm2),
        mappers=[dict(B=m.eng.params.B, T=m.T, pool_tier=m._pool_tier,
                      steps=m.disp_events // m.eng.params.B,
                      useful_frac=m.useful_events / max(m.disp_events, 1),
                      n_handoff=m.n_handoff, harvested=len(m.demand))
                 for m in chain],
        ejects_per_tier=[m.n_ejected for m in bm2.tiers()],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=counts,
        launches_per_step={k: v / max(steps, 1) for k, v in counts.items()},
        pool_hw=[int(x) for x in bm2.pool_hw],
    )
    out["defaults"] = real
    log("[6] defaults: " + json.dumps(real))
    log("[6] tracker fold forms: " + json.dumps(fold_forms(counts)))
    for r in differ[:5]:
        log(f"[6]   {r}: {lines4.get(r)!r} (phase 4) vs this run's line")
    ok &= recheck_captured(captured, 6)
    levels = (131072 // min(sk.RUN_TILE, 131072)).bit_length() - 1
    ok &= len(captured["merge_level"]) == min(levels, 4)
    out["defaults_profile"] = profile_block(bm2, timed)
    log("[6] profile: " + json.dumps(out["defaults_profile"]))
    ok &= (len(pafs) == len(timed) and not differ and n_mapped > 0
           and real["n_handoff"] > 0)
    ok &= all(counts[k] > 0 for k in DEFAULT_KERNELS)
    for k in ("sort_runs", "merge_level"):
        if k in out["kernels"]:
            out["kernels"][k]["launches"] = counts[k]
    return ok


# ---------------------------------------------------------------------------
# the realtime layer and the device event detector (phases 2, 3 and 7)
# ---------------------------------------------------------------------------

_WALL_TAGS = re.compile(r"\t(mt|qt|wt):f:[^\t]*")


def strip_wall(line: str) -> str:
    """A PAF line without its wall-clock timing tags (mt, qt, wt)."""
    return _WALL_TAGS.sub("", line)


def example_assets():
    """The example index, the pore model, the thresholds and the index
    prefix (tests/fixtures)."""
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    prefix = os.path.join(REPO, "tests", "fixtures", "example_index",
                          "example_ref")
    return (load_bwa_index(prefix), load_default(),
            load_uncl(prefix + ".uncl"), prefix)


def golden_signals():
    fx = os.path.join(REPO, "tests", "fixtures")
    with open(os.path.join(fx, "golden_pafs.json")) as f:
        golden = json.load(f)
    return golden, np.load(os.path.join(fx, "golden_reads.npz"))


def rt_map_ordered(device):
    """tests/test_realtime.py's chunk-ordered replay case: PAF lines in
    completion order, timing tags stripped."""
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping.ordered import map_ordered
    from uncalled_tpu_torch.testing.simulate import simulate_reads

    fmi, model, th, prefix = example_assets()
    reads = simulate_reads(prefix + ".fa", 4, seed=31,
                           read_len_bp=(900, 1600))
    for i, r in enumerate(reads):
        r.channel = (i % 2) + 1
        r.start_sample = 10000 * (i // 2) + 1
    conf = Conf()
    conf.engine.evt_block = 64
    return [strip_wall(p.to_line()) for p in map_ordered(
        fmi, model, th, reads, conf, P=1024, C=1024, R=64, CL=256,
        device=device)]


def rt_sim(device):
    """tests/test_realtime.py's deplete sim case (4 channels, 6 reads that
    cycle, 0.2 s ticks on a SimClock), cut to SIM3_SECS simulated seconds:
    every output line (timing tags stripped) and the give-up records."""
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.realtime.clientsim import ClientSim
    from uncalled_tpu_torch.realtime.mapper import RealtimeMapper
    from uncalled_tpu_torch.realtime.sim import (SimClock, default_pattern,
                                                 run_sim_loop)
    from uncalled_tpu_torch.testing.simulate import simulate_reads

    fmi, model, th, prefix = example_assets()
    reads = simulate_reads(prefix + ".fa", 6, seed=21,
                           read_len_bp=(800, 1500))
    for i, r in enumerate(reads):
        r.number = i + 1
    conf = Conf()
    conf.reads.num_channels = 4
    conf.engine.evt_block = 64
    conf.simulator.sim_speed = 1.0
    clock = SimClock()
    client = ClientSim(conf, clock=clock)
    default_pattern(client, reads,
                    duration_samples=sum(r.raw_len for r in reads) * 3,
                    gap=2000)
    client.load_reads(reads)
    rt = RealtimeMapper(fmi, model, th, conf, P=1024, C=1024, R=64, CL=256,
                        device=device)
    buf = io.StringIO()
    run_sim_loop(client, rt, conf, deplete=True, out=buf, sleep=0.2,
                 clock=clock, max_wall=SIM3_SECS)
    return ([strip_wall(x) for x in buf.getvalue().splitlines()],
            [list(g) for g in rt.giveups])


def rt_dsp_golden(device):
    """BatchMapper with conf.engine.device_dsp on the 13 golden reads that
    decide (pooled, B=4): read id -> PAF line."""
    from uncalled_tpu_torch.mapping.batch import BatchMapper

    fmi, model, th, _ = example_assets()
    golden, sigs = golden_signals()
    conf = _conf(4, 512, 64)
    conf.engine.device_dsp = True
    bm = BatchMapper(fmi, model, th, conf, device=device)
    reads = [_Read(r, sigs[r]) for r in golden if r != "noise_1"]
    return {p.rd_name: p.to_line() for p in bm.map_reads(reads)}


DUMP_RID = "sim_0000_Escherichia_coli_3854_+"
# noise_1 cut to its first NOISE_CUT samples (a few hundred events): the
# pooled engine's run of a read that never decides to the end of its signal
NOISE_CUT = 2000


def noise_pooled(device):
    """Phase 3's pooled golden mapper (B=4, flat sort) on noise_1 cut to
    NOISE_CUT samples: its PAF lines."""
    from uncalled_tpu_torch.mapping.batch import BatchMapper

    fmi, model, th, _ = example_assets()
    _, sigs = golden_signals()
    bm = BatchMapper(fmi, model, th, _conf(4, 512, 64), sort_mode="flat",
                     device=device)
    return [p.to_line() for p in bm.map_reads(
        [_Read("noise_1", sigs["noise_1"][:NOISE_CUT])])]


def rt_dump(device):
    """dump_read of one golden read (conf defaults at B=1, the wide classic
    engine for the dump), its first DUMP_EVENTS events: the PAF line, the
    seed rows and the bytes of the three files."""
    import tempfile

    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.debug import dump_read
    from uncalled_tpu_torch.mapping.batch import BatchMapper

    fmi, model, th, _ = example_assets()
    _, sigs = golden_signals()
    conf = Conf()
    conf.engine.batch_reads = 1
    bm = BatchMapper(fmi, model, th, conf, device=device)
    with tempfile.TemporaryDirectory(dir=os.path.join(
            REPO, "uncalled_tpu_torch", "_build")) as tmp:
        paf, n_rows = dump_read(bm, _Read(DUMP_RID, sigs[DUMP_RID]),
                                os.path.join(tmp, "d_"),
                                max_events=DUMP_EVENTS)
        files = {}
        for suffix in ("_events.tsv", "_seeds.bed", "_paths.tsv"):
            with open(os.path.join(tmp, f"d_{DUMP_RID}{suffix}"), "rb") as f:
                files[suffix] = f.read()
    return paf.to_line(), n_rows, files


def golden_rows():
    """The 14 golden reads as detector rows, zero-padded to a whole number
    of 4096-sample blocks: (names, [14, L] f32)."""
    _, sigs = golden_signals()
    names = list(sigs.files)
    L = max(len(sigs[r]) for r in names)
    L = -(-L // 4096) * 4096
    rows = np.zeros((len(names), L), np.float32)
    for i, r in enumerate(names):
        rows[i, : len(sigs[r])] = sigs[r]
    return names, rows


def detect_golden_plain():
    """The plain detector over the golden rows in 4096-sample blocks on the
    CPU: every block's outputs, concatenated, and the state after each
    block (numpy)."""
    import torch

    from uncalled_tpu_torch.ops import events as ev

    _, rows = golden_rows()
    st = ev.make_detector_state(rows.shape[0])
    outs, states = {k: [] for k in ev.OUT_KEYS}, []
    for b in range(rows.shape[1] // 4096):
        st, o = ev.detect_block_plain(
            st, torch.from_numpy(rows[:, b * 4096: (b + 1) * 4096]))
        for k in ev.OUT_KEYS:
            outs[k].append(o[k].numpy())
        states.append({k: v.numpy() for k, v in st.items()})
    return {k: np.concatenate(v, 1) for k, v in outs.items()}, states


def oracle_golden():
    """The port's oracle (``mapping/oracle.py``, host numpy, no card) on
    the 14 golden reads of the example index: each line and its seconds."""
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping.oracle import OracleMapper

    fmi, model, th, _ = example_assets()
    golden, sigs = golden_signals()
    m = OracleMapper(fmi, model, th, Conf())
    lines, secs = {}, {}
    for rid in golden:
        t0 = time.time()
        lines[rid] = m.map_read(_Read(rid, sigs[rid])).to_line()
        secs[rid] = time.time() - t0
    return dict(lines=lines, seconds=secs)


# the CPU references the card's checks are held to, in the order the
# phases need them
CPU_REFS = (("detect_golden", detect_golden_plain),
            ("noise_pooled", lambda: noise_pooled("cpu")),
            ("dump_read", lambda: rt_dump("cpu")),
            ("map_ordered", lambda: rt_map_ordered("cpu")),
            ("dsp_golden", lambda: rt_dsp_golden("cpu")),
            ("sim", lambda: rt_sim("cpu")),
            ("oracle_golden", oracle_golden),
            ("cli", lambda: cli_small("cpu")))


def run_jobs(path, jobs, threads):
    """A worker process's loop: each (name, fn) of ``jobs`` in turn, one
    pickle per result as it finishes (its error, if it raised)."""
    import pickle
    import traceback

    import torch

    torch.set_num_threads(threads)
    for name, fn in jobs:
        t0 = time.time()
        try:
            res = dict(ok=True, value=fn())
        except Exception:  # noqa: BLE001 - reported to the main process
            res = dict(ok=False, error=traceback.format_exc())
        res["seconds"] = time.time() - t0
        with open(f"{path}.{name}.tmp", "wb") as f:
            pickle.dump(res, f)
        os.replace(f"{path}.{name}.tmp", f"{path}.{name}.pkl")
    return 0


def cpu_refs_worker(path):
    """The worker process: compute CPU_REFS on the CPU with the port's own
    code (device="cpu")."""
    return run_jobs(path, CPU_REFS, 2)


class HostWorker:
    """A process of this script with ``argv`` (no card: CUDA_VISIBLE_DEVICES
    is empty there) that computes the results ``names``, each fetched by
    ``get`` once its pickle is on disk."""

    def __init__(self, tag, names, argv, env=()):
        from uncalled_tpu_torch import native
        from uncalled_tpu_torch.ops._cuda import BUILD_DIR

        native.available()  # build the host library before the worker runs
        os.makedirs(BUILD_DIR, exist_ok=True)
        self.path = os.path.join(BUILD_DIR, tag)
        for name in names:
            if os.path.exists(f"{self.path}.{name}.pkl"):
                os.remove(f"{self.path}.{name}.pkl")
        self.log = open(self.path + ".log", "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), *argv, self.path],
            stdout=self.log, stderr=subprocess.STDOUT,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **dict(env)),
            cwd=REPO)
        self.t0 = time.time()

    def get(self, name, timeout=1500.0, tag="cpu"):
        import pickle

        f = f"{self.path}.{name}.pkl"
        t0 = time.time()
        while not os.path.exists(f):
            if self.proc.poll() is not None and not os.path.exists(f):
                raise RuntimeError(f"the host worker {self.path} ended (rc "
                                   f"{self.proc.returncode}) without {name}")
            if time.time() - t0 > timeout:
                raise RuntimeError(f"no result {name} in {timeout:.0f} s")
            time.sleep(0.5)
        with open(f, "rb") as fh:
            res = pickle.load(fh)
        log(f"[{tag}] reference {name}: {res['seconds']:.1f} s on the CPU, "
            f"waited {time.time() - t0:.1f} s")
        if not res["ok"]:
            raise RuntimeError(f"host reference {name} failed:\n"
                               + res["error"])
        return res["value"]

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.log.close()


# ---------------------------------------------------------------------------
# the reference rig's lines on phase 4's genome: the 7 tie reads
# (tests/fixtures/tie_reads.npz, from bench.py's read set on the same
# genome), mapped by the reference binary built with a stable candidate
# sort (tie_pafs.json) and with libstdc++'s std::sort (tie_pafs_stdsort.json)

TIE_FAST = ("sim_0545_bench_ref_4295489_+", "sim_0731_bench_ref_302488_+")
TIE_SLOW = ("sim_0214_bench_ref_4050919_-", "sim_0364_bench_ref_3184616_-",
            "sim_0631_bench_ref_1571287_+", "sim_0661_bench_ref_4308092_-",
            "sim_0715_bench_ref_1685755_+")
TIE_IN_PHASE4 = {214: "sim_0214_bench_ref_4050919_-",
                 364: "sim_0364_bench_ref_3184616_-"}  # sim[i] of build_assets
TIE_FILES = {"stable": "tie_pafs.json", "introsort": "tie_pafs_stdsort.json"}
TIE_DEADLINE_S = 1150  # seconds since the start: phase 10 waits no longer


def tie_fixtures():
    """The 7 tie signals (f32) and the reference rig's lines, by tie
    order."""
    fx = os.path.join(REPO, "tests", "fixtures")
    d = np.load(os.path.join(fx, "tie_reads.npz"))
    sigs = {rid: np.asarray(d[rid], np.float32) for rid in TIE_FAST + TIE_SLOW}
    want = {}
    for order, fn in TIE_FILES.items():
        with open(os.path.join(fx, fn)) as f:
            want[order] = json.load(f)
    return sigs, want


def tie_oracle_worker(path, order, prefix):
    """The worker process of one tie order: the port's oracle on the 7 tie
    reads over phase 4's genome (the index built here, in memory, from the
    .fa phase 4 wrote; its .uncl), one pickle a read: line, seconds,
    events."""
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.index.build import build_index
    from uncalled_tpu_torch.mapping.oracle import OracleMapper, load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    os.nice(10)  # the card's phases run beside it: the main process first
    t0 = time.time()
    fmi = build_index(prefix + ".fa")
    m = OracleMapper(fmi, load_default(), load_uncl(prefix + ".uncl"),
                     Conf(), tie_order=order)
    print(f"index n={fmi.n} in {time.time() - t0:.1f} s", flush=True)
    sigs, _ = tie_fixtures()

    def job(rid):
        def run():
            t1 = time.time()
            line = m.map_read(_Read(rid, sigs[rid])).to_line()
            return dict(line=line, events=m.n_events_mapped,
                        seconds=time.time() - t1)
        return rid, run

    return run_jobs(path, [job(r) for r in TIE_FAST + TIE_SLOW], 1)


class TieOracles:
    """Two host workers, one a tie order, each one process of one torch
    thread; started once phase 4's assets are on disk."""

    def __init__(self):
        self.workers = {}

    def start(self):
        for order in TIE_FILES:
            self.workers[order] = HostWorker(
                f"tie_{order}", TIE_FAST + TIE_SLOW,
                ["--tie-oracle", order, assets_prefix()],
                env=dict(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
                         MKL_NUM_THREADS="1"))
        self.t0 = time.time()
        log("[4] tie-read oracle workers started (stable, introsort)")

    def stop(self):
        for w in self.workers.values():
            w.stop()


def phase_oracle_golden(out, refs):
    """Phase 3's host reference: the port's oracle on the 14 golden reads
    (computed by the CPU worker), every line the golden one; and the
    FM-range arithmetic of ``ranges.py`` on tensors on the card, equal to
    its numpy results."""
    import torch

    from uncalled_tpu_torch import ranges

    golden, _ = golden_signals()
    res = refs.get("oracle_golden")
    got, secs = res["lines"], res["seconds"]
    eq = {rid: got.get(rid) == line for rid, line in golden.items()}
    for rid in golden:
        if not eq[rid]:
            log(f"[3] oracle {rid}: {got.get(rid)!r}, golden {golden[rid]!r}")
    log(f"[3] the port's oracle (host, example index): {sum(eq.values())}/"
        f"{len(eq)} lines byte-identical to golden_pafs.json; "
        f"{sum(secs.values()):.1f} s on the CPU, {max(secs.values()):.2f} s "
        f"the longest read ({max(secs, key=secs.get)})")

    rng = np.random.default_rng(7)
    st = rng.integers(0, 50, (2, 1 << 16))
    en = st + rng.integers(-3, 30, (2, 1 << 16))
    a = (st[0], en[0], st[1], en[1])

    def flat(r):
        return [y for x in r for y in flat(x)] if isinstance(r, tuple) \
            else [r]

    r_ok = True
    for op in ("intersects", "intersect", "merge", "recp_overlap", "split"):
        want = flat(getattr(ranges, op)(*a))
        got_t = flat(getattr(ranges, op)(*[torch.from_numpy(x).cuda()
                                           for x in a]))
        for g, w in zip(got_t, want):
            g_np = g.cpu().numpy()
            r_ok &= (g.device.type == "cuda" and g_np.dtype == w.dtype
                     and np.array_equal(g_np, w))
    log(f"[3] ranges on the card (65536 pairs): "
        f"{'equal to' if r_ok else 'DIFFER from'} the numpy results")
    out["oracle_golden"] = dict(equal=eq, seconds=secs, ranges_on_card=r_ok)
    return all(eq.values()) and len(got) == len(golden) and r_ok


def phase_tie_oracle(out, ties):
    """Phase 10: the port's oracle on the 7 tie reads over phase 4's genome
    in both tie orders, from the two host workers started once the assets
    were on disk: stable lines equal tie_pafs.json and introsort lines
    tie_pafs_stdsort.json (mt stripped)."""
    real_assets()  # starts the workers, unless phase 4's assets exist
    _, want = tie_fixtures()
    ok = True
    res = out["tie_oracle"] = {}
    for order, w in ties.workers.items():
        res[order] = {}
        for rid in TIE_FAST + TIE_SLOW:
            left = TIE_DEADLINE_S - (time.time() - _T0)
            try:
                r = w.get(rid, timeout=max(left, 10.0), tag="10")
            except RuntimeError as e:
                log(f"[10] {order} {rid}: {e}")
                res[order][rid] = dict(error=str(e))
                ok = False
                continue
            sec = r["seconds"]
            eq = strip_wall(r["line"]) == strip_wall(want[order][rid])
            res[order][rid] = dict(equal=eq, seconds=sec, events=r["events"])
            log(f"[10] oracle {order} {rid}: "
                f"{'equal to' if eq else 'DIFFERS from'} {TIE_FILES[order]}"
                f" ({r['events']} events, {sec:.1f} s on the CPU)"
                + ("" if eq else f": {r['line']!r} against "
                   f"{want[order][rid]!r}"))
            ok &= eq
    cpu = {o: sum(v.get("seconds", 0.0) for v in r.values())
           for o, r in res.items()}
    log(f"[10] tie-read oracle: workers started at {ties.t0 - _T0:.1f} s, "
        f"every result in by {time.time() - _T0:.1f} s; CPU seconds "
        + json.dumps(cpu))
    out["tie_oracle_window"] = (ties.t0 - _T0, time.time() - _T0)
    return ok


def detect_signals(rng, B, n):
    """Seeded signal in pA: k-mer levels ~ N(90, 12) held for a geometric
    number of samples (mean 9), plus N(0, 1.5) noise, clipped to
    [40, 140], f32."""
    seg = np.minimum(np.cumsum(rng.random((B, n)) < 1 / 9, axis=1), n - 1)
    lv = rng.normal(90.0, 12.0, (B, n))
    x = np.take_along_axis(lv, seg, 1) + rng.normal(0.0, 1.5, (B, n))
    return np.clip(x, 40.0, 140.0).astype(np.float32)


def scan_step_ns(dev, steps=(20000, 60000)):
    """Nanoseconds of one step of the detector's scan on one thread, at two
    chain lengths, so the launch cancels out of the difference.  It is the
    latency of this implementation's step, not a floor of the hardware."""
    import torch

    from uncalled_tpu_torch.ops import _cuda

    res = torch.empty(1, dtype=torch.float64, device=dev)
    # CUDA events: the difference of two single-thread chains cancels the
    # launch (the profiler lost these one-block launches in a run)
    ms = [time_ms(lambda k=k: _cuda.launch("probe_detect_chain", k, res),
                  reps=10)
          for k in steps]
    return (ms[1] - ms[0]) * 1e6 / (steps[1] - steps[0])


def phase_detect(out, rate, dev, refs):
    """The device event detector against its plain version, bit for bit:
    seeded pA signal at B=512, S=4096 over three carried blocks with some
    rows reset mid-stream (the plain version on the card), and the 14
    golden reads (the real read among them) as rows at S=4096 and S=512
    (against the plain version's blocks of 4096 from the CPU worker:
    outputs do not depend on the block size), and a zero-padded block
    (reads of random lengths padded to S, as a refill wave's last block);
    its device ms on the seeded and the padded block, the repair rounds of
    its scan, its bound (max of bytes and f64 operations) and the old
    design's serial floor (a probe of one sample's serial step)."""
    import torch

    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import events as ev

    ok = True
    rng = np.random.default_rng(20261017)
    B, S, NB = DET_B, DET_S, DET_NB
    sig = detect_signals(rng, B, S * NB)
    # a constant row and a constant stretch: NaN t-stats (0 / 0) and a
    # flushed subnormal in the t-stat windows
    sig[0] = 77.0
    sig[1, S - 1000: S + 1000] = 91.25
    exact = all(ev.prefix_sums_exact(r) for r in sig)
    log(f"[2] detect: seeded B={B} S={S} x {NB} blocks, prefix sums exact "
        f"on every row: {exact}")
    ok &= exact
    sig_d = torch.from_numpy(sig).to(dev)
    reset = torch.from_numpy(np.arange(B) % 7 == 3).to(dev)
    sk, sp = ev.make_detector_state(B, dev), ev.make_detector_state(B, dev)
    st0 = sk
    fired = 0
    for b in range(NB):
        if b == 1:  # every 7th row starts a new read mid-stream
            sk = ev.reset_detector_rows(sk, reset)
            sp = ev.reset_detector_rows(sp, reset)
        blk = sig_d[:, b * S: (b + 1) * S].contiguous()
        sk, ko = ev.detect_block(sk, blk)
        sp, po = ev.detect_block_plain(sp, blk)
        ok &= check(f"detect[seeded B={B} S={S} block {b}: outputs]", ko, po)
        ok &= check(f"detect[seeded B={B} S={S} block {b}: state]", sk, sp)
        fired += int(ko["fired"].sum())
    log(f"[2] detect: {fired} events over the seeded blocks")
    # other block sizes: the smallest JAX takes (2 * TAIL) and sizes that
    # end inside a 512-sample chunk
    for Sx in (2 * ev.TAIL, 1000, 1537):
        sx = torch.from_numpy(detect_signals(rng, 64, 2 * Sx)).to(dev)
        sk2 = ev.make_detector_state(64, dev)
        sp2 = ev.make_detector_state(64, dev)
        for b in range(2):
            blk = sx[:, b * Sx: (b + 1) * Sx].contiguous()
            sk2, ko = ev.detect_block(sk2, blk)
            sp2, po = ev.detect_block_plain(sp2, blk)
            ok &= check(f"detect[seeded B=64 S={Sx} block {b}]",
                        (ko, sk2), (po, sp2))

    names, rows = golden_rows()
    exact = all(ev.prefix_sums_exact(r) for r in rows)
    ok &= exact
    want_out, want_states = refs.get("detect_golden")
    rows_d = torch.from_numpy(rows).to(dev)
    for Sg in (4096, 512):
        st = ev.make_detector_state(len(names), dev)
        outs = {k: [] for k in ev.OUT_KEYS}
        st_ok = True
        for b in range(rows.shape[1] // Sg):
            st, o = ev.detect_block(
                st, rows_d[:, b * Sg: (b + 1) * Sg].contiguous())
            for k in ev.OUT_KEYS:
                outs[k].append(o[k])
            if ((b + 1) * Sg) % 4096 == 0:
                want = want_states[(b + 1) * Sg // 4096 - 1]
                st_ok &= all(same_bits(st[k].cpu(), torch.from_numpy(want[k]))
                             for k in ev.STATE_KEYS)
        got = {k: torch.cat(v, 1).cpu() for k, v in outs.items()}
        out_ok = all(same_bits(got[k], torch.from_numpy(want_out[k]))
                     for k in ev.OUT_KEYS)
        real = names.index("f41a60f7-de4a-4b17-9f54-387e52d60b65")
        real_ok = all(same_bits(got[k][real], torch.from_numpy(
            want_out[k][real])) for k in ev.OUT_KEYS)
        log(f"[2] detect[14 golden rows S={Sg}, {rows.shape[1]} samples; "
            f"prefix sums exact {exact}]: outputs "
            f"{'bit-equal' if out_ok else 'MISMATCH'}, state every 4096 "
            f"samples {'bit-equal' if st_ok else 'MISMATCH'}, the real read "
            f"{'bit-equal' if real_ok else 'MISMATCH'}")
        ok &= out_ok and st_ok and real_ok

    # the t-stats' divisions by the window widths (three operations each,
    # csrc/detect.cu ddiv_w / fdiv_w) against the division instructions:
    # every f32 input and 2^30 hashed f64 inputs, at w = 3 and 6
    chk = torch.zeros(3, dtype=torch.int64, device=dev)
    _cuda.launch("probe_div_check", 1 << 30, chk)
    bad32, bad64, fast64 = chk.tolist()
    log(f"[2] detect: width divisions against div.rn: {bad32} of 2^33 f32 "
        f"and {bad64} of 2^31 f64 quotients differ ({fast64} f64 inputs on "
        "the three-operation path)")
    ok &= bad32 == 0 and bad64 == 0 and fast64 > 0

    # a refill wave's last block: reads of random lengths zero-padded to
    # the block (BatchMapper._prepare_wave), NaN t-stats over each tail
    prng = np.random.default_rng(20261019)
    pad = detect_signals(prng, B, S)
    lens = prng.integers(S // 8, S, B)
    lens[:: 8] = S
    pad[np.arange(S)[None, :] >= lens[:, None]] = 0.0
    pad_d = torch.from_numpy(pad).to(dev)
    stp = ev.make_detector_state(B, dev)
    ok &= check(f"detect[zero-padded B={B} S={S}, rows of "
                f"{int(lens.min())}-{S} samples]",
                ev.detect_block(stp, pad_d), ev.detect_block_plain(stp, pad_d))

    # time, repair rounds and bounds at the headline shape (block 0 of the
    # seeded signal), the zero-padded block beside it
    blk0 = sig_d[:, :S].contiguous()
    rounds = {}
    for name, st_, x in (("seeded", st0, blk0), ("padded", stp, pad_d)):
        r = torch.zeros(B, dtype=torch.int32, device=dev)
        ev.detect_block(st_, x, rounds=r)
        r = r.cpu().numpy()
        rounds[name] = dict(max=int(r.max()), mean=float(r.mean()),
                            hist=np.bincount(r).tolist())
    log("[2] detect: repair rounds a row " + json.dumps(rounds))
    src = []
    ms, pad_ms = device_ms([(lambda: ev.detect_block(st0, blk0), 20),
                            (lambda: ev.detect_block(stp, pad_d), 20)],
                           tag="detect", sources=src)
    call_ms = time_ms(lambda: ev.detect_block(st0, blk0))
    plain_ms = time_ms(lambda: ev.detect_block_plain(st0, blk0), reps=1,
                       warm=0)
    state_bytes = sum(v.element_size() * v.numel() for v in st0.values())
    nbytes = B * S * (4 + 1 + 4 + 4 + 4 + 4) + 2 * state_bytes
    byte_ms = nbytes / rate * 1e3
    # the f64 operations of the function, each one (divides and square
    # roots included): a sample's two prefix sums and the carry added to
    # each (4), each window's t-stat (4 window sums, 2 divides, 3 adds,
    # a square root and a divide: 11, twice), its event's mean (2 subtracts
    # and a divide: 3); at the H100 SXM's FP64 vector peak (data sheet)
    ops = B * S * DET_F64_OPS
    op_ms = ops / (DET_F64_PEAK_TFLOPS * 1e12) * 1e3
    # the old design's floor: S steps of a serial scan, one step probed
    # (the function asks for no such chain; an informative field)
    scan_ns = scan_step_ns(dev)
    serial_ms = S * scan_ns * 1e-6
    out["kernels"]["detect"] = dict(
        KERNELS["detect"], launches=0, max_abs_err=0.0 if ok else None,
        ms=ms, ms_source=src[0], plain_ms=plain_ms,
        bound_ms=max(byte_ms, op_ms),
        bound_by="operations" if op_ms > byte_ms else "bytes",
        library_ms=None, call_ms=call_ms, byte_bound_ms=byte_ms,
        op_bound_ms=op_ms, f64_ops=ops,
        f64_peak=f"{DET_F64_PEAK_TFLOPS} TFLOP/s FP64 vector (H100 SXM)",
        padded_ms=pad_ms, padded_ms_source=src[1], rounds=rounds,
        serial_bound_ms=serial_ms, scan_step_ns=scan_ns, bytes=nbytes,
        shape=f"B={B} S={S} (seeded pA signal; padded_ms: the zero-padded "
              "block)")
    log("[2] detect: " + json.dumps(out["kernels"]["detect"]))
    return ok


def phase_realtime_small(out, refs, dev="cuda"):
    """Phase 3's realtime cases on the card against the port's own CPU
    results from the worker: chunk-ordered replay, the deplete sim loop,
    BatchMapper with the device DSP, and dump_read's three files."""
    from uncalled_tpu_torch.ops import _cuda

    ok = True
    res = out["realtime_small"] = {}
    for name, fn, kernels in (
            ("map_ordered", rt_map_ordered, DEFAULT_KERNELS),
            ("sim", rt_sim, DEFAULT_KERNELS),
            ("dsp_golden", rt_dsp_golden, ("detect",) + POOLED_KERNELS),
            ("dump_read", rt_dump, CLASSIC_KERNELS)):
        _cuda.reset_counts()
        t0 = time.time()
        got = fn(dev)
        dt = time.time() - t0
        counts = wrapper_counts()
        want = refs.get(name)
        eq = got == want
        ran = all(counts[k] > 0 for k in kernels)
        if name == "dsp_golden":
            golden, _ = golden_signals()
            n_gold = sum(got[r] == golden[r] for r in got)
            out["kernels"]["detect"]["launches"] = counts["detect"]
            extra = f", {n_gold}/{len(got)} equal to the golden lines"
        elif name == "sim":
            lines = [x for x in got[0] if not x.startswith("#")]
            extra = (f", {len(lines)} lines, "
                     f"{sum('ej:f:' in x for x in lines)} ejected, "
                     f"{len(got[1])} give-ups")
        elif name == "dump_read":
            extra = f", {got[1]} seed rows, files " + ", ".join(
                f"{k} {len(v)} B" for k, v in got[2].items())
        else:
            extra = f", {len(got)} lines"
        log(f"[3] realtime/{name} on the card: "
            f"{'equal to' if eq else 'DIFFERS from'} the port's CPU run"
            f"{extra}; {dt:.1f} s; launches "
            + json.dumps({k: v for k, v in counts.items() if v}))
        res[name] = dict(equal=eq, kernels_ran=ran, seconds=dt,
                         launches=counts)
        ok &= eq and ran
    return ok


def phase_realtime(out, dev="cuda"):
    """Realtime at 512 channels: bench_sim.py's configuration on phase 4's
    genome and read generator (the first RT_READS reads dealt over the
    channels by default_pattern, 288 pool slots a read, a SimClock with
    RT_TICK s ticks, deplete), RT_SECS simulated seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import sortkern as sk
    from uncalled_tpu_torch.pafstats import PafEntry
    from uncalled_tpu_torch.poremodel import load_default
    from uncalled_tpu_torch.realtime.clientsim import ClientSim
    from uncalled_tpu_torch.realtime.mapper import RealtimeMapper, _Channel
    from uncalled_tpu_torch.realtime.sim import (SimClock, default_pattern,
                                                 run_sim_loop)
    from uncalled_tpu_torch.testing.simulate import simulate_reads

    fmi, th, _ = real_assets()
    t0 = time.time()
    reads = simulate_reads(assets_prefix() + ".fa", RT_READS, seed=123,
                           read_len_bp=(1000, 4000), mismatch=True)
    truth = {r.id: (r.ref_name, r.ref_start, r.ref_end, r.fwd) for r in reads}
    conf = Conf()
    conf.reads.num_channels = RT_CH
    conf.simulator.sim_speed = 1.0
    conf.engine.pool_slots_per_read = RT_SPR
    clock = SimClock()
    client = ClientSim(conf, clock=clock)
    default_pattern(client, reads,
                    int(conf.reads.sample_rate * (RT_SECS + 60)))
    client.load_reads(reads)
    rt = RealtimeMapper(fmi, load_default(), th, conf, device=dev)
    p = rt.eng.params
    log(f"[7] {len(reads)} reads simulated, mapper built in "
        f"{time.time() - t0:.1f} s; shapes B={p.B} S={p.S} SC={p.SC} "
        f"CL={p.CL} R={p.R} RT={p.RT} T={rt.T} sort_mode={p.sort_mode} "
        f"handoff={p.handoff}")

    # warm the advance path (bench_sim.py): one synthetic chunk through
    # channel 1's active branch, then the channel reset
    class _WarmChunk:
        number, start, read_id = 0, 0, "warmup"
        signal = np.random.RandomState(0).normal(90.0, 10.0, 4000).astype(
            np.float32)

    rt.add_chunks([(1, _WarmChunk())], 0.0)
    rt.update(0.0)
    rt.channels[0] = _Channel()
    mask0 = np.zeros(RT_CH, bool)
    mask0[0] = True
    rt.state = rt.eng.reset_slots(rt.state, mask0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the timed window: run_sim_loop alone, each update's wall time kept
    upd, adv = [], []
    # on the class: a pool's widening replaces rt.eng with a new engine
    Engine = type(rt.eng)
    orig_update, orig_advance = rt.update, Engine.advance

    def advance(self, *a, **k):
        adv.append(1)
        return orig_advance(self, *a, **k)

    def update(now):
        n_adv = len(adv)
        t = time.perf_counter()
        r = orig_update(now)
        upd.append(((time.perf_counter() - t) * 1e3, len(adv) > n_adv))
        return r

    Engine.advance, rt.update = advance, update
    _cuda.reset_counts()
    buf = io.StringIO()
    t0 = time.time()
    run_sim_loop(client, rt, conf, deplete=True, sleep=RT_TICK, clock=clock,
                 out=buf, duration=RT_SECS / 3600.0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = wrapper_counts()
    sim_s = client.get_runtime()
    n_adv = len(adv)
    peak = torch.cuda.max_memory_allocated()  # the window's, not the checks'
    Engine.advance, rt.update = orig_advance, orig_update

    # past the timed window, on the live state: the kernels' inputs from
    # the next updates (one whole NP=262144 sort, every level), re-checked
    # against their plain versions below, then one update traced by
    # torch.profiler
    def tick():
        n_adv = len(adv)
        rt.update(clock())  # decisions past the window are not counted
        rt.add_chunks(client.get_read_chunks(), clock())
        clock.advance(RT_TICK)
        return len(adv) > n_adv

    Engine.advance = advance
    p = rt.eng.params  # the pools as the window left them
    NP = 1 << (p.SC - 1).bit_length()  # 262144 where SC was not widened
    levels = (NP // min(sk.RUN_TILE, NP)).bit_length() - 1
    limits = dict(tracker_fold=2, ring_assemble=2, pair_counts=2,
                  flat_gather=9, sort_runs=1, merge_level=levels,
                  seg_running_max=2)
    # the first of these blocks runs eagerly (the step's ops between the
    # wrappers, the segmented running max among them, run only there); the
    # runner comes back for the next
    eng = rt.eng
    runners, eng._blocks = eng._blocks, {}
    with capture_pooled(limits, NP=NP) as captured:
        for _ in range(10):
            if tick():
                eng._blocks = runners
            if all(len(captured[k]) == n for k, n in limits.items()):
                break
    eng._blocks = runners
    traced = {}
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            advanced = tick()
            torch.cuda.synchronize()
        if advanced:
            traced = dict(wall_ms=(time.perf_counter() - t) * 1e3, prof=prof)
            break
    Engine.advance = orig_advance
    cap_ok = recheck_captured(captured, 7)

    tags = {"ej": [], "kp": [], "mx": [], "en": []}
    n_lines = n_bad = n_mapped = n_true = 0
    for line in buf.getvalue().splitlines():
        if line.startswith("#"):
            continue
        n_lines += 1
        try:
            pe = PafEntry(line)
            for t in tags:
                v = pe.get_tag(t)
                if v is not None:
                    tags[t].append(float(v))
            if pe.is_mapped:
                n_mapped += 1
                name, st, en, fwd = truth[pe.qr_name]
                n_true += (pe.rf_name == name and st - 500 <= pe.rf_st
                           <= en + 500 and pe.is_fwd == fwd)
        except Exception:  # noqa: BLE001 - a line that does not parse
            n_bad += 1

    def pct(a):
        return ([float(np.percentile(a, q)) for q in (50, 90, 99)]
                if a else None)

    active = [ms for ms, a in upd if a]
    prof_info = {}
    if traced:
        evs = trace_events(traced["prof"], "realtime_update")
        kern = [e for e in evs if e.get("cat") == "kernel"]
        dev_ms = sum(float(e.get("dur", 0)) for e in evs) / 1e3
        med = float(np.median(active)) if active else None
        prof_info = dict(
            traced_wall_ms=traced["wall_ms"],
            device_ms=dev_ms, device_ms_per_step=dev_ms / rt.T,
            kernels_per_step=len(kern) / rt.T,
            seg_running_max_launches=len(graph_launches(kern,
                                                        "seg_running_max")),
            idle_share=1.0 - dev_ms / med if med else None,
            idle_share_traced=1.0 - dev_ms / traced["wall_ms"])
    real = dict(
        channels=RT_CH, reads=len(reads), sim_seconds=sim_s,
        wall_seconds=wall, realtime_factor=sim_s / wall,
        decisions=n_lines, unparsed=n_bad,
        n_ej=len(tags["ej"]), n_kp=len(tags["kp"]), n_mx=len(tags["mx"]),
        n_en=len(tags["en"]), n_giveup=len(rt.giveups),
        n_giveup_ovf=sum(1 for g in rt.giveups if g[1]),
        eject_latency_s_p50_p90_p99=pct(tags["ej"]),
        mapped=n_mapped, truth_frac=n_true / max(n_mapped, 1),
        updates=len(upd), advances=n_adv,
        wall_ms_per_update=float(np.mean([m for m, _ in upd])) if upd
        else None,
        wall_ms_per_active_update_p50=float(np.median(active)) if active
        else None,
        wall_ms_per_step=(float(np.median(active)) / rt.T) if active
        else None,
        profiled_update=prof_info,
        max_memory_allocated=peak,
        pool_hw=[int(x) for x in rt.state["dm_pool"].cpu().numpy()],
        pool_cap=[p.SC, p.SC, p.S, p.RE, p.RT],
        launches=counts,
        launches_per_step={k: v / max(n_adv * rt.T, 1)
                           for k, v in counts.items() if v},
    )
    out["realtime"] = real
    log("[7] realtime: " + json.dumps(real))
    n_seg = prof_info.get("seg_running_max_launches", 0)
    if n_seg and "seg_running_max" in out["kernels"]:
        out["kernels"]["seg_running_max"]["launches"] = n_seg
    ran = all(counts[k] > 0 for k in DEFAULT_KERNELS) and n_seg > 0
    ok = (n_bad == 0 and n_lines > 0 and n_mapped > 0 and ran and cap_ok
          and bool(traced) and real["truth_frac"] >= RT_TRUTH_MIN)
    log(f"[7] gates: lines parse {n_bad == 0}, decisions {n_lines} > 0, "
        f"kernels of the path launched {ran} (seg_running_max {n_seg} "
        f"times in the traced update), captured calls bit-equal to "
        f"the plain versions {cap_ok}, an update traced {bool(traced)}, "
        f"truth fraction {real['truth_frac']:.4f} >= {RT_TRUTH_MIN}: "
        f"{'ok' if ok else 'FAILED'}")
    return ok


# ---------------------------------------------------------------------------
# the command line (phase 8)
# ---------------------------------------------------------------------------

# phase 8's golden-derived runs: channels the reads are dealt over, reads of
# the --ord and classic runs, simulated seconds of the sim run; reads of the
# real-size run
CLI_CH, CLI_SMALL, CLI_SIM_SECS = 4, 4, 10.0
CLI_N = 128


def write_fast5_npz(path, reads, n_ch):
    """The stand-in for a multi-read fast5 file, one .npz written under the
    .fast5 name: each signal quantized to int16 as a MinION stores it
    (digitisation 8192, range 1402, offset 0), the reads dealt over
    ``n_ch`` channels in turn, with read numbers and start times."""
    raws = [np.clip(np.rint(np.asarray(s, np.float32) * (8192.0 / 1402.0)),
                    -32768, 32767).astype(np.int16) for _, s in reads]
    i = np.arange(len(reads))
    with open(path, "wb") as f:
        np.savez(f, read_id=np.array([r for r, _ in reads]),
                 channel=i % n_ch + 1, number=i + 1,
                 start_time=4000 * (i // n_ch) + 1,
                 digitisation=np.full(len(i), 8192.0),
                 range=np.full(len(i), 1402.0), offset=np.zeros(len(i)),
                 raw=np.concatenate(raws),
                 raw_len=np.array([len(r) for r in raws]))


def load_fast5_npz(path):
    """``io.fast5.load_fast5``'s stand-in: the reads of a write_fast5_npz
    file, calibrated by the port's own ``io.fast5._calibrate`` (its u16
    wrap included), with the field types the multi-read loader gives."""
    from uncalled_tpu_torch.io.fast5 import Read, _calibrate

    with np.load(path) as z:
        ends = np.cumsum(z["raw_len"])
        return [Read(id=str(z["read_id"][i]), channel=int(z["channel"][i]),
                     number=int(z["number"][i]),
                     start_sample=int(z["start_time"][i]),
                     signal=_calibrate(z["raw"][e - z["raw_len"][i]: e],
                                       float(z["digitisation"][i]),
                                       float(z["offset"][i]),
                                       float(z["range"][i])))
                for i, e in enumerate(ends)]


class _Stamped(io.StringIO):
    """A stdout that records when each of its lines was written."""

    def __init__(self):
        super().__init__()
        self.stamps = []

    def write(self, s):
        self.stamps += [time.perf_counter()] * s.count("\n")
        return super().write(s)


def run_cli(argv, sim_clock=False):
    """One in-process call of the port's ``main(argv)``, its fast5 input
    read through load_fast5_npz (and, with ``sim_clock``, one SimClock as
    ``time.monotonic`` for the call): (stdout lines, stderr, the time of
    the first file read, the time of each stdout line)."""
    from uncalled_tpu_torch.__main__ import main
    from uncalled_tpu_torch.io import fast5
    from uncalled_tpu_torch.realtime.sim import SimClock

    first = []

    def load(path):
        first.append(time.perf_counter())
        return load_fast5_npz(path)

    out, err = _Stamped(), io.StringIO()
    orig = fast5.load_fast5, time.monotonic
    fast5.load_fast5 = load
    if sim_clock:
        time.monotonic = SimClock()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main(argv)
    finally:
        fast5.load_fast5, time.monotonic = orig
    return out.getvalue().splitlines(), err.getvalue(), first[:1], out.stamps


def cli_inputs(device):
    """Phase 8's small inputs, written for the process that asks (the
    card's or the CPU worker's): the example index prefix, the stand-in
    fast5 of the golden reads that decide, and a --conf file for
    CLI_CH channels."""
    from uncalled_tpu_torch.ops._cuda import BUILD_DIR

    d = os.path.join(BUILD_DIR, f"cli_{device}")
    os.makedirs(d, exist_ok=True)
    golden, sigs = golden_signals()
    f5 = os.path.join(d, "golden.fast5")
    write_fast5_npz(f5, [(r, sigs[r]) for r in golden if r != "noise_1"],
                    CLI_CH)
    conf = os.path.join(d, f"ch{CLI_CH}.toml")
    with open(conf, "w") as f:
        f.write(f"[reads]\nnum_channels = {CLI_CH}\n")
    return example_assets()[3], f5, conf


def cli_small_cases(prefix, f5, conf):
    """(name, argv, kernels the run must launch, SimClock?) of phase 8's
    runs on golden-derived reads: map at the CLI's defaults (pooled, B=64,
    the conf defaults), map --ord and the classic engine on CLI_SMALL
    reads, and sim on CLI_CH channels for CLI_SIM_SECS simulated seconds
    (--duration is in hours)."""
    n = str(CLI_SMALL)
    return (
        ("map", ["map", prefix, f5], DEFAULT_KERNELS, False),
        ("map --ord", ["map", prefix, f5, "--ord", "-n", n], DEFAULT_KERNELS,
         False),
        ("map --engine-pooled false", ["map", prefix, f5, "--engine-pooled",
                                       "false", "-n", n], CLASSIC_KERNELS,
         False),
        ("sim", ["sim", prefix, f5, "--conf", conf, "--duration",
                 str(CLI_SIM_SECS / 3600)], DEFAULT_KERNELS, True))


def cli_small(device):
    """Phase 8's golden-derived runs on ``device``: {name: stdout lines,
    wall-clock tags stripped}."""
    cases = cli_small_cases(*cli_inputs(device))
    return {name: [strip_wall(x) for x in run_cli(
        argv + ["--device", device], clock)[0]]
        for name, argv, _, clock in cases}


def phase_cli(out, refs):
    """The port's command line on the card, called in-process: ``index``;
    map, map --ord, the classic map and sim on golden-derived reads, each
    equal to the port's own --device cpu run from the worker; and map at
    the CLI's defaults on phase 4's genome and CLI_N of its reads."""
    import shutil
    import tempfile

    import torch

    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops._cuda import BUILD_DIR

    log("[8] fast5 input: through a stand-in for io.fast5.load_fast5 (an "
        ".npz of int16 raw data and the read and channel attributes, "
        "calibrated by io.fast5._calibrate), on every machine: h5py, the "
        "fast5 reader's optional dependency, is not part of the card's "
        "PyTorch installation")
    res = out["cli"] = {}
    prefix, f5, conf = cli_inputs("cuda")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        t0 = time.time()
        fa = shutil.copy(prefix + ".fa", os.path.join(tmp, "example_ref.fa"))
        run_cli(["index", fa, "-o", os.path.join(tmp, "example_ref")])
        with open(os.path.join(tmp, "example_ref.uncl"), "rb") as a, \
                open(prefix + ".uncl", "rb") as b:
            ok = a.read() == b.read()
    res["index"] = dict(uncl_equal=ok, seconds=time.time() - t0)
    log(f"[8] index: .uncl {'byte-identical to' if ok else 'DIFFERS from'}"
        f" tests/fixtures/example_index/example_ref.uncl; "
        f"{res['index']['seconds']:.1f} s")

    small = {}
    for name, argv, kernels, clock in cli_small_cases(prefix, f5, conf):
        _cuda.reset_counts()
        t0 = time.time()
        lines = [strip_wall(x) for x in run_cli(argv, clock)[0]]
        torch.cuda.synchronize()
        counts = wrapper_counts()
        small[name] = lines
        res[name] = dict(lines=len(lines), seconds=time.time() - t0,
                         kernels_ran=all(counts[k] > 0 for k in kernels),
                         launches=counts)

    # real size: phase 4's index and thresholds under one prefix, CLI_N of
    # its timed reads in one stand-in fast5, map at the CLI's defaults
    fmi, th, sim = real_assets()
    reads = sim[8: 8 + CLI_N]
    truth = {r.id: (r.ref_name, r.ref_start, r.ref_end, r.fwd) for r in reads}
    made = []
    init = BatchMapper.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        big = os.path.join(tmp, "rgen")
        fmi.save(big)
        shutil.copy(assets_prefix() + ".uncl", big + ".uncl")
        f5big = os.path.join(tmp, "reads.fast5")
        write_fast5_npz(f5big, [(r.id, r.signal) for r in reads], 512)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_counts()
        BatchMapper.__init__ = record
        t0 = time.perf_counter()
        try:
            lines, err, first, stamps = run_cli(["map", big, f5big])
        finally:
            BatchMapper.__init__ = init
        torch.cuda.synchronize()
    counts = wrapper_counts()
    bm = made[0]
    chain = _chain(bm)
    steps = sum(m.disp_events // m.eng.params.B for m in chain)
    dt = stamps[-1] - first[0] if stamps and first else float("nan")
    cols = [x.split("\t") for x in lines]
    mapped = [c for c in cols if c[4] in "+-"]
    correct = [c for c in mapped if c[5] == truth[c[0]][0]
               and truth[c[0]][1] - 500 <= int(c[7]) <= truth[c[0]][2] + 500
               and (c[4] == "+") == truth[c[0]][3]]
    p = bm.eng.params
    real = dict(
        reads=len(reads), lines=len(lines),
        yielded_all=sorted(c[0] for c in cols) == sorted(truth),
        setup_s=first[0] - t0 if first else None, seconds=dt,
        reads_per_s=len(reads) / dt, steps=steps,
        steps_entry=bm.disp_events // p.B, ms_per_step=dt * 1e3 / max(steps, 1),
        mapped_frac=len(mapped) / len(reads),
        correct_frac=len(correct) / len(reads),
        shapes=dict(B=p.B, S=p.S, SC=p.SC, CL=p.CL, T=bm.T,
                    sort_mode=p.sort_mode, handoff=p.handoff),
        n_handoff=sum(m.n_handoff for m in chain),
        drain_widths=_drains(bm),
        ejects_per_tier=[m.n_ejected for m in bm.tiers()],
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches=counts,
        launches_per_step={k: v / max(steps, 1) for k, v in counts.items()},
        stderr=err.strip().splitlines()[-1:])
    res["real"] = real
    log("[8] real: " + json.dumps(real))
    log(f"[8] map at the CLI's defaults, {len(reads)} reads of the 4.7 Mb "
        f"genome: {real['reads_per_s']:.2f} reads/s from the first fast5 "
        f"read to the last PAF line, {real['ms_per_step']:.2f} ms per event "
        f"step, mapped {real['mapped_frac']:.3f}, correct "
        f"{real['correct_frac']:.3f}, peak device memory "
        f"{real['max_memory_allocated']} B ({out.get('card')})")
    ok &= (len(lines) == len(reads) and real["yielded_all"]
           and real["mapped_frac"] >= 0.95)
    ok &= all(counts[k] > 0 for k in DEFAULT_KERNELS)

    # the golden-derived runs against the worker's (ready by now)
    want = refs.get("cli")
    for name, lines in small.items():
        r = res[name]
        r["equal"] = lines == want[name]
        log(f"[8] {name}: {r['lines']} lines, "
            f"{'equal to' if r['equal'] else 'DIFFER from'} the port's "
            f"--device cpu run; {r['seconds']:.1f} s; launches "
            + json.dumps({k: v for k, v in r["launches"].items() if v}))
        ok &= r["equal"] and r["kernels_ran"] and r["lines"] > 0
    return ok


# ---------------------------------------------------------------------------
# the sharded engines' kernels (phase 2) and the sharded engines (phase 9)
# ---------------------------------------------------------------------------

def _pad_rows(a, mult):
    extra = (-len(a)) % mult
    return np.pad(a, [(0, extra)] + [(0, 0)] * (a.ndim - 1)) if extra else a


def shard_rows(rng, n_rows, nix, k, count):
    """Seeded indices over a table of n_rows padded to the nix multiple,
    with the edges of block k, the padding rows and rows in no shard."""
    padded = n_rows + (-n_rows) % nix
    per = padded // nix
    edges = np.array([-(2**31), -1, 0, k * per - 1, k * per,
                      (k + 1) * per - 1, (k + 1) * per, n_rows - 1, n_rows,
                      padded - 1, padded, 2**31 - 1], np.int64)
    body = rng.integers(-64, padded + 64, count - len(edges))
    return np.concatenate([edges, body]).astype(np.int32)


def shard_kernels(out, rate, dev):
    """The sharded engines' two kernels against their plain versions, bit
    for bit: ``shard_take`` over phase 4's occ_rows split in 2 and in 4
    (every block; 2*SC rows, F=6) and its sa_samp (RT rows, F=1), with rows
    in no shard and the padding rows; ``sa_walk_step`` on every row of the
    example index at intv 32 and 24, both blocks of a split in 2, and the
    whole walk as the sum of the blocks' steps against the one-launch
    lookup; then each kernel's device time at the shapes of phase 9 (c)
    (one rank of the (2, 2) mesh: 2*SC/2 occ rows, RT/2 walk rows)."""
    import torch

    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping.engine import index_arrays
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.ops import sa_lookup as sl
    from uncalled_tpu_torch.ops import shard_take as st
    from uncalled_tpu_torch.poremodel import load_default

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    res = out["kernels"]
    rng = np.random.default_rng(20261017)
    fmi, th, _ = real_assets()
    model = load_default()
    tabs = index_arrays(fmi, th, model, sampled_sa=True, sa_intv=SA_INTV)
    ok = True
    for nix in (2, 4):
        for key, count in (("occ_rows", 2 * SC_FULL), ("sa_samp", RT_FULL)):
            tbl = _pad_rows(tabs[key], nix)
            per = len(tbl) // nix
            for k in range(nix):
                blk = T(tbl[k * per: (k + 1) * per])
                rows = T(shard_rows(rng, len(tabs[key]), nix, k, count))
                ok &= check(f"shard_take[{key} split {nix}, block {k}, "
                            f"F={tbl.shape[1] if tbl.ndim == 2 else 1}, "
                            f"{count} rows]",
                            st.shard_take(blk, rows, k * per),
                            st.shard_take_plain(blk, rows, k * per))
    # the headline: one rank's take in (c), its local 2*SC/2 queries
    occ = _pad_rows(tabs["occ_rows"], 2)
    per = len(occ) // 2
    blk = T(occ[:per])
    rows = T(shard_rows(rng, len(tabs["occ_rows"]), 2, 0, SC_FULL))
    own = rows[(rows >= 0) & (rows < per)]

    def lib_take():
        m = (rows >= 0) & (rows < per)
        g = blk.index_select(0, rows.clamp(0, per - 1))
        return torch.where(m[:, None], g, 0)

    ok &= report(res, "shard_take", st.shard_take(blk, rows, 0),
                 st.shard_take_plain(blk, rows, 0), rate,
                 lambda: st.shard_take(blk, rows, 0),
                 lambda: st.shard_take_plain(blk, rows, 0), lib_take,
                 nbytes=rows.numel() * 4 * 7
                 + int(torch.unique(own).numel()) * 24,
                 shape=f"block {tuple(blk.shape)} of {len(occ)} rows, "
                       f"{rows.numel()} rows")

    # the walk step on every row of the example index, both blocks of 2
    ex = os.path.join(REPO, "tests", "fixtures", "example_index",
                      "example_ref")
    efmi = load_bwa_index(ex)
    eth = load_uncl(ex + ".uncl")
    from uncalled_tpu_torch.mapping.engine import device_index

    for intv in (SA_INTV, 24):
        et = index_arrays(efmi, eth, model, sampled_sa=True, sa_intv=intv)
        n, primary = et["n"], et["primary"]
        eocc = _pad_rows(et["occ_rows"], 2)
        esamp = _pad_rows(et["sa_samp"], 2)
        po, ps = len(eocc) // 2, len(esamp) // 2
        blocks = [(T(eocc[k * po: (k + 1) * po]),
                   T(esamp[k * ps: (k + 1) * ps])) for k in range(2)]
        L2 = T(et["L2"])
        rows = torch.arange(n + 1, dtype=torch.int32, device=dev)
        for k, (ob, _) in enumerate(blocks):
            ok &= check(f"sa_walk_step[example index, intv {intv}, block {k}"
                        f" of 2, all {n + 1} rows]",
                        sl.sa_walk_step(ob, L2, rows, n, primary, intv,
                                        k * po),
                        sl.sa_walk_step_plain(ob, L2, rows, n, primary,
                                              intv, k * po))
        # the whole walk: rounds of the blocks' runs summed (the sum over
        # idx), then the sample's take
        r, steps, rounds = rows.clone(), torch.zeros_like(rows), 0
        while bool(((r % intv) != 0).any()):
            r, k_ = sum(sl.sa_walk_step(ob, L2, r, n, primary, intv, k * po)
                        for k, (ob, _) in enumerate(blocks))
            steps += k_
            rounds += 1
        q = torch.div(r, intv, rounding_mode="floor")
        got = sum(st.shard_take(sb, q, k * ps)
                  for k, (_, sb) in enumerate(blocks)) + steps
        idx = device_index(efmi, eth, model, device=dev, sampled_sa=True,
                           sa_intv=intv)
        ok &= check(f"sharded walk[example index, intv {intv}, split 2, "
                    f"{int(steps.max())} steps in {rounds} rounds] vs "
                    "sa_lookup", got, sl.sa_lookup(idx, rows, intv))

    # the headline step: one rank's walk rows in (c) (RT/2) over the 4.7 Mb
    # genome's occ_rows, block 0 of 2
    n, primary = tabs["n"], tabs["primary"]
    L2 = T(tabs["L2"])
    r = T(rng.integers(0, n + 1, RT_FULL // 2).astype(np.int32))
    got = sl.sa_walk_step(blk, L2, r, n, primary, SA_INTV, 0)
    taken = got[1]
    longest = int(taken.max())
    ok &= report(res, "sa_walk_step", got,
                 sl.sa_walk_step_plain(blk, L2, r, n, primary, SA_INTV, 0),
                 rate, lambda: sl.sa_walk_step(blk, L2, r, n, primary,
                                               SA_INTV, 0),
                 lambda: sl.sa_walk_step_plain(blk, L2, r, n, primary,
                                               SA_INTV, 0), None,
                 nbytes=r.numel() * 12 + int(taken.sum()) * 24 + 20,
                 shape=f"block {tuple(blk.shape)} of {len(occ)} rows, "
                       f"{r.numel()} rows: {int((taken > 0).sum())} owned "
                       f"and live, {int(taken.sum())} local steps, the "
                       f"longest run {longest}")
    # its chain bound, as sa_lookup's: the longest local run of dependent
    # bucket-row loads x one dependent load's measured latency
    lat = load_latency_ns(dev)
    res["sa_walk_step"].update(chain_bound_ms=longest * lat * 1e-6,
                               load_latency_ns=lat, run_longest=longest)
    # its step on one thread over the whole table as one block, and its
    # floor: the same rows rounded down to sampled ones (no row steps)
    r_res = (r // SA_INTV) * SA_INTV
    ok &= lf_step_times(res["sa_walk_step"], "sa_walk_step", 2,
                        T(tabs["occ_rows"]), None, L2, fmi, dev,
                        lambda: sl.sa_walk_step(blk, L2, r_res, n, primary,
                                                SA_INTV, 0))
    log("[2] sa_walk_step chain bound: " + json.dumps(
        {k: res["sa_walk_step"][k] for k in (
            "ms", "bound_ms", "chain_bound_ms", "load_latency_ns",
            "step_ns", "floor_ms", "step_model_ms", "run_longest")}))
    return ok


def phase_sharded(out):
    """Phase 9: the sharded engines through BatchMapper: (a) NCCL at world
    size 1 on a (1, 1) mesh in this process; (b) four gloo ranks on this
    card, (2, 2) mesh; (c) four gloo ranks at real size."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops._cuda import BUILD_DIR
    from uncalled_tpu_torch.testing import multihost_child as mc

    res = out["sharded"] = {}
    with open(os.path.join(REPO, "tests", "fixtures", "golden_pafs.json")) \
            as f:
        golden = json.load(f)

    def lines_ok(cases):
        bad = [(c, r) for c, v in cases.items() for r, line in
               v["lines"].items() if line != golden[r]]
        n = sum(len(v["lines"]) for v in cases.values())
        want = sum(len(c[3]) for c in mc.GOLDEN_CASES.values())
        return not bad and n == want, bad

    log("[9] four ranks share one card: their collectives are gloo's, "
        "staged through the host (NCCL refuses two ranks on one device), so "
        "the times below are gloo's on one host and not the layout's over "
        "NVLink")
    # (a) NCCL at world size 1, in this process
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                                rank=0, world_size=1)
        try:
            mesh = mc.make_mesh(1, "nccl")
            _cuda.reset_counts()
            cases = mc.golden_cases(mesh, torch.device("cuda", 0))
            torch.cuda.synchronize()
            counts = wrapper_counts()
        finally:
            dist.destroy_process_group()
    a_ok, bad = lines_ok(cases)
    need = POOLED_KERNELS + CLASSIC_KERNELS + SHARD_KERNELS
    a_ok &= all(counts[k] > 0 for k in need)
    res["a"] = dict(backend="nccl", world=1, mesh=[1, 1],
                    seconds=time.time() - t0, bad=bad, launches=counts,
                    case_seconds={c: v["seconds"] for c, v in cases.items()})
    for k in SHARD_KERNELS:
        out["kernels"][k]["launches"] = counts[k]
    log(f"[9] (a) NCCL, world 1, mesh (1, 1): "
        f"{'every line golden' if not bad else 'MISMATCH ' + str(bad)}; "
        f"{res['a']['seconds']:.1f} s; launches "
        + json.dumps({k: counts[k] for k in need}))

    # (b) gloo, four ranks on this card, mesh (2, 2)
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        ranks, _ = mc.collect(
            mc.spawn(4, tmp, "golden", device="cuda", backend="gloo",
                     timeout=SHARD_TIMEOUT_S), tmp, "golden", SHARD_TIMEOUT_S)
    b_ok = True
    for r in ranks:
        good, bad = lines_ok(r["golden"])
        same = r["golden"].keys() == ranks[0]["golden"].keys() and all(
            r["golden"][c]["lines"] == ranks[0]["golden"][c]["lines"]
            for c in r["golden"])
        split = all(loc * 2 == tot for kind in ("map", "pooled")
                    for loc, tot, _ in r["tables"][kind].values())
        ran = all(r["launches"][k] > 0 for k in need)
        b_ok &= good and same and split and ran
    res["b"] = dict(backend="gloo", world=4, mesh=[2, 2],
                    seconds=time.time() - t0, tables=ranks[0]["tables"],
                    case_seconds={c: v["seconds"] for c, v in
                                  ranks[0]["golden"].items()},
                    launches=ranks[0]["launches"], ok=b_ok)
    res["b"]["sum_ms"] = ranks[0]["sum_ms"]
    log(f"[9] (b) gloo, four ranks on cuda:0, mesh (2, 2): lines "
        f"{'golden on every rank' if b_ok else 'MISMATCH'}; each rank's "
        f"tables {json.dumps(ranks[0]['tables'])}; "
        f"{res['b']['seconds']:.1f} s with the ranks' start")
    log("[9] (b) one sum over idx of 3072 int32 on the card and its host "
        "copy, as the sharded walk makes it: "
        + json.dumps(ranks[0]["sum_ms"]))

    # (c) real size, four ranks (2, 2): phase 4's index and reads
    fmi, th, sim = real_assets()
    reads = sim[8: 8 + N_SHARDED]
    truth = {r.id: (r.ref_name, r.ref_start, r.ref_end, r.fwd) for r in reads}
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        big = os.path.join(tmp, "rgen")
        fmi.save(big)
        shutil.copy(assets_prefix() + ".uncl", big + ".uncl")
        sig = np.empty(len(reads), object)
        sig[:] = [r.signal for r in reads]
        np.savez(os.path.join(tmp, "reads.npz"),
                 ids=np.array([r.id for r in reads]), signals=sig)
        spec = dict(prefix=big, reads=os.path.join(tmp, "reads.npz"),
                    conf=dict(batch_reads=B_FULL, pooled=True,
                              pool_slots_per_read=SPR, evt_block=32,
                              slot_handoff=False, drain_shrink=False),
                    over=dict(CL=CL_FULL, sampled_sa=True, sa_intv=SA_INTV))
        with open(os.path.join(tmp, "real.json"), "w") as f:
            json.dump(spec, f)
        ranks, _ = mc.collect(
            mc.spawn(4, tmp, "real", device="cuda", backend="gloo",
                     timeout=SHARD_TIMEOUT_S), tmp, "real", SHARD_TIMEOUT_S)
    wall = time.time() - t0
    r0 = ranks[0]
    lines = r0["lines"]
    same = all(r["lines"] == lines for r in ranks)
    ref = out.get("real_lines")
    if ref is None:  # phase 4 did not run: its configuration, unsharded
        from uncalled_tpu_torch.mapping.batch import BatchMapper
        from uncalled_tpu_torch.poremodel import load_default

        bm = BatchMapper(fmi, load_default(), th, _conf(B_FULL, SPR, 32),
                         sort_mode="flat")
        ref = {p.rd_name: p.to_line() for p in bm.map_reads(
            [_Read(r.id, r.signal) for r in reads])}
    differ = sorted(r.id for r in reads if lines.get(r.id) != ref.get(r.id))
    cut = {rid: r0["ovf_why"].get(rid) for rid in differ}
    cols = [x.split("\t") for x in lines.values()]
    mapped = [c for c in cols if c[4] in "+-"]
    correct = [c for c in mapped if c[5] == truth[c[0]][0]
               and truth[c[0]][1] - 500 <= int(c[7]) <= truth[c[0]][2] + 500
               and (c[4] == "+") == truth[c[0]][3]]
    n = fmi.n
    one_card = dict(occ_rows=((n + 31) // 32) * 24, sa=(n + 1) * 4,
                    sa_samp=(n // SA_INTV + 1) * 4)
    real = dict(
        backend="gloo", world=4, mesh=[2, 2], reads=len(reads),
        yielded=len(lines), lines_equal_all_ranks=same,
        differ_from_phase4=differ, differing_ovf_why=cut,
        mapped_frac=len(mapped) / len(reads),
        correct_frac=len(correct) / len(reads),
        **{k: r0[k] for k in ("seconds", "steps", "steps_entry",
                              "ms_per_step", "collective_calls",
                              "timed_block", "walk_steps_per_event",
                              "walk_rounds_per_event", "ejects", "shapes",
                              "launches", "launches_per_step")},
        table_bytes_per_rank=[r["table_bytes"] for r in ranks],
        table_bytes_one_card=one_card, wall_with_start_s=wall,
        rank_seconds=[r["seconds"] for r in ranks],
    )
    res["c"] = real
    log("[9] (c) real: " + json.dumps(real))
    tb = real["timed_block"]
    log(f"[9] (c) {len(reads)} reads of the 4.7 Mb genome at B={B_FULL} "
        f"over four gloo ranks (2, 2): {real['ms_per_step']:.1f} ms per "
        f"event step untimed ({real['collective_calls']} sums over idx); in "
        f"a block of {tb['steps']} steps with the sums timed, "
        f"{tb['ms_per_step']:.1f} ms a step, {tb['sums_per_step']:.1f} sums"
        f" a step, {100 * tb['collective_share']:.1f}% of it in the sums; "
        f"{real['walk_steps_per_event']:.1f} walk steps in "
        f"{real['walk_rounds_per_event']:.1f} rounds per event; lines "
        f"equal to phase 4's but {differ} (ovf_why {cut}); mapped "
        f"{real['mapped_frac']:.3f}; each rank's occ_rows and sa_samp "
        f"{r0['table_bytes']} B against one card's {one_card} B "
        f"({out.get('card')})")
    c_ok = (len(lines) == len(reads) and sorted(lines) == sorted(truth)
            and same and all(cut[rid] for rid in differ)
            and real["mapped_frac"] >= 0.95)
    return a_ok and b_ok and c_ok


def profile_block(bm, reads):
    """One block of T events with every slot live, after two warm blocks
    (a pooled engine's eager block and the capture of its graphs, so the
    pooled blocks measured are replays), timed plain and then traced with
    torch.profiler: wall per step, device kernel time per step,
    CUDA kernels per step, the top kernels, and the device time per step
    of the column gathers and of every ``torch.cat`` copy left in the
    step.  ``idle_share`` is the device's idle share of the untraced wall
    time; tracing slows the host's issue, so ``idle_share_traced`` (of the
    traced kernel span) reads higher."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    eng = bm.eng
    B, T = eng.params.B, bm.T
    slots = [bm._prepare(r) for r in reads[:B]]
    means = np.zeros((B, 4 * T), np.float32)
    on = np.zeros((B, 4 * T), bool)
    for b, s in enumerate(slots):
        m = s.means[: 4 * T]
        means[b, : len(m)] = m
        on[b, : len(m)] = True
    state = eng.reset_slots(eng.fresh_state(), np.ones(B, bool))
    # warm: the block shape's eager block and its graphs' capture
    for k in range(2):
        state = eng.advance(state, means[:, k * T: (k + 1) * T],
                            on[:, k * T: (k + 1) * T])
    torch.cuda.synchronize()
    t0 = time.time()
    state = eng.advance(state, means[:, 2 * T: 3 * T], on[:, 2 * T: 3 * T])
    torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3 / T
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state = eng.advance(state, means[:, 3 * T:], on[:, 3 * T:])
        torch.cuda.synchronize()
    evs = trace_events(prof, "step")
    kern = [e for e in evs if e.get("cat") == "kernel"]
    copies = [e for e in evs if e.get("cat") != "kernel"]
    dev_us = sum(float(e.get("dur", 0)) for e in kern + copies)
    by_name = {}
    for e in kern:
        k = e.get("name", "?")[:60]
        by_name[k] = by_name.get(k, 0.0) + float(e.get("dur", 0))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]

    def family_ms(tag):
        return sum(v for k, v in by_name.items() if tag in k) / 1e3 / T

    def family_n(tag):
        return sum(1 for e in kern if tag in e.get("name", "")) / T

    starts = [float(e["ts"]) for e in kern]
    ends = [float(e["ts"]) + float(e.get("dur", 0)) for e in kern]
    span_ms = (max(ends) - min(starts)) / 1e3 if kern else 0.0
    seg = graph_launches(kern, "seg_running_max")
    return dict(
        live_slots=int(sum(1 for s in slots if len(s.means))),
        wall_ms_per_step=wall,
        traced_span_ms_per_step=span_ms / T,
        device_ms_per_step=dev_us / 1e3 / T,
        idle_share=1.0 - (dev_us / 1e3 / T) / wall,
        idle_share_traced=1.0 - (dev_us / 1e3) / span_ms if span_ms else None,
        kernels_per_step=len(kern) / T,
        copies_per_step=len(copies) / T,
        top_kernels_ms_per_step=[(k, v / 1e3 / T) for k, v in top],
        gather_cols_ms_per_step=family_ms("gather_cols_kernel"),
        cat_ms_per_step=family_ms("CatArrayBatchedCopy"),
        tracker_fold_ms_per_step=family_ms("tracker_fold_kernel"),
        sa_lookup_ms_per_step=family_ms("sa_lookup_kernel"),
        sa_lookup_launches_per_step=family_n("sa_lookup_kernel"),
        seg_running_max_launches=len(seg),
        seg_running_max_ms_per_step=sum(
            float(e.get("dur", 0)) for e in seg) / 1e3 / T,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10")
    # internal: the CPU reference worker (started by the main process)
    ap.add_argument("--cpu-refs", default=None, help=argparse.SUPPRESS)
    # internal: a tie-read oracle worker (ORDER PREFIX PATH)
    ap.add_argument("--tie-oracle", nargs=3, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = {int(x) for x in args.phases.split(",")}
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if args.cpu_refs:
        sys.path.insert(0, REPO)
        return cpu_refs_worker(args.cpu_refs)
    if args.tie_oracle:
        sys.path.insert(0, REPO)
        order, prefix, path = args.tie_oracle
        return tie_oracle_worker(path, order, prefix)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        import uncalled_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from a checkout of the repository "
              "(uncalled_tpu_torch not found)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    out = {"kernels": {}, "phase_seconds": {}}
    ok = True
    # the CPU references of the realtime, oracle and CLI checks run in a
    # worker process beside phases 1-3; the tie-read oracles in two more,
    # from the moment phase 4's assets are on disk to phase 10
    refs = HostWorker("cpu_refs", [n for n, _ in CPU_REFS],
                      ["--cpu-refs"]) if phases & {2, 3, 8} else None
    ties = TieOracles() if 10 in phases else None
    if ties is not None:
        _ON_ASSETS.append(ties.start)
    try:
        t0 = time.time()
        phase_card(out)
        rate = hbm_rate(out["card"])
        dev = torch.device("cuda")
        out["phase_seconds"][1] = time.time() - t0
        for n, run in (
                (2, lambda: phase_kernels(out, rate)
                 & phase_detect(out, rate, dev, refs)),
                (3, lambda: phase_golden(out, refs)
                 & phase_realtime_small(out, refs)
                 & phase_oracle_golden(out, refs)),
                (4, lambda: phase_real(out, rate)),
                (5, lambda: phase_classic(out)),
                (6, lambda: phase_defaults(out)),
                (7, lambda: phase_realtime(out)),
                (8, lambda: phase_cli(out, refs)),
                (9, lambda: phase_sharded(out)),
                (10, lambda: phase_tie_oracle(out, ties))):
            if n in phases:
                t0 = time.time()
                try:
                    ok &= bool(run())
                except Exception:  # noqa: BLE001 - the verdict fails below
                    import traceback

                    log(f"[{n}] phase {n} raised:\n"
                        + traceback.format_exc())
                    ok = False
                out["phase_seconds"][n] = time.time() - t0
                log(f"[{n}] phase {n} took {out['phase_seconds'][n]:.1f} s")
    finally:
        for w in (refs, ties):
            if w is not None:
                w.stop()
    from uncalled_tpu_torch.ops._cuda import BUILD_DIR

    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "chip_smoke.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(out["card"])
    print(json.dumps({"kernels": [dict(name=k, **v)
                                  for k, v in out["kernels"].items()]}))
    if not ok or phases != set(range(1, 11)):
        log("chip_smoke: FAILED" if not ok else "chip_smoke: partial run")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
