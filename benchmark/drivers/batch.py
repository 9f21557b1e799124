"""Batch mapping: ``BatchMapper.map_reads`` over an endless closed-loop
stream of simulated reads, pulled as slots free.

Set-up: the configuration's genome, the program's index and thresholds
(``uncalled_tpu_torch.index``; built on a checkout's first run, loaded
after it), the mapper at the configuration's settings, and a pre-roll: the window opens once the mapper has yielded as
many reads as it has slots, so the slots hold reads of every age and every
shape the window runs has run.  The reads come from producer processes
that make them from the seed, and the first ``feed_reads`` wait in this
process before the window opens, so the window pays almost nothing for
making them (``feed.pull_share.batch`` says what it paid).

The window counts the PAF records yielded in ``seconds``; they are the
answers due.  Reads still in a slot at the close, and reads ejected to a
wider tier (which runs only once the input ends, and a closed loop's
input never does), are not due, but every read pulled must be yielded or
still held by the mapper: one that is neither was lost, and one yielded
twice failed.  Then the program is freed and the reference maps a sample
of the due reads, drawn from the seed.
"""

from __future__ import annotations

import gc
import hashlib
import json
import os
import sys
import time
import types
from collections import deque

import numpy as np

COUNTERS = ("disp_events", "useful_events", "t_refill", "n_handoff",
            "n_overflow")
SPANS = (("eng", "advance", "advance"), ("eng", "readout_start",
                                         "readout_issue"),
         ("eng", "readout_get", "readout_wait"),
         ("eng", "reset_slots", "slot_reset"),
         ("bm", "_prepare_many", "refill_dsp"))


def held_reads(gen, read_type) -> set:
    """Numbers of the reads a suspended ``map_reads`` generator still
    holds: every ``read_type`` reachable from its frame (locals, the cells
    its closures share and the value stack, so also a generator it runs by
    ``yield from`` or loops over) and from the generators and iterators
    found there, through
    lists, tuples, sets, deques, dicts and objects with a ``read`` (the
    slots), whatever the program names them.  A list iterator counts
    only the items it has still to give."""
    out, seen = set(), set()
    todo = [(gen, 0)]
    while todo:
        v, depth = todo.pop()
        if isinstance(v, read_type):
            out.add(v.number)
            continue
        if depth > 8 or id(v) in seen:
            continue
        seen.add(id(v))
        if isinstance(v, (list, tuple, set, frozenset, deque)):
            todo += [(x, depth + 1) for x in v]
        elif isinstance(v, dict):
            todo += [(x, depth + 1) for x in v.values()]
        elif type(v).__name__ == "list_iterator":
            red = v.__reduce__()  # (iter, (list,), position): not consumed
            rest = red[1][0][red[2]:] if len(red) > 2 else []
            todo += [(x, depth + 1) for x in rest]
        elif isinstance(v, (types.GeneratorType, types.CellType, enumerate,
                            zip, map, filter)) or type(v).__name__.endswith(
                                "iterator"):
            todo += [(x, depth + 1) for x in gc.get_referents(v)]
        elif isinstance(getattr(v, "read", None), read_type):
            out.add(v.read.number)
    return out


def mappers(bm):
    """The mapper, its eject tiers and every drain below them."""
    out, todo = [], [bm]
    while todo:
        m = todo.pop()
        if m is None or any(m is x for x in out):
            continue
        out.append(m)
        todo += [m._next_mapper, m._drain_mapper]
    return out


def _read(path):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


def counters(bm) -> dict:
    ms = mappers(bm)
    out = {k: float(sum(getattr(m, k, 0) for m in ms)) for k in COUNTERS}
    # reads harvested with a budget overflow: ejected to a wider tier
    out["n_overflow"] = float(sum(len(m.ovf_why) for m in ms))
    return out


def run(ctx) -> dict:
    import uncalled_tpu_torch.mapping.batch  # noqa: F401  (the imports)
    from uncalled_tpu_torch import native

    from benchmark.traffic import genome as gen
    from benchmark.traffic.reads import ReadStream

    cfg, mix, seed = ctx.config, ctx.cell["params"], ctx.seed
    stages = {}

    def stage(name):
        stages[name] = time.time() - ctx.t0

    if not native.available():  # the host detector's numpy fallback
        raise RuntimeError("the port's native host library did not build")
    stage("imports")
    genome = gen.realistic_genome(cfg["genome"]["bp"],
                                  np.random.default_rng([cfg["genome"]["seed"],
                                                         1]),
                                  cfg["genome"]["repeats"])
    stage("genome")
    # the producers make the reads while the rest of set-up runs
    stream = ReadStream(genome, seed, mix, ahead=mix["feed_reads"])
    try:
        return _run(ctx, cfg, mix, seed, genome, stream, stage, stages)
    finally:
        stream.close()


def _run(ctx, cfg, mix, seed, genome, stream, stage, stages):
    import torch

    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.index.build import build_index
    from uncalled_tpu_torch.index.fmindex import load_index
    from uncalled_tpu_torch.index.parameterize import build_uncl
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.poremodel import load_default

    from benchmark.harness.core import WORK, power_limit_w
    from benchmark.harness.profile import Stretch
    from benchmark.harness.spans import Spans
    from benchmark.reference import check
    from benchmark.traffic import genome as gen
    from benchmark.traffic.reads import Read

    on_card = ctx.device == "cuda"
    conf = Conf()
    for sec, kv in cfg["conf"].items():
        for k, v in kv.items():
            setattr(getattr(conf, sec), k, v)
    # the program's index and thresholds, built on a checkout's first run
    # and loaded after it (the genome is the configuration's own)
    prefix = os.path.join(WORK, "index_" + cfg["name"], "genome")
    key = json.dumps([cfg["genome"], cfg["conf"]["index"]], sort_keys=True)
    if _read(prefix + ".key") != key:
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        if os.path.exists(prefix + ".key"):
            os.remove(prefix + ".key")
        gen.write_fasta(prefix + ".fa", cfg["genome"]["name"], genome)
        fmi = build_index(prefix + ".fa")
        fmi.save(prefix)
        build_uncl(fmi, prefix, conf)
        with open(prefix + ".key", "w") as f:
            f.write(key)
    else:
        fmi = load_index(prefix)
    stage("index")
    bm = BatchMapper(fmi, load_default(), load_uncl(prefix + ".uncl"), conf,
                     device=ctx.device)
    if ctx.patch:
        ctx.patch(bm)
    spans = Spans()
    for owner, meth, name in SPANS:
        spans.wrap(bm.eng if owner == "eng" else bm, meth, name)
    B, T = bm.eng.params.B, bm.T
    stage("mapper")

    out = bm.map_reads(stream)
    yielded = [next(out).rd_name for _ in range(B)]
    if on_card:
        torch.cuda.synchronize()
    stage("preroll")
    stream.fill()
    stage("feed")
    t_open = time.time()
    setup_s = t_open - ctx.t0
    c0 = counters(bm)
    stretch = None
    if ctx.trace:
        stretch = Stretch(spans, "advance", mix["profile_blocks"],
                          t_open + ctx.seconds / 2, ctx.work, _cuda.COUNTS)
        spans.hooks.append(stretch.hook)
    spans.on = stream.timing = True
    t_end = t_open + ctx.seconds
    lines, window_reads = {}, 0  # PAF records yielded in the window
    for paf in out:
        yielded.append(paf.rd_name)  # one past the close too: not lost
        if time.time() >= t_end:
            break
        window_reads += 1
        lines[paf.rd_name] = paf.to_line()
    spans.on = stream.timing = False
    twice = len(yielded) - len(set(yielded))
    c1 = counters(bm)
    stage("window")
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if stretch is not None:  # the peak before the stretch kept indices,
        memory_peak = max(memory_peak, stretch.peak_before)  # and since

    # every read pulled is yielded or still held by the mapper
    held = held_reads(out, Read)
    done = {check.read_number(r) for r in yielded}
    lost = sorted(set(range(stream.pulled)) - done - held)
    ejected = {check.read_number(r) for m in mappers(bm) for r in m.ovf_why}
    reads = dict(pulled=stream.pulled, yielded=len(yielded),
                 held=len(held - done), deferred=len(held & ejected - done),
                 lost=len(lost))
    out.close()
    by_number = {check.read_number(r): r for r in lines}
    delta = {k: c1[k] - c0[k] for k in COUNTERS}
    delta["yielded"] = window_reads
    sp = spans.snapshot()
    sp["feed"] = dict(seconds=stream.wait_s, calls=stream.waits)
    prof = stretch.finish() if stretch else None
    record = dict(window_s=ctx.seconds - (prof or {}).get("tally_s", 0.0),
                  B=B, T=T, counters=delta, spans=sp, profile=prof)
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    del out, bm, fmi, spans, stretch
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the reference, on a sample of the window's reads
    spec = check.prepare(ctx.work, genome, cfg["genome"]["name"],
                         cfg["conf"], ctx.device)
    stage("reference_index")
    picked = check.sample(list(by_number), mix["check"]["reads"], seed)
    ref = check.reference_lines(spec, seed, mix, picked,
                                mix["check"]["workers"])
    stage("reference_map")
    differ = [n for n in picked if ref[n] != lines[by_number[n]]]
    print("stages (s since start): " + " ".join(
        f"{k} {v:.1f}" for k, v in stages.items()), file=sys.stderr)
    order = hashlib.sha1("\n".join(list(lines)[:1000]).encode()).hexdigest()
    blocks = sp.get("advance", {}).get("calls", 0)
    print(f"window: {blocks} blocks, {window_reads} reads, "
          f"{delta['n_overflow']:.0f} ejected, order of the first 1000 "
          f"{order[:12]}", file=sys.stderr)
    print("spans (ms a block): " + " ".join(
        f"{k} {1e3 * v['seconds'] / max(blocks, 1):.3f}"
        for k, v in sorted(sp.items())) + f"; refill "
        f"{1e3 * delta['t_refill'] / max(blocks, 1):.3f}", file=sys.stderr)
    print("reads at the close: " + " ".join(f"{k} {v}" for k, v in
                                             reads.items()), file=sys.stderr)
    for n in lost[:3]:
        print(f"read {n} was pulled and is neither yielded nor held",
              file=sys.stderr)
    for n in differ[:3]:
        print(f"line differs, read {n}:\n  program   {lines[by_number[n]]}\n"
              f"  reference {ref[n]}", file=sys.stderr, flush=True)
    return dict(
        attempted=window_reads, failed=twice + len(lost), reads=reads,
        end_to_end=dict(reads_per_s=window_reads / ctx.seconds,
                        setup_s=setup_s),
        checks=dict(lines_differ=(len(differ), 0), yielded_twice=(twice, 0),
                    reads_lost=(len(lost), 0)),
        compared=len(picked),
        record=record, device_kind=kind, memory_peak_bytes=memory_peak,
        power_limit_w=power_limit_w() if on_card else None)
