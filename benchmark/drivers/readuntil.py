"""ReadUntil: the program's simulated ReadUntil loop, ``run_sim_loop`` over
``ClientSim`` and ``RealtimeMapper``, on every channel of a flow cell.

Set-up: the configuration's target genome and the other members' genome,
the program's index and thresholds of the target (cached as the batch
cell caches them), the mapper as the program's sim command builds it at
the configuration's conf (one read slot pinned to each channel; its
pools grow with the demand), and the simulated pore: every channel active
for the whole run from a start drawn from the seed within
``start_spread_s``, reads drawn from the seed as the channels need them
(producer processes make them ahead; ``feed_reads`` wait in this process
before the loop starts), the next read starting ``gap_s`` after a read
ends (``eject_delay_s`` more after an eject).  The loop runs on a
simulated clock that moves ``tick_s`` a pass, however long the pass
takes, so the run is the same on any host; it is the program's own loop,
asked once a pass whether to stop.  The window opens once
``preroll_decisions`` lines have come out and closes at the first pass
``seconds`` of wall time later.

The window counts the decision lines (kp, ej, mx, en) it emits.  Every
read the pore started by the close must have had one line, or still be
on its channel (in the mapper's slot, or not yet delivered); a read with
two lines failed.  Then the program is freed and the reference
(``benchmark/reference/realtime.py``) replays a sample of the window's
decided reads, drawn from the seed (``check.kept`` of them kept lines,
the rest of the other kinds), each from its start sample in the pore's
record.  The feed's pulls are the ``feed`` span.  With ``--trace 1`` the
program's tracer is on over the window (its spans and counters feed the
per-layer metrics) and two ticks' engine advances after the window's
midpoint are profiled.

    python3 benchmark/drivers/readuntil.py --control <float32|newest_first> --seeds <n> [<n> ...]

runs the cell with the program broken underneath, one run a seed, and
prints whether the comparison held: ``float32`` detects, profiles and
normalises each read's signal at float32, the precision below the
configuration's; ``newest_first`` pops each read's events newest first.  A sound comparison gives ``correct`` false on every seed.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time
from collections import Counter
from types import SimpleNamespace

import numpy as np

COMMENT = "#"
_WALL = re.compile(r"\t(mt|qt|wt):f:[^\t]*")


def strip(line: str) -> str:
    """A PAF line without the wall-clock tags."""
    return _WALL.sub("", line.rstrip("\n"))


def number_of(line: str) -> int:
    return int(line[1:8])


class Lines:
    """The loop's output: counts each decision line by read number and
    keeps the lines of the window."""

    def __init__(self):
        self.n = 0
        self.count = Counter()
        self.window = None  # {number: line} while the window is open

    def write(self, s):
        if s.startswith(COMMENT):
            return
        self.n += 1
        k = number_of(s)
        self.count[k] += 1
        if self.window is not None:
            self.window[k] = s.rstrip("\n")


def loop_settings(cfg) -> dict:
    """The loop's settings as the reference takes them."""
    c, lp = cfg["conf"], cfg["loop"]
    rd = c["reads"]
    sr = rd["sample_rate"]
    return dict(
        T=c["engine"]["evt_block"], tick=lp["tick_s"],
        time_coef=sr / 1000.0 * c["simulator"]["sim_speed"],
        chunk_len=int(rd["chunk_time"] * sr), max_chunks=rd["max_chunks"],
        max_events=c["mapper"]["max_events"],
        chunk_timeout=c["mapper"]["chunk_timeout"],
        max_event_backlog=c["realtime"]["max_event_backlog"],
        norm_len=c["normalizer"]["len"],
        profiler=[c["event_profiler"]["win_len"],
                  c["event_profiler"]["win_stdv_min"]],
        deplete=lp["mode"] == "deplete",
        eject_delay=int(lp["eject_delay_s"] * sr))


def genomes(cfg):
    from benchmark.traffic import genome as gen

    out = []
    for g in (cfg["genome"], cfg["off_target_genome"]):
        out.append(gen.realistic_genome(
            g["bp"], np.random.default_rng([g["seed"], 1]), g["repeats"]))
    return out


def make_conf(cfg):
    from uncalled_tpu_torch.config import Conf

    conf = Conf()
    for sec, kv in cfg["conf"].items():
        for k, v in kv.items():
            setattr(getattr(conf, sec), k, v)
    return conf


def program_index(cfg, genome, conf):
    """The program's index and thresholds of the target, built on a
    checkout's first run and loaded after it (the batch cell's cache where
    the genome and index settings are the same)."""
    from uncalled_tpu_torch.index.build import build_index
    from uncalled_tpu_torch.index.fmindex import load_index
    from uncalled_tpu_torch.index.parameterize import build_uncl

    from benchmark.harness.core import WORK
    from benchmark.traffic import genome as gen

    prefix = os.path.join(WORK, "index_" + cfg.get("index_cache", cfg["name"]),
                          "genome")
    key = json.dumps([cfg["genome"], cfg["conf"]["index"]], sort_keys=True)
    if os.path.exists(prefix + ".key") and open(prefix + ".key").read() == key:
        return load_index(prefix), prefix
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    if os.path.exists(prefix + ".key"):
        os.remove(prefix + ".key")
    gen.write_fasta(prefix + ".fa", cfg["genome"]["name"], genome)
    fmi = build_index(prefix + ".fa")
    fmi.save(prefix)
    build_uncl(fmi, prefix, conf)
    with open(prefix + ".key", "w") as f:
        f.write(key)
    return fmi, prefix


def run(ctx) -> dict:
    import uncalled_tpu_torch.realtime.mapper  # noqa: F401  (the imports)
    from uncalled_tpu_torch import native
    from uncalled_tpu_torch.realtime import clientsim, sim

    from benchmark.traffic.zymo import MixedStream

    # what the cell needs of the program, asked before any set-up, so that
    # a program without it fails at once
    if not (hasattr(clientsim.ClientSim, "set_read_source")
            and "stop" in sim.run_sim_loop.__code__.co_varnames):
        raise RuntimeError("the program's ClientSim draws no reads as it "
                           "goes, or its loop takes no stop")
    if not native.available():
        raise RuntimeError("the port's native host library did not build")
    stages = {}

    def stage(name):
        stages[name] = time.time() - ctx.t0

    stage("imports")
    target, other = genomes(ctx.config)
    stage("genomes")
    stream = MixedStream(target, other, ctx.seed, ctx.cell["params"],
                         ahead=ctx.cell["params"]["feed_reads"])
    try:
        return _run(ctx, target, other, stream, stage, stages)
    finally:
        stream.close()


def _run(ctx, target, other, stream, stage, stages):
    import torch

    from uncalled_tpu_torch import tracing
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.poremodel import load_default
    from uncalled_tpu_torch.realtime.clientsim import ClientSim
    from uncalled_tpu_torch.realtime.mapper import RealtimeMapper
    from uncalled_tpu_torch.realtime.sim import SimClock, run_sim_loop

    from benchmark.harness.core import power_limit_w
    from benchmark.harness.profile import Stretch
    from benchmark.harness.spans import Spans
    from benchmark.reference import check, realtime

    cfg, mix, seed = ctx.config, ctx.cell["params"], ctx.seed
    on_card = ctx.device == "cuda"
    conf = make_conf(cfg)
    fmi, prefix = program_index(cfg, target, conf)
    stage("index")
    # the mapper as the program's sim and realtime commands build it: a
    # slot pinned to each channel, at the configuration's conf
    rt = RealtimeMapper(fmi, load_default(), load_uncl(prefix + ".uncl"),
                        conf, device=ctx.device)
    if ctx.patch:
        ctx.patch(rt)
    clock = SimClock()
    client = ClientSim(conf, clock=clock)
    sr = conf.reads.sample_rate
    lp = cfg["loop"]
    # every channel active for the whole run from a start drawn from the
    # seed, so that the channels do not start their reads together
    first = np.random.default_rng([seed, 5]).integers(
        0, int(lp["start_spread_s"] * sr), conf.reads.num_channels)
    for ch in range(1, conf.reads.num_channels + 1):
        client.add_intv(ch, 0, int(first[ch - 1]), 1 << 60)
        client.add_gap(ch, 0, int(lp["gap_s"] * sr))
        client.add_delay(ch, 0, int(lp["eject_delay_s"] * sr))
    stream.fill()
    spans = Spans()  # the engine's advances and the feed's pulls
    feed = SimpleNamespace(pull=lambda ch, k: next(stream))
    spans.wrap(feed, "pull", "feed")
    client.set_read_source(lambda ch, k: feed.pull(ch, k))
    watched = [None]

    def watch():
        """The profiled stretch's span on the mapper's engine (a new one
        each time the mapper widens its pools)."""
        if rt.eng is not watched[0]:
            watched[0] = rt.eng
            spans.wrap(rt.eng, "advance", "advance")

    watch()
    stage("mapper")

    out = Lines()
    st = dict(t_open=None, t_close=None, stretch=None)
    preroll_limit = time.time() + 1800.0

    def stop():
        watch()
        now = time.time()
        if st["t_open"] is None:
            if out.n < mix["preroll_decisions"]:
                if now > preroll_limit:
                    raise RuntimeError(f"{out.n} decisions in the pre-roll")
                return False
            if on_card:
                torch.cuda.synchronize()
            stage("preroll")
            st["g0"] = (rt.eng.graph_steps, rt.eng.eager_steps, len(rt.grows))
            out.window = {}
            spans.on = True
            if ctx.trace:
                st["stretch"] = Stretch(spans, "advance", mix["profile_ticks"],
                                        now + ctx.seconds / 2, ctx.work,
                                        _cuda.COUNTS)
                spans.hooks.append(st["stretch"].hook)
                tracing.enable()
            st["t_open"] = time.time()
            return False
        if now - st["t_open"] < ctx.seconds:
            return False
        st["t_close"] = now
        spans.on = False
        if ctx.trace:
            tracing.disable()
        return True

    run_sim_loop(client, rt, conf, deplete=lp["mode"] == "deplete", out=out,
                 sleep=lp["tick_s"], clock=clock, stop=stop)
    window_s = st["t_close"] - st["t_open"]
    stage("window")
    window_lines = out.window
    out.window = None
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    stretch = st["stretch"]
    if stretch is not None:
        memory_peak = max(memory_peak, stretch.peak_before)
    graph = (rt.eng.graph_steps - st["g0"][0], rt.eng.eager_steps - st["g0"][1])

    # where every read the pore started by the close went
    t_close = client.get_time()
    started = {n: v for n, v in client.started.items() if v[1] <= t_close}
    decided = set(out.count)
    twice = sum(1 for v in out.count.values() if v > 1)
    held = {c.number for c in rt.channels
            if c.number >= 0 and not c.done_reported}
    held |= {nm for _, nm, _ in rt._pending}
    held |= {ch.read.number for ch in client.channels if ch.read is not None}
    lost = sorted(set(started) - decided - held)
    ovf = sum(1 for _, cut, _ in rt.giveups if cut)
    reads = dict(started=len(started), decided=len(decided & set(started)),
                 held=len(held - decided), lost=len(lost),
                 giveups_ovf=ovf)
    by_channel = {}
    for n, (ch, s0, d) in sorted(started.items(), key=lambda kv: kv[1][1]):
        by_channel.setdefault(ch, []).append((n, s0, d))
    after = {}
    for rows in by_channel.values():
        for (n, _, _), (_, s1, d1) in zip(rows, rows[1:]):
            after[n] = (s1, d1)
    prof = stretch.finish() if stretch else None
    snap = tracing.snapshot()["totals"] if ctx.trace else {}
    snap["feed"] = spans.snapshot().get("feed", dict(seconds=0.0, calls=0))
    grows, grows_before = rt.grows, st["g0"][2]
    record = dict(window_s=window_s - (prof or {}).get("tally_s", 0.0),
                  B=rt.eng.params.B, T=rt.T, tick_s=lp["tick_s"],
                  counts=tracing.counts() if ctx.trace else {},
                  spans=snap, profile=prof, grows=grows)
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    del rt, client, fmi, spans, stretch, st, watched, feed
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # the reference, on a sample of the window's decided reads: a share of
    # them kept (mapped), the rest of the other kinds
    spec = check.prepare(ctx.work, target, cfg["genome"]["name"],
                         cfg["conf"], ctx.device)
    spec["paths"]["other"] = os.path.join(ctx.work, "ref_other.npy")
    np.save(spec["paths"]["other"], other.astype(np.uint8))
    stage("reference_index")
    kinds = {n: kind_of(x) for n, x in window_lines.items()}
    kept = [n for n in window_lines if kinds[n] == "kp"]
    picked = check.sample(kept, mix["check"]["kept"], seed)
    picked = sorted(picked + check.sample(
        [n for n in window_lines if kinds[n] != "kp"],
        mix["check"]["reads"] - len(picked), seed))
    items = [(n, started[n][0], started[n][1]) + after.get(n, (None, 0))
             for n in picked]
    ref = realtime.reference_lines(spec, seed, mix, items,
                                   loop_settings(cfg),
                                   mix["check"]["workers"])
    stage("reference_map")
    differ = [n for n in picked if ref[n] != strip(window_lines[n])]
    print("stages (s since start): " + " ".join(
        f"{k} {v:.1f}" for k, v in stages.items()), file=sys.stderr)
    print(f"window: {window_s:.2f} s, {len(window_lines)} decisions "
          f"({dict(Counter(kinds.values()))}), {graph[0]} graph and "
          f"{graph[1]} eager steps; compared {len(picked)} "
          f"({sum(kinds[n] == 'kp' for n in picked)} kept)", file=sys.stderr)
    for k, (at, sizes) in enumerate(grows):
        print(f"pools widened at update {at}"
              f"{' (in the window)' if k >= grows_before else ''}: "
              + " ".join(f"{f} {a}->{b}" for f, (a, b) in sizes.items()),
              file=sys.stderr)
    print("reads at the close: " + " ".join(f"{k} {v}" for k, v in
                                             reads.items()), file=sys.stderr)
    for n in lost[:3]:
        print(f"read {n} was started and is neither decided nor held",
              file=sys.stderr)
    for n in differ[:3]:
        print(f"line differs, read {n}:\n  program   "
              f"{strip(window_lines[n])}\n  reference {ref[n]}",
              file=sys.stderr, flush=True)
    return dict(
        attempted=len(window_lines), failed=twice + len(lost), reads=reads,
        end_to_end=dict(reads_per_s=len(window_lines) / window_s,
                        setup_s=stages["preroll"]),
        checks=dict(lines_differ=(len(differ), 0), decided_twice=(twice, 0),
                    reads_lost=(len(lost), 0)),
        compared=len(picked),
        record=record, device_kind=kind, memory_peak_bytes=memory_peak,
        power_limit_w=power_limit_w() if on_card else None)


def kind_of(line: str) -> str:
    """The decision of a line: kp, ej, mx or en (the loop's last tag)."""
    return strip(line).split("\t")[-1][:2]


def float32(rt):
    """Each new read's signal runs at float32 where the configuration
    states float64: its events come from the reference's streaming
    detector with float32 prefix sums, and its stall profiler and rolling
    normaliser keep their running mean and variance sum in float32; the
    profiler's mask and the normaliser's skip are the program's."""
    from uncalled_tpu_torch.realtime.signal import RollingStats

    from benchmark.reference.realtime import StreamDetector

    class Stats32(RollingStats):
        def push(self, v):
            ok = super().push(v)
            self.mean = float(np.float32(self.mean))
            self.varsum = float(np.float32(self.varsum))
            return ok

    ed = rt.conf.event_detector
    orig = rt._start_read

    def start(c, chunk, now):
        orig(c, chunk, now)
        dsp = rt.channels[c].dsp
        dsp.profiler.window.__class__ = Stats32
        dsp.norm.rs.__class__ = Stats32
        det = StreamDetector(ed.min_mean, ed.max_mean, np.float32)

        def process_chunk(sig):
            sig = np.asarray(sig, np.float32)
            dsp.signal = [np.concatenate(dsp.signal + [sig])]
            n = 0
            for m in det.add(sig):
                if not dsp.profiler.add_event(m):
                    continue
                if not dsp.norm.push(dsp.profiler.next_mean):
                    dsp.skipped += dsp.norm.skip_unread(n)
                    if not dsp.norm.push(dsp.profiler.next_mean):
                        return n
                n += 1
            return n
        dsp.process_chunk = process_chunk
    rt._start_read = start


def newest_first(rt):
    """Each new read's normaliser gives its queued events newest first."""
    orig = rt._start_read

    def start(c, chunk, now):
        orig(c, chunk, now)
        dsp = rt.channels[c].dsp
        pop_all = dsp.pop_all
        dsp.pop_all = lambda cap: pop_all(10**9)[::-1][:cap]
    rt._start_read = start


CONTROLS = dict(float32=float32, newest_first=newest_first)


def main():
    import argparse

    for v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[v] = "1"
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    from benchmark.harness.core import WORK, run_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--control", choices=sorted(CONTROLS), required=True)
    ap.add_argument("--workload", default="ecoli_rt.enrich_zymo")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    a = ap.parse_args()
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(WORK, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(WORK, "triton")
    import torch

    torch.set_num_threads(1)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in a.seeds:
        t0 = time.time()
        line, _ = run_cell(a.workload, seed, a.seconds, 0, t0, device,
                           patch=CONTROLS[a.control])
        print(json.dumps(dict(control=a.control, seed=seed,
                              correct=line["correct"], checks=line["checks"],
                              attempted=line["attempted"],
                              seconds=time.time() - t0)), flush=True)


if __name__ == "__main__":
    main()
