"""`sim` subcommand: simulated ReadUntil run (reference scripts/uncalled:160-291).

Drives ClientSim + RealtimeMapper with the reference's per-read decision
rule: ended -> stop_receiving (en tag); (mapped XOR deplete) -> unblock if
ejectable else stop in-scan (ej/dl or mx tags); otherwise keep ->
stop_receiving (kp tag). Ejected reads are deduped per channel via the last
unblocked number.

Patterns come from `<prefix>_itvs/_gaps/_delays/_reads.txt` files (the
reference ClientSim::load_from_files format, client_sim.cpp:44-66) or, if
absent, a default full-run interval per channel with reads dealt round-robin.
"""

from __future__ import annotations

import os
import sys
import time

from .. import tracing
from ..config import Conf
from .clientsim import ClientSim


class SimClock:
    """Deterministic controllable clock for tests (monotonic seconds)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt: float):
        self.t += dt


def load_pattern_files(client: ClientSim, prefix: str) -> bool:
    """ClientSim::load_from_files equivalent; returns False if absent."""
    paths = {k: f"{prefix}_{k}.txt" for k in ("itvs", "gaps", "delays", "reads")}
    if not all(os.path.exists(p) for p in paths.values()):
        return False
    with open(paths["itvs"]) as f:
        for line in f:
            ch, i, st, en = line.split()
            client.add_intv(int(ch), int(i), int(st), int(en))
    with open(paths["gaps"]) as f:
        for line in f:
            ch, i, ln = line.split()
            client.add_gap(int(ch), int(i), int(ln))
    with open(paths["delays"]) as f:
        for line in f:
            ch, i, ln = line.split()
            client.add_delay(int(ch), int(i), int(ln))
    read_assign = []
    with open(paths["reads"]) as f:
        for line in f:
            ch, rd, offs = line.split()
            client.add_read(int(ch), rd, int(offs))
            read_assign.append(rd)
    return True


def default_pattern(client: ClientSim, reads, duration_samples: int,
                    gap: int = 4000, delay: int = 400):
    """No pattern files: every channel active for the whole run, reads dealt
    round-robin with a fixed inter-read gap and ejection delay."""
    n_ch = len(client.channels)
    used = set()
    for i, r in enumerate(reads):
        ch = (i % n_ch) + 1
        client.add_intv(ch, 0, 0, duration_samples)
        client.add_gap(ch, 0, gap)
        client.add_delay(ch, 0, delay)
        if ch not in used:
            used.add(ch)
        client.add_read(ch, r.id, 0)


def run_sim_loop(client: ClientSim, rt, conf: Conf, deplete: bool,
                 even: bool = False, odd: bool = False, duration: float = 0.0,
                 out=None, sleep=0.01, clock=None, max_wall: float = 0.0,
                 stop=None):
    """The shared realtime/sim decision loop. Returns emitted Paf count.

    ``stop``, where given, is called once a pass, after the pass's chunks
    are delivered and before the clock moves on; the loop ends when it
    returns true.  Each pass is an ``rt_loop.tick`` span of the tracer,
    made of ``rt_loop.update`` (the mapper's update and the decisions)
    and ``rt_loop.chunks`` (the chunks read and delivered); counters
    ``rt_ticks`` and ``rt_decisions.<kind>`` (kp, ej, mx, en)."""
    out = out or sys.stdout
    clock = clock or time.monotonic
    n_ch = len(client.channels)
    chunk_times = [clock() for _ in range(n_ch)]
    unblocked = [None] * n_ch
    end_time = duration * 60 * 60 if duration else float("inf")
    t_start = clock()
    n_out = 0

    client.run()
    while client.is_running():
        tick = tracing.span("rt_loop.tick")
        tracing.count("rt_ticks")
        t0 = clock()
        now = clock()
        sp = tracing.span("rt_loop.update")
        for ch, nm, paf in rt.update(now):
            t = now - chunk_times[ch - 1]
            if paf.ended:
                kind = "en"
                client.stop_receiving_read(ch, nm)
            elif (paf.is_mapped and deplete) or not (paf.is_mapped or deplete):
                if client.should_eject():
                    kind = "ej"
                    u = client.unblock_read(ch, nm)
                    if u is not None:
                        # sim only: the reference stamps dl just for the
                        # simulator (scripts/uncalled:228-233); the live
                        # client's unblock has no delay to report
                        paf.set_int("dl", u)
                    unblocked[ch - 1] = nm
                else:
                    kind = "mx"
                    client.stop_receiving_read(ch, nm)
            else:
                kind = "kp"
                client.stop_receiving_read(ch, nm)
            paf.set_float(kind, t)
            tracing.count("rt_decisions." + kind)
            out.write(paf.to_line() + "\n")
            n_out += 1
        sp.close()

        sp = tracing.span("rt_loop.chunks")
        batch = []
        for channel, chunk in client.get_read_chunks():
            if (even and channel % 2 == 1) or (odd and channel % 2 == 0):
                client.stop_receiving_read(channel, chunk.number)
                continue
            if unblocked[channel - 1] == chunk.number:
                out.write(f"# received chunk from {chunk.read_id} after unblocking\n")
                continue
            chunk_times[channel - 1] = clock()
            batch.append((channel, chunk))
        if batch:
            rt.add_chunks(batch, clock())
        sp.close()
        tick.close()

        if client.get_runtime() >= end_time:
            break
        if max_wall and clock() - t_start > max_wall:
            break
        if stop is not None and stop():
            break
        if hasattr(clock, "advance"):
            clock.advance(sleep or 0.01)  # deterministic test clock
        else:
            dt = clock() - t0
            if sleep and dt < sleep:
                time.sleep(sleep - dt)
    return n_out


def run_sim(args):
    """CLI entry (`python -m uncalled_tpu_torch sim`).  Like the JAX entry it
    builds its own Conf from ``--conf`` and leaves the reflected
    ``--<section>-<field>`` overrides unread; ``--duration`` is in hours."""
    from ..index.fmindex import load_index
    from ..io.fast5 import iter_reads
    from ..mapping.thresholds import load_uncl
    from ..poremodel import load_default
    from .mapper import RealtimeMapper

    conf = Conf()
    if getattr(args, "conf", None):
        conf.load_toml(args.conf)
    conf.simulator.sim_speed = args.sim_speed
    conf.engine.evt_block = args.evt_block

    fmi = load_index(args.bwa_prefix)
    threshes = load_uncl(args.bwa_prefix + ".uncl", args.idx_preset)
    reads = list(iter_reads(args.fast5s, recursive=args.recursive))
    sys.stderr.write(f"Loaded {len(reads)} reads\n")

    conf.simulator.ctl_seqsum = args.ctl_seqsum
    conf.simulator.unc_seqsum = args.unc_seqsum
    conf.simulator.unc_paf = args.unc_paf
    client = ClientSim(conf)
    if args.unc_seqsum and args.ctl_seqsum and args.unc_paf:
        from .sim_utils import load_sim

        load_sim(client, conf)
    elif not (args.unc_seqsum and load_pattern_files(client, args.unc_seqsum)):
        dur = sum(r.raw_len for r in reads) // max(len(client.channels), 1) * 2
        default_pattern(client, reads, max(dur, conf.reads.sample_rate * 60))
    client.load_reads(reads)

    rt = RealtimeMapper(
        fmi, load_default(), threshes, conf,
        P=args.max_paths, C=args.max_paths, R=args.seed_rows, CL=args.clusters,
        device=args.device,
    )
    deplete = not args.enrich
    n = run_sim_loop(
        client, rt, conf, deplete, even=args.even, odd=args.odd,
        duration=args.duration,
    )
    sys.stderr.write(f"Simulation done: {n} reads reported\n")
