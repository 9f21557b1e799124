"""The port's simulated ReadUntil loop against the benchmark's plain
reference of it (``benchmark/reference/realtime.py``), line for line.

``run_sim_loop`` drives ``ClientSim`` and ``RealtimeMapper`` on the CPU
over eight channels of the ``ecoli_rt.enrich_zymo`` cell cut to a test's
size: a 100 kb target genome and a 100 kb genome the index does not hold,
half the reads from each, reads drawn as the channels need them, enrich
mode, ``max_chunks`` 3, T = 64 events a tick on the cell's 0.075-s
simulated clock.  Every decided read is then replayed alone by the
reference from the start sample the simulated pore gave it, and its line
must be the loop's, the wall-clock tags (mt, qt, wt) aside.  Four cases:
the cell's tick (a chunk's events arrive at once and drain over several
ticks), a tick whose T events drain less than the pore makes with no
backlog cap (the rolling normaliser's pushes and pops interleave, and its
scale moves under the queued events), a slow tick that sheds chunks at
the cell's backlog cap of 256 events, and the cell's tick on pools far
too small for the traffic, which the mapper must widen before any read
is cut."""

import io

import pytest
import torch

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)

CHANNELS = 8
POOL_S, POOL_CL = 2048, 64  # the "grow" case's first pools
CASES = {  # name: (tick s, T, max_event_backlog, simulated seconds, pools)
    "cell": (0.075, 64, 256, 5.0, {}),
    "backlog": (0.075, 16, 0, 5.0, {}),
    "shed": (0.3, 64, 256, 6.0, {}),
    "grow": (0.075, 64, 256, 5.0, dict(S=POOL_S, CL=POOL_CL)),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The cell's configuration at a test's size, the port's index and the
    reference's mapper of the same target genome."""
    from uncalled_tpu_torch.index.build import build_index
    from uncalled_tpu_torch.index.parameterize import build_uncl
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    from benchmark.drivers import readuntil
    from benchmark.harness.core import cell_files
    from benchmark.reference import fm, params
    from benchmark.reference.mapper import RefMapper, pore_model
    from benchmark.traffic import genome as gen
    from benchmark.traffic.reads import MODEL_NPZ

    cell, cfg = cell_files("ecoli_rt.enrich_zymo")
    cfg["genome"]["bp"] = cfg["off_target_genome"]["bp"] = 100_000
    cfg["conf"]["reads"]["num_channels"] = CHANNELS
    mix = dict(cell["params"], on_target=0.5, read_len_bp=[1000, 3000])
    target, other = readuntil.genomes(cfg)
    d = tmp_path_factory.mktemp("rt")
    gen.write_fasta(str(d / "g.fa"), cfg["genome"]["name"], target)
    fmi = build_index(str(d / "g.fa"))
    build_uncl(fmi, str(d / "g"))
    text = fm.full_text(target)
    sa = fm.suffix_array(text)
    idx = fm.RefFM(cfg["genome"]["name"], len(target), text, sa,
                   fm.bwt_of(text, sa))
    th = params.bin_thresholds(params.fit_default(idx, cfg["conf"]["index"]))
    return dict(cfg=cfg, mix=mix, target=target, other=other,
                port=(fmi, load_default(), load_uncl(str(d / "g.uncl"))),
                ref=RefMapper(idx, pore_model(MODEL_NPZ), th, cfg["conf"]))


def run_port(world, tick, T, backlog, seconds, pools=None, trace=False,
             patch=None):
    """The port's loop for ``seconds`` simulated seconds: (its decision
    lines, the pore's record of starts, the mapper, the tracer's
    snapshot and counts where ``trace``); the engine's first ``pools``
    (PoolParams sizes) and ``patch(mapper)`` where given."""
    from uncalled_tpu_torch import tracing
    from uncalled_tpu_torch.realtime.clientsim import ClientSim
    from uncalled_tpu_torch.realtime.mapper import RealtimeMapper
    from uncalled_tpu_torch.realtime.sim import SimClock, run_sim_loop

    from benchmark.drivers import readuntil
    from benchmark.traffic.zymo import MixedStream

    cfg = world["cfg"]
    conf = readuntil.make_conf(cfg)
    conf.engine.evt_block = T
    conf.realtime.max_event_backlog = backlog
    rt = RealtimeMapper(*world["port"], conf, device="cpu", **(pools or {}))
    if patch:
        patch(rt)
    clock = SimClock()
    client = ClientSim(conf, clock=clock)
    sr = conf.reads.sample_rate
    for ch in range(1, CHANNELS + 1):
        client.add_intv(ch, 0, 0, 1 << 60)
        client.add_gap(ch, 0, int(cfg["loop"]["gap_s"] * sr))
        client.add_delay(ch, 0, int(cfg["loop"]["eject_delay_s"] * sr))
    stream = MixedStream(world["target"], world["other"], 2**33 + 19,
                         world["mix"])
    client.set_read_source(lambda ch, k: next(stream))
    buf = io.StringIO()
    tracing.enable()  # empties the tracer
    if not trace:
        tracing.disable()
    try:
        run_sim_loop(client, rt, conf, deplete=False, out=buf, sleep=tick,
                     clock=clock, stop=lambda: clock.t >= seconds)
    finally:
        snap, counts = tracing.snapshot(), tracing.counts()
        tracing.disable()
    lines = [l for l in buf.getvalue().splitlines() if not l.startswith("#")]
    return lines, dict(client.started), rt, snap, counts


def reference_line(world, number, started, tick, T, backlog):
    from benchmark.drivers import readuntil
    from benchmark.reference import realtime
    from benchmark.traffic.reads import load_levels
    from benchmark.traffic.zymo import make_mixed_read

    rt = dict(readuntil.loop_settings(world["cfg"]), tick=tick, T=T,
              max_event_backlog=backlog)
    ch, start, _ = started[number]
    later = sorted((s, d) for n, (c, s, d) in started.items()
                   if c == ch and s > start)
    nxt = later[0] if later else (None, 0)
    r = make_mixed_read(world["target"], world["other"], 2**33 + 19, number,
                        world["mix"], load_levels())
    return realtime.replay(world["ref"], r, ch, start, rt, *nxt)


@pytest.fixture(scope="module", params=list(CASES))
def case(request, world):
    tick, T, backlog, seconds, pools = CASES[request.param]
    lines, started, rt, _, counts = run_port(world, tick, T, backlog,
                                             seconds, pools, trace=True)
    return request.param, lines, started, rt, counts


def test_lines_equal_the_reference(world, case):
    from benchmark.drivers.readuntil import number_of, strip

    name, lines, started, _, _ = case
    tick, T, backlog, _, _ = CASES[name]
    assert len(lines) >= CHANNELS // 2, lines
    numbers = [number_of(l) for l in lines]
    assert len(set(numbers)) == len(numbers)  # one line a read
    for n, line in zip(numbers, lines):
        assert strip(line) == reference_line(world, n, started, tick, T,
                                             backlog), line


def test_the_cases_do_what_they_are_for(world, case):
    """The cell's tick sheds nothing and keeps up; the backlog case queues
    more than T events; the slow tick sheds; each has kept and ended
    reads."""
    name, lines, _, rt, counts = case
    kinds = {l.split("\t")[-1][:2] for l in lines}
    assert {"kp", "en"} <= kinds, kinds
    shed = counts.get("rt_shed_chunks", 0)
    assert (shed > 0) == (name == "shed"), shed
    if name == "backlog":
        assert any(c.dsp is not None and c.dsp.norm.unread_size() > 16
                   for c in rt.channels)
    p = rt.eng.params
    assert not any(cut for _, cut, _ in rt.giveups)  # no read cut
    assert p.R == p.RT  # a read's seed rows capped by the batch's alone
    assert bool(rt.grows) == (name == "grow"), rt.grows
    if name == "grow":
        # both pools widened, and the state went over whole (the lines
        # above are the reference's)
        assert p.S > POOL_S and p.CL > POOL_CL, rt.grows
        assert counts.get("rt_grows") == len(rt.grows)
