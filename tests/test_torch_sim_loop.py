"""The simulated ReadUntil loop of the port on the CPU against the JAX
package's: ``ClientSim`` + ``RealtimeMapper`` + ``run_sim_loop`` on a
``SimClock`` (tests/test_realtime.py's sim case, cut to size), in deplete
and enrich mode.  The same reads go through both packages; every output
line, comments included, must be byte-identical once the wall-clock tags
(mt, qt, wt) are stripped, and so must the give-up records."""

import io

import pytest
import torch

from test_torch_realtime import REF_FA, assets, strip  # noqa: F401

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)


def _sim_conf(Conf):
    conf = Conf()
    conf.reads.num_channels = 2
    conf.engine.evt_block = 64
    conf.simulator.sim_speed = 1.0
    return conf


def _run_sim(pkg, assets, reads, deplete, device=None):
    """tests/test_realtime.py's sim case through package ``pkg``, at two
    channels, three reads and 20 simulated seconds (the reads cycle): the
    port's eager steps cost the CPU some 15-19 ms an event, so the JAX
    test's four channels, six reads and 120 s (8896 event steps) would take
    minutes here; chip_smoke.py phase 3 runs that case on the card."""
    if pkg == "jax":
        from uncalled_tpu.config import Conf
        from uncalled_tpu.realtime.clientsim import ClientSim
        from uncalled_tpu.realtime.mapper import RealtimeMapper
        from uncalled_tpu.realtime.sim import (SimClock, default_pattern,
                                               run_sim_loop)
        fmi, model, th = assets[1]
        kw = {}
    else:
        from uncalled_tpu_torch.config import Conf
        from uncalled_tpu_torch.realtime.clientsim import ClientSim
        from uncalled_tpu_torch.realtime.mapper import RealtimeMapper
        from uncalled_tpu_torch.realtime.sim import (SimClock,
                                                     default_pattern,
                                                     run_sim_loop)
        fmi, model, th = assets[0]
        kw = {"device": device}
    conf = _sim_conf(Conf)
    clock = SimClock()
    client = ClientSim(conf, clock=clock)
    total = sum(r.raw_len for r in reads)
    default_pattern(client, reads, duration_samples=total * 3, gap=2000)
    client.load_reads(reads)
    rt = RealtimeMapper(fmi, model, th, conf, P=1024, C=1024, R=64, CL=256,
                        **kw)
    buf = io.StringIO()
    run_sim_loop(client, rt, conf, deplete=deplete, out=buf, sleep=0.2,
                 clock=clock, max_wall=20.0)
    return [strip(l) for l in buf.getvalue().splitlines()], rt


@pytest.fixture(scope="module")
def sim_reads():
    from uncalled_tpu_torch.testing.simulate import simulate_reads

    reads = simulate_reads(REF_FA, 3, seed=21, read_len_bp=(800, 1500))
    for i, r in enumerate(reads):
        r.number = i + 1
    return reads


@pytest.mark.parametrize("deplete", [True, False], ids=["deplete", "enrich"])
def test_sim_loop_matches_jax(assets, sim_reads, deplete):
    got, rt = _run_sim("torch", assets, sim_reads, deplete, device="cpu")
    want, jrt = _run_sim("jax", assets, sim_reads, deplete)
    assert got == want
    assert rt.giveups == jrt.giveups
    lines = [l for l in got if not l.startswith("#")]
    mapped = [l for l in lines if "\t+\t" in l or "\t-\t" in l]
    assert len(lines) >= len(sim_reads) - 1 and len(mapped) >= 2
    for l in mapped:
        assert "Escherichia_coli_chromosome:2400000-2410000" in l
        # deplete ejects every mapped read, enrich keeps them
        assert ("ej:f:" in l) == deplete and ("kp:f:" in l) != deplete
