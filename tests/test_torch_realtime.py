"""The port's realtime layer on the CPU against the JAX package's: the
streaming DSP (``ChannelDSP``), ``RealtimeMapper`` under chunk-ordered
replay (``map_ordered``), backlog shedding, updates driven by hand, and
ClientSim's pattern files (the simulated ReadUntil loop is in
tests/test_torch_sim_loop.py).  The same reads and chunks go through
both packages; every PAF line must be byte-identical once the wall-clock
tags (mt, qt, wt) are stripped.  The JAX tests of the same cases
(tests/test_realtime.py) take the ``example_index`` fixture; these load the
in-repo BWA files instead."""

import os
import re

import numpy as np
import pytest
import torch

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")
REF_FA = PREFIX + ".fa"

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)

_WALL = re.compile(r"\t(mt|qt|wt):f:[^\t]*")


def strip(line: str) -> str:
    """A PAF line without its wall-clock timing tags."""
    return _WALL.sub("", line)


@pytest.fixture(scope="module")
def assets():
    from uncalled_tpu.index.bwa_compat import load_bwa_index as jload
    from uncalled_tpu.mapping.oracle import load_uncl as juncl
    from uncalled_tpu.poremodel import load_default as jmodel
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    port = (load_bwa_index(PREFIX), load_default(), load_uncl(PREFIX + ".uncl"))
    jax = (jload(PREFIX), jmodel(), juncl(PREFIX + ".uncl"))
    return port, jax


def test_channel_dsp_matches_jax_and_chunking():
    """The streaming DSP's normalized events equal JAX's at each chunking,
    and the event count entering the normalizer does not depend on it."""
    from uncalled_tpu.config import Conf as JConf
    from uncalled_tpu.realtime.signal import ChannelDSP as JDSP
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.realtime.signal import ChannelDSP

    g = np.load(os.path.join(FX, "golden_reads.npz"))
    sig = g["sim_0005_Escherichia_coli_3483_+"][:16000]
    streams = {}
    for cs in (2000, 4000):
        dsp, jdsp = ChannelDSP(Conf()), JDSP(JConf())
        outs = []
        for i in range(0, len(sig), cs):
            dsp.process_chunk(sig[i: i + cs])
            jdsp.process_chunk(sig[i: i + cs])
            got, want = dsp.pop_all(10000), jdsp.pop_all(10000)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
            outs.append(got)
        assert dsp.skipped == jdsp.skipped
        streams[cs] = np.concatenate(outs)
    a, b = streams[2000], streams[4000]
    assert len(a) == len(b) > 100
    np.testing.assert_allclose(a, b, atol=2.0)


def test_map_ordered_matches_jax(assets):
    """Chunk-ordered replay (tests/test_realtime.py's case): the same PAF
    lines as JAX's in the same order, and the truth rule met."""
    from uncalled_tpu.config import Conf as JConf
    from uncalled_tpu.mapping.ordered import map_ordered as jmap
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping.ordered import map_ordered
    from uncalled_tpu_torch.testing.simulate import simulate_reads

    reads = simulate_reads(REF_FA, 4, seed=31, read_len_bp=(900, 1600))
    for i, r in enumerate(reads):
        r.channel = (i % 2) + 1
        r.start_sample = 10000 * (i // 2) + 1
    conf, jconf = Conf(), JConf()
    conf.engine.evt_block = jconf.engine.evt_block = 64
    got = list(map_ordered(*assets[0], reads, conf, P=1024, C=1024, R=64,
                           CL=256, device="cpu"))
    want = list(jmap(*assets[1], reads, jconf, P=1024, C=1024, R=64,
                     CL=256))
    assert [strip(p.to_line()) for p in got] == \
        [strip(p.to_line()) for p in want]
    truth = {r.id: r for r in reads}
    n_ok = sum(1 for p in got if p.is_mapped and truth[p.rd_name].ref_start
               - 400 <= p.rf_st <= truth[p.rd_name].ref_end + 400)
    assert len({p.rd_name for p in got}) == 4 and n_ok >= 3


def test_backlog_shedding_matches_jax(assets):
    """Chunks flooding one channel are shed once its event backlog passes
    the cap, at the same chunks as in JAX; with the cap off nothing is
    shed."""
    from uncalled_tpu.config import Conf as JConf
    from uncalled_tpu.realtime.mapper import RealtimeMapper as JRT
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.realtime.mapper import RealtimeMapper

    g = np.load(os.path.join(FX, "golden_reads.npz"))
    sig = g["sim_0000_Escherichia_coli_3854_+"]

    class Ck:
        def __init__(self, number, s, start):
            self.number, self.signal, self.start = number, s, start
            self.read_id = f"rd{number}"

    step = 4000
    res = {}
    for cap in (64, 0):
        pair = []
        for cls, C, kw in ((RealtimeMapper, Conf, {"device": "cpu"}),
                           (JRT, JConf, {})):
            conf = C()
            conf.reads.num_channels = 2
            conf.realtime.max_event_backlog = cap
            assets_i = assets[0] if cls is RealtimeMapper else assets[1]
            rt = cls(*assets_i, conf, P=64, C=64, R=16, CL=32, **kw)
            for i in range(0, len(sig) - step, step):
                rt.add_chunks([(1, Ck(1, sig[i: i + step], i))],
                              now=float(i) / 4000)
            ch = rt.channels[0]
            pair.append((ch.shed_chunks, ch.dsp.norm.unread_size()))
        assert pair[0] == pair[1]
        res[cap] = pair[0]
    assert res[64][0] > 0 and res[64][1] < 64 + 700
    assert res[0][0] == 0 and res[0][1] > res[64][1]


def test_realtime_mapper_updates_match_jax(assets):
    """RealtimeMapper driven by hand: two channels, reads replaced
    mid-stream (ended unmapped), every update's emitted (channel, number,
    line) the same as JAX's."""
    from uncalled_tpu.config import Conf as JConf
    from uncalled_tpu.realtime.mapper import RealtimeMapper as JRT
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.realtime.mapper import RealtimeMapper

    g = np.load(os.path.join(FX, "golden_reads.npz"))
    rids = ["sim_0000_Escherichia_coli_3854_+", "noise_1",
            "sim_0002_Escherichia_coli_6254_+"]

    class Ck:
        def __init__(self, number, s, start, rid):
            self.number, self.signal, self.start = number, s, start
            self.read_id = rid

    def drive(cls, C, assets_i, kw):
        conf = C()
        conf.reads.num_channels = 2
        conf.engine.evt_block = 32
        rt = cls(*assets_i, conf, **kw)
        out = []
        for tick in range(14):
            batch = []
            # channel 1: read 0, then read 2 from tick 8 (read 0 replaced)
            rid, num = (rids[0], 1) if tick < 8 else (rids[2], 2)
            st = 4000 * (tick if tick < 8 else tick - 8)
            batch.append((1, Ck(num, g[rid][st: st + 4000], st, rid)))
            st = 4000 * tick
            if st < len(g[rids[1]]):
                batch.append((2, Ck(1, g[rids[1]][st: st + 4000], st,
                                    rids[1])))
            rt.add_chunks(batch, now=0.4 * tick)
            out += [(c, n, strip(p.to_line()))
                    for c, n, p in rt.update(0.4 * tick)]
        return out, rt.giveups

    got = drive(RealtimeMapper, Conf, assets[0], {"device": "cpu"})
    want = drive(JRT, JConf, assets[1], {})
    assert got == want
    assert any(n == 1 and c == 1 for c, n, _ in got[0])


def test_clientsim_pattern_files(tmp_path):
    """File-based pattern population (client_sim.cpp:44-208 formats), the
    port's ClientSim and sim loader against JAX's."""
    from uncalled_tpu.config import Conf as JConf
    from uncalled_tpu.realtime.clientsim import ClientSim as JCS
    from uncalled_tpu.realtime.sim import load_pattern_files as jload
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.realtime.clientsim import ClientSim
    from uncalled_tpu_torch.realtime.sim import load_pattern_files

    (tmp_path / "p_itvs.txt").write_text("1 0 0 5000\n2 0 100 4000\n")
    (tmp_path / "p_gaps.txt").write_text("1 0 250\n")
    (tmp_path / "p_delays.txt").write_text("2 0 400\n")
    (tmp_path / "p_reads.txt").write_text("1 rd_a 0\n2 rd_b 50\n")
    conf, jconf = Conf(), JConf()
    conf.reads.num_channels = jconf.reads.num_channels = 2
    cs, js = ClientSim(conf), JCS(jconf)
    assert cs.load_pattern_files(str(tmp_path / "p"))
    assert js.load_pattern_files(str(tmp_path / "p"))
    assert cs.channels[0].intvs[0].gaps == [250]
    assert cs.channels[1].intvs[0].delays == [400]
    for a, b in zip(cs.channels, js.channels):
        assert [(i.gaps, i.delays, list(i.bounds), i.active)
                for i in a.intvs] == [(i.gaps, i.delays, list(i.bounds),
                                       i.active) for i in b.intvs]
    cs2, js2 = ClientSim(conf), JCS(jconf)
    assert load_pattern_files(cs2, str(tmp_path / "p")) == \
        jload(js2, str(tmp_path / "p")) is True
    assert not ClientSim(conf).load_pattern_files(str(tmp_path / "missing"))
