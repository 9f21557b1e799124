"""The port's realtime commands against the JAX package's, in-process on the
CPU: ``sim`` (deplete and ``--enrich``) and ``map --ord`` on golden-derived
fast5 reads, and ``realtime`` through a stand-in MinKNOW connection (the
ONT ``read_until`` package is not installed).  ``sim`` and ``realtime``
run on the wall clock unless one is patched in: both runs here get a fresh
``SimClock`` as ``time.monotonic``, so each loop sees the same times.
Every output line must be byte-identical once the wall-clock tags (mt, qt,
wt) are stripped."""

import time

import numpy as np
import pytest
import torch

from test_live_client import FakeConnection, FakeReadUntil, _obj
from test_torch_cli import (CLI_READS, FX, PREFIX, both,  # noqa: F401
                            golden_fast5, strip)
from uncalled_tpu.__main__ import main as jmain
from uncalled_tpu_torch.__main__ import main as tmain

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def conf2(tmp_path_factory):
    """A --conf file for a two-channel flow cell."""
    path = tmp_path_factory.mktemp("conf") / "ch2.toml"
    path.write_text("[reads]\nnum_channels = 2\n")
    return str(path)


def _clocked(pkg, main, argv, monkeypatch, capsys):
    """stdout of one call with a fresh SimClock as time.monotonic."""
    if pkg == "jax":
        from uncalled_tpu.realtime.sim import SimClock
    else:
        from uncalled_tpu_torch.realtime.sim import SimClock
    with monkeypatch.context() as m:
        m.setattr(time, "monotonic", SimClock())
        main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("mode", ["deplete", "enrich"])
def test_sim_lines_equal_jax(golden_fast5, conf2, monkeypatch, capsys,  # noqa
                             mode):
    """6 simulated seconds (--duration is in hours) on two channels."""
    argv = ["sim", PREFIX, golden_fast5, "--conf", conf2,
            "--duration", str(6 / 3600)] + (
                ["--enrich"] if mode == "enrich" else [])
    got = _clocked("port", tmain, argv + ["--device", "cpu"], monkeypatch,
                   capsys)
    want = _clocked("jax", jmain, argv, monkeypatch, capsys)
    got = [strip(x) for x in got.splitlines()]
    assert got == [strip(x) for x in want.splitlines()]
    tag = "\tej:f:" if mode == "deplete" else "\tkp:f:"
    assert len(got) >= 2 and all(tag in x for x in got)


def test_map_ord_lines_equal_jax(golden_fast5, capsys):  # noqa: F811
    got, want = both(["map", PREFIX, golden_fast5, "--ord"], capsys)
    got = [strip(x) for x in got.splitlines()]
    assert got == [strip(x) for x in want.splitlines()]
    assert sorted(x.split("\t")[0] for x in got) == sorted(CLI_READS)


class ChunkFeed(FakeReadUntil):
    """A ReadUntil stand-in that plays int16 reads on two channels: one
    4000-sample chunk a channel every ``every`` polls, the next read once
    the mapper unblocks or stops receiving the current one, and the run
    ends ``tail`` polls after the last chunk."""

    def __init__(self, connection, reads, every=10, tail=100):
        super().__init__(connection)
        self.reads = reads  # channel -> [(read id, number, int16 raw)]
        self.pos = {ch: [0, 0] for ch in reads}
        self.every, self.tail, self.polls, self.idle = every, tail, 0, 0

    def get_read_chunks(self, batch_size=1, last=True):
        self.polls += 1
        if self.polls % self.every:
            return []
        out = []
        for ch, lst in self.reads.items():
            ri, ci = self.pos[ch]
            if ri < len(lst) and (ch, lst[ri][1]) in set(
                    self.unblocked + self.stopped):
                ri, ci = ri + 1, 0
            if ri >= len(lst):
                self.pos[ch] = [ri, ci]
                continue
            rid, num, raw = lst[ri]
            out.append((ch, _obj(raw_data=raw[ci: ci + 4000].tobytes(),
                                 number=num, chunk_start_sample=ci, id=rid)))
            ci += 4000
            self.pos[ch] = [ri + 1, 0] if ci >= len(raw) else [ri, ci]
        if not out:
            self.idle += 1
            self.is_running = self.idle * self.every < self.tail
        return out


def _realtime(pkg, main, conf2, monkeypatch, capsys, deplete, repair=False):
    """The realtime command with MinknowClient given the stand-in feed
    (the mux monitor set to ordinary sequencing, so ejects are allowed);
    ``repair`` gives the client the ``channels`` the loop reads."""
    if pkg == "jax":
        from uncalled_tpu.realtime import client as mod
    else:
        from uncalled_tpu_torch.realtime import client as mod
    sigs = np.load(f"{FX}/golden_reads.npz")
    reads = {1: [], 2: []}
    for i, rid in enumerate(CLI_READS[:4]):
        raw = np.rint(sigs[rid] * (8192.0 / 1402.0)).astype(np.int16)
        reads[i % 2 + 1].append((rid, i + 1, raw))
    feeds = []

    class Client(mod.MinknowClient):
        def __init__(self, conf, host, port, chunk_time):
            feeds.append(ChunkFeed(FakeConnection([mod.MK_PROCESSING]),
                                   reads))
            super().__init__(conf, host, port, chunk_time,
                             connection_factory=lambda: feeds[0])
            self.monitor.update([(1, 1), (2, 3)])
            if repair:  # the port's client has it; the JAX one does not
                self.channels = range(1, self.num_channels + 1)

    argv = ["realtime", PREFIX, "--conf", conf2] + (
        [] if deplete else ["--enrich"])
    if pkg == "port":
        argv += ["--device", "cpu"]
    with monkeypatch.context() as m:
        m.setattr(mod, "MinknowClient", Client)
        out = _clocked(pkg, main, argv, monkeypatch, capsys)
    return ([strip(x) for x in out.splitlines()], feeds[0].unblocked,
            feeds[0].stopped)


@pytest.mark.parametrize("mode", ["deplete", "enrich"])
def test_realtime_through_stand_in_connection(conf2, monkeypatch, capsys,
                                              mode):
    """The port's command runs the loop; the JAX command stops before it
    (its MinknowClient has no ``channels``) and, given them, prints the
    port's lines and makes the port's calls to the connection."""
    deplete = mode == "deplete"
    got = _realtime("port", tmain, conf2, monkeypatch, capsys, deplete)
    with pytest.raises(AttributeError, match="channels"):
        _realtime("jax", jmain, conf2, monkeypatch, capsys, deplete)
    want = _realtime("jax", jmain, conf2, monkeypatch, capsys, deplete,
                     repair=True)
    assert got == want
    lines, unblocked, stopped = got
    assert len(lines) == 4
    if deplete:
        assert len(unblocked) == 4 and all("\tej:f:" in x for x in lines)
    else:
        assert len(stopped) == 4 and all("\tkp:f:" in x for x in lines)
