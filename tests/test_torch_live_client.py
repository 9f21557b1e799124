"""The port's live MinKNOW client (``uncalled_tpu_torch/realtime/client.py``)
through tests/test_live_client.py's stand-in ReadUntil connection: the
wait for the run with the chunk-length push, the mid-run refusal, the mux
scan that suppresses ejections, the channel-state thread, chunk dtype
dispatch and the fast5 calibration's u16 wrap; each case also against the
JAX package's client where both give a value."""

import numpy as np
import pytest

from test_live_client import FakeConnection, FakeReadUntil, _obj
from uncalled_tpu.realtime import client as jcl
from uncalled_tpu_torch.config import Conf
from uncalled_tpu_torch.realtime.client import (
    MK_PROCESSING, MK_READY, MK_STARTING, RN_RUNNING, RN_STARTING,
    MinknowClient, MuxScanMonitor, calibrate_fast5, chunk_signal_f32,
)


def make_client(statuses, chunk_len=1.0, n_ch=8):
    conf = Conf()
    conf.reads.num_channels = n_ch
    conn = FakeConnection(statuses, chunk_len)
    fake = FakeReadUntil(conn)
    cl = MinknowClient(conf, "h", 8000, chunk_time=1.0,
                       connection_factory=lambda: fake)
    return cl, fake, conn


def test_run_state_enums_match_jax():
    assert (MK_READY, MK_STARTING, MK_PROCESSING) == (
        jcl.MK_READY, jcl.MK_STARTING, jcl.MK_PROCESSING)
    assert (RN_STARTING, RN_RUNNING) == (jcl.RN_STARTING, jcl.RN_RUNNING)


def test_wait_for_start_configures_chunk_len():
    """STARTING -> chunk length pushed; PROCESSING dwell -> ready."""
    cl, fake, conn = make_client(
        [MK_READY, MK_STARTING, MK_PROCESSING, MK_PROCESSING], chunk_len=0.5)
    t = [0.0]

    def sleep(dt):
        t[0] += 5.0

    assert cl.wait_for_start(steady=10, refresh=0.01, clock=lambda: t[0],
                             sleep=sleep)
    assert conn.analysis_configuration.set_calls == 1
    assert (conn.analysis_configuration.cfg
            .read_detection.break_reads_after_seconds.value == 1.0)


def test_wait_for_start_rejects_midrun_change(capsys):
    """Already PROCESSING with a different chunk length -> refuse."""
    cl, fake, conn = make_client([MK_PROCESSING], chunk_len=0.5)
    assert cl.wait_for_start() is False
    assert conn.analysis_configuration.set_calls == 0
    assert "cannot set chunk size mid-run" in capsys.readouterr().err


def test_wait_for_start_ok_when_chunk_len_matches():
    cl, fake, conn = make_client([MK_PROCESSING], chunk_len=1.0)
    assert cl.wait_for_start() is True


def test_mux_scan_suppresses_ejects():
    mon, jmon = MuxScanMonitor(8, 0.99), jcl.MuxScanMonitor(8, 0.99)
    assert mon.in_scan and jmon.in_scan  # conservative default
    for states, want in (([(c, 1 + (c % 4)) for c in range(1, 9)], False),
                         ([(c, 2) for c in range(1, 9)], True),
                         ([(c, 1 + (c % 4)) for c in range(1, 9)], False),
                         ([(1, 0), (2, 0), (3, 3)], False),
                         ([(c, 0) for c in range(1, 9)], False)):
        mon.update(states)
        jmon.update(states)
        assert mon.in_scan is jmon.in_scan is want
        np.testing.assert_array_equal(mon.mux_counts, jmon.mux_counts)
        np.testing.assert_array_equal(mon.ch_mux, jmon.ch_mux)


def test_should_eject_follows_monitor():
    cl, fake, conn = make_client([MK_PROCESSING])
    cl.monitor.update([(c, 3) for c in range(1, 9)])
    assert cl.should_eject() is False
    cl.monitor.update([(c, 1 + (c % 4)) for c in range(1, 9)])
    assert cl.should_eject() is True


def test_monitor_thread_consumes_states_and_stops():
    cl, fake, conn = make_client([MK_PROCESSING, MK_PROCESSING, MK_READY])
    conn.state_batches = [
        [(c, 2) for c in range(1, 9)],  # scan
        [(c, 1 + (c % 4)) for c in range(1, 9)],  # spread -> not scan
    ]
    cl._start_monitor()
    cl._mon_thread.join(timeout=5)
    assert not cl._mon_thread.is_alive()
    assert cl.monitor.in_scan is False


def test_chunk_dtype_dispatch():
    cases = ((np.array([-3, 10, 1000], np.int16), "int16"),
             (np.array([1.5, -2.25], np.float32), "float32"),
             (np.array([70000, -5], np.int32), "int32"))
    for arr, dt in cases:
        got = chunk_signal_f32(arr.tobytes(), dt)
        # ints pass through numerically (the reference leaves calibration
        # commented out, chunk.cpp:33-45)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, arr.astype(np.float32))
        np.testing.assert_array_equal(
            got.view(np.uint32),
            jcl.chunk_signal_f32(arr.tobytes(), dt).view(np.uint32))
    with pytest.raises(ValueError):
        chunk_signal_f32(b"", "uint8")


def test_get_read_chunks_decodes():
    cl, fake, conn = make_client([MK_PROCESSING])
    sig = np.array([1, 2, 3], np.int16)
    fake._chunks = [(3, _obj(raw_data=sig.tobytes(), number=7,
                             chunk_start_sample=100, id="r1"))]
    (ch, chunk), = cl.get_read_chunks()
    assert ch == 3 and chunk.number == 7 and chunk.read_id == "r1"
    assert chunk.start == 100 and chunk.channel == 3
    np.testing.assert_array_equal(chunk.signal, [1.0, 2.0, 3.0])
    assert cl.unblock_read(3, 7) is None
    assert fake.unblocked == [(3, 7)]
    cl.stop_receiving_read(3, 8)
    assert fake.stopped == [(3, 8)]


def test_run_and_runtime_without_start_wait():
    cl, fake, conn = make_client([MK_PROCESSING])
    assert cl.get_runtime() == 0.0
    assert cl.run(steady_wait=0.0, refresh=0.0) is True
    assert cl.is_running() and cl.get_runtime() >= 0.0
    cl.reset()
    assert cl._mon_thread is None


def test_calibrate_fast5_u16_wrap():
    """read_buffer.cpp:239 loops `for (u16 raw : int_data)`: signed
    samples reinterpret as u16 before calibration."""
    raw = np.array([-3, 5, -32768, 32767], np.int16)
    out = calibrate_fast5(raw, digitisation=8192.0, range_=1402.0,
                          offset=10.0)
    want_m3 = np.float32(1402.0 * (65533.0 + 10.0) / 8192.0)
    want_5 = np.float32(1402.0 * (5.0 + 10.0) / 8192.0)
    np.testing.assert_allclose(out[:2], [want_m3, want_5], rtol=0)
    jout = jcl.calibrate_fast5(raw, digitisation=8192.0, range_=1402.0,
                               offset=10.0)
    np.testing.assert_array_equal(out.view(np.uint32), jout.view(np.uint32))
