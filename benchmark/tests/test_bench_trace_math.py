"""The trace arithmetic on synthetic traces, and the byte counts on known
shapes."""

import pytest
import torch

from benchmark.harness import profile as pf
from benchmark.metrics import common
from benchmark.roofline import bytes as nb
from benchmark.roofline.kernels import family_of


def test_busy_union_merges_overlaps():
    assert pf.busy_union([]) == 0
    assert pf.busy_union([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    assert pf.busy_union([(3, 4), (0, 1)]) == 2


def test_idle_gaps_and_labels():
    gaps = pf.idle_gaps([(2, 4), (3, 6), (9, 10)], 0, 12)
    assert gaps == [(0, 2), (6, 3), (10, 2)]
    spans = [("advance", 0, 7), ("readout_wait", 5, 8)]
    assert pf.label_of(6.5, spans) == "readout_wait"  # the inner span
    assert pf.label_of(1, spans) == "advance"
    assert pf.label_of(11, spans) == "host loop"


def _ev(cat, name, ts, dur):
    return dict(cat=cat, name=name, ts=ts, dur=dur)


def test_summarize_synthetic_trace():
    spans = [("advance", 0, 100), ("readout_wait", 100, 150)]
    evs = [
        _ev("kernel", "void tracker_fold_kernel<1>(TrackerArgs)", 10, 20),
        _ev("kernel", "gather_cols_kernel", 20, 20),  # overlaps: union 30
        _ev("gpu_memcpy", "Memcpy DtoH", 120, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 5, 1),
    ]
    s = pf.summarize(evs, 200e-6, family_of, spans)
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["device_s"] == pytest.approx(50e-6)
    assert s["kernels"] == 2
    assert s["family_s"] == pytest.approx(dict(tracker_fold=20e-6,
                                               gather_cols=20e-6))
    # gaps: [0, 10) and [40, 100) in advance, [100, 120) and [130, 150) in
    # the readout
    gaps = dict(s["idle_gaps"])
    assert gaps["advance"] == pytest.approx(70e-6)
    assert gaps["readout_wait"] == pytest.approx(40e-6)
    assert s["device_ops"][0][1] == pytest.approx(20e-6)


def test_host_spans_go_on_the_trace_clock():
    evs = [_ev("kernel", "k", 5, 1),
           _ev("cuda_runtime", "cudaDeviceSynchronize", 1000, 20),
           _ev("cuda_runtime", "cudaDeviceSynchronize", 3000, 20)]
    # the first sync ran from 2.000000 to 2.000030 s on the host's clock
    off = pf.sync_offset_us(evs, 2.0, 2.00003)
    assert off == pytest.approx(1010 - 2000015)
    assert pf.sync_offset_us(evs[:1], 2.0, 2.1) is None


def test_calls_count_at_the_call_and_keep_only_indices():
    from benchmark.roofline import kernels as rk

    c = rk.Calls()
    a = torch.arange(10, dtype=torch.int32)
    b = torch.arange(10, dtype=torch.float32)
    idx = torch.tensor([1, 1, 3, 5, 5, 9], dtype=torch.int32)
    gather = c._wrap("gather_cols", rk._gather, lambda *a, **k: None)
    gather("flat_gather", [a, b], idx)
    pair = c._wrap("pair_counts", rk._shapes(nb.pair_counts),
                   lambda *a, **k: None)
    pair(torch.zeros(100, dtype=torch.int32),
         torch.zeros(100, dtype=torch.int32), 8, 16)
    # nothing of the columns is kept; the indices are
    assert all(k[3] is None or k[3][1] is idx for k in c.kept)
    got = c.tally()
    assert got["gather_cols"] == (nb.gather_cols([a, b], idx), 1)
    assert got["pair_counts"] == (800 + 512, 1)
    # indices written in place after the call: nothing to read
    gather("flat_gather", [a, b], idx)
    idx += 1
    assert c.tally()["gather_cols"][1] == 0


def test_roofline_and_step_arithmetic():
    rec = dict(B=4, T=8, window_s=2.0,
               counters=dict(disp_events=4 * 8 * 10, useful_events=160,
                             t_refill=0.5, n_handoff=0),
               spans={"advance": dict(seconds=0.3, calls=10),
                      "readout_wait": dict(seconds=0.1, calls=10)},
               profile=dict(calls=2, kernels=320, device_s=0.004,
                            busy_s=0.003, wall_s=0.01,
                            family_s=dict(gather_cols=1e-3, sort_net=1e-3),
                            family_bytes=dict(gather_cols=1.675e9,
                                              sort_net=0.335e9),
                            family_launches=dict(gather_cols=5, sort_net=2)))
    assert common.window_steps(rec) == 80
    assert common.stretch_steps(rec) == 16
    # (0.5 ms + 0.1 ms) of least time over 2 ms of device time
    assert common.roofline(rec) == pytest.approx(30.0)
    # a family launched without a byte count: nothing to read, never 0
    rec["profile"]["family_launches"]["pair_counts"] = 1
    assert common.roofline(rec) is None
    assert common.roofline(dict(rec, profile=None)) is None


def test_gather_bytes_on_known_shapes():
    # flat: 2 int32 columns of 10 rows, 6 indices of which 4 distinct
    a = torch.arange(10, dtype=torch.int32)
    b = torch.arange(10, dtype=torch.float32)
    idx = torch.tensor([1, 1, 3, 5, 5, 9], dtype=torch.int32)
    assert nb.gather_cols([a, b], idx) == 6 * 4 * 3 + 2 * 4 * 4
    # clamped indices count as the rows they read
    idx2 = torch.tensor([-3, 0, 20, 9], dtype=torch.int32)
    assert nb.gather_cols([a], idx2) == 4 * 4 * 2 + 2 * 4
    # segments: a bool column and a constant; rows 0-3 | 4-9
    s0, s1 = torch.ones(4, dtype=torch.bool), torch.zeros(6, dtype=torch.bool)
    idx3 = torch.tensor([0, 1, 1, 7], dtype=torch.int32)
    assert nb.gather_cols([[s0, s1], [a[:4], 5]], idx3) == (
        4 * 4 * 3 + (2 * 1 + 2 * 4) + 1 * 1)
    # per-row form: a [2, 10] per-row column and a shared one
    pr = torch.zeros(2, 10, dtype=torch.int32)
    idx4 = torch.tensor([[1, 1, 2], [1, 3, 3]], dtype=torch.int32)
    assert nb.gather_cols([pr, a], idx4, rows=True) == (
        6 * 4 * 3 + 4 * 4 + 3 * 4)
    # a packed [N, F] table: its F columns
    tbl = torch.zeros(10, 3, dtype=torch.int32)
    assert nb.gather_table([tbl], idx) == 6 * 4 * 4 + 4 * 3 * 4


def test_other_byte_counts():
    k = torch.zeros(100, dtype=torch.int32)
    assert nb.pair_counts(k, k, 8, 16) == 800 + 512
    ring = torch.zeros(50, 23)
    z = torch.zeros(50, dtype=torch.int32)
    assert nb.ring_assemble(ring, z, z, z.float(), z.bool()) == (
        50 * 23 * 8 + 50 * 13)
    st = dict(a=torch.zeros(4, 16, dtype=torch.int32),
              b=torch.zeros(4, dtype=torch.int32))
    rows = torch.tensor([3, 0, 5, 1], dtype=torch.int32)
    assert nb.tracker_fold(25, st, z, z, z, rows, rows) == (
        2 * (64 + 4) * 4 + 9 * 12 + 4 * 8)
    keys = [torch.zeros(100, dtype=torch.int32)] * 5
    assert nb.sort_runs(keys, 128, 64) == 5 * 228 * 4
    assert nb.merge_level(torch.zeros(5, 128, dtype=torch.int32), 2, 1) == (
        2 * 5 * 128 * 4)
