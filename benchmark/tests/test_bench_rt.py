"""The ReadUntil cell's reference and driver on the CPU.

The reference's per-event stepper, fed a whole read's globally normalised
events, must give the frozen sequential reference's line; its streaming
detector, fed a read in chunks, the whole-signal detector's events; its
stall profiler and rolling normaliser, the port's on the same events.
Then the cell runs whole at a small size, sound and with the loop broken
underneath (the driver's control that pops the normaliser's events
newest first, and each tick's decisions given out a tick late): ``correct`` must hold for the
sound run and fail for each fault."""

import time

import numpy as np
import pytest
import torch

from benchmark.harness import core
from benchmark.reference import events, fm, params, realtime
from benchmark.reference.mapper import Paf, RefMapper, pore_model
from benchmark.traffic import genome as gen
from benchmark.traffic.reads import MODEL_NPZ, load_levels, make_read
from test_bench_traffic import MIX, REPEATS

F32 = np.float32

# one intra-op thread: several pytest workers side by side, each with a
# spinning torch thread pool, starve one another's engine steps
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref():
    from dataclasses import asdict

    from uncalled_tpu_torch.config import Conf

    g = gen.realistic_genome(120_000, np.random.default_rng([11, 1]), REPEATS)
    text = fm.full_text(g)
    sa = fm.suffix_array(text)
    idx = fm.RefFM("ecoli_sim", len(g), text, sa, fm.bwt_of(text, sa))
    prm = {k: asdict(getattr(Conf(), k)) for k in
           ("event_detector", "seed_tracker", "mapper", "reads", "index")}
    th = params.bin_thresholds(params.fit_default(idx, prm["index"]))
    other = gen.realistic_genome(120_000, np.random.default_rng([12, 1]),
                                 REPEATS)
    return g, other, RefMapper(idx, pore_model(MODEL_NPZ), th, prm)


@pytest.mark.parametrize("i", range(4))
def test_stepper_gives_the_sequential_references_line(ref, i):
    g, other, rm = ref
    r = make_read(g if i % 2 == 0 else other, 123, i, MIX, load_levels())
    want = rm.map_read(r).to_line()
    means, total, len_sum = events.detect_events(r.signal, 0.0, 40000.0)
    st = realtime.Stepper(rm)
    sc = None
    for e in events.normalize(means, rm.model.means_mean,
                              rm.model.means_stdv)[:rm.mp.max_events]:
        sc = st.step(e)
        if sc is not None:
            break
    p = Paf(r.id, r.channel, r.start_sample)
    p.rd_len = int(F32(F32(len(r.signal)) * F32(rm.bp_per_samp)))
    if sc is not None:
        rm._set_ref_loc(p, sc, st.event_i - 1, F32(len_sum) / F32(total))
    assert p.to_line() == want
    assert (sc is not None) == (i % 2 == 0)  # off-target reads never map


@pytest.mark.parametrize("chunk", [4000, 997])
def test_stream_detector_is_the_whole_signal_detector(ref, chunk):
    g = ref[0]
    r = make_read(g, 5, 1, MIX, load_levels())
    means, total, len_sum = events.detect_events(r.signal, 0.0, 40000.0)
    d = realtime.StreamDetector(0.0, 40000.0)
    got = []
    for a in range(0, len(r.signal), chunk):
        got += d.add(r.signal[a:a + chunk])
    assert np.array_equal(np.array(got, F32), means)
    assert (d.total_events, F32(d.len_sum)) == (total, len_sum)


def test_profiler_and_normaliser_are_the_ports():
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.realtime.signal import (EventProfiler,
                                                    StreamNormalizer)

    rng = np.random.default_rng(4)
    x = np.concatenate([rng.normal(90, 12, 300), np.full(60, 80.0),
                        rng.normal(95, 3, 300)]).astype(F32)
    x[400:420] += rng.normal(0, 0.5, 20).astype(F32)
    pe, pn = EventProfiler(), StreamNormalizer(64, 90.2, 12.1)
    qe, qn = realtime.Profiler(), realtime.RollingNorm(64, 90.2, 12.1)
    got, want = [], []
    for k, v in enumerate(x.tolist()):
        e = qe.add(v)
        if pe.add_event(v):
            assert e == pe.next_mean
            ok = pn.push(pe.next_mean)
            assert qn.ring.push(e) == ok
            if not ok:
                assert qn.ring.skip(3) == pn.skip_unread(3)
        else:
            assert e is None
        if k % 7 == 0:  # pop a few now and then
            for _ in range(5):
                if pn.empty():
                    assert qn.ring.empty
                    break
                want.append(pn.pop())
                got.append(qn.pop())
    assert len(got) > 100 and np.array_equal(np.array(got), np.array(want))
    assert Conf().normalizer.len == 6000


@pytest.fixture(scope="module")
def small():
    """The cell at a CPU test's size: 100 kb genomes, four channels, half
    the reads on target, 1-2 kb reads, the window open from the first
    tick (so that its decisions do not hang on the CPU's pace), every
    window decision compared."""
    cell, cfg = core.cell_files("ecoli_rt.enrich_zymo")
    cfg["genome"]["bp"] = cfg["off_target_genome"]["bp"] = 100_000
    cfg["index_cache"] = "ecoli_rt_test"
    cfg["conf"]["reads"]["num_channels"] = 4
    cfg["loop"]["start_spread_s"] = 1.0
    cell["params"].update(feed_reads=24, preroll_decisions=0, on_target=0.5,
                          read_len_bp=[1000, 2000])
    cell["params"]["check"].update(reads=64, workers=2)
    return cell, cfg


def run(small, patch=None, trace=0, seconds=60.0):
    cell, cfg = small
    line, unread = core.run_cell("ecoli_rt.enrich_zymo", 2**31 + 77, seconds,
                                 trace, time.time(), "cpu", cell=cell,
                                 config=cfg, patch=patch)
    return line, unread


def test_sound_run_is_correct(small):
    line, _ = run(small)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 2 and line["failed"] == 0
    assert line["reads"]["lost"] == 0
    assert set(line["metrics"]) == {"reads_per_s", "setup_s"}


def test_traced_run_reads_the_programs_metrics(small):
    """The program's spans and counters give the loop's and the engine's
    metrics; the device's need the card (and the CPU's profiled advance
    is slow, so this window is read for little more)."""
    line, unread = run(small, trace=1)
    assert line["correct"], line["checks"]
    assert {"rt_loop.realtime_factor.rt", "rt_loop.dsp_share.rt",
            "engine.ms_per_tick.rt", "feed.pull_share.rt"} <= set(
                line["metrics"])
    assert set(unread) <= {"engine.launches_per_step.rt",
                           "kernels.device_ms_per_step.rt",
                           "kernels.handwritten_roofline.rt",
                           "device.idle_share.rt",
                           "rt_loop.decide_share.rt"}


def decided_a_tick_late(rt):
    """Each tick's decisions come out with the next tick's."""
    orig = rt.update
    held = []

    def update(now):
        out, held[:] = list(held), orig(now)
        return out
    rt.update = update


@pytest.mark.parametrize("fault", ["newest_first", "decided_a_tick_late"])
def test_faults_make_correct_false(small, fault):
    """The driver's pop-order control and a late decision each break the
    line (its float32 control needs the cell's size to show, on the
    card)."""
    if fault == "decided_a_tick_late":
        patch = decided_a_tick_late
    else:
        patch = core.driver_of(small[0]).CONTROLS[fault]
    line, _ = run(small, patch)
    assert not line["correct"]
    assert line["checks"]["lines_differ"]["value"] > 0
