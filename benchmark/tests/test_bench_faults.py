"""A whole run of the batch cell on the CPU at a small size, sound and
with the timed path broken underneath: ``correct`` must come out false
for each fault the cell can have.  (It has one chip, so no exchange
between chips to leave out.)"""

import time

import numpy as np
import pytest

from benchmark.drivers.batch import held_reads
from benchmark.harness import core
from benchmark.traffic.reads import Read

# what a CPU run cannot read: the device's trace
DEVICE_METRICS = {"engine.launches_per_step.batch",
                  "kernels.device_ms_per_step.batch",
                  "kernels.handwritten_roofline.batch",
                  "device.idle_share.batch"}


def run(small, patch=None, trace=0, seconds=20.0):
    cell, cfg = small
    line, unread = core.run_cell("ecoli_map.isolate", 2**31 + 99, seconds,
                                 trace, time.time(), "cpu", cell=cell,
                                 config=cfg, patch=patch)
    return line, unread


def test_sound_run_is_correct(small):
    line, unread = run(small, trace=1)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["checks"]["lines_differ"]["value"] == 0
    assert line["checks"]["reads_lost"]["value"] == 0
    r = line["reads"]
    assert r["pulled"] == r["yielded"] + r["held"] and r["lost"] == 0
    assert set(unread) <= DEVICE_METRICS
    names = set(line["metrics"])
    assert {"host_loop.slot_util.batch", "engine.ms_per_step.batch",
            "feed.pull_share.batch"} <= names
    assert 0 <= line["metrics"]["feed.pull_share.batch"]["value"] < 0.2
    assert list(line)[-1] == "checks"


def step_unchanged(bm):
    bm.eng.advance = lambda state, means, on, sb=None: state


def half_batch_left_out(bm):
    orig = bm.eng.advance

    def advance(state, means, on, sb=None):
        on = on.copy()
        on[len(on) // 2:] = False
        return orig(state, means, on) if sb is None else orig(
            state, means, on, sb=sb)
    bm.eng.advance = advance


def answer_altered(bm):
    orig = bm._finalize

    def finalize(slot, ro, b):
        paf = orig(slot, ro, b)
        if paf.is_mapped:
            paf.rf_st += 1
        return paf
    bm._finalize = finalize


def read_dropped(bm):
    """One read harvested and never yielded: the first after the
    pre-roll."""
    orig = bm._run
    B = bm.eng.params.B

    def _run(*a, **k):
        for i, paf in enumerate(orig(*a, **k)):
            if i != B:
                yield paf
    bm._run = _run


@pytest.mark.parametrize("fault", [step_unchanged, half_batch_left_out,
                                   answer_altered])
def test_fault_is_not_correct(small, fault):
    line, _ = run(small, patch=fault)
    assert not line["correct"]
    assert line["checks"]["lines_differ"]["value"] > 0


def test_dropped_read_is_not_correct(small):
    line, _ = run(small, patch=read_dropped)
    assert not line["correct"]
    assert line["checks"]["reads_lost"]["value"] == 1
    assert line["failed"] >= 1


def test_held_reads_finds_what_a_generator_holds():
    def rd(n):
        return Read(f"r{n:07d}", np.zeros(3, np.float32), n, 0, True)

    class Slot:
        def __init__(self, n):
            self.read = rd(n)

    def inner(it):
        slots = [Slot(1), None, Slot(2)]  # noqa: F841
        standby = {0: Slot(3)}  # a closure's cell
        eject = [(rd(4), 7, (1, 2))]  # noqa: F841

        def arm():
            return standby
        yield "x"

    def outer():
        queued = iter([rd(5), rd(6), rd(7)])
        next(queued)  # read 5 has gone in
        yield from inner(queued)

    def wrapper():
        for _, x in enumerate(outer()):
            yield x

    for gen in (outer(), wrapper()):
        next(gen)
        assert held_reads(gen, Read) == {1, 2, 3, 4, 6, 7}
        gen.close()
