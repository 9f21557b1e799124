"""The port's oracle on the 7 tie reads (tests/test_tie_parity.py's four
cases): the stable tie order gives the stable reference build's lines
(tie_pafs.json), the introsort order the libstdc++ std::sort build's
(tie_pafs_stdsort.json), ``mt`` tags stripped.

Requires the bench index (bench_data/rgen_4700000.*, built by bench.py);
skipped when absent, as tests/test_tie_parity.py is.  Short reads run in
the default gate; long ones are slow.  On the card machine chip_smoke.py
runs all 7 in both orders on the same genome (its phase 10)."""

import json
import os

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PREFIX = os.path.join(REPO, "bench_data", "rgen_4700000")

FAST = ["sim_0545_bench_ref_4295489_+", "sim_0731_bench_ref_302488_+"]
SLOW = [
    "sim_0214_bench_ref_4050919_-",
    "sim_0364_bench_ref_3184616_-",
    "sim_0631_bench_ref_1571287_+",
    "sim_0661_bench_ref_4308092_-",
    "sim_0715_bench_ref_1685755_+",
]

torch.set_num_threads(1)

needs_bench_index = pytest.mark.skipif(
    not os.path.exists(PREFIX + ".utidx.npz"),
    reason="bench index not built (run bench.py once)",
)


def _oracle(tie_order):
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.index.fmindex import load_index
    from uncalled_tpu_torch.mapping.oracle import OracleMapper, load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    return OracleMapper(load_index(PREFIX), load_default(),
                        load_uncl(PREFIX + ".uncl"), Conf(),
                        tie_order=tie_order)


@pytest.fixture(scope="module")
def oracle_stable():
    return _oracle("stable")


@pytest.fixture(scope="module")
def oracle_introsort():
    return _oracle("introsort")


class _Read:
    def __init__(self, id, signal):
        self.id, self.signal = id, signal
        self.channel, self.number, self.start_sample = 1, 0, 0

    @property
    def raw_len(self):
        return len(self.signal)


def _check(oracle, rid, fixture):
    d = np.load(os.path.join(HERE, "fixtures", "tie_reads.npz"))
    with open(os.path.join(HERE, "fixtures", fixture)) as f:
        want = json.load(f)[rid]
    sig = np.asarray(d[rid], np.float32)
    line = oracle.map_read(_Read(rid, sig)).to_line()

    def strip(s):
        return "\t".join(t for t in s.split("\t") if not t.startswith("mt:"))

    assert strip(line) == strip(want)


@needs_bench_index
@pytest.mark.parametrize("rid", FAST)
def test_stable_build_fast(oracle_stable, rid):
    _check(oracle_stable, rid, "tie_pafs.json")


@needs_bench_index
@pytest.mark.slow
@pytest.mark.parametrize("rid", SLOW)
def test_stable_build_slow(oracle_stable, rid):
    _check(oracle_stable, rid, "tie_pafs.json")


@needs_bench_index
@pytest.mark.parametrize("rid", FAST)
def test_unstable_build_fast(oracle_introsort, rid):
    _check(oracle_introsort, rid, "tie_pafs_stdsort.json")


@needs_bench_index
@pytest.mark.slow
@pytest.mark.parametrize("rid", SLOW)
def test_unstable_build_slow(oracle_introsort, rid):
    _check(oracle_introsort, rid, "tie_pafs_stdsort.json")
