"""The port's host copies for the simulated ReadUntil tooling against the
JAX package's: ``pafstats`` (parsing, truth comparison, the summary run),
``realtime/sim_utils`` (the pattern builder, held to
``fixtures/sim_utils_golden.json`` as tests/test_sim_utils.py holds the JAX
one) and ``realtime/yield_est`` (tests/test_yield_est.py's cases)."""

import io
import json
import os

import numpy as np
import pytest

from test_sim_utils import GOLDEN, RecordingClient, sim_files  # noqa: F401
from test_yield_est import bed_inputs  # noqa: F401


def _load_sim(mod, Conf, files):
    unc, ctl, paf = files
    conf = Conf()
    conf.simulator.unc_seqsum = unc
    conf.simulator.ctl_seqsum = ctl
    conf.simulator.unc_paf = paf
    conf.simulator.min_ch_reads = 2
    conf.simulator.sim_speed = 0.25
    client = RecordingClient(4)
    mod.load_sim(client, conf)
    return client.calls


def test_load_sim_matches_golden(sim_files):  # noqa: F811
    from uncalled_tpu.config import Conf as JConf
    from uncalled_tpu.realtime import sim_utils as jsu
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.realtime import sim_utils

    calls = _load_sim(sim_utils, Conf, sim_files)
    with open(GOLDEN) as f:
        assert calls == json.load(f)
    assert calls == _load_sim(jsu, JConf, sim_files)


def test_find_scans_synthetic(sim_files):  # noqa: F811
    from uncalled_tpu.realtime import sim_utils as jsu
    from uncalled_tpu_torch.realtime import sim_utils

    prof = sim_utils.SeqsumProfile(sim_files[0], num_channels=4)
    scans = sim_utils.find_scans(prof.sts, prof.ens, prof.mxs)
    assert len(scans) == 1
    st, en = scans[0]
    assert st < 101 and en > 124
    jp = jsu.SeqsumProfile(sim_files[0], num_channels=4)
    assert scans == jsu.find_scans(jp.sts, jp.ens, jp.mxs)


def test_est_genome_yield(bed_inputs, tmp_path):  # noqa: F811
    from uncalled_tpu.realtime.yield_est import est_genome_yield as jest
    from uncalled_tpu_torch.realtime.yield_est import est_genome_yield

    paf, _, seqsum = bed_inputs
    ann = tmp_path / "idx.ann"
    ann.write_text("10000 1 11\n0 ref\n0 10000 0\n")
    mm2 = tmp_path / "truth.paf"
    mm2.write_text(
        "read_0\t2000\t0\t2000\t+\tref\t10000\t0\t2000\t2000\t2000\t60"
        "\ttp:A:P\n"
        "read_1\t3000\t0\t3000\t+\tref\t10000\t0\t3000\t3000\t3000\t60"
        "\ttp:A:P\n"
        "read_2\t1500\t0\t1500\t+\tother\t9000\t0\t1500\t1500\t1500\t60"
        "\ttp:A:P\n"
    )
    for deplete in (False, True):
        out, jout = io.StringIO(), io.StringIO()
        r = est_genome_yield(paf, seqsum, str(mm2), str(tmp_path / "idx"),
                             deplete=deplete, sim_speed=0.5, out=out)
        jr = jest(paf, seqsum, str(mm2), str(tmp_path / "idx"),
                  deplete=deplete, sim_speed=0.5, out=jout)
        assert r == jr and out.getvalue() == jout.getvalue()
    r = est_genome_yield(paf, seqsum, str(mm2), str(tmp_path / "idx"),
                         deplete=False, sim_speed=0.5, out=io.StringIO())
    assert r["cnt_on_bp"] == pytest.approx(5000 / 1e6)
    salv = min(3000.0, 3000 / 3.8 * (1.0 + 0.1 + 0.3 - 0.2))
    assert r["unc_on_bp"] == pytest.approx((2000 + salv) / 1e6 / 0.5)


def test_est_bed_yield(bed_inputs):  # noqa: F811
    from uncalled_tpu.realtime.yield_est import est_bed_yield as jest
    from uncalled_tpu_torch.realtime.yield_est import est_bed_yield

    paf, bed, seqsum = bed_inputs
    out, jout = io.StringIO(), io.StringIO()
    r = est_bed_yield(paf, bed, seqsum, sim_speed=0.5, out=out)
    assert r == jest(paf, bed, seqsum, sim_speed=0.5, out=jout)
    assert out.getvalue() == jout.getvalue()
    assert r["cnt_on_bp"] == pytest.approx(2500 / 1e6)
    assert r["unc_total_bp"] > r["unc_on_bp"] > 0


PAFS = [
    "r0\t2000\t0\t450\t+\tchrA\t10000\t100\t550\t450\t450\t255\tmt:f:12.5",
    "r1\t1500\t30\t400\t-\tchrA\t10000\t5000\t5370\t370\t370\t255\tmt:f:8.0",
    "r2\t900\t*\t*\t*\t*\t*\t*\t*\t*\t*\t255",
    "r3\t800\t0\t300\t+\tchrB\t9000\t10\t310\t300\t300\t255\tmt:f:4.0",
    "r4\t700\t*\t*\t*\t*\t*\t*\t*\t*\t*\t255",
]
TRUTH = [
    "r0\t2000\t0\t2000\t+\tchrA\t10000\t80\t2080\t2000\t2000\t60",
    "r1\t1500\t0\t1500\t+\tchrA\t10000\t100\t1600\t1500\t1500\t60",
    "r2\t900\t0\t900\t+\tchrB\t9000\t0\t900\t900\t900\t60",
    "r4\t700\t*\t*\t*\t*\t*\t*\t*\t*\t*\t0",
]


@pytest.mark.parametrize("annotate", [False, True])
def test_pafstats_matches_jax(tmp_path, annotate):
    from uncalled_tpu import pafstats as jps
    from uncalled_tpu_torch import pafstats

    qry, ref = tmp_path / "q.paf", tmp_path / "t.paf"
    qry.write_text("\n".join(PAFS) + "\n")
    ref.write_text("\n".join(TRUTH) + "\n")
    got = [str(p) for p in pafstats.parse_paf(str(qry))]
    assert got == [str(p) for p in jps.parse_paf(str(qry))]
    groups = pafstats.paf_ref_compare(pafstats.parse_paf(str(qry)),
                                      pafstats.parse_paf(str(ref)))
    jgroups = jps.paf_ref_compare(jps.parse_paf(str(qry)),
                                  jps.parse_paf(str(ref)))
    assert [[p.qr_name for p in g] for g in groups] == \
        [[p.qr_name for p in g] for g in jgroups]
    # r0 right, r1 wrong place, r2 unmapped with truth, r3 no truth, r4 TN
    assert [[p.qr_name for p in g] for g in groups] == \
        [["r0"], ["r4"], ["r1"], ["r2"], ["r3"]]
    out, jout = io.StringIO(), io.StringIO()
    pafstats.run(str(qry), str(ref), annotate=annotate, out=out)
    jps.run(str(qry), str(ref), annotate=annotate, out=jout)
    assert out.getvalue() == jout.getvalue() and out.getvalue()
    entry = pafstats.PafEntry(PAFS[0])
    assert entry.ext_ref(1.5) == jps.PafEntry(PAFS[0]).ext_ref(1.5)
    assert entry.get_tag("mt") == jps.PafEntry(PAFS[0]).get_tag("mt")
