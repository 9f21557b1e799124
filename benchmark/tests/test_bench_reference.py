"""The plain reference against naive definitions and against the port's
own oracle (which the reference is a frozen copy of) at a small size."""

from dataclasses import asdict

import numpy as np
import pytest

from benchmark.reference import events, fm, params
from benchmark.reference.mapper import RefMapper, pore_model
from benchmark.traffic import genome as gen
from benchmark.traffic.reads import MODEL_NPZ, load_levels, make_read
from test_bench_traffic import MIX, REPEATS


@pytest.mark.parametrize("n", [1, 2, 7, 300])
def test_suffix_array_is_the_sorted_suffixes(n):
    rng = np.random.default_rng(n)
    text = rng.integers(0, 4, n).astype(np.uint8)
    if n == 300:
        text[100:200] = text[0:100]  # a long repeat
    sa = fm.suffix_array(text)
    want = sorted(range(n + 1), key=lambda i: list(text[i:]) + [-1])
    assert sa.tolist() == want


def test_extend_counts_occurrences():
    rng = np.random.default_rng(0)
    g = rng.integers(0, 4, 500).astype(np.uint8)
    text = fm.full_text(g)
    sa = fm.suffix_array(text)
    idx = fm.RefFM("g", len(g), text, sa, fm.bwt_of(text, sa))
    sfx = [tuple(text[i:]) for i in sa]
    for pattern in [(0,), (1, 2), (3, 3, 1), (2, 0, 1, 3)]:
        # backward search: the rows whose suffix starts with the pattern
        st, en = idx.L2[pattern[-1]] + 1, idx.L2[pattern[-1] + 1]
        for b in reversed(pattern[:-1]):
            st, en = idx.extend(st, en, b)
        want = [r for r, s in enumerate(sfx) if s[:len(pattern)] == pattern]
        assert list(range(st, en + 1)) == want


@pytest.fixture(scope="module")
def port_and_reference(tmp_path_factory):
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.index.build import build_index
    from uncalled_tpu_torch.index.parameterize import build_uncl
    from uncalled_tpu_torch.mapping.oracle import OracleMapper
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    d = tmp_path_factory.mktemp("ref")
    g = gen.realistic_genome(120_000, np.random.default_rng([11, 1]), REPEATS)
    gen.write_fasta(str(d / "g.fa"), "ecoli_sim", g)
    fmi = build_index(str(d / "g.fa"))
    build_uncl(fmi, str(d / "g"))
    th = load_uncl(str(d / "g.uncl"))
    conf = Conf()
    text = fm.full_text(g)
    sa = fm.suffix_array(text)
    idx = fm.RefFM("ecoli_sim", len(g), text, sa, fm.bwt_of(text, sa))
    prm = {k: asdict(getattr(conf, k)) for k in
           ("event_detector", "seed_tracker", "mapper", "reads", "index")}
    return dict(g=g, fmi=fmi, th=th, idx=idx, prm=prm,
                oracle=OracleMapper(fmi, load_default(), th, conf))


def test_index_and_thresholds_equal_the_ports(port_and_reference):
    p = port_and_reference
    assert np.array_equal(p["idx"].sa_full, p["fmi"].sa_full)
    assert np.array_equal(p["idx"].kmer_ranges, p["fmi"].kmer_ranges)
    th = params.bin_thresholds(params.fit_default(p["idx"], p["prm"]["index"]))
    assert np.array_equal(th, p["th"])


def test_model_equals_the_ports():
    from uncalled_tpu_torch.poremodel import load_default

    m, pm = pore_model(MODEL_NPZ), load_default()
    assert np.array_equal(m.means, pm.means)
    assert np.array_equal(m.vars_x2, pm.vars_x2)
    assert np.array_equal(m.lognorm_denoms, pm.lognorm_denoms)
    assert (m.means_mean, m.means_stdv) == (pm.means_mean, pm.means_stdv)


def test_events_equal_the_ports():
    from uncalled_tpu_torch.ops.events import detect_events_np

    g = gen.realistic_genome(50_000, np.random.default_rng([2, 1]), REPEATS)
    r = make_read(g, 9, 0, MIX, load_levels())
    means, total, len_sum = events.detect_events(r.signal, 0.0, 40000.0)
    ev = detect_events_np(r.signal, 0.0, 40000.0)
    assert np.array_equal(means, ev["mean"])
    assert (total, len_sum) == (ev["total_events"], ev["len_sum"])


def test_lines_equal_the_ports_oracle(port_and_reference):
    p = port_and_reference
    ref = RefMapper(p["idx"], pore_model(MODEL_NPZ), p["th"], p["prm"])
    lv = load_levels()
    mapped = 0
    for i in range(5):
        r = make_read(p["g"], 123, i, MIX, lv)
        want = p["oracle"].map_read(r)
        got = ref.map_read(r).to_line()
        assert got == want.to_line()
        mapped += want.is_mapped
    assert mapped >= 3
