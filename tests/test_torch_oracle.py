"""The port's sequential oracle mapper equals the JAX package's: the PAF
line (and the reference's golden line) on the three FAST_SUBSET reads of
tests/test_oracle.py, in the stable and the introsort tie order, the
per-event stats, the seed tracker on seeded add_seed streams, the match
probabilities as raw bits and the FM bins -- on an index loaded from the
in-repo BWA files and on one built from the example FASTA.  The 14 golden
reads and the repeat-genome cases (the port's CPU BatchMapper, pooled and
classic, held to the port's oracle) are slow."""

import json
import os

import numpy as np
import pytest
import torch

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")

FAST_SUBSET = [
    "sim_0000_Escherichia_coli_3854_+",
    "sim_0002_Escherichia_coli_6254_+",
    "sim_0005_Escherichia_coli_3483_+",
]

torch.set_num_threads(1)


class Read:
    def __init__(self, id, signal):
        self.id = id
        self.signal = np.asarray(signal, dtype=np.float32)
        self.channel, self.number, self.start_sample = 1, 0, 0

    @property
    def raw_len(self):
        return len(self.signal)


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(FX, "golden_pafs.json")) as f:
        pafs = json.load(f)
    return pafs, np.load(os.path.join(FX, "golden_reads.npz"))


@pytest.fixture(scope="module")
def port():
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping.oracle import load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    return load_bwa_index(PREFIX), load_default(), load_uncl(PREFIX + ".uncl")


@pytest.fixture(scope="module")
def ref():
    from uncalled_tpu.index.bwa_compat import load_bwa_index
    from uncalled_tpu.mapping.oracle import load_uncl
    from uncalled_tpu.poremodel import load_default

    return load_bwa_index(PREFIX), load_default(), load_uncl(PREFIX + ".uncl")


def _mappers(port, ref, **kw):
    from uncalled_tpu.config import Conf as JConf
    from uncalled_tpu.mapping.oracle import OracleMapper as JOracle
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping.oracle import OracleMapper

    return OracleMapper(*port, Conf(), **kw), JOracle(*ref, JConf(), **kw)


def _same_run(m, j, rid, sig):
    """One read through both mappers: the lines, and everything the run
    leaves behind, equal."""
    line = m.map_read(Read(rid, sig)).to_line()
    assert line == j.map_read(Read(rid, sig)).to_line(), rid
    assert m.n_events_mapped == j.n_events_mapped
    assert m.stats == j.stats
    for k, v in j.last_events.items():
        np.testing.assert_array_equal(m.last_events[k], v, err_msg=k)
    return line


@pytest.mark.parametrize("rid", FAST_SUBSET)
def test_oracle_line_equals_jax_and_golden(port, ref, golden, rid):
    pafs, sigs = golden
    m, j = _mappers(port, ref, collect_stats=True)
    line = _same_run(m, j, rid, sigs[rid])
    assert line == pafs[rid], rid
    assert set(m.stats) == {"paths", "cands", "sources", "seed_groups",
                            "seed_rows", "clusters"}
    assert len(m.stats["paths"]) == m.n_events_mapped + 1


def test_introsort_tie_order(port, ref, golden):
    pafs, sigs = golden
    rid = FAST_SUBSET[0]
    m, j = _mappers(port, ref, tie_order="introsort", collect_stats=True)
    assert _same_run(m, j, rid, sigs[rid]) == pafs[rid]


def test_oracle_on_a_built_index(ref, golden):
    """An index built from the example FASTA (``build_index``: its own SA
    and ``sa_full``) gives the same line through both packages, and the
    golden one."""
    from uncalled_tpu.index.build import build_index as jbuild
    from uncalled_tpu_torch.index.build import build_index
    from uncalled_tpu_torch.mapping.oracle import load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    pafs, sigs = golden
    fmi, jfmi = build_index(PREFIX + ".fa"), jbuild(PREFIX + ".fa")
    np.testing.assert_array_equal(fmi.sa_full, jfmi.sa_full)
    th = load_uncl(PREFIX + ".uncl")
    m, j = _mappers((fmi, load_default(), th), (jfmi,) + ref[1:])
    rid = FAST_SUBSET[1]
    assert _same_run(m, j, rid, sigs[rid]) == pafs[rid]


def _streams(seed, n=3000):
    """add_seed arguments: a one-in-five true diagonal (22-long seeds, one
    cluster that decides) over a band of noise with jittered events, where
    clusters grow, merge and collide on their (ref_en_start, evt_en) set
    key."""
    rng = np.random.default_rng(seed)
    base = np.sort(rng.integers(0, 200, n))
    diag = rng.random(n) < 0.2
    evt = np.where(diag, base, base + rng.integers(-2, 1, n))
    ref_en = np.where(diag, 5000 + base, rng.integers(22, 60, n) + base // 4)
    ref_len = np.where(diag, 22, rng.integers(1, 23, n))
    return [(int(a), int(b), int(c)) for a, b, c in zip(ref_en, ref_len, evt)]


@pytest.mark.parametrize("seed", range(4))
def test_seed_tracker_equals_jax(seed):
    from uncalled_tpu.config import Conf as JConf
    from uncalled_tpu.mapping.oracle import SeedTracker as JTracker
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping.oracle import SeedTracker

    t, jt = SeedTracker(Conf().seed_tracker), JTracker(JConf().seed_tracker)
    lost = 0
    decided = 0
    for args in _streams(seed):
        a, ja = t.add_seed(*args), jt.add_seed(*args)
        assert vars(a) == vars(ja)
        lost += not any(c is a for c in t.clusters)
        assert [vars(c) for c in t.clusters] == [vars(c) for c in jt.clusters]
        assert t.all_lens == jt.all_lens and t.len_sum == jt.len_sum
        assert (t.max_map is None) == (jt.max_map is None)
        if t.max_map is not None:
            assert vars(t.max_map) == vars(jt.max_map)
        f, jf = t.get_final(), jt.get_final()
        assert (f is None) == (jf is None)
        if f is not None:
            assert vars(f) == vars(jf)
            decided += 1
    # the set-reinsertion case (oracle.py's "insertion failed") was hit,
    # and the tracker decided
    assert lost > 0 and decided > 0
    t.reset()
    assert t.clusters == [] and t.all_lens == [] and t.max_map is None


def test_match_probs_exact_bits():
    from uncalled_tpu.mapping.oracle import match_probs_exact as jmp
    from uncalled_tpu.poremodel import load_default as jload
    from uncalled_tpu_torch.mapping.oracle import match_probs_exact
    from uncalled_tpu_torch.poremodel import load_default

    m, jm = load_default(), jload()
    rng = np.random.default_rng(0)
    samps = np.concatenate([rng.normal(90, 15, 256).astype(np.float32),
                            np.float32([0, -1e-30, 1e30, 60.5])])
    for s in samps:
        with np.errstate(over="ignore"):  # 1e30: -inf in both, as f32
            got = match_probs_exact(s, m.means, m.vars_x2, m.lognorm_denoms)
            want = jmp(s, jm.means, jm.vars_x2, jm.lognorm_denoms)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_fm_bin():
    from uncalled_tpu.mapping.oracle import fm_bin as jbin
    from uncalled_tpu_torch.mapping.oracle import fm_bin

    vals = [0, 1, 2, 3] + [v for k in range(2, 63) for v in
                           ((1 << k) - 1, 1 << k, (1 << k) + 1)]
    assert [fm_bin(v) for v in vals] == [jbin(v) for v in vals]
    assert fm_bin(1) == 63 and fm_bin(np.int64(1 << 40)) == 23


def test_load_uncl_from_the_oracle():
    """Callers import load_uncl from the oracle module, as the JAX
    package's do; it is the one definition in mapping/thresholds."""
    from uncalled_tpu.mapping.oracle import load_uncl as jload
    from uncalled_tpu_torch.mapping import thresholds
    from uncalled_tpu_torch.mapping.oracle import load_uncl

    assert load_uncl is thresholds.load_uncl
    got, want = load_uncl(PREFIX + ".uncl"), jload(PREFIX + ".uncl")
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.slow
def test_oracle_golden_all(port, golden):
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping.oracle import OracleMapper

    pafs, sigs = golden
    m = OracleMapper(*port, Conf())
    for rid in pafs:
        assert m.map_read(Read(rid, sigs[rid])).to_line() == pafs[rid], rid


@pytest.fixture(scope="module")
def repeat_genome(tmp_path_factory):
    """tests/test_pooled.py's 120 kb repeat genome and three reads
    simulated with a mismatched signal model, through the port's copies."""
    from uncalled_tpu_torch.index.build import build_index
    from uncalled_tpu_torch.index.parameterize import build_uncl
    from uncalled_tpu_torch.mapping.oracle import load_uncl
    from uncalled_tpu_torch.testing.simulate import (
        realistic_genome,
        simulate_reads,
    )

    d = tmp_path_factory.mktemp("oracle_scale")
    fa = d / "ref.fa"
    seq = realistic_genome(120_000, seed=3)
    fa.write_text(">pool_ref\n" + "\n".join(
        seq[i: i + 80] for i in range(0, len(seq), 80)) + "\n")
    fmi = build_index(str(fa))
    threshes = load_uncl(build_uncl(fmi, str(fa)[:-3]))
    reads = simulate_reads(str(fa), 3, seed=17, read_len_bp=(1200, 2200),
                           mismatch=True)
    return fmi, threshes, reads


@pytest.fixture(scope="module")
def repeat_oracle_lines(repeat_genome):
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping.oracle import OracleMapper
    from uncalled_tpu_torch.poremodel import load_default

    fmi, threshes, reads = repeat_genome
    oracle = OracleMapper(fmi, load_default(), threshes, Conf())
    return {r.id: oracle.map_read(r).to_line() for r in reads}


@pytest.mark.slow
@pytest.mark.parametrize("pooled", [True, False], ids=["pooled", "classic"])
def test_batch_mapper_equals_oracle_on_repeat_genome(
        repeat_genome, repeat_oracle_lines, pooled):
    """tests/test_pooled.py::test_pooled_matches_oracle_on_repeat_genome
    and tests/test_engine_scale.py through the port: engine line ==
    oracle line where the per-read budgets bind."""
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.poremodel import load_default

    fmi, threshes, reads = repeat_genome
    conf = Conf()
    conf.engine.batch_reads = 3
    conf.engine.evt_block = 16
    conf.engine.pooled = pooled
    kw = dict(CL=2048)
    if pooled:
        conf.engine.pool_slots_per_read = 2048
    else:
        kw.update(P=10000, C=10000, R=512)
    bm = BatchMapper(fmi, load_default(), threshes, conf, device="cpu", **kw)
    got = {p.rd_name: p.to_line() for p in bm.map_reads(reads)}
    if pooled:
        assert bm.ovf_why == {}, bm.ovf_why
    for rid, want in repeat_oracle_lines.items():
        assert got[rid] == want, rid
