"""The port's debug taps and dumps against the JAX package's: the classic
step's ``dbg`` dict (``advance_block(..., debug=True)``) on every key after
every event, ``dump_read``'s three files byte for byte, ``DebugParser`` on
them, and the basecall-comparison helpers (``cigar_query_to_refs``,
``bc_aln_from_moves``, ``compare_seeds_to_basecall``)."""

import os

import numpy as np
import pytest
import torch

from test_torch_classic_step import _eq, _eq_state, _golden_events, _t

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")
RID = "sim_0000_Escherichia_coli_3854_+"
# events dumped: the read decides near event 50 of its 6216; the full read
# on the port's CPU steps at P=2048 would take a minute
DUMP_EVENTS = 256

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)


class Read:
    def __init__(self, id, signal):
        self.id = id
        self.signal = np.asarray(signal, dtype=np.float32)
        self.channel, self.number, self.start_sample = 1, 0, 0

    @property
    def raw_len(self):
        return len(self.signal)


@pytest.mark.parametrize(
    "rids,budgets,NE",
    [
        # budgets that hold these reads (one of them decides)
        (("sim_0000_Escherichia_coli_3854_+",
          "sim_0001_Escherichia_coli_3623_-", "noise_1"),
         dict(P=256, C=256, CE=0, R=64, CL=64), 48),
        # budgets that trip every overflow bit
        (("sim_0007_Escherichia_coli_7193_+",
          "f41a60f7-de4a-4b17-9f54-387e52d60b65", "noise_1"),
         dict(P=48, C=40, CE=56, R=1, CL=2), 40),
    ],
    ids=["fits", "overflows"],
)
def test_debug_taps_match_jax_every_event(rids, budgets, NE):
    import jax

    from uncalled_tpu.index.bwa_compat import load_bwa_index
    from uncalled_tpu.mapping import engine as je
    from uncalled_tpu.mapping.oracle import load_uncl
    from uncalled_tpu.poremodel import load_default

    from uncalled_tpu_torch.convert import index_from_numpy
    from uncalled_tpu_torch.mapping import engine as te

    B = len(rids)
    means = np.zeros((B, NE), np.float32)
    on = np.zeros((B, NE), bool)
    for b, e in enumerate(_golden_events(rids)):
        m = e[:NE]
        means[b, : len(m)] = m
        on[b, : len(m)] = True
    jpp = je.EngineParams(B=B, mxu=False, **budgets)
    tpp = te.EngineParams(B=B, **budgets)
    idx = je.device_index(load_bwa_index(PREFIX), load_uncl(PREFIX + ".uncl"),
                          load_default())
    tabs = {k: v for k, v in idx.items() if not isinstance(v, int)}
    meta = {k: v for k, v in idx.items() if isinstance(v, int)}
    adv = jax.jit(lambda s, m, o, t: je.advance_block(
        dict(t, **meta), jpp, s, m, o, debug=True))
    tidx = index_from_numpy({k: (v if isinstance(v, int) else np.asarray(v))
                             for k, v in idx.items()})
    all_on = np.ones(B, bool)
    js = je.reset_rows(je.make_state(jpp), jax.numpy.asarray(all_on))
    ts = te.reset_rows(te.make_state(tpp), _t(all_on))
    js, jd = adv(js, means, on, tabs)
    ts, td = te.advance_block(tidx, tpp, ts, _t(means), _t(on), debug=True)
    assert set(td) == set(jd)
    for k in jd:
        # [T, B, ...]: every key after every event
        _eq(jd[k], td[k], f"dbg {k}")
    _eq_state(js, ts, "after the block")
    d = {k: v.numpy() for k, v in td.items()}
    assert (d["seed_ref_en"] >= 0).any() and (d["n_paths"] > 0).any()
    assert ((d["p_parent"] < tpp.P) & (d["p_total"] > 0)).any()
    # the taps cost nothing unless asked: the production step's state is
    # the debug step's
    ts2 = te.reset_rows(te.make_state(tpp), _t(all_on))
    _eq_state({k: v.numpy() for k, v in ts.items()},
              te.advance_block(tidx, tpp, ts2, _t(means), _t(on)),
              "debug=False")


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """dump_read of one golden read by both packages (conf defaults, B=1:
    the pooled entry, so both build the wide classic engine for the
    dump)."""
    from uncalled_tpu.config import Conf as JConf
    from uncalled_tpu.debug import dump_read as jdump
    from uncalled_tpu.index.bwa_compat import load_bwa_index as jbwa
    from uncalled_tpu.mapping.batch import BatchMapper as JBM
    from uncalled_tpu.mapping.oracle import load_uncl as juncl
    from uncalled_tpu.poremodel import load_default as jmodel

    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.debug import dump_read
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index
    from uncalled_tpu_torch.mapping.batch import BatchMapper
    from uncalled_tpu_torch.mapping.thresholds import load_uncl
    from uncalled_tpu_torch.poremodel import load_default

    sig = np.load(os.path.join(FX, "golden_reads.npz"))[RID]
    tmp = tmp_path_factory.mktemp("dbg")
    conf, jconf = Conf(), JConf()
    conf.engine.batch_reads = jconf.engine.batch_reads = 1
    bm = BatchMapper(load_bwa_index(PREFIX), load_default(),
                     load_uncl(PREFIX + ".uncl"), conf, device="cpu")
    jbm = JBM(jbwa(PREFIX), jmodel(), juncl(PREFIX + ".uncl"), jconf)
    got = dump_read(bm, Read(RID, sig), str(tmp / "t_"),
                    max_events=DUMP_EVENTS)
    want = jdump(jbm, Read(RID, sig), str(tmp / "j_"),
                 max_events=DUMP_EVENTS)
    return tmp, got, want


def test_dump_read_files_match_jax(dumps):
    tmp, (paf, n_rows), (jpaf, jn_rows) = dumps
    assert paf.to_line() == jpaf.to_line() and n_rows == jn_rows
    for suffix in ("_events.tsv", "_seeds.bed", "_paths.tsv"):
        a = (tmp / f"t_{RID}{suffix}").read_bytes()
        b = (tmp / f"j_{RID}{suffix}").read_bytes()
        assert a == b, suffix
    assert paf.is_mapped and n_rows >= 5


def test_debug_parser_on_the_dump(dumps):
    """tests/test_realtime.py's dump-and-parse case on the port's dump."""
    from uncalled_tpu.debug import DebugParser as JParser

    from uncalled_tpu_torch.debug import DebugParser

    tmp, (paf, _), _ = dumps
    dp = DebugParser(str(tmp / "t_"), RID)
    jp = JParser(str(tmp / "t_"), RID)
    assert dp.seeds == jp.seeds and dp.paths == jp.paths
    np.testing.assert_array_equal(dp.events, jp.events)
    assert len(dp.events) > 20
    clusters = dp.seed_clusters()
    assert clusters == jp.seed_clusters()
    top = clusters[0]
    assert top["name"] == paf.rf_name and abs(top["st"] - paf.rf_st) < 200
    deep = max(dp.paths, key=lambda k: dp.paths[k]["full_len"])
    chain = dp.path_ancestry(*deep)
    assert chain == jp.path_ancestry(*deep)
    assert len(chain) >= min(dp.paths[deep]["full_len"], 10)
    for (evt, _), row in chain[:-1]:
        assert row["parent"][0] == evt - 1
    root_key, root = chain[-1]
    assert root["parent"] == root_key or root["full_len"] == 1


def test_cigar_query_to_refs_and_compare(dumps, tmp_path):
    from uncalled_tpu.debug import compare_seeds_to_basecall as jcmp
    from uncalled_tpu.debug import cigar_query_to_refs as jcig

    from uncalled_tpu_torch.debug import (DebugParser, cigar_query_to_refs,
                                          compare_seeds_to_basecall)
    from uncalled_tpu_torch.pafstats import PafEntry

    line = ("q1\t100\t0\t100\t+\tref\t10000\t500\t600\t90\t100\t60\t"
            "cg:Z:50M2D30M1I19M")
    m = cigar_query_to_refs(PafEntry(line))
    assert m == jcig(PafEntry(line))
    assert m[0] == [0] and m[49] == [49] and m[50] == [50, 52]
    assert m[79] == [81] and m[80] == [82] and m[81] == [82]
    rev = line.replace("\t+\t", "\t-\t")
    assert cigar_query_to_refs(PafEntry(rev)) == jcig(PafEntry(rev))

    tmp, (paf, _), _ = dumps
    dp = DebugParser(str(tmp / "t_"), RID)
    qlen = paf.rd_len
    bc = tmp_path / "bc.paf"
    bc.write_text(
        f"{RID}\t{qlen}\t0\t{qlen}\t+\t{paf.rf_name}\t10000\t"
        f"{max(paf.rf_st - 20, 0)}\t{paf.rf_en}\t{qlen}\t{qlen}\t60\t"
        f"cg:Z:{qlen}M\n")
    rows, summary = compare_seeds_to_basecall(dp, str(bc), RID)
    assert (rows, summary) == jcmp(dp, str(bc), RID)
    assert summary["n_scored"] > 0 and summary["frac_within_100"] > 0.5


def test_bc_aln_from_moves_matches_jax():
    from uncalled_tpu.debug import bc_aln_from_moves as jbc

    from uncalled_tpu_torch.debug import BCE_K, BCE_STRIDE, bc_aln_from_moves
    from uncalled_tpu_torch.pafstats import PafEntry

    moves = np.zeros(24, np.uint8)
    moves[::3] = 1
    packed = np.packbits(moves)
    p = PafEntry("q1\t100\t0\t100\t+\tref\t10000\t500\t600\t90\t100\t60\t"
                 "cg:Z:100M")
    samps, refs = bc_aln_from_moves(p, bce_samp_st=1000,
                                    bce_moves_packed=packed)
    assert len(samps) == 24 and samps[1] == 1000 + BCE_STRIDE
    assert (refs == 1 + np.arange(24) // 3 - BCE_K + 1).all()
    for kw in ({}, {"min_samp": 1010}, {"max_samp": 1050}):
        a = bc_aln_from_moves(p, 1000, packed, **kw)
        b = jbc(p, 1000, packed, **kw)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert bc_aln_from_moves(
        PafEntry("q1\t100\t0\t100\t+\tref\t10000\t500\t600\t90\t100\t60"),
        1000, packed) is None
