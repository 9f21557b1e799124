"""The port's host tools for the ``dtw`` and ``mask`` commands against the
JAX package's: ``ops/dtw.py`` (the DP matrix, the traceback, the cost
functions and ``align_read`` on a golden read at its golden region) and
``masking.py`` (``mask_internal``, ``mask_external``, ``long_repeat_mask``).
Floats are compared as raw bits, paths and masks exactly, and the masked
FASTA files byte for byte."""

import io
import json
import os

import numpy as np
import pytest

from test_dtw import brute_matrix
from uncalled_tpu.ops import dtw as jdtw
from uncalled_tpu_torch.ops import dtw as tdtw

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
PREFIX = os.path.join(FX, "example_index", "example_ref")
PRESETS = ("DTW_EVENT_GLOB", "DTW_EVENT_QSUB", "DTW_EVENT_RSUB",
           "DTW_RAW_GLOB", "DTW_RAW_QSUB", "DTW_RAW_RSUB")


def same_bits(a, b):
    a, b = np.atleast_1d(a), np.atleast_1d(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("shape", [(37, 23), (1, 9), (12, 1), (40, 64)])
def test_dtw_matrix_and_traceback_match_jax(preset, shape):
    rng = np.random.default_rng([PRESETS.index(preset), *shape])
    cost = (rng.random(shape) * 5).astype(np.float32)
    p, jp = getattr(tdtw, preset), getattr(jdtw, preset)
    assert p == tdtw.DTWParams(jp.subseq, jp.dw, jp.hw, jp.vw)
    mat = tdtw.dtw_matrix(cost, p)
    same_bits(mat, jdtw.dtw_matrix(cost, jp))
    np.testing.assert_allclose(mat, brute_matrix(cost, jp), rtol=1e-9)
    path, score = tdtw.dtw_traceback(mat, cost, p)
    jpath, jscore = jdtw.dtw_traceback(mat, cost, jp)
    assert path == jpath and len(path) >= 1
    same_bits(np.float64(score), np.float64(jscore))
    a, ja = tdtw.DTWAlign(cost, p), jdtw.DTWAlign(cost, jp)
    assert a.get_path() == ja.get_path()
    same_bits(np.float64(a.mean_score()), np.float64(ja.mean_score()))


def test_cost_functions_match_jax():
    rng = np.random.default_rng(5)
    means = (rng.normal(90, 13, 57)).astype(np.float32)
    kmers = rng.integers(0, 1024, 31)
    for name in ("cost_r94p", "cost_r94d"):
        same_bits(getattr(tdtw, name)(means, kmers),
                  getattr(jdtw, name)(means, kmers))
    for name in ("DTWr94p", "DTWr94d"):
        a = getattr(tdtw, name)(means, kmers, tdtw.DTW_EVENT_QSUB)
        ja = getattr(jdtw, name)(means, kmers, jdtw.DTW_EVENT_QSUB)
        same_bits(a.mat, ja.mat)
        assert a.get_path() == ja.get_path()


@pytest.mark.parametrize("rid", ["sim_0002_Escherichia_coli_6254_+",
                                 "sim_0011_Escherichia_coli_6633_-"])
def test_align_read_on_golden_read_matches_jax(rid):
    """The dtw command's alignment of a golden read against its golden
    region (events, normalisation, the region's k-mers, the DTW)."""
    from uncalled_tpu.config import Conf as JConf
    from uncalled_tpu.index.bwa_compat import load_bwa_index as jload
    from uncalled_tpu_torch.config import Conf
    from uncalled_tpu_torch.index.bwa_compat import load_bwa_index

    with open(os.path.join(FX, "golden_pafs.json")) as f:
        cols = json.load(f)[rid].split("\t")
    sig = np.load(os.path.join(FX, "golden_reads.npz"))[rid]
    args = (cols[5], int(cols[7]), int(cols[8]), cols[4] == "+")
    aln, ev = tdtw.align_read(sig, load_bwa_index(PREFIX), *args, Conf())
    jaln, jev = jdtw.align_read(sig, jload(PREFIX), *args, JConf())
    assert sorted(ev) == sorted(jev)
    for k in ev:
        same_bits(ev[k], jev[k])
    same_bits(aln.cost, jaln.cost)
    same_bits(aln.mat, jaln.mat)
    assert aln.get_path() == jaln.get_path()
    same_bits(np.float64(aln.score()), np.float64(jaln.score()))
    assert aln.cost.shape[0] == args[2] - args[1] - 4  # k-mers of the region


def _fasta(tmp_path):
    """Two records with planted repeats: a 200 bp run of one 8-mer, a 300
    bp duplication, a copy across the records, N runs and lower case."""
    rng = np.random.default_rng(3)
    base = "".join("ACGT"[c] for c in rng.integers(0, 4, 2500))
    seq1 = (base[:800] + "ACGTTGCA" * 25 + base[800:1600] + base[200:500]
            + base[1600:])
    seq2 = (base[2100:2400].lower() + "N" * 30 + base[1000:1250]
            + "".join("ACGT"[c] for c in rng.integers(0, 4, 700)))
    fa = tmp_path / "in.fa"
    fa.write_text(f">m1 first\n{seq1}\n>m2\n{seq2[:333]}\n{seq2[333:]}\n")
    return str(fa)


@pytest.mark.parametrize("mode,kw", [("internal", dict(k=8, iters=3)),
                                     ("internal", dict(k=15, iters=20)),
                                     ("external", dict(min_len=100)),
                                     ("external", dict(min_len=40))])
def test_masking_files_match_jax(tmp_path, mode, kw):
    from uncalled_tpu import masking as jm
    from uncalled_tpu_torch import masking as tm

    fa = _fasta(tmp_path)
    outs = []
    for mod, tag in ((tm, "port"), (jm, "jax")):
        out, log = str(tmp_path / f"{tag}.fa"), io.StringIO()
        fn = getattr(mod, f"mask_{mode}")
        assert fn(fa, out, *kw.values(), log=log) == out
        with open(out, "rb") as f:
            outs.append((f.read(), log.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][0].count(b"N") > 30  # the planted repeats were masked


def test_long_repeat_mask_matches_jax():
    from uncalled_tpu import masking as jm
    from uncalled_tpu_torch import masking as tm
    from uncalled_tpu_torch.kmer import seq_to_codes

    rng = np.random.default_rng(11)
    base = "".join("ACGT"[c] for c in rng.integers(0, 4, 900))
    codes = seq_to_codes(base + base[100:260] + "NNNN" + base[500:560])
    for min_len in (20, 60, 150, 400):
        got = tm.long_repeat_mask(codes, min_len)
        want = jm.long_repeat_mask(codes, min_len)
        assert got.dtype == want.dtype == bool
        np.testing.assert_array_equal(got, want)
    assert tm.long_repeat_mask(codes, 150).sum() >= 2 * 160
