"""Dynamic time warping: signal-to-reference ground-truth alignment.

Port of the reference DTW evaluation tool (src/dtw.hpp:9-233 + the
dtw_test.cpp flow): full O(N*M) cost matrix with weighted diagonal /
horizontal / vertical moves, global and row/column-subsequence modes, and the
two r9.4.1 cost functions (negative log match prob, or |event - level mean|).

Not on the mapping path: this scores how well the signal pipeline matches the
pore model independently of seed-and-extend (SURVEY §4.4).

The row sweep is vectorized with a min-plus prefix scan: within a row,
cell[j] = min(b[j], cell[j-1] + hw*c[j]) equals
S[j] + running_min(b - S)[j] with S = cumsum(hw*c). Numerically this may
differ from the sequential recurrence by float-associativity ulps; the DP is
accumulated in float64 to make that immaterial.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BIG = np.float64(np.finfo(np.float32).max / 2.0)


@dataclass(frozen=True)
class DTWParams:
    subseq: str = "none"  # none | row | col
    dw: float = 2.0
    hw: float = 1.0
    vw: float = 100.0


# presets from dtw.hpp:15-28
DTW_EVENT_GLOB = DTWParams("none", 2, 1, 100)
DTW_EVENT_QSUB = DTWParams("col", 2, 1, 100)
DTW_EVENT_RSUB = DTWParams("row", 2, 1, 100)
DTW_RAW_GLOB = DTWParams("none", 10, 1, 1000)
DTW_RAW_QSUB = DTWParams("col", 10, 1, 1000)
DTW_RAW_RSUB = DTWParams("row", 10, 1, 1000)


def dtw_matrix(cost: np.ndarray, p: DTWParams) -> np.ndarray:
    """Fill the DP matrix (rows x cols) with the reference's move and border
    semantics (dtw.hpp:51-74, hscore/vscore/dscore at :161-179)."""
    R, C = cost.shape
    c64 = cost.astype(np.float64)
    mat = np.empty((R, C), dtype=np.float64)

    for i in range(R):
        if i == 0:
            # dscore: (i==j) -> 0 at (0,0); i==0 && COL -> 0 everywhere
            ds = np.full(C, 0.0 if p.subseq == "col" else BIG)
            ds[0] = 0.0
            vs = np.full(C, 0.0 if p.subseq == "col" else BIG)
        else:
            prev = mat[i - 1]
            ds = np.empty(C)
            ds[0] = 0.0 if p.subseq == "row" else BIG
            ds[1:] = prev[:-1]
            vs = prev
        b = np.minimum(ds + p.dw * c64[i], vs + p.vw * c64[i])
        # cell[j] = min(b[j], cell[j-1] + hw*c[j]) with virtual cell[-1]=h0:
        # min-plus prefix scan over S = cumsum(hw*c)
        h0 = 0.0 if p.subseq == "row" else BIG
        S = np.cumsum(p.hw * c64[i])
        run = np.minimum.accumulate(np.minimum(b - S, h0))
        mat[i] = S + np.minimum(run, h0)
    return mat


def dtw_traceback(mat: np.ndarray, cost: np.ndarray, p: DTWParams):
    """Traceback (dtw.hpp:76-120): returns path [(col, row), ...] end-first
    and the path score."""
    R, C = mat.shape
    i, j = R - 1, C - 1
    if p.subseq == "row":
        i = int(np.argmin(mat[:, j]))
    elif p.subseq == "col":
        j = int(np.argmin(mat[i, :]))
    score = float(mat[i, j])
    path = [(j, i)]
    while not ((i == 0 or p.subseq == "row") and (j == 0 or p.subseq == "col")):
        c = p_cost = cost[i, j]
        ds = mat[i - 1, j - 1] if (i > 0 and j > 0) else (
            0.0 if ((i == j) or (i == 0 and p.subseq == "col")
                    or (j == 0 and p.subseq == "row")) else BIG
        )
        hs = mat[i, j - 1] if j > 0 else (0.0 if p.subseq == "row" else BIG)
        vs = mat[i - 1, j] if i > 0 else (0.0 if p.subseq == "col" else BIG)
        dv = ds + p.dw * c
        hv = hs + p.hw * c
        vv = vs + p.vw * c
        if i == 0 or (not (dv <= hv and dv <= vv) and hv <= vv):
            j -= 1
        elif j == 0 or not (dv <= hv and dv <= vv):
            i -= 1
        else:
            i -= 1
            j -= 1
        if i < 0 or j < 0:
            break
        path.append((j, i))
    return path, score


class DTWAlign:
    """DTW<ColT, RowT> equivalent: align row values to column values."""

    def __init__(self, cost: np.ndarray, prms: DTWParams = DTW_EVENT_GLOB):
        self.prms = prms
        self.cost = cost
        self.mat = dtw_matrix(cost, prms)
        self.path, self.score_sum = dtw_traceback(self.mat, cost, prms)

    def get_path(self):
        return self.path

    def score(self) -> float:
        return self.score_sum

    def mean_score(self) -> float:
        return self.score_sum / len(self.path)


def cost_r94p(means: np.ndarray, kmers: np.ndarray, model=None) -> np.ndarray:
    """-log match prob against the template model (dtw.hpp:189-191).

    Rows are k-mers, columns are events (the reference's DTW<ColT=event,
    RowT=kmer> layout): consecutive events on one k-mer are cheap horizontal
    moves (hw=1) while skipping k-mers without events costs vw=100."""
    from ..poremodel import PoreModel

    model = model or PoreModel.load_npz(complement=False)
    d = model.means[kmers][:, None] - means[None, :].astype(np.float32)
    return (
        (d * d) / model.vars_x2[kmers][:, None]
        + model.lognorm_denoms[kmers][:, None]
    )


def cost_r94d(means: np.ndarray, kmers: np.ndarray, model=None) -> np.ndarray:
    """|event - level mean| (dtw.hpp:212-214); k-mer rows x event columns."""
    from ..poremodel import PoreModel

    model = model or PoreModel.load_npz(complement=False)
    return np.abs(model.means[kmers][:, None] - means[None, :].astype(np.float32))


def DTWr94p(means, kmers, prms=DTW_EVENT_GLOB, model=None) -> DTWAlign:
    return DTWAlign(cost_r94p(np.asarray(means), np.asarray(kmers), model), prms)


def DTWr94d(means, kmers, prms=DTW_EVENT_GLOB, model=None) -> DTWAlign:
    return DTWAlign(cost_r94d(np.asarray(means), np.asarray(kmers), model), prms)


def align_read(signal: np.ndarray, fmi, ref_name: str, ref_st: int,
               ref_en: int, fwd: bool, conf=None, prms=DTW_EVENT_RSUB):
    """dtw_test.cpp:62-179 equivalent: events -> normalize -> DTW against the
    reference k-mers of a known region; returns (DTWAlign, events)."""
    from ..config import Conf
    from ..kmer import seq_to_kmers
    from ..mapping.batch import normalize_events
    from ..ops.events import detect_events_np
    from .. import native

    conf = conf or Conf()
    ed = conf.event_detector
    ev = native.detect_events(signal, ed.min_mean, ed.max_mean)
    if ev is None:
        ev = detect_events_np(signal, ed.min_mean, ed.max_mean)
    norm, _, _ = normalize_events(
        ev["mean"], conf.normalizer.tgt_mean, conf.normalizer.tgt_stdv
    )
    st = fmi.get_sa_loc(ref_name, ref_st)
    bases = fmi.get_base(np.arange(st, st + (ref_en - ref_st)))
    if not fwd:
        bases = (3 - bases)[::-1]
    kmers = seq_to_kmers(bases)
    return DTWAlign(cost_r94p(norm, kmers), prms), ev
