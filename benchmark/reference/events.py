"""The reference's event detector and normalizer.

A copy of UNCALLED's t-test event detector (event_detector.cpp) as
``uncalled_tpu_torch.ops.events.detect_events_np`` has it: float64 prefix
sums and moments with float32 rounding where the reference rounds, and the
sequential peak scan.  ``hi`` is the precision the reference keeps in
float64; the control passes float32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

W1, W2 = 3, 6
THRESH1, THRESH2 = 1.4, 9.0
PEAK_HEIGHT = 0.2
FLT_MAX = np.float32(np.finfo(np.float32).max)
FLT_MIN = np.float32(np.finfo(np.float32).tiny)
_BIG = np.int64(1) << 32
F32 = np.float32


def _tstats(signal: np.ndarray, hi=np.float64):
    """t-stat streams: entry i is what the detectors see at sample i
    (boundary m = i - 5); 0 where the reference returns 0 (t <= 2w)."""
    xf = signal.astype(F32)
    x = xf.astype(hi)
    n = len(x)
    S = np.zeros(n + 1, hi)
    SQ = np.zeros(n + 1, hi)
    np.cumsum(x, out=S[1:])
    np.cumsum((xf * xf).astype(hi), out=SQ[1:])
    out = []
    for w, tmin in ((W1, 2 * W1), (W2, 2 * W2)):
        t = np.zeros(n, dtype=F32)
        i = np.arange(n)
        m = i - 5
        valid = (i + 2) > tmin
        m_ok = np.clip(m, 0, n)
        # ring-buffer wrap quirk: left prefix index m + 2w when m < w
        left = np.where(m_ok >= w, m_ok - w, m_ok + 2 * w)
        right = m_ok + w
        ok = valid & (m >= 0) & (right <= n)
        li, mi, ri = left[ok], m_ok[ok], right[ok]
        wf32 = F32(w)
        whi = hi(F32(w))
        sum1 = S[mi] - S[li]
        sumsq1 = SQ[mi] - SQ[li]
        sum2 = (S[ri] - S[mi]).astype(F32)
        sumsq2 = (SQ[ri] - SQ[mi]).astype(F32)
        mean1 = (sum1 / whi).astype(F32)
        mean2 = sum2 / wf32
        comb = (sumsq1 / whi - (mean1 * mean1).astype(hi)
                + (sumsq2 / wf32).astype(hi)
                - (mean2 * mean2).astype(hi)).astype(F32)
        comb = np.maximum(comb, FLT_MIN)
        delta = mean2 - mean1
        inner = comb / wf32
        t[ok] = (np.abs(delta.astype(hi)) / np.sqrt(inner.astype(hi))
                 ).astype(F32)
        out.append(t)
    return out[0], out[1]


@dataclass
class _Det:
    threshold: float
    window_length: int
    masked_to: int = 0
    peak_pos: int = -1
    peak_value: np.float32 = FLT_MAX
    valid_peak: bool = False


def detect_events(signal: np.ndarray, min_mean: float, max_mean: float,
                  hi=np.float64):
    """Events of a whole signal: the means of those passing the mean filter,
    and the count and summed length of all events made (for the mean event
    length)."""
    xf = signal.astype(F32)
    x = xf.astype(hi)
    n = len(x)
    S = np.zeros(n + 1, hi)
    SQ = np.zeros(n + 1, hi)
    np.cumsum(x, out=S[1:])
    np.cumsum((xf * xf).astype(hi), out=SQ[1:])
    t1, t2 = _tstats(signal, hi)
    short = _Det(F32(THRESH1), W1)
    longd = _Det(F32(THRESH2), W2)

    def peak_detect(cur, det, m_cmp, m) -> bool:
        if det.masked_to >= m_cmp:
            return False
        if det.peak_pos == -1:
            if cur < det.peak_value:
                det.peak_value = cur
            elif cur - det.peak_value > PEAK_HEIGHT:
                det.peak_value = cur
                det.peak_pos = m
        else:
            if cur > det.peak_value:
                det.peak_value = cur
                det.peak_pos = m
            if det.window_length == W1 and det.peak_value > det.threshold:
                longd.masked_to = det.peak_pos + det.window_length
                longd.peak_pos = -1
                longd.peak_value = FLT_MAX
                longd.valid_peak = False
            if (det.peak_value - cur > PEAK_HEIGHT
                    and det.peak_value > det.threshold):
                det.valid_peak = True
            if det.valid_peak and (m - det.peak_pos) > det.window_length // 2:
                det.peak_pos = -1
                det.peak_value = cur
                det.valid_peak = False
                return True
        return False

    means = []
    evt_st = 0
    total_events = 0
    len_sum = 0.0
    for i in range(n):
        m = i - 5
        m_cmp = m if m >= 0 else m + _BIG  # u32 wrap of buf_mid
        p1 = peak_detect(t1[i], short, m_cmp, m)
        p2 = peak_detect(t2[i], longd, m_cmp, m)
        if p1 or p2:
            evt_en = m - W1 + 1
            length = F32(evt_en - evt_st)
            mean = F32((S[evt_en] - S[evt_st]) / length)
            total_events += 1
            len_sum += float(length)
            if min_mean <= mean <= max_mean:
                means.append(float(mean))
            evt_st = evt_en
    return np.array(means, dtype=F32), total_events, F32(len_sum)


def normalize(means: np.ndarray, tgt_mean: float, tgt_stdv: float,
              hi=np.float64) -> np.ndarray:
    """Global z-score onto the model's level distribution, accumulated in
    order (Normalizer::set_signal, normalizer.cpp:46-118)."""
    n = len(means)
    gmean = hi(0.0)
    for e in means:
        gmean += hi(e)
    gmean /= n
    varsum = hi(0.0)
    for e in means:
        varsum += (hi(e) - gmean) ** 2
    scale = F32(tgt_stdv / np.sqrt(varsum / n))
    shift = F32(tgt_mean - scale * gmean)
    return (scale * means.astype(F32) + shift).astype(F32)
