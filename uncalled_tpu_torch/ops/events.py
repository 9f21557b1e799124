"""Streaming event detection (t-test segmentation of raw nanopore current).

Algorithm (behavioral spec extracted from the reference's scrappie-derived
detector, src/event_detector.cpp):

* maintain prefix sums S / SQ of the signal;
* at sample i (0-based), evaluate boundary position m = i - 5: two Welch-style
  t-statistics over [m-w, m) vs [m, m+w) for w in {3 (short), 6 (long)}
  (event_detector.cpp:174-219);
* feed each t-stat stream into a peak detector (state machine with a
  peak-height hysteresis of 0.2 and thresholds 1.4 / 9.0); a firing short
  detector masks the long detector (event_detector.cpp:221-279);
* a detected peak closes an event at boundary m - 2 whose mean/stdv come from
  the prefix sums (event_detector.cpp:296-319).

Quirks preserved for parity:

* for boundary m < 3 the short detector's "left window" wraps the ring buffer
  and actually reads S[m+6], i.e. sum1 = S[m] - S[m+6] (negative);
* `buf_mid` is u32 in the reference, so for samples i < 5 the boundary wraps
  to a huge value and the detectors *run* on the zero-valued early t-stats,
  which pulls their initial `peak_value` from FLT_MAX down to 0 before real
  t-stats arrive. We reproduce this (it changes where the first event lands).

Two implementations:

* ``detect_events_np`` -- float64 numpy + python peak scan; the test oracle,
  numerically matched to the reference (double prefix sums, float32 rounding
  at the same places).
* ``detect_block`` -- the batched streaming detector over [B, S] blocks
  (port of the JAX ``detect_block``): state in / state out, one row per
  read slot.  For tensors on the CPU it runs ``detect_block_plain``
  (vectorised t-stats and a per-sample loop); for tensors on the card it
  launches the hand-written kernel ``csrc/detect.cu`` or raises.

Bit-exactness with the JAX function rests on one precondition: every f64
prefix sum of the signal (of x and of the f32 x*x) is exact.  XLA's f64
cumsum is not a left-to-right sum, ``torch.cumsum`` on the CPU is, and the
kernel sums by a parallel scan; where every partial sum is exact the order
does not matter.  :func:`prefix_sums_exact` checks a sufficient condition
(the sum of |terms| below 2^53 times the terms' finest ulp); signals in pA
meet it (the golden sims span 43.9-137.2 pA, the real read 5.2-12194 pA).
Beyond that, the JAX function on the CPU runs with f32 subnormals flushed
(inputs and results), and ``jnp.maximum`` propagates NaN and returns +0
for max(-0, 0): both versions here do the same.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

W1 = 3
W2 = 6
THRESH1 = 1.4
THRESH2 = 9.0
PEAK_HEIGHT = 0.2
# defaults.toml [event_detector] values (the CLI-effective ones)
MIN_MEAN = 0.0
MAX_MEAN = 40000.0

TAIL = 2 * W2  # raw-sample carry needed for cross-block t-stats
DELAY = 7  # event boundary (m-2) lags the current sample by 7

FLT_MAX = np.float32(np.finfo(np.float32).max)
# the NaN an invalid f32 operation gives on x86 (sign set, quiet bit)
_X86_NAN = torch.tensor(-0x400000, dtype=torch.int32).view(torch.float32)
FLT_MIN = np.float32(np.finfo(np.float32).tiny)
_BIG = np.int64(1) << 32


# --------------------------------------------------------------------------
# numpy oracle
# --------------------------------------------------------------------------

def _tstats_np(signal: np.ndarray):
    """t-stat streams: entry i is the value seen by the detectors at sample i
    (boundary m = i-5); 0 when the reference returns 0 (t <= 2w)."""
    xf = signal.astype(np.float32)
    x = xf.astype(np.float64)
    n = len(x)
    S = np.zeros(n + 1)
    SQ = np.zeros(n + 1)
    np.cumsum(x, out=S[1:])
    # parity: the reference squares the float32 sample before accumulating
    # into the double sumsq (event_detector.cpp:89: `sumsq[..] + s*s`)
    np.cumsum((xf * xf).astype(np.float64), out=SQ[1:])

    out = []
    for w, tmin in ((W1, 2 * W1), (W2, 2 * W2)):
        t = np.zeros(n, dtype=np.float32)
        i = np.arange(n)
        m = i - 5
        valid = (i + 2) > tmin  # reference: t <= 2w -> 0  (t == i+2)
        m_ok = np.clip(m, 0, n)
        # ring-buffer wrap quirk: left prefix index m+2w when m < w
        left = np.where(m_ok >= w, m_ok - w, m_ok + 2 * w)
        right = m_ok + w
        ok = valid & (m >= 0) & (right <= n)
        li, mi, ri = left[ok], m_ok[ok], right[ok]
        # type choreography mirrors event_detector.cpp:201-218 exactly:
        # sum1/sumsq1 double; sum2/sumsq2 float; mean1 = (float)(double/ w);
        # mean2 = float/float; combined_var accumulated in double with f32
        # products, rounded to float; final t in double, rounded to float.
        wf32 = np.float32(w)
        wf64 = np.float64(np.float32(w))
        sum1 = S[mi] - S[li]
        sumsq1 = SQ[mi] - SQ[li]
        sum2 = (S[ri] - S[mi]).astype(np.float32)
        sumsq2 = (SQ[ri] - SQ[mi]).astype(np.float32)
        mean1 = (sum1 / wf64).astype(np.float32)
        mean2 = sum2 / wf32  # f32 division
        comb = (
            sumsq1 / wf64
            - (mean1 * mean1).astype(np.float64)
            + (sumsq2 / wf32).astype(np.float64)
            - (mean2 * mean2).astype(np.float64)
        ).astype(np.float32)
        comb = np.maximum(comb, FLT_MIN)
        delta = mean2 - mean1  # f32
        inner = comb / wf32  # f32 division
        t[ok] = (
            np.abs(delta.astype(np.float64)) / np.sqrt(inner.astype(np.float64))
        ).astype(np.float32)
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


def detect_events_np(
    signal: np.ndarray,
    min_mean: float = MIN_MEAN,
    max_mean: float = MAX_MEAN,
    calibration=None,
):
    """Sequential oracle. Returns dict with arrays start, length, mean, stdv
    (events passing the mean filter) plus total_events / len_sum over all
    created events (for mean_event_len parity).

    ``calibration=(offset, range, digitisation)`` applies the reference's
    mid-stream calibration hook (event_detector.cpp:155-162): every
    created event's mean AND stdv become (v + offset) * range/digitisation
    in f32 (the stdv offset included — create_event calibrates both,
    event_detector.cpp:308-309) BEFORE the min/max mean filter
    (event_detector.cpp:107-108 checks the calibrated mean).  Use when a
    data source delivers uncalibrated integer samples."""
    xf = signal.astype(np.float32)
    x = xf.astype(np.float64)
    n = len(x)
    S = np.zeros(n + 1)
    SQ = np.zeros(n + 1)
    np.cumsum(x, out=S[1:])
    # parity: the reference squares the float32 sample before accumulating
    # into the double sumsq (event_detector.cpp:89: `sumsq[..] + s*s`)
    np.cumsum((xf * xf).astype(np.float64), out=SQ[1:])
    t1, t2 = _tstats_np(signal)

    short = _Det(np.float32(THRESH1), W1)
    longd = _Det(np.float32(THRESH2), W2)

    def peak_detect(cur: np.float32, det: _Det, m_cmp: int, m: int) -> bool:
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
            if det.peak_value - cur > PEAK_HEIGHT and det.peak_value > det.threshold:
                det.valid_peak = True
            if det.valid_peak and (m - det.peak_pos) > det.window_length // 2:
                det.peak_pos = -1
                det.peak_value = cur
                det.valid_peak = False
                return True
        return False

    if calibration is not None:
        cal_off = np.float32(calibration[0])
        cal_coef = np.float32(calibration[1]) / np.float32(calibration[2])
    starts, lengths, means, stdvs = [], [], [], []
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
            length = np.float32(evt_en - evt_st)
            mean = np.float32((S[evt_en] - S[evt_st]) / length)
            deltasqr = np.float32(SQ[evt_en] - SQ[evt_st])
            var = np.float32(deltasqr / length - mean * mean)
            stdv = np.float32(np.sqrt(max(var, np.float32(0.0))))
            if calibration is not None:
                mean = np.float32((mean + cal_off) * cal_coef)
                stdv = np.float32((stdv + cal_off) * cal_coef)
            total_events += 1
            len_sum += float(length)
            if min_mean <= mean <= max_mean:
                starts.append(evt_st)
                lengths.append(float(length))
                means.append(float(mean))
                stdvs.append(float(stdv))
            evt_st = evt_en
    return {
        "start": np.array(starts, dtype=np.int64),
        "length": np.array(lengths, dtype=np.float32),
        "mean": np.array(means, dtype=np.float32),
        "stdv": np.array(stdvs, dtype=np.float32),
        "total_events": total_events,
        "len_sum": np.float32(len_sum),
    }


# --------------------------------------------------------------------------
# batched / streaming detector (torch; the kernel in csrc/detect.cu)
# --------------------------------------------------------------------------

_STATE = (
    # per-detector state, stacked [2, B]: 0 = short, 1 = long
    ("masked_to", "i32", 0), ("peak_pos", "i32", -1),
    ("peak_value", "f32", float(FLT_MAX)), ("valid_peak", "bool", False),
    # open event: start boundary (global prefix index) and the global f64
    # prefix sums at that boundary
    ("evt_st", "i32", 0), ("S_st", "f64", 0.0), ("SQ_st", "f64", 0.0),
    # index of the next sample to consume (global within the read)
    ("t", "i32", 0),
    # totals over all created events (for mean_event_len)
    ("total_events", "i32", 0), ("len_sum", "f32", 0.0),
    # the last TAIL raw samples (cross-block t-stats), and the global
    # prefix sums at position t - TAIL that seed the block's prefixes
    ("tail", "f32", 0.0), ("S0", "f64", 0.0), ("SQ0", "f64", 0.0),
)
STATE_KEYS = tuple(k for k, _, _ in _STATE)
_DT = {"i32": torch.int32, "f32": torch.float32, "f64": torch.float64,
       "bool": torch.bool}
OUT_KEYS = ("fired", "mean", "stdv", "start", "length")


def _shape(k, B):
    if k in ("masked_to", "peak_pos", "peak_value", "valid_peak"):
        return (2, B)
    return (B, TAIL) if k == "tail" else (B,)


def make_detector_state(B: int, device="cpu") -> dict:
    """Initial streaming detector state for a batch of B read slots (the
    JAX ``make_detector_state``'s keys, shapes and dtypes)."""
    return {k: torch.full(_shape(k, B), v, dtype=_DT[d], device=device)
            for k, d, v in _STATE}


def reset_detector_rows(state: dict, mask) -> dict:
    """Reset the detector state of read slots where mask[B] is True."""
    mask = torch.as_tensor(mask, dtype=torch.bool,
                           device=state["t"].device)
    fresh = make_detector_state(mask.shape[0], mask.device)
    out = {}
    for k, v in state.items():
        m = mask[None, :] if v.shape[0] == 2 and v.dim() == 2 else mask
        m = m.reshape(m.shape + (1,) * (v.dim() - m.dim()))
        out[k] = torch.where(m, fresh[k], v)
    return out


def _ftz(x):
    """f32 subnormals to signed zero, as XLA's CPU runtime flushes every f32
    input and result (FTZ and DAZ)."""
    return torch.where(x.abs() < float(FLT_MIN), x * 0.0, x)


def _maximum(a, b: float):
    """``jnp.maximum(a, b)`` for a scalar b: NaN propagates, and
    max(-0, +0) is +0."""
    return torch.where(torch.isnan(a) | (a > b), a,
                       torch.full_like(a, b))


def _div(a, w: float):
    """``a / w`` as one IEEE division on every device (PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal)."""
    return a / torch.full_like(a, w)


def _sqrt64(x):
    """Correctly rounded f64 sqrt (``torch.sqrt`` on the CPU is not: about
    1% of its results are one ulp off): one correction step from the exact
    residual of the first guess (a Dekker product)."""
    y = torch.sqrt(x)
    p = y * y
    c = 134217729.0 * y  # 2^27 + 1: Veltkamp split
    yh = c - (c - y)
    yl = y - yh
    pe = ((yh * yh - p) + 2.0 * yh * yl) + yl * yl
    z = y + ((x - p) - pe) / (2.0 * y)
    return torch.where((x == 0) | torch.isinf(x), y, z)


def _fma(a, b, c):
    """f32 ``a * b + c`` rounded once (a fused multiply-add), flushed.
    The product is exact in f64; the f64 sum is rounded to odd (from its
    exact error) so that the final rounding to f32 is the correct one."""
    f64 = torch.float64
    p = a.to(f64) * b.to(f64)
    c64 = c.to(f64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    # truncate s toward zero where it was rounded away, then set the last
    # bit where the sum was inexact
    bits = s.view(torch.int64)
    away = (err != 0) & ((err < 0) != (s < 0)) & (s != 0)
    bits = torch.where(away, bits - 1, bits)
    bits = torch.where(err != 0, bits | 1, bits)
    return _ftz(bits.view(f64).to(torch.float32))


def _tstats_block(sig, tail, S0, SQ0, t_start):
    """t-stats [B, S] (f32) of one block and the global f64 prefix arrays
    [B, TAIL + S + 1] given the carry (the JAX ``_tstats_block``).  The
    prefixes are left-to-right sums from 0 with S0 / SQ0 added after."""
    B, S = sig.shape
    f32, f64 = torch.float32, torch.float64
    xs = _ftz(torch.cat([tail, sig.to(f32)], 1))
    zero = torch.zeros((B, 1), dtype=f64, device=sig.device)
    S1 = torch.cat([zero, torch.cumsum(xs.to(f64), 1)], 1) + S0[:, None]
    # parity: square in f32, accumulate in f64 (event_detector.cpp:89)
    SQ1 = torch.cat([zero, torch.cumsum(_ftz(xs * xs).to(f64), 1)], 1) \
        + SQ0[:, None]
    idx = torch.arange(S, dtype=torch.int32, device=sig.device)
    tg = t_start[:, None] + idx[None, :]
    res = []
    for w, tmin in ((W1, 2 * W1), (W2, 2 * W2)):
        m = (idx + TAIL - 5).to(torch.int64)
        # start-of-read wrap quirk (0 <= m_global < w): left reads m+2w
        mg = tg - 5
        wrap = (mg >= 0) & (mg < w)
        left = torch.where(wrap, m[None, :] + 2 * w, m[None, :] - w)
        pm, pqm = S1[:, m], SQ1[:, m]
        sum1 = pm - torch.gather(S1, 1, left)
        sumsq1 = pqm - torch.gather(SQ1, 1, left)
        sum2 = _ftz((S1[:, m + w] - pm).to(f32))
        sumsq2 = _ftz((SQ1[:, m + w] - pqm).to(f32))
        mean1 = _ftz(_div(sum1, w).to(f32))
        mean2 = _ftz(_div(sum2, w))
        comb = _ftz((
            _div(sumsq1, w)
            - _ftz(mean1 * mean1).to(f64)
            + _ftz(_div(sumsq2, w)).to(f64)
            - _ftz(mean2 * mean2).to(f64)
        ).to(f32))
        comb = _maximum(comb, float(FLT_MIN))
        delta = _ftz(mean2 - mean1)
        inner = _ftz(_div(comb, w))
        t = _ftz((delta.to(f64).abs() / _sqrt64(inner.to(f64))).to(f32))
        # 0 / 0 (a window pair of equal samples): the x86 default NaN, as
        # the JAX function on the CPU gives it (the card's is 0x7fffffff)
        t = torch.where(torch.isnan(t), _X86_NAN.to(t.device), t)
        # zero when t_global <= 2w (reference: t <= 2w -> 0)
        res.append(torch.where((tg + 2) <= tmin, torch.zeros_like(t), t))
    return res[0], res[1], S1, SQ1


def detect_block_plain(state: dict, sig):
    """The JAX ``detect_block`` in plain PyTorch: vectorised t-stats, a loop
    over the block's samples carrying both detectors of every row (stacked
    [2, B] as in the JAX state), then the event statistics of every sample,
    vectorised.  Returns (state', out); out holds [B, S] arrays fired
    (bool), mean, stdv, length (f32) and start (int32), computed at every
    sample (the mean filter is applied to ``fired``)."""
    B, S = sig.shape
    if S < 2 * TAIL:
        raise ValueError(f"detect_block: block of {S} samples is below "
                         f"2 * TAIL = {2 * TAIL}")
    dev = sig.device
    f32, f64, i32 = torch.float32, torch.float64, torch.int32
    t1, t2, S1, SQ1 = _tstats_block(
        sig, state["tail"], state["S0"], state["SQ0"], state["t"])
    # global f64 prefix values at the event boundary en = i - 7
    S_en = S1[:, TAIL - 7: TAIL - 7 + S]
    SQ_en = SQ1[:, TAIL - 7: TAIL - 7 + S]
    cur_all = torch.stack([t1, t2], 0).permute(2, 0, 1)  # [S, 2, B]
    thresh = torch.tensor([[THRESH1], [THRESH2]], dtype=f32, device=dev)
    whalf = torch.tensor([[W1 // 2], [W2 // 2]], dtype=i32, device=dev)
    is_long = torch.tensor([[False], [True]], device=dev)

    mt, pp = state["masked_to"], state["peak_pos"]
    pv, vd = state["peak_value"], state["valid_peak"]
    t0 = state["t"]
    evt_st, s_st, sq_st = state["evt_st"], state["S_st"], state["SQ_st"]
    total, len_sum = state["total_events"], state["len_sum"]
    fmax = torch.tensor(float(FLT_MAX), dtype=f32, device=dev)
    fired_s, st_s, sst_s, sqst_s = [], [], [], []
    for i in range(S):
        cur = cur_all[i]  # [2, B]
        m = t0 + i - 5  # boundary evaluated at this sample (can be < 0)
        # short dominates long: short's case-2 peak (from its state before
        # this sample) above its threshold resets the long detector
        s_act = (m < 0) | (mt[0] < m)
        s_hi = cur[0] > pv[0]
        s_pv2 = torch.where(s_hi, cur[0], pv[0])
        s_pp2 = torch.where(s_hi, m, pp[0])
        dom = (s_act & (pp[0] != -1) & (s_pv2 > THRESH1))[None] & is_long
        mt = torch.where(dom, s_pp2 + W1, mt)
        pp = torch.where(dom, -1, pp)
        pv = torch.where(dom, fmax, pv)
        vd = vd & ~dom
        # both detectors, the long one on its updated state
        act = (m < 0) | (mt < m)
        no_peak = pp == -1
        rise = (cur - pv) > PEAK_HEIGHT  # flushing cannot change this
        higher = cur > pv
        pv2 = torch.where(higher, cur, pv)
        pp2 = torch.where(higher, m, pp)
        vd2 = vd | (((pv2 - cur) > PEAK_HEIGHT) & (pv2 > thresh))
        fire = vd2 & ((m - pp2) > whalf)
        set_pv = act & torch.where(no_peak, (cur < pv) | rise, higher | fire)
        pp = torch.where(act, torch.where(
            no_peak, torch.where(rise, m, pp), torch.where(fire, -1, pp2)),
            pp)
        vd = torch.where(act & ~no_peak, vd2 & ~fire, vd)
        pv = torch.where(set_pv, cur, pv)
        fired = (act & ~no_peak & fire).any(0)
        fired_s.append(fired)
        st_s.append(evt_st)
        sst_s.append(s_st)
        sqst_s.append(sq_st)
        # on fire the event covers [evt_st, en), en = m - 2
        en = m - 2
        total = total + fired.to(i32)
        len_sum = _ftz(len_sum + torch.where(
            fired, (en - evt_st).to(f32), torch.zeros_like(len_sum)))
        evt_st = torch.where(fired, en, evt_st)
        s_st = torch.where(fired, S_en[:, i], s_st)
        sq_st = torch.where(fired, SQ_en[:, i], sq_st)

    # every sample's event statistics from the global f64 prefix sums,
    # rounded like create_event
    fired = torch.stack(fired_s, 1)
    start = torch.stack(st_s, 1)
    en = t0[:, None] + torch.arange(S, dtype=i32, device=dev)[None] - 7
    length = (en - start).to(f32)
    lsafe = _maximum(length, 1.0)
    mean = _ftz(((S_en - torch.stack(sst_s, 1)) / lsafe.to(f64)).to(f32))
    dsq = _ftz((SQ_en - torch.stack(sqst_s, 1)).to(f32))
    # the JAX scan body is compiled, and XLA contracts this line into one
    # fused multiply-add: fma(-mean, mean, dsq / lsafe)
    var = _fma(-mean, mean, _ftz(dsq / lsafe))
    # an f32 sqrt rounded once: the correctly rounded f64 root of an f32
    # value rounds to the correctly rounded f32 root
    stdv = _ftz(_sqrt64(_maximum(var, 0.0).to(f64)).to(f32))
    keep = fired & (mean >= MIN_MEAN) & (mean <= MAX_MEAN)

    new = dict(
        masked_to=mt, peak_pos=pp, peak_value=pv, valid_peak=vd,
        evt_st=evt_st, S_st=s_st, SQ_st=sq_st, t=t0 + S,
        total_events=total, len_sum=len_sum,
        tail=torch.cat([state["tail"], sig.to(f32)], 1)[:, -TAIL:],
        # the prefix carry advances to position t_new - TAIL = padded S
        S0=S1[:, S], SQ0=SQ1[:, S],
    )
    out = dict(fired=keep, mean=mean, stdv=stdv, start=start, length=length)
    return new, out


def detect_block(state: dict, sig, rounds=None):
    """Advance detection over one [B, S] signal block (S >= 2 * TAIL).

    Returns (state', out) as the JAX ``detect_block``.  CPU tensors run
    :func:`detect_block_plain`; CUDA tensors launch ``csrc/detect.cu``
    (one block per row, a segmented speculative scan) or raise.  On the
    card ``rounds``, an int32 [B] tensor, receives each row's repair
    rounds of that scan (a measurement; without it a scratch tensor
    does)."""
    from . import _cuda

    if sig.device.type == "cpu":
        return detect_block_plain(state, sig)
    dev = sig.device
    B, S = sig.shape
    if S < 2 * TAIL:
        raise ValueError(f"detect_block: block of {S} samples is below "
                         f"2 * TAIL = {2 * TAIL}")
    _cuda.check(sig, "detect_block.sig", (torch.float32,), 2, dev)
    for k, d, _ in _STATE:
        v = state[k]
        _cuda.check(v, f"detect_block.{k}", (_DT[d],), len(_shape(k, B)),
                    dev)
        if tuple(v.shape) != _shape(k, B):
            raise ValueError(f"detect_block.{k}: shape {tuple(v.shape)}, "
                             f"expected {_shape(k, B)}")
    new = {k: torch.empty(_shape(k, B), dtype=_DT[d], device=dev)
           for k, d, _ in _STATE}
    out = {k: torch.empty((B, S), dtype=d, device=dev) for k, d in (
        ("fired", torch.bool), ("mean", torch.float32),
        ("stdv", torch.float32), ("start", torch.int32),
        ("length", torch.float32))}
    if rounds is None:
        rounds = torch.empty(B, dtype=torch.int32, device=dev)
    _cuda.check(rounds, "detect_block.rounds", (torch.int32,), 1, dev)
    if rounds.shape[0] != B:
        raise ValueError(f"detect_block.rounds: {rounds.shape[0]} rows, "
                         f"expected {B}")
    if B:
        _cuda.launch(
            "detect_block_f32",
            [sig] + [state[k] for k in STATE_KEYS]
            + [new[k] for k in STATE_KEYS] + [out[k] for k in OUT_KEYS]
            + [rounds], B, S)
        _cuda.COUNTS["detect"] += 1
    return new, out


def prefix_sums_exact(signal) -> bool:
    """True when every f64 partial sum of the f32 signal and of its f32
    squares is exact in any order: the sum of |terms| stays below 2^53
    times the finest ulp among the terms (every partial sum is then a
    multiple of that ulp below 2^53 of them).  Subnormal samples are
    refused (the JAX function flushes them)."""
    x = np.asarray(signal, dtype=np.float32).ravel()
    if (np.abs(x[x != 0]) < FLT_MIN).any() or not np.isfinite(x).all():
        return False
    for terms in (x, x * x):
        nz = np.abs(terms[terms != 0]).astype(np.float64)
        if not len(nz):
            continue
        if (nz < float(FLT_MIN)).any():
            return False
        # ulp of an f32 value v: 2^(floor(log2 v) - 23)
        q = np.ldexp(1.0, int(np.frexp(nz)[1].min()) - 1 - 23)
        if nz.sum() >= np.ldexp(q, 53):
            return False
    return True
