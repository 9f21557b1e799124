"""The reference's per-FM-bin seed thresholds, fitted from its own index.

A copy of UNCALLED's index parameterizer (uncalled/index.py:53-209 and
src/self_align_ref.cpp:34-91) as ``uncalled_tpu_torch.index.parameterize``
has it, with the ``.uncl`` text round trip kept: each threshold is written
with ``str`` and read back as float32, bins 63 downward, the lower bins
repeating the last value (Mapper::load_static, mapper.cpp:138-157).
"""

from __future__ import annotations

import os

import numpy as np

THRESHS_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "r94_5mer_threshs.npz")


class GlibcRand:
    """glibc rand(): TYPE_3 additive-feedback generator."""

    def __init__(self, seed: int = 0):
        if seed == 0:
            seed = 1
        r = [seed]
        for i in range(1, 31):
            hi, lo = divmod(r[i - 1], 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r.append(word)
        for i in range(31, 34):
            r.append(r[i - 31])
        self.r = r
        self.i = 34
        for _ in range(34, 344):
            self._next()

    def _next(self) -> int:
        r = self.r
        v = (r[self.i - 31] + r[self.i - 3]) & 0xFFFFFFFF
        r.append(v)
        self.i += 1
        return v >> 1

    def rand(self) -> int:
        return self._next()


def sample_starts(ref_lens, sample_dist: int) -> np.ndarray:
    """Positions p with rand() % sample_dist == 0, one rand() a position."""
    rng = GlibcRand(0)
    starts = []
    off = 0
    for ln in ref_lens:
        for i in range(int(ln)):
            if rng.rand() % sample_dist == 0:
                starts.append(off + i)
        off += int(ln)
    return np.asarray(starts, dtype=np.int64)


def self_align(fmi, sample_dist: int, max_steps: int = 4096):
    """FM-interval lengths of sampled positions walked backward until
    unique (self_align_ref.cpp:34-91), all positions in lockstep."""
    starts = sample_starts(fmi.ref_lens, sample_dist)
    m = len(starts)
    if m == 0:
        return []
    seq_ends = np.cumsum(np.asarray(fmi.ref_lens, dtype=np.int64))
    ends = seq_ends[np.searchsorted(seq_ends, starts, side="right")]
    b0 = 3 - fmi.get_base(starts).astype(np.int64)
    lo = fmi.L2[b0].astype(np.int64)
    hi = fmi.L2[b0 + 1].astype(np.int64)
    profiles = [[] for _ in range(m)]
    pos = starts + 1
    active = np.ones(m, dtype=bool)
    for _ in range(max_steps):
        length = hi - lo + 1
        cont = active & (pos < ends) & (length > 1)
        for i in np.flatnonzero(cont):
            profiles[i].append(int(length[i]))
        done_now = active & ~cont
        for i in np.flatnonzero(done_now):
            if length[i] > 0:
                profiles[i].append(int(length[i]))
        active = cont
        if not active.any():
            break
        idx = np.flatnonzero(active)
        b = 3 - fmi.get_base(pos[idx]).astype(np.int64)
        nlo, nhi = fmi.extend(lo[idx], hi[idx], b)
        lo[idx], hi[idx] = nlo, nhi
        pos[idx] += 1
    return profiles


def power_fn(xmax, ymin, ymax, exp, N=100):
    t = np.arange(0, 1 + 1.0 / N, 1.0 / N)
    return t * xmax, (t ** exp) * (ymax - ymin) + ymin


def fit_default(fmi, p: dict, tgt_speed: float = 115.0) -> np.ndarray:
    """The "default" preset's per-bin thresholds (f64), as
    ``IndexParameterizer.add_preset("default", tgt_speed=115)`` fits them
    with the index parameters ``p`` (the [index] section)."""
    ref_len = int(np.sum(fmi.ref_lens))
    approx = ref_len / p["max_sample_dist"]
    if approx < p["min_samples"]:
        dist = int(np.ceil(ref_len / p["min_samples"]))
    elif approx > p["max_samples"]:
        dist = int(np.floor(ref_len / p["max_samples"]))
    else:
        dist = p["max_sample_dist"]
    fmlens = self_align(fmi, dist)
    k = p["kmer_len"]
    paths = [q[k - 1:] if len(q) >= k else [1] for q in fmlens]
    lens = [len(q) for q in paths if len(q) <= p["max_replen"]]
    gt1 = np.zeros(max(lens))
    for ln in lens:
        gt1[:ln] += 1
    max_pathlen = int(np.flatnonzero(
        gt1 / len(lens) <= p["pathlen_percentile"])[0])
    max_fmexp = int(np.log2(max(q[0] for q in paths))) + 1
    mat = np.zeros((max_fmexp, max_pathlen))
    for q in paths:
        ll = min(max_pathlen, len(q))
        for i in range(ll):
            mat[int(np.log2(q[i])), i] += 1
        mat[0, len(q): max_pathlen] += 1
    pos = np.arange(max_pathlen)
    fm_locs = (mat * pos).sum(1) / mat.sum(1)
    loc_fms = (mat * np.arange(max_fmexp)[:, None]).sum(0) / mat.sum(0)
    speed_denom = loc_fms.sum()

    d = np.load(THRESHS_NPZ)
    model_ekms = d["thresh"][::-1].astype(np.float64)
    model_pcks = d["freq"][::-1].astype(np.float64)
    model_counts = d["count"][::-1].astype(np.float64)

    def speed(fn_locs, fn_pcks):
        pcks = np.interp(pos, fn_locs, fn_pcks)
        counts = np.interp(pcks, model_pcks, model_counts)
        return np.dot(counts, loc_fms) / speed_denom

    exp, exp_min, exp_max, pdelta, eps = 2, None, None, None, 1e-5
    while True:
        fn_locs, fn_pcks = power_fn(fm_locs[0], p["matchpr1"], p["matchpr2"],
                                    exp)
        delta = speed(fn_locs, fn_pcks) - tgt_speed
        if abs(delta) <= eps or delta == pdelta:
            break
        pdelta = delta
        if delta < 0:
            exp_max = exp
        else:
            exp_min = exp
        pexp = exp
        if exp_max is None:
            exp *= 2
        elif exp_min is None:
            exp /= 2
        else:
            exp = exp_min + (exp_max - exp_min) / 2.0
        if exp == pexp:
            break
    fm_pcks = np.interp(fm_locs, fn_locs, fn_pcks)
    return np.interp(fm_pcks, model_pcks, model_ekms)


def bin_thresholds(ekms) -> np.ndarray:
    """The 64 per-bin float32 thresholds a mapper loads from the preset's
    text line."""
    vals = [np.float32(x) for x in ",".join(map(str, ekms)).split(",")]
    out = np.zeros(64, dtype=np.float32)
    b = 63
    for v in vals:
        out[b] = v
        b -= 1
    out[: b + 1] = vals[-1]
    return out
