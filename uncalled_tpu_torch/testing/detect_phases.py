"""Where the device event detector's time goes, phase by phase (a
measurement on the card, no part of the mapper).

    python -m uncalled_tpu_torch.testing.detect_phases [--B 512] [--S 4096]

Builds ``csrc/detect.cu`` with ``-DDETECT_PHASES`` into the gitignored
``_build/phases/`` (thread 0 of each block stamps the global timer at the
start and after each phase), runs it on a seeded block of pA signal and on
a block of reads of random lengths zero-padded to S (as a refill wave's
last block), checks both against ``detect_block_plain``, and prints one
JSON line: for each block the launch's span, the median block time, the
median and largest time of each phase (the prefix sums, the t-stats, the
speculation, the repair rounds, the outputs, the carry), and the repair
rounds a row.  The card's name and power limit lead the output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from ..ops import _cuda
from ..ops import events as ev

PHASES = ("prefix", "tstats", "speculate", "repair", "outputs", "carry")


def pa_signal(rng, B, n):
    """Seeded signal in pA: k-mer levels ~ N(90, 12) held for a geometric
    number of samples (mean 9), plus N(0, 1.5) noise, clipped to [40, 140]
    (chip_smoke.py's detect_signals)."""
    seg = np.minimum(np.cumsum(rng.random((B, n)) < 1 / 9, axis=1), n - 1)
    lv = rng.normal(90.0, 12.0, (B, n))
    x = np.take_along_axis(lv, seg, 1) + rng.normal(0.0, 1.5, (B, n))
    return np.clip(x, 40.0, 140.0).astype(np.float32)


def same_bits(a, b) -> bool:
    """Every tensor of two (state, out) pairs equal bit for bit."""
    views = {torch.float32: torch.int32, torch.float64: torch.int64,
             torch.bool: torch.uint8}
    for da, db in zip(a, b):
        for k in da:
            x, y = da[k], db[k]
            if x.dtype in views:
                x, y = x.view(views[x.dtype]), y.view(views[y.dtype])
            if not torch.equal(x, y):
                return False
    return True


def build() -> str:
    out = os.path.join(_cuda.BUILD_DIR, "phases")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libdetect.so")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-DDETECT_PHASES",
                    "-o", so, os.path.join(_cuda.SRC_DIR, "detect.cu")],
                   check=True, capture_output=True)
    return so


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=512)
    ap.add_argument("--S", type=int, default=4096)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("detect_phases: no CUDA device")
        return 2
    B, S = args.B, args.S
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    _cuda._paths["detect"] = build()
    lib = _cuda._lib("detect")
    dev = torch.device("cuda")
    rng = np.random.default_rng(20261017)
    seeded = pa_signal(rng, B, S)
    padded = pa_signal(rng, B, S)
    lens = rng.integers(S // 8, S, B)
    padded[np.arange(S)[None, :] >= lens[:, None]] = 0.0
    st = ev.make_detector_state(B, dev)
    res = {}
    for name, sig in (("seeded", seeded), ("padded", padded)):
        x = torch.from_numpy(sig).to(dev)
        rounds = torch.zeros(B, dtype=torch.int32, device=dev)
        for _ in range(3):  # warm, then the stamped launch
            got = ev.detect_block(st, x, rounds=rounds)
        torch.cuda.synchronize()
        h = np.zeros(1024 * 8, np.uint64)
        if lib.detect_stamps(ctypes.c_void_p(h.ctypes.data)) != 0:
            raise RuntimeError("detect_stamps failed")
        n = min(B, 1024)
        h = h.reshape(1024, 8)[:n].astype(np.int64)
        ph = np.diff(h[:, :7], axis=1) / 1e3
        r = rounds.cpu().numpy()
        res[name] = dict(
            bit_equal=same_bits(got, ev.detect_block_plain(st, x)),
            span_us=float((h[:, 6].max() - h[:, 0].min()) / 1e3),
            block_us_median=float(np.median(h[:, 6] - h[:, 0]) / 1e3),
            phase_us_median=dict(zip(PHASES, np.median(ph, 0).tolist())),
            phase_us_max=dict(zip(PHASES, ph.max(0).tolist())),
            blocks_an_sm_max=int(np.bincount(h[:, 7]).max()),
            rounds_max=int(r.max()), rounds_mean=float(r.mean()))
    print(json.dumps(dict(B=B, S=S, **res)))
    return 0 if all(v["bit_equal"] for v in res.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
