"""fast5 (HDF5) read loading via h5py.

Supports both single-read and multi-read fast5 layouts, mirroring the
reference's Fast5Reader detection logic (fast5_reader.cpp:35-43,125-181).

Calibration parity note: the reference iterates the int16 signal as u16
(read_buffer.cpp:239: ``for (u16 raw : int_data)``), so negative raw values
wrap mod 65536 before calibration. We reproduce that intentionally.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None


@dataclass
class Read:
    id: str
    channel: int  # 1-based channel number
    number: int
    start_sample: int
    signal: np.ndarray  # calibrated float32 [n]

    @property
    def raw_len(self) -> int:
        return len(self.signal)


def _attr(obj, name, default=None):
    v = obj.attrs.get(name, default)
    if isinstance(v, bytes):
        return v.decode()
    return v


def _calibrate(raw: np.ndarray, digitisation, offset, rng) -> np.ndarray:
    # u16-cast parity with the reference (see module docstring)
    as_u16 = raw.astype(np.int64) & 0xFFFF
    return (
        np.float32(rng) * (as_u16.astype(np.float32) + np.float32(offset))
    ) / np.float32(digitisation)


def _load_single(f) -> list[Read]:
    reads = []
    ch = f["UniqueGlobalKey/channel_id"]
    channel = int(_attr(ch, "channel_number"))
    digit = float(_attr(ch, "digitisation"))
    offset = float(_attr(ch, "offset"))
    rng = float(_attr(ch, "range"))
    for name, grp in f["Raw/Reads"].items():
        raw = grp["Signal"][:]
        reads.append(
            Read(
                id=_attr(grp, "read_id"),
                channel=channel,
                number=int(_attr(grp, "read_number", 0)),
                start_sample=int(_attr(grp, "start_time", 0)),
                signal=_calibrate(raw, digit, offset, rng),
            )
        )
    return reads


def _load_multi(f) -> list[Read]:
    reads = []
    for name in f:
        if not name.startswith("read_"):
            continue
        grp = f[name]
        ch = grp["channel_id"]
        raw = grp["Raw/Signal"][:]
        reads.append(
            Read(
                id=_attr(grp["Raw"], "read_id", name[5:]),
                channel=int(_attr(ch, "channel_number")),
                number=int(_attr(grp["Raw"], "read_number", 0)),
                start_sample=int(_attr(grp["Raw"], "start_time", 0)),
                signal=_calibrate(
                    raw,
                    float(_attr(ch, "digitisation")),
                    float(_attr(ch, "offset")),
                    float(_attr(ch, "range")),
                ),
            )
        )
    return reads


def load_fast5(path: str) -> list[Read]:
    if h5py is None:
        raise RuntimeError("h5py is required for fast5 reading")
    with h5py.File(path, "r") as f:
        if "Raw/Reads" in f:
            return _load_single(f)
        return _load_multi(f)


def iter_fast5_paths(paths, recursive: bool = False):
    """Expand a mix of .fast5 files, directories, list files, and
    comma-separated strings into fast5 paths (reference scripts/uncalled:78-116)."""
    for p in paths:
        if "," in p:
            yield from iter_fast5_paths(p.split(","), recursive)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                for fn in sorted(files):
                    if fn.endswith(".fast5"):
                        yield os.path.join(root, fn)
                if not recursive:
                    break
        elif p.endswith(".fast5"):
            yield p
        elif os.path.isfile(p):
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield from iter_fast5_paths([line], recursive)


def iter_reads(paths, recursive: bool = False, max_reads: int = 0, read_filter=None):
    n = 0
    for fp in iter_fast5_paths(paths, recursive):
        for read in load_fast5(fp):
            if read_filter and read.id not in read_filter:
                continue
            yield read
            n += 1
            if max_reads and n >= max_reads:
                return
