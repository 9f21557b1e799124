"""The port's fast5 input (``uncalled_tpu_torch/io/fast5.py``) against the
JAX package's: single- and multi-read files written here with h5py from
seeded int16 data (negative samples among them, for the reference's u16
wrap before calibration), str and bytes attributes, and the path forms
``iter_reads`` accepts (files, directories with and without ``recursive``,
list files, comma lists) with ``max_reads`` and ``read_filter``.  Every
field of every ``Read`` must equal JAX's: integers equal, the calibrated
signal as raw f32 bits."""

import os

import h5py
import numpy as np
import pytest

from uncalled_tpu.io import fast5 as jf5
from uncalled_tpu_torch.io import fast5 as tf5


def _channel_attrs(grp, rng, channel, as_bytes):
    enc = (lambda s: s.encode()) if as_bytes else (lambda s: s)
    grp.attrs["channel_number"] = enc(str(channel))
    grp.attrs["digitisation"] = 8192.0
    grp.attrs["offset"] = float(rng.integers(-20, 20))
    grp.attrs["range"] = 1402.0 + float(rng.random())


def _raw(rng, n):
    # pA-like values with a tail of negative samples: the reference reads
    # them as u16, so -3 calibrates as 65533
    raw = rng.integers(300, 900, n).astype(np.int16)
    neg = rng.random(n) < 0.05
    raw[neg] = rng.integers(-32768, 0, n)[neg]
    return raw


def write_multi(path, rng, ids, as_bytes=False):
    enc = (lambda s: s.encode()) if as_bytes else (lambda s: s)
    with h5py.File(path, "w") as f:
        for i, rid in enumerate(ids):
            g = f.create_group(f"read_{rid}")
            r = g.create_group("Raw")
            r.create_dataset("Signal", data=_raw(rng, int(rng.integers(50, 400))))
            if i % 3 != 2:  # the read id falls back to the group name
                r.attrs["read_id"] = enc(rid)
            r.attrs["read_number"] = int(rng.integers(1, 1000))
            r.attrs["start_time"] = int(rng.integers(0, 1 << 40))
            _channel_attrs(g.create_group("channel_id"), rng,
                           int(rng.integers(1, 513)), as_bytes)
        f.create_group("not_a_read")


def write_single(path, rng, rid, as_bytes=False):
    enc = (lambda s: s.encode()) if as_bytes else (lambda s: s)
    with h5py.File(path, "w") as f:
        _channel_attrs(f.create_group("UniqueGlobalKey/channel_id"), rng,
                       int(rng.integers(1, 513)), as_bytes)
        g = f.create_group(f"Raw/Reads/Read_{int(rng.integers(1, 99))}")
        g.create_dataset("Signal", data=_raw(rng, int(rng.integers(50, 400))))
        g.attrs["read_id"] = enc(rid)
        g.attrs["read_number"] = int(rng.integers(1, 1000))
        if not as_bytes:  # start_time defaults to 0
            g.attrs["start_time"] = int(rng.integers(0, 1 << 40))


def same_reads(got, want):
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert type(a).__name__ == type(b).__name__ == "Read"
        for k in ("id", "channel", "number", "start_sample", "raw_len"):
            assert getattr(a, k) == getattr(b, k), k
            assert type(getattr(a, k)) is type(getattr(b, k)), k
        assert a.signal.dtype == b.signal.dtype == np.float32
        np.testing.assert_array_equal(a.signal.view(np.uint32),
                                      b.signal.view(np.uint32))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """d/a.fast5 (multi, str attrs), d/b.fast5 (single, bytes attrs),
    d/notes.txt, d/sub/c.fast5 (multi, bytes), d/sub/e.fast5 (single, str),
    and a list file naming c and b."""
    rng = np.random.default_rng(9)
    d = tmp_path_factory.mktemp("f5")
    os.makedirs(d / "sub")
    write_multi(d / "a.fast5", rng, [f"r{i}" for i in range(5)])
    write_single(d / "b.fast5", rng, "single_b", as_bytes=True)
    (d / "notes.txt").write_text("not a fast5 file\n")
    write_multi(d / "sub" / "c.fast5", rng, [f"c{i}" for i in range(4)],
                as_bytes=True)
    write_single(d / "sub" / "e.fast5", rng, "single_e")
    lst = d / "list.txt"
    lst.write_text(f"{d / 'sub' / 'c.fast5'}\n\n{d / 'b.fast5'}\n")
    return d


@pytest.mark.parametrize("name", ["a.fast5", "b.fast5", "sub/c.fast5",
                                  "sub/e.fast5"])
def test_load_fast5_matches_jax(tree, name):
    got = tf5.load_fast5(str(tree / name))
    same_reads(got, jf5.load_fast5(str(tree / name)))
    if name.endswith("a.fast5"):
        assert [r.id for r in got] == ["r0", "r1", "r2", "r3", "r4"]


def test_calibrate_wraps_negative_samples():
    raw = np.array([-3, 5, -32768, 32767], np.int16)
    got = tf5._calibrate(raw, 8192.0, 10.0, 1402.0)
    want = jf5._calibrate(raw, 8192.0, 10.0, 1402.0)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got[0] == np.float32(1402.0) * np.float32(65533 + 10) \
        / np.float32(8192.0)


def _paths(tree, form):
    d = str(tree)
    return {
        "dir": [d],
        "dir_recursive": [d],
        "list_file": [str(tree / "list.txt")],
        "comma_list": [f"{tree / 'sub' / 'e.fast5'},{tree / 'a.fast5'}"],
        # a text file whose line names no path is an empty list file
        "mixed": [str(tree / "b.fast5"), str(tree / "sub"),
                  str(tree / "notes.txt")],
    }[form]


@pytest.mark.parametrize("form", ["dir", "dir_recursive", "list_file",
                                  "comma_list", "mixed"])
@pytest.mark.parametrize("max_reads,filt", [(0, None), (3, None),
                                            (0, {"r1", "c2", "single_e",
                                                 "single_b", "r4"}),
                                            (2, {"r3", "c0", "c3"})])
def test_iter_reads_matches_jax(tree, form, max_reads, filt):
    rec = form == "dir_recursive"
    paths = _paths(tree, form)
    assert list(tf5.iter_fast5_paths(paths, rec)) == \
        list(jf5.iter_fast5_paths(paths, rec))
    got = list(tf5.iter_reads(paths, recursive=rec, max_reads=max_reads,
                              read_filter=filt))
    want = list(jf5.iter_reads(paths, recursive=rec, max_reads=max_reads,
                               read_filter=filt))
    if want:
        same_reads(got, want)
    else:
        assert got == []
    if max_reads:
        assert len(got) <= max_reads
    if filt:
        assert {r.id for r in got} <= filt


def test_without_h5py_raises_as_jax(tree, monkeypatch):
    monkeypatch.setattr(tf5, "h5py", None)
    monkeypatch.setattr(jf5, "h5py", None)
    with pytest.raises(RuntimeError) as got:
        tf5.load_fast5(str(tree / "a.fast5"))
    with pytest.raises(RuntimeError) as want:
        jf5.load_fast5(str(tree / "a.fast5"))
    assert str(got.value) == str(want.value) == \
        "h5py is required for fast5 reading"
