"""The port's std_sort is the JAX package's libstdc++ std::sort replica:
the g++ probe's permutations in introsort_golden.json, the heap fallback,
and a differential against JAX's std_sort on seeded tie-heavy arrays,
with and without the fallback (zero tolerance: the permutations equal)."""

import json
import os

import numpy as np
import pytest

from uncalled_tpu.mapping.introsort import std_sort as jax_std_sort
from uncalled_tpu_torch.mapping.introsort import std_sort

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _key(r):
    return (r[0], r[1], r[2])


def _recs(rng, n, pool):
    """n records keyed on (start, end, f32 prob) drawn from ``pool``
    values each, so most keys tie; the last field is the creation index."""
    return [(int(rng.integers(pool)), int(rng.integers(pool)),
             np.float32(rng.integers(pool)), i) for i in range(n)]


def test_golden_permutations():
    with open(os.path.join(FX, "introsort_golden.json")) as f:
        cases = json.load(f)
    for arr, want in cases:
        recs = [(s, e, np.float32(p), i) for i, (s, e, p) in enumerate(arr)]
        got = std_sort(list(recs), key=_key)
        assert [r[3] for r in got] == want, f"n={len(arr)}"


def test_heap_fallback():
    """_depth_limit=0 takes the __partial_sort path (heap_select +
    sort_heap) for every range past the threshold: a total order on the
    keys, a tie permutation of its own, and JAX's permutation."""
    rng = np.random.default_rng(3)
    recs = [(int(rng.integers(2)), 0, np.float32(0), i) for i in range(64)]
    heap = std_sort(list(recs), key=_key, _depth_limit=0)
    intro = std_sort(list(recs), key=_key)
    assert [r[0] for r in heap] == sorted(r[0] for r in recs)
    assert [r[0] for r in intro] == sorted(r[0] for r in recs)
    assert [r[3] for r in heap] != [r[3] for r in intro]
    assert heap == jax_std_sort(list(recs), key=_key, _depth_limit=0)


@pytest.mark.parametrize("fallback", [False, True], ids=["intro", "heap"])
@pytest.mark.parametrize("group", range(8))
def test_differential_vs_jax(group, fallback):
    """25 seeded arrays a case, 400 in all: sizes 0-200 (the threshold's
    neighbours among them), pools of 1-8 values a key."""
    rng = np.random.default_rng(1000 * group + fallback)
    depth = 0 if fallback else None
    sizes = [0, 1, 2, 15, 16, 17, 33, 200] + list(rng.integers(0, 201, 17))
    for n in sizes:
        pool = int(rng.choice([1, 2, 3, 8]))
        recs = _recs(rng, int(n), pool)
        got = std_sort(list(recs), key=_key, _depth_limit=depth)
        want = jax_std_sort(list(recs), key=_key, _depth_limit=depth)
        assert [r[3] for r in got] == [r[3] for r in want], (n, pool)
        assert [_key(r) for r in got] == sorted(_key(r) for r in recs)
