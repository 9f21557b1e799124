import numpy as np

from benchmark.harness.core import cell_files
from benchmark.traffic import genome as gen
from benchmark.traffic.reads import ReadStream, load_levels, make_read

REPEATS = cell_files("ecoli_map.isolate")[1]["genome"]["repeats"]
MIX = dict(read_len_bp=[1000, 4000], mean_dwell=9.6,
           mismatch=dict(noise=1.25, drift_scale_sd=0.02, drift_shift_sd=1.5,
                         stall_p=0.01, skip_p=0.03, slow_drift=2.0))


def test_markov_is_the_sequential_chain():
    rng = np.random.default_rng(3)
    got = gen.markov(rng, 5000)
    rng = np.random.default_rng(3)
    b = int(rng.integers(4))
    want = []
    for u in rng.random(5000):
        b = int(np.searchsorted(gen._CUM[b], u))
        want.append(b)
    assert np.array_equal(got, np.array(want))


def test_genome_is_deterministic_per_seed():
    a = gen.realistic_genome(200_000, np.random.default_rng([7, 1]), REPEATS)
    b = gen.realistic_genome(200_000, np.random.default_rng([7, 1]), REPEATS)
    c = gen.realistic_genome(200_000, np.random.default_rng([8, 1]), REPEATS)
    assert a.dtype == np.uint8 and a.max() <= 3
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # the base bias of the chain's stationary distribution
    frac = np.bincount(a, minlength=4) / len(a)
    assert np.all(np.abs(frac - 0.25) < 0.03)


def test_reads_are_deterministic_per_seed_and_number():
    g = gen.realistic_genome(100_000, np.random.default_rng([1, 1]), REPEATS)
    lv = load_levels()
    big = 2**31 + 12345
    r1 = make_read(g, big, 17, MIX, lv)
    r2 = make_read(g, big, 17, MIX, lv)
    r3 = make_read(g, big + 1, 17, MIX, lv)
    assert r1.id == r2.id and np.array_equal(r1.signal, r2.signal)
    assert r1.signal.dtype == np.float32
    assert not np.array_equal(r1.signal[:100], r3.signal[:100])
    s = ReadStream(g, big, MIX, lv)
    ids = [next(s).id for _ in range(20)]
    assert ids[17] == r1.id and len(set(ids)) == 20
    s.stop()
    assert list(s) == []


def test_read_lengths_follow_the_mix():
    g = gen.realistic_genome(100_000, np.random.default_rng([1, 1]), REPEATS)
    lv = load_levels()
    lens = [len(make_read(g, 5, i, MIX, lv).signal) for i in range(40)]
    # ~9.6 samples a base (with stalls and skips) over 1-4 kb
    assert 5_000 < min(lens) and max(lens) < 60_000


def test_produced_stream_is_the_same_stream():
    g = gen.realistic_genome(100_000, np.random.default_rng([1, 1]), REPEATS)
    lv = load_levels()
    big = 2**31 + 777
    s = ReadStream(g, big, MIX, lv, ahead=5)
    try:
        s.fill()
        assert len(s._buf) == 5
        s.timing = True
        got = [next(s) for _ in range(12)]  # past the buffer
        assert s.waits == 12 and s.pulled == 12
    finally:
        s.close()
    assert not s._procs
    for i in (0, 4, 5, 11):
        r = make_read(g, big, i, MIX, lv)
        assert got[i].id == r.id and np.array_equal(got[i].signal, r.signal)
