"""The port's streaming event detector (``ops/events.py`` ``detect_block``,
the plain version the CPU runs) against the JAX ``detect_block``, bit for
bit: every output and every state field after every block, at blocks of 512
and 4096 samples, with rows reset mid-stream; batch against solo; the
exactness precondition on every signal used; and a numpy replay of the
parallel prefix-scan order of ``csrc/detect.cu``.  The CUDA kernel itself
runs on the card (``chip_smoke.py`` phase 2); here its wrapper's launch
path is checked with a stand-in launcher."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

FX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")

# one intra-op thread: the suite runs several pytest workers side by side,
# and spinning torch thread pools in each of them starve one another
torch.set_num_threads(1)

READS = ("f41a60f7-de4a-4b17-9f54-387e52d60b65",
         "sim_0005_Escherichia_coli_3483_+", "noise_1")


@pytest.fixture(scope="module", autouse=True)
def _x64():
    """The JAX detector turns on jax_enable_x64; restore it after."""
    was = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", was)


def signals(n):
    """[5, n] rows: three golden reads from their first sample, a constant
    row (its t-stat windows divide a flushed subnormal: NaN t-stats in
    JAX) and a near-constant one (two neighbouring f32 values)."""
    g = np.load(os.path.join(FX, "golden_reads.npz"))
    rows = np.zeros((5, n), np.float32)
    for i, r in enumerate(READS):
        s = g[r][:n]
        rows[i, : len(s)] = s
    rows[3] = 77.0
    rng = np.random.default_rng(5)
    rows[4] = np.where(rng.random(n) < 0.5, np.float32(91.25),
                       np.nextafter(np.float32(91.25), np.float32(100)))
    rows[4, 100:300] = 91.25  # and a constant stretch inside it
    return rows


def bits(a):
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32)
    if a.dtype == np.float64:
        return a.view(np.int64)
    return a


def assert_same(want, got, what):
    want, got = np.asarray(want), np.asarray(got)
    assert want.dtype == got.dtype, (what, want.dtype, got.dtype)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    bad = bits(want) != bits(got)
    assert not bad.any(), (what, int(bad.sum()), np.argwhere(bad)[:5])


def replay_prefix(xs, p0, nt=256, seg=16):
    """csrc/detect.cu's prefix order over a block's TAIL + S samples: in
    chunks of nt * seg samples, each chunk's prefixes P[c0 + q] (q < n +
    20, the windows' reach past its n samples) by one scan from the exact
    run at c0, the chunk's own prefixes kept.  In the scan each of the nt
    threads sums its v = ceil(count / nt) samples left to right
    (np.add.accumulate is sequential), each warp of 32 threads scans its
    thread totals by shuffles (Hillis-Steele: at offsets 1, 2, 4, 8, 16 a
    lane adds the lane that far below), a warp's offset is the earlier
    warps' totals summed left to right from 0, and a sample's partial sum
    is ((carry + warp offset) + lane offset) + its thread's running sum.
    The block's carry p0 is added to every partial sum."""
    x = np.asarray(xs, np.float64)
    n_p = len(x) + 1
    S = len(x) - 12
    ch = nt * seg
    lane = np.arange(32)

    def scan(part_x, carry):
        n = len(part_x)
        v = -(-n // nt)
        part = np.zeros(nt * v)
        part[:n] = part_x
        acc = np.add.accumulate(part.reshape(nt, v), axis=1)
        s = acc[:, -1].reshape(nt // 32, 32)
        for off in (1, 2, 4, 8, 16):
            up = np.concatenate([np.zeros((len(s), off)), s[:, :-off]], 1)
            s = np.where(lane >= off, up + s, s)
        excl = np.concatenate([np.zeros((len(s), 1)), s[:, :-1]], 1)
        woff = np.zeros(len(s))
        for w in range(1, len(s)):
            woff[w] = woff[w - 1] + s[w - 1, -1]
        base = ((carry + woff[:, None]) + excl).reshape(nt, 1)
        return np.concatenate([[carry], (base + acc).reshape(-1)[:n]])

    out = np.empty(n_p)
    r = 0.0
    for c0 in range(0, S, ch):
        n = min(ch, S - c0)
        nq = min(n + 20, n_p - c0)
        run = scan(x[c0: c0 + nq - 1], r)
        keep = nq if c0 + n == S else n
        out[c0: c0 + keep] = run[:keep]
        r = run[n]
    return out + p0


# S = 24 = 2 * TAIL: the smallest block JAX takes
@pytest.mark.parametrize("S,nb", [(512, 4), (4096, 2), (24, 6)])
def test_detect_block_matches_jax(S, nb):
    from uncalled_tpu.ops import events as je
    from uncalled_tpu_torch.ops import events as te

    sig = signals(S * nb)
    for row in sig:
        assert te.prefix_sums_exact(row)
    B = sig.shape[0]
    js = je.make_detector_state(B)
    ts = te.make_detector_state(B)
    for k in te.STATE_KEYS:
        assert_same(js[k], ts[k].numpy(), f"initial {k}")
    reset = np.zeros(B, bool)
    reset[[1, 3]] = True
    n_fired = 0
    for b in range(nb):
        if b == 1:  # rows 1 and 3 start a new read mid-stream
            js = je.reset_detector_rows(js, jnp.asarray(reset))
            ts = te.reset_detector_rows(ts, torch.from_numpy(reset))
        blk = sig[:, b * S: (b + 1) * S]
        p0 = (ts["S0"].numpy().copy(), ts["SQ0"].numpy().copy())
        tail = ts["tail"].numpy().copy()
        js, jo = je.detect_block(js, jnp.asarray(blk))
        ts, to = te.detect_block(ts, torch.from_numpy(blk))
        for k in te.OUT_KEYS:
            assert_same(jo[k], to[k].numpy(), f"block {b} out {k}")
        for k in te.STATE_KEYS:
            assert_same(js[k], ts[k].numpy(), f"block {b} state {k}")
        # the kernel's summation order gives the same prefix carry
        xs = np.concatenate([tail, blk], 1)
        for r in range(B):
            P = replay_prefix(xs[r], p0[0][r])
            Q = replay_prefix(xs[r] * xs[r], p0[1][r])
            assert bits(P[S]) == bits(ts["S0"].numpy()[r])
            assert bits(Q[S]) == bits(ts["SQ0"].numpy()[r])
        n_fired += int(to["fired"].sum())
    assert n_fired > 0
    # the constant row's t-stats are NaN after the warm-up: no events
    assert not bool(to["fired"][3].any())


def test_tstats_prefixes_replay_kernel_order():
    """Every prefix array the plain t-stats build (a left-to-right
    cumsum) equals the kernel's parallel scan order plus the carry, on a
    carried block of exact signals (with 32 threads a chunk is 512
    samples, so the chunk carry runs long)."""
    from uncalled_tpu_torch.ops import events as te

    for S, nt in ((512, 256), (4096, 256), (4096, 32)):
        sig = signals(2 * S)
        for row in sig:
            assert te.prefix_sums_exact(row)
        st = te.make_detector_state(sig.shape[0])
        st, _ = te.detect_block(st, torch.from_numpy(sig[:, :S]))
        blk = sig[:, S:]
        _, _, S1, SQ1 = te._tstats_block(torch.from_numpy(blk), st["tail"],
                                         st["S0"], st["SQ0"], st["t"])
        xs = np.concatenate([st["tail"].numpy(), blk], 1)
        for r in range(sig.shape[0]):
            assert_same(replay_prefix(xs[r], st["S0"].numpy()[r], nt),
                        S1[r].numpy(), f"S1 row {r}")
            assert_same(replay_prefix(xs[r] * xs[r], st["SQ0"].numpy()[r],
                                      nt), SQ1[r].numpy(), f"SQ1 row {r}")
    # the order is the kernel's own: on sums that round it differs from
    # the left-to-right one
    x = np.array([1e-3, 3e7] * 700, np.float32)
    assert not te.prefix_sums_exact(x)
    seq = np.concatenate([[0.0], np.add.accumulate(x.astype(np.float64))])
    assert (bits(replay_prefix(x, 0.0)) != bits(seq)).any()


def test_detect_block_batch_equals_solo():
    from uncalled_tpu_torch.ops import events as te

    S = 512
    sig = signals(2 * S)[:3]
    bs = te.make_detector_state(3)
    solos = [te.make_detector_state(1) for _ in range(3)]
    for b in range(2):
        blk = torch.from_numpy(sig[:, b * S: (b + 1) * S])
        bs, bo = te.detect_block(bs, blk)
        for r in range(3):
            solos[r], so = te.detect_block(solos[r], blk[r: r + 1])
            for k in te.OUT_KEYS:
                assert_same(bo[k][r: r + 1].numpy(), so[k].numpy(), k)
            for k in te.STATE_KEYS:
                v = bs[k][:, r: r + 1] if bs[k].shape[0] == 2 else \
                    bs[k][r: r + 1]
                assert_same(v.numpy(), solos[r][k].numpy(), k)


@pytest.mark.parametrize("S", [512, 4096])
def test_detect_block_streams_like_the_host_detector(S):
    """Concatenated over blocks, the fired events start where the host
    detector's do (tests/test_events.py's own check of the JAX detector,
    on the port)."""
    from uncalled_tpu_torch.ops import events as te

    g = np.load(os.path.join(FX, "golden_reads.npz"))
    x = g["sim_0008_Escherichia_coli_1891_+"]
    want = te.detect_events_np(x)
    st = te.make_detector_state(1)
    means, starts = [], []
    n = (len(x) // S) * S
    for i in range(0, n, S):
        st, out = te.detect_block(st, torch.from_numpy(x[None, i: i + S]))
        f = out["fired"][0].numpy()
        means.append(out["mean"][0].numpy()[f])
        starts.append(out["start"][0].numpy()[f])
    means, starts = np.concatenate(means), np.concatenate(starts)
    k = min(np.searchsorted(want["start"], n - 16), len(means))
    assert k > 100
    np.testing.assert_array_equal(starts[:k], want["start"][:k])
    np.testing.assert_allclose(means[:k], want["mean"][:k], rtol=2e-5,
                               atol=2e-3)


def test_prefix_sums_exact_precondition():
    from uncalled_tpu_torch.ops import events as te

    g = np.load(os.path.join(FX, "golden_reads.npz"))
    for k in g.files:
        assert te.prefix_sums_exact(g[k]), k
    # a tiny step beside a huge one: partial sums would round
    assert not te.prefix_sums_exact(np.array([1e-3, 3e7] * 1000, np.float32))
    assert not te.prefix_sums_exact(np.array([1e-40, 5.0], np.float32))
    assert te.prefix_sums_exact(np.zeros(10, np.float32))


def test_reset_detector_rows_matches_jax():
    from uncalled_tpu.ops import events as je
    from uncalled_tpu_torch.ops import events as te

    S = 512
    sig = signals(S)
    js, _ = je.detect_block(je.make_detector_state(5), jnp.asarray(sig))
    ts, _ = te.detect_block(te.make_detector_state(5), torch.from_numpy(sig))
    mask = np.array([True, False, True, False, False])
    js = je.reset_detector_rows(js, jnp.asarray(mask))
    ts = te.reset_detector_rows(ts, mask)
    for k in te.STATE_KEYS:
        assert_same(js[k], ts[k].numpy(), k)


def test_detect_block_launch_off_the_cpu(monkeypatch):
    """A signal off the CPU goes to the launcher with every state tensor,
    the new state, the outputs and the rounds tensor (the caller's, or a
    scratch one; the kernel keeps its prefix sums in shared memory), and
    counts one launch; the plain version never runs there; short blocks,
    wrong dtypes, wrong state shapes and a wrong rounds tensor raise."""
    from uncalled_tpu_torch.ops import _cuda
    from uncalled_tpu_torch.ops import events as te

    seen = []

    def fake_launch(name, *args):
        seen.append((name, [(tuple(t.shape), t.dtype) for t in args[0]],
                     args[1:]))

    def refuse(*a):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(_cuda, "launch", fake_launch)
    monkeypatch.setattr(_cuda, "COUNTS", dict.fromkeys(_cuda.COUNTS, 0))
    monkeypatch.setattr(te, "detect_block_plain", refuse)
    B, S = 512, 4096
    st = {k: v.to("meta") for k, v in te.make_detector_state(B).items()}
    sig = torch.empty((B, S), dtype=torch.float32, device="meta")
    new, out = te.detect_block(st, sig)
    assert set(new) == set(te.STATE_KEYS) and set(out) == set(te.OUT_KEYS)
    assert out["fired"].dtype == torch.bool and out["start"].shape == (B, S)
    assert [(k, new[k].shape, new[k].dtype) for k in te.STATE_KEYS] == \
        [(k, st[k].shape, st[k].dtype) for k in te.STATE_KEYS]
    (name, shapes, ints), = seen
    assert name == "detect_block_f32" and ints == (B, S)
    assert len(shapes) == 1 + 2 * len(te.STATE_KEYS) + len(te.OUT_KEYS) + 1
    assert shapes[0] == ((B, S), torch.float32)
    assert shapes[-1] == ((B,), torch.int32)
    assert _cuda.COUNTS == dict(dict.fromkeys(_cuda.COUNTS, 0), detect=1)
    rounds = torch.empty(B, dtype=torch.int32, device="meta")
    te.detect_block(st, sig, rounds=rounds)
    assert seen[-1][1][-1] == ((B,), torch.int32)
    assert _cuda.COUNTS["detect"] == 2
    with pytest.raises(ValueError):
        te.detect_block(st, sig, rounds=rounds[:-1])
    with pytest.raises(TypeError):
        te.detect_block(st, sig, rounds=rounds.long())
    with pytest.raises(ValueError, match="2 \\* TAIL"):
        te.detect_block(st, sig[:, : 2 * te.TAIL - 1])
    with pytest.raises(TypeError):
        te.detect_block(st, sig.to(torch.float64))
    with pytest.raises(ValueError):
        te.detect_block(dict(st, tail=st["tail"][:, :3]), sig)
    with pytest.raises(TypeError):
        te.detect_block(dict(st, S0=st["S0"].float()), sig)
