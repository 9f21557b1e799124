"""A numpy model of ``csrc/detect.cu``'s schedule, held bit for bit to the
port's plain detector (``detect_block_plain``) and to the JAX
``detect_block``.

The kernel runs each row's peak detectors as a segmented speculative scan:
every segment of ``L`` samples is run by its own thread from a guessed
carry (speculate), then rerun from its predecessor's end carry in lockstep
with its old run until the two carries are equal bit for bit (repair),
round after round until no segment's start changes.  A detector carry that
has reached its fixed point under NaN t-stats (a constant stretch, a
zero-padded tail) jumps over the rest of the stretch, and a run of
all-NaN segments takes the fixed point of the first one in one round.
The per-sample outputs follow from the fire bits (a "last fire before"
scan), ``total_events`` from a popcount, and ``len_sum`` telescopes where
every partial sum is an integer of at most 2^24 (in fire order otherwise).

The model below is that schedule in numpy, vectorised over the segments
as the kernel's threads run them; the per-sample arithmetic (t-stats,
mean, stdv) is the plain version's.  The cases: seeded pA rows, rows
zero-padded from a random length (``BatchMapper._prepare_wave``'s shape),
a constant row and a constant stretch across a block edge, rows reset
mid-stream, S = 24, 1000, 1537 and 4096 with L not dividing S, several
chunks a row, and a ``len_sum`` beyond 2^24; and the fixed-point jump
against the serial step on random carries."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# one intra-op thread: the suite runs several pytest workers side by side
torch.set_num_threads(1)

NT, L = 256, 16  # csrc/detect.cu: threads a block, samples a segment
WU = 12  # csrc/detect.cu: samples a guess runs before its segment
F32 = np.float32
FLT_MAX = F32(np.finfo(np.float32).max)
T1, T2, PH = F32(1.4), F32(9.0), F32(0.2)
TWO24 = 1 << 24
FIELDS = ("pp0", "pv0", "vd0", "mt1", "pp1", "pv1", "vd1")


@pytest.fixture(scope="module", autouse=True)
def _x64():
    """The JAX detector turns on jax_enable_x64; restore it after."""
    was = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", was)


# --------------------------------------------------------------------------
# the detector carry: one step, its NaN fixed point, comparison
# --------------------------------------------------------------------------

def _peak(cur, m, thresh, whalf, mt, pp, pv, vd):
    """One peak detector at one sample (csrc/detect.cu peak_det)."""
    act = (m < 0) | (mt < m)
    no_peak = pp == -1
    rise = (cur - pv) > PH
    higher = cur > pv
    pv2 = np.where(higher, cur, pv)
    pp2 = np.where(higher, m, pp)
    vd2 = vd | (((pv2 - cur) > PH) & (pv2 > thresh))
    fire = vd2 & ((m - pp2) > whalf)
    set_pv = act & np.where(no_peak, (cur < pv) | rise, higher | fire)
    new_pp = np.where(act, np.where(no_peak, np.where(rise, m, pp),
                                    np.where(fire, -1, pp2)), pp)
    new_vd = np.where(act & ~no_peak, vd2 & ~fire, vd)
    return (act & ~no_peak & fire, new_pp.astype(np.int32),
            np.where(set_pv, cur, pv).astype(F32), new_vd)


def step(s, c1, c2, m, mt0):
    """Both detectors at one sample (csrc/detect.cu fsm_step): the short
    one's case-2 peak above its threshold resets the long one first.
    Returns (carry', fired)."""
    with np.errstate(all="ignore"):
        s_act = (m < 0) | (mt0 < m)
        s_hi = c1 > s["pv0"]
        s_pv2 = np.where(s_hi, c1, s["pv0"])
        s_pp2 = np.where(s_hi, m, s["pp0"])
        dom = s_act & (s["pp0"] != -1) & (s_pv2 > T1)
        mt1 = np.where(dom, s_pp2 + 3, s["mt1"]).astype(np.int32)
        pp1 = np.where(dom, -1, s["pp1"]).astype(np.int32)
        pv1 = np.where(dom, FLT_MAX, s["pv1"]).astype(F32)
        vd1 = s["vd1"] & ~dom
        f0, pp0, pv0, vd0 = _peak(c1, m, T1, 1, mt0, s["pp0"], s["pv0"],
                                  s["vd0"])
        f1, pp1, pv1, vd1 = _peak(c2, m, T2, 3, mt1, pp1, pv1, vd1)
    return dict(pp0=pp0, pv0=pv0, vd0=vd0, mt1=mt1, pp1=pp1, pv1=pv1,
                vd1=vd1), f0 | f1


def fixed_nan(s):
    """True where the carry is a fixed point of the step under NaN t-stats
    at every later sample (csrc/detect.cu fixed_nan): the short detector
    holds no valid peak (it cannot fire), and the long one either is
    already what the short one's standing dominance resets it to, or
    (no dominance) holds no valid peak."""
    with np.errstate(invalid="ignore"):
        dom = (s["pp0"] != -1) & (s["pv0"] > T1)
    is_d = ((s["mt1"] == s["pp0"] + 3) & (s["pp1"] == -1)
            & (s["pv1"].view(np.int32) == FLT_MAX.view(np.int32))
            & ~s["vd1"])
    return (((s["pp0"] == -1) | ~s["vd0"])
            & np.where(dom, is_d, (s["pp1"] == -1) | ~s["vd1"]))


def short_dead(s):
    """True where the short detector is dead: no peak and a NaN peak value
    (a fire on a NaN t-stat leaves it so).  No input and no dominance
    changes it again, so every later carry has it too."""
    return (s["pp0"] == -1) & np.isnan(s["pv0"])


# what a dead short detector freezes: itself, and the long detector's
# mask (only a dominance reset moves it)
FROZEN = ("pp0", "pv0", "vd0", "mt1")


def dead(s):
    """True where both detectors are dead: with the short one dead no
    dominance resets the long one, so the carry never changes again."""
    return short_dead(s) & (s["pp1"] == -1) & np.isnan(s["pv1"])


def same(a, b):
    """Carries equal bit for bit."""
    eq = np.ones(np.shape(a["pp0"]), bool)
    for f in FIELDS:
        x, y = np.asarray(a[f]), np.asarray(b[f])
        if x.dtype == F32:
            x, y = x.view(np.int32), y.view(np.int32)
        eq &= x == y
    return eq


def pick(cond, a, b):
    return {f: np.where(cond, a[f], b[f]).astype(np.asarray(a[f]).dtype)
            for f in FIELDS}


def take(s, idx):
    return {f: np.asarray(s[f])[idx] for f in FIELDS}


# --------------------------------------------------------------------------
# the segmented scan of one chunk of one row
# --------------------------------------------------------------------------

def scan_chunk(c1, c2, m0, mt0, carry, L=L):
    """Fire bits of one chunk's samples, its end carry and its repair
    rounds, as csrc/detect.cu's scan_chunk runs them: segment k (one
    thread) covers samples [kL, kL + L)."""
    n = len(c1)
    nseg = -(-n // L)
    pad = nseg * L - n
    c1p = np.concatenate([c1, np.full(pad, np.nan, F32)]).reshape(nseg, L)
    c2p = np.concatenate([c2, np.full(pad, np.nan, F32)]).reshape(nseg, L)
    ks = np.arange(nseg)
    ln = np.minimum(L, n - ks * L)
    ms = (m0 + ks[:, None] * L + np.arange(L)[None]).astype(np.int64)
    nan = np.isnan(c1p) & np.isnan(c2p)
    # where each segment's run of NaN samples to its end starts
    nanfrom = ln.copy()
    for k in range(nseg):
        while nanfrom[k] > 0 and nan[k, nanfrom[k] - 1]:
            nanfrom[k] -= 1
    allnan = nanfrom == 0
    # the last segment before k that is not all NaN (-1: none)
    v = np.where(allnan, -1, ks)
    h = np.concatenate([[-1], np.maximum.accumulate(v)[:-1]])

    def run(X, Y, old_mask, old_E, sel):
        """Run the selected segments from X; with Y (the old start) in
        lockstep, stop where the two carries meet and keep the old fires
        and end from there.  A dead carry, or one at its NaN fixed point in
        the NaN tail of its segment, stops: no fires after, its end is
        itself."""
        mask = np.zeros(nseg, np.int64)
        E = dict(X)
        done = ~sel
        for j in range(L):
            live = ~done & (j < ln)
            if not live.any():
                break
            if Y is not None and j % 2 == 0:  # every other sample
                meet = live & same(X, Y)
                hi = old_mask & ~((1 << j) - 1)
                mask = np.where(meet, mask | hi, mask)
                E = pick(meet, old_E, E)
                done |= meet
                live &= ~meet
            jump = live & (((j == 0) & dead(X))
                           | ((j >= nanfrom) & (dead(X) | fixed_nan(X))))
            E = pick(jump, X, E)
            done |= jump
            live &= ~jump
            Xn, f = step(X, c1p[:, j], c2p[:, j], ms[:, j], mt0)
            X = pick(live, Xn, X)
            if Y is not None:
                Y = pick(live, step(Y, c1p[:, j], c2p[:, j], ms[:, j],
                                    mt0)[0], Y)
            mask |= np.where(live & f, 1 << j, 0)
        E = pick(~done, X, E)
        return mask, E

    # the guess: a fresh carry run over the WU samples before the segment
    guess = dict(pp0=-1, pv0=FLT_MAX, vd0=False, mt1=carry["mt1"], pp1=-1,
                 pv1=FLT_MAX, vd1=False)
    start = {f: np.array([carry[f]] + [guess[f]] * (nseg - 1),
                         dtype=np.asarray(carry[f]).dtype) for f in FIELDS}
    flat1, flat2 = c1p.reshape(-1), c2p.reshape(-1)
    for j in range(WU):
        at = np.maximum(ks * L - WU + j, 0)
        nxt, _ = step(start, flat1[at], flat2[at], m0 + at.astype(np.int64),
                      mt0)
        start = pick(ks > 0, nxt, start)
    sel = np.ones(nseg, bool)
    mask, E = run(dict(start), None, None, None, sel)
    rounds = 0
    while True:
        # each segment's next start, from the end carries of the round
        # before: a dead carry before it (the latest), else the NaN fixed
        # point of the first segment of its all-NaN run, else its
        # predecessor's end; and where that still has a live short
        # detector but one before it is dead, a new guess with the dead
        # short detector and its frozen mask (the predecessor's end is not
        # final yet)
        def latest(flag):
            v = np.where(flag, ks, -1)
            return np.concatenate([[-1], np.maximum.accumulate(v)[:-1]])

        jd, js = latest(dead(E)), latest(short_dead(E))
        prev = take(E, np.maximum(ks - 1, 0))
        hp = take(E, np.maximum(h + 1, 0))
        use_h = allnan & (ks > h + 1) & fixed_nan(hp)
        D = pick(use_h, hp, prev)
        sd = take(E, np.maximum(js, 0))
        respec = (js >= 0) & ~short_dead(D) & ~short_dead(start)
        D = pick(respec, {f: sd[f] if f in FROZEN else start[f]
                          for f in FIELDS}, D)
        D = pick(jd >= 0, take(E, np.maximum(jd, 0)), D)
        D = pick(ks == 0, start, D)
        active = ~same(D, start)
        if not active.any():
            break
        rounds += 1
        m2, E2 = run(dict(D), dict(start), mask, E, active)
        mask = np.where(active, m2, mask)
        E = pick(active, E2, E)
        start = pick(active, D, start)
    fires = ((mask[:, None] >> np.arange(L)[None]) & 1).astype(bool)
    return mask, fires.reshape(-1)[:n], take(E, nseg - 1), rounds


def last_fire_before(mask, n, L=L):
    """Chunk index of the last fire strictly before each sample (-1: none),
    from the segments' fire masks: an exclusive max over the segments'
    last fires, then the bits below the sample in its own segment."""
    nseg = len(mask)
    last = np.array([k * L + int(mk).bit_length() - 1 if mk else -1
                     for k, mk in enumerate(mask)], np.int64)
    lb = np.concatenate([[-1], np.maximum.accumulate(last)[:-1]])
    i = np.arange(n)
    k, b = i // L, i % L
    below = mask[k] & ((1 << b) - 1)
    hb = np.array([int(x).bit_length() - 1 for x in below], np.int64)
    return np.where(below != 0, k * L + hb, lb[k]), nseg


def f32_add(a, b):
    """An f32 add with subnormal inputs and result flushed (add.ftz)."""
    def ftz(x):
        return F32(0.0) * x if abs(x) < np.finfo(F32).tiny else x
    with np.errstate(all="ignore"):
        return ftz(F32(ftz(F32(a)) + ftz(F32(b))))


def len_sum_update(lsum, evst, en):
    """len_sum after a chunk whose fires end events at ``en`` (in order):
    telescoped to one add where every partial sum is an integer of at
    most 2^24, else added in fire order (csrc/detect.cu).  Returns
    (len_sum, telescoped)."""
    lsum = F32(lsum)
    if not len(en):
        return f32_add(lsum, 0.0), True
    d1, dn = int(en[0]) - int(evst), int(en[-1]) - int(evst)
    x = float(lsum)
    if (np.isfinite(x) and x == np.floor(x) and abs(x) <= TWO24
            and abs(d1) <= TWO24 and abs(x + d1) <= TWO24
            and abs(x + dn) <= TWO24):
        return f32_add(lsum, F32(dn)), True
    lsum = f32_add(lsum, 0.0)
    for e in en:
        lsum = f32_add(lsum, F32(np.int32(np.int64(e) - evst)))
        evst = e
    return lsum, False


def model_block(state, sig, nt=NT, L=L):
    """The kernel's detect_block as the model runs it: (state', out, stats)
    with the per-row repair rounds and whether len_sum telescoped."""
    from uncalled_tpu_torch.ops import events as te

    st = {k: v.numpy() for k, v in state.items()}
    B, S = sig.shape
    t1, t2, S1, SQ1 = (x.numpy() for x in te._tstats_block(
        torch.from_numpy(sig), state["tail"], state["S0"], state["SQ0"],
        state["t"]))
    S_en = S1[:, te.TAIL - 7: te.TAIL - 7 + S]
    SQ_en = SQ1[:, te.TAIL - 7: te.TAIL - 7 + S]
    CH = nt * L
    new = {k: v.copy() for k, v in st.items()}
    fired = np.zeros((B, S), bool)
    start = np.zeros((B, S), np.int32)
    sst = np.zeros((B, S))
    sqst = np.zeros((B, S))
    rounds = np.zeros(B, np.int64)
    tele = np.ones(B, bool)
    for b in range(B):
        c = dict(pp0=st["peak_pos"][0, b], pv0=st["peak_value"][0, b],
                 vd0=st["valid_peak"][0, b], mt1=st["masked_to"][1, b],
                 pp1=st["peak_pos"][1, b], pv1=st["peak_value"][1, b],
                 vd1=st["valid_peak"][1, b])
        mt0 = int(st["masked_to"][0, b])
        t0 = int(st["t"][b])
        evst, s0, q0 = int(st["evt_st"][b]), st["S_st"][b], st["SQ_st"][b]
        tot, lsum = int(st["total_events"][b]), st["len_sum"][b]
        for c0 in range(0, S, CH):
            n = min(CH, S - c0)
            mask, f, c, r = scan_chunk(t1[b, c0: c0 + n], t2[b, c0: c0 + n],
                                       t0 + c0 - 5, mt0, c, L)
            rounds[b] += r
            lf, _ = last_fire_before(mask, n, L)
            g = c0 + lf
            have = lf >= 0
            fired[b, c0: c0 + n] = f
            start[b, c0: c0 + n] = np.where(have, t0 + g - 7, evst)
            sst[b, c0: c0 + n] = np.where(have, S_en[b, np.maximum(g, 0)], s0)
            sqst[b, c0: c0 + n] = np.where(have, SQ_en[b, np.maximum(g, 0)],
                                           q0)
            idx = np.flatnonzero(f)
            en = t0 + c0 + idx - 7
            lsum, ok = len_sum_update(lsum, evst, en)
            tele[b] &= ok
            tot = int(np.int32(tot + len(idx)))
            if len(idx):
                evst = int(en[-1])
                s0, q0 = S_en[b, c0 + idx[-1]], SQ_en[b, c0 + idx[-1]]
        new["masked_to"][1, b] = c["mt1"]
        new["peak_pos"][:, b] = (c["pp0"], c["pp1"])
        new["peak_value"][:, b] = (c["pv0"], c["pv1"])
        new["valid_peak"][:, b] = (c["vd0"], c["vd1"])
        new["evt_st"][b], new["S_st"][b], new["SQ_st"][b] = evst, s0, q0
        new["total_events"][b], new["len_sum"][b] = tot, lsum
    new["t"] = st["t"] + S
    new["tail"] = np.concatenate([st["tail"], sig], 1)[:, -te.TAIL:]
    new["S0"], new["SQ0"] = S1[:, S], SQ1[:, S]
    # the per-sample statistics: the plain version's arithmetic
    en_all = st["t"][:, None] + np.arange(S, dtype=np.int32)[None] - 7
    length = torch.from_numpy((en_all - start).astype(F32))
    lsafe = te._maximum(length, 1.0)
    mean = te._ftz(((torch.from_numpy(S_en) - torch.from_numpy(sst))
                    / lsafe.double()).float())
    dsq = te._ftz((torch.from_numpy(SQ_en) - torch.from_numpy(sqst)).float())
    var = te._fma(-mean, mean, te._ftz(dsq / lsafe))
    stdv = te._ftz(te._sqrt64(te._maximum(var, 0.0).double()).float())
    keep = torch.from_numpy(fired) & (mean >= te.MIN_MEAN) & \
        (mean <= te.MAX_MEAN)
    out = dict(fired=keep.numpy(), mean=mean.numpy(), stdv=stdv.numpy(),
               start=start, length=length.numpy())
    return new, out, dict(rounds=rounds, telescoped=tele)


# --------------------------------------------------------------------------
# inputs and comparisons
# --------------------------------------------------------------------------

def pa_signals(rng, B, n):
    """Seeded signal in pA (chip_smoke.detect_signals): k-mer levels ~
    N(90, 12) held for a geometric number of samples (mean 9), plus N(0,
    1.5) noise, clipped to [40, 140], f32."""
    seg = np.minimum(np.cumsum(rng.random((B, n)) < 1 / 9, axis=1), n - 1)
    lv = rng.normal(90.0, 12.0, (B, n))
    x = np.take_along_axis(lv, seg, 1) + rng.normal(0.0, 1.5, (B, n))
    return np.clip(x, 40.0, 140.0).astype(F32)


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


def run_three(sig, S, nb, reset=None, nt=NT, len_sum=None):
    """Blocks of S samples through the model, the plain version and the
    JAX function, every output and state field compared after every
    block; returns the model's per-block stats."""
    from uncalled_tpu.ops import events as je
    from uncalled_tpu_torch.ops import events as te

    B = sig.shape[0]
    ts = te.make_detector_state(B)
    js = je.make_detector_state(B)
    if len_sum is not None:
        ts["len_sum"] = torch.from_numpy(len_sum)
        js = dict(js, len_sum=jnp.asarray(len_sum))
    stats = []
    for b in range(nb):
        if b == 1 and reset is not None:
            ts = te.reset_detector_rows(ts, torch.from_numpy(reset))
            js = je.reset_detector_rows(js, jnp.asarray(reset))
        blk = np.ascontiguousarray(sig[:, b * S: (b + 1) * S])
        ms, mo, stat = model_block(ts, blk, nt)
        ts, to = te.detect_block_plain(ts, torch.from_numpy(blk))
        js, jo = je.detect_block(js, jnp.asarray(blk))
        for k in te.OUT_KEYS:
            assert_same(to[k].numpy(), mo[k], f"block {b} out {k} (plain)")
            assert_same(jo[k], mo[k], f"block {b} out {k} (JAX)")
        for k in te.STATE_KEYS:
            assert_same(ts[k].numpy(), ms[k], f"block {b} state {k} (plain)")
            assert_same(js[k], ms[k], f"block {b} state {k} (JAX)")
        stats.append(stat)
    return stats


def zero_padded(rng, B, n):
    """pA reads of random lengths zero-padded to n samples, as
    BatchMapper._prepare_wave pads a refill wave to its longest read."""
    sig = pa_signals(rng, B, n)
    lens = rng.integers(n // 8, n, B)
    lens[0] = n
    for r in range(B):
        sig[r, lens[r]:] = 0.0
    return sig


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

def test_nan_fixed_point_is_fixed_under_the_serial_step():
    """The jump's lemma: a carry that fixed_nan accepts is left bit for bit
    unchanged, with no fire, by the serial step at any later sample with
    NaN t-stats; and the predicate is not vacuous (it holds on some
    carries that are not the trivial all-empty one)."""
    rng = np.random.default_rng(11)
    n = 200_000
    pv_pool = np.array([FLT_MAX, np.nan, 0.0, 1.0, 1.4, 1.5, 9.0, 20.0,
                        -3.0], F32)
    s = dict(pp0=rng.choice([-1, 3, 40, 95], n).astype(np.int32),
             pv0=rng.choice(pv_pool, n),
             vd0=rng.random(n) < 0.5,
             mt1=rng.integers(-2, 110, n).astype(np.int32),
             pp1=rng.choice([-1, 3, 50, 97], n).astype(np.int32),
             pv1=rng.choice(pv_pool, n), vd1=rng.random(n) < 0.5)
    # carries that are a dominance reset already
    d = rng.random(n) < 0.3
    s["mt1"] = np.where(d, s["pp0"] + 3, s["mt1"]).astype(np.int32)
    s["pp1"] = np.where(d, -1, s["pp1"]).astype(np.int32)
    s["pv1"] = np.where(d, FLT_MAX, s["pv1"]).astype(F32)
    s["vd1"] &= ~d
    fp = fixed_nan(s)
    assert fp.sum() > n // 10 and (fp & (s["pp0"] != -1)).any()
    nan = np.full(n, np.nan, F32)
    mt0 = rng.integers(-1, 120, n).astype(np.int32)
    cur = s
    for m in (-3, 0, 2, 50, 96, 97, 100, 101, 120, 5000):
        nxt, f = step(cur, nan, nan, np.full(n, m, np.int64), mt0)
        assert not f[fp].any(), m
        assert same(take(nxt, fp), take(cur, fp)).all(), m
        assert fixed_nan(take(nxt, fp)).all(), m
        cur = pick(fp, cur, nxt)
    # and a carry the predicate refuses does move under NaN (a valid
    # short peak fires once it is old enough)
    one = dict(pp0=np.int32([10]), pv0=F32([5.0]), vd0=np.array([True]),
               mt1=np.int32([0]), pp1=np.int32([-1]), pv1=F32([FLT_MAX]),
               vd1=np.array([False]))
    assert not fixed_nan(one)[0]
    nxt, f = step(one, F32([np.nan]), F32([np.nan]), np.int64([20]),
                  np.int32([0]))
    assert f[0] and nxt["pp0"][0] == -1 and fixed_nan(nxt)[0]


def test_dead_short_detector_freezes_under_any_input():
    """The re-speculation's and the dead jump's lemma: a dead short
    detector (no peak, a NaN peak value) and the long detector's mask stay
    bit for bit what they are under any t-stats, and a carry with both
    detectors dead does not change at all and never fires."""
    rng = np.random.default_rng(12)
    n = 100_000
    nan = F32(np.nan)
    pool = np.array([FLT_MAX, nan, 0.0, 1.0, 1.4, 1.5, 9.0, 20.0, np.inf],
                    F32)
    s = dict(pp0=np.full(n, -1, np.int32), pv0=np.full(n, nan, F32),
             vd0=rng.random(n) < 0.5,
             mt1=rng.integers(-2, 110, n).astype(np.int32),
             pp1=rng.choice([-1, 3, 50, 97], n).astype(np.int32),
             pv1=rng.choice(pool, n), vd1=rng.random(n) < 0.5)
    both = dead(s)
    assert short_dead(s).all() and 0 < both.sum() < n
    mt0 = rng.integers(-1, 120, n).astype(np.int32)
    cur = s
    for m in (-3, 0, 2, 50, 96, 100, 101, 120, 5000):
        with np.errstate(over="ignore"):
            c1 = rng.choice(pool, n) * rng.choice(F32([1, -1, 0.37]), n)
            c2 = rng.choice(pool, n) * rng.choice(F32([1, -1, 2.9]), n)
        nxt, f = step(cur, c1, c2, np.full(n, m, np.int64), mt0)
        for fld in FROZEN:
            assert same({g: cur[fld] for g in FIELDS},
                        {g: nxt[fld] for g in FIELDS}).all(), (m, fld)
        assert not f[both].any(), m
        assert same(take(nxt, both), take(cur, both)).all(), m
        cur = nxt


def test_scan_chunk_equals_the_serial_scan_on_random_carries():
    """The segmented scan from any carry gives the serial scan's fires and
    end carry, on pA t-stats with NaN stretches cut in (so the jumps and
    the all-NaN segments run)."""
    from uncalled_tpu_torch.ops import events as te

    rng = np.random.default_rng(3)
    sig = pa_signals(rng, 6, 1500)
    sig[1, 300:900] = 77.0
    sig[2, 700:] = 0.0
    sig[3, :] = 51.5
    sig[4, 31:97] = 80.0
    st = te.make_detector_state(6)
    t1, t2, _, _ = te._tstats_block(torch.from_numpy(sig), st["tail"],
                                    st["S0"], st["SQ0"], st["t"])
    t1, t2 = t1.numpy(), t2.numpy()
    starts = [dict(pp0=-1, pv0=FLT_MAX, vd0=False, mt1=0, pp1=-1,
                   pv1=FLT_MAX, vd1=False),
              dict(pp0=12, pv0=F32(3.5), vd0=True, mt1=40, pp1=20,
                   pv1=F32(11.0), vd1=True),
              dict(pp0=-1, pv0=F32(np.nan), vd0=False, mt1=7, pp1=30,
                   pv1=F32(2.0), vd1=False)]
    for r in range(6):
        for c in starts:
            c = {f: np.asarray(v, dtype=np.float32 if f in ("pv0", "pv1")
                               else bool if f in ("vd0", "vd1")
                               else np.int32) for f, v in c.items()}
            x = {f: np.asarray([v]) for f, v in c.items()}
            want = np.zeros(1500, bool)
            for i in range(1500):
                x, f = step(x, t1[r, i: i + 1], t2[r, i: i + 1],
                            np.int64([100 + i - 5]), np.int32([0]))
                want[i] = f[0]
            _, got, end, _ = scan_chunk(t1[r], t2[r], 95, 0, c)
            assert np.array_equal(got, want), (r, np.flatnonzero(got != want))
            assert same(take(x, 0), end), r


@pytest.mark.parametrize("S,nb", [(4096, 2), (1537, 2), (1000, 3),
                                  (24, 4)])
def test_model_seeded_pa_rows(S, nb):
    """Seeded pA rows (L = 16 does not divide 1000, 1537 or 24): the
    model equals the plain version and JAX, and its repair rounds stay
    few."""
    sig = pa_signals(np.random.default_rng(S), 6, S * nb)
    stats = run_three(sig, S, nb)
    rounds = np.concatenate([s["rounds"] for s in stats])
    assert rounds.max() <= 6 and rounds.mean() <= 3.0, rounds
    assert all(s["telescoped"].all() for s in stats)


@pytest.mark.parametrize("nt", [NT, 4])
def test_model_zero_padded_wave(nt):
    """Rows zero-padded from a random length, as a refill wave is: the
    NaN tail jumps, so the rounds stay near the pA rows'; with 4 threads
    a block (chunks of 64 samples) the carry crosses many chunks."""
    rng = np.random.default_rng(42)
    S = 4096
    sig = zero_padded(rng, 6, 2 * S)
    stats = run_three(sig, S, 2, nt=nt)
    rounds = np.concatenate([s["rounds"] for s in stats])
    if nt == NT:
        assert rounds.max() <= 8, rounds


def test_model_constant_rows():
    """A constant row and chip_smoke's constant stretch across a block
    edge, beside pA rows."""
    S = 1024
    sig = pa_signals(np.random.default_rng(9), 4, 3 * S)
    sig[0] = 77.0
    sig[1, S - 300: S + 300] = 91.25
    sig[2, 2 * S - 5: 2 * S + 600] = 130.5
    stats = run_three(sig, S, 3)
    assert max(int(s["rounds"].max()) for s in stats) <= 8


@pytest.mark.parametrize("nt", [NT, 8])
def test_model_rows_reset_mid_stream(nt):
    """Rows reset to the initial carry after the first block (a new read
    in the slot), over S = 1000 blocks (8 threads: chunks of 128)."""
    S = 1000
    sig = pa_signals(np.random.default_rng(17), 7, 3 * S)
    sig[5, 1500:] = 0.0
    reset = np.arange(7) % 3 == 1
    run_three(sig, S, 3, reset=reset, nt=nt)


def test_model_len_sum_beyond_2_24():
    """A carried len_sum near 2^24: partial sums pass 2^24 and round, the
    telescoped add would not give their bits, so the model adds in fire
    order on those rows (and still telescopes on the others)."""
    S = 1537
    sig = pa_signals(np.random.default_rng(23), 4, 2 * S)
    ls = np.array([TWO24 - 40, 0.0, TWO24 - 3000, 2.5], F32)
    stats = run_three(sig, S, 2, len_sum=ls)
    tele = stats[0]["telescoped"]
    assert not tele[0] and tele[1] and not tele[3]
    # the rounding is real: f32 partial sums above 2^24 lose odd lengths
    assert not stats[1]["telescoped"][0]
