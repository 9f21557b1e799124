// Streaming t-test event detector over one [B, S] signal block (Hopper,
// sm_90a).
//
// Replaces: no Pallas kernel.  The JAX package runs the detector as
// vectorised t-stats and a lax.scan over the block's samples,
// uncalled_tpu/ops/events.py:_tstats_block and detect_block (:338-471).
// Run eagerly in PyTorch, each sample of the scan is some 60 launches.
// Here the whole block is one launch, bit for bit the JAX function.
//
// Bound on the card: bytes (the [B, S] signal in, five [B, S] outputs out,
// the state in and out); the f64 work, a few dozen operations a sample,
// is below it.  The function itself asks for no serial chain: the peak
// detectors' carry forgets its past at every fire and every dominance
// reset (events come every ~9 samples in pA signal), so a run started
// from a wrong carry soon equals the true one.  Design: one block of NT
// threads per row, the row in chunks of CH = NT * L samples (one chunk at
// S <= 4096), every thread busy in each phase of a chunk:
//  1. the f64 prefix sums of the chunk (x and its f32 square) by a
//     parallel scan in shared memory: the chunk's samples staged, each
//     thread sums its ceil(count / NT) of them left to right, a warp scan
//     by shuffles, the earlier warps' totals left to right, the exact run
//     carried from the chunk before; S0 / SQ0 added after.  The windows
//     reach HALO samples past the chunk, so its sums run that far;
//  2. every t-stat of the chunk into shared memory (the divisions by the
//     window widths in three operations each, ddiv_w / fdiv_w);
//  3. the peak detectors as a segmented speculative scan, one thread a
//     segment of L samples (held in registers): each runs its segment from
//     a guess, a fresh carry run over the WU samples before the segment
//     (speculate), and records its fire bits and end carry; then, round
//     after round, each segment whose start differs from its
//     predecessor's end reruns from that end in lockstep with its old
//     run and stops where the two carries are equal bit for bit (the old
//     fires after that sample stand), until no start changes (repair).
//     Segment 0 starts from the true carry, so by induction the result is
//     the serial scan's whatever the data; the worst case is the serial
//     scan.  Three shortcuts keep constant stretches off that worst case
//     (each proved against the serial step in
//     tests/test_torch_detect_segments.py): a carry at its fixed point
//     under NaN t-stats (fixed_nan) jumps over its segment's NaN tail,
//     and an all-NaN segment takes the fixed point of the first segment
//     of its run; a dead carry (dead) never changes, so later segments
//     take it; a dead short detector never revives, so later segments
//     still on a live guess are guessed again with it (short_dead);
//  4. every sample's outputs from the fire bits: the start, S_st and
//     SQ_st before it from the last fire before it (the fire words' bits
//     and an exclusive max over the segments), total_events by popcount,
//     len_sum telescoped to lsum + (en_last - evt_st) where every partial
//     sum is an integer of at most 2^24 (added in fire order otherwise).
// Shared memory: the chunk's prefix sums (16 B a sample), its t-stats (8 B
// a sample, skewed one word in 32 against bank conflicts) and the
// segments' end carries, ~107 KB at S = 4096: two blocks an SM.
//
// Bit parity with the JAX function on the CPU:
//  - every f32 operation flushes subnormal inputs and results, as XLA's CPU
//    runtime does (the .ftz forms below);
//  - var = dsq / lsafe - mean * mean is one fused multiply-add: XLA
//    contracts it in the compiled scan body.  Every other f32 operation
//    has an explicit rounding, so nvcc contracts nothing else;
//  - jnp.maximum propagates NaN and gives +0 for max(-0, 0) (jmax), and a
//    NaN t-stat carries the x86 default NaN's bits (0xffc00000);
//  - the constants 0.2, 1.4, 9.0 and the mean filter are f32 (weak-typed
//    Python floats in JAX);
//  - every divide and square root rounds once (__ddiv_rn, __dsqrt_rn,
//    div.rn, and ddiv_w / fdiv_w, held to them on the card);
//  - precondition: every f64 prefix sum of the block's samples is exact
//    (ops/events.py prefix_sums_exact; signals in pA meet it), so the
//    parallel scan's order gives the bits of any other order.  Where sums
//    are not exact the kernel's prefixes are its own order's.
//
// probe_detect_chain (a measurement probe for chip_smoke.py, no kernel of
// the mapper) runs the old design's serial step (both detectors with
// branches, and the open event's carry) on one thread for a number of
// steps: the latency of one step of its serial scan, which it paid S
// times a row.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W1 = 3, W2 = 6, TAIL = 12;
constexpr int NT = 256;     // threads a block (one block a row)
constexpr int NW = NT / 32;  // warps a block
constexpr int L = 16;       // samples a segment (its fire word's bits)
constexpr int CH = NT * L;  // samples a chunk: one segment a thread
constexpr int WU = 12;      // samples a guess runs before its segment
// a chunk's prefix sums reach past its samples: P[i + 13] for the long
// window, P[i + 19] for the start-of-read wrap
constexpr int HALO = 20;

// -DDETECT_PHASES (uncalled_tpu_torch/testing/detect_phases.py, a
// measurement build): thread 0 of each of the first 1024 blocks stamps the
// global timer at the start, after each phase of its last chunk and at the
// end, and its SM
#ifdef DETECT_PHASES
__device__ unsigned long long g_stamps[1024 * 8];
#define STAMP(q)                                                     \
  do {                                                               \
    if (threadIdx.x == 0 && blockIdx.x < 1024) {                     \
      unsigned long long t_;                                         \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));         \
      g_stamps[blockIdx.x * 8 + (q)] = t_;                           \
    }                                                                \
  } while (0)
#else
#define STAMP(q)
#endif

__device__ __forceinline__ float f_add(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float f_sub(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float f_mul(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float f_div(float a, float b) {
  float r;
  asm("div.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float f_fma(float a, float b, float c) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(a), "f"(b), "f"(c));
  return r;
}
__device__ __forceinline__ float f_sqrt(float a) {
  float r;
  asm("sqrt.rn.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}
// f64 -> f32, a subnormal result flushed
__device__ __forceinline__ float d2f(double a) {
  float r;
  asm("cvt.rn.ftz.f32.f64 %0, %1;" : "=f"(r) : "d"(a));
  return r;
}
// f32 -> f64, a subnormal input flushed
__device__ __forceinline__ double f2d(float a) {
  double r;
  asm("cvt.ftz.f64.f32 %0, %1;" : "=d"(r) : "f"(a));
  return r;
}
// jnp.maximum(a, b) for a non-NaN b
__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}
// x / y for a positive finite y, rounded once: a zero x is its own
// quotient (the sign kept), which skips the division's slow path (the
// constant stretches and zero padding divide zeros)
__device__ __forceinline__ double div_pos(double x, double y) {
  return x == 0.0 ? x : __ddiv_rn(x, y);
}
// x / w for the window widths w = 3, 6, rounded once, in three operations
// (Markstein): rw = RN(1/w) has relative error 2^-54 (2^-25 in f32), so
// q = RN(x * rw) is within one ulp of x / w, the remainder x - q * w is
// exact (one FMA), and RN(q + remainder * rw) is RN(x / w).  Zero, tiny
// (whose remainder would be subnormal, and flushed in f32), huge and
// non-finite x divide as usual.  chip_smoke.py holds both against the
// division instructions (every f32 input, random f64).
template <int W>
__device__ __forceinline__ double ddiv_w(double x) {
  constexpr double w = W, rw = 1.0 / W;
  const double ax = fabs(x);
  if (!(ax >= 0x1p-900 && ax <= 0x1p900)) return div_pos(x, w);
  const double q = __dmul_rn(x, rw);
  return __fma_rn(__fma_rn(-q, w, x), rw, q);
}
template <int W>
__device__ __forceinline__ float fdiv_w(float x) {
  constexpr float w = W, rw = 1.0f / W;
  const float ax = fabsf(x);
  if (ax == 0.0f) return x;
  if (!(ax >= 0x1p-96f && ax <= 0x1p120f)) return f_div(x, w);
  const float q = f_mul(x, rw);
  return f_fma(f_fma(-q, w, x), rw, q);
}
// the chunk's t-stat arrays, one word skipped in every 32: thread k reads
// sample k * L + j, so a warp's 32 threads hit 32 banks
__host__ __device__ __forceinline__ int sk(int i) { return i + (i >> 5); }

struct Args {
  const float* sig;
  // state in (ops/events.py STATE_KEYS order)
  const int32_t* masked_to;
  const int32_t* peak_pos;
  const float* peak_value;
  const uint8_t* valid_peak;
  const int32_t* evt_st;
  const double* S_st;
  const double* SQ_st;
  const int32_t* t;
  const int32_t* total_events;
  const float* len_sum;
  const float* tail;
  const double* S0;
  const double* SQ0;
  // state out
  int32_t* o_masked_to;
  int32_t* o_peak_pos;
  float* o_peak_value;
  uint8_t* o_valid_peak;
  int32_t* o_evt_st;
  double* o_S_st;
  double* o_SQ_st;
  int32_t* o_t;
  int32_t* o_total_events;
  float* o_len_sum;
  float* o_tail;
  double* o_S0;
  double* o_SQ0;
  // per-sample outputs [B, S]
  uint8_t* fired;
  float* mean;
  float* stdv;
  int32_t* start;
  float* length;
  // each row's repair rounds [B] (a measurement of the scan)
  int32_t* rounds;
  int B, S;
};

// One peak detector at one sample (event_detector.cpp:221-279, as the JAX
// scan's one_det computes it); returns whether it fired.  Branch-free
// (bitwise logic and selects): the threads of a warp run different
// segments, so a branch would split the warp.
__device__ __forceinline__ bool peak_det(float cur, int m, float thresh,
                                         int whalf, int mt, int& pp,
                                         float& pv, bool& vd) {
  const bool act = (m < 0) | (mt < m);  // the u32 wrap of buf_mid for m < 0
  const bool no_peak = pp == -1;
  const bool rise = f_sub(cur, pv) > 0.2f;
  const bool higher = cur > pv;
  const float pv2 = higher ? cur : pv;
  const int pp2 = higher ? m : pp;
  const bool vd2 = vd | ((f_sub(pv2, cur) > 0.2f) & (pv2 > thresh));
  const bool fire = vd2 & ((m - pp2) > whalf);
  const bool set_pv = act & (no_peak ? ((cur < pv) | rise) : (higher | fire));
  const int npp = no_peak ? (rise ? m : pp) : (fire ? -1 : pp2);
  pv = set_pv ? cur : pv;
  pp = act ? npp : pp;
  vd = (act & !no_peak) ? (vd2 & !fire) : vd;
  return act & !no_peak & fire;
}

// The detectors' carry (the short detector's mask mt0 never changes in a
// block, so it is not carried)
struct Fsm {
  int pp0, mt1, pp1;
  float pv0, pv1;
  bool vd0, vd1;
};

// Both detectors at one sample: the short one resets the long one first
// when its case-2 peak passes its threshold (dominance).  Returns whether
// an event ends here.
__device__ __forceinline__ bool fsm_step(Fsm& c, int mt0, int m, float cur1,
                                         float cur2) {
  const bool s_act = (m < 0) | (mt0 < m);
  const bool s_hi = cur1 > c.pv0;
  const float s_pv2 = s_hi ? cur1 : c.pv0;
  const int s_pp2 = s_hi ? m : c.pp0;
  const bool dom = s_act & (c.pp0 != -1) & (s_pv2 > 1.4f);
  c.mt1 = dom ? s_pp2 + W1 : c.mt1;
  c.pp1 = dom ? -1 : c.pp1;
  c.pv1 = dom ? FLT_MAX : c.pv1;
  c.vd1 = c.vd1 & !dom;
  const bool f0 = peak_det(cur1, m, 1.4f, W1 / 2, mt0, c.pp0, c.pv0, c.vd0);
  const bool f1 = peak_det(cur2, m, 9.0f, W2 / 2, c.mt1, c.pp1, c.pv1, c.vd1);
  return f0 | f1;
}

__device__ __forceinline__ bool same(const Fsm& a, const Fsm& b) {
  return (a.pp0 == b.pp0) & (a.mt1 == b.mt1) & (a.pp1 == b.pp1) &
         (__float_as_int(a.pv0) == __float_as_int(b.pv0)) &
         (__float_as_int(a.pv1) == __float_as_int(b.pv1)) &
         (a.vd0 == b.vd0) & (a.vd1 == b.vd1);
}

// A fixed point of fsm_step under NaN t-stats at every later sample: the
// short detector cannot fire (no peak, or no valid one), and the long one
// either already is what the short one's standing dominance resets it to,
// or (no dominance) cannot fire either.  No fire comes from it.
__device__ __forceinline__ bool fixed_nan(const Fsm& s) {
  bool dom = s.pp0 != -1 && s.pv0 > 1.4f;
  bool is_d = s.mt1 == s.pp0 + W1 && s.pp1 == -1 &&
              __float_as_int(s.pv1) == __float_as_int(FLT_MAX) && !s.vd1;
  return (s.pp0 == -1 || !s.vd0) && (dom ? is_d : (s.pp1 == -1 || !s.vd1));
}
// The short detector is dead (no peak, a NaN peak value: it fired on a NaN
// t-stat): no input revives it, no dominance follows, and the long
// detector's mask mt1 is frozen with it.
__device__ __forceinline__ bool short_dead(const Fsm& s) {
  return s.pp0 == -1 && s.pv0 != s.pv0;
}
// Both detectors dead: the carry never changes again.
__device__ __forceinline__ bool dead(const Fsm& s) {
  return short_dead(s) && s.pp1 == -1 && s.pv1 != s.pv1;
}

// The segments' end carries in shared memory
struct EndSh {
  int pp0[NT], mt1[NT], pp1[NT];
  float pv0[NT], pv1[NT];
  uint8_t vd[NT];
};
__device__ __forceinline__ void put(EndSh& e, int k, const Fsm& s) {
  e.pp0[k] = s.pp0;
  e.mt1[k] = s.mt1;
  e.pp1[k] = s.pp1;
  e.pv0[k] = s.pv0;
  e.pv1[k] = s.pv1;
  e.vd[k] = (uint8_t)(s.vd0 | (s.vd1 << 1));
}
__device__ __forceinline__ Fsm get(const EndSh& e, int k) {
  Fsm s;
  s.pp0 = e.pp0[k];
  s.mt1 = e.mt1[k];
  s.pp1 = e.pp1[k];
  s.pv0 = e.pv0[k];
  s.pv1 = e.pv1[k];
  s.vd0 = e.vd[k] & 1;
  s.vd1 = (e.vd[k] >> 1) & 1;
  return s;
}

// Runs one segment of `len` samples (its t-stats cu1, cu2 in registers,
// boundary m0 at its first sample) from X.  With `lock`, Y (the segment's
// old start) runs in lockstep: where the two carries meet, the old fires
// from there on (`oldF`) and the old end (`oldE`) stand.  A dead carry, or
// one at its NaN fixed point inside the segment's NaN tail (from
// `nanfrom`), stops there: no fires after, its end is itself (a carry
// dies only on a NaN t-stat, so past the start it is looked for in the
// tail alone).  Returns the fire word; E the end (E may be oldE).
__device__ __forceinline__ uint32_t run_seg(Fsm X, bool lock, Fsm Y,
                                            uint32_t oldF, const Fsm& oldE,
                                            const float* cu1,
                                            const float* cu2, int len,
                                            int nanfrom, int m0, int mt0,
                                            Fsm& E) {
  uint32_t f = 0;
  if (dead(X)) {
    E = X;
    return 0;
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (j >= len) break;
    // (looked for every other sample: carries that meet stay equal)
    if (lock && !(j & 1) && same(X, Y)) {
      E = oldE;
      return f | (oldF & (0xffffffffu << j));
    }
    if (j >= nanfrom && (dead(X) || fixed_nan(X))) {
      E = X;
      return f;
    }
    if (fsm_step(X, mt0, m0 + j, cu1[j], cu2[j])) f |= 1u << j;
    if (lock) fsm_step(Y, mt0, m0 + j, cu1[j], cu2[j]);
  }
  E = X;
  return f;
}

// Exclusive max over the block's threads in thread order (-1 before the
// first); every thread calls it.
__device__ __forceinline__ int block_excl_max(int v, int* wsh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = max(x, y);
  }
  int ex = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) ex = -1;
  __syncthreads();
  if (lane == 31) wsh[w] = x;
  __syncthreads();
  for (int q = 0; q < w; ++q) ex = max(ex, wsh[q]);
  return ex;
}

// t-stat of window W at chunk sample i (the JAX _tstats_block), P and Q
// the chunk's prefix sums in shared memory
template <int W>
__device__ __forceinline__ float tstat(const double* P, const double* Q,
                                       int i, int tg) {
  int m = i + TAIL - 5;
  int mg = tg - 5;
  int left = (mg >= 0 && mg < W) ? m + 2 * W : m - W;  // start-of-read wrap
  double pm = P[m], pqm = Q[m];
  double sum1 = __dsub_rn(pm, P[left]);
  double sumsq1 = __dsub_rn(pqm, Q[left]);
  float sum2 = d2f(__dsub_rn(P[m + W], pm));
  float sumsq2 = d2f(__dsub_rn(Q[m + W], pqm));
  float mean1 = d2f(ddiv_w<W>(sum1));
  float mean2 = fdiv_w<W>(sum2);
  double comb64 = __dsub_rn(
      __dadd_rn(__dsub_rn(ddiv_w<W>(sumsq1), f2d(f_mul(mean1, mean1))),
                f2d(fdiv_w<W>(sumsq2))),
      f2d(f_mul(mean2, mean2)));
  float comb = jmax(d2f(comb64), FLT_MIN);
  float delta = f_sub(mean2, mean1);
  // FLT_MIN / w is subnormal, flushed to +0 (no division: its slow path)
  float inner = comb == FLT_MIN ? 0.0f : fdiv_w<W>(comb);
  // |delta| / sqrt(inner); inner is 0 (flushed) or at least FLT_MIN / 6,
  // and for inner = 0 the quotient is +inf, or NaN for 0 / 0, with no
  // division (its slow path)
  float t;
  if (inner == 0.0f)
    t = (delta == 0.0f || delta != delta) ? __int_as_float(0x7fffffff)
                                          : __int_as_float(0x7f800000);
  else
    t = d2f(__ddiv_rn(fabs(f2d(delta)), __dsqrt_rn(f2d(inner))));
  // 0 / 0 (a window pair of equal samples): the x86 default NaN, as the
  // JAX function on the CPU gives it (the card's own is 0x7fffffff)
  if (t != t) t = __int_as_float(0xffc00000);
  return (tg + 2 <= 2 * W) ? 0.0f : t;  // reference: t <= 2w -> 0
}

__global__ void __launch_bounds__(NT, 2) detect_kernel(const Args a) {
  // dynamic: the chunk's prefix sums P, Q [chs + HALO] (f64), then its
  // t-stats c1, c2 (f32, skewed), whose room first stages its samples
  extern __shared__ double dsh[];
  __shared__ EndSh esh;
  __shared__ uint32_t fm[NT];  // the chunk's fire words (L bits)
  __shared__ int lastb[NT];    // last fire before each segment (-1: none)
  __shared__ int wsh[NW];
  __shared__ int red[3][NW];
  __shared__ double wp[NW], wq[NW];
  // the carries between chunks: the exact prefix runs (the thread that
  // sums sample c0 + n writes them), and the open event's (thread 0)
  __shared__ double c_rp, c_rq;
  __shared__ int c_evst, c_tot;
  __shared__ double c_sst, c_sqst;
  __shared__ float c_lsum;

  STAMP(0);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int S = a.S, NP = S + TAIL + 1;
  const float* sig = a.sig + (size_t)b * S;
  const int t_start = a.t[b];
  const int mt0 = a.masked_to[b];
  const double s0 = a.S0[b], q0 = a.SQ0[b];
  const int chs = min(S, CH);
  double* P = dsh;
  double* Q = dsh + chs + HALO;
  float* c1s = (float*)(Q + chs + HALO);
  float* c2s = c1s + sk(chs + L) + 1;
  float* xsh = c1s;

  // the detectors' carry at the chunk's start, and the open event's
  Fsm C;
  C.pp0 = a.peak_pos[b];
  C.pp1 = a.peak_pos[a.B + b];
  C.pv0 = a.peak_value[b];
  C.pv1 = a.peak_value[a.B + b];
  C.vd0 = a.valid_peak[b] != 0;
  C.vd1 = a.valid_peak[a.B + b] != 0;
  C.mt1 = a.masked_to[a.B + b];
  if (tid == 0) {
    c_rp = c_rq = 0.0;
    c_evst = a.evt_st[b];
    c_sst = a.S_st[b];
    c_sqst = a.SQ_st[b];
    c_tot = a.total_events[b];
    c_lsum = a.len_sum[b];
  }
  int rounds = 0;

  for (int c0 = 0; c0 < S; c0 += CH) {
    const int n = min(CH, S - c0);
    // 1. the chunk's prefix sums P[c0 + q], q < nq (its samples and the
    // windows' reach past them): its nx = nq - 1 samples staged, then one
    // scan from the exact run at c0: each thread sums its V = ceil(nx /
    // NT) samples left to right, a warp scans its threads' totals by
    // shuffles, a warp's offset is the earlier warps' totals left to
    // right from 0; S0 / SQ0 added after
    const int nq = min(n + HALO, NP - c0), nx = nq - 1;
    for (int q = tid; q < nx; q += NT) {
      const int g = c0 + q;
      xsh[q] = g < TAIL ? a.tail[b * TAIL + g] : sig[g - TAIL];
    }
    __syncthreads();
    {
      const double cp = c_rp, cq = c_rq;
      if (tid == 0) {
        P[0] = __dadd_rn(cp, s0);
        Q[0] = __dadd_rn(cq, q0);
      }
      const int V = (nx + NT - 1) / NT;
      const int qa = min(tid * V, nx), qb = min(qa + V, nx);
      double sp = 0.0, sq = 0.0;
      for (int q = qa; q < qb; ++q) {
        const float x = xsh[q];
        // parity: square in f32, accumulate in f64 (event_detector.cpp:89)
        const double dx = f2d(x), dq = f2d(f_mul(x, x));
        sp = q == qa ? dx : __dadd_rn(sp, dx);
        sq = q == qa ? dq : __dadd_rn(sq, dq);
        P[q + 1] = sp;  // the thread's own running sums, for now
        Q[q + 1] = sq;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double yp = __shfl_up_sync(0xffffffffu, sp, o);
        const double yq = __shfl_up_sync(0xffffffffu, sq, o);
        if (lane >= o) {
          sp = __dadd_rn(yp, sp);
          sq = __dadd_rn(yq, sq);
        }
      }
      double ep = __shfl_up_sync(0xffffffffu, sp, 1);
      double eq = __shfl_up_sync(0xffffffffu, sq, 1);
      if (lane == 0) ep = eq = 0.0;
      if (lane == 31) {
        wp[w] = sp;
        wq[w] = sq;
      }
      __syncthreads();
      double tp = 0.0, tq = 0.0;  // the earlier warps' totals
      for (int q = 0; q < w; ++q) {
        tp = __dadd_rn(tp, wp[q]);
        tq = __dadd_rn(tq, wq[q]);
      }
      const double bp = __dadd_rn(__dadd_rn(cp, tp), ep);
      const double bq = __dadd_rn(__dadd_rn(cq, tq), eq);
      for (int q = qa; q < qb; ++q) {
        const double rp = __dadd_rn(bp, P[q + 1]);
        const double rq = __dadd_rn(bq, Q[q + 1]);
        P[q + 1] = __dadd_rn(rp, s0);
        Q[q + 1] = __dadd_rn(rq, q0);
        if (q + 1 == n) {  // the next chunk's start
          c_rp = rp;
          c_rq = rq;
        }
      }
      __syncthreads();
    }
    STAMP(1);

    // 2. the chunk's t-stats
    for (int j = tid; j < n; j += NT) {
      c1s[sk(j)] = tstat<W1>(P, Q, j, t_start + c0 + j);
      c2s[sk(j)] = tstat<W2>(P, Q, j, t_start + c0 + j);
    }
    __syncthreads();
    STAMP(2);

    // 3. the segmented scan: thread k runs segment k
    const int nseg = (n + L - 1) / L;
    const int k = tid;
    const bool own = k < nseg;
    const int base = k * L;
    const int len = own ? min(L, n - base) : 0;
    const int m0 = t_start + c0 + base - 5;
    float cu1[L], cu2[L];  // the segment's t-stats (its last one may
                           // run past the chunk: never stepped)
#pragma unroll
    for (int j = 0; j < L; ++j) {
      cu1[j] = own ? c1s[sk(base + j)] : 0.0f;
      cu2[j] = own ? c2s[sk(base + j)] : 0.0f;
    }
    int nanfrom = len;  // where the segment's NaN tail starts
#pragma unroll
    for (int j = L - 1; j >= 0; --j)
      if (j < len && nanfrom == j + 1 && cu1[j] != cu1[j] && cu2[j] != cu2[j])
        nanfrom = j;
    const bool allnan = own && nanfrom == 0;
    // the last segment before k that is not all NaN
    const int h = block_excl_max(own && !allnan ? k : -1, wsh);

    // speculate: segment 0 from the true carry, the others from a guess,
    // a fresh carry run over the WU samples before the segment (it then
    // equals the true carry at the segment's start in most segments)
    Fsm S_ = C, E_ = C;
    uint32_t F = 0;
    if (own) {
      if (k > 0) {
        S_.pp0 = S_.pp1 = -1;
        S_.pv0 = S_.pv1 = FLT_MAX;
        S_.vd0 = S_.vd1 = false;
#pragma unroll
        for (int j = 0; j < WU; ++j) {
          const int q = sk(base - WU + j);
          fsm_step(S_, mt0, m0 - WU + j, c1s[q], c2s[q]);
        }
      }
      F = run_seg(S_, false, S_, 0u, S_, cu1, cu2, len, nanfrom, m0, mt0,
                  E_);
      put(esh, k, E_);
    }
    STAMP(3);
    // repair, round after round, from the end carries of the round before
    for (;;) {
      const bool sd = own && short_dead(E_);
      int jd = -1, js = -1;
      if (__syncthreads_or(sd)) {
        jd = block_excl_max(own && dead(E_) ? k : -1, wsh);
        js = block_excl_max(sd ? k : -1, wsh);
      }
      Fsm X = S_;
      bool active = false;
      if (own && k > 0) {
        if (jd >= 0) {
          // a dead carry before this segment is every later start
          X = get(esh, jd);
        } else {
          X = get(esh, k - 1);
          if (allnan && k > h + 1) {
            // an all-NaN run: its first segment's end, at its fixed point
            const Fsm hp = get(esh, h + 1);
            if (fixed_nan(hp)) X = hp;
          }
          if (js >= 0 && !short_dead(X) && !short_dead(S_)) {
            // a dead short detector before this segment: guess again
            // with it and the long detector's mask it froze
            const Fsm d = get(esh, js);
            X = S_;
            X.pp0 = d.pp0;
            X.pv0 = d.pv0;
            X.vd0 = d.vd0;
            X.mt1 = d.mt1;
          }
        }
        active = !same(X, S_);
      }
      if (!__syncthreads_or(active)) break;
      ++rounds;
      if (active) {
        F = run_seg(X, true, S_, F, E_, cu1, cu2, len, nanfrom, m0, mt0,
                    E_);
        S_ = X;
        put(esh, k, E_);
      }
    }
    STAMP(4);

    // 4. the fire words: the last fire before each segment, the chunk's
    // first and last fire and its count
    const int lastk = F ? base + 31 - __clz(F) : -1;
    if (own) fm[k] = F;
    lastb[k] = block_excl_max(lastk, wsh);
    {
      const int cnt = __reduce_add_sync(0xffffffffu, __popc(F));
      const int lo = __reduce_min_sync(
          0xffffffffu, F ? (unsigned)(base + __ffs(F) - 1) : 0x7fffffffu);
      const int hi = __reduce_max_sync(0xffffffffu, lastk + 1) - 1;
      if (lane == 0) {
        red[0][w] = cnt;
        red[1][w] = lo;
        red[2][w] = hi;
      }
    }
    __syncthreads();
    C = get(esh, nseg - 1);

    // every sample's event statistics; the event boundary en = i - 7 is
    // chunk prefix index j + 5
    const int evst0 = c_evst;
    const double sst0 = c_sst, sqst0 = c_sqst;
    for (int j = tid; j < n; j += NT) {
      const int seg = j / L, bit = j % L;
      const uint32_t fw = fm[seg];
      const uint32_t below = fw & ((1u << bit) - 1u);
      const int lf = below ? seg * L + 31 - __clz(below) : lastb[seg];
      int st;
      double ssts, sqsts;
      if (lf >= 0) {
        st = t_start + c0 + lf - 7;
        ssts = P[lf + 5];
        sqsts = Q[lf + 5];
      } else {
        st = evst0;
        ssts = sst0;
        sqsts = sqst0;
      }
      const size_t o = (size_t)b * S + c0 + j;
      const int en = t_start + c0 + j - 7;
      const float lf32 = (float)(en - st);
      const float lsafe = jmax(lf32, 1.0f);
      const float mean =
          d2f(div_pos(__dsub_rn(P[j + 5], ssts), (double)lsafe));
      const float dsq = d2f(__dsub_rn(Q[j + 5], sqsts));
      // XLA's contraction of dsq / lsafe - mean * mean
      const float var = f_fma(-mean, mean, f_div(dsq, lsafe));
      a.fired[o] = ((fw >> bit) & 1u) && mean >= 0.0f && mean <= 40000.0f;
      a.mean[o] = mean;
      a.stdv[o] = f_sqrt(jmax(var, 0.0f));
      a.start[o] = st;
      a.length[o] = lf32;
    }
    __syncthreads();
    STAMP(5);

    // the open event's carry past the chunk
    if (tid == 0) {
      int cnt = 0, lo = 0x7fffffff, hi = -1;
      for (int q = 0; q < NW; ++q) {
        cnt += red[0][q];
        lo = min(lo, red[1][q]);
        hi = max(hi, red[2][q]);
      }
      float lsum = c_lsum;
      if (cnt == 0) {
        lsum = f_add(lsum, 0.0f);
      } else {
        const long long ev = c_evst;
        const long long e1 = (long long)t_start + c0 + lo - 7 - ev;
        const long long en_ = (long long)t_start + c0 + hi - 7 - ev;
        const double x = (double)lsum, M = 16777216.0;
        if (x == floor(x) && fabs(x) <= M && fabs((double)e1) <= M &&
            fabs(x + (double)e1) <= M && fabs(x + (double)en_) <= M) {
          // every partial sum an integer of at most 2^24: exact, so the
          // sum telescopes to one add
          lsum = f_add(lsum, (float)en_);
        } else {
          // in fire order, as the serial scan adds
          lsum = f_add(lsum, 0.0f);
          int evc = c_evst;
          for (int q = 0; q < nseg; ++q) {
            for (uint32_t fw = fm[q]; fw; fw &= fw - 1) {
              const int e = t_start + c0 + q * L + __ffs(fw) - 1 - 7;
              lsum = f_add(lsum, (float)(int)((unsigned)e - (unsigned)evc));
              evc = e;
            }
          }
        }
        c_evst = t_start + c0 + hi - 7;
        c_sst = P[hi + 5];
        c_sqst = Q[hi + 5];
      }
      c_lsum = lsum;
      c_tot = (int)((unsigned)c_tot + (unsigned)cnt);
      if (c0 + n == S) {
        // the prefix carry advances to position t_new - TAIL = index S
        a.o_S0[b] = P[S - c0];
        a.o_SQ0[b] = Q[S - c0];
      }
    }
    __syncthreads();
  }

  // the new state
  if (tid == 0) {
    a.o_masked_to[b] = mt0;
    a.o_masked_to[a.B + b] = C.mt1;
    a.o_peak_pos[b] = C.pp0;
    a.o_peak_pos[a.B + b] = C.pp1;
    a.o_peak_value[b] = C.pv0;
    a.o_peak_value[a.B + b] = C.pv1;
    a.o_valid_peak[b] = C.vd0;
    a.o_valid_peak[a.B + b] = C.vd1;
    a.o_evt_st[b] = c_evst;
    a.o_S_st[b] = c_sst;
    a.o_SQ_st[b] = c_sqst;
    a.o_t[b] = t_start + S;
    a.o_total_events[b] = c_tot;
    a.o_len_sum[b] = c_lsum;
    a.rounds[b] = rounds;
  }
  if (tid < TAIL) a.o_tail[b * TAIL + tid] = sig[S - TAIL + tid];
  STAMP(6);
#ifdef DETECT_PHASES
  if (tid == 0 && b < 1024) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    g_stamps[b * 8 + 7] = sm;
  }
#endif
}

// dynamic shared memory of a block for chunks of `chs` samples
size_t dyn_smem(int chs) {
  return 2 * sizeof(double) * (size_t)(chs + HALO) +
         2 * sizeof(float) * (size_t)(sk(chs + L) + 1);
}

// The old design's serial step, for the probe: the detectors with
// branches (one thread ran the scan), then the open event's carry
__device__ __forceinline__ bool peak_det_serial(float cur, int m,
                                                float thresh, int whalf,
                                                int mt, int& pp, float& pv,
                                                bool& vd) {
  bool act = (m < 0) || (mt < m);
  bool no_peak = pp == -1;
  bool rise = f_sub(cur, pv) > 0.2f;
  bool higher = cur > pv;
  float pv2 = higher ? cur : pv;
  int pp2 = higher ? m : pp;
  bool vd2 = vd || ((f_sub(pv2, cur) > 0.2f) && (pv2 > thresh));
  bool fire = vd2 && ((m - pp2) > whalf);
  if (!act) return false;
  if (no_peak) {
    if (cur < pv || rise) pv = cur;
    if (rise) pp = m;
    return false;
  }
  if (higher || fire) pv = cur;
  pp = fire ? -1 : pp2;
  vd = vd2 && !fire;
  return fire;
}

struct Carry {
  Fsm f;
  int mt0, evst, t, tot;
  double sst, sqst;
  float lsum;
};

__device__ __forceinline__ bool scan_step(Carry& c, float cur1, float cur2,
                                          double s_en, double sq_en) {
  const int m = c.t - 5;
  bool s_act = (m < 0) || (c.mt0 < m);
  bool s_hi = cur1 > c.f.pv0;
  float s_pv2 = s_hi ? cur1 : c.f.pv0;
  int s_pp2 = s_hi ? m : c.f.pp0;
  if (s_act && c.f.pp0 != -1 && s_pv2 > 1.4f) {
    c.f.mt1 = s_pp2 + W1;
    c.f.pp1 = -1;
    c.f.pv1 = FLT_MAX;
    c.f.vd1 = false;
  }
  bool f0 = peak_det_serial(cur1, m, 1.4f, W1 / 2, c.mt0, c.f.pp0, c.f.pv0,
                            c.f.vd0);
  bool f1 = peak_det_serial(cur2, m, 9.0f, W2 / 2, c.f.mt1, c.f.pp1,
                            c.f.pv1, c.f.vd1);
  bool fired = f0 || f1;
  int en = m - 2;
  c.tot += fired;
  c.lsum = f_add(c.lsum, fired ? (float)(en - c.evst) : 0.0f);
  if (fired) {
    c.evst = en;
    c.sst = s_en;
    c.sqst = sq_en;
  }
  c.t += 1;
  return fired;
}

// the probe: `steps` serial steps on one thread, inputs from shared memory
// off the dependent chain
__global__ void chain_kernel(int steps, double* out) {
  __shared__ float cur[256];
  __shared__ double pre[256];
  for (int j = threadIdx.x; j < 256; j += blockDim.x) {
    cur[j] = (float)((j * 37) % 23) * 0.5f;
    pre[j] = (double)j * 71.5;
  }
  __syncthreads();
  if (threadIdx.x) return;
  Carry c{{-1, 0, -1, FLT_MAX, FLT_MAX, false, false}, 0, 0, 0, 0,
          0.0, 0.0, 0.0f};
  for (int i = 0; i < steps; ++i)
    scan_step(c, cur[i & 255], cur[(i * 7) & 255], pre[i & 255],
              pre[(i * 3) & 255]);
  out[0] = c.sst + c.sqst + c.lsum + c.tot + c.f.pv0 + c.f.pv1 + c.f.pp0 +
           c.f.pp1;
}

}  // namespace

extern "C" int detect_block_f32(void** p, int B, int S, void* stream) {
  Args a;
  int k = 0;
  a.sig = (const float*)p[k++];
  a.masked_to = (const int32_t*)p[k++];
  a.peak_pos = (const int32_t*)p[k++];
  a.peak_value = (const float*)p[k++];
  a.valid_peak = (const uint8_t*)p[k++];
  a.evt_st = (const int32_t*)p[k++];
  a.S_st = (const double*)p[k++];
  a.SQ_st = (const double*)p[k++];
  a.t = (const int32_t*)p[k++];
  a.total_events = (const int32_t*)p[k++];
  a.len_sum = (const float*)p[k++];
  a.tail = (const float*)p[k++];
  a.S0 = (const double*)p[k++];
  a.SQ0 = (const double*)p[k++];
  a.o_masked_to = (int32_t*)p[k++];
  a.o_peak_pos = (int32_t*)p[k++];
  a.o_peak_value = (float*)p[k++];
  a.o_valid_peak = (uint8_t*)p[k++];
  a.o_evt_st = (int32_t*)p[k++];
  a.o_S_st = (double*)p[k++];
  a.o_SQ_st = (double*)p[k++];
  a.o_t = (int32_t*)p[k++];
  a.o_total_events = (int32_t*)p[k++];
  a.o_len_sum = (float*)p[k++];
  a.o_tail = (float*)p[k++];
  a.o_S0 = (double*)p[k++];
  a.o_SQ0 = (double*)p[k++];
  a.fired = (uint8_t*)p[k++];
  a.mean = (float*)p[k++];
  a.stdv = (float*)p[k++];
  a.start = (int32_t*)p[k++];
  a.length = (float*)p[k++];
  a.rounds = (int32_t*)p[k++];
  a.B = B;
  a.S = S;
  if (B <= 0 || S < 2 * TAIL) return (int)cudaErrorInvalidValue;
  const int chs = S < CH ? S : CH;
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn_smem(CH));
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const size_t smem = dyn_smem(chs);
  detect_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#ifdef DETECT_PHASES
extern "C" int detect_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
}
#endif

// The check of ddiv_w and fdiv_w against the division instructions:
// out[0] counts the f32 inputs (all 2^32, w = 3 and 6) whose quotient
// bits differ, out[1] the f64 ones among `n` hashed inputs a width (random
// bits, and random mantissas at exponents within 2^+-64), out[2] how many
// of those took the three-operation path.
__device__ __forceinline__ unsigned long long mix64(unsigned long long z) {
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}
__device__ __forceinline__ bool same_q(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b) || (a != a && b != b);
}
__device__ __forceinline__ bool same_q(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b) ||
         (a != a && b != b);
}
__global__ void div_check_kernel(unsigned long long n,
                                 unsigned long long* out) {
  unsigned long long bad32 = 0, bad64 = 0, fast = 0;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x +
                              threadIdx.x;
       i < (1ull << 32); i += stride) {
    const float x = __uint_as_float((unsigned)i);
    bad32 += !same_q(fdiv_w<3>(x), f_div(x, 3.0f));
    bad32 += !same_q(fdiv_w<6>(x), f_div(x, 6.0f));
  }
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x +
                              threadIdx.x;
       i < n; i += stride) {
    unsigned long long h = mix64(i);
    if (i & 1)  // a random mantissa at an exponent within 2^+-64
      h = (h & 0x800fffffffffffffull) |
          ((unsigned long long)(1023 - 64 + (mix64(~i) & 127)) << 52);
    const double x = __longlong_as_double((long long)h);
    const double ax = fabs(x);
    fast += (ax >= 0x1p-900 && ax <= 0x1p900);
    bad64 += !same_q(ddiv_w<3>(x), __ddiv_rn(x, 3.0));
    bad64 += !same_q(ddiv_w<6>(x), __ddiv_rn(x, 6.0));
  }
  atomicAdd(out, bad32);
  atomicAdd(out + 1, bad64);
  atomicAdd(out + 2, fast);
}

extern "C" int probe_div_check(int n, void* out, void* stream) {
  cudaMemsetAsync(out, 0, 3 * sizeof(unsigned long long),
                  (cudaStream_t)stream);
  div_check_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      (unsigned long long)n, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

extern "C" int probe_detect_chain(int steps, void* out, void* stream) {
  chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(steps, (double*)out);
  return (int)cudaGetLastError();
}
