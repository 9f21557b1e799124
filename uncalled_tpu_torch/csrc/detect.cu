// Streaming t-test event detector over one [B, S] signal block (Hopper,
// sm_90a).
//
// Replaces: no Pallas kernel.  The JAX package runs the detector as
// vectorised t-stats and a lax.scan over the block's samples,
// uncalled_tpu/ops/events.py:_tstats_block and detect_block (:338-471).
// Run eagerly in PyTorch, each sample of the scan is some 60 launches.
// Here the whole block is one launch, bit for bit the JAX function.
//
// Bound on the card: the serial scan.  Each row's peak detectors carry
// their state from one sample to the next, so a row costs S dependent
// steps of a few dozen compare-and-select instructions; the bytes (the
// [B, S] signal in, five [B, S] outputs out) are a small fraction of that.
// The prefix sums are exact for signals in pA, so a parallel scan would
// give the same bits: their serial order is this design's, not the
// function's.  Design, simple
// first: one block per row.  Threads 0 and 32 (two warps, side by side)
// sum the row's prefixes left to right from 0 into device-memory scratch
// and add S0 / SQ0 after, as concat([0, cumsum]) + S0 does; then, chunk by
// chunk, every thread computes the chunk's t-stats into shared memory,
// thread 0 runs the peak detectors over the chunk with the carry in
// registers, and every thread computes the chunk's event statistics from
// the stashed event starts and writes the outputs.  Shared memory is fixed
// (CH samples a chunk), so any S >= 2 * TAIL is taken.
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
//  - the prefix sums are exact for signals in pA, so their order does not
//    matter (ops/events.py prefix_sums_exact); the left-to-right order is
//    torch.cumsum's on the CPU, so the kernel equals the plain version
//    even where they are not.
//
// probe_detect_chain (a measurement probe for chip_smoke.py, no kernel of
// the mapper) runs the same scan step on one thread for a number of steps:
// the latency of this implementation's step, which the serial bound uses.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W1 = 3, W2 = 6, TAIL = 12;
constexpr int NT = 256;  // threads a block
constexpr int CH = 512;  // samples a chunk

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
  // scratch: the global f64 prefix arrays [2, B, S + TAIL + 1]
  double* pref;
  int B, S;
};

// One peak detector at one sample (event_detector.cpp:221-279, as the JAX
// scan's one_det computes it); returns whether it fired.
__device__ __forceinline__ bool peak_det(float cur, int m, float thresh,
                                         int whalf, int mt, int& pp,
                                         float& pv, bool& vd) {
  bool act = (m < 0) || (mt < m);  // the u32 wrap of buf_mid for m < 0
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
  int mt0, mt1, pp0, pp1;
  float pv0, pv1;
  bool vd0, vd1;
  int evst, t, tot;
  double sst, sqst;
  float lsum;
};

// One sample of the scan: both detectors (the short one resets the long
// one first when its case-2 peak passes its threshold), then the open
// event's carry.  Returns whether an event was created.
__device__ __forceinline__ bool scan_step(Carry& c, float cur1, float cur2,
                                          double s_en, double sq_en) {
  const int m = c.t - 5;
  bool s_act = (m < 0) || (c.mt0 < m);
  bool s_hi = cur1 > c.pv0;
  float s_pv2 = s_hi ? cur1 : c.pv0;
  int s_pp2 = s_hi ? m : c.pp0;
  if (s_act && c.pp0 != -1 && s_pv2 > 1.4f) {
    c.mt1 = s_pp2 + W1;
    c.pp1 = -1;
    c.pv1 = FLT_MAX;
    c.vd1 = false;
  }
  bool f0 = peak_det(cur1, m, 1.4f, W1 / 2, c.mt0, c.pp0, c.pv0, c.vd0);
  bool f1 = peak_det(cur2, m, 9.0f, W2 / 2, c.mt1, c.pp1, c.pv1, c.vd1);
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

// t-stat of window w at block sample i (the JAX _tstats_block)
// (P and Q are written earlier in the same launch: plain loads, no
// read-only path)
__device__ __forceinline__ float tstat(const double* P, const double* Q,
                                       int i, int tg, int w) {
  int m = i + TAIL - 5;
  int mg = tg - 5;
  int left = (mg >= 0 && mg < w) ? m + 2 * w : m - w;  // start-of-read wrap
  double pm = P[m], pqm = Q[m];
  double sum1 = __dsub_rn(pm, P[left]);
  double sumsq1 = __dsub_rn(pqm, Q[left]);
  float sum2 = d2f(__dsub_rn(P[m + w], pm));
  float sumsq2 = d2f(__dsub_rn(Q[m + w], pqm));
  float wf = (float)w;
  double wd = (double)w;
  float mean1 = d2f(__ddiv_rn(sum1, wd));
  float mean2 = f_div(sum2, wf);
  double comb64 = __dsub_rn(
      __dadd_rn(__dsub_rn(__ddiv_rn(sumsq1, wd), f2d(f_mul(mean1, mean1))),
                f2d(f_div(sumsq2, wf))),
      f2d(f_mul(mean2, mean2)));
  float comb = jmax(d2f(comb64), FLT_MIN);
  float delta = f_sub(mean2, mean1);
  float inner = f_div(comb, wf);
  float t = d2f(__ddiv_rn(fabs(f2d(delta)), __dsqrt_rn(f2d(inner))));
  // 0 / 0 (a window pair of equal samples): the x86 default NaN, as the
  // JAX function on the CPU gives it (the card's own is 0x7fffffff)
  if (t != t) t = __int_as_float(0xffc00000);
  return (tg + 2 <= 2 * w) ? 0.0f : t;  // reference: t <= 2w -> 0
}

__global__ void __launch_bounds__(NT) detect_kernel(const Args a) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int S = a.S, NX = S + TAIL, NP = NX + 1;
  const double* P = a.pref + (size_t)b * NP;
  const double* Q = a.pref + ((size_t)a.B + b) * NP;
  double* Pw = a.pref + (size_t)b * NP;
  double* Qw = a.pref + ((size_t)a.B + b) * NP;
  const float* sig = a.sig + (size_t)b * S;
  const int t_start = a.t[b];

  __shared__ float xsh[CH];
  __shared__ float t1s[CH], t2s[CH];
  __shared__ double sen[CH], sqen[CH], ssts[CH], sqsts[CH];
  __shared__ int32_t sts[CH];
  __shared__ uint8_t fs[CH];

  // 1. the prefix sums, left to right from 0; S0 / SQ0 added after
  {
    const double s0 = a.S0[b], q0 = a.SQ0[b];
    double run = 0.0;
    if (tid == 0) Pw[0] = __dadd_rn(0.0, s0);
    if (tid == 32) Qw[0] = __dadd_rn(0.0, q0);
    for (int c0 = 0; c0 < NX; c0 += CH) {
      const int n = min(CH, NX - c0);
      for (int j = tid; j < n; j += NT) {
        int g = c0 + j;
        xsh[j] = g < TAIL ? a.tail[b * TAIL + g] : sig[g - TAIL];
      }
      __syncthreads();
      if (tid == 0) {
        for (int j = 0; j < n; ++j) {
          run = __dadd_rn(run, f2d(xsh[j]));
          Pw[c0 + j + 1] = __dadd_rn(run, s0);
        }
      } else if (tid == 32) {
        // parity: square in f32, accumulate in f64 (event_detector.cpp:89)
        for (int j = 0; j < n; ++j) {
          float x = xsh[j];
          run = __dadd_rn(run, f2d(f_mul(x, x)));
          Qw[c0 + j + 1] = __dadd_rn(run, q0);
        }
      }
      __syncthreads();
    }
  }

  // 2. chunk by chunk: t-stats, the serial scan, the event statistics
  Carry c;
  if (tid == 0) {
    c.mt0 = a.masked_to[b];
    c.mt1 = a.masked_to[a.B + b];
    c.pp0 = a.peak_pos[b];
    c.pp1 = a.peak_pos[a.B + b];
    c.pv0 = a.peak_value[b];
    c.pv1 = a.peak_value[a.B + b];
    c.vd0 = a.valid_peak[b] != 0;
    c.vd1 = a.valid_peak[a.B + b] != 0;
    c.evst = a.evt_st[b];
    c.sst = a.S_st[b];
    c.sqst = a.SQ_st[b];
    c.t = t_start;
    c.tot = a.total_events[b];
    c.lsum = a.len_sum[b];
  }
  for (int c0 = 0; c0 < S; c0 += CH) {
    const int n = min(CH, S - c0);
    for (int j = tid; j < n; j += NT) {
      int i = c0 + j;
      t1s[j] = tstat(P, Q, i, t_start + i, W1);
      t2s[j] = tstat(P, Q, i, t_start + i, W2);
      // the global prefixes at the event boundary en = i - 7
      sen[j] = P[i + TAIL - 7];
      sqen[j] = Q[i + TAIL - 7];
    }
    __syncthreads();
    if (tid == 0) {
      for (int j = 0; j < n; ++j) {
        sts[j] = c.evst;
        ssts[j] = c.sst;
        sqsts[j] = c.sqst;
        fs[j] = scan_step(c, t1s[j], t2s[j], sen[j], sqen[j]);
      }
    }
    __syncthreads();
    for (int j = tid; j < n; j += NT) {
      int i = c0 + j;
      size_t o = (size_t)b * S + i;
      int en = t_start + i - 7;
      float len = (float)(en - sts[j]);
      float lsafe = jmax(len, 1.0f);
      float mean = d2f(__ddiv_rn(__dsub_rn(sen[j], ssts[j]), (double)lsafe));
      float dsq = d2f(__dsub_rn(sqen[j], sqsts[j]));
      // XLA's contraction of dsq / lsafe - mean * mean
      float var = f_fma(-mean, mean, f_div(dsq, lsafe));
      a.fired[o] = fs[j] && mean >= 0.0f && mean <= 40000.0f;
      a.mean[o] = mean;
      a.stdv[o] = f_sqrt(jmax(var, 0.0f));
      a.start[o] = sts[j];
      a.length[o] = len;
    }
    __syncthreads();
  }

  // 3. the new state
  if (tid == 0) {
    a.o_masked_to[b] = c.mt0;
    a.o_masked_to[a.B + b] = c.mt1;
    a.o_peak_pos[b] = c.pp0;
    a.o_peak_pos[a.B + b] = c.pp1;
    a.o_peak_value[b] = c.pv0;
    a.o_peak_value[a.B + b] = c.pv1;
    a.o_valid_peak[b] = c.vd0;
    a.o_valid_peak[a.B + b] = c.vd1;
    a.o_evt_st[b] = c.evst;
    a.o_S_st[b] = c.sst;
    a.o_SQ_st[b] = c.sqst;
    a.o_t[b] = c.t;
    a.o_total_events[b] = c.tot;
    a.o_len_sum[b] = c.lsum;
    // the prefix carry advances to position t_new - TAIL = padded index S
    a.o_S0[b] = P[S];
    a.o_SQ0[b] = Q[S];
  }
  if (tid < TAIL) a.o_tail[b * TAIL + tid] = sig[S - TAIL + tid];
}

// the probe: `steps` scan steps on one thread, inputs from shared memory
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
  Carry c{0, 0, -1, -1, FLT_MAX, FLT_MAX, false, false, 0, 0, 0,
          0.0, 0.0, 0.0f};
  for (int i = 0; i < steps; ++i)
    scan_step(c, cur[i & 255], cur[(i * 7) & 255], pre[i & 255],
              pre[(i * 3) & 255]);
  out[0] = c.sst + c.sqst + c.lsum + c.tot + c.pv0 + c.pv1 + c.pp0 + c.pp1;
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
  a.pref = (double*)p[k++];
  a.B = B;
  a.S = S;
  if (B <= 0 || S < 2 * TAIL) return (int)cudaErrorInvalidValue;
  detect_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int probe_detect_chain(int steps, void* out, void* stream) {
  chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(steps, (double*)out);
  return (int)cudaGetLastError();
}
