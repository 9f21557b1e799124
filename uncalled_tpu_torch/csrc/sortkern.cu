// The bitonic candidate sort of the pooled step (Hopper, sm_90a): the run
// sort and every merge level, down to stride 1.
//
// Replaces uncalled_tpu/ops/sortkern.py:_level_kernel (one merge level's
// XOR passes at strides >= C) and the XLA row sorts that finished each
// level and built the first runs (uncalled_tpu/mapping/pooled.py:379-397,
// lax.sort along rows).  The network, over NK <= 8 int32 key planes of
// length NP (a power of two), compared lexicographically over the tuple:
//
//   for k = 2, 4, ..., NP:                 (levels)
//     for s = k/2, k/4, ..., 1:            (passes)
//       for every i with bit s clear, partner j = i | s:
//         ascending iff (i & k) == 0; put the smaller tuple first
//         (the larger first when descending)
//
// A pass of the TPU kernel (`ties never swap`) and this one differ only on
// tuples equal in every key, where a swap changes no bit; so any schedule
// of the same passes gives the same planes, and a level run to stride 1
// sorts each k-chunk in its direction, which is what the row sort did.
//
// The host (ops/sortkern.py) hands a schedule: launches of three kinds,
// each running a contiguous stretch of the network's passes, every launch
// on one [NK, NP] buffer:
//
//   * kind 0, runs: one block per tile of `tile` elements reads the caller's
//     key planes where they lie (positions >= N read INT32_MAX: the padding)
//     and runs levels 2 ... tile on the chip: the run sort;
//   * kind 1, tile: the same on the buffer in place, for the passes of a
//     level whose strides are below the tile (the level's tail);
//   * kind 2, global: R (1-4) strides >= the tile of one level in one
//     device-memory round trip: each thread loads the 2^R elements that
//     those R passes pair with one another and runs the passes in
//     registers.
//
// Bound on the card: the compares.  A sort of NP = 131072 tuples runs 153
// passes of NP/2 compare-exchanges, about ten instructions of compare and
// ten of select each; device memory sees one round trip per launch (5.24
// MB at NK = 5, which stays in the 50 MB L2).  Inside a tile each thread
// holds E consecutive elements in registers (E = 4 up to 2048-element
// tiles, 8 at 4096, 16 at 8192; loaded and stored once, all loads in
// flight): strides below E are swaps in registers, strides below 32E a
// warp shuffle with the partner lane, wider strides an exchange through
// shared memory (striped, conflict-free) between two barriers.  The tile
// is also the unit of parallelism, NP / tile blocks, so small tiles win:
// chip_smoke.py sweeps the run width, the tile and R (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_NK = 8;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may take
constexpr int GLOBAL_THREADS = 256;
constexpr int I32_MAX = 0x7fffffff;

struct Keys {
  const int32_t* k[MAX_NK];
};

// (x < y, x == y) over the NK-tuple, lexicographically
template <int NK>
__device__ __forceinline__ void lex(const int32_t (&x)[NK],
                                    const int32_t (&y)[NK], bool& lt,
                                    bool& eq) {
  lt = false;
  eq = true;
#pragma unroll
  for (int q = 0; q < NK; ++q) {
    lt |= eq & (x[q] < y[q]);
    eq &= x[q] == y[q];
  }
}

// compare-exchange of a (lower index) and b in registers
template <int NK>
__device__ __forceinline__ void ce(int32_t (&a)[NK], int32_t (&b)[NK],
                                   bool asc) {
  bool lt, eq;
  lex<NK>(b, a, lt, eq);
  bool swap = asc ? lt : !(lt | eq);
#pragma unroll
  for (int q = 0; q < NK; ++q) {
    int32_t x = a[q], y = b[q];
    a[q] = swap ? y : x;
    b[q] = swap ? x : y;
  }
}

// one side of a compare-exchange whose partner p lives in another thread:
// keep the smaller tuple when (lower == asc), else the larger
template <int NK>
__device__ __forceinline__ void keep_side(int32_t (&m)[NK],
                                          const int32_t (&p)[NK],
                                          bool lower, bool asc) {
  bool lt, eq;
  lex<NK>(p, m, lt, eq);
  bool take = (lower == asc) ? lt : !(lt | eq);
#pragma unroll
  for (int q = 0; q < NK; ++q) m[q] = take ? p[q] : m[q];
}

template <int NK, int E, int S>
__device__ __forceinline__ void reg_pass_s(int32_t (&v)[E][NK], int k,
                                           int gi0) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if ((e & S) == 0) ce<NK>(v[e], v[e | S], ((gi0 + e) & k) == 0);
  }
}

// a pass at stride s < E: both elements in this thread's registers
template <int NK, int E>
__device__ __forceinline__ void reg_pass(int32_t (&v)[E][NK], int s, int k,
                                         int gi0) {
  if (s == 1) {
    reg_pass_s<NK, E, 1>(v, k, gi0);
  } else if (s == 2) {
    reg_pass_s<NK, E, 2>(v, k, gi0);
  } else if (s == 4) {
    if constexpr (E > 4) reg_pass_s<NK, E, 4>(v, k, gi0);
  } else {
    if constexpr (E > 8) reg_pass_s<NK, E, 8>(v, k, gi0);
  }
}

// Passes (k_first, s_first) ... (k_last, s_last) of the network over one
// tile of blockDim.x * E elements.  Reads the caller's planes (src.k[0]
// set: the run sort, with the INT32_MAX padding at positions >= N) or the
// buffer; writes the buffer.
template <int NK, int E>
__global__ void __launch_bounds__(512)
    tile_net(Keys src, int N, int32_t* __restrict__ buf, int NP, int k_first,
             int s_first, int k_last, int s_last) {
  extern __shared__ __align__(16) int32_t sm[];  // [NK][tile], exchanges
  const int threads = blockDim.x;
  const int tile = threads * E;
  const int t = threadIdx.x;
  const int gi0 = blockIdx.x * tile + t * E;  // this thread's first element
  int32_t v[E][NK];

  // E consecutive elements a thread, every load in flight at once
  if (src.k[0] != nullptr) {
#pragma unroll
    for (int q = 0; q < NK; ++q) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        v[e][q] = gi0 + e < N ? __ldg(src.k[q] + gi0 + e) : I32_MAX;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < NK; ++q) {
#pragma unroll
      for (int e = 0; e < E; e += 4) {
        int4 w = *reinterpret_cast<const int4*>(buf + (long long)q * NP +
                                                gi0 + e);
        v[e][q] = w.x;
        v[e + 1][q] = w.y;
        v[e + 2][q] = w.z;
        v[e + 3][q] = w.w;
      }
    }
  }

  int k = k_first, s = s_first;
  while (true) {
    if (s < E) {
      reg_pass<NK, E>(v, s, k, gi0);
    } else {
      // bit s of an element's index is bit s/E of its thread's
      const int m = s / E;
      const bool lower = (t & m) == 0;
      const bool asc = (gi0 & k) == 0;  // k > s >= E: one direction a thread
      if (m < 32) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          int32_t p[NK];
#pragma unroll
          for (int q = 0; q < NK; ++q) {
            p[q] = __shfl_xor_sync(0xffffffffu, v[e][q], m);
          }
          keep_side<NK>(v[e], p, lower, asc);
        }
      } else {
        // across warps: a striped exchange (element e of thread t at
        // e * threads + t), conflict-free for both sides
        __syncthreads();
#pragma unroll
        for (int q = 0; q < NK; ++q) {
#pragma unroll
          for (int e = 0; e < E; ++e) sm[q * tile + e * threads + t] = v[e][q];
        }
        __syncthreads();
        const int pt = t ^ m;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          int32_t p[NK];
#pragma unroll
          for (int q = 0; q < NK; ++q) p[q] = sm[q * tile + e * threads + pt];
          keep_side<NK>(v[e], p, lower, asc);
        }
      }
    }
    if (k == k_last && s == s_last) break;
    if (s == 1) {
      k <<= 1;
      s = k >> 1;
    } else {
      s >>= 1;
    }
  }

#pragma unroll
  for (int q = 0; q < NK; ++q) {
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      *reinterpret_cast<int4*>(buf + (long long)q * NP + gi0 + e) =
          make_int4(v[e][q], v[e + 1][q], v[e + 2][q], v[e + 3][q]);
    }
  }
}

// R passes of level k at strides s_lo << (R-1) ... s_lo (s_lo = 1 << sh),
// each thread on the 2^R elements they pair: base + j * s_lo.
template <int NK, int R>
__global__ void __launch_bounds__(GLOBAL_THREADS, 2)
    global_net(int32_t* __restrict__ buf, int NP, int k, int sh) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (NP >> R)) return;
  const int base = (g & ((1 << sh) - 1)) | ((g >> sh) << (sh + R));
  const bool asc = (base & k) == 0;
  int32_t v[1 << R][NK];
#pragma unroll
  for (int j = 0; j < (1 << R); ++j) {
#pragma unroll
    for (int q = 0; q < NK; ++q) {
      v[j][q] = buf[(long long)q * NP + base + (j << sh)];
    }
  }
#pragma unroll
  for (int b = R - 1; b >= 0; --b) {
#pragma unroll
    for (int j = 0; j < (1 << R); ++j) {
      if ((j & (1 << b)) == 0) ce<NK>(v[j], v[j | (1 << b)], asc);
    }
  }
#pragma unroll
  for (int j = 0; j < (1 << R); ++j) {
#pragma unroll
    for (int q = 0; q < NK; ++q) {
      buf[(long long)q * NP + base + (j << sh)] = v[j][q];
    }
  }
}

bool pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

int log2i(long long x) {
  int r = 0;
  while ((1LL << r) < x) ++r;
  return r;
}

template <int NK, int E>
cudaError_t launch_tile(const Keys& src, int N, int32_t* buf, int NP,
                        int tile, int kf, int sf, int kl, int sl,
                        cudaStream_t st) {
  static bool attr = false;  // once per instantiation
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        tile_net<NK, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  int smem = NK * tile * (int)sizeof(int32_t);
  tile_net<NK, E><<<NP / tile, tile / E, smem, st>>>(src, N, buf, NP, kf, sf,
                                                      kl, sl);
  return cudaGetLastError();
}

template <int NK>
cudaError_t launch_global(int32_t* buf, int NP, int R, int k, int sh,
                          cudaStream_t st) {
  int blocks = ((NP >> R) + GLOBAL_THREADS - 1) / GLOBAL_THREADS;
  const int T = GLOBAL_THREADS;
  switch (R) {
    case 1: global_net<NK, 1><<<blocks, T, 0, st>>>(buf, NP, k, sh); break;
    case 2: global_net<NK, 2><<<blocks, T, 0, st>>>(buf, NP, k, sh); break;
    case 3: global_net<NK, 3><<<blocks, T, 0, st>>>(buf, NP, k, sh); break;
    case 4: global_net<NK, 4><<<blocks, T, 0, st>>>(buf, NP, k, sh); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int NK>
cudaError_t launch_one(const long long* L, const Keys& src, int N,
                       int32_t* buf, int NP, cudaStream_t st) {
  const long long kind = L[0], a = L[1], kf = L[2], sf = L[3], kl = L[4],
                  sl = L[5];
  if (!pow2(kf) || !pow2(kl) || !pow2(sf) || !pow2(sl) || kf < 2 ||
      kl > NP || kf > kl || 2 * sf > kf || 2 * sl > kl ||
      (kf == kl && sl > sf)) {
    return cudaErrorInvalidValue;
  }
  if (kind == 2) {  // global: R = a strides of one level, each >= a tile
    if (kf != kl || a < 1 || a > 4 || sf != (sl << (a - 1))) {
      return cudaErrorInvalidValue;
    }
    return launch_global<NK>(buf, NP, (int)a, (int)kf, log2i(sl), st);
  }
  if (kind != 0 && kind != 1) return cudaErrorInvalidValue;
  // tile kinds: every stride below the tile, E elements a thread
  const long long tile = a;
  const int E = tile > 4096 ? 16 : tile > 2048 ? 8 : 4;
  if (!pow2(tile) || tile < 256 || tile > 8192 || tile > NP ||
      NK * tile * 4 > SMEM_MAX || (kf == kl ? sf : kl / 2) >= tile) {
    return cudaErrorInvalidValue;
  }
  Keys from = src;
  if (kind == 1) {
    for (int q = 0; q < MAX_NK; ++q) from.k[q] = nullptr;
  } else if (src.k[0] == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (E == 16) {
    return launch_tile<NK, 16>(from, N, buf, NP, (int)tile, (int)kf, (int)sf,
                               (int)kl, (int)sl, st);
  }
  if (E == 8) {
    return launch_tile<NK, 8>(from, N, buf, NP, (int)tile, (int)kf, (int)sf,
                              (int)kl, (int)sl, st);
  }
  return launch_tile<NK, 4>(from, N, buf, NP, (int)tile, (int)kf, (int)sf,
                            (int)kl, (int)sl, st);
}

template <int NK>
int run_schedule(void** src_ptrs, int N, int32_t* buf, int NP,
                 const long long* sched, int n, cudaStream_t st) {
  Keys src;
  for (int q = 0; q < MAX_NK; ++q) {
    src.k[q] = (src_ptrs != nullptr && q < NK)
                   ? (const int32_t*)src_ptrs[q] : nullptr;
  }
  for (int i = 0; i < n; ++i) {
    cudaError_t e = launch_one<NK>(sched + 6 * i, src, N, buf, NP, st);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// Runs `n` launches of the schedule `sched` (six int64 each: kind, tile or
// R, k_first, s_first, k_last, s_last; ops/sortkern.py builds it) on the
// [nk, NP] int32 buffer `buf`, in order, on `stream`.  `src` holds the nk
// caller planes of length N (read by kind 0 only).  Returns the first CUDA
// error, or cudaErrorInvalidValue for a launch off the kernels' shapes
// (NP a power of two >= 256, nk in 1..8, N <= NP); 0 when every launch
// was accepted.
extern "C" int sort_net_i32(void** src, int nk, int N, void* buf, int NP,
                            const long long* sched, int n, void* stream) {
  if (nk < 1 || nk > MAX_NK || !pow2(NP) || NP < 256 || N < 0 || N > NP) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* b = (int32_t*)buf;
  switch (nk) {
    case 1: return run_schedule<1>(src, N, b, NP, sched, n, st);
    case 2: return run_schedule<2>(src, N, b, NP, sched, n, st);
    case 3: return run_schedule<3>(src, N, b, NP, sched, n, st);
    case 4: return run_schedule<4>(src, N, b, NP, sched, n, st);
    case 5: return run_schedule<5>(src, N, b, NP, sched, n, st);
    case 6: return run_schedule<6>(src, N, b, NP, sched, n, st);
    case 7: return run_schedule<7>(src, N, b, NP, sched, n, st);
    default: return run_schedule<8>(src, N, b, NP, sched, n, st);
  }
}
