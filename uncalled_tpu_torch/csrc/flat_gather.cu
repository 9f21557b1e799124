// Flat shared-table gather and pair count for the pooled step (Hopper, sm_90a).
//
// Replaces:
//   flat_gather_cols_i32 <- uncalled_tpu/ops/flat_gather.py:_kernel (the
//     two-level MXU one-hot gather, reached through _gather_i32 by
//     flat_gather / flat_gather_fields from pooled._flat_take and by the
//     pooled step's field packs, now flat_gather_cols)
//   pair_counts_i32      <- uncalled_tpu/ops/flat_gather.py:_count_kernel
//     (the int8 one-hot pair-count contraction, pair_counts)
//
// The gather is the column-descriptor gather of gather.cuh with one batch
// row: out[f, k] = col_f[clamp(idx[k], 0, N-1)].  Bound on the card: bytes,
// and for its scattered rows the L2's latency (each field was written by
// the op just before, so it sits in the 50 MB L2).  The TPU needed the
// one-hot scheme because its gather was slow per index; the card gathers
// directly.  One thread per index reads its row once, with all F loads in
// flight before its stores (16-byte loads where four 32-bit fields sit
// side by side), so no row is fetched once per field; and the columns are
// read where they lie (a packed table's field, a strided view, a bool, a
// segment of several tensors and constants), so no caller copies its
// fields into a packed table first.
//
// The pair count is a histogram of K keys into na * nb int32 counters
// (122880 keys into 1 MB at the pooled step's shapes, all in L2): bound by
// launch latency, not bytes.  One cooperative launch does the whole
// function: every block zeroes its share of out with 16-byte stores, one
// grid barrier, then the count -- so no separate fill launch.  Each thread
// takes four keys of each vector with one 16-byte load (scalar loads for
// the tail or an unaligned view) and folds runs of one cell among its four
// into one atomic: the live keys come out of the candidate sort nearly
// ordered by cell, so runs are common.  Grouping equal cells across the
// warp (__match_any_sync, with __reduce_add_sync or a popcount) measured
// slower on seeded, sorted and live keys alike, so each run adds on its
// own.  Integer adds commute, so the result is the same bits in any order.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>

#include "gather.cuh"

namespace cg = cooperative_groups;

// the cell of key pair (i, j), or -1 outside [0, na) x [0, nb)
__device__ __forceinline__ int pair_cell(int i, int j, int na, int nb) {
  return (i >= 0 && i < na && j >= 0 && j < nb) ? i * nb + j : -1;
}

// the four keys of group g (keys 4g .. 4g+3; -1 past K): one 16-byte load
// of each vector where both are aligned, else scalar loads
__device__ __forceinline__ void pair_keys4(const int32_t* __restrict__ a,
                                           const int32_t* __restrict__ b,
                                           long long g, int K, int na, int nb,
                                           bool vec, int key[4]) {
  const long long c = g << 2;
  if (vec && c + 4 <= K) {
    const int4 va = __ldg(reinterpret_cast<const int4*>(a) + g);
    const int4 vb = __ldg(reinterpret_cast<const int4*>(b) + g);
    key[0] = pair_cell(va.x, vb.x, na, nb);
    key[1] = pair_cell(va.y, vb.y, na, nb);
    key[2] = pair_cell(va.z, vb.z, na, nb);
    key[3] = pair_cell(va.w, vb.w, na, nb);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      key[q] = c + q < K ? pair_cell(__ldg(a + c + q), __ldg(b + c + q), na,
                                     nb)
                         : -1;
  }
}

// out[a[c] * nb + b[c]] = #{c} for keys inside [0, na) x [0, nb); out is
// zeroed first by the same launch
__global__ void __launch_bounds__(1024)
pair_counts_kernel(const int32_t* __restrict__ a,
                   const int32_t* __restrict__ b, int K, int na, int nb,
                   int32_t* __restrict__ out) {
  const long long cells = (long long)na * nb;
  const long long nthr = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // zero fill; out is the wrapper's own allocation, so 16-byte aligned
  const long long c4 = cells >> 2;
  for (long long q = tid; q < c4; q += nthr)
    reinterpret_cast<int4*>(out)[q] = make_int4(0, 0, 0, 0);
  for (long long q = (c4 << 2) + tid; q < cells; q += nthr) out[q] = 0;
  cg::this_grid().sync();  // every zero lands before any add

  const bool vec = ((reinterpret_cast<uintptr_t>(a) |
                     reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  const long long groups = ((long long)K + 3) >> 2;
  for (long long g = tid; g < groups; g += nthr) {
    int key[4];
    pair_keys4(a, b, g, K, na, nb, vec, key);
    // runs of one cell inside the thread's four: a run's first slot adds
    // its length, the others add nothing
    const bool e1 = key[1] == key[0], e2 = key[2] == key[1],
               e3 = key[3] == key[2];
    if (key[0] >= 0) atomicAdd(out + key[0], 1 + (e1 ? 1 + (e2 ? 1 + e3 : 0)
                                                      : 0));
    if (!e1 && key[1] >= 0) atomicAdd(out + key[1], 1 + (e2 ? 1 + e3 : 0));
    if (!e2 && key[2] >= 0) atomicAdd(out + key[2], 1 + e3);
    if (!e3 && key[3] >= 0) atomicAdd(out + key[3], 1);
  }
}

extern "C" int flat_gather_cols_i32(const long long* meta, const void* idx,
                                    void* out, void* stream) {
  return gather_cols_launch(meta, idx, out, stream);
}

extern "C" int pair_counts_i32(const void* a, const void* b, int K, int na,
                               int nb, int threads, void* out, void* stream) {
  // a cooperative grid must fit on the card at once: at most one block of
  // `threads` per SM, fewer where the work is smaller (each block crosses
  // the grid barrier with one atomic on a single word).  The SM count and
  // the occupancy are kept per device and block width: the queries cost
  // host time on every step.
  static int c_dev = -1, c_threads = 0, sms = 0, fits = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != c_dev || threads != c_threads) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, pair_counts_kernel,
                                                  threads, 0);
    c_dev = dev;
    c_threads = threads;
  }
  const long long cells = (long long)na * nb;
  const long long work = std::max((cells >> 2) + 1, ((long long)K + 3) >> 2);
  const long long grid = fits > 0 ? sms : 1;  // fits == 0: the launch says so
  const int blocks = (int)std::max(
      1LL, std::min(grid, (work + threads - 1) / threads));
  int32_t* o = (int32_t*)out;
  const int32_t* pa = (const int32_t*)a;
  const int32_t* pb = (const int32_t*)b;
  void* args[] = {&pa, &pb, &K, &na, &nb, &o};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)pair_counts_kernel, dim3(blocks), dim3(threads), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
