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
// fields into a packed table first.  The pair count is a histogram of a
// few hundred thousand keys into 1 MB of int32 counters (in L2): one thread
// per key, one int32 atomicAdd per in-domain key -- integer atomics, so the
// result is the same in any order.

#include "gather.cuh"

// out[a[c] * nb + b[c]] += 1 for keys inside [0, na) x [0, nb)
__global__ void pair_counts_kernel(const int32_t* __restrict__ a,
                                   const int32_t* __restrict__ b, int K,
                                   int na, int nb, int32_t* __restrict__ out) {
  int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= K) return;
  int i = a[c];
  int j = b[c];
  if (i >= 0 && i < na && j >= 0 && j < nb) {
    atomicAdd(out + (long long)i * nb + j, 1);
  }
}

extern "C" int flat_gather_cols_i32(const long long* meta, const void* idx,
                                    void* out, void* stream) {
  return gather_cols_launch(meta, idx, out, stream);
}

extern "C" int pair_counts_i32(const void* a, const void* b, int K, int na,
                               int nb, void* out, void* stream) {
  if (K == 0) return 0;
  const int threads = 256;
  int blocks = (K + threads - 1) / threads;
  pair_counts_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)a, (const int32_t*)b, K, na, nb, (int32_t*)out);
  return (int)cudaGetLastError();
}
