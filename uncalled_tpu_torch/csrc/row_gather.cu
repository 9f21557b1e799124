// Per-row and shared-table gather of the classic step (Hopper, sm_90a).
//
// Replaces uncalled_tpu/ops/mxu_gather.py:_gather_kernel (the monolithic
// one-hot MXU gather, N <= 4096) and :_gather_kernel_chunked (the same
// function with the contraction walked in HC-row chunks, N > 4096), both
// reached through _gather_i32 by row_gather / shared_gather /
// row_gather_fields from engine._row_gather, _pack_gather and
// _shared_gather.
//
//   out[f, b, k] = tbl[b * bstride + clamp(idx[b, k], 0, N-1) * F + f]
//
// with bstride = N * F for a per-row table [B, N, F] and 0 for a shared
// table [N, F].  The payload is any 32-bit pattern (f32 fields move as
// their bits, so NaN payloads and -0.0 survive).
//
// Bound on the card: device memory.  The gather does no arithmetic: it
// reads each index once, one 4-byte field per output element, and writes
// the output once.  The TPU needed the one-hot matmul, the W=8 layout and
// the H-chunking because its gathers were slow per index and its tables
// had to fit VMEM; the card gathers directly.  Design: one thread per
// output element, k fastest, so the index reads and the fields-major
// [F, B, K] writes coalesce and only the table reads scatter (a gathered
// row is 4-92 bytes: one or a few sectors, shared by the F threads that
// read its fields).  Every size N takes the same kernel.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void row_gather_kernel(const int32_t* __restrict__ tbl,
                                  long long bstride, int N, int F,
                                  const int32_t* __restrict__ idx, int B,
                                  int K, int32_t* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long bk = (long long)B * K;
  if (t >= bk * F) return;
  const int f = (int)(t / bk);
  const long long r = t - (long long)f * bk;  // b * K + k
  const int b = (int)(r / K);
  int i = idx[r];
  i = i < 0 ? 0 : (i > N - 1 ? N - 1 : i);
  out[t] = tbl[(long long)b * bstride + (long long)i * F + f];
}

extern "C" int row_gather_i32(const void* tbl, int shared, int N, int F,
                              const void* idx, int B, int K, void* out,
                              void* stream) {
  const long long total = (long long)B * K * F;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  const long long bstride = shared ? 0 : (long long)N * F;
  row_gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tbl, bstride, N, F, (const int32_t*)idx, B, K,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
