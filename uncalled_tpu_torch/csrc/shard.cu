// Shard-local row gather of a row-sharded table (Hopper, sm_90a).
//
// Replaces: no Pallas kernel.  The local half of the JAX engines' sharded
// row gather, uncalled_tpu/mapping/engine.py:_shard_take (:262-272): under
// shard_map each idx shard answers the rows that fall in its block, zeroes
// the others, and a psum over idx combines the answers.  Here the psum is a
// torch.distributed all_reduce(SUM) over the idx process group, outside the
// kernel (uncalled_tpu_torch/ops/shard_take.py).
//
// out[i, f] = tbl[rows[i] - lo, f] if lo <= rows[i] < lo + per, else 0,
// where tbl is this rank's [per, F] int32 block (F = 6 for occ_rows, 1 for
// sa or sa_samp) and lo = the block's first global row.  Every table is
// int32, so the sum of one owner's word and zeros is exact in any order.
//
// Bound on the card: bytes (the rows read once, the output written once,
// one F-word table row per owned index), a few integer operations a word.
// Design: one thread per output word, neighbouring threads on neighbouring
// words, so the F words of a row are one coalesced run; the index is read
// once per word from L1.  Indices outside the block read nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
shard_take_kernel(const int32_t* __restrict__ tbl,
                  const int32_t* __restrict__ rows, int32_t* __restrict__ out,
                  long long total, int F, long long lo, long long per) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long i = e / F;
  const int f = (int)(e - i * F);
  const long long r = (long long)__ldg(rows + i) - lo;
  out[e] = (r >= 0 && r < per) ? __ldg(tbl + r * F + f) : 0;
}

}  // namespace

extern "C" int shard_take_i32(const void* tbl, const void* rows, void* out,
                              int N, int F, int lo, int per, void* stream) {
  if (N == 0) return 0;
  const long long total = (long long)N * F;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  shard_take_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tbl, (const int32_t*)rows, (int32_t*)out, total, F,
      (long long)lo, (long long)per);
  return (int)cudaGetLastError();
}
