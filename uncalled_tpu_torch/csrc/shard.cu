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
// one F-word table row per owned index), a few integer operations a row;
// in practice a launch and two dependent loads (the row index, then its
// table row).  Design: F a template parameter.  The ownership test is one
// 32-bit unsigned compare ((unsigned)(row - lo) < per, exact under the
// wrapper's range check lo >= 0, lo + per <= 2^31 - 1); only the
// addresses are 64-bit.  F = 6 (occ_rows, 24-byte rows): a warp of 32
// rows, the lanes load the 32 row indices (one coalesced load), then each
// lane moves 3 of the warp's 96 8-byte words (the wrapper checks the
// 8-byte alignment), the row index taken from its lane by a shuffle: every
// store instruction writes 256 contiguous bytes, the warp 768.  F = 1: one
// thread a row.  An unowned row reads nothing and writes zeros.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;

__global__ void __launch_bounds__(NT)
take6_kernel(const int32_t* __restrict__ tbl,
             const int32_t* __restrict__ rows, int32_t* __restrict__ out,
             int N, int lo, int per) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned r0 = (blockIdx.x * NT + threadIdx.x) & ~31u;  // warp's rows
  if (r0 >= (unsigned)N) return;
  const unsigned i = r0 + lane;
  const unsigned r =
      i < (unsigned)N ? (unsigned)__ldg(rows + i) - (unsigned)lo : ~0u;
  const unsigned nrow = min(32u, (unsigned)N - r0);
  const int2* src = reinterpret_cast<const int2*>(tbl);
  int2* dst = reinterpret_cast<int2*>(out) + (size_t)r0 * 3;
  int2 v[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const unsigned word = lane + 32 * q, row = word / 3;
    const unsigned rr = __shfl_sync(0xffffffffu, r, row);
    v[q] = rr < (unsigned)per ? __ldg(src + (size_t)rr * 3 + (word - row * 3))
                              : make_int2(0, 0);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const unsigned word = lane + 32 * q;
    if (word / 3 < nrow) dst[word] = v[q];
  }
}

__global__ void __launch_bounds__(NT)
take1_kernel(const int32_t* __restrict__ tbl,
             const int32_t* __restrict__ rows, int32_t* __restrict__ out,
             int N, int lo, int per) {
  const unsigned i = blockIdx.x * NT + threadIdx.x;
  if (i >= (unsigned)N) return;
  const unsigned r = (unsigned)__ldg(rows + i) - (unsigned)lo;
  out[i] = r < (unsigned)per ? __ldg(tbl + r) : 0;
}

}  // namespace

extern "C" int shard_take_i32(const void* tbl, const void* rows, void* out,
                              int N, int F, int lo, int per, void* stream) {
  if (N == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* t = (const int32_t*)tbl;
  const int32_t* r = (const int32_t*)rows;
  int32_t* o = (int32_t*)out;
  // F = 6: a whole warp for every 32 rows
  const long long threads = F == 6 ? ((long long)N + 31) / 32 * 32 : N;
  const unsigned blocks = (unsigned)((threads + NT - 1) / NT);
  if (F == 6)
    take6_kernel<<<blocks, NT, 0, s>>>(t, r, o, N, lo, per);
  else if (F == 1)
    take1_kernel<<<blocks, NT, 0, s>>>(t, r, o, N, lo, per);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
