// SA lookup from the 1/intv row sample by LF-walk (Hopper, sm_90a).
//
// Replaces: no Pallas kernel.  The JAX engines run the walk as an XLA
// while_loop, uncalled_tpu/mapping/engine.py:_sa_lookup (called by the
// classic step, engine.py:940-941, and the pooled step, pooled.py:1095-1096).
// Run eagerly in PyTorch each iteration would be a dozen launches and a host
// sync for the exit test; here the whole walk is one launch.
//
// out[i] = sa_samp[r / intv] + steps, where r starts at rows[i] and steps
// LF(r) = L2[c] + occ(c, r) (c = the BWT base of row r; LF(primary) = 0)
// until r % intv == 0 -- libbwa's bwt_sa, bit for bit as the JAX function
// computes it (with sa_samp[0] = n, a walk that passes the primary row ends
// n + 1 above the true SA value, as the JAX function's does).
//
// Bound on the card: the latency of the longest walk.  Each step is one
// dependent load of a 24-byte bucket row (occ_rows[j >> 5], from the 50 MB
// L2 once warm: ~7 MB for a 4.7 Mb genome) and a few dozen integer
// operations, and the walk's length is unbounded by intv (the SA is sampled
// by row, not by text position).  Design: one thread per row runs the whole
// walk in registers.  For r != primary the base index j = r - (r > primary)
// and the occ index kk = r - (r >= primary) are the same row, so one bucket
// row (three 8-byte loads, in flight together) serves both the base and the
// occ count; the count is two __popc of masked 2-bit words.  Walks of
// different rows overlap across the warps of an SM.
//
// sa_walk_step_i32 below runs the same walk over a row-sharded occ_rows, as
// far as each rank's block reaches (the sharded engines,
// uncalled_tpu_torch/parallel/sharded.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kEven = 0x55555555u;

// # of base c among the first inc (MSB-first) 2-bit bases of word
__device__ __forceinline__ int count_word(unsigned word, int inc, int c) {
  unsigned x = word ^ ((unsigned)c * kEven);
  unsigned m = ~x & (~x >> 1) & kEven;
  unsigned pm = inc <= 0 ? 0u
                : inc >= 16 ? 0xFFFFFFFFu
                            : 0xFFFFFFFFu << ((16 - inc) * 2);
  return __popc(m & pm);
}

// LF(r) = L2[c] + occ(c, r) for r != primary, from bucket row `row` of
// bwt index j = r - (r > primary): for r != primary that row also holds
// _occ's index kk = r - (r >= primary) = j
__device__ __forceinline__ int lf_from_row(const int2* row, int r, int j,
                                           int n, const int* L2) {
  const int2 ck01 = __ldg(row);
  const int2 ck23 = __ldg(row + 1);
  const int2 w01 = __ldg(row + 2);
  const int pos = j & 31;
  const unsigned word = (unsigned)(pos < 16 ? w01.x : w01.y);
  const int c = (word >> ((15 - (pos & 15)) * 2)) & 3;
  int occ;
  if (r >= n) {  // _occ's k >= n: the base's full count
    occ = L2[c + 1] - L2[c];
  } else {  // kk == j (r != primary, 0 <= j < n)
    const int ck = c == 0 ? ck01.x : c == 1 ? ck01.y : c == 2 ? ck23.x
                                                               : ck23.y;
    const int rem = j & 31;
    occ = ck + count_word((unsigned)w01.x, rem + 1, c) +
          count_word((unsigned)w01.y, rem - 15, c);
  }
  return L2[c] + occ;
}

// kPow2: intv is a power of two (the default 32), so the exit test and the
// sample index are a mask and a shift instead of an integer division on
// the walk's dependent chain
template <bool kPow2>
__global__ void __launch_bounds__(128)
sa_lookup_kernel(const int32_t* __restrict__ occ_rows,
                 const int32_t* __restrict__ sa_samp,
                 const int32_t* __restrict__ L2g,
                 const int32_t* __restrict__ rows, int32_t* __restrict__ out,
                 int N, int n, int primary, int intv) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  int L2[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) L2[c] = __ldg(L2g + c);
  const int mask = intv - 1, shift = __ffs(intv) - 1;
  // callers clamp rows to [0, n]; the clamp here only keeps loads in bounds
  int r = min(max(__ldg(rows + i), 0), n);
  int steps = 0;
  // the LF map is one cycle through all n + 1 rows and row 0 is sampled,
  // so a walk ends within n + 1 steps; the cap only guards bad tables
  while ((kPow2 ? r & mask : r % intv) != 0 && steps <= n) {
    if (r == primary) {
      r = 0;
    } else {
      const int j = r - (r > primary);  // >= 0: r > 0 here
      r = lf_from_row(
          reinterpret_cast<const int2*>(occ_rows) + 3 * (j >> 5), r, j, n,
          L2);
    }
    ++steps;
  }
  out[i] = __ldg(sa_samp + (kPow2 ? r >> shift : r / intv)) + steps;
}

// The steps of the walk that one rank can take on its block of a
// row-sharded occ_rows, for every row.
// Replaces: no Pallas kernel.  The JAX while_loop of
// uncalled_tpu/mapping/engine.py:338-381 as it runs under shard_map, where
// each iteration's base read and _occ each take a bucket row through
// _shard_take (two psums a step).  For r != primary the two reads are the
// same bucket row (see lf_from_row), so the rank that owns bucket j >> 5
// computes LF(r) alone; the primary row (LF = 0) belongs to the block with
// lo = 0.  The owner of a live row steps it on while it stays live and owned
// and reports (row, steps taken); the other ranks report (0, 0), so a sum
// over the idx ranks gives every rank each row's walk up to its first row
// in another block, one collective a hand-over instead of two a step:
//   out[0][i], out[1][i] = (walked row, steps)  on the rank owning r, if live
//                          (r, 0)               if r % intv == 0 and lo == 0
//                          (0, 0)               otherwise.
// lo is the block's first bucket row, per its length.  Bound: the latency of
// the longest local run (dependent loads of 24-byte bucket rows, as in
// sa_lookup_kernel); bytes: r read, out written, one bucket row a step.
template <bool kPow2>
__global__ void __launch_bounds__(128)
sa_walk_step_kernel(const int32_t* __restrict__ occ_local,
                    const int32_t* __restrict__ L2g,
                    const int32_t* __restrict__ r_in,
                    int32_t* __restrict__ out, int N, int n, int primary,
                    int intv, int lo, int per) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  int L2[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) L2[c] = __ldg(L2g + c);
  int r = __ldg(r_in + i);
  int steps = 0;
  // the LF map is one cycle through all n + 1 rows and row 0 is sampled,
  // so a walk ends within n + 1 steps; the cap only guards bad tables
  while ((kPow2 ? r & (intv - 1) : r % intv) != 0 && steps <= n) {
    if (r == primary) {
      if (lo != 0) break;
      r = 0;
    } else {
      const int j = max(r - (r > primary), 0);
      const int b = (j >> 5) - lo;
      if (b < 0 || b >= per) break;
      r = lf_from_row(reinterpret_cast<const int2*>(occ_local) + 3 * b, r, j,
                      n, L2);
    }
    ++steps;
  }
  const bool kept = steps > 0 || ((kPow2 ? r & (intv - 1) : r % intv) == 0
                                  && lo == 0);
  out[i] = kept ? r : 0;
  out[N + i] = steps;
}

}  // namespace

extern "C" int sa_walk_step_i32(const void* occ_local, const void* L2,
                                const void* r, void* out, int N, int n,
                                int primary, int intv, int lo, int per,
                                void* stream) {
  if (N == 0) return 0;
  const int threads = 128, blocks = (N + threads - 1) / threads;
  auto kernel = (intv & (intv - 1)) == 0 ? sa_walk_step_kernel<true>
                                         : sa_walk_step_kernel<false>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)occ_local, (const int32_t*)L2, (const int32_t*)r,
      (int32_t*)out, N, n, primary, intv, lo, per);
  return (int)cudaGetLastError();
}

extern "C" int sa_lookup_i32(const void* occ_rows, const void* sa_samp,
                             const void* L2, const void* rows, void* out,
                             int N, int n, int primary, int intv,
                             void* stream) {
  if (N == 0) return 0;
  const int threads = 128, blocks = (N + threads - 1) / threads;
  auto kernel = (intv & (intv - 1)) == 0 ? sa_lookup_kernel<true>
                                         : sa_lookup_kernel<false>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)occ_rows, (const int32_t*)sa_samp, (const int32_t*)L2,
      (const int32_t*)rows, (int32_t*)out, N, n, primary, intv);
  return (int)cudaGetLastError();
}
