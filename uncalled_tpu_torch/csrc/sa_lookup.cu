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
// Bound on the card: the latency of the longest walk.  Its steps form one
// dependent chain, and the walk's length is unbounded by intv (the SA is
// sampled by row, not by text position: 473 steps on a 4.7 Mb genome).  A
// step is one load of a 24-byte bucket row (occ_rows[j >> 5], ~7 MB for a
// 4.7 Mb genome, in the 50 MB L2 once warm: ~143 ns a dependent load) plus
// the arithmetic between that load's return and the next load's issue.
// One thread walks one row in registers (walks of different rows overlap
// across the warps of an SM), and the design keeps that arithmetic short:
//
//  - For r != primary the base's BWT index and _occ's index are the same
//    row j = r - (r > primary) = r - (r >= primary), so one bucket row
//    (three 8-byte loads in flight together) serves both.  LF(primary) = 0
//    and r == n (_occ's full count: LF = L2[c] + L2[c + 1] - L2[c] =
//    L2[c + 1]) are selects, not branches.  The address takes j = r - (r >=
//    primary), which for 1 <= primary <= n (the wrapper checks it) lies in
//    [0, n - 1] for every row, so a load for any row is in the table.
//  - The next row's loads are issued as soon as its address is known; then,
//    while they are in flight, what needs r alone (lf_pre): the mask of the
//    bucket's bases 0 ... j & 31, the bit that holds base j & 31, each
//    base's addend (L2[c], plus (j & 31) + 1 for base 0; for r == n and the
//    primary row the LF itself, with the mask 0), and the exit test (r %
//    intv, the step cap).  All of it sits before the loop's branch, so the
//    in-order issue reaches it before it stalls on the row.
//  - After the row arrives (lf_post): the two words interleaved into x (each
//    base's low bit) and y (its high bit), one shift and one LOP3 each;
//    three popcounts under the mask give all four counts (1: x & ~y, 1 + 2:
//    x ^ y, 3: x & y, and 0: the rest); the four candidate LF values are
//    added while the base's two bits are read; two levels of selects pick
//    one; then the next address (j, j >> 5, its row).  L2 stays in five
//    registers (no local memory).
//
// sa_walk_step_kernel below runs the same step over a row-sharded occ_rows,
// as far as each rank's block reaches (the sharded engines,
// uncalled_tpu_torch/parallel/sharded.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kEven = 0x55555555u;
// threads a block, each the fastest of 128, 64 and 32 on the card: the
// lookup's 6144 rows at 128, the walk step's 3072 at 32 (96 blocks)
constexpr int kLookupThreads = 128;
constexpr int kWalkThreads = 32;

// (a & kEven) | (b & ~kEven) in one LOP3 (the compiler's own form of it
// took two)
__device__ __forceinline__ unsigned even_odd(unsigned a, unsigned b) {
  unsigned d;
  asm("lop3.b32 %0, %1, %2, %3, 0xE2;" : "=r"(d) : "r"(a), "r"(kEven),
      "r"(b));
  return d;
}

// The part of the step at row r that needs only r (and j = r - (r >=
// primary), its bucket row's BWT index): computed while the row loads.
struct LfPre {
  unsigned mask;  // bases 0 ... j & 31 in the x / y layout; 0 if fixed
  unsigned bit;   // the low bit of base j & 31 in x, its high bit in y
  int keep;       // ~0, or 0 if fixed (masks the checkpoints)
  int add0, add1, add2, add3;  // each base's addend, or its fixed LF
};

__device__ __forceinline__ LfPre lf_pre(int r, int j, int n, int primary,
                                        const int (&L2)[5]) {
  const int pos = j & 31;
  // the bucket's first pos + 1 bases of its two words (MSB first)
  const unsigned long long pm = ~0ull << (62 - 2 * pos);
  const unsigned pm0 = (unsigned)(pm >> 32), pm1 = (unsigned)pm;
  const bool prim = r == primary;
  const bool fixed = prim || r >= n;
  LfPre p;
  p.mask = fixed ? 0u : (pm0 & kEven) | (pm1 & ~kEven);
  p.bit = 1u << (pos < 16 ? 30 - 2 * pos : 63 - 2 * pos);
  p.keep = fixed ? 0 : -1;
  p.add0 = fixed ? (prim ? 0 : L2[1]) : L2[0] + pos + 1;
  p.add1 = fixed ? (prim ? 0 : L2[2]) : L2[1];
  p.add2 = fixed ? (prim ? 0 : L2[3]) : L2[2];
  p.add3 = fixed ? (prim ? 0 : L2[4]) : L2[3];
  return p;
}

// LF(r) from its bucket row (ck01, ck23: the checkpoints of bases 0-3;
// w01: the bucket's 32 bases, 2 bits each, MSB first, 16 a word).
__device__ __forceinline__ int lf_post(const LfPre& p, int2 ck01, int2 ck23,
                                       int2 w01) {
  const unsigned w0 = (unsigned)w01.x, w1 = (unsigned)w01.y;
  // x: word 0's low bits on the even bits, word 1's on the odd; y: the high
  // bits, laid out the same
  const unsigned x = even_odd(w0, w1 << 1);
  const unsigned y = even_odd(w0 >> 1, w1);
  const unsigned n1 = __popc(x & ~y & p.mask);
  const unsigned n12 = __popc((x ^ y) & p.mask);
  const unsigned n3 = __popc(x & y & p.mask);
  const unsigned v0 = p.add0 + (ck01.x & p.keep) - n12 - n3;
  const unsigned v1 = p.add1 + (ck01.y & p.keep) + n1;
  const unsigned v2 = p.add2 + (ck23.x & p.keep) + n12 - n1;
  const unsigned v3 = p.add3 + (ck23.y & p.keep) + n3;
  const bool lo = x & p.bit, hi = y & p.bit;
  return (int)(hi ? (lo ? v3 : v2) : (lo ? v1 : v0));
}

struct Row {
  int2 ck01, ck23, w01;
};

// bucket row b of the table (three 8-byte loads in flight together)
__device__ __forceinline__ Row load_row(const int2* occ, unsigned b) {
  const int2* row = occ + 3 * b;
  return Row{__ldg(row), __ldg(row + 1), __ldg(row + 2)};
}

__device__ __forceinline__ void load_l2(const int32_t* L2g, int (&L2)[5]) {
#pragma unroll
  for (int c = 0; c < 5; ++c) L2[c] = __ldg(L2g + c);
}

// kPow2: intv is a power of two (the default 32), so the exit test and the
// sample index are a mask and a shift instead of an integer division
template <bool kPow2>
__device__ __forceinline__ bool live(int r, int intv) {
  return (kPow2 ? r & (intv - 1) : r % intv) != 0;
}

template <bool kPow2>
__global__ void __launch_bounds__(kLookupThreads)
sa_lookup_kernel(const int32_t* __restrict__ occ_rows,
                 const int32_t* __restrict__ sa_samp,
                 const int32_t* __restrict__ L2g,
                 const int32_t* __restrict__ rows, int32_t* __restrict__ out,
                 int N, int n, int primary, int intv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  int L2[5];
  load_l2(L2g, L2);
  const int2* occ = reinterpret_cast<const int2*>(occ_rows);
  // callers clamp rows to [0, n]; the clamp here only keeps loads in bounds
  int r = min(max(__ldg(rows + i), 0), n);
  int steps = 0;
  if (live<kPow2>(r, intv)) {  // so r >= 1 and n >= 1
    int j = r - (r >= primary);
    Row row = load_row(occ, (unsigned)j >> 5);
    LfPre p = lf_pre(r, j, n, primary, L2);
    // the LF map is one cycle through all n + 1 rows and row 0 is sampled,
    // so a walk ends within n + 1 steps; the cap only guards bad tables
    for (;;) {
      r = lf_post(p, row.ck01, row.ck23, row.w01);
      ++steps;
      j = r - (r >= primary);
      row = load_row(occ, (unsigned)j >> 5);
      p = lf_pre(r, j, n, primary, L2);
      if (!live<kPow2>(r, intv) || steps > n) break;
    }
  }
  const int shift = __ffs(intv) - 1;
  out[i] = __ldg(sa_samp + (kPow2 ? r >> shift : r / intv)) + steps;
}

// The steps of the walk that one rank can take on its block of a
// row-sharded occ_rows, for every row.
// Replaces: no Pallas kernel.  The JAX while_loop of
// uncalled_tpu/mapping/engine.py:338-381 as it runs under shard_map, where
// each iteration's base read and _occ each take a bucket row through
// _shard_take (two psums a step).  For r != primary the two reads are the
// same bucket row (see above), so the rank that owns bucket j >> 5
// computes LF(r) alone; the primary row (LF = 0) belongs to the block with
// lo = 0.  The owner of a live row steps it on while it stays live and owned
// and reports (row, steps taken); the other ranks report (0, 0), so a sum
// over the idx ranks gives every rank each row's walk up to its first row
// in another block, one collective a hand-over instead of two a step:
//   out[0][i], out[1][i] = (walked row, steps)  on the rank owning r, if live
//                          (r, 0)               if r % intv == 0 and lo == 0
//                          (0, 0)               otherwise.
// lo is the block's first bucket row, per its length.  Bound: the latency of
// the longest local run (the step of sa_lookup_kernel, whose loads are
// clamped into the block); bytes: r read, out written, one bucket row a
// step.  A row that is resolved or not owned makes no load.
template <bool kPow2>
__global__ void __launch_bounds__(kWalkThreads)
sa_walk_step_kernel(const int32_t* __restrict__ occ_local,
                    const int32_t* __restrict__ L2g,
                    const int32_t* __restrict__ r_in,
                    int32_t* __restrict__ out, int N, int n, int primary,
                    int intv, int lo, int per) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int2* occ = reinterpret_cast<const int2*>(occ_local);
  int r = __ldg(r_in + i);
  int steps = 0;
  // r's bucket row in the block (b < per), clamped into it; the primary row
  // is owned by block 0 (if it holds any row) and needs no data
  const bool home = lo == 0 && per > 0;
  int j = r - (r >= primary);
  unsigned b = (unsigned)((j >> 5) - lo);
  bool own = r == primary ? home : b < (unsigned)per;
  if (live<kPow2>(r, intv) && own) {
    int L2[5];
    load_l2(L2g, L2);
    Row row = load_row(occ, min(b, (unsigned)per - 1));
    LfPre p = lf_pre(r, j, n, primary, L2);
    // the LF map is one cycle through all n + 1 rows and row 0 is sampled,
    // so a walk ends within n + 1 steps; the cap only guards bad tables
    for (;;) {
      r = lf_post(p, row.ck01, row.ck23, row.w01);
      ++steps;
      j = r - (r >= primary);
      b = (unsigned)((j >> 5) - lo);
      row = load_row(occ, min(b, (unsigned)per - 1));
      p = lf_pre(r, j, n, primary, L2);
      own = r == primary ? home : b < (unsigned)per;
      if (!live<kPow2>(r, intv) || !own || steps > n) break;
    }
  }
  const bool kept = steps > 0 || (!live<kPow2>(r, intv) && lo == 0);
  out[i] = kept ? r : 0;
  out[N + i] = steps;
}

}  // namespace

extern "C" int sa_walk_step_i32(const void* occ_local, const void* L2,
                                const void* r, void* out, int N, int n,
                                int primary, int intv, int lo, int per,
                                void* stream) {
  if (N == 0) return 0;
  const int blocks = (N + kWalkThreads - 1) / kWalkThreads;
  auto kernel = (intv & (intv - 1)) == 0 ? sa_walk_step_kernel<true>
                                         : sa_walk_step_kernel<false>;
  kernel<<<blocks, kWalkThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)occ_local, (const int32_t*)L2, (const int32_t*)r,
      (int32_t*)out, N, n, primary, intv, lo, per);
  return (int)cudaGetLastError();
}

extern "C" int sa_lookup_i32(const void* occ_rows, const void* sa_samp,
                             const void* L2, const void* rows, void* out,
                             int N, int n, int primary, int intv,
                             void* stream) {
  if (N == 0) return 0;
  const int blocks = (N + kLookupThreads - 1) / kLookupThreads;
  auto kernel = (intv & (intv - 1)) == 0 ? sa_lookup_kernel<true>
                                         : sa_lookup_kernel<false>;
  kernel<<<blocks, kLookupThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)occ_rows, (const int32_t*)sa_samp, (const int32_t*)L2,
      (const int32_t*)rows, (int32_t*)out, N, n, primary, intv);
  return (int)cudaGetLastError();
}
