// Segmented running max of both steps' sources phase (Hopper, sm_90a).
//
// Replaces: no Pallas kernel.  It stands for the JAX step's
// _seg_running_max (uncalled_tpu/mapping/pooled.py:439-484), a two-level
// associative_scan (row-parallel scans over a [N / C, C] reshape plus a
// cross-row carry; a flat scan has no parallelism there), and for the
// classic step's associative_scan along each read's row
// (uncalled_tpu/mapping/engine.py:980-985).  The port had called one int64
// torch.cummax of (seg_id << 32 | vals + 2^31) instead, which PyTorch runs
// on one block for a 1-D input: one SM walking SC keys.
//
//   out[r, i] = max(vals[r, j] for j <= i with seg_id[r, j] == seg_id[r, i])
//
// over rows of a non-decreasing int32 seg_id and int32 vals; a row start
// is a segment boundary.  Pairs (s, m) compose by the JAX reference's
// _segmax, (sa, ma) o (sb, mb) = (sb, sa == sb ? max(ma, mb) : mb), which is
// associative on non-decreasing s; (any, INT32_MIN) on the left is its
// identity (max(INT32_MIN, m) == m).  Exact integer max.
//
// Bound on the card: bytes.  The two launches below read seg_id and vals
// twice and write out once, 20 B an element: 7.4 MB at SC = 368,640, 2.2 us
// at 3.35 TB/s, and L2-resident behind the sort that wrote them.  At that
// size two launches and the latency of a dependent chain bound it, not
// bandwidth.  Design: a tile of TILE = 2048 elements a block (256 threads,
// 8 consecutive elements each, loaded as two 16-byte vectors an array), so
// 180 tiles at SC = 368,640, all resident at once on 132 SMs.  A thread
// folds its 8 pairs, a warp scans its 32 thread aggregates with shuffles,
// the block its 8 warp totals.  Between tiles, reduce then scan: the first
// kernel writes each tile's aggregate; in the second, warp 0 folds the
// row's earlier aggregates (a contiguous chunk a lane, then a shuffle scan)
// into the tile's carry while the block scans its tile.  No waiting between
// blocks, no memset.  A one-pass decoupled look-back (an atomic tile
// counter, status flags zeroed by a memset) measured slower on the H100:
// 6.9 and 10.5 us at SC = 131,072 and 368,640 against 4.0 and 5.1 us for
// this scheme, and 16 elements a thread 5.1 and 5.6 us.
// No int64, no indices output, no host synchronisation.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;              // threads a block
constexpr int WARPS = NT / 32;
constexpr int ITEMS = 8;             // consecutive elements a thread
constexpr int TILE = NT * ITEMS;
constexpr int32_t NEG = INT32_MIN;

struct Pair {
  int32_t s, m;
};

__device__ __forceinline__ Pair op(Pair a, Pair b) {
  return {b.s, a.s == b.s ? max(a.m, b.m) : b.m};
}

__device__ __forceinline__ Pair shfl_up(Pair p, int d) {
  return {__shfl_up_sync(0xffffffffu, p.s, d),
          __shfl_up_sync(0xffffffffu, p.m, d)};
}

__device__ __forceinline__ Pair shfl(Pair p, int lane) {
  return {__shfl_sync(0xffffffffu, p.s, lane),
          __shfl_sync(0xffffffffu, p.m, lane)};
}

// A thread's ITEMS consecutive elements of a row from position i0: 16-byte
// loads where the row allows them, else one word at a time; positions past
// the row's end read (INT32_MAX, INT32_MIN), which only later positions see.
__device__ __forceinline__ void load(const int32_t* __restrict__ seg,
                                     const int32_t* __restrict__ val,
                                     int i0, int n, bool vec,
                                     int32_t (&s)[ITEMS], int32_t (&v)[ITEMS]) {
#pragma unroll
  for (int q = 0; q < ITEMS; q += 4) {
    const int i = i0 + q;
    if (vec && i + 3 < n) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(seg + i));
      const int4 b = __ldg(reinterpret_cast<const int4*>(val + i));
      s[q] = a.x; s[q + 1] = a.y; s[q + 2] = a.z; s[q + 3] = a.w;
      v[q] = b.x; v[q + 1] = b.y; v[q + 2] = b.z; v[q + 3] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = i + k < n;
        s[q + k] = in ? __ldg(seg + i + k) : INT32_MAX;
        v[q + k] = in ? __ldg(val + i + k) : NEG;
      }
    }
  }
}

__device__ __forceinline__ void store(int32_t* __restrict__ out, int i0,
                                      int n, bool vec,
                                      const int32_t (&o)[ITEMS]) {
#pragma unroll
  for (int q = 0; q < ITEMS; q += 4) {
    const int i = i0 + q;
    if (vec && i + 3 < n) {
      *reinterpret_cast<int4*>(out + i) =
          make_int4(o[q], o[q + 1], o[q + 2], o[q + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (i + k < n) out[i + k] = o[q + k];
    }
  }
}

// The block's scan of its threads' aggregates: each thread's exclusive
// prefix within the tile (threadIdx.x > 0) and the tile's aggregate.
__device__ __forceinline__ void block_scan(Pair agg, Pair* wtot, Pair& pre,
                                           Pair& tile) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Pair inc = agg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Pair o = shfl_up(inc, d);
    if (lane >= d) inc = op(o, inc);
  }
  if (lane == 31) wtot[warp] = inc;
  const Pair exl = shfl_up(inc, 1);
  __syncthreads();
  Pair wpre = {0, NEG};
  for (int w = 0; w < warp; ++w) wpre = op(wpre, wtot[w]);
  pre = lane ? op(wpre, exl) : wpre;
  tile = wpre;
  for (int w = warp; w < WARPS; ++w) tile = op(tile, wtot[w]);
}

// The fold of a[0], ..., a[n - 1] in order by one warp (n >= 1): a
// contiguous chunk a lane, then an inclusive shuffle scan over the lanes
// that hold one (a prefix of the warp); every lane gets the result.
__device__ __forceinline__ Pair warp_fold(const int2* a, int n, int lane) {
  const int chunk = (n + 31) / 32;
  const int b = lane * chunk, e = min(b + chunk, n);
  const bool has = b < e;
  Pair acc = {0, NEG};
  if (has) {
    const int2 x = a[b];
    acc = {x.x, x.y};
    for (int j = b + 1; j < e; ++j) {
      const int2 y = a[j];
      acc = op(acc, {y.x, y.y});
    }
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Pair o = shfl_up(acc, d);
    if (has && lane >= d) acc = op(o, acc);
  }
  return shfl(acc, (n + chunk - 1) / chunk - 1);
}

// The thread's ITEMS outputs from its carry in.
__device__ __forceinline__ void finish(Pair acc, const int32_t (&s)[ITEMS],
                                       const int32_t (&v)[ITEMS],
                                       int32_t (&o)[ITEMS]) {
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    acc = op(acc, {s[k], v[k]});
    o[k] = acc.m;
  }
}

__device__ __forceinline__ Pair fold(const int32_t (&s)[ITEMS],
                                     const int32_t (&v)[ITEMS]) {
  Pair a = {s[0], v[0]};
#pragma unroll
  for (int k = 1; k < ITEMS; ++k) a = op(a, {s[k], v[k]});
  return a;
}

// First kernel: each tile's aggregate.
__global__ void __launch_bounds__(NT)
tile_aggregates(const int32_t* __restrict__ seg,
                const int32_t* __restrict__ val, int2* __restrict__ agg,
                int n, bool vec) {
  __shared__ Pair wtot[WARPS];
  const size_t row = blockIdx.y;
  const int i0 = blockIdx.x * TILE + threadIdx.x * ITEMS;
  int32_t s[ITEMS], v[ITEMS];
  load(seg + row * n, val + row * n, i0, n, vec, s, v);
  Pair pre, tile;
  block_scan(fold(s, v), wtot, pre, tile);
  if (threadIdx.x == 0)
    agg[row * gridDim.x + blockIdx.x] = make_int2(tile.s, tile.m);
}

// Second kernel: the carry from the row's earlier aggregates, the scan.
__global__ void __launch_bounds__(NT)
tile_scan(const int32_t* __restrict__ seg, const int32_t* __restrict__ val,
          const int2* __restrict__ agg, int32_t* __restrict__ out, int n,
          bool vec) {
  __shared__ Pair wtot[WARPS];
  __shared__ Pair carry;
  const size_t row = blockIdx.y;
  const int t = blockIdx.x;
  const int i0 = t * TILE + threadIdx.x * ITEMS;
  int32_t s[ITEMS], v[ITEMS], o[ITEMS];
  load(seg + row * n, val + row * n, i0, n, vec, s, v);
  if (threadIdx.x < 32) {
    const Pair c = t ? warp_fold(agg + row * gridDim.x, t, threadIdx.x)
                     : Pair{0, NEG};
    if (threadIdx.x == 0) carry = c;
  }
  Pair pre, tile;
  block_scan(fold(s, v), wtot, pre, tile);  // syncs: carry is set
  const Pair acc = threadIdx.x ? op(carry, pre) : carry;
  finish(acc, s, v, o);
  store(out + row * n, i0, n, vec, o);
}

}  // namespace

// seg, vals, out: [rows, n] int32, contiguous; scratch: int32, at least
// 2 * rows * ceil(n / 2048) words (the tiles' aggregates); rows <= 65535.
extern "C" int seg_running_max_i32(const void* seg, const void* vals,
                                   void* out, void* scratch, int rows, int n,
                                   void* stream) {
  if (rows == 0 || n == 0) return 0;
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t* s = (const int32_t*)seg;
  const int32_t* v = (const int32_t*)vals;
  int32_t* o = (int32_t*)out;
  const bool vec = n % 4 == 0 && (uintptr_t)s % 16 == 0 &&
                   (uintptr_t)v % 16 == 0 && (uintptr_t)o % 16 == 0;
  const dim3 grid((n + TILE - 1) / TILE, rows);
  int2* agg = reinterpret_cast<int2*>(scratch);
  tile_aggregates<<<grid, NT, 0, st>>>(s, v, agg, n, vec);
  tile_scan<<<grid, NT, 0, st>>>(s, v, agg, o, n, vec);
  return (int)cudaGetLastError();
}
