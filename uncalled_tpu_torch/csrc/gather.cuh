// Column-descriptor gather shared by flat_gather.cu and row_gather.cu
// (Hopper, sm_90a).
//
//   out[f, b, k] = col_f[b, clamp(idx[b, k], 0, N-1)]        f < F <= 16
//
// A column is 1 to 5 segments laid end to end; the segment bounds are
// shared by every column of the call.  A segment is either a strided view
// (base pointer, batch stride, element stride, 1-byte bool or 32-bit
// payload) or a 32-bit constant.  So a gather reads the fields where they
// lie: a packed table's field is a view with element stride F, a shared
// table a view with batch stride 0, a ring column a view with the ring's
// strides, a fill a constant.  Nothing is packed before the call.
//
// Bound on the card: bytes, and for scattered reads the L2's latency.
// Each thread takes one (b, k): it reads the index once, finds its
// segment (at most four compares against the bounds), issues every
// field's load before any store -- one 16-byte load for four 32-bit fields
// that sit side by side in a 16-byte aligned row, else one load a field,
// all through the read-only path -- and writes the fields-major [F, B, K]
// output, which coalesces across the warp.  Each gathered row is read by
// one thread (once, not once per field), and F independent loads per
// thread keep the memory system busy.  The descriptor travels by value as
// a __grid_constant__ kernel parameter (about 2.6 KB): no device table,
// no copy before the launch.  A call with one segment (every packed-table
// call) takes the kernel instance that never indexes the segments.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define GC_MAX_COLS 16
#define GC_MAX_SEGS 5
#define GC_THREADS 256

// kind of a segment: what a thread loads for it
enum { GC_CONST = 0, GC_BOOL = 1, GC_WORD = 4, GC_VEC4 = 16 };

struct GcSeg {
  const char* base;   // the segment's element (0, 0); null for a constant
  long long bstride;  // bytes from one batch row to the next (0: shared)
  long long estride;  // bytes from one element to the next
  int kind;           // GC_CONST, GC_BOOL, GC_WORD, or GC_VEC4: this
                      // column and the next three as one 16-byte load
  int konst;          // a constant's 32 bits
};

struct GcDesc {
  GcSeg seg[GC_MAX_SEGS][GC_MAX_COLS];
  int bound[GC_MAX_SEGS + 1];  // segment s holds rows [bound[s], bound[s+1])
  int F, nseg, B, K;
  const int32_t* idx;  // [B, K]
  int32_t* out;        // [F, B, K]
};

__device__ __forceinline__ int32_t gc_load(const GcSeg& g, int b, int r) {
  if (g.kind == GC_CONST) return g.konst;
  const char* p = g.base + b * g.bstride + r * g.estride;
  if (g.kind == GC_BOOL) {
    return __ldg(reinterpret_cast<const unsigned char*>(p)) != 0;
  }
  return __ldg(reinterpret_cast<const int32_t*>(p));
}

template <bool MULTI>
__global__ void __launch_bounds__(GC_THREADS)
    gather_cols_kernel(const __grid_constant__ GcDesc d) {
  const int k = blockIdx.x * GC_THREADS + threadIdx.x;
  if (k >= d.K) return;
  const int b = blockIdx.y;
  const long long bk = (long long)b * d.K + k;
  const int n = d.bound[d.nseg];
  int i = __ldg(d.idx + bk);
  i = i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
  int s = 0, r = i;
  if (MULTI) {
#pragma unroll
    for (int j = 1; j < GC_MAX_SEGS; ++j) {
      if (j < d.nseg && i >= d.bound[j]) {
        s = j;
        r = i - d.bound[j];
      }
    }
  }
  int32_t v[GC_MAX_COLS];
#pragma unroll
  for (int f = 0; f < GC_MAX_COLS; f += 4) {
    if (f < d.F) {
      const GcSeg& g = d.seg[s][f];
      if (g.kind == GC_VEC4) {
        const int4 q = __ldg(reinterpret_cast<const int4*>(
            g.base + b * g.bstride + r * g.estride));
        v[f] = q.x;
        v[f + 1] = q.y;
        v[f + 2] = q.z;
        v[f + 3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (f + j < d.F) v[f + j] = gc_load(d.seg[s][f + j], b, r);
        }
      }
    }
  }
  const long long plane = (long long)d.B * d.K;
#pragma unroll
  for (int f = 0; f < GC_MAX_COLS; ++f) {
    if (f < d.F) d.out[f * plane + bk] = v[f];
  }
}

// The C launcher's body.  meta (int64): F, nseg, B, K, the nseg + 1
// bounds, then five entries per (s, f), segment major: device pointer (0
// for a constant), batch stride and element stride in bytes, kind,
// constant.  A GC_VEC4 segment must be 16-byte aligned in base and
// strides and head four GC_WORD columns of one row; anything else the
// kernel does not take returns cudaErrorInvalidValue before a launch.
static int gather_cols_launch(const long long* meta, const void* idx,
                              void* out, void* stream) {
  GcDesc d;
  memset(&d, 0, sizeof d);
  d.F = (int)meta[0];
  d.nseg = (int)meta[1];
  d.B = (int)meta[2];
  d.K = (int)meta[3];
  if (d.F < 1 || d.F > GC_MAX_COLS || d.nseg < 1 || d.nseg > GC_MAX_SEGS ||
      d.B < 0 || d.B > 65535 || d.K < 0) {
    return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s <= d.nseg; ++s) d.bound[s] = (int)meta[4 + s];
  if (d.bound[0] != 0 || d.bound[d.nseg] < 1) return (int)cudaErrorInvalidValue;
  const long long* m = meta + 5 + d.nseg;
  for (int s = 0; s < d.nseg; ++s) {
    if (d.bound[s + 1] < d.bound[s]) return (int)cudaErrorInvalidValue;
    for (int f = 0; f < d.F; ++f, m += 5) {
      GcSeg& g = d.seg[s][f];
      g.base = (const char*)(uintptr_t)m[0];
      g.bstride = m[1];
      g.estride = m[2];
      g.kind = (int)m[3];
      g.konst = (int)m[4];
      const bool ok = g.kind == GC_CONST ||
                      ((g.kind == GC_BOOL || g.kind == GC_WORD ||
                        g.kind == GC_VEC4) && g.base != nullptr);
      if (!ok) return (int)cudaErrorInvalidValue;
    }
    for (int f = 0; f < d.F; ++f) {
      const GcSeg& g = d.seg[s][f];
      if (g.kind != GC_VEC4) continue;
      bool ok = f % 4 == 0 && f + 4 <= d.F &&
                ((uintptr_t)g.base | (uintptr_t)g.bstride |
                 (uintptr_t)g.estride) % 16 == 0;
      for (int j = 1; ok && j < 4; ++j) {
        const GcSeg& h = d.seg[s][f + j];
        ok = h.kind == GC_WORD && h.base == g.base + 4 * j &&
             h.bstride == g.bstride && h.estride == g.estride;
      }
      if (!ok) return (int)cudaErrorInvalidValue;
    }
  }
  d.idx = (const int32_t*)idx;
  d.out = (int32_t*)out;
  if (d.B == 0 || d.K == 0) return 0;
  const dim3 grid((unsigned)((d.K + GC_THREADS - 1) / GC_THREADS),
                  (unsigned)d.B);
  if (d.nseg > 1) {
    gather_cols_kernel<true><<<grid, GC_THREADS, 0, (cudaStream_t)stream>>>(d);
  } else {
    gather_cols_kernel<false><<<grid, GC_THREADS, 0, (cudaStream_t)stream>>>(d);
  }
  return (int)cudaGetLastError();
}
