// Ring assembly of the pooled step (Hopper, sm_90a).
//
// Replaces uncalled_tpu/ops/stepkern.py:_ring_kernel (built by _build_ring,
// called through ring_assemble from the pooled step's assembly stage):
//
//   new[i, j] = keep[i] ? (j == rslot[i] ? rval[i]
//                                        : (rsrc[i] >= 0 ? old[rsrc[i], j] : 0))
//                       : 0
//
// over the RING (= seed_len + 1 <= 32) cumulative-sum ring of each of the
// S pool slots.  Values move as their 32-bit patterns (int32 views of the
// f32 rings), so NaN payloads and -0.0 survive exactly.
//
// Bound on the card: device memory — one [S, RING] ring read (rows in a
// data-dependent order) and one written, no arithmetic.  The TPU kernel
// kept the table in VMEM and unrolled scalar row copies to hide its
// per-index gather cost.  Here the threads map onto the flat [S * RING]
// output, four consecutive words each, written as one 16-byte store (the
// wrapper allocates the output to a multiple of four words, so the last
// thread's store stays inside it): every lane of every warp carries
// output and the stores fill whole sectors.  A thread's four words span
// at most two slots when RING >= 4; it issues the side loads (keep, rsrc,
// rslot, rval) of all four words together, then the four row loads, so
// its chain is two loads deep.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void ring_assemble_kernel(const int32_t* __restrict__ old_ring,
                                     const int32_t* __restrict__ rsrc,
                                     const int32_t* __restrict__ rslot,
                                     const int32_t* __restrict__ rval,
                                     const uint8_t* __restrict__ keep,
                                     int32_t* __restrict__ out, int S,
                                     int RING) {
  const int total = S * RING;
  const int f0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (f0 >= total) return;
  // slot and lane of each word; words past the end (the allocation's
  // padding) repeat the last word
  int slot[4], lane[4];
  int i = f0 / RING, j = f0 - i * RING;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    bool in = f0 + w < total;
    slot[w] = in ? i : S - 1;
    lane[w] = in ? j : RING - 1;
    if (++j == RING) {
      j = 0;
      ++i;
    }
  }
  uint8_t kp[4];
  int src[4], rs[4], rv[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    kp[w] = __ldg(keep + slot[w]);
    src[w] = __ldg(rsrc + slot[w]);
    rs[w] = __ldg(rslot + slot[w]);
    rv[w] = __ldg(rval + slot[w]);
  }
  int o[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    int s = src[w] > S - 1 ? S - 1 : src[w];
    bool row = kp[w] && lane[w] != rs[w] && s >= 0;
    int x = 0;
    if (row) x = __ldg(old_ring + (long long)s * RING + lane[w]);
    o[w] = kp[w] ? (lane[w] == rs[w] ? rv[w] : x) : 0;
  }
  *reinterpret_cast<int4*>(out + f0) = make_int4(o[0], o[1], o[2], o[3]);
}

// `out` holds S * RING words rounded up to a multiple of four, 16-byte
// aligned; S * RING < 2^31.
extern "C" int ring_assemble_i32(const void* old_ring, const void* rsrc,
                                 const void* rslot, const void* rval,
                                 const void* keep, void* out, int S, int RING,
                                 void* stream) {
  if (S == 0) return 0;
  const int threads = 256;
  long long quads = ((long long)S * RING + 3) / 4;
  int blocks = (int)((quads + threads - 1) / threads);
  ring_assemble_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)old_ring, (const int32_t*)rsrc, (const int32_t*)rslot,
      (const int32_t*)rval, (const uint8_t*)keep, (int32_t*)out, S, RING);
  return (int)cudaGetLastError();
}
