// One bitonic merge level of the pooled candidate sort (Hopper, sm_90a).
//
// Replaces uncalled_tpu/ops/sortkern.py:_level_kernel (built by _build,
// called through merge_level from pooled._sort1d_bitonic):
//
//   for s = k_lv/2, k_lv/4, ..., C:          (every XOR pass of the level)
//     for every i with bit s clear, partner j = i | s:
//       asc  = (i & k_lv) == 0
//       swap = asc ? (key[j] < key[i]) : (key[i] < key[j])
//       if swap: exchange i and j in every key array
//
// over NK <= 8 int32 key arrays of length NP, compared lexicographically
// over the whole tuple.  Ties never swap, in either direction, so fully
// tied tuples (the INT32_MAX padding) stay where they are.  The keys are
// sorted in place: the wrapper hands over its own copy.
//
// Bound on the card: device memory.  A level reads and writes every key
// once at least (2 * NK * NP * 4 bytes: 5.24 MB at NK = 5, NP = 131072);
// the compares are a few integer operations per element per pass.  The
// TPU kernel held a whole k_lv chunk in VMEM and ran every pass there.  A
// chunk does not fit in a block's shared memory here (k_lv = 16384 at
// NK = 5 is 320 KB), so the level is split:
//
//   * one global launch per stride s > TILE/2, one thread per pair, keys
//     read and written in device memory (coalesced: neighbouring threads
//     take neighbouring i);
//   * one tiled launch for the strides TILE/2 ... C: a block loads TILE
//     contiguous elements of every key into dynamic shared memory
//     (TILE = 4096: 80 KB at NK = 5), runs those passes there with a
//     barrier between passes, and writes the tile back once.
//
// Pairs of one pass are independent and the passes run in the same order
// as the TPU kernel's, so the split cannot change a bit.  The global
// passes cost one device-memory round trip each; fusing several strides
// per launch is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_NK = 8;
constexpr int TILE = 4096;
constexpr int THREADS = 256;

struct Keys {
  int32_t* k[MAX_NK];
};

// swap decision for the pair (a at i, b at i|s) of a chunk of direction
// asc: the first key that differs decides; a full tie never swaps.  The
// loop runs to MAX_NK so that a[] and b[] stay in registers.
__device__ __forceinline__ bool want_swap(const int32_t (&a)[MAX_NK],
                                          const int32_t (&b)[MAX_NK], int nk,
                                          bool asc) {
  bool decided = false, swap = false;
#pragma unroll
  for (int q = 0; q < MAX_NK; ++q) {
    if (q < nk && !decided && a[q] != b[q]) {
      decided = true;
      bool lt = a[q] < b[q];
      swap = asc ? !lt : lt;
    }
  }
  return swap;
}

__global__ void merge_pass_global(Keys keys, int nk, int half, int s,
                                  int k_lv) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= half) return;
  int i = ((p / s) * 2 * s) + (p % s);
  int j = i + s;
  bool asc = (i & k_lv) == 0;
  int32_t a[MAX_NK], b[MAX_NK];
#pragma unroll
  for (int q = 0; q < MAX_NK; ++q) {
    if (q < nk) {
      a[q] = keys.k[q][i];
      b[q] = keys.k[q][j];
    }
  }
  if (want_swap(a, b, nk, asc)) {
#pragma unroll
    for (int q = 0; q < MAX_NK; ++q) {
      if (q < nk) {
        keys.k[q][i] = b[q];
        keys.k[q][j] = a[q];
      }
    }
  }
}

__global__ void merge_passes_tile(Keys keys, int nk, int tile, int s_hi,
                                  int C, int k_lv) {
  extern __shared__ int32_t sm[];  // [nk][tile]
  long long base = (long long)blockIdx.x * tile;
#pragma unroll
  for (int q = 0; q < MAX_NK; ++q) {
    if (q < nk) {
      for (int t = threadIdx.x; t < tile; t += blockDim.x) {
        sm[q * tile + t] = keys.k[q][base + t];
      }
    }
  }
  __syncthreads();
  // direction is constant over a tile: tile <= k_lv, tiles are aligned
  bool asc = ((base & (long long)k_lv) == 0);
  for (int s = s_hi; s >= C; s >>= 1) {
    for (int p = threadIdx.x; p < tile / 2; p += blockDim.x) {
      int i = ((p / s) * 2 * s) + (p % s);
      int j = i + s;
      int32_t a[MAX_NK], b[MAX_NK];
#pragma unroll
      for (int q = 0; q < MAX_NK; ++q) {
        if (q < nk) {
          a[q] = sm[q * tile + i];
          b[q] = sm[q * tile + j];
        }
      }
      if (want_swap(a, b, nk, asc)) {
#pragma unroll
        for (int q = 0; q < MAX_NK; ++q) {
          if (q < nk) {
            sm[q * tile + i] = b[q];
            sm[q * tile + j] = a[q];
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < MAX_NK; ++q) {
    if (q < nk) {
      for (int t = threadIdx.x; t < tile; t += blockDim.x) {
        keys.k[q][base + t] = sm[q * tile + t];
      }
    }
  }
}

}  // namespace

// Runs every stride >= C pass of merge level k_lv over the nk key arrays
// (pointers in `ptrs`), in place.  Needs k_lv and C powers of two,
// NP % k_lv == 0, k_lv % (2C) == 0 and nk <= 8 (the wrapper checks).  The
// tile is min(TILE, k_lv) elements, so it divides NP and lies inside one
// chunk of the level (one direction).  Returns the first CUDA
// error of any launch, 0 when every launch was accepted.
extern "C" int merge_level_i32(void** ptrs, int nk, int NP, int k_lv, int C,
                               void* stream) {
  if (nk < 1 || nk > MAX_NK) return (int)cudaErrorInvalidValue;
  Keys keys;
  for (int q = 0; q < MAX_NK; ++q) {
    keys.k[q] = q < nk ? (int32_t*)ptrs[q] : nullptr;
  }
  cudaStream_t st = (cudaStream_t)stream;
  int half = NP / 2;
  int blocks = (half + THREADS - 1) / THREADS;
  int tile = k_lv < TILE ? k_lv : TILE;
  int s = k_lv / 2;
  // strides whose pairs span more than one tile: device-memory passes
  for (; s >= C && 2 * s > tile; s >>= 1) {
    merge_pass_global<<<blocks, THREADS, 0, st>>>(keys, nk, half, s, k_lv);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (s >= C) {
    // the rest of the level inside tiles of TILE contiguous elements
    int smem = nk * tile * (int)sizeof(int32_t);
    cudaError_t e = cudaFuncSetAttribute(
        merge_passes_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    merge_passes_tile<<<NP / tile, THREADS * 2, smem, st>>>(keys, nk, tile,
                                                             s, C, k_lv);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
