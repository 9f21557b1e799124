// Measurement probes for chip_smoke.py (Hopper, sm_90a).  Not kernels of
// the port: no wrapper of the mapper calls them.
//
//   probe_empty  an empty kernel: a plain launch (grid_sync 0), a
//                cooperative launch (2), or a cooperative launch that only
//                crosses one grid barrier (1): the device time of a launch
//                that does nothing, the practical floor of a short kernel
//   probe_chase  one thread follows nxt[] for a number of steps: the latency
//                of one dependent load, for the chain bound of a walk

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

__global__ void empty_kernel() {}

__global__ void grid_barrier_kernel() { cg::this_grid().sync(); }

__global__ void chase_kernel(const int32_t* __restrict__ nxt, int steps,
                             int32_t* __restrict__ out) {
  int j = 0;
  for (int s = 0; s < steps; ++s) j = nxt[j];
  out[0] = j;
}

}  // namespace

extern "C" int probe_empty(int blocks, int threads, int grid_sync,
                           void* stream) {
  if (!grid_sync) {
    empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  } else {
    void* no_args[1] = {nullptr};
    cudaError_t e = cudaLaunchCooperativeKernel(
        grid_sync == 1 ? (const void*)grid_barrier_kernel
                       : (const void*)empty_kernel,
        dim3(blocks), dim3(threads), no_args, 0, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

extern "C" int probe_chase(const void* nxt, int steps, void* out,
                           void* stream) {
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((const int32_t*)nxt, steps,
                                                  (int32_t*)out);
  return (int)cudaGetLastError();
}
