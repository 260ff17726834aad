// Launching a thread-block cluster through the runtime (cudaLaunchKernelEx),
// shared by kernels 2, 3 and 6 (Kernel: the __global__ instance; `threads`
// a CTA, `smem` bytes of dynamic shared memory).
#pragma once

#include <cuda_runtime.h>

namespace {

// The function attributes of an instance, set once: dynamic shared memory
// up to the card's opt-in limit (less the instance's static shared
// memory), and clusters of 16 (beyond the portable 8).
template <auto Kernel>
cudaError_t prepare() {
  static const cudaError_t err = [] {
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, Kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(fa.sharedSizeBytes));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return err;
}

// groups * C CTAs of `threads` threads in clusters of C
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int groups, int C, int threads, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(groups * C);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// groups * C CTAs of Kernel in clusters of C, then cudaGetLastError
template <auto Kernel, typename... Args>
int launch_cluster(int groups, int C, int threads, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t e = prepare<Kernel>();
  if (e != cudaSuccess) return static_cast<int>(e);
  ClusterLaunch cl(groups, C, threads, smem, stream);
  e = cudaLaunchKernelEx(&cl.cfg, Kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// What a wrapper picks C from, for one instance: the clusters of C that
// can be resident at once with `smem` bytes a CTA, and the instance's
// registers and local memory a thread.
template <auto Kernel>
int query_cluster(int C, int threads, size_t smem, int* clusters, int* regs, int* local) {
  cudaError_t e = prepare<Kernel>();
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, Kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = fa.numRegs;
  *local = static_cast<int>(fa.localSizeBytes);
  ClusterLaunch cl(1, C, threads, smem, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, Kernel, &cl.cfg));
}

}  // namespace
