// Shared-memory synchronisation helpers: mbarriers (also used by sm90.cuh's
// TMA pipelines) and the thread-block-cluster helpers of fps.cu (K2) and
// nn_distance.cu (K1): the CTA's rank in its cluster, the cluster barrier,
// distributed shared memory (DSMEM) addresses, stores and loads, and a
// cluster launch. Everything has internal linkage: each source that includes
// it is built into a library of its own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives (release: its earlier
// shared-memory writes, local and remote, become visible) and waits for all
// (acquire). Also a barrier of the CTA's own threads. The release / acquire
// pair costs a cluster-scope fence: ~0.4 µs on an H100.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p` (a shared-memory variable of this CTA)
// in the CTA of cluster rank `rank`.
__device__ __forceinline__ uint32_t dsmem_addr(const void* p, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  return remote;
}

// Stores 8 bytes into another CTA's shared memory and completes them as
// transaction bytes on the mbarrier `bar` of that CTA (both shared::cluster
// addresses): the receiver learns of the data from its own mbarrier, with no
// cluster-wide fence.
__device__ __forceinline__ void st_async_v2(uint32_t addr, uint32_t lo, uint32_t hi, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "r"(lo), "r"(hi), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t ld_cluster(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared::cluster.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// Launches `kernel` on a grid of `grid` CTAs of `threads` threads with
// `smem` bytes of dynamic shared memory, in clusters of `cluster` CTAs along
// x (no cluster attribute for 1). Clusters above 8 CTAs are non-portable and
// are allowed first. Returns the CUDA error code of the attribute calls or
// of the launch.
template <typename... Params, typename... Args>
int launch_clustered(void (*kernel)(Params...), dim3 grid, int threads, size_t smem, int cluster,
                     cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess && cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}

}  // namespace
