"""Latency of the steps of an FPS round on the card, in SM clock cycles a
step: the warp reductions and shuffles, a shared-memory load, a block barrier
and, across the CTAs of one thread-block cluster, barrier.cluster (release /
acquire and relaxed), a cluster-scope fence, and an exchange of 8-byte slots
by st.async completing each receiver's mbarrier. These are the numbers behind
the choice of K2's round barrier (``csrc/fps.cu``).

    python3 -m svdformer_pointsea_tpu_torch.bench_cluster_sync

Run from the root of a checkout, on a CUDA card with ``nvcc``. Each case is
one cluster of C CTAs looping 2048 times over a chain of dependent steps,
timed with ``clock64`` by thread 0 of rank 0; the source is built with the
port's nvcc flags into the build directory and includes ``csrc/cluster.cuh``.
"""

from __future__ import annotations

import os
import subprocess
import sys

from svdformer_pointsea_tpu_torch import kernels

SOURCE = r"""
#include <cstdio>
#include <cstdlib>

#include "cluster.cuh"

constexpr int kIters = 2048;

// A plain store into another CTA's shared memory (the barrier.cluster
// exchange that K2 does not use).
__device__ __forceinline__ void st_cluster_v2(uint32_t addr, uint32_t lo, uint32_t hi) {
  asm volatile("st.shared::cluster.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(lo), "r"(hi)
               : "memory");
}

template <int kOp>
__global__ void bench(unsigned* out) {
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ __align__(16) unsigned slot[2][64][2];
  __shared__ unsigned s[1024];
  const int C = gridDim.x;
  const unsigned rank = cluster_rank();
  const int lane = threadIdx.x & 31;
  unsigned v = threadIdx.x;
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) s[i] = (i * 7 + 1) & 1023;
  for (int i = threadIdx.x; i < 256; i += blockDim.x) (&slot[0][0][0])[i] = 0;
  if (threadIdx.x == 0) {
    mbar_init(smem_u32(&bar[0]), 1);
    mbar_init(smem_u32(&bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();
  const long long t0 = clock64();
  for (int i = 0; i < kIters; ++i) {
    const int par = i & 1;
    if (kOp == 0) v = __reduce_max_sync(0xffffffffu, v ^ i);
    if (kOp == 1) v = __shfl_xor_sync(0xffffffffu, v, 1) ^ i;
    if (kOp == 2) v = s[v & 1023];
    if (kOp == 3) { __syncthreads(); v += s[(v + i) & 1023]; }
    if (kOp == 4) cluster_sync();
    if (kOp == 5) {
      if (lane < C) st_cluster_v2(dsmem_addr(&slot[par][rank][0], lane), v, i);
      cluster_sync();
      v += slot[par][v % C][0];
    }
    if (kOp == 6) asm volatile("barrier.cluster.arrive.relaxed.aligned;\nbarrier.cluster.wait.aligned;" ::: "memory");
    if (kOp == 7) { asm volatile("fence.acq_rel.cluster;" ::: "memory"); v += s[v & 1023]; }
    if (kOp == 8) {
      if (threadIdx.x == 0) mbar_expect_tx(smem_u32(&bar[par]), C * 8);
      if ((int)threadIdx.x < C) {
        st_async_v2(dsmem_addr(&slot[par][rank][0], threadIdx.x), v, i,
                    dsmem_addr(&bar[par], threadIdx.x));
      }
      mbar_wait(smem_u32(&bar[par]), (i >> 1) & 1);
      v = slot[par][v % C][0];
    }
  }
  const long long t1 = clock64();
  cluster_sync();
  if (threadIdx.x == 0 && rank == 0) { out[0] = v; out[1] = (unsigned)((t1 - t0) / kIters); }
}

template <int kOp>
void run(const char* name, int cluster, int threads) {
  unsigned* d;
  cudaMalloc(&d, 16);
  cudaMemset(d, 0, 16);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cluster > 8) cudaFuncSetAttribute(bench<kOp>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaError_t err = cudaLaunchKernelEx(&cfg, bench<kOp>, d);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  unsigned h[2] = {0, 0};
  cudaMemcpy(h, d, 8, cudaMemcpyDeviceToHost);
  printf("%-52s C %2d, %4d threads: %5u cycles a step%s%s\n", name, cluster, threads, h[1],
         err ? ": " : "", err ? cudaGetErrorString(err) : "");
  cudaFree(d);
  if (err) exit(1);
}

int main() {
  run<0>("redux.sync max (a warp)", 1, 32);
  run<1>("shfl.sync (a warp)", 1, 32);
  run<2>("shared-memory load", 1, 32);
  for (int t : {128, 256, 1024}) run<3>("__syncthreads + shared-memory load", 1, t);
  for (int c : {1, 2, 4, 8, 16}) run<4>("barrier.cluster release / acquire", c, 128);
  for (int c : {2, 8, 16}) for (int t : {128, 256}) run<5>("st.shared::cluster slots + barrier.cluster", c, t);
  for (int c : {2, 8}) run<6>("barrier.cluster relaxed (orders no memory)", c, 128);
  run<7>("fence.acq_rel.cluster + shared-memory load", 8, 128);
  for (int c : {2, 4, 8, 16}) for (int t : {128, 256}) run<8>("st.async slots + mbarrier complete_tx + wait", c, t);
  return 0;
}
"""


def main() -> int:
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = kernels.BUILD_DIR / "bench_cluster_sync.cu"
    exe = kernels.BUILD_DIR / f"bench_cluster_sync-{os.getpid()}"
    src.write_text(SOURCE)
    flags = [f for f in kernels.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([kernels._nvcc(), *flags, "-I", str(kernels.CSRC), "-o", str(exe), str(src)],
                   check=True)
    try:
        res = subprocess.run([str(exe)], capture_output=True, text=True, timeout=120)
    finally:
        exe.unlink(missing_ok=True)
    sys.stdout.write(res.stdout)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip())
    return res.returncode


if __name__ == "__main__":
    sys.exit(main())
