// Furthest point sampling (kernel K2) on thread-block clusters.
//
// Replaces: svdformer_pointsea_tpu/ops/fps.py::_fps_kernel (the Pallas TPU
// kernel behind _fps_pallas / furthest_point_sample). On the evaluation path
// it picks 512 of 2048 (SA1, LocalEncoder), 128 of 512 (SA2) and 512 of 2304
// (the merge); the loss pyramid of the training slice picks 2048 of 16384 and
// 256 of 2048.
//
// Semantics (held index for index against ops/fps.py::furthest_point_sample_ref
// of this package on the same card):
//   - the first pick is index 0;
//   - every round updates each point's running min squared distance to the
//     picked set, d = (dx*dx + dy*dy) + dz*dz with every operation rounded on
//     its own (__fsub_rn / __fmul_rn / __fadd_rn: a contracted FMA would
//     differ from PyTorch's elementwise ops in the last bit, and one flipped
//     pick changes every later pick);
//   - the next pick is the first-occurrence argmax of that distance;
//   - points with |p|^2 <= 1e-3 are never picked; when no point is valid the
//     pick falls back to index 0.
//
// What bounds it on an H100: the latency of a round. `npoint - 1` rounds run
// one after the other, and each ends in a reduction over the whole sample
// before the next can start; the arithmetic of a round (8 FP32 operations a
// point) is small beside it. The kernel before this design ran one block of
// up to 1024 threads per sample (12 of 132 SMs busy at B 12) and ended each
// round in two shuffle reductions of 5 dependent steps and two barriers.
//
// Design: one cluster of C CTAs per sample (C from ops/fps.py::fps_launch_plan;
// C = 1 is an ordinary block). Every CTA copies the whole cloud into shared
// memory (12 B a point, 192 KB at N 16384), and CTA r owns the contiguous
// points [r * chunk, (r + 1) * chunk), keeping their coordinates and running
// min-distances in registers (PPT = 4 or 16 a thread, interleaved by thread),
// so a round reads no memory for the distance update. A round:
//   1. each thread updates its PPT distances and takes its best (larger value
//      wins, equal values go to the lower index) in a pairwise tree;
//   2. each warp reduces with two redux.sync: the max of an order-preserving
//      uint key of the value (flip every bit of a negative float, set the sign
//      bit of a non-negative one: invalid points' -1 and empty slots' -2 stay
//      below every distance), then the max of ~index (the min index) among
//      the lanes that hold it;
//   3. the warp publishes (key, ~index), 8 bytes, into slot (rank, warp) of
//      every CTA of the cluster: lane r stores into CTA r through distributed
//      shared memory;
//   4. the round's one barrier, a cluster barrier built from mbarriers: the
//      slot stores are st.async, which complete transaction bytes on the
//      receiving CTA's mbarrier of that round's parity; each CTA expects
//      C x W slots a round and waits on its own mbarrier, so no CTA passes
//      round j before every CTA of the cluster has published round j
//      (C = 1: lane 0's store and __syncthreads);
//   5. every warp reduces the C x W slots itself (two redux.sync again): the
//      pick, whose coordinates every CTA holds; rank 0 writes its index.
// Only the winner's index travels. The slots and mbarriers are
// double-buffered by round parity: round j + 2 cannot overwrite a slot that
// a slower warp still reads in round j, because every CTA must first have
// received all of round j + 1's slots, which each warp sends after reading
// round j's. Why not barrier.cluster: its arrive.release / wait.acquire costs
// a cluster-scope fence; on an H100 (bench_cluster_sync.py) the stores plus
// barrier.cluster take ~920 cycles a round at C = 8 and 128 threads, ~1430
// at 256, the st.async exchange ~350. A barrier.cluster before the first
// round makes sure every CTA of the cluster runs and has initialised its
// mbarriers before any remote store, and one after the last keeps every CTA
// resident until the stores into it have landed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

constexpr float kMagSkip = 1e-3f;
constexpr float kInitDist = 1e10f;
// Threads a CTA may have: at 16 points a thread in registers (coordinates and
// running distance, 4 registers a point, and the tree's values and indices,
// 2) 512 threads fit the register file, so a CTA owns at most 8192 points and
// a larger cloud takes a cluster of at least 2.
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Monotone map of a float onto uint32 (no NaN here): a < b <=> key(a) < key(b).
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The warp's best of (key, lo = ~index): the largest key, then the largest lo
// (the lowest index) among the lanes that hold it; every lane gets it.
__device__ __forceinline__ uint64_t warp_best(uint32_t key, uint32_t lo) {
  const uint32_t k = __reduce_max_sync(0xffffffffu, key);
  const uint32_t l = __reduce_max_sync(0xffffffffu, key == k ? lo : 0u);
  return (static_cast<uint64_t>(k) << 32) | l;
}

// Grid (C, B), clusters of C CTAs along x: CTA r of cluster b samples batch
// row b, owning points [r * chunk, min(n, (r + 1) * chunk)).
template <bool kCluster, int PPT>
__global__ void __launch_bounds__(kMaxThreads, 1)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n, int npoint, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const int csize = kCluster ? static_cast<int>(gridDim.x) : 1;
  const int rank = kCluster ? static_cast<int>(cluster_rank()) : 0;
  const int nslots = csize * nwarps;  // one a warp of the cluster
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [2] mbarriers, by round parity
  uint64_t* slots = bars + 2;                           // [2][nslots], by round parity
  float* sx = reinterpret_cast<float*>(slots + 2 * nslots);  // the whole cloud
  float* sy = sx + n;
  float* sz = sy + n;

  const int batch = blockIdx.y;
  const int base = rank * chunk;
  const int count = min(chunk, n - base);
  const float* p = xyz + static_cast<size_t>(batch) * n * 3;
  for (int i = tid; i < n; i += nthreads) {
    sx[i] = p[3 * i + 0];
    sy[i] = p[3 * i + 1];
    sz[i] = p[3 * i + 2];
  }
  if (kCluster && tid == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float px[PPT], py[PPT], pz[PPT], mind[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tid + k * nthreads;
    const int g = min(base + i, n - 1);  // past the CTA's points: any point, never picked
    px[k] = sx[g];
    py[k] = sy[g];
    pz[k] = sz[g];
    // Invalid points carry -1, which no min() with a distance (>= 0) raises;
    // slots past the CTA's points -2, below every point's value.
    mind[k] = i >= count ? -2.f : sq3(px[k], py[k], pz[k]) > kMagSkip ? kInitDist : -1.f;
  }
  float lx = sx[0], ly = sy[0], lz = sz[0];  // the first pick, index 0
  if (rank == 0 && tid == 0) out[static_cast<size_t>(batch) * npoint] = 0;
  if constexpr (kCluster) cluster_sync();  // every CTA runs before the first remote store

  for (int j = 1; j < npoint; ++j) {
    // Update the running distances and take the thread's best in a pairwise
    // tree (a short chain of dependent steps), lower indices first, so that
    // the strict > keeps the lowest index among equal values.
    float v[PPT];
    int vk[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      mind[k] = fminf(mind[k], sq3(__fsub_rn(px[k], lx), __fsub_rn(py[k], ly),
                                   __fsub_rn(pz[k], lz)));
      v[k] = mind[k];
      vk[k] = k;
    }
#pragma unroll
    for (int s = 1; s < PPT; s <<= 1) {
#pragma unroll
      for (int k = 0; k + s < PPT; k += 2 * s) {
        if (v[k + s] > v[k]) {
          v[k] = v[k + s];
          vk[k] = vk[k + s];
        }
      }
    }
    const uint64_t wbest =
        warp_best(order_key(v[0]), ~static_cast<uint32_t>(base + tid + vk[0] * nthreads));
    const uint32_t wlo = static_cast<uint32_t>(wbest), whi = static_cast<uint32_t>(wbest >> 32);

    // Publish the warp's best into slot (rank, warp) of every CTA of the
    // cluster, then meet: the round's one barrier.
    const int par = j & 1;
    uint64_t* buf = slots + par * nslots;
    if constexpr (kCluster) {
      const uint32_t bar = smem_u32(&bars[par]);
      if (tid == 0) mbar_expect_tx(bar, nslots * 8);
      if (lane < csize) {
        st_async_v2(dsmem_addr(buf + rank * nwarps + warp, lane), wlo, whi,
                    dsmem_addr(&bars[par], lane));
      }
      mbar_wait(bar, ((j - 1) >> 1) & 1);  // the ((j - 1) / 2)-th use of this barrier
    } else {
      if (lane == 0) buf[warp] = wbest;
      __syncthreads();
    }

    // Every warp reduces the slots itself: the round's pick, whose
    // coordinates this CTA holds.
    uint64_t c = 0;
    for (int s = lane; s < nslots; s += 32) c = buf[s] > c ? buf[s] : c;
    const uint64_t best = warp_best(static_cast<uint32_t>(c >> 32), static_cast<uint32_t>(c));
    const int pick = static_cast<int>(~static_cast<uint32_t>(best));
    lx = sx[pick];
    ly = sy[pick];
    lz = sz[pick];
    if (rank == 0 && tid == 0) out[static_cast<size_t>(batch) * npoint + j] = pick;
  }
  // No CTA leaves while the last round's stores into it may be in flight.
  if constexpr (kCluster) cluster_sync();
}

template <bool kCluster, int PPT>
int launch(const float* xyz, int* out, int batch, int n, int npoint, int cluster, int threads,
           cudaStream_t stream) {
  const int chunk = (n + cluster - 1) / cluster;
  const size_t smem = 2 * sizeof(uint64_t) +
                      2 * static_cast<size_t>(cluster) * (threads / 32) * sizeof(uint64_t) +
                      3 * static_cast<size_t>(n) * sizeof(float);
  return launch_clustered(fps_kernel<kCluster, PPT>, dim3(cluster, batch), threads, smem, cluster,
                          stream, xyz, out, n, npoint, chunk);
}

template <bool kCluster>
int dispatch(const float* xyz, int* out, int batch, int n, int npoint, int cluster, int threads,
             int ppt, cudaStream_t s) {
  switch (ppt) {
    case 4: return launch<kCluster, 4>(xyz, out, batch, n, npoint, cluster, threads, s);
    case 16: return launch<kCluster, 16>(xyz, out, batch, n, npoint, cluster, threads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// xyz (B, N, 3) contiguous f32, N <= 16384; out (B, npoint) int32. The
// launch plan (ops/fps.py::fps_launch_plan): `cluster` CTAs a sample (1, 2,
// 4, 8 or 16), `threads` a CTA (a multiple of 32, at most 512) and `ppt`
// points a thread (4 or 16), with threads * ppt >= ceil(N / cluster) and
// every CTA owning at least one point. Launches on `stream`; returns a CUDA error code (0 on
// success; cudaErrorInvalidValue for a plan outside those rules).
extern "C" int fps_launch(const float* xyz, int* out, int batch, int n, int npoint, int cluster,
                          int threads, int ppt, void* stream) {
  if (batch <= 0 || npoint <= 0) return static_cast<int>(cudaGetLastError());
  const bool cluster_ok = cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8 ||
                          cluster == 16;
  const int chunk = cluster_ok ? (n + cluster - 1) / cluster : 0;
  if (!cluster_ok || n <= 0 || n > 16384 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || static_cast<long long>(threads) * ppt < chunk ||
      (cluster - 1) * chunk >= n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return cluster == 1 ? dispatch<false>(xyz, out, batch, n, npoint, cluster, threads, ppt, s)
                      : dispatch<true>(xyz, out, batch, n, npoint, cluster, threads, ppt, s);
}
