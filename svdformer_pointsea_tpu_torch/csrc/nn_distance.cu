// One-way nearest-neighbour squared distance + argmin (kernel K1),
// register-blocked over queries and split over targets.
//
// Replaces: svdformer_pointsea_tpu/ops/nn_pallas.py::_nn_kernel (the Pallas
// TPU kernel behind nn_one_way_pallas), which the JAX package dispatches from
// ops/distances.py::_nn_one_way. It is the NN search inside every SDG stage,
// every chamfer of the loss pyramid and of the metrics (16384 x 16384 per
// direction).
//
// Semantics (held bit for bit against the plain PyTorch version in
// ops/distances.py::nn_one_way_plain on the same card):
//   d(i, j) = (dx*dx + dy*dy) + dz*dz in exact f32 difference form, every
//             product and sum rounded on its own (no FMA contraction), which
//             is how PyTorch's elementwise ops evaluate the plain version;
//   argmin  = lowest index among equal minima (strict < while scanning j in
//             increasing order, within a tile, across tiles and across the
//             split's ranges);
//   dmin    = max(min_j d(i, j), 0); a row whose distances are all inf keeps
//             index 0.
//
// What bounds it on an H100: the issue rate of unfused FP32 operations. A
// (query, target) pair costs 3 sub + 3 mul + 2 add, rounded one by one, and a
// compare and two selects for the running argmin: 11 instructions, each one
// issue slot of an SM sub-partition, against 12 bytes read per target. The
// kernel before this design held one query a thread, so every pair also cost
// 3 shared-memory loads (the load/store unit, one warp instruction a clock per
// SM, was busier than the FP32 pipes), and a grid of ceil(N / 256) x B gave
// the small sites a few CTAs (12 at (256, 256), B 12).
//
// Design (the plan - threads, Q, S, chunk, vote - is
// ops/distances.py::nn_launch_plan, its rules measured at every main-path
// site):
//   - Q queries a thread in registers (4 where the queries fill the card, 2
//     on the small sites, where more threads pay more): each target read from
//     shared memory (one 16-byte broadcast load of x, y, z) serves Q pairs;
//   - the targets pass through shared memory in tiles of kTile points,
//     double-buffered with cp.async (4-byte copies into a padded float4 row),
//     the next tile landing while the current one is scanned; tiles go in
//     increasing j, so strict < keeps the lowest index;
//   - on long ranges of targets (16384), a vote of the warp every 4 targets
//     (kVote): the compare and two selects of the running argmin run only
//     where some lane found a smaller distance, which soon becomes rare, so
//     a pair costs 9 instructions and not 11;
//   - where the queries alone give the card too few warps, S CTAs (a cluster
//     along x) scan S contiguous, increasing ranges of `chunk` targets for
//     the same queries; each leaves its partial (d, j) in its own shared
//     memory, and after a cluster barrier CTA r merges 1/S of the queries by
//     reading the S partials through distributed shared memory in range
//     order with strict <, so a tie across a range boundary keeps the lower
//     index; a second cluster barrier keeps every CTA resident until the
//     others have read it. One launch, no scratch buffer, deterministic.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cluster.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTile = 256;  // targets a shared-memory stage
constexpr int kMaxSplits = 8;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Scans `len` targets of a tile (j0 the index of its first) for Q queries.
// With kVote > 0, the running minima are updated only where some lane of the
// warp found a smaller distance among kVote targets (one vote for them). The
// updates, when they run, take the targets in order, so strict < still keeps
// the lowest index.
template <int Q, int kVote>
__device__ __forceinline__ void scan_group(const float4* __restrict__ tile, int j,
                                           const float (&qx)[Q], const float (&qy)[Q],
                                           const float (&qz)[Q], float (&best)[Q], int (&bj)[Q]) {
  constexpr int G = kVote > 0 ? kVote : 1;
  float d[G][Q];
  bool smaller = false;
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const float4 t = tile[u];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float dx = __fsub_rn(qx[q], t.x);
      const float dy = __fsub_rn(qy[q], t.y);
      const float dz = __fsub_rn(qz[q], t.z);
      d[u][q] = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if constexpr (kVote > 0) smaller |= d[u][q] < best[q];
    }
  }
  if (kVote == 0 || __any_sync(0xffffffffu, smaller)) {
#pragma unroll
    for (int u = 0; u < G; ++u) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (d[u][q] < best[q]) {
          best[q] = d[u][q];
          bj[q] = j + u;
        }
      }
    }
  }
}

template <int Q, int kVote, int kLen>
__device__ __forceinline__ void scan(const float4* __restrict__ tile, int len, int j0,
                                     const float (&qx)[Q], const float (&qy)[Q],
                                     const float (&qz)[Q], float (&best)[Q], int (&bj)[Q]) {
  constexpr int G = kVote > 0 ? kVote : 1;
  const int n = kLen > 0 ? kLen : len;
  int k = 0;
#pragma unroll 4
  for (; k + G <= n; k += G) scan_group<Q, kVote>(tile + k, j0 + k, qx, qy, qz, best, bj);
  for (; k < n; ++k) scan_group<Q, kVote == 0 ? 0 : 1>(tile + k, j0 + k, qx, qy, qz, best, bj);
}

// Grid (S, ceil(n / (threads * Q)), B), clusters of S CTAs along x. Thread t
// of query block y holds queries y * threads * Q + k * threads + t, k < Q;
// CTA s scans targets [s * chunk, min(m, (s + 1) * chunk)).
template <int Q, int kVote>
__global__ void __launch_bounds__(kMaxThreads)
nn_one_way_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ dmin, int* __restrict__ idx, int n, int m, int chunk) {
  constexpr int kTileBytes = 2 * kTile * static_cast<int>(sizeof(float4));
  constexpr int kPartBytes = kMaxThreads * Q * 8;  // the partials (d, j) of a split
  __shared__ __align__(16) unsigned char raw[kTileBytes > kPartBytes ? kTileBytes : kPartBytes];
  float4* tiles = reinterpret_cast<float4*>(raw);  // [2][kTile]: x, y, z, unused

  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int splits = gridDim.x;
  const int split = blockIdx.x;  // = the CTA's rank in its cluster
  const int batch = blockIdx.z;
  const int q0 = blockIdx.y * nthreads * Q;
  const float* ab = a + static_cast<size_t>(batch) * n * 3;
  const float* bb = b + static_cast<size_t>(batch) * m * 3;

  float qx[Q], qy[Q], qz[Q], best[Q];
  int bj[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const int i = q0 + k * nthreads + tid;
    qx[k] = qy[k] = qz[k] = 0.f;
    if (i < n) {
      qx[k] = ab[3 * i + 0];
      qy[k] = ab[3 * i + 1];
      qz[k] = ab[3 * i + 2];
    }
    best[k] = CUDART_INF_F;  // an all-inf row keeps index 0, as torch.min does
    bj[k] = 0;
  }

  const int t_begin = split * chunk;
  const int t_end = min(m, t_begin + chunk);
  const int ntiles = (t_end - t_begin + kTile - 1) / kTile;
  auto stage = [&](int t) {
    const int t0 = t_begin + t * kTile;
    const int len = min(kTile, t_end - t0);
    float* dst = reinterpret_cast<float*>(tiles + (t & 1) * kTile);
    for (int k = tid; k < len; k += nthreads) {
      const float* src = bb + 3 * static_cast<size_t>(t0 + k);
      cp_async4(dst + 4 * k + 0, src + 0);
      cp_async4(dst + 4 * k + 1, src + 1);
      cp_async4(dst + 4 * k + 2, src + 2);
    }
    cp_async_commit();
  };
  if (ntiles > 0) stage(0);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      stage(t + 1);  // its buffer was last read in iteration t - 1, before its closing barrier
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = t_begin + t * kTile;
    const int len = min(kTile, t_end - t0);
    const float4* cur = tiles + (t & 1) * kTile;
    if (len == kTile) {
      scan<Q, kVote, kTile>(cur, len, t0, qx, qy, qz, best, bj);
    } else {
      scan<Q, kVote, 0>(cur, len, t0, qx, qy, qz, best, bj);
    }
    __syncthreads();
  }

  if (splits == 1) {
#pragma unroll
    for (int k = 0; k < Q; ++k) {
      const int i = q0 + k * nthreads + tid;
      if (i < n) {
        dmin[static_cast<size_t>(batch) * n + i] = fmaxf(best[k], 0.f);
        idx[static_cast<size_t>(batch) * n + i] = bj[k];
      }
    }
    return;
  }

  // Partials of local query l = k * threads + t (the tiles are no longer read).
  float* part_d = reinterpret_cast<float*>(raw);
  int* part_j = reinterpret_cast<int*>(raw + kMaxThreads * Q * 4);
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    part_d[k * nthreads + tid] = best[k];
    part_j[k * nthreads + tid] = bj[k];
  }
  cluster_sync();
  const int per = nthreads * Q;
  const int slice = (per + splits - 1) / splits;
  const int end = min(per, (split + 1) * slice);
  for (int l = split * slice + tid; l < end; l += nthreads) {
    float ds[kMaxSplits];
    int js[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {  // all loads first: one round trip, not S
      if (s < splits) {
        ds[s] = __uint_as_float(ld_cluster(dsmem_addr(part_d + l, s)));
        js[s] = static_cast<int>(ld_cluster(dsmem_addr(part_j + l, s)));
      }
    }
    float d = ds[0];
    int jj = js[0];
#pragma unroll
    for (int s = 1; s < kMaxSplits; ++s) {  // range order: strict < keeps the lower index
      if (s < splits && ds[s] < d) {
        d = ds[s];
        jj = js[s];
      }
    }
    const int i = q0 + l;
    if (i < n) {
      dmin[static_cast<size_t>(batch) * n + i] = fmaxf(d, 0.f);
      idx[static_cast<size_t>(batch) * n + i] = jj;
    }
  }
  cluster_sync();  // every CTA stays until the others have read its partials
}

template <int Q>
int launch(const float* a, const float* b, float* dmin, int* idx, int batch, int n, int m,
           int threads, int splits, int chunk, int vote, cudaStream_t stream) {
  const int qblocks = (n + threads * Q - 1) / (threads * Q);
  const dim3 grid(splits, qblocks, batch);
  return vote ? launch_clustered(nn_one_way_kernel<Q, 4>, grid, threads, 0, splits, stream, a, b,
                                 dmin, idx, n, m, chunk)
              : launch_clustered(nn_one_way_kernel<Q, 0>, grid, threads, 0, splits, stream, a, b,
                                 dmin, idx, n, m, chunk);
}

}  // namespace

// a (B, N, 3), b (B, M, 3) contiguous f32 on the device; dmin (B, N) f32 and
// idx (B, N) int32 outputs. The launch plan (ops/distances.py::nn_launch_plan):
// `threads` a CTA (a multiple of 32, at most 256), `q` queries a thread (2 or
// 4), `splits` ranges of `chunk` targets (1 to 8, each range non-empty,
// together covering [0, M)) and `vote` targets a vote (0 for none, or 4).
// Launches on `stream`; returns a CUDA error code (0 on success;
// cudaErrorInvalidValue for a plan outside those rules).
extern "C" int nn_one_way_launch(const float* a, const float* b, float* dmin, int* idx, int batch,
                                 int n, int m, int threads, int q, int splits, int chunk,
                                 int vote, void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (m <= 0 || threads < 32 || threads > kMaxThreads || threads % 32 != 0 || splits < 1 ||
      splits > kMaxSplits || chunk <= 0 || static_cast<long long>(splits) * chunk < m ||
      static_cast<long long>(splits - 1) * chunk >= m || (vote != 0 && vote != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q) {
    case 2: return launch<2>(a, b, dmin, idx, batch, n, m, threads, splits, chunk, vote, s);
    case 4: return launch<4>(a, b, dmin, idx, batch, n, m, threads, splits, chunk, vote, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
