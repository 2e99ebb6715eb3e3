// One-way nearest-neighbour squared distance + argmin (kernel K1).
//
// Replaces: svdformer_pointsea_tpu/ops/nn_pallas.py::_nn_kernel (the Pallas
// TPU kernel behind nn_one_way_pallas), which the JAX package dispatches from
// ops/distances.py::_nn_one_way. It is the NN search inside every SDG stage
// and every chamfer of the metrics (16384 x 16384 per direction at eval).
//
// Semantics (held bit for bit against the plain PyTorch version in
// ops/distances.py::nn_one_way_plain on the same card):
//   d(i, j) = (dx*dx + dy*dy) + dz*dz in exact f32 difference form, every
//             product and sum rounded on its own (no FMA contraction), which
//             is how PyTorch's elementwise ops evaluate the plain version;
//   argmin  = lowest index among equal minima (strict < while scanning j in
//             increasing order, also across shared-memory tiles);
//   dmin    = max(min_j d(i, j), 0).
//
// What bounds it on an H100: FP32 issue rate. Each (query, target) pair costs
// 3 sub + 3 mul + 2 add + compare/select, i.e. ~10 instructions, and the
// kernel reads only 12 bytes per target per 256 queries, so memory never
// limits it. Design: grid (ceil(N/256), B), one query per thread held in
// registers, the target set streamed through shared memory in tiles of
// TILE points stored structure-of-arrays (every thread of a warp reads the
// same address: a broadcast, no bank conflicts). Rounding each operation on
// its own gives up FMA contraction (~20% of issue slots) to keep the argmin
// equal to the plain version's; a faster kernel is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void __launch_bounds__(kThreads)
nn_one_way_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ dmin, int* __restrict__ idx, int n, int m) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float sz[kTile];

  const int batch = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float* ab = a + (size_t)batch * n * 3;
  const float* bb = b + (size_t)batch * m * 3;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < n) {
    qx = ab[3 * i + 0];
    qy = ab[3 * i + 1];
    qz = ab[3 * i + 2];
  }
  float best = CUDART_INF_F;  // an all-inf row keeps index 0, as torch.min does
  int best_j = 0;

  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int len = min(kTile, m - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < len; k += kThreads) {
      sx[k] = bb[3 * (t0 + k) + 0];
      sy[k] = bb[3 * (t0 + k) + 1];
      sz[k] = bb[3 * (t0 + k) + 2];
    }
    __syncthreads();
    for (int k = 0; k < len; ++k) {
      const float dx = __fsub_rn(qx, sx[k]);
      const float dy = __fsub_rn(qy, sy[k]);
      const float dz = __fsub_rn(qz, sz[k]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < best) {
        best = d;
        best_j = t0 + k;
      }
    }
  }
  if (i < n) {
    dmin[(size_t)batch * n + i] = fmaxf(best, 0.f);
    idx[(size_t)batch * n + i] = best_j;
  }
}

}  // namespace

// a (B, N, 3), b (B, M, 3) contiguous f32 on the device; dmin (B, N) f32 and
// idx (B, N) int32 outputs. Launches on `stream`; returns cudaGetLastError().
extern "C" int nn_one_way_launch(const float* a, const float* b, float* dmin, int* idx,
                                 int batch, int n, int m, void* stream) {
  if (batch > 0 && n > 0 && m > 0) {
    dim3 grid((n + kThreads - 1) / kThreads, batch);
    nn_one_way_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, b, dmin, idx, n, m);
  }
  return (int)cudaGetLastError();
}
