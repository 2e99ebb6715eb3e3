// Furthest point sampling (kernel K2).
//
// Replaces: svdformer_pointsea_tpu/ops/fps.py::_fps_kernel (the Pallas TPU
// kernel behind _fps_pallas / furthest_point_sample). On the evaluation path
// it picks 512 of 2048 (SA1, LocalEncoder), 128 of 512 (SA2) and 512 of 2304
// (the merge); the loss pyramid of the training slice picks 2048 of 16384.
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
// What bounds it on an H100: latency, not bandwidth or FLOPs. `npoint - 1`
// rounds run one after the other, each ending in a block-wide (value, index)
// reduction and two barriers, and only B of the 132 SMs are busy. Design: one
// block of up to 1024 threads per batch row; the coordinates live in shared
// memory as structure-of-arrays (12 bytes a point: 192 KB at N = 16384, within
// the 227 KB a block may use), and each thread keeps the running min-distance
// of its PPT points in registers, so no round touches device memory except to
// write its pick. Invalid points carry a running distance of -1, which no
// min() with a real distance can raise and no valid point (>= 0) loses to;
// the all-invalid row then resolves to its lowest index, 0, by the same
// lowest-index tie rule.

#include <cuda_runtime.h>

namespace {

constexpr float kMagSkip = 1e-3f;
constexpr float kInitDist = 1e10f;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Larger value wins; equal values go to the lower index.
__device__ __forceinline__ void arg_better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ xyz, int* __restrict__ out, int n, int npoint) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + n;
  float* sz = sy + n;
  __shared__ float warp_val[32];
  __shared__ int warp_idx[32];
  __shared__ int s_last;

  const int batch = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (nthreads + 31) >> 5;
  const float* p = xyz + (size_t)batch * n * 3;

  float mind[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int i = tid + k * nthreads;
    mind[k] = -1.f;
    if (i < n) {
      const float x = p[3 * i + 0], y = p[3 * i + 1], z = p[3 * i + 2];
      sx[i] = x;
      sy[i] = y;
      sz[i] = z;
      if (sq3(x, y, z) > kMagSkip) mind[k] = kInitDist;
    }
  }
  if (tid == 0) {
    out[(size_t)batch * npoint] = 0;
    s_last = 0;
  }
  __syncthreads();

  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    float bv = -2.f;  // below every in-range value, so empty threads never win
    int bi = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * nthreads;
      if (i < n) {
        const float d = sq3(__fsub_rn(sx[i], lx), __fsub_rn(sy[i], ly), __fsub_rn(sz[i], lz));
        mind[k] = fminf(mind[k], d);
        if (mind[k] > bv) {  // i grows with k: strict > keeps the lowest index
          bv = mind[k];
          bi = i;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      arg_better(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
                 __shfl_down_sync(0xffffffffu, bi, off));
    }
    if (lane == 0) {
      warp_val[warp] = bv;
      warp_idx[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < nwarps ? warp_val[lane] : -2.f;
      bi = lane < nwarps ? warp_idx[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        arg_better(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
                   __shfl_down_sync(0xffffffffu, bi, off));
      }
      if (lane == 0) {
        s_last = bi;
        out[(size_t)batch * npoint + j] = bi;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

template <int PPT>
int launch(const float* xyz, int* out, int batch, int n, int npoint, int threads,
           cudaStream_t stream) {
  const size_t smem = (size_t)3 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fps_kernel<PPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<PPT><<<batch, threads, smem, stream>>>(xyz, out, n, npoint);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3) contiguous f32; out (B, npoint) int32. N <= 16384 (the wrapper
// checks). Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int fps_launch(const float* xyz, int* out, int batch, int n, int npoint,
                          void* stream) {
  if (batch <= 0 || npoint <= 0) return (int)cudaGetLastError();
  int threads = ((n + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int ppt = (n + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (ppt <= 1) return launch<1>(xyz, out, batch, n, npoint, threads, s);
  if (ppt <= 2) return launch<2>(xyz, out, batch, n, npoint, threads, s);
  if (ppt <= 4) return launch<4>(xyz, out, batch, n, npoint, threads, s);
  if (ppt <= 8) return launch<8>(xyz, out, batch, n, npoint, threads, s);
  if (ppt <= 16) return launch<16>(xyz, out, batch, n, npoint, threads, s);
  return (int)cudaErrorInvalidValue;
}
