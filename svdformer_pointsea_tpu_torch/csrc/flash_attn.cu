// Flash-attention forward, f32 (kernel K3).
//
// Replaces: the forward Pallas kernel that svdformer_pointsea_tpu/nn/flash_vjp.py
// (flash_attention_di128 / _fwd) runs through jax.experimental.pallas.ops.tpu
// .flash_attention._flash_attention, entered from nn/layers.py::_scaled_attention.
// It computes O = softmax(Q K^T * scale) V, non-causal, with no bias and no
// segment ids. For training it also writes each query row's softmax
// statistic, the log-sum-exp LSE = m + log(l) of the scaled logits (m the row
// max, l = sum exp(s - m), upstream's two residuals folded into one), which
// the backward kernels K4 / K5 (flash_attn_bwd.cu) read as P = exp(s - LSE).
// With a null `lse` pointer (evaluation) nothing but O is written.
//
// Layout: q (B, Lq, H, D), k and v (B, Lk, H, D), o (B, Lq, H, D), all
// contiguous f32 -- the port's channels-last attention layout, read in place
// so no transpose runs around the call; lse (B, H, Lq) f32 or null. Lq and
// Lk are multiples of 64 (the dispatcher only sends multiples of 512); D is
// 64, 96, 128 or 256.
//
// What bounds it on an H100: the evaluation path is f32 for parity, so the
// tensor cores' TF32 mode is off the table (it keeps ~3 decimal digits) and
// the kernel runs on the FP32 pipes (67 TFLOP/s peak). Its arithmetic
// intensity is high (each K/V tile is reused by 64 query rows), so the limit
// is the shared-memory operand traffic feeding the FMAs. Design: one block of
// 256 threads per (64-row query tile, head, batch); Q stays in shared memory,
// K/V stream through it in 64-row tiles. Each thread owns a 4 x 4 tile of
// scores, reading 4 query and 4 key values per head-dim step as two 16-byte
// loads (Q and K are stored d-major for that), i.e. 16 FMAs per 2 loads. The
// softmax is the online one in f32 (running max m, running sum l, rescaled
// accumulator); probabilities go through shared memory once per tile for the
// P V product, where each thread owns 4 rows x D/16 columns of the output.
// Dynamic shared memory above 48 KB is enabled per instance (217 KB for D 256).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPad = 4;        // row padding that keeps 16-byte alignment

template <int D>
struct Smem {
  static constexpr int q = D * (kBQ + kPad);   // Qs[d][row]
  static constexpr int k = D * (kBK + kPad);   // Ks[d][key]
  static constexpr int v = kBK * D;            // Vs[key][d]
  static constexpr int p = kBK * (kBQ + kPad); // Ps[key][row]
  static constexpr size_t bytes = sizeof(float) * (size_t)(q + k + v + p);
};

// Copies a (64, D) row tile of a (.., H, D) tensor into d-major shared memory.
template <int D>
__device__ __forceinline__ void load_transposed(float* dst, const float* src, size_t row_stride) {
  for (int e = threadIdx.x; e < 64 * (D / 4); e += kThreads) {
    const int r = e % 64;
    const int c = (e / 64) * 4;
    const float4 t = *reinterpret_cast<const float4*>(src + r * row_stride + c);
    dst[(c + 0) * (64 + kPad) + r] = t.x;
    dst[(c + 1) * (64 + kPad) + r] = t.y;
    dst[(c + 2) * (64 + kPad) + r] = t.z;
    dst[(c + 3) * (64 + kPad) + r] = t.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int heads, int lq, int lk, float scale) {
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + Smem<D>::q;
  float* Vs = Ks + Smem<D>::k;
  float* Ps = Vs + Smem<D>::v;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key / output-column group
  const int ty = tid >> 4;  // query-row group: rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rs = (size_t)heads * D;  // stride between tokens

  load_transposed<D>(Qs, q + ((size_t)b * lq + q0) * rs + (size_t)h * D, rs);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < lk; k0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    const float* kb = k + ((size_t)b * lk + k0) * rs + (size_t)h * D;
    const float* vb = v + ((size_t)b * lk + k0) * rs + (size_t)h * D;
    load_transposed<D>(Ks, kb, rs);
    for (int e = tid; e < kBK * (D / 4); e += kThreads) {
      const int r = e / (D / 4);
      const int c = (e % (D / 4)) * 4;
      *reinterpret_cast<float4*>(Vs + r * D + c) =
          *reinterpret_cast<const float4*>(vb + r * rs + c);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qs + d * (kBQ + kPad) + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Ks + d * (kBK + kPad) + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // Online softmax over this tile; a row's 64 scores sit in 16 lanes.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(Ps + (tx * 4 + j) * (kBQ + kPad) + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pp = *reinterpret_cast<const float4*>(Ps + j * (kBQ + kPad) + ty * 4);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = Vs[j * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* orow = o + ((size_t)b * lq + q0 + ty * 4 + i) * rs + (size_t)h * D;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = acc[i][c] * inv;
  }
  // Every lane of a row group holds the same m and l after the shuffles.
  if (lse != nullptr && tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      lse[((size_t)b * heads + h) * lq + q0 + ty * 4 + i] = m[i] + logf(l[i]);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o, float* lse, int batch,
           int heads, int lq, int lk, float scale, cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(lq / kBQ, heads, batch);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, heads, lq, lk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Lq, H, D), k/v (B, Lk, H, D), o (B, Lq, H, D): contiguous f32 on the
// device; lse (B, H, Lq) f32, or null to skip the statistics. Lq, Lk
// multiples of 64; D in {64, 96, 128, 256}. Launches on `stream`; returns a
// CUDA error code (0 on success).
extern "C" int flash_attn_fwd_launch(const float* q, const float* k, const float* v, float* o,
                                     float* lse, int batch, int heads, int lq, int lk,
                                     int head_dim, float scale, void* stream) {
  if (lq % kBQ != 0 || lk % kBK != 0 || lk <= 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || heads <= 0 || lq <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (head_dim) {
    case 64: return launch<64>(q, k, v, o, lse, batch, heads, lq, lk, scale, s);
    case 96: return launch<96>(q, k, v, o, lse, batch, heads, lq, lk, scale, s);
    case 128: return launch<128>(q, k, v, o, lse, batch, heads, lq, lk, scale, s);
    case 256: return launch<256>(q, k, v, o, lse, batch, heads, lq, lk, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
