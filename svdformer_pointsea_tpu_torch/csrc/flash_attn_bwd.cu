// Flash-attention backward, f32: dK / dV (kernel K4) and dQ (kernel K5).
//
// Replaces: the two backward Pallas kernels that svdformer_pointsea_tpu/nn/
// flash_vjp.py::_bwd runs for flash_attention_di128 -- upstream
// jax.experimental.pallas.ops.tpu.flash_attention._flash_attention_bwd_dkv
// (kernel _flash_attention_dkv_kernel), and _bwd_dq_di128 around upstream
// _flash_attention_dq_kernel. Non-causal, no bias, no segment ids.
//
// Math (S = Q K^T * scale, LSE the forward's per-row log-sum-exp, written by
// K3 in flash_attn.cu; di = rowsum(O * dO), computed by the caller):
//   P  = exp(S - LSE)          dP = dO V^T          dS = P * (dP - di)
//   dV = P^T dO                dK = dS^T Q * scale  dQ = dS K * scale
// Both kernels recompute S and dP tile by tile, so neither the (Lq, Lk)
// probabilities nor their gradient ever reach device memory.
//
// Layout: q, dout, dq (B, Lq, H, D); k, v, dk, dv (B, Lk, H, D), contiguous
// f32, read and written in place (the port's channels-last layout); lse, di
// (B, H, Lq) f32. Lq and Lk are multiples of 64; D is 64, 96, 128 or 256.
//
// What bounds it on an H100: arithmetic. K4 does ~8 B H Lq Lk D flops (S, dP,
// dV, dK) against (2 Lq + 4 Lk) B H D f32 values of traffic, K5 ~6 B H Lq Lk D
// (S, dP, dQ) against (3 Lq + 2 Lk) B H D, so both are far above the f32
// ridge point. The path is f32 for parity (TF32 tensor cores keep ~3 decimal
// digits), so the peak is the FP32 pipes' 67 TFLOP/s, and the practical limit
// is the shared-memory operand traffic that feeds the FMAs. Design, the same register tiling as
// K3 (256 threads as 16 x 16, 64-row tiles, operands stored d-major so one
// 16-byte load fetches 4 rows):
// - K4: one block per (64-key tile, head, batch) keeps K and V and loops over
//   the query tiles. Each thread computes a 4 x 4 tile of S and dP (16 FMAs
//   per 2 16-byte loads each), turns it into P and dS and stores both in
//   shared memory; then it owns 4 keys x D/16 columns of dK and dV and
//   accumulates P^T dO and dS^T Q four query rows at a time: 8 16-byte loads
//   of P and dS, then per owned column 2 (dO, Q) that feed 32 FMAs.
// - K5: one block per (64-query tile, head, batch) keeps Q and dO and loops
//   over the key tiles; dS goes through shared memory and each thread
//   accumulates 4 rows x D/16 columns of dS K, reading K d-major.
// Every output element is summed by one thread in a fixed order: no atomics,
// so dQ, dK and dV are deterministic. At D 256 the four operand tiles do not
// fit in 227 KB, so D is streamed in two 128-wide chunks (Q / dO / K / V
// reloaded per chunk); D <= 128 keeps the block's own tiles resident.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;        // rows per tile, queries and keys alike
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kLd = kRows + 4;   // leading dim of a d-major tile; keeps 16-byte alignment

template <int D>
struct Chunk {
  static constexpr int width = D > 128 ? 128 : D;  // head-dim columns per pass
  static constexpr int count = D / width;
  static constexpr int tile = width * kLd;         // floats in one d-major tile
};

// Copies a (64, W) row tile of a (.., H, D) tensor (row stride `rs` floats,
// columns from `src` on) into d-major shared memory: dst[c * kLd + row].
template <int W>
__device__ __forceinline__ void load_dmajor(float* dst, const float* src, size_t rs) {
  for (int e = threadIdx.x; e < kRows * (W / 4); e += kThreads) {
    const int r = e % kRows;
    const int c = (e / kRows) * 4;
    const float4 t = *reinterpret_cast<const float4*>(src + r * rs + c);
    dst[(c + 0) * kLd + r] = t.x;
    dst[(c + 1) * kLd + r] = t.y;
    dst[(c + 2) * kLd + r] = t.z;
    dst[(c + 3) * kLd + r] = t.w;
  }
}

__device__ __forceinline__ void unpack(const float4 t, float* out) {
  out[0] = t.x;
  out[1] = t.y;
  out[2] = t.z;
  out[3] = t.w;
}

// s += A B^T and dp += G W^T over one chunk for the thread's 4 x 4 tile:
// rows ty*4.. of A / G (d-major), rows tx*4.. of B / W (d-major).
template <int W>
__device__ __forceinline__ void score_tiles(const float* As, const float* Bs, const float* Gs,
                                            const float* Ws, int ty, int tx, float (&s)[4][4],
                                            float (&dp)[4][4]) {
#pragma unroll 4
  for (int d = 0; d < W; ++d) {
    float a[4], b[4], g[4], w[4];
    unpack(*reinterpret_cast<const float4*>(As + d * kLd + ty * 4), a);
    unpack(*reinterpret_cast<const float4*>(Bs + d * kLd + tx * 4), b);
    unpack(*reinterpret_cast<const float4*>(Gs + d * kLd + ty * 4), g);
    unpack(*reinterpret_cast<const float4*>(Ws + d * kLd + tx * 4), w);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
      }
  }
}

// ---------------------------------------------------------------- K4: dK, dV
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ lse,
                     const float* __restrict__ dout, const float* __restrict__ di,
                     float* __restrict__ dk, float* __restrict__ dv, int heads, int lq, int lk,
                     float scale) {
  using C = Chunk<D>;
  constexpr int W = C::width;
  constexpr int CC = W / 16;  // columns per thread per chunk
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [W][kLd]
  float* Vs = Ks + C::tile;
  float* Qs = Vs + C::tile;
  float* dOs = Qs + C::tile;
  float* Ps = dOs + C::tile;   // [query row][kLd], keys along the row
  float* dSs = Ps + kRows * kLd;
  float* lse_s = dSs + kRows * kLd;
  float* di_s = lse_s + kRows;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rs = (size_t)heads * D;
  const float* kb = k + ((size_t)b * lk + k0) * rs + (size_t)h * D;
  const float* vb = v + ((size_t)b * lk + k0) * rs + (size_t)h * D;
  const float* lse_b = lse + ((size_t)b * heads + h) * lq;
  const float* di_b = di + ((size_t)b * heads + h) * lq;

  // This thread's outputs: keys ty*4 + jj, columns ch*W + tx + 16*cc.
  float acc_dk[4][D / 16], acc_dv[4][D / 16];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      acc_dk[jj][c] = 0.f;
      acc_dv[jj][c] = 0.f;
    }

  if (C::count == 1) {
    load_dmajor<W>(Ks, kb, rs);
    load_dmajor<W>(Vs, vb, rs);
  }

  for (int q0 = 0; q0 < lq; q0 += kRows) {
    const float* qb = q + ((size_t)b * lq + q0) * rs + (size_t)h * D;
    const float* ob = dout + ((size_t)b * lq + q0) * rs + (size_t)h * D;

    // Scores and dP for query rows ty*4.., keys tx*4.. of this tile pair.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll
    for (int ch = 0; ch < C::count; ++ch) {
      __syncthreads();  // every thread is done with the previous tiles
      if (C::count > 1) {
        load_dmajor<W>(Ks, kb + ch * W, rs);
        load_dmajor<W>(Vs, vb + ch * W, rs);
      }
      load_dmajor<W>(Qs, qb + ch * W, rs);
      load_dmajor<W>(dOs, ob + ch * W, rs);
      if (ch == 0 && tid < kRows) {
        lse_s[tid] = lse_b[q0 + tid];
        di_s[tid] = di_b[q0 + tid];
      }
      __syncthreads();
      score_tiles<W>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const float m = lse_s[row];
      const float g = di_s[row];
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(s[i][j] * scale - m);
        ds[j] = p[j] * (dp[i][j] - g);
      }
      *reinterpret_cast<float4*>(Ps + row * kLd + tx * 4) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dSs + row * kLd + tx * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }

    // dV += P^T dO, dK += dS^T Q, column chunk by column chunk; the last
    // chunk loaded above is still in shared memory, so it goes first.
#pragma unroll
    for (int t = 0; t < C::count; ++t) {
      const int ch = C::count - 1 - t;
      __syncthreads();  // P / dS complete (and, from t = 1, the last chunk read)
      if (t > 0) {
        load_dmajor<W>(Qs, qb + ch * W, rs);
        load_dmajor<W>(dOs, ob + ch * W, rs);
        __syncthreads();
      }
#pragma unroll 2
      for (int i0 = 0; i0 < kRows; i0 += 4) {
        float pr[4][4], dsr[4][4];  // [query row i0 + ii][key ty*4 + jj]
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          unpack(*reinterpret_cast<const float4*>(Ps + (i0 + ii) * kLd + ty * 4), pr[ii]);
          unpack(*reinterpret_cast<const float4*>(dSs + (i0 + ii) * kLd + ty * 4), dsr[ii]);
        }
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          const int c = tx + 16 * cc;
          float g[4], a[4];  // dO[i0 + ii][c], Q[i0 + ii][c]
          unpack(*reinterpret_cast<const float4*>(dOs + c * kLd + i0), g);
          unpack(*reinterpret_cast<const float4*>(Qs + c * kLd + i0), a);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) {
              acc_dv[jj][ch * CC + cc] = fmaf(pr[ii][jj], g[ii], acc_dv[jj][ch * CC + cc]);
              acc_dk[jj][ch * CC + cc] = fmaf(dsr[ii][jj], a[ii], acc_dk[jj][ch * CC + cc]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const size_t row = ((size_t)b * lk + k0 + ty * 4 + jj) * rs + (size_t)h * D;
#pragma unroll
    for (int ch = 0; ch < C::count; ++ch)
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const int c = ch * W + tx + 16 * cc;
        dk[row + c] = acc_dk[jj][ch * CC + cc] * scale;
        dv[row + c] = acc_dv[jj][ch * CC + cc];
      }
  }
}

// ---------------------------------------------------------------- K5: dQ
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ lse,
                    const float* __restrict__ dout, const float* __restrict__ di,
                    float* __restrict__ dq, int heads, int lq, int lk, float scale) {
  using C = Chunk<D>;
  constexpr int W = C::width;
  constexpr int CC = W / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [W][kLd]
  float* dOs = Qs + C::tile;
  float* Ks = dOs + C::tile;
  float* Vs = Ks + C::tile;
  float* dSs = Vs + C::tile;  // [query row][kLd], keys along the row

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t rs = (size_t)heads * D;
  const float* qb = q + ((size_t)b * lq + q0) * rs + (size_t)h * D;
  const float* ob = dout + ((size_t)b * lq + q0) * rs + (size_t)h * D;

  float row_lse[4], row_di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t r = ((size_t)b * heads + h) * lq + q0 + ty * 4 + i;
    row_lse[i] = lse[r];
    row_di[i] = di[r];
  }
  // This thread's outputs: query rows ty*4 + i, columns ch*W + tx + 16*cc.
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  if (C::count == 1) {
    load_dmajor<W>(Qs, qb, rs);
    load_dmajor<W>(dOs, ob, rs);
  }

  for (int k0 = 0; k0 < lk; k0 += kRows) {
    const float* kb = k + ((size_t)b * lk + k0) * rs + (size_t)h * D;
    const float* vb = v + ((size_t)b * lk + k0) * rs + (size_t)h * D;

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
#pragma unroll
    for (int ch = 0; ch < C::count; ++ch) {
      __syncthreads();  // every thread is done with the previous tiles
      if (C::count > 1) {
        load_dmajor<W>(Qs, qb + ch * W, rs);
        load_dmajor<W>(dOs, ob + ch * W, rs);
      }
      load_dmajor<W>(Ks, kb + ch * W, rs);
      load_dmajor<W>(Vs, vb + ch * W, rs);
      __syncthreads();
      score_tiles<W>(Qs, Ks, dOs, Vs, ty, tx, s, dp);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ds[j] = expf(s[i][j] * scale - row_lse[i]) * (dp[i][j] - row_di[i]);
      *reinterpret_cast<float4*>(dSs + (ty * 4 + i) * kLd + tx * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }

    // dQ += dS K, the resident (last loaded) K chunk first.
#pragma unroll
    for (int t = 0; t < C::count; ++t) {
      const int ch = C::count - 1 - t;
      __syncthreads();  // dS complete (and, from t = 1, the last chunk read)
      if (t > 0) {
        load_dmajor<W>(Ks, kb + ch * W, rs);
        __syncthreads();
      }
#pragma unroll 2
      for (int j0 = 0; j0 < kRows; j0 += 4) {
        float dsr[4][4];  // [query row ty*4 + i][key j0 + jj]
#pragma unroll
        for (int i = 0; i < 4; ++i)
          unpack(*reinterpret_cast<const float4*>(dSs + (ty * 4 + i) * kLd + j0), dsr[i]);
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          float kk[4];  // K[j0 + jj][c]
          unpack(*reinterpret_cast<const float4*>(Ks + (tx + 16 * cc) * kLd + j0), kk);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              acc[i][ch * CC + cc] = fmaf(dsr[i][jj], kk[jj], acc[i][ch * CC + cc]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t row = ((size_t)b * lq + q0 + ty * 4 + i) * rs + (size_t)h * D;
#pragma unroll
    for (int ch = 0; ch < C::count; ++ch)
#pragma unroll
      for (int cc = 0; cc < CC; ++cc)
        dq[row + ch * W + tx + 16 * cc] = acc[i][ch * CC + cc] * scale;
  }
}

template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * (size_t)Chunk<D>::tile + 2 * kRows * kLd + 2 * kRows);
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * (size_t)Chunk<D>::tile + kRows * kLd);
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v, const float* lse,
               const float* dout, const float* di, float* dk, float* dv, int batch, int heads,
               int lq, int lk, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(lk / kRows, heads, batch);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, lse, dout, di, dk, dv,
                                                             heads, lq, lk, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* lse,
              const float* dout, const float* di, float* dq, int batch, int heads, int lq,
              int lk, float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(lq / kRows, heads, batch);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, lse, dout, di, dq, heads,
                                                            lq, lk, scale);
  return (int)cudaGetLastError();
}

int check_shape(int batch, int heads, int lq, int lk) {
  if (lq % kRows != 0 || lk % kRows != 0 || lq <= 0 || lk <= 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// K4. q, dout (B, Lq, H, D); k, v, dk, dv (B, Lk, H, D); lse, di (B, H, Lq):
// contiguous f32 on the device. Lq, Lk multiples of 64; D in {64, 96, 128,
// 256}. Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int flash_attn_bwd_dkv_launch(const float* q, const float* k, const float* v,
                                         const float* lse, const float* dout, const float* di,
                                         float* dk, float* dv, int batch, int heads, int lq,
                                         int lk, int head_dim, float scale, void* stream) {
  if (int err = check_shape(batch, heads, lq, lk)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (head_dim) {
    case 64:
      return launch_dkv<64>(q, k, v, lse, dout, di, dk, dv, batch, heads, lq, lk, scale, s);
    case 96:
      return launch_dkv<96>(q, k, v, lse, dout, di, dk, dv, batch, heads, lq, lk, scale, s);
    case 128:
      return launch_dkv<128>(q, k, v, lse, dout, di, dk, dv, batch, heads, lq, lk, scale, s);
    case 256:
      return launch_dkv<256>(q, k, v, lse, dout, di, dk, dv, batch, heads, lq, lk, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5. Same operands as K4; writes dq (B, Lq, H, D).
extern "C" int flash_attn_bwd_dq_launch(const float* q, const float* k, const float* v,
                                        const float* lse, const float* dout, const float* di,
                                        float* dq, int batch, int heads, int lq, int lk,
                                        int head_dim, float scale, void* stream) {
  if (int err = check_shape(batch, heads, lq, lk)) return err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (head_dim) {
    case 64:
      return launch_dq<64>(q, k, v, lse, dout, di, dq, batch, heads, lq, lk, scale, s);
    case 96:
      return launch_dq<96>(q, k, v, lse, dout, di, dq, batch, heads, lq, lk, scale, s);
    case 128:
      return launch_dq<128>(q, k, v, lse, dout, di, dq, batch, heads, lq, lk, scale, s);
    case 256:
      return launch_dq<256>(q, k, v, lse, dout, di, dq, batch, heads, lq, lk, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
