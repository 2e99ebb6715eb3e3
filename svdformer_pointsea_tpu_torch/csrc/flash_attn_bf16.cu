// Flash attention backward in bf16 on the tensor cores: dK / dV (kernel K4)
// and dQ (kernel K5). The bf16 forward (K3) is flash_attn_bf16_fwd.cu.
//
// Replaces: the bf16 instances of the Pallas kernels that
// svdformer_pointsea_tpu/nn/flash_vjp.py runs when nn/layers.py::
// _scaled_attention casts q, k and v to bf16 (--precision bf16): upstream
// jax.experimental.pallas.ops.tpu.flash_attention._flash_attention_dkv_kernel
// (dK, dV) and _flash_attention_dq_kernel (dQ, through
// flash_vjp.py::_bwd_dq_di128). Non-causal, no bias, no segment ids.
//
// What they compute, the upstream kernels' function with bf16 operands and
// f32 accumulation (bf16 x bf16 products are exact in f32), from the
// forward's O and LSE = m + log l (f32):
//   K4: P = exp(S - LSE) (f32); dV += bf16(P)^T dO; dP = dO V^T (f32);
//       dS = (dP - di) * P * scale (f32); dK += bf16(dS)^T Q; dK, dV bf16.
//   K5: the same P and dS; dQ += bf16(dS) K; dQ bf16.
// As upstream, dS is rounded after the scale is applied; di = rowsum(O * dO)
// in f32 comes from the caller.
//
// Layout: q, dout, dq (B, Lq, H, D); k, v, dk, dv (B, Lk, H, D), all
// contiguous bf16 (the port's channels-last layout, read in place); lse, di
// (B, H, Lq) f32. Lq and Lk are multiples of 64; D is 64, 96, 128 or 256.
//
// What bounds it on an H100: the tensor cores (989 TFLOP/s bf16 dense). K4
// and K5 do 8 and 6 B H Lq Lk D flops against a few (Lq + Lk) B H D bf16
// values, far above the ridge point. Design: warp-level mma.sync.m16n8k16
// (bf16 in, f32 accumulate), operands fed by ldmatrix from shared memory; one block of
// 4 warps per (64-row tile, head, batch), each warp owning 16 rows. Tiles
// live in shared memory row-major with 8 bf16 of padding per row, so the 8
// row addresses of an ldmatrix fall in 8 distinct bank groups. Products
// against a row-major operand (P V, dS K, P^T dO, dS^T Q) read it with
// ldmatrix.trans; the transposed products P^T and dS^T never exist in memory:
// K4 computes S^T = K Q^T and dP^T = V dO^T directly, so its accumulator
// fragments are already the A operands of the next product. Between two
// products a score tile stays in registers (the m16n8k16 accumulator layout
// of two adjacent 8-column tiles is the A-operand layout of one 16-deep
// step). K5 streams K / V tiles of 64 keys through shared memory, K4
// streams Q / dO tiles of 64 queries; no atomics: every output element is
// summed by one thread in a fixed order, so the backward is deterministic.
// K4 and K5 keep at most 128 output columns in registers and stream D 256 in
// two chunks (S and dP recomputed per chunk). A simple, correct first
// version: no cp.async pipelining, wgmma or TMA yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;             // rows per tile, queries and keys alike
constexpr int kWarps = 4;             // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;               // bf16 of padding per shared-memory row
constexpr int kNt = kRows / 8;        // 8-wide n-tiles across a 64-row tile

template <int D>
struct Tile {
  static constexpr int ld = D + kPad;       // row stride in shared memory
  static constexpr int elems = kRows * ld;  // one (64, D) tile
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to nearest even into one bf16 pair, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand (16 x 16) at rows m0.., columns k0.. of a row-major tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int m0, int k0,
                                       int lane) {
  ldsm_x4(a, tile + (m0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}

// B operands of two n-tiles (n0.., n0 + 8..) for depth k0..k0+15, from a tile
// stored [n][k] (b = tile^T): r[0..1] for n0, r[2..3] for n0 + 8.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* tile, int n0, int k0,
                                       int lane) {
  const int i = lane >> 3;
  ldsm_x4(r, tile + (n0 + (i >> 1) * 8 + (lane & 7)) * LD + k0 + (i & 1) * 8);
}

// The same from a tile stored [k][n] (b = tile), through ldmatrix.trans.
template <int LD>
__device__ __forceinline__ void load_b_trans(uint32_t (&r)[4], const bf16* tile, int k0, int n0,
                                             int lane) {
  const int i = lane >> 3;
  ldsm_x4_trans(r, tile + (k0 + (i & 1) * 8 + (lane & 7)) * LD + n0 + (i >> 1) * 8);
}

// Copies rows 0..63 of a (.., H, D) tensor (row stride `rs` elements) into a
// padded row-major tile, 16 bytes a thread per step.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t rs) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * Tile<D>::ld + c) =
        *reinterpret_cast<const uint4*>(src + r * rs + c);
  }
}

// acc (16 x 64, the warp's rows of a score tile) = A-rows m0.. of `a` times
// the 64 rows of `b`, contracted over D.
template <int D>
__device__ __forceinline__ void scores(float (&acc)[kNt][4], const bf16* a, int m0,
                                       const bf16* b, int lane) {
#pragma unroll
  for (int j = 0; j < kNt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    uint32_t fa[4];
    load_a<Tile<D>::ld>(fa, a, m0, k0, lane);
#pragma unroll
    for (int j = 0; j < kNt; j += 2) {
      uint32_t fb[4];
      load_b<Tile<D>::ld>(fb, b, j * 8, k0, lane);
      mma(acc[j], fa, fb[0], fb[1]);
      mma(acc[j + 1], fa, fb[2], fb[3]);
    }
  }
}

// out (16 x W, columns c0..) += bf16(p) (16 x 64, in registers) times rows
// 0..63, columns c0..c0+W of the row-major tile `b`.
template <int D, int W>
__device__ __forceinline__ void accumulate(float (&out)[W / 8][4], const float (&p)[kNt][4],
                                           const bf16* b, int c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < kNt / 2; ++kk) {
    const uint32_t fa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int c = 0; c < W / 8; c += 2) {
      uint32_t fb[4];
      load_b_trans<Tile<D>::ld>(fb, b, kk * 16, c0 + c * 8, lane);
      mma(out[c], fa, fb[0], fb[1]);
      mma(out[c + 1], fa, fb[2], fb[3]);
    }
  }
}

// Writes the warp's 16 rows (row0.. of a (.., H, D) tensor), columns c0..c0+W,
// of an f32 accumulator as bf16, times `mul` per row half.
template <int W>
__device__ __forceinline__ void store_rows(bf16* dst, size_t rs, const float (&acc)[W / 8][4],
                                           int c0, float mul0, float mul1, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < W / 8; ++c) {
    const int col = c0 + c * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dst + g * rs + col) = pack_bf16(acc[c][0] * mul0, acc[c][1] * mul0);
    *reinterpret_cast<uint32_t*>(dst + (g + 8) * rs + col) =
        pack_bf16(acc[c][2] * mul1, acc[c][3] * mul1);
  }
}

// ---------------------------------------------------------------- K5 ------
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ lse,
              const bf16* __restrict__ dout, const float* __restrict__ di,
              bf16* __restrict__ dq, int heads, int lq, int lk, float scale) {
  constexpr int W = D > 128 ? 128 : D;  // dQ columns held per pass
  extern __shared__ uint4 smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + Tile<D>::elems;
  bf16* Ks = dOs + Tile<D>::elems;
  bf16* Vs = Ks + Tile<D>::elems;

  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int wr = (threadIdx.x >> 5) * 16;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const size_t rs = (size_t)heads * D;
  const size_t qoff = ((size_t)b * lq + q0) * rs + (size_t)h * D;
  load_tile<D>(Qs, q + qoff, rs);
  load_tile<D>(dOs, dout + qoff, rs);
  const size_t srow = ((size_t)b * heads + h) * lq + q0 + wr + g;
  const float lse_r[2] = {lse[srow], lse[srow + 8]};
  const float di_r[2] = {di[srow], di[srow + 8]};

  for (int c0 = 0; c0 < D; c0 += W) {
    float acc[W / 8][4];
#pragma unroll
    for (int c = 0; c < W / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
    for (int k0 = 0; k0 < lk; k0 += kRows) {
      __syncthreads();
      const size_t off = ((size_t)b * lk + k0) * rs + (size_t)h * D;
      load_tile<D>(Ks, k + off, rs);
      load_tile<D>(Vs, v + off, rs);
      __syncthreads();
      float p[kNt][4], ds[kNt][4];
      scores<D>(p, Qs, wr, Ks, lane);
      scores<D>(ds, dOs, wr, Vs, lane);  // dP = dO V^T
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = expf(p[j][e] * scale - lse_r[e >> 1]);
          ds[j][e] = (ds[j][e] - di_r[e >> 1]) * pe * scale;
        }
      accumulate<D, W>(acc, ds, Ks, c0, lane);  // dS rounded to bf16 here
    }
    store_rows<W>(dq + qoff + (size_t)wr * rs, rs, acc, c0, 1.f, 1.f, lane);
  }
}

// ---------------------------------------------------------------- K4 ------
template <int D>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ lse,
               const bf16* __restrict__ dout, const float* __restrict__ di,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int lq, int lk,
               float scale) {
  constexpr int W = D > 128 ? 128 : D;  // dK / dV columns held per pass
  extern __shared__ uint4 smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + Tile<D>::elems;
  bf16* Qs = Vs + Tile<D>::elems;
  bf16* dOs = Qs + Tile<D>::elems;
  float* lse_s = reinterpret_cast<float*>(dOs + Tile<D>::elems);
  float* di_s = lse_s + kRows;

  const int lane = threadIdx.x & 31, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const size_t rs = (size_t)heads * D;
  const size_t koff = ((size_t)b * lk + k0) * rs + (size_t)h * D;
  load_tile<D>(Ks, k + koff, rs);
  load_tile<D>(Vs, v + koff, rs);
  const float* lse_b = lse + ((size_t)b * heads + h) * lq;
  const float* di_b = di + ((size_t)b * heads + h) * lq;

  for (int c0 = 0; c0 < D; c0 += W) {
    float acc_k[W / 8][4], acc_v[W / 8][4];
#pragma unroll
    for (int c = 0; c < W / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[c][e] = acc_v[c][e] = 0.f;
    for (int q0 = 0; q0 < lq; q0 += kRows) {
      __syncthreads();
      const size_t off = ((size_t)b * lq + q0) * rs + (size_t)h * D;
      load_tile<D>(Qs, q + off, rs);
      load_tile<D>(dOs, dout + off, rs);
      if (threadIdx.x < kRows) {
        lse_s[threadIdx.x] = lse_b[q0 + threadIdx.x];
        di_s[threadIdx.x] = di_b[q0 + threadIdx.x];
      }
      __syncthreads();
      // Transposed scores: rows are the warp's 16 keys, columns 64 queries.
      float pt[kNt][4];
      scores<D>(pt, Ks, wr, Qs, lane);
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pt[j][e] = expf(pt[j][e] * scale - lse_s[j * 8 + 2 * t + (e & 1)]);
      accumulate<D, W>(acc_v, pt, dOs, c0, lane);  // P^T rounded to bf16 here
      float dst[kNt][4];
      scores<D>(dst, Vs, wr, dOs, lane);  // dP^T = V dO^T
#pragma unroll
      for (int j = 0; j < kNt; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dst[j][e] = (dst[j][e] - di_s[j * 8 + 2 * t + (e & 1)]) * pt[j][e] * scale;
      accumulate<D, W>(acc_k, dst, Qs, c0, lane);  // dS^T rounded to bf16 here
    }
    const size_t out = koff + (size_t)wr * rs;
    store_rows<W>(dk + out, rs, acc_k, c0, 1.f, 1.f, lane);
    store_rows<W>(dv + out, rs, acc_v, c0, 1.f, 1.f, lane);
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

int check_shape(int batch, int heads, int lq, int lk) {
  if (lq % kRows != 0 || lk % kRows != 0 || lk <= 0 || lq <= 0 || batch <= 0 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int D>
int launch_dq(const bf16* q, const bf16* k, const bf16* v, const float* lse, const bf16* dout,
              const float* di, bf16* dq, int batch, int heads, int lq, int lk, float scale,
              cudaStream_t s) {
  const size_t smem = 4 * Tile<D>::elems * sizeof(bf16);
  if (int err = prepare(bwd_dq_kernel<D>, smem)) return err;
  bwd_dq_kernel<D><<<dim3(lq / kRows, heads, batch), kThreads, smem, s>>>(
      q, k, v, lse, dout, di, dq, heads, lq, lk, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const bf16* q, const bf16* k, const bf16* v, const float* lse, const bf16* dout,
               const float* di, bf16* dk, bf16* dv, int batch, int heads, int lq, int lk,
               float scale, cudaStream_t s) {
  const size_t smem = 4 * Tile<D>::elems * sizeof(bf16) + 2 * kRows * sizeof(float);
  if (int err = prepare(bwd_dkv_kernel<D>, smem)) return err;
  bwd_dkv_kernel<D><<<dim3(lk / kRows, heads, batch), kThreads, smem, s>>>(
      q, k, v, lse, dout, di, dk, dv, heads, lq, lk, scale);
  return (int)cudaGetLastError();
}

template <typename Launch>
int dispatch(int head_dim, Launch launch) {
  switch (head_dim) {
    case 64: return launch(std::integral_constant<int, 64>());
    case 96: return launch(std::integral_constant<int, 96>());
    case 128: return launch(std::integral_constant<int, 128>());
    case 256: return launch(std::integral_constant<int, 256>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// All pointers are contiguous device buffers, bf16 passed as void*: q, dout,
// dq (B, Lq, H, D); k, v, dk, dv (B, Lk, H, D); lse, di (B, H, Lq) f32. Lq,
// Lk multiples of 64; D in {64, 96, 128, 256}. Each launches on `stream` and
// returns a CUDA error code (0 on success).
extern "C" int flash_attn_bf16_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                              const float* lse, const void* dout,
                                              const float* di, void* dk, void* dv, int batch,
                                              int heads, int lq, int lk, int head_dim,
                                              float scale, void* stream) {
  if (int err = check_shape(batch, heads, lq, lk)) return err;
  return dispatch(head_dim, [&](auto d) {
    return launch_dkv<decltype(d)::value>((const bf16*)q, (const bf16*)k, (const bf16*)v, lse,
                                          (const bf16*)dout, di, (bf16*)dk, (bf16*)dv, batch,
                                          heads, lq, lk, scale, (cudaStream_t)stream);
  });
}

extern "C" int flash_attn_bf16_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const float* lse, const void* dout, const float* di,
                                             void* dq, int batch, int heads, int lq, int lk,
                                             int head_dim, float scale, void* stream) {
  if (int err = check_shape(batch, heads, lq, lk)) return err;
  return dispatch(head_dim, [&](auto d) {
    return launch_dq<decltype(d)::value>((const bf16*)q, (const bf16*)k, (const bf16*)v, lse,
                                         (const bf16*)dout, di, (bf16*)dq, batch, heads, lq, lk,
                                         scale, (cudaStream_t)stream);
  });
}
