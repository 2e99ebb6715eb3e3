// The three-way bf16 split of f32 operands for Hopper's bf16 tensor cores,
// shared by the f32 flash kernels (flash_attn_split_fwd.cu: K3;
// flash_attn_split_bwd.cu: K4, K5 and the split pass): an f32 value x is
// hi + mid + lo, three bf16 parts, each rounded to nearest even from an exact
// f32 difference, and a product A B is the six bf16 products lo hi, mid mid,
// hi lo, mid hi, hi mid, then hi hi, in one f32 accumulator. Here: the split
// in registers, split tiles in shared memory (three planes, plane after
// plane, each as sm90.cuh's swizzle atoms) loaded by TMA from the (3, B, L,
// H, D) planes, the six SS and RS products over them, the per-tile
// accumulator helpers, the f32 row store and the host's plane maps.
// Everything has internal linkage, as in sm90.cuh.

#pragma once

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kRows = 64;  // rows of a resident split tile (one warpgroup's wgmma M)
constexpr size_t kMaxSmem = 232448;  // per block, after cudaFuncSetAttribute

// The six products of the split, in order: (part of A, part of B), hi 0, mid
// 1, lo 2: lo hi, mid mid, hi lo, mid hi, hi mid, hi hi.
__host__ __device__ constexpr int part_a(int t) { return t == 0 ? 2 : (t == 1 || t == 3) ? 1 : 0; }
__host__ __device__ constexpr int part_b(int t) { return t == 2 ? 2 : (t == 1 || t == 4) ? 1 : 0; }

// One tensor map per plane of a (3, B, L, H, D) bf16 tensor.
struct Planes {
  CUtensorMap p[3];
};

// ---------------------------------------------------------------- split --
__device__ __forceinline__ float bf16_low(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_high(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

// x0, x1 as three bf16 pairs (x0 in the low halves): hi, mid, lo.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  x0 -= bf16_low(hi);
  x1 -= bf16_high(hi);
  mid = pack_bf16(x0, x1);
  x0 -= bf16_low(mid);
  x1 -= bf16_high(mid);
  lo = pack_bf16(x0, x1);
}

// An f32 accumulator split in order into three sets of bf16 pairs (elements
// 2i, 2i + 1): the three A operands of the next product along its columns.
template <int N>
__device__ __forceinline__ void split_rows(uint32_t (&p)[3][N / 2], const float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) split_pair(acc[2 * i], acc[2 * i + 1], p[0][i], p[1][i], p[2][i]);
}

// ------------------------------------------------------------- products --
// Rows [row0, row0 + R) of head h, batch b of the three planes into a split
// tile of R rows at dst (plane after plane): one TMA copy per plane and atom.
template <int D, int R>
__device__ __forceinline__ void load_split(uint32_t dst, const Planes& m, uint32_t bar, int h,
                                           int row0, int b) {
  using A = Atom<D>;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int a = 0; a < D / A::kCols; ++a)
      tma_load(dst + p * R * D * 2 + a * R * A::kRowBytes, &m.p[p], bar, a * A::kCols, h, row0, b);
}

// acc (64 x N, f32) = A B^T over the six split products, contracted over D:
// A the resident 64-row split tile at a, B the split tile of N rows at b,
// both K-major. Started, not fenced or committed.
template <int D, int N>
__device__ __forceinline__ void mma_ss_split(float (&acc)[N / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int t = 0; t < 6; ++t)
    mma_ss<D, N, kRows>(acc, a + part_a(t) * kRows * D * 2, b + part_b(t) * N * D * 2, t == 0);
}

// acc (64 x D, f32) += A B over the six split products: A (64 x K) in three
// parts of bf16 pairs in registers, B the K-row split tile at b, MN-major.
// Started, not fenced or committed.
template <int D, int K>
__device__ __forceinline__ void mma_rs_split(float (&acc)[D / 2], const uint32_t (&a)[3][K / 4],
                                             uint32_t b) {
#pragma unroll
  for (int t = 0; t < 6; ++t)
    mma_rs<D, D, K>(acc, a[part_a(t)], b + part_b(t) * K * D * 2, K * Atom<D>::kRowBytes);
}

template <int N>
__device__ __forceinline__ void zero_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
  fence_regs(r);
}

// acc += tile, f32 additions rounded to nearest: a tile's products, summed
// in their own zeroed accumulator, join the running sum.
template <int N>
__device__ __forceinline__ void add_tile(float (&acc)[N], float (&tile)[N]) {
  fence_regs(tile);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += tile[i];
}

template <int N>
__device__ __forceinline__ void fence_parts(uint32_t (&p)[3][N]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) fence_regs(p[i]);
}

// A warpgroup's 64 x D f32 accumulator into rows g and g + 8 of a (.., H, D)
// f32 tensor: `out` points at row g, column 2 quad; rows are `rs` apart.
template <int D>
__device__ __forceinline__ void store_rows_f32(float* out, size_t rs, const float (&acc)[D / 2]) {
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    *reinterpret_cast<float2*>(out + 8 * c) = make_float2(acc[4 * c], acc[4 * c + 1]);
    *reinterpret_cast<float2*>(out + 8 * rs + 8 * c) = make_float2(acc[4 * c + 2], acc[4 * c + 3]);
  }
}

// ------------------------------------------------------------------ host --
// One map per plane of a (3, B, L, H, D) bf16 tensor at `base`, boxes of
// `rows` rows (sm90.cuh's make_map).
template <int D>
int make_planes(Planes* m, const void* base, int batch, int len, int heads, int rows) {
  const size_t plane = (size_t)batch * len * heads * D * 2;
  for (int p = 0; p < 3; ++p)
    if (int err = make_map<D>(&m->p[p], static_cast<const char*>(base) + p * plane, batch, len,
                              heads, rows))
      return err;
  return 0;
}

// f(std::integral_constant<int, head_dim>) for a head dim the kernels take,
// else `otherwise`.
template <typename F>
int dispatch(int head_dim, int otherwise, F f) {
  switch (head_dim) {
    case 64: return f(std::integral_constant<int, 64>());
    case 96: return f(std::integral_constant<int, 96>());
    case 128: return f(std::integral_constant<int, 128>());
    case 256: return f(std::integral_constant<int, 256>());
    default: return otherwise;
  }
}

}  // namespace
