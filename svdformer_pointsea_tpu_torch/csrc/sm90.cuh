// Hopper (sm_90a) building blocks shared by the flash kernels on the tensor
// cores (flash_attn_bf16_fwd.cu: the bf16 K3; flash_attn_bf16_bwd.cu: the
// bf16 K4 and K5; flash_attn_split_fwd.cu and flash_attn_split_bwd.cu: the
// f32 K3, K4 and K5 on split bf16 planes, through split.cuh): TMA and bulk
// copies (on the mbarriers of cluster.cuh), wgmma and its shared-memory
// descriptors over tiles of
// swizzle atoms, the forward's online softmax, the backward's dS from the scores,
// and the 4-D tensor maps over the port's channels-last (B, L, H, D) layout. Everything has internal linkage: each source that
// includes it is built into a library of its own.
//
// Tiles in shared memory: a tile of R rows and D bf16 columns is stored as
// D / Atom<D>::kCols swizzle atoms, atom after atom, each R rows of kRowBytes
// (64 columns under the 128-byte swizzle; at D 96, whose 192-byte rows are no
// whole number of 128-byte atoms, 32 columns under the 64-byte swizzle), as a
// TMA box of (kCols, 1, R, 1) writes it. Tiles start on 1024-byte boundaries.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cluster.cuh"  // smem_u32 and the mbarrier helpers

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Atom {
  static constexpr int kCols = D % 64 == 0 ? 64 : 32;  // columns of one swizzle atom
  static constexpr int kRowBytes = kCols * 2;          // = the swizzle span, 128 or 64
};

// ------------------------------------------------------------ PTX helpers --
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma operand registers
// across the points where the asynchronous products start and are waited for.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 rounded to nearest even into one bf16 pair, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A contiguous copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// --------------------------------------------------------- wgmma wrappers --
// d (m64n16, f32) {=, +=} A (64 x 16, smem desc) * B (16 x 16, smem desc), both K-major.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64n32, f32) {=, +=} A (64 x 16, smem desc) * B (16 x 32, smem desc), both K-major.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64n64, f32) {=, +=} A (64 x 16, smem desc) * B (16 x 64, smem desc), both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64n128, f32) {=, +=} A (64 x 16, smem desc) * B (16 x 128, smem desc), both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (m64n64, f32) += A (64 x 16 bf16, registers) * B (16 x 64, smem desc, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n96, f32) += A (64 x 16 bf16, registers) * B (16 x 96, smem desc, MN-major).
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n128, f32) += A (64 x 16 bf16, registers) * B (16 x 128, smem desc, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (m64n256, f32) += A (64 x 16 bf16, registers) * B (16 x 256, smem desc, MN-major).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 16) wgmma_ss_n16(d, a, b, acc);
  else if constexpr (N == 32) wgmma_ss_n32(d, a, b, acc);
  else if constexpr (N == 64) wgmma_ss_n64(d, a, b, acc);
  else wgmma_ss_n128(d, a, b, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, b);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, b);
  else wgmma_rs_n256(d, a, b);
}

// Shared-memory matrix descriptor of a swizzled tile: start address, leading
// byte offset (K-major: unused, 16; MN-major: the stride from one atom to the
// next), stride byte offset (8 rows of an atom) and the swizzle mode (1:
// 128-byte, 2: 64-byte).
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  constexpr uint64_t mode = Atom<D>::kRowBytes == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((8 * Atom<D>::kRowBytes) >> 4) << 32) | (mode << 62);
}

// Byte offset of (row, byte) in an atom whose rows are kRowBytes long: the
// 16-byte chunk index XOR the row's bits above it, as the TMA box writes it
// (128-byte swizzle: chunk ^ row % 8; 64-byte: chunk ^ (row / 2) % 4).
template <int D>
__device__ __forceinline__ uint32_t swizzle(uint32_t row, uint32_t byte) {
  constexpr uint32_t mask = Atom<D>::kRowBytes / 16 - 1;
  const uint32_t off = row * Atom<D>::kRowBytes + byte;
  return off ^ (((off >> 7) & mask) << 4);
}

// acc (64 x N, f32) = A B^T (or += with `zero` false), contracted over D,
// both operands K-major in shared memory: A the 64 rows from `a` on (atom 0)
// of a tile of ARows rows, B a tile of N rows at `b`. Started, not fenced or
// committed.
template <int D, int N, int ARows>
__device__ __forceinline__ void mma_ss(float (&acc)[N / 2], uint32_t a, uint32_t b,
                                       bool zero = true) {
  using A = Atom<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t atom = kk * 16 / A::kCols, col_bytes = (kk * 16 % A::kCols) * 2;
    wgmma_ss<N>(acc, make_desc<D>(a + atom * ARows * A::kRowBytes + col_bytes, 16),
                make_desc<D>(b + atom * N * A::kRowBytes + col_bytes, 16), kk > 0 || !zero);
  }
}

// acc (64 x N, f32) += A B: A (64 x K, bf16 pairs in registers, an
// accumulator's order: element pairs along its rows), B the K rows from `b`
// on of a tile whose N columns (from `b`'s atom on) are MN-major: stored
// [k][n], its atoms `atom_stride` bytes apart. Started, not fenced or committed.
template <int D, int N, int K>
__device__ __forceinline__ void mma_rs(float (&acc)[N / 2], const uint32_t (&a)[K / 4], uint32_t b,
                                         uint32_t atom_stride) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t frag[4] = {a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3]};
    wgmma_rs<N>(acc, frag, make_desc<D>(b + kk * 16 * Atom<D>::kRowBytes, atom_stride));
  }
}

// An f32 accumulator packed in order into bf16 pairs (elements 2i, 2i + 1):
// the A operand of the next product along the accumulator's columns.
template <int N>
__device__ __forceinline__ void pack_rows(uint32_t (&p)[N / 2], const float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) p[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
}

// Writes a warpgroup's 64 x D f32 accumulator, times mul[r] on its row half
// r (rows g, g + 8), as bf16 into the warpgroup's 64 rows of a tile of ARows
// rows (`tile`: its first row, atom 0) in the tile's swizzle, ready for one
// TMA store per atom.
template <int D, int ARows>
__device__ __forceinline__ void stage_rows(uint8_t* tile, const float (&acc)[D / 2],
                                           const float (&mul)[2], int warp, int lane) {
  using A = Atom<D>;
  const uint32_t g = warp * 16 + lane / 4;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint32_t col = c * 8 + 2 * (lane % 4);
    const uint32_t atom = col / A::kCols, byte = (col % A::kCols) * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(tile + atom * ARows * A::kRowBytes + swizzle<D>(g + 8 * r, byte)) =
          pack_bf16(acc[4 * c + 2 * r] * mul[r], acc[4 * c + 2 * r + 1] * mul[r]);
  }
}

// Online softmax over one tile of raw scores s (accumulator layout: elements
// 4i, 4i+1 of row g, 4i+2, 4i+3 of row g+8): m2 the running max in log2
// units, l this thread's running partial sums, alpha the factor that carries
// the accumulator to the new max; s becomes the f32 exponentials.
template <int N>
__device__ __forceinline__ void online_softmax(float (&s)[N], float (&m2)[2], float (&l)[2],
                                               float (&alpha)[2], float scale_log2) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m2[r], quad_max(mx[r]) * scale_log2);  // scale > 0
    alpha[r] = ex2(m2[r] - m_new);  // ex2(-inf) = 0 on the first tile
    m2[r] = m_new;
    neg_m[r] = -m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = ex2(fmaf(s[i], scale_log2, neg_m[r]));
    sum[r] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// dp (accumulator layout: elements 4i, 4i+1 of row g, 4i+2, 4i+3 of row
// g+8) becomes dS = (dP - di) P scale in f32, P = 2^(s scale log2 e - lse
// log2 e) from the raw scores s, with neg_lse2 = -lse log2 e and di per row.
template <int N>
__device__ __forceinline__ void ds_by_rows(const float (&s)[N], float (&dp)[N],
                                           const float (&neg_lse2)[2], const float (&di)[2],
                                           float scale_log2, float scale) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2(fmaf(s[i], scale_log2, neg_lse2[r]));
    dp[i] = (dp[i] - di[r]) * p * scale;
  }
}

// The same for S^T and dP^T, whose columns are queries (columns 8c + 2 quad
// and + 1 hold elements 4c, 4c+2 and 4c+1, 4c+3): lse and di come from the
// stage's slices in shared memory. s becomes P^T and dp dS^T, both f32.
template <int N>
__device__ __forceinline__ void ds_by_cols(float (&s)[N], float (&dp)[N], const float* lse,
                                           const float* di, int quad, float scale_log2,
                                           float scale) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * c + 2 * quad);
    const float2 d = *reinterpret_cast<const float2*>(di + 8 * c + 2 * quad);
    const float neg_lse2[2] = {-l.x * kLog2e, -l.y * kLog2e}, di_c[2] = {d.x, d.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * c + e, col = e & 1;
      s[i] = ex2(fmaf(s[i], scale_log2, neg_lse2[col]));
      dp[i] = (dp[i] - di_c[col]) * s[i] * scale;
    }
  }
}

// Ping-pong of two consumer warpgroups (named barriers 3 + wg of 256
// threads: this warpgroup's sync, the other's arrive): they take turns to
// start their products, so that one's softmax runs under the other's.
// Warpgroup 1 arrives first, so warpgroup 0 takes the first turn; both take
// the same number of turns, and warpgroup 1 does not pass its last.
struct PingPong {
  uint32_t mine, other;
  __device__ __forceinline__ explicit PingPong(int wg) : mine(3 + wg), other(3 + (wg ^ 1)) {
    if (wg == 1) pass();
  }
  __device__ __forceinline__ void wait() const {
    asm volatile("bar.sync %0, 256;\n" ::"r"(mine) : "memory");
  }
  __device__ __forceinline__ void pass() const {
    asm volatile("bar.arrive %0, 256;\n" ::"r"(other) : "memory");
  }
};

// ------------------------------------------------------------------ host --
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime: no -lcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess)
      return EncodeTiled(nullptr);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
        cudaSuccess)
      return EncodeTiled(nullptr);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr)
                                                : EncodeTiled(nullptr);
  }();
  return fn;
}

// A 4-D map over a contiguous (B, L, H, D) bf16 tensor, innermost first
// (D, H, L, B), whose box is (atom columns, 1 head, `rows` rows, 1 batch).
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int batch, int len, int heads, int rows) {
  using A = Atom<D>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)len * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)A::kCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      A::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
