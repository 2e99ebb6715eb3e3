// Flash attention forward in bf16 for Hopper (kernel K3, with or without its
// row statistics): TMA-fed, warp-specialised, on wgmma. Built for sm_90a only.
//
// Replaces: the bf16 instances of upstream
// jax.experimental.pallas.ops.tpu.flash_attention._flash_attention_kernel that
// svdformer_pointsea_tpu/nn/flash_vjp.py enters at :153 (O only) and :160
// (O and the row statistics) when nn/layers.py::_scaled_attention casts q, k
// and v to bf16 (--precision bf16). Non-causal, no bias, no segment ids.
//
// What it computes, the upstream kernel's function on bf16 inputs:
//   S = (Q K^T) * scale in f32; online softmax in f32 (running max m, running
//   sum l of the f32 exponentials); P = exp(S - m_running) rounded to bf16
//   (nearest even) before P V, which accumulates in f32; O = acc / l rounded
//   to bf16; with statistics LSE = m + ln l in f32. The exponentials are
//   2^(S_raw * scale * log2 e - m2), one FFMA and one ex2.approx each, with m2
//   the running max in log2 units; LSE goes back to the natural log once, at
//   the end. O is the same with and without statistics: only the LSE store
//   differs.
//
// Layout: q, o (B, Lq, H, D); k, v (B, Lk, H, D), contiguous bf16 (the port's
// channels-last layout, read in place through 4-D tensor maps over (D, H, L,
// B)); lse (B, H, Lq) f32. Lq and Lk are multiples of 128; D is 64, 96, 128
// or 256.
//
// What bounds it on an H100: the tensor cores (989 TFLOP/s bf16 dense) for
// 4 B H Lq Lk D flops, and close behind them the exponentials: B H Lq Lk of
// them at 16 a clock per SM (MUFU) cost as much as the two products at dh 64.
//
// Design (the usual Hopper shape):
// - One CTA per (128-query tile, head, batch): warpgroups 0 and 1 are the
//   consumers, 64 query rows each; warpgroup 2 is the producer, of which one
//   thread starts every copy. setmaxnreg moves registers from the producer
//   (24 a thread) to the consumers (240).
// - TMA: Q is loaded once; K and V tiles of kBlockN keys go through a ring of
//   kStages stages with full (transaction-count) and empty (256 consumer
//   arrivals) mbarriers, K and V on barriers of their own, so that S = Q K^T
//   can start before V has landed.
// - Shared memory holds every tile as swizzle atoms of kAtomCols columns
//   (64 columns under the 128-byte swizzle; at D 96, whose 192-byte rows are
//   no whole number of 128-byte atoms, 32 columns under the 64-byte
//   swizzle), atom after atom, as the TMA box writes them; the wgmma
//   descriptors name the same swizzle.
// - S = Q K^T: wgmma m64nNk16 (N = kBlockN), both operands from shared
//   memory, K-major (K is stored [key][d]).
// - Softmax in registers, rows reduced across the quad by shuffles; each
//   thread keeps its partial row sum and reduces it once at the end.
// - O += P V: wgmma m64nDk16 with P from registers (the S accumulator packed
//   to bf16 pairs is the A fragment, in order) and V from shared memory
//   through the descriptor's transpose bit (MN-major: V is stored [key][d]).
// - Overlap within each consumer: tile j's S product is started before tile
//   j-1's P V, and tile j's softmax runs while that P V is in flight.
// - Overlap between the consumers (ping-pong): the two warpgroups take
//   turns, on a pair of named barriers, to start their products, so that one
//   warpgroup's softmax runs under the other's products. The exponentials
//   cost as much as the products at D 64; without the turns both
//   warpgroups reach their softmax together and the tensor cores idle.
// - Epilogue: O / l rounded to bf16 into the warpgroup's own (now unread) Q
//   rows of shared memory, in the swizzle of the O map, then one TMA store
//   per atom; LSE from registers when lse is not null.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockM = 128;   // query rows per CTA
constexpr int kConsumers = 2;  // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct Cfg {
  static constexpr int kAtomCols = D % 64 == 0 ? 64 : 32;  // columns of one swizzle atom
  static constexpr int kRowBytes = kAtomCols * 2;          // = the swizzle span, 128 or 64
  static constexpr int kBlockN = D == 256 ? 64 : 128;      // keys per tile
  static constexpr int kStages = D == 64 ? 4 : (D == 96 ? 3 : 2);
  static constexpr uint32_t kQBytes = kBlockM * D * 2;
  static constexpr uint32_t kTileBytes = kBlockN * D * 2;  // one K or one V tile
  static constexpr int kBars = 1 + 4 * kStages;            // Q; full K, V; empty K, V
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes + 8 * kBars;
  static_assert(kSmem <= 232448, "shared memory per block");
};

// ------------------------------------------------------------ PTX helpers --
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

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

// --------------------------------------------------------- wgmma wrappers --
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
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, acc);
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
// byte offset (K-major: unused, 16; MN-major: the stride from one atom of
// kAtomCols columns to the next), stride byte offset (8 rows of an atom) and
// the swizzle mode (1: 128-byte, 2: 64-byte).
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  using C = Cfg<D>;
  constexpr uint64_t mode = C::kRowBytes == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((8 * C::kRowBytes) >> 4) << 32) | (mode << 62);
}

// Byte offset of (row, byte) in a tile of swizzle atoms whose rows are
// kRowBytes long: the 16-byte chunk index XOR the row's bits above it, as the
// TMA box writes it (128-byte swizzle: chunk ^ row % 8; 64-byte: chunk ^
// (row / 2) % 4).
template <int D>
__device__ __forceinline__ uint32_t swizzle(uint32_t row, uint32_t byte) {
  constexpr uint32_t mask = Cfg<D>::kRowBytes / 16 - 1;
  const uint32_t off = row * Cfg<D>::kRowBytes + byte;
  return off ^ (((off >> 7) & mask) << 4);
}

// s (this warpgroup's 64 rows x kBlockN keys, f32) = Q K^T over D, started and
// committed as one group. q: the warpgroup's first Q row in atom 0; k: the
// stage's K tile.
template <int D>
__device__ __forceinline__ void start_qk(float (&s)[Cfg<D>::kBlockN / 2], uint32_t q, uint32_t k) {
  using C = Cfg<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t atom = kk * 16 / C::kAtomCols, col_bytes = (kk * 16 % C::kAtomCols) * 2;
    wgmma_ss<C::kBlockN>(s, make_desc<D>(q + atom * kBlockM * C::kRowBytes + col_bytes, 16),
                         make_desc<D>(k + atom * C::kBlockN * C::kRowBytes + col_bytes, 16),
                         kk > 0);
  }
  wgmma_commit();
}

// o (64 rows x D, f32) += P V, P (64 x kBlockN, bf16 pairs in registers),
// started and committed as one group; v: the stage's V tile.
template <int D>
__device__ __forceinline__ void start_pv(float (&o)[D / 2], const uint32_t (&p)[Cfg<D>::kBlockN / 4],
                                         uint32_t v) {
  using C = Cfg<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::kBlockN / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_rs<D>(o, a, make_desc<D>(v + kk * 16 * C::kRowBytes, C::kBlockN * C::kRowBytes));
  }
  wgmma_commit();
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                 float* __restrict__ lse, int lq, int lk, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BN = C::kBlockN, S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms repeat every 1024 bytes
  const uint32_t sQ = base, sK = sQ + C::kQBytes, sV = sK + S * C::kTileBytes;
  const uint32_t bars = sV + S * C::kTileBytes;  // 8 bytes each
  const uint32_t bar_q = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + S + s); };
  auto empty_k = [&](int s) { return bars + 8 * (1 + 2 * S + s); };
  auto empty_v = [&](int s) { return bars + 8 * (1 + 3 * S + s); };

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = lk / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 128 * kConsumers);
      mbar_init(empty_v(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      mbar_expect_tx(bar_q, C::kQBytes);
      for (int a = 0; a < D / C::kAtomCols; ++a)
        tma_load(sQ + a * kBlockM * C::kRowBytes, &tm_q, bar_q, a * C::kAtomCols, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        const uint32_t phase = ((j / S) & 1) ^ 1;  // the first round finds every stage empty
        mbar_wait(empty_k(s), phase);
        mbar_expect_tx(full_k(s), C::kTileBytes);
        for (int a = 0; a < D / C::kAtomCols; ++a)
          tma_load(sK + s * C::kTileBytes + a * BN * C::kRowBytes, &tm_k, full_k(s),
                   a * C::kAtomCols, h, j * BN, b);
        mbar_wait(empty_v(s), phase);
        mbar_expect_tx(full_v(s), C::kTileBytes);
        for (int a = 0; a < D / C::kAtomCols; ++a)
          tma_load(sV + s * C::kTileBytes + a * BN * C::kRowBytes, &tm_v, full_v(s),
                   a * C::kAtomCols, h, j * BN, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const uint32_t q_wg = sQ + wg * 64 * C::kRowBytes;  // this warpgroup's rows, atom 0

    float o[D / 2], s[BN / 2], m2[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
    float alpha[2];
    uint32_t p[BN / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    // Ping-pong: the two consumer warpgroups take turns to start their
    // products (named barrier 3 + wg of 256 threads: this warpgroup's sync,
    // the other's arrive), so that one's softmax runs under the other's
    // products. Warpgroup 0 goes first; each takes n_tiles + 1 turns.
    const uint32_t my_turn = 3 + wg, other_turn = 3 + (wg ^ 1);
    auto wait_turn = [&] { asm volatile("bar.sync %0, 256;\n" ::"r"(my_turn) : "memory"); };
    auto pass_turn = [&] { asm volatile("bar.arrive %0, 256;\n" ::"r"(other_turn) : "memory"); };
    if (wg == 1) pass_turn();

    mbar_wait(bar_q, 0);
    mbar_wait(full_k(0), 0);
    wait_turn();
    start_qk<D>(s, q_wg, sK);
    pass_turn();
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(empty_k(0));
    online_softmax(s, m2, l, alpha, scale_log2);
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);

    for (int j = 1; j < n_tiles; ++j) {
      const int sj = j % S, sp = (j - 1) % S;
      mbar_wait(full_k(sj), (j / S) & 1);
      mbar_wait(full_v(sp), ((j - 1) / S) & 1);
      wait_turn();
      start_qk<D>(s, q_wg, sK + sj * C::kTileBytes);  // tile j's scores ...
      fence_regs(o);
      start_pv<D>(o, p, sV + sp * C::kTileBytes);  // ... while tile j-1's P V follows
      pass_turn();
      wgmma_wait<1>();
      fence_regs(s);
      mbar_arrive(empty_k(sj));
      online_softmax(s, m2, l, alpha, scale_log2);  // overlaps the P V in flight
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      mbar_arrive(empty_v(sp));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    }
    const int sl = (n_tiles - 1) % S;
    mbar_wait(full_v(sl), ((n_tiles - 1) / S) & 1);
    wait_turn();
    fence_regs(o);
    start_pv<D>(o, p, sV + sl * C::kTileBytes);
    if (wg == 0) pass_turn();  // warpgroup 1 has no turn left to wait for
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty_v(sl));

    // Epilogue: O / l as bf16 into this warpgroup's Q rows (no longer read),
    // then a TMA store per atom; LSE from registers.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = 1.f / l[r];
    }
    const uint32_t g = warp * 16 + lane / 4;  // row within the warpgroup; g + 8
    uint8_t* smem_q = smem_raw + (q_wg - raw);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const uint32_t col = c * 8 + 2 * (lane % 4);
      const uint32_t atom = col / C::kAtomCols, byte = (col % C::kAtomCols) * 2;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(smem_q + atom * kBlockM * C::kRowBytes +
                                     swizzle<D>(g + 8 * r, byte)) =
            pack_bf16(o[4 * c + 2 * r] * inv[r], o[4 * c + 2 * r + 1] * inv[r]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (t == 0) {
      for (int a = 0; a < D / C::kAtomCols; ++a)
        tma_store(&tm_o, q_wg + a * kBlockM * C::kRowBytes, a * C::kAtomCols, h, q0 + wg * 64, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    if (lse != nullptr && lane % 4 == 0) {  // the quad's lanes hold the same m2, l
      constexpr float kLn2 = 0.69314718055994531f;
      float* out = lse + ((size_t)b * gridDim.y + h) * lq + q0 + wg * 64 + g;
      out[0] = m2[0] * kLn2 + logf(l[0]);
      out[8] = m2[1] * kLn2 + logf(l[1]);
    }
    if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

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
  using C = Cfg<D>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)len, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)len * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::kAtomCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      C::kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
               int heads, int lq, int lk, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv, to;
  if (int err = make_map<D>(&tq, q, batch, lq, heads, kBlockM)) return err;
  if (int err = make_map<D>(&tk, k, batch, lk, heads, C::kBlockN)) return err;
  if (int err = make_map<D>(&tv, v, batch, lk, heads, C::kBlockN)) return err;
  if (int err = make_map<D>(&to, o, batch, lq, heads, 64)) return err;
  if (int err = (int)cudaFuncSetAttribute(wgmma_fwd_kernel<D>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)C::kSmem))
    return err;
  constexpr float kLog2e = 1.4426950408889634f;
  wgmma_fwd_kernel<D><<<dim3(lq / kBlockM, heads, batch), kThreads, C::kSmem, stream>>>(
      tq, tk, tv, to, lse, lq, lk, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o (B, Lq, H, D) and k, v (B, Lk, H, D): contiguous bf16 device buffers,
// 16-byte aligned, passed as void*; lse (B, H, Lq) f32 or null (no
// statistics). Lq, Lk multiples of 128; D in {64, 96, 128, 256}. Launches on
// `stream` and returns a CUDA error code (0 on success).
extern "C" int flash_attn_bf16_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                          float* lse, int batch, int heads, int lq, int lk,
                                          int head_dim, float scale, void* stream) {
  if (lq <= 0 || lk <= 0 || lq % kBlockM != 0 || lk % kBlockM != 0 || batch <= 0 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (head_dim) {
    case 64: return launch_fwd<64>(q, k, v, o, lse, batch, heads, lq, lk, scale, s);
    case 96: return launch_fwd<96>(q, k, v, o, lse, batch, heads, lq, lk, scale, s);
    case 128: return launch_fwd<128>(q, k, v, o, lse, batch, heads, lq, lk, scale, s);
    case 256: return launch_fwd<256>(q, k, v, o, lse, batch, heads, lq, lk, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

