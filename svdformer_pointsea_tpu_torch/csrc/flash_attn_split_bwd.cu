// Flash attention backward in f32 for Hopper on the bf16 tensor cores: dQ
// (kernel K5) and dK / dV (kernel K4), with f32 accuracy from a three-way bf16
// split of every operand, and the split pass that makes the planes. TMA-fed,
// warp-specialised, on wgmma. Built for sm_90a only.
//
// Replaces: the f32 Pallas kernels that svdformer_pointsea_tpu/nn/
// flash_vjp.py::_bwd runs for flash_attention_di128: upstream
// jax.experimental.pallas.ops.tpu.flash_attention._flash_attention_bwd_dkv
// (flash_attention.py:941, kernel :796; called at flash_vjp.py:171) for dK
// and dV, and flash_vjp.py::_bwd_dq_di128 (:49, pallas_call :109) for dQ.
// Non-causal, no bias, no segment ids.
//
// What they compute, in f32, from the forward's LSE and di = rowsum(O * dO):
//   S = Q K^T and dP = dO V^T; P = exp(S scale - LSE); dS = P (dP - di);
//   K5: dQ = scale dS K;  K4: dV = P^T dO, dK = scale dS^T Q.
// P is 2^(S scale log2 e - LSE log2 e), one FFMA and one ex2.approx, and the
// scale goes into dS before its products, as in the bf16 kernels.
//
// The split: an f32 value x becomes three bf16 parts, hi = bf16(x), mid =
// bf16(x - hi), lo = bf16(x - hi - mid), each rounded to nearest even from
// an f32 difference. The differences are exact, so hi + mid + lo == x for
// normal x. A product A B is the six bf16 products lo hi, mid mid, hi lo,
// mid hi, hi mid and hi hi (the dropped mid lo, lo mid and lo lo are below
// 2^-24 of it) in one f32 accumulator: the five corrections first, over the
// whole contraction, then hi hi, so that the small terms are summed while
// the accumulator is small (CUTLASS orders its 3xTF32 terms so). q, k, v and
// dO are split by split_bf16x3_kernel into (3, B, L, H, D) planes, read with
// 16-byte accesses and written with 16-byte stores; P and dS are formed in
// f32 in registers and split there into three A fragments each. Nothing but
// the parts is rounded to bf16; the outputs are f32. Why not 3xTF32: wgmma
// takes tf32 operands K-major only (its transpose bit is for 16-bit types),
// and three of the five products read an MN-major operand (dO and Q in K4's
// dV and dK, K in K5's dQ); a tf32 value with its residual also takes 8
// bytes of shared memory, a split one 6.
//
// Layout: q, dout, dq (B, Lq, H, D); k, v, dk, dv (B, Lk, H, D); the planes
// of q, k, v and dout (3, B, L, H, D) bf16, read in place through one 4-D
// tensor map per plane over (D, H, L, B); lse, di (B, H, Lq) f32, 16-byte
// aligned. Lq and Lk are multiples of 64; D is 64, 96, 128 or 256.
//
// What bounds them on an H100: the tensor cores. Six bf16 products at 989
// TFLOP/s dense are 164.8 TFLOP/s for the f32 function: K5 does 6 and K4 8
// B H Lq Lk D flops of it. The split pass is bound by bytes: 4 read and 6
// written per value.
//
// Design (the bf16 backward's, flash_attn_bf16_bwd.cu, on the parts of
// sm90.cuh and split.cuh), shaped by shared memory: three planes triple every tile. One
// CTA holds 64 resident rows in three planes, queries (Q, dO) in K5 and keys
// (K, V) in K4, loaded once; the other operand comes as tiles of kBlockN rows
// through a ring of slots, one operand tile a slot, with full and empty
// mbarriers, filled by one thread of a producer warpgroup. The score
// products are SS wgmma, K-major; P and dS in registers, split, are the
// register A operands of the accumulating products, whose B operand is read
// MN-major through the descriptor's transpose bit, so that no transpose ever
// exists in memory. Two consumer warpgroups (setmaxnreg 24 / 240) take turns
// to start their products (ping-pong), so that one's exponentials and splits
// run under the other's products; every wait for data happens outside a
// turn. No atomics: every output element is summed by one thread in a fixed
// order, so a repeat gives the same bits.
// - K5, one CTA per (64 queries, head, batch): V_j, then K_j; dP = dO V^T,
//   S = Q K^T; lse and di of a thread's two rows in registers; dQ += dS K, K
//   MN-major. At D 64, 96, 128 the two warpgroups work over the same 64
//   queries and take the key tiles in turn (tile j to warpgroup j % 2), each
//   with slots of its own (their count a multiple of 4) and its own f32
//   partial dQ; at the end the second's partial goes through the ring's
//   shared memory and the first adds it, in that order. A tile takes two
//   turns: the two score products, then dS K.
// - K4, one CTA per (64 keys, head, batch): Q_j with its lse and di slices
//   (bulk copies into the slot's vectors: they vary along the columns of
//   S^T), then dO_j. At D 64, 96, 128 both warpgroups take every tile and
//   split the outputs: warpgroup 0 forms S^T = K Q^T, P^T and dV += P^T dO;
//   warpgroup 1 dP^T = V dO^T, and dS^T = P^T (dP^T - di) scale with
//   warpgroup 0's P^T, passed through a pair of f32 buffers in shared memory
//   with full / empty mbarriers, and dK += dS^T Q. So each holds one output
//   (64 f32 a thread at D 128) beside a tile accumulator, and the products
//   are not repeated; a tile takes each warpgroup two turns.
// - D 256: 64 rows of three planes are 96 KB an operand, so the two
//   resident operands take 192 KB and the ring one slot of 16 rows (m64n16
//   scores), and one consumer warpgroup does the work. K5 frees each V_j
//   before its K_j comes. K4 makes two passes over the query tiles, dV (Q,
//   then dO) and dK (dO, then Q), each with its 256 accumulator columns, S^T
//   recomputed.
//
// The accumulator. The five correction products share one wgmma
// accumulator with hi hi, before it: over one tile the result is as close to
// an f64 backward as the plain f32 one, so the corrections are not lost. A
// sum carried over many tiles in a wgmma accumulator drifts further (each
// wgmma step rounds the running sum, twelve steps a tile), so at D 64-128
// each tile's accumulating products go into a zeroed accumulator, which is
// added to the running dQ, dK or dV in f32 once a tile (PERF.md has the
// errors with and without). At D 256 (not on the model's path) there are no
// registers for it and the sum stays in the wgmma accumulator.
//
// Dynamic shared memory (bytes, from the configs below; 1024 of them for
// alignment): K5 148,616 / 222,344 / 197,704 / 222,232 and K4 167,080 /
// 203,400 / 215,144 / 222,360 at D 64 / 96 / 128 / 256, of 232,448.

#include <algorithm>

#include "split.cuh"

namespace {

constexpr int kThreads = 384;  // two consumer warpgroups and a producer
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// The ring and the resident rows of one kernel at head dim D.
template <int D>
struct RingCfg {
  static constexpr bool kWide = D == 256;
  static constexpr int kBlockN = kWide ? 16 : 32;                 // rows of a streamed tile
  static constexpr uint32_t kResPlane = kRows * D * 2;            // one plane of 64 resident rows
  static constexpr uint32_t kRes = 3 * kResPlane;
  static constexpr uint32_t kSlotPlane = kBlockN * D * 2;         // one plane of a streamed tile
  static constexpr uint32_t kSlot = 3 * kSlotPlane;
};

// K5: Q and dO resident; V_j, K_j through the ring, tile j to warpgroup
// j % 2, each warpgroup with slots of its own.
template <int D>
struct DqCfg : RingCfg<D> {
  using R = RingCfg<D>;
  static constexpr int kConsumers = R::kWide ? 1 : 2;
  static constexpr int kSlots = R::kWide ? 1 : D == 128 ? 4 : 8;
  static constexpr int kBars = 1 + 2 * kSlots;  // resident rows; full, empty
  static constexpr size_t kSmem = 1024 + 2 * R::kRes + kSlots * R::kSlot + 8 * kBars;
  static_assert(kSmem <= kMaxSmem, "shared memory per block");
  static_assert(kConsumers == 1 || kSlots % 4 == 0, "each warpgroup needs slots of its own");
  static_assert(kConsumers == 1 || kSlots * R::kSlot >= kRows * D * 4,
                "the ring holds the second warpgroup's dQ");
};

// K4: K and V resident; Q_j with its lse and di slices, dO_j through the
// ring, every tile to both warpgroups (D <= 128: warpgroup 0 makes P^T and
// dV, warpgroup 1 dP^T, dS^T and dK, P^T passing through kPBuf buffers).
template <int D>
struct DkvCfg : RingCfg<D> {
  using R = RingCfg<D>;
  static constexpr int kSlots = R::kWide ? 1 : D == 64 ? 8 : D == 96 ? 6 : 4;
  static constexpr uint32_t kVec = R::kBlockN * 4;                   // one lse or di slice
  static constexpr int kPBuf = R::kWide ? 0 : 2;
  static constexpr uint32_t kPBytes = kRows * R::kBlockN * 4;        // one P^T tile, f32
  static constexpr int kBars = 1 + 2 * kSlots + 2 * kPBuf;           // ...; P^T full, empty
  static constexpr size_t kSmem = 1024 + 2 * R::kRes + kSlots * (R::kSlot + 2 * kVec) +
                                  kPBuf * kPBytes + 8 * kBars;
  static_assert(kSmem <= kMaxSmem, "shared memory per block");
};

// x (n8 runs of 8 f32) into three planes of n8 runs of 8 bf16: hi, mid, lo.
__global__ void __launch_bounds__(256) split_bf16x3_kernel(const float4* __restrict__ x,
                                                           uint4* __restrict__ out, size_t n8) {
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < n8; i += (size_t)gridDim.x * 256) {
    const float4 a = x[2 * i], c = x[2 * i + 1];
    uint4 hi, mid, lo;
    split_pair(a.x, a.y, hi.x, mid.x, lo.x);
    split_pair(a.z, a.w, hi.y, mid.y, lo.y);
    split_pair(c.x, c.y, hi.z, mid.z, lo.z);
    split_pair(c.z, c.w, hi.w, mid.w, lo.w);
    out[i] = hi;
    out[n8 + i] = mid;
    out[2 * n8 + i] = lo;
  }
}

// P^T from S^T whose columns are queries, as ds_by_cols forms it (lse from the
// slot's slice in shared memory).
template <int N>
__device__ __forceinline__ void p_by_cols(float (&s)[N], const float* lse, int quad,
                                          float scale_log2) {
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * c + 2 * quad);
    const float neg_lse2[2] = {-l.x * kLog2e, -l.y * kLog2e};
#pragma unroll
    for (int e = 0; e < 4; ++e) s[4 * c + e] = ex2(fmaf(s[4 * c + e], scale_log2, neg_lse2[e & 1]));
  }
}

// The two consumer warpgroups' partial sums of one accumulator, warpgroup 0's
// plus warpgroup 1's, through `part` (shared memory no copy uses any more),
// into warpgroup 0's; true in warpgroup 0, which then holds the sum.
template <int N>
__device__ __forceinline__ bool add_partials(float* part, int wg, int t, float (&acc)[N]) {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both are done with `part`
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) part[i * 128 + t] = acc[i];
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  if (wg == 1) return false;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] += part[i * 128 + t];
  return true;
}

// ---------------------------------------------------------------- K5 ------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
split_bwd_dq_kernel(const __grid_constant__ Planes tm_q, const __grid_constant__ Planes tm_k,
                    const __grid_constant__ Planes tm_v, const __grid_constant__ Planes tm_do,
                    const float* __restrict__ lse, const float* __restrict__ di,
                    float* __restrict__ dq, int lq, int lk, float scale, float scale_log2) {
  using C = DqCfg<D>;
  constexpr int BN = C::kBlockN, S = C::kSlots, NC = C::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms repeat every 1024 bytes
  const uint32_t sQ = base, sdO = sQ + C::kRes, ring = sdO + C::kRes;
  const uint32_t bars = ring + S * C::kSlot;  // 8 bytes each
  auto slot = [&](int s) { return ring + s * C::kSlot; };
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + S + s); };

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = lk / BN;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      mbar_expect_tx(bars, 2 * C::kRes);
      load_split<D, kRows>(sQ, tm_q, bars, h, q0, b);
      load_split<D, kRows>(sdO, tm_do, bars, h, q0, b);
      for (int i = 0; i < 2 * n_tiles; ++i) {  // V_j, then K_j
        const int s = i % S;
        mbar_wait(empty(s), ((i / S) & 1) ^ 1);  // the first round finds every slot empty
        mbar_expect_tx(full(s), C::kSlot);
        load_split<D, BN>(slot(s), i % 2 ? tm_k : tm_v, full(s), h, (i / 2) * BN, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    if (wg >= NC) return;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const size_t row = ((size_t)b * gridDim.y + h) * lq + q0 + warp * 16 + lane / 4;
    const float neg_lse2[2] = {-lse[row] * kLog2e, -lse[row + 8] * kLog2e};
    const float di_r[2] = {di[row], di[row + 8]};

    float acc[D / 2], s[BN / 2], dp[BN / 2];
    uint32_t ds[3][BN / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // D <= 128: each tile's dS K goes into a zeroed accumulator, added to
    // dQ in f32 (see "The accumulator" above); at D 256 there is no room.
    float tile[C::kWide ? 1 : D / 2];

    // Ping-pong (two consumers): warpgroup 0 goes first; each takes n_tiles turns.
    const PingPong turn(wg);
    mbar_wait(bars, 0);
    for (int j = wg; j < n_tiles; j += NC) {
      const int iv = 2 * j, ik = iv + 1, sv = iv % S, sk = ik % S;
      mbar_wait(full(sv), (iv / S) & 1);
      if constexpr (NC == 2) turn.wait();
      wgmma_fence();
      mma_ss_split<D, BN>(dp, sdO, slot(sv));  // dP = dO V^T
      if constexpr (S == 1) {  // one slot: V_j leaves before K_j comes
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dp);
        mbar_arrive(empty(sv));
      }
      mbar_wait(full(sk), (ik / S) & 1);
      wgmma_fence();
      mma_ss_split<D, BN>(s, sQ, slot(sk));  // S = Q K^T
      wgmma_commit();
      if constexpr (NC == 2) turn.pass();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if constexpr (S > 1) mbar_arrive(empty(sv));
      ds_by_rows(s, dp, neg_lse2, di_r, scale_log2, scale);
      split_rows<BN / 2>(ds, dp);
      if constexpr (!C::kWide) zero_regs(tile);
      if constexpr (NC == 2) turn.wait();
      wgmma_fence();
      if constexpr (C::kWide) {
        fence_regs(acc);
        mma_rs_split<D, BN>(acc, ds, slot(sk));  // dQ += dS K
      } else {
        mma_rs_split<D, BN>(tile, ds, slot(sk));  // dQ += dS K
      }
      wgmma_commit();
      if constexpr (NC == 2) {
        if (wg == 0 || j + NC < n_tiles) turn.pass();  // warpgroup 1 does not pass its last
      }
      wgmma_wait<0>();
      if constexpr (!C::kWide) add_tile(acc, tile);
      fence_regs(acc);
      fence_parts(ds);
      mbar_arrive(empty(sk));
    }

    if constexpr (NC == 2) {
      if (!add_partials(reinterpret_cast<float*>(smem_raw + (ring - raw)), wg, t, acc)) return;
    }
    const size_t rs = (size_t)gridDim.y * D;  // elements from one query's row to the next
    store_rows_f32<D>(dq + ((size_t)b * lq + q0 + warp * 16 + lane / 4) * rs + (size_t)h * D +
                          2 * (lane % 4),
                      rs, acc);
  }
}

// ---------------------------------------------------------------- K4 ------
// Whether item i of K4's ring is Q_j (with its lse and di slices) or dO_j:
// Q, dO a tile; at D 256 the dV pass takes Q, dO and the dK pass dO, Q.
template <int D>
__device__ __forceinline__ bool is_q(int i, int n_tiles) {
  if constexpr (RingCfg<D>::kWide) return (i % 2 == 0) == (i < 2 * n_tiles);
  else return i % 2 == 0;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
split_bwd_dkv_kernel(const __grid_constant__ Planes tm_q, const __grid_constant__ Planes tm_k,
                     const __grid_constant__ Planes tm_v, const __grid_constant__ Planes tm_do,
                     const float* __restrict__ lse, const float* __restrict__ di,
                     float* __restrict__ dk, float* __restrict__ dv, int lq, int lk, float scale,
                     float scale_log2) {
  using C = DkvCfg<D>;
  constexpr int BN = C::kBlockN, S = C::kSlots, NC = C::kWide ? 1 : 2, PB = C::kPBuf;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = sK + C::kRes, ring = sV + C::kRes;
  const uint32_t vecs = ring + S * C::kSlot, pbufs = vecs + 2 * S * C::kVec;
  const uint32_t bars = pbufs + PB * C::kPBytes;
  auto slot = [&](int s) { return ring + s * C::kSlot; };
  auto lse_s = [&](int s) { return vecs + 2 * s * C::kVec; };
  auto di_s = [&](int s) { return vecs + (2 * s + 1) * C::kVec; };
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + S + s); };
  auto p_full = [&](int p) { return bars + 8 * (1 + 2 * S + p); };
  auto p_empty = [&](int p) { return bars + 8 * (1 + 2 * S + PB + p); };
  auto smem_f = [&](uint32_t addr) { return reinterpret_cast<float*>(smem_raw + (addr - raw)); };

  const int wg = threadIdx.x / 128;
  const int k0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = lq / BN;
  const int n_items = (C::kWide ? 4 : 2) * n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * NC);  // every consumer takes every item
    }
    for (int p = 0; p < PB; ++p) {
      mbar_init(p_full(p), 128);
      mbar_init(p_empty(p), 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      mbar_expect_tx(bars, 2 * C::kRes);
      load_split<D, kRows>(sK, tm_k, bars, h, k0, b);
      load_split<D, kRows>(sV, tm_v, bars, h, k0, b);
      const float* lse_bh = lse + ((size_t)b * gridDim.y + h) * lq;
      const float* di_bh = di + ((size_t)b * gridDim.y + h) * lq;
      for (int i = 0; i < n_items; ++i) {
        const int s = i % S, q_row = ((i / 2) % n_tiles) * BN;
        mbar_wait(empty(s), ((i / S) & 1) ^ 1);  // the first round finds every slot empty
        if (is_q<D>(i, n_tiles)) {
          mbar_expect_tx(full(s), C::kSlot + 2 * C::kVec);
          load_split<D, BN>(slot(s), tm_q, full(s), h, q_row, b);
          bulk_load(lse_s(s), lse_bh + q_row, C::kVec, full(s));
          bulk_load(di_s(s), di_bh + q_row, C::kVec, full(s));
        } else {
          mbar_expect_tx(full(s), C::kSlot);
          load_split<D, BN>(slot(s), tm_do, full(s), h, q_row, b);
        }
      }
    }
    return;
  }
  // ----------------------------------------------------------- consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  if (wg >= NC) return;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, quad = lane % 4;
  const size_t rs = (size_t)gridDim.y * D;  // elements from one key's row to the next
  const size_t out = ((size_t)b * lk + k0 + warp * 16 + lane / 4) * rs + (size_t)h * D + 2 * quad;
  mbar_wait(bars, 0);

  if constexpr (!C::kWide) {
    // Warpgroup 0: S^T = K Q^T, P^T, dV += P^T dO. Warpgroup 1: dP^T = V dO^T,
    // dS^T = P^T (dP^T - di) scale with warpgroup 0's P^T, dK += dS^T Q. Each
    // tile's product goes into a zeroed accumulator, then into the sum.
    float acc[D / 2], tile[D / 2], x[BN / 2];
    uint32_t frag[3][BN / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const PingPong turn(wg);  // warpgroup 0 goes first; each takes 2 n_tiles turns
    for (int j = 0; j < n_tiles; ++j) {
      const int iq = 2 * j, io = iq + 1, sq = iq % S, so = io % S, pb = j % PB;
      const uint32_t par_q = (iq / S) & 1, par_o = (io / S) & 1, par_p = (j / PB) & 1;
      float* pbuf = smem_f(pbufs + pb * C::kPBytes);
      mbar_wait(full(wg == 0 ? sq : so), wg == 0 ? par_q : par_o);
      turn.wait();
      wgmma_fence();
      mma_ss_split<D, BN>(x, wg == 0 ? sK : sV, slot(wg == 0 ? sq : so));  // S^T or dP^T
      wgmma_commit();
      turn.pass();
      wgmma_wait<0>();
      fence_regs(x);
      if (wg == 0) {
        p_by_cols(x, smem_f(lse_s(sq)), quad, scale_log2);  // P^T
        mbar_arrive(empty(sq));
        mbar_wait(p_empty(pb), par_p ^ 1);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) pbuf[i * 128 + t] = x[i];
        mbar_arrive(p_full(pb));
        mbar_wait(full(so), par_o);
      } else {
        mbar_arrive(empty(so));
        mbar_wait(full(sq), par_q);
        mbar_wait(p_full(pb), par_p);
        const float* d = smem_f(di_s(sq));
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {  // as ds_by_cols, P^T from the buffer
          const float2 dd = *reinterpret_cast<const float2*>(d + 8 * c + 2 * quad);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * c + e;
            x[i] = (x[i] - (e & 1 ? dd.y : dd.x)) * pbuf[i * 128 + t] * scale;
          }
        }
        mbar_arrive(p_empty(pb));
      }
      split_rows<BN / 2>(frag, x);
      zero_regs(tile);
      turn.wait();
      wgmma_fence();
      mma_rs_split<D, BN>(tile, frag, slot(wg == 0 ? so : sq));  // P^T dO or dS^T Q
      wgmma_commit();
      if (wg == 0 || j + 1 < n_tiles) turn.pass();  // warpgroup 1 does not pass its last
      wgmma_wait<0>();
      add_tile(acc, tile);
      fence_parts(frag);
      mbar_arrive(empty(wg == 0 ? so : sq));
    }
    store_rows_f32<D>((wg == 0 ? dv : dk) + out, rs, acc);
  } else {
    // One consumer, one slot: each item is freed before the next is waited for.
    float acc[D / 2], s[BN / 2], dp[BN / 2];
    uint32_t frag[3][BN / 4];
    int i = 0;
    auto take = [&](int item) {
      mbar_wait(full(item % S), (item / S) & 1);
      return item % S;
    };
    auto start_rs = [&](int sl) {  // acc += frag B over the split tile in slot sl
      wgmma_fence();
      fence_regs(acc);
      mma_rs_split<D, BN>(acc, frag, slot(sl));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_parts(frag);
      mbar_arrive(empty(sl));
    };
    auto scores = [&](float (&x)[BN / 2], uint32_t res, int sl) {  // x = res slot^T
      wgmma_fence();
      mma_ss_split<D, BN>(x, res, slot(sl));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(x);
    };
#pragma unroll 1
    for (int pass = 0; pass < 2; ++pass) {  // dV, then dK
#pragma unroll
      for (int c = 0; c < D / 2; ++c) acc[c] = 0.f;
      for (int j = 0; j < n_tiles; ++j) {
        if (pass == 0) {
          const int sq = take(i++);
          scores(s, sK, sq);  // S^T
          p_by_cols(s, smem_f(lse_s(sq)), quad, scale_log2);
          mbar_arrive(empty(sq));
          split_rows<BN / 2>(frag, s);
          start_rs(take(i++));  // dV += P^T dO
        } else {
          const int so = take(i++);
          scores(dp, sV, so);  // dP^T
          mbar_arrive(empty(so));
          const int sq = take(i++);
          scores(s, sK, sq);  // S^T
          ds_by_cols(s, dp, smem_f(lse_s(sq)), smem_f(di_s(sq)), quad, scale_log2, scale);
          split_rows<BN / 2>(frag, dp);
          start_rs(sq);  // dK += dS^T Q
        }
      }
      store_rows_f32<D>((pass == 0 ? dv : dk) + out, rs, acc);
    }
  }
}

// ------------------------------------------------------------------ host --

template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, int blocks, int heads, int batch, cudaStream_t stream,
           Args... args) {
  if (int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)smem))
    return err;
  kernel<<<dim3(blocks, heads, batch), kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// K5 (dq) or K4 (dk, dv) at head dim D on the planes of q, k, v and dout.
template <int D>
int launch_bwd(bool dkv, const void* q, const void* k, const void* v, const float* lse,
               const void* dout, const float* di, float* out0, float* out1, int batch, int heads,
               int lq, int lk, float scale, cudaStream_t stream) {
  constexpr int BN = RingCfg<D>::kBlockN;
  Planes tq, tk, tv, tdo;
  const int q_rows = dkv ? BN : kRows, k_rows = dkv ? kRows : BN;
  if (int err = make_planes<D>(&tq, q, batch, lq, heads, q_rows)) return err;
  if (int err = make_planes<D>(&tdo, dout, batch, lq, heads, q_rows)) return err;
  if (int err = make_planes<D>(&tk, k, batch, lk, heads, k_rows)) return err;
  if (int err = make_planes<D>(&tv, v, batch, lk, heads, k_rows)) return err;
  const float scale_log2 = scale * kLog2e;
  if (dkv)
    return launch(split_bwd_dkv_kernel<D>, DkvCfg<D>::kSmem, lk / kRows, heads, batch, stream,
                     tq, tk, tv, tdo, lse, di, out0, out1, lq, lk, scale, scale_log2);
  return launch(split_bwd_dq_kernel<D>, DqCfg<D>::kSmem, lq / kRows, heads, batch, stream, tq,
                   tk, tv, tdo, lse, di, out0, lq, lk, scale, scale_log2);
}

int check_shape(int batch, int heads, int lq, int lk, const float* lse, const float* di) {
  if (lq <= 0 || lk <= 0 || lq % kRows != 0 || lk % kRows != 0 || batch <= 0 || heads <= 0 ||
      reinterpret_cast<uintptr_t>(lse) % 16 || reinterpret_cast<uintptr_t>(di) % 16)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// x (n f32) into out (3, n) bf16: the planes hi, mid and lo. n a multiple of
// 8; x and out 16-byte aligned device buffers. Launches on `stream` and
// returns a CUDA error code (0 on success).
extern "C" int split_bf16x3_launch(const float* x, void* out, long long n, void* stream) {
  if (n <= 0 || n % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t n8 = (size_t)n / 8;
  const int blocks = (int)std::min<size_t>((n8 + 255) / 256, 132 * 16);
  split_bf16x3_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), static_cast<uint4*>(out), n8);
  return (int)cudaGetLastError();
}

// q, k, v, dout: the (3, B, L, H, D) bf16 planes of the f32 operands (q and
// dout Lq rows, k and v Lk), 16-byte aligned; lse, di (B, H, Lq) f32,
// 16-byte aligned; dq (B, Lq, H, D), dk and dv (B, Lk, H, D) f32. Lq, Lk
// multiples of 64; D in {64, 96, 128, 256}. Each launches on `stream` and
// returns a CUDA error code (0 on success).
extern "C" int flash_attn_split_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                               const float* lse, const void* dout,
                                               const float* di, float* dk, float* dv, int batch,
                                               int heads, int lq, int lk, int head_dim,
                                               float scale, void* stream) {
  if (int err = check_shape(batch, heads, lq, lk, lse, di)) return err;
  return dispatch(head_dim, (int)cudaErrorInvalidValue, [&](auto d) {
    return launch_bwd<decltype(d)::value>(true, q, k, v, lse, dout, di, dk, dv, batch, heads, lq,
                                          lk, scale, (cudaStream_t)stream);
  });
}

extern "C" int flash_attn_split_bwd_dq_launch(const void* q, const void* k, const void* v,
                                              const float* lse, const void* dout, const float* di,
                                              float* dq, int batch, int heads, int lq, int lk,
                                              int head_dim, float scale, void* stream) {
  if (int err = check_shape(batch, heads, lq, lk, lse, di)) return err;
  return dispatch(head_dim, (int)cudaErrorInvalidValue, [&](auto d) {
    return launch_bwd<decltype(d)::value>(false, q, k, v, lse, dout, di, dq, nullptr, batch,
                                          heads, lq, lk, scale, (cudaStream_t)stream);
  });
}

// The dynamic shared memory each launcher requests at head_dim (-1: not taken).
extern "C" int flash_attn_split_bwd_dkv_smem(int head_dim) {
  return dispatch(head_dim, -1, [](auto d) { return (int)DkvCfg<decltype(d)::value>::kSmem; });
}

extern "C" int flash_attn_split_bwd_dq_smem(int head_dim) {
  return dispatch(head_dim, -1, [](auto d) { return (int)DqCfg<decltype(d)::value>::kSmem; });
}
