// Flash attention backward in bf16 for Hopper: dQ (kernel K5) and dK / dV
// (kernel K4), TMA-fed, warp-specialised, on wgmma. Built for sm_90a only.
//
// Replaces: the bf16 instances of the Pallas kernels that
// svdformer_pointsea_tpu/nn/flash_vjp.py runs when nn/layers.py::
// _scaled_attention casts q, k and v to bf16 (--precision bf16): upstream
// jax.experimental.pallas.ops.tpu.flash_attention._flash_attention_bwd_dkv
// (flash_attention.py:941, kernel :796; called at flash_vjp.py:171) for dK
// and dV, and flash_vjp.py::_bwd_dq_di128 (:49, pallas_call :109) for dQ.
// Non-causal, no bias, no segment ids.
//
// What they compute, the upstream kernels' function on bf16 operands, from
// the forward's LSE and di = rowsum(O * dO), both f32 from the caller:
//   S = (Q K^T) * scale and dP = dO V^T in f32; P = exp(S - LSE) in f32;
//   dS = (dP - di) * P * scale in f32;
//   K5: dQ = bf16(dS) K;  K4: dV = bf16(P)^T dO, dK = bf16(dS)^T Q;
// with f32 accumulation and the outputs rounded to bf16 (nearest even). P is
// 2^(S_raw * scale * log2 e - LSE * log2 e): one FFMA and one ex2.approx.
//
// Layout: q, dout, dq (B, Lq, H, D); k, v, dk, dv (B, Lk, H, D), contiguous
// bf16 read in place through 4-D tensor maps over (D, H, L, B); lse, di
// (B, H, Lq) f32, 16-byte aligned. Lq and Lk are multiples of 128; D is 64,
// 96, 128 or 256.
//
// What bounds them on an H100: the tensor cores (989 TFLOP/s bf16 dense) for
// 6 (K5) and 8 (K4) B H Lq Lk D flops, and close behind them the
// exponentials: each kernel recomputes P, B H Lq Lk exponentials at 16 a
// clock per SM, at dh 64 as much time as 45 % (K5) and 34 % (K4) of the
// tensor cores' bound.
//
// Design (the bf16 forward's, flash_attn_bf16_fwd.cu; the parts are in
// sm90.cuh): one CTA holds a producer warpgroup, one thread of which starts
// every TMA copy, and two consumer warpgroups of 64 rows each (setmaxnreg
// 24 / 240) that take turns to start their products (ping-pong), so that
// one's exponentials run under the other's products. No atomics: every
// output element is summed by one thread in a fixed order, so a repeat
// gives the same bits.
// - K5, one CTA per (128 queries, head, batch): Q and dO are loaded once; K
//   and V tiles of kBlockN keys go through a ring with full and empty
//   mbarriers, K and V on barriers of their own, so that S can start before
//   V lands; lse and di of a thread's two rows stay in registers. S = Q K^T
//   and dP = dO V^T are wgmma with both operands in shared memory, K-major;
//   dS packed to bf16 pairs is the register A operand of dQ += dS K, with K
//   MN-major through the descriptor's transpose bit. Tile j's two products
//   are started before tile j-1's dS K, and tile j's dS is computed while
//   that product is in flight, so the ring must hold two tiles (at D 256,
//   of 32 keys). dQ goes out as bf16 through the warpgroup's (no longer
//   read) Q rows and one TMA store per atom.
// - K4, one CTA per (128 keys, head, batch), keys on the M side, so that no
//   transpose ever exists in memory: K and V are loaded once; Q and dO tiles
//   of 64 queries go through the ring with their lse and di slices (bulk
//   copies into shared memory: they vary along the columns of S^T). S^T =
//   K Q^T and dP^T = V dO^T are SS wgmma, K-major; P^T and dS^T are formed
//   in registers and are the A operands of dV += P^T dO and dK += dS^T Q,
//   dO and Q MN-major. A tile takes two turns: the two score products, then
//   the two accumulating ones. dK and dV stay in registers for the whole
//   sweep over the queries and are stored from them. At D 256 they (256 f32
//   a thread) do not fit beside the scores: the sweep runs once for each
//   128-column half, S^T and dP^T recomputed.

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kBlockM = 128;   // rows per CTA: queries (K5) or keys (K4)
constexpr int kConsumers = 2;  // warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr size_t kMaxSmem = 232448;  // per block, after cudaFuncSetAttribute

// K5: Q and dO once, K and V tiles of kBlockN keys through the ring.
template <int D>
struct DqCfg {
  static constexpr int kBlockN = D == 256 ? 32 : 64;
  static constexpr int kStages = D == 256 ? 2 : 4;
  static constexpr uint32_t kRowsBytes = kBlockM * D * 2;  // Q or dO
  static constexpr uint32_t kTileBytes = kBlockN * D * 2;  // one K or one V tile
  static constexpr int kBars = 1 + 4 * kStages;            // Q and dO; full K, V; empty K, V
  static constexpr size_t kSmem = 1024 + 2 * kRowsBytes + 2 * kStages * kTileBytes + 8 * kBars;
  static_assert(kSmem <= kMaxSmem, "shared memory per block");
};

// K4: K and V once, Q and dO tiles of kBlockN queries with their lse and di
// slices through the ring; at D 256 two passes of 128 dK / dV columns.
template <int D>
struct DkvCfg {
  static constexpr int kBlockN = 64;
  static constexpr int kStages = D == 256 ? 1 : 4;
  static constexpr int kPasses = D == 256 ? 2 : 1;
  static constexpr int kW = D / kPasses;                   // dK and dV columns a pass
  static constexpr uint32_t kRowsBytes = kBlockM * D * 2;  // K or V
  static constexpr uint32_t kTileBytes = kBlockN * D * 2;  // one Q or one dO tile
  static constexpr uint32_t kVecBytes = kBlockN * 4;       // its lse or di slice
  static constexpr int kBars = 1 + 2 * kStages;            // K and V; full, empty
  static constexpr size_t kSmem =
      1024 + 2 * kRowsBytes + 2 * kStages * (kTileBytes + kVecBytes) + 8 * kBars;
  static_assert(kSmem <= kMaxSmem, "shared memory per block");
};

// A warpgroup's 64 x W f32 accumulator as bf16 into rows g and g + 8 of a
// (.., H, D) tensor: `out` points at row g, column 2 quad of the block of
// columns, rows are `rs` elements apart.
template <int W>
__device__ __forceinline__ void store_rows(bf16* out, size_t rs, const float (&acc)[W / 2]) {
#pragma unroll
  for (int c = 0; c < W / 8; ++c) {
    *reinterpret_cast<uint32_t*>(out + 8 * c) = pack_bf16(acc[4 * c], acc[4 * c + 1]);
    *reinterpret_cast<uint32_t*>(out + 8 * rs + 8 * c) = pack_bf16(acc[4 * c + 2], acc[4 * c + 3]);
  }
}

// ---------------------------------------------------------------- K5 ------
// s = Q K^T and dp = dO V^T for this warpgroup's 64 query rows (q, d_o: its
// first row, atom 0) and one stage's K and V tiles, one commit group; the V
// tile is waited for (full_v, parity) after Q K^T has gone out.
template <int D>
__device__ __forceinline__ void start_scores(float (&s)[DqCfg<D>::kBlockN / 2],
                                             float (&dp)[DqCfg<D>::kBlockN / 2], uint32_t q,
                                             uint32_t d_o, uint32_t k, uint32_t v,
                                             uint32_t full_v, uint32_t parity) {
  constexpr int BN = DqCfg<D>::kBlockN;
  wgmma_fence();
  mma_ss<D, BN, kBlockM>(s, q, k);
  mbar_wait(full_v, parity);
  wgmma_fence();
  mma_ss<D, BN, kBlockM>(dp, d_o, v);
  wgmma_commit();
}

// dq (64 rows x D, f32) += dS K, dS (64 x kBlockN, bf16 pairs in registers),
// one commit group; k: the stage's K tile, MN-major.
template <int D>
__device__ __forceinline__ void start_dq(float (&dq)[D / 2],
                                         const uint32_t (&ds)[DqCfg<D>::kBlockN / 4], uint32_t k) {
  constexpr int BN = DqCfg<D>::kBlockN;
  wgmma_fence();
  mma_rs<D, D, BN>(dq, ds, k, BN * Atom<D>::kRowBytes);
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
              const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse,
              const float* __restrict__ di, int lq, int lk, float scale, float scale_log2) {
  using C = DqCfg<D>;
  using A = Atom<D>;
  constexpr int BN = C::kBlockN, S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms repeat every 1024 bytes
  const uint32_t sQ = base, sdO = sQ + C::kRowsBytes, sK = sdO + C::kRowsBytes;
  const uint32_t sV = sK + S * C::kTileBytes, bars = sV + S * C::kTileBytes;  // 8 bytes each
  const uint32_t bar_qdo = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + S + s); };
  auto empty_k = [&](int s) { return bars + 8 * (1 + 2 * S + s); };
  auto empty_v = [&](int s) { return bars + 8 * (1 + 3 * S + s); };

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = lk / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_qdo, 1);
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
      prefetch_map(&tm_do);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      mbar_expect_tx(bar_qdo, 2 * C::kRowsBytes);
      for (int a = 0; a < D / A::kCols; ++a) {
        tma_load(sQ + a * kBlockM * A::kRowBytes, &tm_q, bar_qdo, a * A::kCols, h, q0, b);
        tma_load(sdO + a * kBlockM * A::kRowBytes, &tm_do, bar_qdo, a * A::kCols, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        const uint32_t phase = ((j / S) & 1) ^ 1;  // the first round finds every stage empty
        mbar_wait(empty_k(s), phase);
        mbar_expect_tx(full_k(s), C::kTileBytes);
        for (int a = 0; a < D / A::kCols; ++a)
          tma_load(sK + s * C::kTileBytes + a * BN * A::kRowBytes, &tm_k, full_k(s),
                   a * A::kCols, h, j * BN, b);
        mbar_wait(empty_v(s), phase);
        mbar_expect_tx(full_v(s), C::kTileBytes);
        for (int a = 0; a < D / A::kCols; ++a)
          tma_load(sV + s * C::kTileBytes + a * BN * A::kRowBytes, &tm_v, full_v(s),
                   a * A::kCols, h, j * BN, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const uint32_t q_wg = sQ + wg * 64 * A::kRowBytes;  // this warpgroup's rows, atom 0
    const uint32_t do_wg = sdO + wg * 64 * A::kRowBytes;
    const size_t row = ((size_t)b * gridDim.y + h) * lq + q0 + wg * 64 + warp * 16 + lane / 4;
    const float neg_lse2[2] = {-lse[row] * kLog2e, -lse[row + 8] * kLog2e};
    const float di_r[2] = {di[row], di[row + 8]};

    float dq[D / 2], s[BN / 2], dp[BN / 2];
    uint32_t ds[BN / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    // Ping-pong: warpgroup 0 goes first; each takes n_tiles + 1 turns.
    const PingPong turn(wg);

    mbar_wait(bar_qdo, 0);
    mbar_wait(full_k(0), 0);
    turn.wait();
    start_scores<D>(s, dp, q_wg, do_wg, sK, sV, full_v(0), 0);
    turn.pass();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    mbar_arrive(empty_v(0));
    ds_by_rows(s, dp, neg_lse2, di_r, scale_log2, scale);
    pack_rows<BN / 2>(ds, dp);

    for (int j = 1; j < n_tiles; ++j) {
      const int sj = j % S, sp = (j - 1) % S;
      const uint32_t parity = (j / S) & 1;
      mbar_wait(full_k(sj), parity);
      turn.wait();
      start_scores<D>(s, dp, q_wg, do_wg, sK + sj * C::kTileBytes, sV + sj * C::kTileBytes,
                      full_v(sj), parity);  // tile j's scores ...
      fence_regs(dq);
      start_dq<D>(dq, ds, sK + sp * C::kTileBytes);  // ... while tile j-1's dS K follows
      turn.pass();
      wgmma_wait<1>();
      fence_regs(s);
      fence_regs(dp);
      mbar_arrive(empty_v(sj));
      ds_by_rows(s, dp, neg_lse2, di_r, scale_log2, scale);  // overlaps the dS K in flight
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(ds);
      mbar_arrive(empty_k(sp));
      pack_rows<BN / 2>(ds, dp);
    }
    const int sl = (n_tiles - 1) % S;
    turn.wait();
    fence_regs(dq);
    start_dq<D>(dq, ds, sK + sl * C::kTileBytes);
    if (wg == 0) turn.pass();  // warpgroup 1 has no turn left to wait for
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(empty_k(sl));

    // Epilogue: dQ as bf16 into this warpgroup's Q rows (no longer read),
    // then a TMA store per atom.
    const float one[2] = {1.f, 1.f};
    stage_rows<D, kBlockM>(smem_raw + (q_wg - raw), dq, one, warp, lane);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (t == 0) {
      for (int a = 0; a < D / A::kCols; ++a)
        tma_store(&tm_dq, q_wg + a * kBlockM * A::kRowBytes, a * A::kCols, h, q0 + wg * 64, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------- K4 ------
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
               const float* __restrict__ lse, const float* __restrict__ di, bf16* __restrict__ dk,
               bf16* __restrict__ dv, int lq, int lk, float scale, float scale_log2) {
  using C = DkvCfg<D>;
  using A = Atom<D>;
  constexpr int BN = C::kBlockN, S = C::kStages, W = C::kW;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sK = base, sV = sK + C::kRowsBytes, ring = sV + C::kRowsBytes;
  const uint32_t vecs = ring + 2 * S * C::kTileBytes, bars = vecs + 2 * S * C::kVecBytes;
  auto q_tile = [&](int s) { return ring + 2 * s * C::kTileBytes; };
  auto do_tile = [&](int s) { return ring + (2 * s + 1) * C::kTileBytes; };
  auto lse_s = [&](int s) { return vecs + 2 * s * C::kVecBytes; };
  auto di_s = [&](int s) { return vecs + (2 * s + 1) * C::kVecBytes; };
  const uint32_t bar_kv = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + S + s); };

  const int wg = threadIdx.x / 128;
  const int k0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = lq / BN, n_iters = C::kPasses * n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      prefetch_map(&tm_q);
      prefetch_map(&tm_do);
      mbar_expect_tx(bar_kv, 2 * C::kRowsBytes);
      for (int a = 0; a < D / A::kCols; ++a) {
        tma_load(sK + a * kBlockM * A::kRowBytes, &tm_k, bar_kv, a * A::kCols, h, k0, b);
        tma_load(sV + a * kBlockM * A::kRowBytes, &tm_v, bar_kv, a * A::kCols, h, k0, b);
      }
      const float* lse_bh = lse + ((size_t)b * gridDim.y + h) * lq;
      const float* di_bh = di + ((size_t)b * gridDim.y + h) * lq;
      for (int it = 0; it < n_iters; ++it) {
        const int j = it % n_tiles, s = it % S;
        mbar_wait(empty(s), ((it / S) & 1) ^ 1);  // the first round finds every stage empty
        mbar_expect_tx(full(s), 2 * (C::kTileBytes + C::kVecBytes));
        for (int a = 0; a < D / A::kCols; ++a) {
          tma_load(q_tile(s) + a * BN * A::kRowBytes, &tm_q, full(s), a * A::kCols, h, j * BN, b);
          tma_load(do_tile(s) + a * BN * A::kRowBytes, &tm_do, full(s), a * A::kCols, h, j * BN,
                   b);
        }
        bulk_load(lse_s(s), lse_bh + j * BN, C::kVecBytes, full(s));
        bulk_load(di_s(s), di_bh + j * BN, C::kVecBytes, full(s));
      }
    }
  } else {
    // --------------------------------------------------------- consumers --
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, quad = lane % 4;
    const uint32_t k_wg = sK + wg * 64 * A::kRowBytes;  // this warpgroup's keys, atom 0
    const uint32_t v_wg = sV + wg * 64 * A::kRowBytes;
    const size_t rs = (size_t)gridDim.y * D;  // elements from one key's row to the next
    const size_t out = ((size_t)b * lk + k0 + wg * 64 + warp * 16 + lane / 4) * rs +
                       (size_t)h * D + 2 * quad;

    float acc_k[W / 2], acc_v[W / 2], s[BN / 2], dp[BN / 2];
    uint32_t pt[BN / 4], dst[BN / 4];

    // Ping-pong: warpgroup 0 goes first; each takes 2 n_iters turns.
    const PingPong turn(wg);
    mbar_wait(bar_kv, 0);

#pragma unroll 1
    for (int pass = 0; pass < C::kPasses; ++pass) {
#pragma unroll
      for (int i = 0; i < W / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
      const uint32_t cols = pass * (W / A::kCols) * BN * A::kRowBytes;  // first atom of the pass
      for (int j = 0; j < n_tiles; ++j) {
        const int it = pass * n_tiles + j, st = it % S;
        mbar_wait(full(st), (it / S) & 1);
        turn.wait();
        wgmma_fence();
        mma_ss<D, BN, kBlockM>(s, k_wg, q_tile(st));    // S^T = K Q^T
        mma_ss<D, BN, kBlockM>(dp, v_wg, do_tile(st));  // dP^T = V dO^T
        wgmma_commit();
        turn.pass();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        ds_by_cols(s, dp, reinterpret_cast<const float*>(smem_raw + (lse_s(st) - raw)),
                   reinterpret_cast<const float*>(smem_raw + (di_s(st) - raw)), quad, scale_log2,
                   scale);
        pack_rows<BN / 2>(pt, s);
        pack_rows<BN / 2>(dst, dp);
        turn.wait();
        wgmma_fence();
        mma_rs<D, W, BN>(acc_v, pt, do_tile(st) + cols, BN * A::kRowBytes);  // dV += P^T dO
        mma_rs<D, W, BN>(acc_k, dst, q_tile(st) + cols, BN * A::kRowBytes);  // dK += dS^T Q
        wgmma_commit();
        if (wg == 0 || it + 1 < n_iters) turn.pass();  // warpgroup 1 does not pass its last
        wgmma_wait<0>();
        fence_regs(acc_v);
        fence_regs(acc_k);
        fence_regs(pt);
        fence_regs(dst);
        mbar_arrive(empty(st));
      }
      store_rows<W>(dk + out + pass * W, rs, acc_k);
      store_rows<W>(dv + out + pass * W, rs, acc_v);
    }
  }
}

// ------------------------------------------------------------------ host --
template <int D>
int launch_dq(const void* q, const void* k, const void* v, const float* lse, const void* dout,
              const float* di, void* dq, int batch, int heads, int lq, int lk, float scale,
              cudaStream_t stream) {
  using C = DqCfg<D>;
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (int err = make_map<D>(&tq, q, batch, lq, heads, kBlockM)) return err;
  if (int err = make_map<D>(&tdo, dout, batch, lq, heads, kBlockM)) return err;
  if (int err = make_map<D>(&tk, k, batch, lk, heads, C::kBlockN)) return err;
  if (int err = make_map<D>(&tv, v, batch, lk, heads, C::kBlockN)) return err;
  if (int err = make_map<D>(&tdq, dq, batch, lq, heads, 64)) return err;
  if (int err = (int)cudaFuncSetAttribute(bwd_dq_kernel<D>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)C::kSmem))
    return err;
  bwd_dq_kernel<D><<<dim3(lq / kBlockM, heads, batch), kThreads, C::kSmem, stream>>>(
      tq, tk, tv, tdo, tdq, lse, di, lq, lk, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const float* lse, const void* dout,
               const float* di, void* dk, void* dv, int batch, int heads, int lq, int lk,
               float scale, cudaStream_t stream) {
  using C = DkvCfg<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (int err = make_map<D>(&tk, k, batch, lk, heads, kBlockM)) return err;
  if (int err = make_map<D>(&tv, v, batch, lk, heads, kBlockM)) return err;
  if (int err = make_map<D>(&tq, q, batch, lq, heads, C::kBlockN)) return err;
  if (int err = make_map<D>(&tdo, dout, batch, lq, heads, C::kBlockN)) return err;
  if (int err = (int)cudaFuncSetAttribute(bwd_dkv_kernel<D>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)C::kSmem))
    return err;
  bwd_dkv_kernel<D><<<dim3(lk / kBlockM, heads, batch), kThreads, C::kSmem, stream>>>(
      tq, tk, tv, tdo, lse, di, (bf16*)dk, (bf16*)dv, lq, lk, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

int check_shape(int batch, int heads, int lq, int lk, const float* lse, const float* di) {
  if (lq <= 0 || lk <= 0 || lq % kBlockM != 0 || lk % kBlockM != 0 || batch <= 0 || heads <= 0 ||
      reinterpret_cast<uintptr_t>(lse) % 16 || reinterpret_cast<uintptr_t>(di) % 16)
    return (int)cudaErrorInvalidValue;
  return 0;
}

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

// All pointers are contiguous device buffers, bf16 passed as void*: q, dout,
// dq (B, Lq, H, D); k, v, dk, dv (B, Lk, H, D), 16-byte aligned; lse, di
// (B, H, Lq) f32, 16-byte aligned. Lq, Lk multiples of 128; D in {64, 96,
// 128, 256}. Each launches on `stream` and returns a CUDA error code (0 on
// success).
extern "C" int flash_attn_bf16_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                              const float* lse, const void* dout,
                                              const float* di, void* dk, void* dv, int batch,
                                              int heads, int lq, int lk, int head_dim,
                                              float scale, void* stream) {
  if (int err = check_shape(batch, heads, lq, lk, lse, di)) return err;
  return dispatch(head_dim, (int)cudaErrorInvalidValue, [&](auto d) {
    return launch_dkv<decltype(d)::value>(q, k, v, lse, dout, di, dk, dv, batch, heads, lq, lk,
                                          scale, (cudaStream_t)stream);
  });
}

extern "C" int flash_attn_bf16_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const float* lse, const void* dout, const float* di,
                                             void* dq, int batch, int heads, int lq, int lk,
                                             int head_dim, float scale, void* stream) {
  if (int err = check_shape(batch, heads, lq, lk, lse, di)) return err;
  return dispatch(head_dim, (int)cudaErrorInvalidValue, [&](auto d) {
    return launch_dq<decltype(d)::value>(q, k, v, lse, dout, di, dq, batch, heads, lq, lk, scale,
                                         (cudaStream_t)stream);
  });
}

// The dynamic shared memory each launcher requests at head_dim (-1: not taken).
extern "C" int flash_attn_bf16_bwd_dkv_smem(int head_dim) {
  return dispatch(head_dim, -1, [](auto d) { return (int)DkvCfg<decltype(d)::value>::kSmem; });
}

extern "C" int flash_attn_bf16_bwd_dq_smem(int head_dim) {
  return dispatch(head_dim, -1, [](auto d) { return (int)DqCfg<decltype(d)::value>::kSmem; });
}
