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
// - Shared memory holds every tile as swizzle atoms (sm90.cuh, which also
//   holds the PTX helpers shared with the backward), atom after atom, as the
//   TMA box writes them; the wgmma descriptors name the same swizzle.
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

#include "sm90.cuh"

namespace {

constexpr int kBlockM = 128;   // query rows per CTA
constexpr int kConsumers = 2;  // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int D>
struct Cfg {
  static constexpr int kAtomCols = Atom<D>::kCols;
  static constexpr int kRowBytes = Atom<D>::kRowBytes;
  static constexpr int kBlockN = D == 256 ? 64 : 128;      // keys per tile
  static constexpr int kStages = D == 64 ? 4 : (D == 96 ? 3 : 2);
  static constexpr uint32_t kQBytes = kBlockM * D * 2;
  static constexpr uint32_t kTileBytes = kBlockN * D * 2;  // one K or one V tile
  static constexpr int kBars = 1 + 4 * kStages;            // Q; full K, V; empty K, V
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes + 8 * kBars;
  static_assert(kSmem <= 232448, "shared memory per block");
};

// s (this warpgroup's 64 rows x kBlockN keys, f32) = Q K^T over D, started and
// committed as one group. q: the warpgroup's first Q row in atom 0; k: the
// stage's K tile.
template <int D>
__device__ __forceinline__ void start_qk(float (&s)[Cfg<D>::kBlockN / 2], uint32_t q, uint32_t k) {
  wgmma_fence();
  mma_ss<D, Cfg<D>::kBlockN, kBlockM>(s, q, k);
  wgmma_commit();
}

// o (64 rows x D, f32) += P V, P (64 x kBlockN, bf16 pairs in registers),
// started and committed as one group; v: the stage's V tile.
template <int D>
__device__ __forceinline__ void start_pv(float (&o)[D / 2], const uint32_t (&p)[Cfg<D>::kBlockN / 4],
                                         uint32_t v) {
  using C = Cfg<D>;
  wgmma_fence();
  mma_rs<D, D, C::kBlockN>(o, p, v, C::kBlockN * C::kRowBytes);
  wgmma_commit();
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

    // Ping-pong: warpgroup 0 goes first; each takes n_tiles + 1 turns.
    const PingPong turn(wg);

    mbar_wait(bar_q, 0);
    mbar_wait(full_k(0), 0);
    turn.wait();
    start_qk<D>(s, q_wg, sK);
    turn.pass();
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(empty_k(0));
    online_softmax(s, m2, l, alpha, scale_log2);
    pack_rows<BN / 2>(p, s);

    for (int j = 1; j < n_tiles; ++j) {
      const int sj = j % S, sp = (j - 1) % S;
      mbar_wait(full_k(sj), (j / S) & 1);
      mbar_wait(full_v(sp), ((j - 1) / S) & 1);
      turn.wait();
      start_qk<D>(s, q_wg, sK + sj * C::kTileBytes);  // tile j's scores ...
      fence_regs(o);
      start_pv<D>(o, p, sV + sp * C::kTileBytes);  // ... while tile j-1's P V follows
      turn.pass();
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
      pack_rows<BN / 2>(p, s);
    }
    const int sl = (n_tiles - 1) % S;
    mbar_wait(full_v(sl), ((n_tiles - 1) / S) & 1);
    turn.wait();
    fence_regs(o);
    start_pv<D>(o, p, sV + sl * C::kTileBytes);
    if (wg == 0) turn.pass();  // warpgroup 1 has no turn left to wait for
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
    stage_rows<D, kBlockM>(smem_raw + (q_wg - raw), o, inv, warp, lane);
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

// The dynamic shared memory the launcher requests at head_dim (-1: not taken).
extern "C" int flash_attn_bf16_fwd_smem(int head_dim) {
  switch (head_dim) {
    case 64: return (int)Cfg<64>::kSmem;
    case 96: return (int)Cfg<96>::kSmem;
    case 128: return (int)Cfg<128>::kSmem;
    case 256: return (int)Cfg<256>::kSmem;
    default: return -1;
  }
}
