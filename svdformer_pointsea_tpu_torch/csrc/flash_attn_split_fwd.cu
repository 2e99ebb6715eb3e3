// Flash attention forward in f32 for Hopper on the bf16 tensor cores (kernel
// K3, with or without its row statistics), with f32 accuracy from the
// three-way bf16 split of split.cuh. TMA-fed, warp-specialised, on wgmma.
// Built for sm_90a only.
//
// Replaces: the f32 forward Pallas kernel that svdformer_pointsea_tpu/nn/
// flash_vjp.py runs through upstream jax.experimental.pallas.ops.tpu.
// flash_attention._flash_attention_impl, entered at flash_vjp.py:153 (O only)
// and :160 (O and the row statistics), from nn/layers.py::_scaled_attention.
// Non-causal, no bias, no segment ids.
//
// What it computes, in f32: O = softmax(Q K^T scale) V; with a non-null lse,
// each query row's log-sum-exp LSE = m + ln l of the scaled scores
// (upstream's two residuals l and m folded into one), which the backward
// (flash_attn_split_bwd.cu) reads as P = exp(S scale - LSE). Online softmax
// in f32: a running max m, a running sum l of the f32 exponentials and a
// rescale of the accumulator by alpha = exp(m_old - m_new). The exponentials
// are 2^(S scale log2 e - m2), one FFMA and one ex2.approx each, with m2 the
// running max in log2 units, as in the bf16 kernels; LSE goes back to the
// natural log once, at the end. O is the same with and without statistics:
// only the LSE store differs.
//
// The split: q, k and v arrive as their (3, B, L, H, D) bf16 planes hi, mid,
// lo (split_bf16x3 in flash_attn_split_bwd.cu makes them). S = Q K^T is the
// six SS products of the parts; P, formed in f32 in registers, is split
// there into three A fragments, and P V is the six RS products with V read
// MN-major through the descriptor's transpose bit. Nothing but the parts is
// rounded to bf16; O and LSE are f32.
//
// Layout: the planes of q (3, B, Lq, H, D) and of k, v (3, B, Lk, H, D), read
// in place through one 4-D tensor map per plane over (D, H, L, B); o (B, Lq,
// H, D) f32; lse (B, H, Lq) f32 or null. Lq and Lk are multiples of 128; D is
// 64, 96, 128 or 256.
//
// What bounds it on an H100: the tensor cores. Six bf16 products at 989
// TFLOP/s dense are 164.8 TFLOP/s for the f32 function, whose two products
// are 4 B H Lq Lk D flops. The exponentials (B H Lq Lk at 16 a clock per SM)
// are a tenth of that time.
//
// Design (the bf16 forward's, flash_attn_bf16_fwd.cu, on split tiles):
// - One CTA per (128 queries, head, batch): warpgroups 0 and 1 are the
//   consumers, 64 query rows each, each with its own resident 64-row split Q
//   tile; warpgroup 2 is the producer, of which one thread starts every copy.
//   setmaxnreg moves registers from the producer (24 a thread) to the
//   consumers (240).
// - TMA: Q is loaded once; split K and V tiles of kBlockN keys go through a
//   ring of kStages stages, K and V on full and empty barriers of their own,
//   so that S = Q K^T can start before V has landed. Three planes triple
//   every tile, so the tiles are short: 64 keys at D 64 and 96, 32 at D 128.
// - S = Q K^T: six SS products m64nN (N = kBlockN), K-major, into one
//   accumulator that each tile's first product zeroes (the sum runs over D).
// - P V: six RS products m64nD into a zeroed per-tile accumulator, which is
//   then added in f32 to the running O, rescaled: O = (O + tile) alpha. A sum
//   carried across tiles in one wgmma accumulator drifts (each wgmma step
//   rounds the running sum); a tile's six products do not (PERF.md, the f32
//   backward's entry).
// - Overlap within each consumer: tile j's S product is started before tile
//   j-1's P V, and tile j's softmax and split run while that P V is in
//   flight. Between the consumers (ping-pong): the two warpgroups take turns,
//   on a pair of named barriers, to start their products, so that one's
//   softmax and split run under the other's products. Every wait for data
//   happens outside a turn and is followed by a wgmma.fence.
// - Epilogue: O / l from registers into o with 8-byte stores (each quad
//   writes 32 contiguous bytes of a row), LSE from registers when lse is not
//   null.
// - D 256 (not on the model's path): 64 query rows of three planes are 96 KB,
//   so one consumer warpgroup takes 64 queries, the key tiles are 16 long, and
//   there are no registers for a second accumulator: the sum stays in the
//   wgmma accumulator, rescaled in place.
//
// Dynamic shared memory (bytes, from FwdCfg below; 1024 of them for
// alignment): 197,736 / 222,280 / 197,704 / 197,704 at D 64 / 96 / 128 / 256,
// of 232,448.

#include "split.cuh"

namespace {

constexpr int kThreads = 384;  // two consumer warpgroups and a producer
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kLength = 128;  // Lq and Lk are multiples of it

template <int D>
struct FwdCfg {
  static constexpr bool kWide = D == 256;
  static constexpr int kConsumers = kWide ? 1 : 2;        // warpgroups of kRows queries
  static constexpr int kBlockM = kRows * kConsumers;      // queries per CTA
  static constexpr int kBlockN = kWide ? 16 : D == 128 ? 32 : 64;  // keys per tile
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr uint32_t kQ = 3 * kRows * D * 2;       // one warpgroup's split Q rows
  static constexpr uint32_t kTile = 3 * kBlockN * D * 2;  // one split K or V tile
  static constexpr int kBars = 1 + 4 * kStages;           // Q; full K, V; empty K, V
  static constexpr size_t kSmem = 1024 + kConsumers * kQ + 2 * kStages * kTile + 8 * kBars;
  static_assert(kSmem <= kMaxSmem, "shared memory per block");
  static_assert(kLength % kBlockM == 0 && kLength % kBlockN == 0, "length rule");
};

// o = (o + tile) alpha on row half r (elements 4i, 4i+1 of row g, 4i+2, 4i+3
// of row g+8): tile j-1's P V joins the running O, which moves to tile j's max.
template <int N>
__device__ __forceinline__ void add_rescaled(float (&o)[N], float (&tile)[N],
                                             const float (&alpha)[2]) {
  fence_regs(tile);
#pragma unroll
  for (int i = 0; i < N; ++i) o[i] = (o[i] + tile[i]) * alpha[(i >> 1) & 1];
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
split_fwd_kernel(const __grid_constant__ Planes tm_q, const __grid_constant__ Planes tm_k,
                 const __grid_constant__ Planes tm_v, float* __restrict__ o,
                 float* __restrict__ lse, int lq, int lk, float scale_log2) {
  using C = FwdCfg<D>;
  constexpr int BN = C::kBlockN, S = C::kStages, NC = C::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms repeat every 1024 bytes
  const uint32_t sQ = base, sK = sQ + NC * C::kQ, sV = sK + S * C::kTile;
  const uint32_t bars = sV + S * C::kTile;  // 8 bytes each
  const uint32_t bar_q = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + S + s); };
  auto empty_k = [&](int s) { return bars + 8 * (1 + 2 * S + s); };
  auto empty_v = [&](int s) { return bars + 8 * (1 + 3 * S + s); };

  const int wg = threadIdx.x / 128;
  const int q0 = blockIdx.x * C::kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = lk / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 128 * NC);
      mbar_init(empty_v(s), 128 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, NC * C::kQ);
      for (int w = 0; w < NC; ++w)
        load_split<D, kRows>(sQ + w * C::kQ, tm_q, bar_q, h, q0 + w * kRows, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % S;
        const uint32_t phase = ((j / S) & 1) ^ 1;  // the first round finds every stage empty
        mbar_wait(empty_k(s), phase);
        mbar_expect_tx(full_k(s), C::kTile);
        load_split<D, BN>(sK + s * C::kTile, tm_k, full_k(s), h, j * BN, b);
        mbar_wait(empty_v(s), phase);
        mbar_expect_tx(full_v(s), C::kTile);
        load_split<D, BN>(sV + s * C::kTile, tm_v, full_v(s), h, j * BN, b);
      }
    }
    return;
  }
  // ----------------------------------------------------------- consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  if (wg >= NC) return;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const uint32_t q_wg = sQ + wg * C::kQ;  // this warpgroup's split Q tile

  float acc[D / 2], s[BN / 2], m2[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float alpha[2];
  float tile[C::kWide ? 1 : D / 2];  // D <= 128: each tile's P V, zeroed, then added
  uint32_t p[3][BN / 4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  // Ping-pong (two consumers): warpgroup 0 goes first; each takes n_tiles + 1 turns.
  const PingPong turn(wg);
  auto take_turn = [&] { if constexpr (NC == 2) turn.wait(); };
  auto pass_turn = [&] { if constexpr (NC == 2) turn.pass(); };
  // Starts tile j-1's P V from the split P in p and the V tile at v.
  auto start_pv = [&](uint32_t v) {
    if constexpr (C::kWide) {
      fence_regs(acc);
      mma_rs_split<D, BN>(acc, p, v);
    } else {
      mma_rs_split<D, BN>(tile, p, v);
    }
    wgmma_commit();
  };

  mbar_wait(bar_q, 0);
  mbar_wait(full_k(0), 0);
  take_turn();
  wgmma_fence();
  mma_ss_split<D, BN>(s, q_wg, sK);
  wgmma_commit();
  pass_turn();
  wgmma_wait<0>();
  fence_regs(s);
  mbar_arrive(empty_k(0));
  online_softmax(s, m2, l, alpha, scale_log2);
  split_rows<BN / 2>(p, s);

  for (int j = 1; j < n_tiles; ++j) {
    const int sj = j % S, sp = (j - 1) % S;
    mbar_wait(full_k(sj), (j / S) & 1);
    mbar_wait(full_v(sp), ((j - 1) / S) & 1);
    if constexpr (!C::kWide) zero_regs(tile);
    take_turn();
    wgmma_fence();
    mma_ss_split<D, BN>(s, q_wg, sK + sj * C::kTile);  // tile j's scores ...
    wgmma_commit();
    start_pv(sV + sp * C::kTile);  // ... while tile j-1's P V follows
    pass_turn();
    wgmma_wait<1>();
    fence_regs(s);
    mbar_arrive(empty_k(sj));
    online_softmax(s, m2, l, alpha, scale_log2);  // overlaps the P V in flight
    wgmma_wait<0>();
    fence_parts(p);
    mbar_arrive(empty_v(sp));
    if constexpr (C::kWide) {
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    } else {
      add_rescaled(acc, tile, alpha);
    }
    split_rows<BN / 2>(p, s);
  }
  const int sl = (n_tiles - 1) % S;
  mbar_wait(full_v(sl), ((n_tiles - 1) / S) & 1);
  if constexpr (!C::kWide) zero_regs(tile);
  take_turn();
  wgmma_fence();
  start_pv(sV + sl * C::kTile);
  if (wg == 0) pass_turn();  // warpgroup 1 has no turn left to wait for
  wgmma_wait<0>();
  if constexpr (C::kWide) fence_regs(acc);
  else add_tile(acc, tile);
  mbar_arrive(empty_v(sl));

  // Epilogue: O / l from registers; LSE = m + ln l.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / l[r];
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= inv[(i >> 1) & 1];
  const int row = q0 + wg * kRows + warp * 16 + lane / 4;  // and row + 8
  const size_t rs = (size_t)gridDim.y * D;  // elements from one query's row to the next
  store_rows_f32<D>(o + ((size_t)b * lq + row) * rs + (size_t)h * D + 2 * (lane % 4), rs, acc);
  if (lse != nullptr && lane % 4 == 0) {  // the quad's lanes hold the same m2, l
    constexpr float kLn2 = 0.69314718055994531f;
    float* out = lse + ((size_t)b * gridDim.y + h) * lq + row;
    out[0] = m2[0] * kLn2 + logf(l[0]);
    out[8] = m2[1] * kLn2 + logf(l[1]);
  }
}

// ------------------------------------------------------------------ host --
template <int D>
int launch_fwd(const void* q, const void* k, const void* v, float* o, float* lse, int batch,
               int heads, int lq, int lk, float scale, cudaStream_t stream) {
  using C = FwdCfg<D>;
  Planes tq, tk, tv;
  if (int err = make_planes<D>(&tq, q, batch, lq, heads, kRows)) return err;
  if (int err = make_planes<D>(&tk, k, batch, lk, heads, C::kBlockN)) return err;
  if (int err = make_planes<D>(&tv, v, batch, lk, heads, C::kBlockN)) return err;
  if (int err = (int)cudaFuncSetAttribute(split_fwd_kernel<D>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)C::kSmem))
    return err;
  split_fwd_kernel<D><<<dim3(lq / C::kBlockM, heads, batch), kThreads, C::kSmem, stream>>>(
      tq, tk, tv, o, lse, lq, lk, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// q (3, B, Lq, H, D), k and v (3, B, Lk, H, D): the bf16 planes of the f32
// operands, 16-byte aligned device buffers; o (B, Lq, H, D) f32; lse (B, H,
// Lq) f32, or null to skip the statistics. Lq, Lk multiples of 128; D in {64,
// 96, 128, 256}. Launches on `stream` and returns a CUDA error code (0 on
// success).
extern "C" int flash_attn_split_fwd_launch(const void* q, const void* k, const void* v, float* o,
                                           float* lse, int batch, int heads, int lq, int lk,
                                           int head_dim, float scale, void* stream) {
  if (lq <= 0 || lk <= 0 || lq % kLength != 0 || lk % kLength != 0 || batch <= 0 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  return dispatch(head_dim, (int)cudaErrorInvalidValue, [&](auto d) {
    return launch_fwd<decltype(d)::value>(q, k, v, o, lse, batch, heads, lq, lk, scale,
                                          (cudaStream_t)stream);
  });
}

// The dynamic shared memory the launcher requests at head_dim (-1: not taken).
extern "C" int flash_attn_split_fwd_smem(int head_dim) {
  return dispatch(head_dim, -1, [](auto d) { return (int)FwdCfg<decltype(d)::value>::kSmem; });
}
