// Flash-attention backward for Hopper (sm_90a): two kernels, bf16 in,
// fp32 accumulation.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` in
// kubeflow_rm_tpu/ops/flash_attention.py (launched by
// `_flash_bwd_pallas`): the same functions, not block-for-block copies.
//
//   S  = Q·Kᵀ·D^-½ (fp32)              P  = exp(S − lse), 0 where masked
//   dP = dO·Vᵀ (fp32)                  dS = P∘(dP − δ)·D^-½
//   dQ = dS·K        dK = dSᵀ·Q        dV = Pᵀ·dO
//
// with δ = rowsum(dO∘O) and lse from the forward, both fp32 per q row.
// The mask is the forward's: causal over local indices ∧ same segment ∧
// in bounds. It SELECTS 0 (never multiplies): a q row that matched no
// key has lse = NEG_INF, so exp(S − lse) is +inf there and inf·0 would
// be NaN. Such a row gets dQ = 0 and adds nothing to dK/dV.
// Rounding points are the TPU kernels': P and dS are rounded to bf16
// right before the tensor-core products that consume them; S, dP, δ,
// lse and the accumulators stay fp32.
//
// Layout: q, o, do (B·Hq, T, D); k, v (B·KVH, T, D), contiguous; lse, δ
// (B·Hq, T) fp32; segq/segkv optional (B, T) int32. GQA without copies:
// q row bh reads kv row bh / group.
//
// Design of dq (warp-specialised, 384 threads; one CTA per (q row bh,
// pair of 128-row q tiles nq − 1 − x and x, the heavy one first), so that
// under the causal mask every CTA has the same work; blocks start in x
// order, so the q tiles of one head and the q heads of one GQA group run
// side by side and share K and V through L2):
// - Warpgroup 0 is the producer: it gives its registers away
//   (setmaxnreg) and one warp loads the two Q and dO tiles once by TMA,
//   then streams K and V tile after tile (DQ_BK rows), for one q tile and
//   then the other, through a K ring and a V ring of DQ_STAGES stages
//   (`full`/`empty` mbarriers). The kv segment ids (4·T-byte rows, not
//   TMA-alignable) travel with the K stage by ordinary loads of that warp.
// - Warpgroups 1 and 2 are the consumers, 64 q rows each. Each thread
//   holds its two rows' lse·log2(e), δ and segment id in registers
//   (ordinary loads). Per kv tile, three wgmmas with fp32 accumulators in
//   registers: S = Q·Kᵀ and dP = dO·Vᵀ with both operands in shared
//   memory (K-major, m64n64k16), then dQ += dS·K with dS rounded to bf16
//   in registers as the A operand and K read MN-major (the transpose
//   bit). Section j issues S_j and dP_j together with dQ += dS_{j−1}·
//   K_{j−1} and computes dS_j while that product runs; the first and the
//   last section are peeled so that no wgmma is issued under a branch
//   (ptxas serialises it there, C7520). V_j is released after dP_j, K_j
//   only after its dQ product one section later, so the K ring is three
//   deep to keep a load in flight. Nothing of S, dP or dS goes through
//   shared memory; dQ (64 x D fp32 a warpgroup) stays in registers and
//   is written as bf16, rows < T, at the end.
// - DQ_BK = 64: S + dP + dQ + bf16 dS take 32 + 32 + 64 + 16 = 144
//   registers a consumer thread at D = 128, under its 240 (DQ_BK = 128
//   would take 224). Shared memory at D = 128: both q tiles' Q and dO
//   (128 KB, resident) + three K and V stages (96 KB) + segment ids and
//   barriers = 230,256 bytes, + 1024 alignment slack under the 232,448 a
//   block may use.
// - Causal: kv tiles wholly in the future of the q tile are never
//   loaded; warpgroup 0 (the tile's first 64 rows) skips the last one,
//   wholly in its rows' future, releasing it once it has arrived. Masking
//   (causal, segments, ragged last kv tile) is `mask_tile`, the forward's
//   −inf pass, on the tiles that need it, before the one code path for P
//   and dS: P = exp2(S·scale·log2e − lse·log2e) is then 0 exactly where
//   masked, even for a row that matched no key, and so is dS.
//
// Design of dkv (warp-specialised, 384 threads; one CTA per (kv row,
// pair of 128-row kv tiles x and nkv − 1 − x, the heavy one first), so
// that under the causal mask every CTA has the same work; blocks start in
// x order, so the kv tiles of one head run side by side and share its Q
// and dO through L2):
// - Warpgroup 0 is the producer: it gives its registers away
//   (setmaxnreg) and one warp loads the two K and V tiles once by TMA,
//   then streams the Q and dO tiles (64 rows) of every q head of the GQA
//   group through a ring of DKV_STAGES stages (TMA, `full`/`empty`
//   mbarriers), for one kv tile and then the other. The q rows' lse, δ
//   and segment ids (4·T-byte rows, not TMA-alignable) go through the
//   same stage by ordinary loads of that warp; lse is stored
//   pre-multiplied by log2(e).
// - Warpgroups 1 and 2 are the consumers, 64 kv rows each. Per q tile,
//   four wgmmas: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with both operands in shared
//   memory (no transpose; m64n64k16, fp32 in registers), then dV += Pᵀ·dO
//   and dK += dSᵀ·Q with Pᵀ and dSᵀ rounded to bf16 in registers as the A
//   operand and dO, Q read MN-major (the transpose bit). dK and dV (64 x
//   D fp32 each) stay in registers for the whole loop.
// - The loop runs over the group's q heads and, for each, over its q
//   tiles from the first that reaches the kv tile's diagonal; a consumer
//   skips the products of a tile wholly in its rows' past. Owning the kv
//   head folds the GQA group inside the CTA in fp32 (the TPU version
//   writes one dK/dV per q head and sums them afterwards): no atomics, no
//   per-head scratch, a deterministic result.
// - Masking (causal, segments, ragged tiles) runs only on tiles that
//   need it, as a pass before the one code path for P and dS: it SELECTS
//   a masked score to −inf, so P = exp2(−inf − lse) is 0 exactly (lse is
//   finite, NEG_INF for a row that matched no key) and so is dS.
//   Zero-filled rows past T give scores of 0, not −∞, so ragged tiles
//   mask by bounds.
//
// Bound: at the Llama-2-7B training shape (B=2, T=2048, H=32, D=128,
// causal) dq does three products and dkv four over ~134 M causal (q, k)
// pairs: ~103 and ~137 GFLOP against ~0.17/0.20 GB of inputs and outputs,
// far above the H100's ~295 bf16 FLOP/byte ridge, so the tensor cores
// bound both (at 989 TFLOP/s: dq 0.104 ms, dkv 0.139 ms). Measured times
// are in PERF.md.

#include "hopper.cuh"

namespace {

using namespace hopper;

// both kernels: a producer warpgroup and two consumer warpgroups
// (hopper.cuh holds the TMA / wgmma / mbarrier pieces)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// dq
constexpr int DQ_BQ = 128;               // q rows per tile: two consumer warpgroups
constexpr int DQ_BK = 64;                // kv rows per ring stage
constexpr int DQ_STAGES = 3;             // depth of the K and V rings
constexpr int DQ_WG_ROWS = 64;           // q rows per consumer warpgroup
constexpr int DQ_THREADS = 384;          // producer warpgroup + 2 consumers

// dkv
constexpr int DKV_BKV = 128;             // kv rows per CTA: two consumer warpgroups
constexpr int DKV_BQ = 64;               // q rows per ring stage
constexpr int DKV_STAGES = 2;            // depth of the Q/dO ring
constexpr int DKV_WG_ROWS = 64;          // kv rows per consumer warpgroup
constexpr int DKV_THREADS = 384;         // producer warpgroup + 2 consumers

// ---------------------------------------------------------------------
// dQ: one CTA per (q row, pair of 128-row q tiles), loop over kv tiles
// ---------------------------------------------------------------------

template <int D>
struct DqSmem {
  bf16 q[2][DQ_BQ * D];              // the CTA's two q tiles, each D/64
  bf16 dout[2][DQ_BQ * D];           // swizzled chunks of (rows x 64)
  bf16 k[DQ_STAGES][DQ_BK * D];
  bf16 v[DQ_STAGES][DQ_BK * D];
  int segkv[DQ_STAGES][DQ_BK];       // travels with K
  uint64_t q_full[2];
  uint64_t k_full[DQ_STAGES], k_empty[DQ_STAGES];
  uint64_t v_full[DQ_STAGES], v_empty[DQ_STAGES];
};
static_assert(sizeof(DqSmem<128>) + 1024 <= 232448,
              "dq's shared memory must fit one block");

// the kv tiles that q rows [r0, r0 + rows) read: causal stops at the
// diagonal of the last row
__device__ __forceinline__ int dq_kv_tiles(int r0, int rows, int nk,
                                           int causal) {
  return causal ? min(nk, (r0 + rows - 1) / DQ_BK + 1) : nk;
}

template <int D>
__device__ __forceinline__ void dq_producer(
    DqSmem<D>& sm, const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const CUtensorMap* map_do,
    const int* __restrict__ segkv, int bh, int b, int kvh, const TilePair& q0,
    int nk, int causal, int T) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    for (int p = 0; p < q0.count; ++p) {
      mbar_arrive_expect_tx(&sm.q_full[p], 2 * DQ_BQ * D * 2);
      tma_load_tile<D, DQ_BQ>(sm.q[p], map_q, &sm.q_full[p], q0[p], bh);
      tma_load_tile<D, DQ_BQ>(sm.dout[p], map_do, &sm.q_full[p], q0[p], bh);
    }
  }
  int it = 0;   // position in the rings, continued from one q tile to the next
  for (int p = 0; p < q0.count; ++p) {
    const int n_tiles = dq_kv_tiles(q0[p], DQ_BQ, nk, causal);
    for (int j = 0; j < n_tiles; ++j, ++it) {
      const int s = it % DQ_STAGES;
      const uint32_t parity = ((it / DQ_STAGES) & 1) ^ 1;
      mbar_wait(&sm.k_empty[s], parity);
      if (segkv != nullptr) {
        for (int c = lane; c < DQ_BK; c += 32) {
          const int col = j * DQ_BK + c;
          sm.segkv[s][c] = col < T ? segkv[(size_t)b * T + col] : 0;
        }
      }
      if (lane == 0) {   // the 32nd arrival, with the tile's TMA bytes
        mbar_arrive_expect_tx(&sm.k_full[s], DQ_BK * D * 2);
        tma_load_tile<D, DQ_BK>(sm.k[s], map_k, &sm.k_full[s], j * DQ_BK,
                                kvh);
      } else {
        mbar_arrive(&sm.k_full[s]);
      }
      mbar_wait(&sm.v_empty[s], parity);
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.v_full[s], DQ_BK * D * 2);
        tma_load_tile<D, DQ_BK>(sm.v[s], map_v, &sm.v_full[s], j * DQ_BK,
                                kvh);
      }
    }
  }
}

// In place on the S and dP accumulators of one kv tile: P =
// exp2(S·scale·log2e − lse·log2e) and dS = P∘(dP − δ)·scale, left in dp.
// A masked score is −inf here, so its p is exp2(−inf) = 0 exactly (lse
// is finite: NEG_INF for a row that matched no key) and so is its ds.
__device__ __forceinline__ void dq_grads(const float (&s)[DQ_BK / 2],
                                         float (&dp)[DQ_BK / 2],
                                         float lse2_0, float lse2_1,
                                         float delta0, float delta1,
                                         float scale, float scale_log2) {
#pragma unroll
  for (int n = 0; n < DQ_BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float p0 = ex2(fmaf(s[4 * n + e], scale_log2, -lse2_0));
      const float p1 = ex2(fmaf(s[4 * n + 2 + e], scale_log2, -lse2_1));
      dp[4 * n + e] = p0 * (dp[4 * n + e] - delta0) * scale;
      dp[4 * n + 2 + e] = p1 * (dp[4 * n + 2 + e] - delta1) * scale;
    }
  }
}

// One q tile (shared-memory slot p, first row q0) against the n_load kv
// tiles the producer streams for it, which hold ring positions it0,
// it0 + 1, ...
template <int D>
__device__ __forceinline__ void dq_consume_tile(
    DqSmem<D>& sm, int p, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ segq,
    bf16* __restrict__ dq, int bh, int b, int q0, int n_load, int it0, int T,
    int causal, float scale) {
  const int cw = threadIdx.x / 128 - 1;        // consumer warpgroup 0 / 1
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int wg_first = q0 + cw * DQ_WG_ROWS;   // its first q row
  const int row0 = wg_first + warp * 16 + lane / 4;
  const int row1 = row0 + 8;
  const int quad = 2 * (lane % 4);             // column offset in an n8 block
  const bool seg = segq != nullptr;
  // causal: the q tile's last kv tile lies wholly in the future of
  // warpgroup 0's rows
  const int n_tiles = dq_kv_tiles(wg_first, DQ_WG_ROWS, n_load, causal);
  float lse2_0 = 0.0f, lse2_1 = 0.0f, delta0 = 0.0f, delta1 = 0.0f;
  int sq0 = 0, sq1 = 0;
  if (row0 < T) {
    lse2_0 = lse[(size_t)bh * T + row0] * LOG2E;
    delta0 = delta[(size_t)bh * T + row0];
    if (seg) sq0 = segq[(size_t)b * T + row0];
  }
  if (row1 < T) {
    lse2_1 = lse[(size_t)bh * T + row1] * LOG2E;
    delta1 = delta[(size_t)bh * T + row1];
    if (seg) sq1 = segq[(size_t)b * T + row1];
  }
  const float scale_log2 = scale * LOG2E;

  float acc[D / 2];                            // dQ
  float s[DQ_BK / 2], dp[DQ_BK / 2];           // S, dP (then dS)
  uint32_t dsa[DQ_BK / 16][4];                 // dS of the previous tile
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.0f;
#pragma unroll
  for (int x = 0; x < DQ_BK / 2; ++x) s[x] = dp[x] = 0.0f;

  mbar_wait(&sm.q_full[p], 0);
  const bf16* qw = sm.q[p] + cw * DQ_WG_ROWS * 64;   // this warpgroup's rows
  const bf16* dow = sm.dout[p] + cw * DQ_WG_ROWS * 64;
  auto stage = [&](int j) { return (it0 + j) % DQ_STAGES; };
  auto phase = [&](int j) { return uint32_t((it0 + j) / DQ_STAGES) & 1u; };

  // S_j = Q·K_jᵀ, dP_j = dO·V_jᵀ: one commit group
  auto issue_s_dp = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int chunk = kk / 4, off = (kk % 4) * 16;
      wgmma_ss<DQ_BK>(
          s, desc_b128(qw + chunk * DQ_BQ * 64 + off, 16, 1024),
          desc_b128(sm.k[st] + chunk * DQ_BK * 64 + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int chunk = kk / 4, off = (kk % 4) * 16;
      wgmma_ss<DQ_BK>(
          dp, desc_b128(dow + chunk * DQ_BQ * 64 + off, 16, 1024),
          desc_b128(sm.v[st] + chunk * DQ_BK * 64 + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // dQ += dS·K (K MN-major as the B operand): the next commit group
  auto issue_dq = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < DQ_BK / 16; ++kk) {
      wgmma_rs_t<D>(acc, dsa[kk],
                    desc_b128(sm.k[st] + kk * 16 * 64, DQ_BK * 64 * 2, 1024));
    }
    wgmma_commit();
  };
  auto grads = [&](int j) {
    const int st = stage(j), k0 = j * DQ_BK;
    // every entry survives unless the tile straddles the diagonal, holds
    // keys past T, or segments are given
    const bool masked = seg || k0 + DQ_BK > T ||
                        (causal && k0 + DQ_BK - 1 > wg_first);
    if (masked) {
      mask_tile<DQ_BK>(s, seg ? sm.segkv[st] : nullptr, k0, row0, row1, sq0,
                       sq1, T, causal, quad);
    }
    dq_grads(s, dp, lse2_0, lse2_1, delta0, delta1, scale, scale_log2);
  };

  // section 0: S_0 and dP_0 only (dQ is still 0)
  mbar_wait(&sm.k_full[stage(0)], phase(0));
  mbar_wait(&sm.v_full[stage(0)], phase(0));
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
  issue_s_dp(stage(0));
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  mbar_arrive(&sm.v_empty[stage(0)]);
  grads(0);
  acc_to_a<DQ_BK>(dp, dsa);

  for (int j = 1; j < n_tiles; ++j) {
    const int st = stage(j), sp = stage(j - 1);
    mbar_wait(&sm.k_full[st], phase(j));
    mbar_wait(&sm.v_full[st], phase(j));
    fence_regs(s);
    fence_regs(dp);
    fence_regs(acc);
    wgmma_fence();
    issue_s_dp(st);
    issue_dq(sp);
    wgmma_wait<1>();                           // S_j, dP_j are in registers
    fence_regs(s);
    fence_regs(dp);
    mbar_arrive(&sm.v_empty[st]);
    grads(j);
    wgmma_wait<0>();                           // dQ += dS_{j−1}·K_{j−1} done
    fence_regs(acc);
    mbar_arrive(&sm.k_empty[sp]);
    acc_to_a<DQ_BK>(dp, dsa);                  // dS_j, bf16, for section j + 1
  }

  // last section: dQ += dS_{n−1}·K_{n−1}
  {
    const int sp = stage(n_tiles - 1);
    fence_regs(acc);
    wgmma_fence();
    issue_dq(sp);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&sm.k_empty[sp]);
  }

  // A tile this warpgroup skips is released only once it has arrived:
  // an arrival before the load could complete the phase of the stage's
  // previous use while the other warpgroup still reads it.
  for (int j = n_tiles; j < n_load; ++j) {
    mbar_wait(&sm.k_full[stage(j)], phase(j));
    mbar_wait(&sm.v_full[stage(j)], phase(j));
    mbar_arrive(&sm.k_empty[stage(j)]);
    mbar_arrive(&sm.v_empty[stage(j)]);
  }

  // epilogue: rows < T, bf16
  __nv_bfloat162* out0 =
      reinterpret_cast<__nv_bfloat162*>(dq + ((size_t)bh * T + row0) * D);
  __nv_bfloat162* out1 =
      reinterpret_cast<__nv_bfloat162*>(dq + ((size_t)bh * T + row1) * D);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c2 = (n * 8 + quad) / 2;
    if (row0 < T) out0[c2] = __floats2bfloat162_rn(acc[4 * n], acc[4 * n + 1]);
    if (row1 < T) {
      out1[c2] = __floats2bfloat162_rn(acc[4 * n + 2], acc[4 * n + 3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ segq,
                    const int* __restrict__ segkv, bf16* __restrict__ dq,
                    int T, int Hq, int group, int causal, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(align1024(smem_raw));

  // A CTA takes q tiles nq − 1 − x and x, one after the other: under the
  // causal mask every CTA then has the same work, and blocks start in x
  // order, so the q tiles of one head (and the heads of one GQA group)
  // run side by side and share its K and V through L2.
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int nq = (T + DQ_BQ - 1) / DQ_BQ;
  const int nk = (T + DQ_BK - 1) / DQ_BK;
  const TilePair q0 = tile_pair(blockIdx.x, nq, DQ_BQ, true);

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full[0], 1);
    mbar_init(&sm.q_full[1], 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&sm.k_full[s], 32);           // the producer warp's lanes
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 2 * 128);     // every consumer thread
      mbar_init(&sm.v_empty[s], 2 * 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // one top-level split, never rejoined, so setmaxnreg takes effect
  if (threadIdx.x < 128) {
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      dq_producer<D>(sm, &map_q, &map_k, &map_v, &map_do, segkv, bh, b,
                     bh / group, q0, nk, causal, T);
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    int it = 0;
    for (int p = 0; p < q0.count; ++p) {
      const int n_load = dq_kv_tiles(q0[p], DQ_BQ, nk, causal);
      dq_consume_tile<D>(sm, p, lse, delta, segq, dq, bh, b, q0[p], n_load,
                         it, T, causal, scale);
      it += n_load;
    }
  }
}

// ---------------------------------------------------------------------
// dK, dV: one CTA per (kv row, 128-row kv tile), loop over the group's q
// heads and their q tiles
// ---------------------------------------------------------------------

template <int D>
struct DkvSmem {
  bf16 k[2][DKV_BKV * D];            // the CTA's two kv tiles, each D/64
  bf16 v[2][DKV_BKV * D];            // swizzled chunks of (rows x 64)
  bf16 q[DKV_STAGES][DKV_BQ * D];
  bf16 dout[DKV_STAGES][DKV_BQ * D];
  float lse2[DKV_STAGES][DKV_BQ];    // lse · log2(e) of the stage's q rows
  float delta[DKV_STAGES][DKV_BQ];
  int segq[DKV_STAGES][DKV_BQ];
  uint64_t kv_full[2];
  uint64_t full[DKV_STAGES];
  uint64_t empty[DKV_STAGES];
};

// the (q head, q tile) of step t of a CTA's loop
struct DkvStep {
  int bh, q0;
};

__device__ __forceinline__ DkvStep dkv_step(int t, int kvr, int group,
                                            int i0, int per_head) {
  return {kvr * group + t / per_head, (i0 + t % per_head) * DKV_BQ};
}

// the first q tile of a head that the kv tile starting at row k0 meets:
// causal skips those wholly before k0
__device__ __forceinline__ int dkv_first_q_tile(int k0, int causal) {
  return causal ? k0 / DKV_BQ : 0;
}

template <int D>
__device__ __forceinline__ void dkv_producer(
    DkvSmem<D>& sm, const CUtensorMap* map_q, const CUtensorMap* map_k,
    const CUtensorMap* map_v, const CUtensorMap* map_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ segq, int kvr, int b, const TilePair& k0,
    int group, int nq, int causal, int T) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    for (int p = 0; p < k0.count; ++p) {
      mbar_arrive_expect_tx(&sm.kv_full[p], 2 * DKV_BKV * D * 2);
      tma_load_tile<D, DKV_BKV>(sm.k[p], map_k, &sm.kv_full[p], k0[p], kvr);
      tma_load_tile<D, DKV_BKV>(sm.v[p], map_v, &sm.kv_full[p], k0[p], kvr);
    }
  }
  int it = 0;   // position in the ring, continued from one kv tile to the next
  for (int p = 0; p < k0.count; ++p) {
    const int i0 = dkv_first_q_tile(k0[p], causal);
    const int per_head = nq - i0;
    for (int t = 0; t < group * per_head; ++t, ++it) {
      const int s = it % DKV_STAGES;
      const DkvStep st = dkv_step(t, kvr, group, i0, per_head);
      mbar_wait(&sm.empty[s], ((it / DKV_STAGES) & 1) ^ 1);
      for (int c = lane; c < DKV_BQ; c += 32) {
        const int row = st.q0 + c;
        const bool in = row < T;
        sm.lse2[s][c] = in ? lse[(size_t)st.bh * T + row] * LOG2E : 0.0f;
        sm.delta[s][c] = in ? delta[(size_t)st.bh * T + row] : 0.0f;
        sm.segq[s][c] =
            (segq != nullptr && in) ? segq[(size_t)b * T + row] : 0;
      }
      if (lane == 0) {   // the 32nd arrival, with the stage's TMA bytes
        mbar_arrive_expect_tx(&sm.full[s], 2 * DKV_BQ * D * 2);
        tma_load_tile<D, DKV_BQ>(sm.q[s], map_q, &sm.full[s], st.q0, st.bh);
        tma_load_tile<D, DKV_BQ>(sm.dout[s], map_do, &sm.full[s], st.q0,
                                 st.bh);
      } else {
        mbar_arrive(&sm.full[s]);
      }
    }
  }
}

// Sets the masked entries of one q tile's Sᵀ to −inf. Entry (n, e)
// holds q row q0 + 8 n + quad + e; for kv row r it is kept iff lo_r <=
// 8 n + e <= hi_r (both rows below T and, causal, the q row not before
// r) and, with segments, the two rows share a segment.
__device__ __forceinline__ void dkv_mask(float (&st)[DKV_BQ / 2],
                                         const int* segq, int q0, int kv0,
                                         int kv1, int sk0, int sk1, bool seg,
                                         int quad, int T, int causal) {
  const int hi = T - 1 - q0 - quad;
  const int hi0 = kv0 < T ? hi : -1, hi1 = kv1 < T ? hi : -1;
  const int lo0 = causal ? kv0 - q0 - quad : 0;
  const int lo1 = causal ? kv1 - q0 - quad : 0;
#pragma unroll
  for (int n = 0; n < DKV_BQ / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int x = 8 * n + e;
      bool keep0 = lo0 <= x && x <= hi0;
      bool keep1 = lo1 <= x && x <= hi1;
      if (seg) {
        const int sq = segq[8 * n + quad + e];
        keep0 = keep0 && sq == sk0;
        keep1 = keep1 && sq == sk1;
      }
      if (!keep0) st[4 * n + e] = -INFINITY;
      if (!keep1) st[4 * n + 2 + e] = -INFINITY;
    }
  }
}

// In place on the Sᵀ and dPᵀ accumulators of one q tile: Pᵀ =
// exp2(Sᵀ·scale·log2e − lse·log2e) and dSᵀ = Pᵀ∘(dPᵀ − δ)·scale. A masked
// entry of Sᵀ is −inf, so its p is exp2(−inf) = 0 exactly (lse is
// finite: NEG_INF for a row that matched no key) and so is its ds.
__device__ __forceinline__ void dkv_probs(float (&st)[DKV_BQ / 2],
                                          float (&dpt)[DKV_BQ / 2],
                                          const float* lse2,
                                          const float* delta, int quad,
                                          float scale, float scale_log2) {
#pragma unroll
  for (int n = 0; n < DKV_BQ / 8; ++n) {
    const int c = n * 8 + quad;
    const float2 l2 = *reinterpret_cast<const float2*>(&lse2[c]);
    const float2 dl = *reinterpret_cast<const float2*>(&delta[c]);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float row_l2 = e ? l2.y : l2.x;
      const float row_dl = e ? dl.y : dl.x;
      float& p0 = st[4 * n + e];
      float& p1 = st[4 * n + 2 + e];
      p0 = ex2(fmaf(p0, scale_log2, -row_l2));
      p1 = ex2(fmaf(p1, scale_log2, -row_l2));
      dpt[4 * n + e] = p0 * (dpt[4 * n + e] - row_dl) * scale;
      dpt[4 * n + 2 + e] = p1 * (dpt[4 * n + 2 + e] - row_dl) * scale;
    }
  }
}

// One kv tile (shared-memory slot p, first row k0) against the q tiles of
// the group's heads, which hold ring positions it0, it0 + 1, ...
template <int D>
__device__ __forceinline__ void dkv_consume_tile(
    DkvSmem<D>& sm, int p, const int* __restrict__ segq,
    const int* __restrict__ segkv, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int kvr, int b, int k0, int group, int nq,
    int it0, int T, int causal, float scale) {
  const int i0 = dkv_first_q_tile(k0, causal);
  const int per_head = nq - i0;
  const int cw = threadIdx.x / 128 - 1;        // consumer warpgroup 0 / 1
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int kv_first = k0 + cw * DKV_WG_ROWS;  // its first kv row
  const int kv0 = kv_first + warp * 16 + lane / 4;
  const int kv1 = kv0 + 8;
  const int quad = 2 * (lane % 4);
  const bool seg = segq != nullptr;
  int sk0 = 0, sk1 = 0;
  if (seg) {
    sk0 = kv0 < T ? segkv[(size_t)b * T + kv0] : 0;
    sk1 = kv1 < T ? segkv[(size_t)b * T + kv1] : 0;
  }
  const float scale_log2 = scale * LOG2E;

  float dk_acc[D / 2], dv_acc[D / 2];
  float st[DKV_BQ / 2], dpt[DKV_BQ / 2];   // Sᵀ, dPᵀ (64 kv x 64 q)
#pragma unroll
  for (int x = 0; x < D / 2; ++x) dk_acc[x] = dv_acc[x] = 0.0f;
#pragma unroll
  for (int x = 0; x < DKV_BQ / 2; ++x) st[x] = dpt[x] = 0.0f;

  mbar_wait(&sm.kv_full[p], 0);
  const bf16* kw = sm.k[p] + cw * DKV_WG_ROWS * 64;   // this warpgroup's rows
  const bf16* vw = sm.v[p] + cw * DKV_WG_ROWS * 64;

  const int n_steps = group * per_head;
  for (int t = 0; t < n_steps; ++t) {
    const int s = (it0 + t) % DKV_STAGES;
    const int q0 = dkv_step(t, kvr, group, i0, per_head).q0;
    mbar_wait(&sm.full[s], ((it0 + t) / DKV_STAGES) & 1);
    if (causal && q0 + DKV_BQ - 1 < kv_first) {   // wholly in the past
      mbar_arrive(&sm.empty[s]);
      continue;
    }

    // Sᵀ = K_w · Qᵀ, dPᵀ = V_w · dOᵀ (64 x 64 each)
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int chunk = kk / 4, off = (kk % 4) * 16;
      wgmma_ss<DKV_BQ>(
          st, desc_b128(kw + chunk * DKV_BKV * 64 + off, 16, 1024),
          desc_b128(sm.q[s] + chunk * DKV_BQ * 64 + off, 16, 1024), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int chunk = kk / 4, off = (kk % 4) * 16;
      wgmma_ss<DKV_BQ>(
          dpt, desc_b128(vw + chunk * DKV_BKV * 64 + off, 16, 1024),
          desc_b128(sm.dout[s] + chunk * DKV_BQ * 64 + off, 16, 1024),
          kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    const bool masked = seg || q0 + DKV_BQ > T ||
                        kv_first + DKV_WG_ROWS > T ||
                        (causal && q0 < kv_first + DKV_WG_ROWS - 1);
    if (masked) {
      dkv_mask(st, sm.segq[s], q0, kv0, kv1, sk0, sk1, seg, quad, T, causal);
    }
    dkv_probs(st, dpt, sm.lse2[s], sm.delta[s], quad, scale, scale_log2);

    // dV += Pᵀ · dO, dK += dSᵀ · Q (bf16 A operands in registers)
    uint32_t pa[DKV_BQ / 16][4], dsa[DKV_BQ / 16][4];
    acc_to_a<DKV_BQ>(st, pa);
    acc_to_a<DKV_BQ>(dpt, dsa);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk) {
      wgmma_rs_t<D>(dv_acc, pa[kk],
                    desc_b128(sm.dout[s] + kk * 16 * 64, DKV_BQ * 64 * 2,
                              1024));
    }
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk) {
      wgmma_rs_t<D>(dk_acc, dsa[kk],
                    desc_b128(sm.q[s] + kk * 16 * 64, DKV_BQ * 64 * 2, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    mbar_arrive(&sm.empty[s]);
  }

  // epilogue: rows < T, bf16
  __nv_bfloat162* k_out0 =
      reinterpret_cast<__nv_bfloat162*>(dk + ((size_t)kvr * T + kv0) * D);
  __nv_bfloat162* k_out1 =
      reinterpret_cast<__nv_bfloat162*>(dk + ((size_t)kvr * T + kv1) * D);
  __nv_bfloat162* v_out0 =
      reinterpret_cast<__nv_bfloat162*>(dv + ((size_t)kvr * T + kv0) * D);
  __nv_bfloat162* v_out1 =
      reinterpret_cast<__nv_bfloat162*>(dv + ((size_t)kvr * T + kv1) * D);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c2 = (n * 8 + quad) / 2;
    if (kv0 < T) {
      k_out0[c2] = __floats2bfloat162_rn(dk_acc[4 * n], dk_acc[4 * n + 1]);
      v_out0[c2] = __floats2bfloat162_rn(dv_acc[4 * n], dv_acc[4 * n + 1]);
    }
    if (kv1 < T) {
      k_out1[c2] = __floats2bfloat162_rn(dk_acc[4 * n + 2],
                                         dk_acc[4 * n + 3]);
      v_out1[c2] = __floats2bfloat162_rn(dv_acc[4 * n + 2],
                                         dv_acc[4 * n + 3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ segq,
                     const int* __restrict__ segkv, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int T, int Hq, int group,
                     int causal, float scale) {
  extern __shared__ unsigned char smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(align1024(smem_raw));

  // A CTA takes kv tiles x and nkv − 1 − x, one after the other: under
  // the causal mask every CTA then has the same work, and blocks start in
  // x order, so the kv tiles of one head run side by side and share its Q
  // and dO through L2.
  const int kvr = blockIdx.y;                // row of (B·KVH)
  const int b = kvr / (Hq / group);
  const int nq = (T + DKV_BQ - 1) / DKV_BQ;
  const int nkv = (T + DKV_BKV - 1) / DKV_BKV;
  const TilePair k0 = tile_pair(blockIdx.x, nkv, DKV_BKV, false);

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full[0], 1);
    mbar_init(&sm.kv_full[1], 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(&sm.full[s], 32);             // the producer warp's lanes
      mbar_init(&sm.empty[s], 2 * 128);       // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  // one top-level split, never rejoined, so setmaxnreg takes effect
  if (threadIdx.x < 128) {
    regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      dkv_producer<D>(sm, &map_q, &map_k, &map_v, &map_do, lse, delta, segq,
                      kvr, b, k0, group, nq, causal, T);
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    int it = 0;
    for (int p = 0; p < k0.count; ++p) {
      dkv_consume_tile<D>(sm, p, segq, segkv, dk, dv, kvr, b, k0[p], group,
                          nq, it, T, causal, scale);
      it += group * (nq - dkv_first_q_tile(k0[p], causal));
    }
  }
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int* segq, const int* segkv, void* dq, int BH,
                      int Hq, int T, int group, int causal, float scale,
                      cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = make_tile_map(&mq, q, BH, T, D, DQ_BQ);
  if (err == cudaSuccess) err = make_tile_map(&mdo, dout, BH, T, D, DQ_BQ);
  if (err == cudaSuccess) err = make_tile_map(&mk, k, BH / group, T, D, DQ_BK);
  if (err == cudaSuccess) err = make_tile_map(&mv, v, BH / group, T, D, DQ_BK);
  if (err != cudaSuccess) return err;
  constexpr int bytes = sizeof(DqSmem<D>) + 1024;   // + alignment slack
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((T + DQ_BQ - 1) / DQ_BQ + 1) / 2, BH);
  flash_bwd_dq_kernel<D><<<grid, DQ_THREADS, bytes, stream>>>(
      mq, mk, mv, mdo, lse, delta, segq, segkv, static_cast<bf16*>(dq), T, Hq,
      group, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const int* segq, const int* segkv, void* dk, void* dv,
                       int BKV, int Hq, int T, int group, int causal,
                       float scale, cudaStream_t stream) {
  const int BH = BKV * group;
  CUtensorMap mq, mk, mv, mdo;
  cudaError_t err = make_tile_map(&mq, q, BH, T, D, DKV_BQ);
  if (err == cudaSuccess) err = make_tile_map(&mdo, dout, BH, T, D, DKV_BQ);
  if (err == cudaSuccess) err = make_tile_map(&mk, k, BKV, T, D, DKV_BKV);
  if (err == cudaSuccess) err = make_tile_map(&mv, v, BKV, T, D, DKV_BKV);
  if (err != cudaSuccess) return err;
  constexpr int bytes = sizeof(DkvSmem<D>) + 1024;   // + alignment slack
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((T + DKV_BKV - 1) / DKV_BKV + 1) / 2, BKV);
  flash_bwd_dkv_kernel<D><<<grid, DKV_THREADS, bytes, stream>>>(
      mq, mk, mv, mdo, lse, delta, segq, segkv, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, Hq, group, causal, scale);
  return cudaGetLastError();
}

// rows (q or kv rows of B·H) is the grid's y dimension
bool bad_shape(int rows, int Hq, int T, int group) {
  return rows <= 0 || rows > 65535 || T <= 0 || Hq <= 0 || group <= 0 ||
         Hq % group != 0;
}

}  // namespace

extern "C" int kfrm_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, const void* segq,
                                 const void* segkv, void* dq, int BH, int Hq,
                                 int T, int D, int group, int causal,
                                 float scale, void* stream) {
  if (bad_shape(BH, Hq, T, group)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* sq = static_cast<const int*>(segq);
  const int* skv = static_cast<const int*>(segkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64:
      err = launch_dq<64>(q, k, v, dout, l, dl, sq, skv, dq, BH, Hq, T, group,
                          causal, scale, s);
      break;
    case 128:
      err = launch_dq<128>(q, k, v, dout, l, dl, sq, skv, dq, BH, Hq, T,
                           group, causal, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int kfrm_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* segq, const void* segkv,
                                  void* dk, void* dv, int BKV, int Hq, int T,
                                  int D, int group, int causal, float scale,
                                  void* stream) {
  if (bad_shape(BKV, Hq, T, group)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* sq = static_cast<const int*>(segq);
  const int* skv = static_cast<const int*>(segkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64:
      err = launch_dkv<64>(q, k, v, dout, l, dl, sq, skv, dk, dv, BKV, Hq, T,
                           group, causal, scale, s);
      break;
    case 128:
      err = launch_dkv<128>(q, k, v, dout, l, dl, sq, skv, dk, dv, BKV, Hq,
                            T, group, causal, scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* kfrm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
