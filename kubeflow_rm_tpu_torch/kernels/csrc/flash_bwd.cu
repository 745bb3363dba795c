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
// Design of dq (a redesign waits for its own change): one CTA of four
// warps per (q row bh, 64-row q tile); each warp owns 16 rows of the
// tile, so the per-row work (masking, exp, δ) never leaves the warp and
// the only CTA-wide barriers are around the shared tile loads. Products
// are bf16 WMMA (mma.sync) tiles with fp32 accumulation; the dQ
// accumulator (16 x D per warp) lives in registers. It loops over kv
// tiles, the TPU grid's sequential axis; causal: kv tiles wholly in the
// future of the q tile are skipped.
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
// bound both. Measured times are in PERF.md.

#include "hopper.cuh"

#include <mma.h>

using namespace nvcuda;

namespace {

using namespace hopper;

constexpr int BQ = 64;                   // q rows per tile
constexpr int BK = 64;                   // kv rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WROWS = 16;                // rows of the CTA's tile per warp

// dkv (hopper.cuh holds the TMA / wgmma / mbarrier pieces)
constexpr int DKV_BKV = 128;             // kv rows per CTA: two consumer warpgroups
constexpr int DKV_BQ = 64;               // q rows per ring stage
constexpr int DKV_STAGES = 2;            // depth of the Q/dO ring
constexpr int DKV_WG_ROWS = 64;          // kv rows per consumer warpgroup
constexpr int DKV_THREADS = 384;         // producer warpgroup + 2 consumers
constexpr int DKV_PRODUCER_REGS = 24;
constexpr int DKV_CONSUMER_REGS = 240;

using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBrow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBcol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Padded row strides (+8 bf16 / +4 fp32) spread WMMA loads over the
// banks; every region and every 16 x 16 sub-tile stays 32-byte aligned.
template <int D>
struct Strides {
  static constexpr int LDT = D + 8;      // bf16 (64, D) tiles
  static constexpr int LDS = 64 + 4;     // fp32 (64, 64) score tiles
  static constexpr int LDP = 64 + 8;     // bf16 (64, 64) P / dS tiles
  static constexpr int LDA = D + 4;      // fp32 (64, D) accumulators
  static constexpr int TILE = 64 * LDT * 2;
  static constexpr int SCORE = 64 * LDS * 4;
  static constexpr int PROB = 64 * LDP * 2;
  static constexpr int ACC = 64 * LDA * 4;
};

template <int D>
struct DqLayout : Strides<D> {
  using S_ = Strides<D>;
  static constexpr int Q = 0;
  static constexpr int DO = Q + S_::TILE;
  static constexpr int K = DO + S_::TILE;
  static constexpr int V = K + S_::TILE;
  static constexpr int S = V + S_::TILE;
  static constexpr int DP = S + S_::SCORE;
  static constexpr int DS = DP + S_::SCORE;
  static constexpr int SEG = DS + S_::PROB;        // segkv of the kv tile
  static constexpr int LSE = SEG + BK * 4;         // per q row of the tile
  static constexpr int DELTA = LSE + BQ * 4;
  static constexpr int SEGQ = DELTA + BQ * 4;
  static constexpr int BYTES = SEGQ + BQ * 4;
  // the epilogue stages dQ (fp32) over the Q and dO tiles
  static_assert(S_::ACC <= 2 * S_::TILE, "dQ staging must fit over Q, dO");
  static_assert(DO % 128 == 0 && K % 128 == 0 && V % 128 == 0 &&
                    S % 128 == 0 && DP % 128 == 0 && DS % 128 == 0 &&
                    SEG % 128 == 0,
                "shared-memory regions must stay aligned");
};

// rows [r0, r0 + 64) of a (T, D) bf16 matrix into a padded smem tile,
// 16 bytes per thread per step; rows past T are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int T, int tid) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = D / VEC;
  for (int e = tid; e < 64 * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW;
    const int c = (e % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * Strides<D>::LDT + c) = val;
  }
}

// out (16 x 64, fp32, stride LDS) = A_w (16 x D, rows of a tile) ·
// Bᵀ (B a (64, D) tile read as a col-major operand)
template <int D>
__device__ __forceinline__ void rows_times_tile_t(float* out, const bf16* a,
                                                  const bf16* b) {
  constexpr int LDT = Strides<D>::LDT;
  FragC c[BK / 16];
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(c[n], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, LDT);
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      FragBcol fb;  // element (d, col) = b[col][d]
      wmma::load_matrix_sync(fb, b + n * 16 * LDT + kk, LDT);
      wmma::mma_sync(c[n], fa, fb, c[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::store_matrix_sync(out + n * 16, c[n], Strides<D>::LDS,
                            wmma::mem_row_major);
  }
}

// ---------------------------------------------------------------------
// dQ: one CTA per (bh, 64-row q tile), loop over kv tiles
// ---------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ segq,
                    const int* __restrict__ segkv, bf16* __restrict__ dq,
                    int T, int Hq, int group, int causal, float scale) {
  using L = DqLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L::DO);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V);
  float* sS = reinterpret_cast<float*>(smem + L::S);
  float* sDP = reinterpret_cast<float*>(smem + L::DP);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::DS);
  int* sSeg = reinterpret_cast<int*>(smem + L::SEG);
  float* sLse = reinterpret_cast<float*>(smem + L::LSE);
  float* sDelta = reinterpret_cast<float*>(smem + L::DELTA);
  int* sSegQ = reinterpret_cast<int*>(smem + L::SEGQ);

  const int bh = blockIdx.x;
  const int i = gridDim.y - 1 - blockIdx.y;  // late (heavy) q tiles first
  const int b = bh / Hq;
  const int kvh = bh / group;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = i * BQ;
  const int wr0 = warp * WROWS;

  load_tile<D>(sQ, q + (size_t)bh * T * D, q0, T, tid);
  load_tile<D>(sDO, dout + (size_t)bh * T * D, q0, T, tid);
  const bf16* kb = k + (size_t)kvh * T * D;
  const bf16* vb = v + (size_t)kvh * T * D;

  // per-row statistics in shared memory, not registers: the dQ
  // accumulator already holds D/2 registers per thread
  if (tid < BQ) {
    const int row = q0 + tid;
    const bool in = row < T;
    sLse[tid] = in ? lse[(size_t)bh * T + row] : 0.0f;
    sDelta[tid] = in ? delta[(size_t)bh * T + row] : 0.0f;
    sSegQ[tid] = (segq != nullptr && in) ? segq[(size_t)b * T + row] : 0;
  }

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);

  int n_tiles = (T + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb, k0, T, tid);
    load_tile<D>(sV, vb, k0, T, tid);
    if (segkv != nullptr && tid < BK) {
      sSeg[tid] = (k0 + tid < T) ? segkv[(size_t)b * T + k0 + tid] : 0;
    }
    __syncthreads();

    rows_times_tile_t<D>(sS + wr0 * L::LDS, sQ + wr0 * L::LDT, sK);
    rows_times_tile_t<D>(sDP + wr0 * L::LDS, sDO + wr0 * L::LDT, sV);
    __syncwarp();

    // dS for the warp's 16 rows; lane owns columns lane, lane + 32
#pragma unroll 4
    for (int r = 0; r < WROWS; ++r) {
      const int row = q0 + wr0 + r;
      const float row_lse = sLse[wr0 + r];
      const float row_delta = sDelta[wr0 + r];
      const int row_seg = sSegQ[wr0 + r];
      const float* srow = sS + (wr0 + r) * L::LDS;
      const float* dprow = sDP + (wr0 + r) * L::LDS;
      bf16* dsrow = sDS + (wr0 + r) * L::LDP;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = lane + 32 * h;
        const int colg = k0 + col;
        bool keep = row < T && colg < T;
        if (causal) keep = keep && (row >= colg);
        if (segq != nullptr) keep = keep && (row_seg == sSeg[col]);
        const float p = keep ? expf(srow[col] * scale - row_lse) : 0.0f;
        dsrow[col] = __float2bfloat16(p * (dprow[col] - row_delta) * scale);
      }
    }
    __syncwarp();

    // dQ_w (16 x D) += dS_w (16 x 64) · K (64 x D)
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa;
      wmma::load_matrix_sync(fa, sDS + wr0 * L::LDP + kk, L::LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        FragBrow fb;
        wmma::load_matrix_sync(fb, sK + kk * L::LDT + n * 16, L::LDT);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
  }

  // epilogue: stage dQ (fp32) over the Q/dO tiles, write bf16 rows < T
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem + L::Q);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::store_matrix_sync(stage + wr0 * L::LDA + n * 16, acc[n], L::LDA,
                            wmma::mem_row_major);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < WROWS; ++r) {
    const int row = q0 + wr0 + r;
    if (row >= T) break;  // rows only grow with r
    const float* arow = stage + (wr0 + r) * L::LDA;
    __nv_bfloat162* orow =
        reinterpret_cast<__nv_bfloat162*>(dq + ((size_t)bh * T + row) * D);
    for (int d = 2 * lane; d < D; d += 64) {
      orow[d / 2] = __floats2bfloat162_rn(arow[d], arow[d + 1]);
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
    regs_dealloc<DKV_PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      dkv_producer<D>(sm, &map_q, &map_k, &map_v, &map_do, lse, delta, segq,
                      kvr, b, k0, group, nq, causal, T);
    }
  } else {
    regs_alloc<DKV_CONSUMER_REGS>();
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
  constexpr int bytes = DqLayout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BH, (T + BQ - 1) / BQ);
  flash_bwd_dq_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      segq, segkv, static_cast<bf16*>(dq), T, Hq, group, causal, scale);
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

bool bad_shape(int rows, int Hq, int T, int group) {
  return rows <= 0 || T <= 0 || Hq <= 0 || group <= 0 || Hq % group != 0 ||
         (T + 63) / 64 > 65535;
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
  if (bad_shape(BKV, Hq, T, group) || BKV > 65535) {
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
