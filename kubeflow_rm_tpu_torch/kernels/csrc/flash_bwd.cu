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
// Design. Both kernels use one CTA of four warps and 64-row tiles; each
// warp owns 16 rows of the CTA's own tile, so the per-row work (masking,
// exp, δ) never leaves the warp and the only CTA-wide barriers are around
// the shared tile loads. Products are bf16 WMMA (mma.sync) tiles with
// fp32 accumulation.
//   dq:  one CTA per (q row bh, 64-row q tile); loops over kv tiles, the
//        TPU grid's sequential axis. The dQ accumulator (16 x D per warp)
//        lives in registers. Causal: kv tiles wholly in the future of the
//        q tile are skipped.
//   dkv: one CTA per (kv row, 64-row kv tile); loops over the group's q
//        heads and, for each, over q tiles. Owning the kv head folds the
//        GQA group inside the CTA in fp32 (the TPU version writes one dK/dV
//        per q head and sums them afterwards), so no atomics and no
//        per-head scratch. The two fp32 accumulators (64 x D each) live in
//        shared memory, which keeps the kernel free of register spills.
//        Causal: q tiles wholly in the past of the kv tile are skipped.
//
// Bound: at the Llama-2-7B training shape (B=2, T=2048, H=32, D=128,
// causal) dq does three products and dkv four over ~134 M causal (q, k)
// pairs: ~103 and ~137 GFLOP against ~0.17/0.20 GB of inputs and outputs,
// far above the H100's ~295 bf16 FLOP/byte ridge, so the tensor cores
// bound both. This first version is simple rather than fast (no TMA, no
// wgmma, no pipelined loads, one or two CTAs per SM); its measured times
// are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;                   // q rows per tile
constexpr int BK = 64;                   // kv rows per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WROWS = 16;                // rows of the CTA's tile per warp

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

template <int D>
struct DkvLayout : Strides<D> {
  using S_ = Strides<D>;
  static constexpr int K = 0;
  static constexpr int V = K + S_::TILE;
  static constexpr int Q = V + S_::TILE;
  static constexpr int DO = Q + S_::TILE;
  static constexpr int S = DO + S_::TILE;
  static constexpr int DP = S + S_::SCORE;
  static constexpr int P = DP + S_::SCORE;
  static constexpr int DS = P + S_::PROB;
  static constexpr int ACC_K = DS + S_::PROB;
  static constexpr int ACC_V = ACC_K + S_::ACC;
  static constexpr int LSE = ACC_V + S_::ACC;
  static constexpr int DELTA = LSE + BQ * 4;
  static constexpr int SEGQ = DELTA + BQ * 4;
  static constexpr int SEGK = SEGQ + BQ * 4;
  static constexpr int BYTES = SEGK + BK * 4;
  static_assert(V % 128 == 0 && Q % 128 == 0 && DO % 128 == 0 &&
                    S % 128 == 0 && DP % 128 == 0 && P % 128 == 0 &&
                    DS % 128 == 0 && ACC_K % 128 == 0 && ACC_V % 128 == 0 &&
                    LSE % 128 == 0,
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

// acc_w (16 x D, fp32 in smem, stride LDA) += A_w (16 x 64 bf16, stride
// LDP) · B (a (64, D) bf16 tile)
template <int D>
__device__ __forceinline__ void accumulate_smem(float* acc, const bf16* a,
                                                const bf16* b) {
  constexpr int LDT = Strides<D>::LDT;
  constexpr int LDA = Strides<D>::LDA;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    FragC c;
    wmma::load_matrix_sync(c, acc + n * 16, LDA, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < 64; kk += 16) {
      FragA fa;
      FragBrow fb;
      wmma::load_matrix_sync(fa, a + kk, Strides<D>::LDP);
      wmma::load_matrix_sync(fb, b + kk * LDT + n * 16, LDT);
      wmma::mma_sync(c, fa, fb, c);
    }
    wmma::store_matrix_sync(acc + n * 16, c, LDA, wmma::mem_row_major);
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
// dK, dV: one CTA per (kv row, 64-row kv tile), loop over the group's q
// heads and their q tiles
// ---------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ segq,
                     const int* __restrict__ segkv, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int T, int Hq, int group,
                     int causal, float scale) {
  using L = DkvLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* sDO = reinterpret_cast<bf16*>(smem + L::DO);
  float* sS = reinterpret_cast<float*>(smem + L::S);
  float* sDP = reinterpret_cast<float*>(smem + L::DP);
  bf16* sP = reinterpret_cast<bf16*>(smem + L::P);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L::DS);
  float* sAccK = reinterpret_cast<float*>(smem + L::ACC_K);
  float* sAccV = reinterpret_cast<float*>(smem + L::ACC_V);
  float* sLse = reinterpret_cast<float*>(smem + L::LSE);
  float* sDelta = reinterpret_cast<float*>(smem + L::DELTA);
  int* sSegQ = reinterpret_cast<int*>(smem + L::SEGQ);
  int* sSegK = reinterpret_cast<int*>(smem + L::SEGK);

  const int kvr = blockIdx.x;              // row of (B·KVH)
  const int j = blockIdx.y;                // early (heavy) kv tiles first
  const int KVH = Hq / group;
  const int b = kvr / KVH;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int k0 = j * BK;
  const int wr0 = warp * WROWS;

  load_tile<D>(sK, k + (size_t)kvr * T * D, k0, T, tid);
  load_tile<D>(sV, v + (size_t)kvr * T * D, k0, T, tid);
  for (int e = tid; e < 64 * L::LDA; e += THREADS) {
    sAccK[e] = 0.0f;
    sAccV[e] = 0.0f;
  }
  if (tid < BK) {   // segkv of the tile's kv rows, for the whole loop
    const int row = k0 + tid;
    sSegK[tid] = (segkv != nullptr && row < T) ? segkv[(size_t)b * T + row]
                                               : 0;
  }

  const int nq = (T + BQ - 1) / BQ;
  const int i0 = causal ? k0 / BQ : 0;   // q tiles wholly before k0 skip

  for (int g = 0; g < group; ++g) {
    const int bh = kvr * group + g;        // q rows reading this kv row
    const bf16* qb = q + (size_t)bh * T * D;
    const bf16* dob = dout + (size_t)bh * T * D;
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * BQ;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      load_tile<D>(sQ, qb, q0, T, tid);
      load_tile<D>(sDO, dob, q0, T, tid);
      if (tid < BQ) {
        const bool in = q0 + tid < T;
        sLse[tid] = in ? lse[(size_t)bh * T + q0 + tid] : 0.0f;
        sDelta[tid] = in ? delta[(size_t)bh * T + q0 + tid] : 0.0f;
        if (segq != nullptr) {
          sSegQ[tid] = in ? segq[(size_t)b * T + q0 + tid] : 0;
        }
      }
      __syncthreads();

      // Sᵀ_w (16 kv x 64 q) = K_w · Qᵀ ; dPᵀ_w = V_w · dOᵀ
      rows_times_tile_t<D>(sS + wr0 * L::LDS, sK + wr0 * L::LDT, sQ);
      rows_times_tile_t<D>(sDP + wr0 * L::LDS, sV + wr0 * L::LDT, sDO);
      __syncwarp();

#pragma unroll 4
      for (int r = 0; r < WROWS; ++r) {
        const int kvg = k0 + wr0 + r;
        const int kv_seg = sSegK[wr0 + r];
        const float* srow = sS + (wr0 + r) * L::LDS;
        const float* dprow = sDP + (wr0 + r) * L::LDS;
        bf16* prow = sP + (wr0 + r) * L::LDP;
        bf16* dsrow = sDS + (wr0 + r) * L::LDP;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = lane + 32 * h;
          const int qg = q0 + col;
          bool keep = kvg < T && qg < T;
          if (causal) keep = keep && (qg >= kvg);
          if (segq != nullptr) keep = keep && (sSegQ[col] == kv_seg);
          const float p = keep ? expf(srow[col] * scale - sLse[col]) : 0.0f;
          prow[col] = __float2bfloat16(p);
          dsrow[col] =
              __float2bfloat16(p * (dprow[col] - sDelta[col]) * scale);
        }
      }
      __syncwarp();

      // dV_w += Pᵀ_w · dO ; dK_w += dSᵀ_w · Q
      accumulate_smem<D>(sAccV + wr0 * L::LDA, sP + wr0 * L::LDP, sDO);
      accumulate_smem<D>(sAccK + wr0 * L::LDA, sDS + wr0 * L::LDP, sQ);
    }
  }

  __syncwarp();
#pragma unroll
  for (int r = 0; r < WROWS; ++r) {
    const int row = k0 + wr0 + r;
    if (row >= T) break;
    const float* krow = sAccK + (wr0 + r) * L::LDA;
    const float* vrow = sAccV + (wr0 + r) * L::LDA;
    __nv_bfloat162* dkrow =
        reinterpret_cast<__nv_bfloat162*>(dk + ((size_t)kvr * T + row) * D);
    __nv_bfloat162* dvrow =
        reinterpret_cast<__nv_bfloat162*>(dv + ((size_t)kvr * T + row) * D);
    for (int d = 2 * lane; d < D; d += 64) {
      dkrow[d / 2] = __floats2bfloat162_rn(krow[d], krow[d + 1]);
      dvrow[d / 2] = __floats2bfloat162_rn(vrow[d], vrow[d + 1]);
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
  constexpr int bytes = DkvLayout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(BKV, (T + BK - 1) / BK);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      segq, segkv, static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, Hq,
      group, causal, scale);
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
