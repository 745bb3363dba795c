// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
//
// Replaces the TPU kernel `_fwd_kernel` in
// kubeflow_rm_tpu/ops/flash_attention.py (launched by `_flash_call`):
// the same function, not a block-for-block copy.
//
//   S = Q·Kᵀ·D^-½ (fp32), masked by causal-over-local-index ∧ same-segment
//   ∧ in-bounds; running (m, l, acc) in fp32 over kv tiles;
//   O = acc / l (bf16), lse = m + log l (fp32, natural log).
//   A row that matched no key (l == 0) writes O = 0 and lse = NEG_INF.
//
// Layout: q (B·Hq, T, D), k/v (B·KVH, T, D) contiguous; segq/segkv
// optional (B, T) int32; o like q; lse (B·Hq, T). GQA without copies:
// q row bh reads kv row bh / group (= b·KVH + h / G since Hq = KVH·G).
//
// Design (warp-specialised, 384 threads; one CTA per (bh, pair of
// 128-row q tiles nq − 1 − x and x, the heavy one first), so that under
// the causal mask every CTA has the same work; blocks start in x order,
// so the tiles of one head run side by side and share its K and V
// through L2):
// - Warpgroup 0 is the producer. It gives its registers away
//   (setmaxnreg) and one of its warps issues the TMA loads: the two Q
//   tiles once, then K and V tile after tile, for one q tile and then the
//   other, into a ring of STAGES shared-memory stages, each signalled by a
//   `full` mbarrier and released by an `empty` one. The kv segment ids of
//   a tile (4·T-byte rows, not TMA-alignable) go through the same stage
//   by ordinary loads of that warp.
// - Warpgroups 1 and 2 are the consumers, 64 q rows each. Per kv tile:
//   S = Q·Kᵀ is one chain of m64n128k16 wgmmas, both operands from
//   shared memory (K as stored is K-major for the B operand), with the
//   fp32 accumulator in registers. The online softmax runs on those
//   registers in the exp2 domain; a row's max and sum are reduced over
//   the 4 threads that hold it, by shuffles. P is rounded to bf16 in
//   registers and is the register A operand of O += P·V (V is MN-major
//   as the B operand: the transpose bit), with O in registers. Nothing
//   of S, P or O goes through shared memory. The two warpgroups take
//   turns at the tensor cores (named barriers), each overlapping its
//   softmax with the products in flight.
// - BQ = BK = 128: two 64-row warpgroups fill the q tile, and a 128-wide
//   kv tile is the widest S accumulator (64 registers) that leaves room
//   for O (64 at D = 128) and the bf16 P (32) under the 240 registers a
//   consumer gets. Two stages of K and V (128 KB at D = 128) plus the two
//   Q tiles (64 KB) fit in shared memory with one CTA per SM.
// - Causal: kv tiles entirely in the future of the q tile are never
//   loaded. Masking (causal, segments, ragged last tile) runs only on the
//   tiles that need it, as a pass before the one softmax code path: it
//   SELECTS a masked score to −inf, so its p = exp2(−inf) is 0 exactly.
//   It is never computed through exp(NEG_INF − m): while every key so far
//   is masked, m is NEG_INF and that exp(0) would leak. (One softmax path
//   instead of a masked and an unmasked copy of it measured faster even
//   on tiles that need no mask.) A zero-filled key row past T scores 0,
//   not −∞, so the ragged last tile masks by bounds too. lse is written
//   in the natural log.
//
// Bound: at the Llama-2-7B forward shape (B=2, T=2048, H=32, D=128,
// causal) the work is ~69 GFLOP against ~135 MB of q/k/v/O/lse, i.e.
// ~500 FLOP/byte, above the H100's ~295 bf16 FLOP/byte ridge: the
// tensor cores bound it. Measured times are in PERF.md.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;          // q rows per CTA: two consumer warpgroups
constexpr int BK = 128;          // kv rows per tile
constexpr int STAGES = 2;        // depth of the K/V ring
constexpr int WG_ROWS = 64;      // q rows per consumer warpgroup
constexpr int THREADS = 384;     // producer warpgroup + 2 consumers
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float NEG_INF = -1073741824.0f;  // -2^30, finite like the TPU kernel

template <int D>
struct Smem {
  bf16 q[2][BQ * D];             // the CTA's two q tiles, each D/64
                                 // swizzled chunks of (BQ x 64)
  bf16 k[STAGES][BK * D];
  bf16 v[STAGES][BK * D];
  int segkv[STAGES][BK];         // travels with K
  uint64_t q_full[2];
  uint64_t k_full[STAGES], k_empty[STAGES];
  uint64_t v_full[STAGES], v_empty[STAGES];
};

// the kv tiles a q tile starting at row q0 reads: causal stops at the
// diagonal of its last row
__device__ __forceinline__ int kv_tiles(int q0, int nk, int causal) {
  return causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
}

template <int D>
__device__ __forceinline__ void producer(Smem<D>& sm, const CUtensorMap* map_q,
                                         const CUtensorMap* map_k,
                                         const CUtensorMap* map_v,
                                         const int* __restrict__ segkv,
                                         int bh, int b, int kvh,
                                         const TilePair& q0, int nk,
                                         int causal, int T) {
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    for (int p = 0; p < q0.count; ++p) {
      mbar_arrive_expect_tx(&sm.q_full[p], BQ * D * 2);
      tma_load_tile<D, BQ>(sm.q[p], map_q, &sm.q_full[p], q0[p], bh);
    }
  }
  int it = 0;   // position in the ring, continued from one q tile to the next
  for (int p = 0; p < q0.count; ++p) {
    const int n_tiles = kv_tiles(q0[p], nk, causal);
    for (int j = 0; j < n_tiles; ++j, ++it) {
      const int s = it % STAGES;
      const uint32_t parity = ((it / STAGES) & 1) ^ 1;
      mbar_wait(&sm.k_empty[s], parity);
      if (segkv != nullptr) {
        for (int c = lane; c < BK; c += 32) {
          const int col = j * BK + c;
          sm.segkv[s][c] = col < T ? segkv[(size_t)b * T + col] : 0;
        }
      }
      if (lane == 0) {   // the 32nd arrival, with the tile's TMA bytes
        mbar_arrive_expect_tx(&sm.k_full[s], BK * D * 2);
        tma_load_tile<D, BK>(sm.k[s], map_k, &sm.k_full[s], j * BK, kvh);
      } else {
        mbar_arrive(&sm.k_full[s]);
      }
      mbar_wait(&sm.v_empty[s], parity);
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.v_full[s], BK * D * 2);
        tma_load_tile<D, BK>(sm.v[s], map_v, &sm.v_full[s], j * BK, kvh);
      }
    }
  }
}

// The online softmax of one kv tile on the S accumulator registers, in
// the log2 domain: S becomes P = exp2(S·scale·log2e − m_new); m and this
// thread's share of the row sums l move on, and corr returns the factors
// that rescale what O holds. A masked score is −inf here, so its p is
// exp2(−inf) = 0 exactly: m is finite (NEG_INF while nothing is kept),
// so the masked entries never take the exp(NEG_INF − m) = 1 that would
// leak into a row whose keys are all masked so far.
__device__ __forceinline__ void softmax_tile(float (&sacc)[BK / 2],
                                             float scale_log2, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& corr0, float& corr1) {
  // the row max of the raw scores, in two chains per row; scale_log2 > 0
  // takes it to the log2 domain afterwards
  float mx0[2] = {-INFINITY, -INFINITY}, mx1[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx0[e] = fmaxf(mx0[e], sacc[4 * n + e]);
      mx1[e] = fmaxf(mx1[e], sacc[4 * n + 2 + e]);
    }
  }
  float new0 = fmaxf(mx0[0], mx0[1]), new1 = fmaxf(mx1[0], mx1[1]);
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {   // the 4 threads of a row
    new0 = fmaxf(new0, __shfl_xor_sync(0xffffffffu, new0, off));
    new1 = fmaxf(new1, __shfl_xor_sync(0xffffffffu, new1, off));
  }
  // a row with nothing kept so far keeps m = NEG_INF (−inf · scale is −inf)
  new0 = fmaxf(m0, new0 * scale_log2);
  new1 = fmaxf(m1, new1 * scale_log2);
  corr0 = ex2(m0 - new0);
  corr1 = ex2(m1 - new1);
  m0 = new0;
  m1 = new1;
  float sum0[2] = {0.0f, 0.0f}, sum1[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float& p0 = sacc[4 * n + e];
      float& p1 = sacc[4 * n + 2 + e];
      p0 = ex2(fmaf(p0, scale_log2, -new0));
      p1 = ex2(fmaf(p1, scale_log2, -new1));
      sum0[e] += p0;
      sum1[e] += p1;
    }
  }
  l0 = l0 * corr0 + (sum0[0] + sum0[1]);
  l1 = l1 * corr1 + (sum1[0] + sum1[1]);
}

// One q tile (shared-memory slot p, first row q0) against its n_tiles kv
// tiles, which hold ring positions it0, it0 + 1, ...
template <int D>
__device__ __forceinline__ void consume_tile(Smem<D>& sm, int p,
                                             const int* __restrict__ segq,
                                             bf16* __restrict__ o,
                                             float* __restrict__ lse, int bh,
                                             int b, int q0, int n_tiles,
                                             int it0, int T, int causal,
                                             float scale) {
  const int cw = threadIdx.x / 128 - 1;        // consumer warpgroup 0 / 1
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int wg_first = q0 + cw * WG_ROWS;      // its first q row
  const int row0 = wg_first + warp * 16 + lane / 4;
  const int row1 = row0 + 8;
  const int quad = 2 * (lane % 4);             // column offset in an n8 block
  const bool seg = segq != nullptr;
  int sq0 = 0, sq1 = 0;
  if (seg) {
    sq0 = row0 < T ? segq[(size_t)b * T + row0] : 0;
    sq1 = row1 < T ? segq[(size_t)b * T + row1] : 0;
  }
  const float scale_log2 = scale * LOG2E;

  float acc[D / 2];
  float sacc[BK / 2];
  uint32_t pa[BK / 16][4];                     // P of the previous tile
#pragma unroll
  for (int x = 0; x < D / 2; ++x) acc[x] = 0.0f;
#pragma unroll
  for (int x = 0; x < BK / 2; ++x) sacc[x] = 0.0f;
  // running max (log2 units) and this thread's share of the row sum
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(&sm.q_full[p], 0);
  const bf16* qw = sm.q[p] + cw * WG_ROWS * 64;   // this warpgroup's rows
  auto stage = [&](int j) { return (it0 + j) % STAGES; };
  auto phase = [&](int j) { return uint32_t((it0 + j) / STAGES) & 1u; };

  // The two warpgroups take turns at the tensor cores: named barrier
  // 1 + w lets warpgroup w issue its products, after which it hands the
  // turn over and runs its softmax while its own and the other's
  // products run. Section j issues S_j = Q·K_jᵀ and O += P_{j−1}·V_{j−1};
  // the first and the last section are peeled so that no product is
  // issued under a branch (ptxas serialises wgmma there, C7520).
  const int my_turn = 1 + cw, other_turn = 2 - cw;
  if (cw == 1) named_arrive(1, 256);           // warpgroup 0 starts
  auto issue_s = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int chunk = kk / 4, off = (kk % 4) * 16;
      wgmma_ss<BK>(sacc, desc_b128(qw + chunk * BQ * 64 + off, 16, 1024),
                   desc_b128(sm.k[st] + chunk * BK * 64 + off, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wgmma_rs_t<D>(acc, pa[kk],
                    desc_b128(sm.v[st] + kk * 16 * 64, BK * 64 * 2, 1024));
    }
    wgmma_commit();
  };
  float corr0, corr1;
  auto softmax = [&](int j) {
    const int st = stage(j), k0 = j * BK;
    // every entry survives unless the tile straddles the diagonal, holds
    // keys past T, or segments are given
    const bool masked = seg || k0 + BK > T ||
                        (causal && k0 + BK - 1 > wg_first);
    if (masked) {
      mask_tile<BK>(sacc, seg ? sm.segkv[st] : nullptr, k0, row0, row1, sq0,
                    sq1, T, causal, quad);
    }
    softmax_tile(sacc, scale_log2, m0, m1, l0, l1, corr0, corr1);
    mbar_arrive(&sm.k_empty[st]);
  };

  // section 0: S_0 only (O is still 0)
  mbar_wait(&sm.k_full[stage(0)], phase(0));
  named_sync(my_turn, 256);
  fence_regs(sacc);
  wgmma_fence();
  issue_s(stage(0));
  named_arrive(other_turn, 256);
  wgmma_wait<0>();
  fence_regs(sacc);
  softmax(0);
  acc_to_a<BK>(sacc, pa);

  for (int j = 1; j < n_tiles; ++j) {
    const int s = stage(j), sp = stage(j - 1);
    mbar_wait(&sm.k_full[s], phase(j));
    mbar_wait(&sm.v_full[sp], phase(j - 1));
    named_sync(my_turn, 256);
    fence_regs(sacc);
    fence_regs(acc);
    wgmma_fence();
    issue_s(s);
    issue_pv(sp);
    named_arrive(other_turn, 256);
    wgmma_wait<1>();                           // S_j is in registers
    fence_regs(sacc);
    softmax(j);
    wgmma_wait<0>();                           // O += P_{j−1}·V_{j−1} done
    fence_regs(acc);
    mbar_arrive(&sm.v_empty[sp]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[4 * n] *= corr0;
      acc[4 * n + 1] *= corr0;
      acc[4 * n + 2] *= corr1;
      acc[4 * n + 3] *= corr1;
    }
    acc_to_a<BK>(sacc, pa);                    // P_j, bf16, for section j + 1
  }

  // last section: O += P_{n−1}·V_{n−1}
  {
    const int sp = stage(n_tiles - 1);
    mbar_wait(&sm.v_full[sp], phase(n_tiles - 1));
    named_sync(my_turn, 256);
    fence_regs(acc);
    wgmma_fence();
    issue_pv(sp);
    if (cw == 0) named_arrive(other_turn, 256);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&sm.v_empty[sp]);
  }

  // epilogue: O = acc / l, lse = m·ln2 + log l (l == 0: O = 0, lse =
  // NEG_INF); the row sum is completed over the quad first
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = l0 == 0.0f ? 1.0f : l0;
  const float d1 = l1 == 0.0f ? 1.0f : l1;
  __nv_bfloat162* out0 =
      reinterpret_cast<__nv_bfloat162*>(o + ((size_t)bh * T + row0) * D);
  __nv_bfloat162* out1 =
      reinterpret_cast<__nv_bfloat162*>(o + ((size_t)bh * T + row1) * D);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c2 = (n * 8 + quad) / 2;
    if (row0 < T) {
      out0[c2] = __floats2bfloat162_rn(acc[4 * n] / d0, acc[4 * n + 1] / d0);
    }
    if (row1 < T) {
      out1[c2] = __floats2bfloat162_rn(acc[4 * n + 2] / d1,
                                       acc[4 * n + 3] / d1);
    }
  }
  if (lane % 4 == 0) {
    if (row0 < T) {
      lse[(size_t)bh * T + row0] =
          l0 == 0.0f ? NEG_INF : m0 * LN2 + logf(l0);
    }
    if (row1 < T) {
      lse[(size_t)bh * T + row1] =
          l1 == 0.0f ? NEG_INF : m1 * LN2 + logf(l1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const int* __restrict__ segq,
                 const int* __restrict__ segkv, bf16* __restrict__ o,
                 float* __restrict__ lse, int T, int Hq, int group,
                 int causal, float scale) {
  extern __shared__ unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(align1024(smem_raw));

  // A CTA takes q tiles nq − 1 − x and x, one after the other: under the
  // causal mask every CTA then has the same work, and blocks start in x
  // order, so the q tiles of one head run side by side and share its K
  // and V through L2.
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int nq = (T + BQ - 1) / BQ;
  const int nk = (T + BK - 1) / BK;
  const TilePair q0 = tile_pair(blockIdx.x, nq, BQ, true);

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full[0], 1);
    mbar_init(&sm.q_full[1], 1);
    for (int s = 0; s < STAGES; ++s) {
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
      producer<D>(sm, &map_q, &map_k, &map_v, segkv, bh, b, bh / group, q0,
                  nk, causal, T);
    }
  } else {
    regs_alloc<CONSUMER_REGS>();
    int it = 0;
    for (int p = 0; p < q0.count; ++p) {
      const int n_tiles = kv_tiles(q0[p], nk, causal);
      consume_tile<D>(sm, p, segq, o, lse, bh, b, q0[p], n_tiles, it, T,
                      causal, scale);
      it += n_tiles;
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* segq, const int* segkv, void* o, float* lse,
                   int BH, int Hq, int T, int group, int causal, float scale,
                   cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_tile_map(&mq, q, BH, T, D, BQ);
  if (err == cudaSuccess) err = make_tile_map(&mk, k, BH / group, T, D, BK);
  if (err == cudaSuccess) err = make_tile_map(&mv, v, BH / group, T, D, BK);
  if (err != cudaSuccess) return err;
  constexpr int bytes = sizeof(Smem<D>) + 1024;   // + alignment slack
  err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((T + BQ - 1) / BQ + 1) / 2, BH);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      mq, mk, mv, segq, segkv, static_cast<bf16*>(o), lse, T, Hq, group,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int kfrm_flash_fwd(const void* q, const void* k, const void* v,
                              const void* segq, const void* segkv, void* o,
                              void* lse, int BH, int Hq, int T, int D,
                              int group, int causal, float scale,
                              void* stream) {
  if (BH <= 0 || T <= 0 || Hq <= 0 || group <= 0 || BH % group != 0 ||
      BH > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* sq = static_cast<const int*>(segq);
  const int* skv = static_cast<const int*>(segkv);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 64:
      err = launch<64>(q, k, v, sq, skv, o, l, BH, Hq, T, group, causal,
                       scale, s);
      break;
    case 128:
      err = launch<128>(q, k, v, sq, skv, o, l, BH, Hq, T, group, causal,
                        scale, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* kfrm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
