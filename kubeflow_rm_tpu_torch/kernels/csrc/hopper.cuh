// Hopper (sm_90a) building blocks of the flash kernels: TMA tile loads
// into mbarrier-signalled rings, wgmma with fp32 accumulators in
// registers, register rebalancing between warpgroups, and the host-side
// encoding of TMA tensor maps.
//
// Tile layout in shared memory. A (rows x D) bf16 tile is stored as D/64
// chunks of (rows x 64): TMA's 128-byte swizzle limits a box's inner
// extent to 128 bytes, so a D = 128 row arrives as two 64-column boxes.
// Inside a chunk, row r occupies bytes [128 r, 128 r + 128) with its 16-
// byte groups permuted by (group ^ r % 8): the B128 swizzle that TMA
// writes and that the wgmma descriptors below describe. Every chunk
// starts on a 1024-byte boundary (one 8-row swizzle atom), so the
// descriptors' base offset is 0.
//
// Traps handled here:
// - TMA wants 16-byte-aligned global strides. q/k/v/dO rows are D·2 =
//   128 or 256 bytes, so they load by TMA; the maps are 3-D (D, T, rows)
//   so a ragged last tile reads zeros inside its own head instead of the
//   next head's rows. The fp32 row statistics and the int32 segment ids
//   have a row stride of 4·T bytes, not 16-aligned for T % 4 != 0, so
//   the kernels load those with ordinary loads.
// - `setmaxnreg` only takes effect under one top-level if/else on the
//   warpgroup index whose branches never meet again (else ptxas warns
//   C7508 and ignores it); the kernels are written that way.
// - cuTensorMapEncodeTiled is a driver function. It is fetched through
//   the runtime's driver entry point, so the library links no -lcuda.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; header only, no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x in one SFU instruction (exp2f adds a range fix-up around it); the
// kernels call it on x <= 0, where flushing results below 2^-126 to 0
// changes no bf16 product
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte boundary at or after p (dynamic shared memory is
// only guaranteed 16-byte alignment; launches allocate 1024 bytes extra)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes the inits visible to the async proxy (TMA) and to every thread;
// follow with __syncthreads()
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of TMA traffic on this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// rows [r0, r0 + ROWS) of plane `plane` of a (planes, T, D) tensor into a
// tile of D/64 swizzled chunks; completion is counted on `bar`
template <int D, int ROWS>
__device__ __forceinline__ void tma_load_tile(bf16* dst, const CUtensorMap* map,
                                              uint64_t* bar, int r0,
                                              int plane) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    tma_load_3d(dst + c * ROWS * 64, map, bar, c * 64, r0, plane);
  }
}

// ---------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------

// Shared-memory matrix descriptor, B128 swizzle. K-major operands (the
// reduction dimension contiguous: Q and K for S = Q·Kᵀ) step 8-row groups
// by SBO = 1024 bytes and ignore LBO; a k16 step inside a 64-wide chunk
// adds 32 bytes to the start address. MN-major operands (V for P·V, Q
// and dO for the dK/dV products: read with the transpose bit) step 8-row
// groups of the reduction dimension by SBO = 1024 bytes and 64-column
// chunks of the output dimension by LBO = the chunk's size in bytes.
__device__ __forceinline__ uint64_t desc_b128(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keeps the compiler from moving register accesses across the
// asynchronous products that read and write these registers
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout of m64nNk16 (fp32, N/2 registers a thread): in
// warp w of the warpgroup, lane l holds d[4 n + e] at row 16 w + l / 4
// (e < 2) or that row + 8 (e >= 2), column 8 n + 2 (l % 4) + e % 2.
// The register A operand of a k16 step has the same shape over 16
// columns, so four accumulator pairs (n = 2 kk, 2 kk + 1) become one A
// fragment without any data movement between threads.

#define KFRM_F8(d, i)                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define KFRM_D32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define KFRM_D64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x N) (+)= A (64 x 16, smem, K-major) · B (16 x N, smem, K-major)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KFRM_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : KFRM_F8(d, 0), KFRM_F8(d, 8), KFRM_F8(d, 16), KFRM_F8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " KFRM_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : KFRM_F8(d, 0), KFRM_F8(d, 8), KFRM_F8(d, 16), KFRM_F8(d, 24),
        KFRM_F8(d, 32), KFRM_F8(d, 40), KFRM_F8(d, 48), KFRM_F8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N) += A (64 x 16, registers, bf16 pairs) · B (16 x N, smem,
// MN-major: the transpose bit is set); always accumulates
template <int N>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs_t<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " KFRM_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : KFRM_F8(d, 0), KFRM_F8(d, 8), KFRM_F8(d, 16), KFRM_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<128>(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " KFRM_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : KFRM_F8(d, 0), KFRM_F8(d, 8), KFRM_F8(d, 16), KFRM_F8(d, 24),
        KFRM_F8(d, 32), KFRM_F8(d, 40), KFRM_F8(d, 48), KFRM_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef KFRM_F8
#undef KFRM_D32
#undef KFRM_D64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the accumulator of an m64nN product, rounded to bf16, as the N/16
// register A operands of the k16 steps of the next product
template <int N>
__device__ __forceinline__ void acc_to_a(const float (&d)[N / 2],
                                         uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// masking of a score tile whose rows are q rows and columns kv rows
// ---------------------------------------------------------------------

// Sets the masked scores of one N-column kv tile of an m64nN S
// accumulator to −inf. Entry (n, e) of row r holds column k0 + 8 n +
// quad + e; it is kept iff 8 n + e <= lim_r (the column is below T and,
// causal, not after r) and, with segments, its key is in the row's
// segment. seg_tile holds the tile's N kv segment ids, or is null.
template <int N>
__device__ __forceinline__ void mask_tile(float (&sacc)[N / 2],
                                          const int* seg_tile, int k0,
                                          int row0, int row1, int sq0,
                                          int sq1, int T, int causal,
                                          int quad) {
  int lim0 = T - 1 - k0 - quad, lim1 = lim0;
  if (causal) {
    lim0 = min(lim0, row0 - k0 - quad);
    lim1 = min(lim1, row1 - k0 - quad);
  }
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      bool ok0 = 8 * n + e <= lim0, ok1 = 8 * n + e <= lim1;
      if (seg_tile != nullptr) {
        const int sk = seg_tile[8 * n + quad + e];
        ok0 = ok0 && sk == sq0;
        ok1 = ok1 && sk == sq1;
      }
      if (!ok0) sacc[4 * n + e] = -INFINITY;
      if (!ok1) sacc[4 * n + 2 + e] = -INFINITY;
    }
  }
}

// ---------------------------------------------------------------------
// the two tiles a CTA takes
// ---------------------------------------------------------------------

// First rows of the tiles n − 1 − x and x of n (in the order the kernel
// runs them), one tile when they coincide. Read by value through [], so
// that a loop over them keeps both in registers (indexing an array with
// the loop counter would put it on the stack).
struct TilePair {
  int row0[2];
  int count;
  __device__ __forceinline__ int operator[](int p) const {
    return p == 0 ? row0[0] : row0[1];
  }
};

__device__ __forceinline__ TilePair tile_pair(int x, int n, int rows,
                                              bool late_first) {
  const int late = (n - 1 - x) * rows, early = x * rows;
  return {{late_first ? late : early, late_first ? early : late},
          n - 1 - x == x ? 1 : 2};
}

// ---------------------------------------------------------------------
// named barriers (ids 1..15; __syncthreads() is id 0)
// ---------------------------------------------------------------------

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------
// register rebalancing (one warpgroup at a time)
// ---------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(R));
}
template <int R>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(R));
}

// ---------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess) {
      return nullptr;
    }
#endif
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// 3-D map of a contiguous (planes, T, D) bf16 tensor: boxes of 64
// columns x box_rows rows x 1 plane, B128-swizzled; rows past T read as
// zeros (inside the plane, never from the next one)
inline cudaError_t make_tile_map(CUtensorMap* map, const void* base,
                                 int planes, int T, int D, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
