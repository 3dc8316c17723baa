// Tensor-core pieces of the bf16 kernels (gram.cu's and mm_update.cu's bf16
// variants): the warp-level product mma.sync m16n8k16 (bf16 x bf16
// products, exact in f32, summed in f32), ldmatrix loads of its operands
// from staged tiles, the exact split of an f32 coefficient into three bf16
// pieces, and a ring of shared-memory stages filled by TMA tensor copies
// (boxes of 64 columns in the 128-byte swizzle) that complete on one
// mbarrier a stage; the tiled tensor-map encoder and the 3-D box copy also
// serve block_stencil.cu's bf16 schedule (bs_tma).
//
// Fragments (PTX ISA, "mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A, 16 x 16 (m x k) row-major, four registers of two bf16 each: a[0]
//     row g, k 2t and 2t + 1; a[1] row g + 8; a[2] row g, k 2t + 8 and
//     2t + 9; a[3] row g + 8, k 2t + 8 and 2t + 9;
//   B, 16 x 8 (k x n) column-major, two registers: b[0] column g, k 2t and
//     2t + 1; b[1] column g, k 2t + 8 and 2t + 9;
//   D, 16 x 8 f32, four registers: d[0], d[1] row g, columns 2t and 2t + 1;
//     d[2], d[3] row g + 8.
// The element of the lower index sits in the lower 16 bits of a register.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace {

// d += A B on one warp.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 (16 bytes, 16-byte aligned) and receives, from
// each matrix r[i], row l / 4, elements 2 (l % 4) and 2 (l % 4) + 1; with
// .trans, column l / 4, rows 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// Two matrices: lanes 0-15 give the addresses.
__device__ __forceinline__ void ldsm_x2(unsigned& r0, unsigned& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ unsigned pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
}

// v = p[0] + p[1] + p[2] exactly: p[0] = bf16(v), p[1] = bf16(v - p[0]),
// p[2] = v - p[0] - p[1]. Each difference is exact in f32 (a multiple of
// v's f32 ulp, at most half a bf16 ulp of what it is taken from), and the
// last one has at most 8 significant bits, so p[2] holds it exactly: three
// 8-bit significands carry f32's 24 (for 2^-103 <= |v| < 2^128 (1 - 2^-9),
// where every piece is a normal bf16 or 0 and p[0] does not round to inf).
// A two-piece split would keep 16 of them.
__device__ __forceinline__ void split3(float v, bf16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(r1 - __bfloat162float(p[1]));
}

// split3 of two values at once, each piece packed as an mma operand word
// (a in the lower 16 bits): the pieces split3 gives, in three bf16x2
// conversions.
__device__ __forceinline__ void split3_pair(float a, float b, unsigned (&w)[3]) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
  const float2 h = __bfloat1622float2(hi);
  const float ra = a - h.x, rb = b - h.y;
  const __nv_bfloat162 mid = __floats2bfloat162_rn(ra, rb);
  const float2 m = __bfloat1622float2(mid);
  const __nv_bfloat162 lo = __floats2bfloat162_rn(ra - m.x, rb - m.y);
  w[0] = *reinterpret_cast<const unsigned*>(&hi);
  w[1] = *reinterpret_cast<const unsigned*>(&mid);
  w[2] = *reinterpret_cast<const unsigned*>(&lo);
}

// ---- tiles staged by TMA (cp.async.bulk.tensor) in 128-byte swizzled boxes
//
// A staged tile of a (rows, n) bf16 field holds columns i0 .. i0+T-1 as
// T / 64 boxes of 64 columns; a box is R8 rows (rows rounded up to 8) of 128
// bytes, whose 16-byte chunks are permuted by the TMA's 128-byte swizzle
// (chunk c of row r sits at chunk c ^ (r % 8)), so the 8 rows an ldmatrix
// reads at one logical chunk fall in 8 distinct bank groups. One TMA request
// copies a box (rows x 128 bytes) and zero-fills its columns past n.
constexpr int kRingMaxStages = 8;  // mbarriers a block holds (static shared memory)
constexpr int kBoxCols = 64;       // columns of a box: 128 bytes of bf16

// Byte offset of element (r, c) of a staged tile whose boxes hold r8 rows.
__host__ __device__ __forceinline__ int swz(int r, int c, int r8) {
  return (c >> 6) * r8 * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

__host__ __device__ inline int round8(int r) { return (r + 7) / 8 * 8; }

// A tiled tensor map of `rank` dimensions (dims innermost first, strides in
// bytes of dimensions 1 .. rank - 1, box in elements, elements past the
// tensor's edges zero-filled); the driver's encoder is found through the
// runtime, so nothing links libcuda.
inline cudaError_t encode_tmap(CUtensorMap* map, CUtensorMapDataType type, int rank,
                               const void* base, const cuuint64_t* dims,
                               const cuuint64_t* strides, const cuuint32_t* box,
                               CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult rc = encode(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base),
                             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The tensor map of a (rows, n) row-major bf16 field (n % 8 == 0, 16-byte
// aligned) cut into boxes of (rows, 64) with the 128-byte swizzle.
inline cudaError_t make_tmap(CUtensorMap* map, const bf16* F, long long n, int rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(n) * 2};
  const cuuint32_t box[2] = {kBoxCols, static_cast<cuuint32_t>(rows)};
  return encode_tmap(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, F, dims, strides, box,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

// Whether a field can be staged by TMA: n % 8 == 0 (16-byte rows), a
// 16-byte aligned base, and column coordinates that fit an int.
inline bool tma_ok(const void* F, long long n) {
  return n % 8 == 0 && n < (1LL << 31) && aligned16(F);
}

// Order this thread's earlier writes to shared memory before later copies
// of the asynchronous proxy (TMA) into the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Post `bytes` more to arrive on bar in its current phase, and arrive.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One box, the (rows, 64) block of `map` at column c0, into dst (1024-byte
// aligned); its bytes count against bar.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int c0,
                                        unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_u32(bar)),
      "r"(c0), "r"(0)
      : "memory");
}

// One box of a 3-D map at (c0, c1, c2) into dst (128-byte aligned without
// a swizzle); its bytes count against bar.
__device__ __forceinline__ void tma_box3(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_u32(bar)),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One field's share of a stage: the T / 64 boxes of `map` from column i0
// into dst (boxes of r8 rows), issued by the lanes of warp 0; lane 0 has
// posted the stage's bytes on bar before (tma_post).
__device__ __forceinline__ void tma_tile(char* dst, const CUtensorMap* map, int r8, long long i0,
                                         int T, unsigned long long* bar) {
  for (int b = threadIdx.x; b < T / kBoxCols; b += 32)
    tma_box(dst + b * r8 * 128, map, static_cast<int>(i0) + kBoxCols * b, bar);
}

// Lane 0 of warp 0 posts a stage of `rows` field rows by T columns (the
// boxes' bytes, zero-filled columns included) on bar; the warp then issues
// its tiles (tma_tile).
__device__ __forceinline__ void tma_post(unsigned long long* bar, int rows, int T) {
  if (threadIdx.x == 0) mbar_expect_tx(bar, 2u * rows * T);
  __syncwarp();
}

// The ring of a persistent block: `stages` shared-memory stages, each
// completing on its mbarrier, that take the block's tiles t_j = blockIdx.x +
// j gridDim.x (j = 0, 1, ...) in turn. Iteration j reads stage j % stages
// once its tile has landed (wait); once every thread has read it, the stage
// takes the tile of iteration j + stages (refill), so stages - 1 tiles are in
// flight while one computes. load(s, t) posts stage s and issues the TMA
// copies of tile t (tma_post, tma_tile); the ring calls it on warp 0 alone.
struct TmaRing {
  unsigned long long* full;  // one mbarrier a stage, in shared memory
  int stages;
  long long ntiles;

  __device__ __forceinline__ long long tile(long long j) const {
    return blockIdx.x + j * gridDim.x;
  }
  __device__ __forceinline__ int stage(long long j) const {
    return static_cast<int>(j % stages);
  }
  // The barriers (thread 0; the caller syncs the block before prime).
  __device__ __forceinline__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
      mbar_fence_init();
    }
  }
  // Every stage takes its first tile.
  template <typename Load>
  __device__ __forceinline__ void prime(const Load& load) const {
    if (threadIdx.x < 32)
      for (int s = 0; s < stages; ++s)
        if (tile(s) < ntiles) load(s, tile(s));
  }
  // Iteration j's tile has landed (the barrier's phase flips each round).
  __device__ __forceinline__ void wait(long long j) const {
    mbar_wait(&full[stage(j)], static_cast<unsigned>(j / stages) & 1);
  }
  // Iteration j's stage, read by every thread, takes the tile of j + stages.
  template <typename Load>
  __device__ __forceinline__ void refill(long long j, const Load& load) const {
    if (threadIdx.x < 32 && tile(j + stages) < ntiles) load(stage(j), tile(j + stages));
  }
};

// The same tile copied element by element by the whole block (a ragged n
// or an unaligned field), columns past n zeroed; the caller syncs.
__device__ __forceinline__ void elem_tile(char* dst, const bf16* F, int rows, int r8, long long n,
                                          long long i0, int T) {
  for (int e = threadIdx.x; e < rows * T; e += blockDim.x) {
    const int r = e / T, q = e % T;
    *reinterpret_cast<bf16*>(dst + swz(r, q, r8)) =
        i0 + q < n ? F[static_cast<long long>(r) * n + i0 + q] : __float2bfloat16_rn(0.f);
  }
}

// The first 1024-byte aligned address of dynamic shared memory (the
// swizzled boxes need it; a launch asks for 1 KB more).
__device__ __forceinline__ char* align1k(void* p) {
  return reinterpret_cast<char*>(p) + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ---- the Gram of staged bf16 tiles on the tensor cores (gram.cu's gram_mma,
// the bf16 stencil's and the fused updates' Grams)

// How the 8 warps of a block share a launch of width W (gram_width): G's
// MT x NT fragments of 16 x 8 are cut into QM x QN groups of TM x TN, and
// the P = 8 / (QM QN) warps of a group take every P-th 16-column step of a
// tile. Up to 32 rows one group holds them all (2 x 4 at 32: 32 f32 and 64
// f64 registers a thread); wider, at most 3 x 3 a warp.
template <int W>
struct MmaGram {
  static constexpr int MT = (W + 15) / 16, NT = W / 8;
  static constexpr int QM = W >= 64 ? 2 : 1;
  static constexpr int QN = W == 96 ? 4 : W >= 48 ? 2 : 1;
  static constexpr int P = 8 / (QM * QN);
  static constexpr int TM = MT / QM, TN = NT / QN;
  static constexpr int kScratch = P * 16 * MT * 8 * NT;  // floats of the warps' sums
  static_assert(QM * TM == MT && QN * TN == NT && P * QM * QN == 8, "the warps must tile G");
};

// One tile's products for this warp: its fragments (mt0 + a, nt0 + b) over
// the 16-column steps p, p + P, ... of the staged tile (rows of U at su in
// boxes of r8u rows, of V at sv in boxes of r8v), added to the running
// sums. SYM: U is V, and the fragments wholly below the diagonal
// (nt < 2 mt) are skipped.
template <int W, bool SYM>
__device__ __forceinline__ void gram_mma_tile(double (&run)[MmaGram<W>::TM][MmaGram<W>::TN][4],
                                              const char* su, const char* sv, int r8u, int r8v,
                                              int T, int ku, int kv, int mt0, int nt0, int p) {
  using S = MmaGram<W>;
  const int lane = threadIdx.x % 32;
  float acc[S::TM][S::TN][4] = {};
  // ldmatrix rows of this lane: A's matrices are (rows 0-7, k 0-7), (rows
  // 8-15, k 0-7), (rows 0-7, k 8-15), (rows 8-15, k 8-15); B's, two
  // fragments at a time, (fragment b, k 0-7), (b, k 8-15), (b + 1, k 0-7),
  // (b + 1, k 8-15).
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 8 * (lane >> 4);
  const int brow = (lane & 7) + 8 * (lane >> 4), bcol = 8 * ((lane >> 3) & 1);
  for (int c0 = 16 * p; c0 < T; c0 += 16 * S::P) {
    unsigned a[S::TM][4], b[S::TN][2];
#pragma unroll
    for (int i = 0; i < S::TM; ++i)
      ldsm_x4(a[i], su + swz(min(16 * (mt0 + i) + arow, ku - 1), c0 + acol, r8u));
#pragma unroll
    for (int j = 0; j + 1 < S::TN; j += 2) {
      unsigned r[4];
      ldsm_x4(r, sv + swz(min(8 * (nt0 + j) + brow, kv - 1), c0 + bcol, r8v));
      b[j][0] = r[0]; b[j][1] = r[1]; b[j + 1][0] = r[2]; b[j + 1][1] = r[3];
    }
    if constexpr (S::TN % 2 == 1)
      ldsm_x2(b[S::TN - 1][0], b[S::TN - 1][1],
              sv + swz(min(8 * (nt0 + S::TN - 1) + (lane & 7), kv - 1), c0 + bcol, r8v));
#pragma unroll
    for (int i = 0; i < S::TM; ++i)
#pragma unroll
      for (int j = 0; j < S::TN; ++j)
        if (!SYM || nt0 + j >= 2 * (mt0 + i)) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
  }
#pragma unroll
  for (int i = 0; i < S::TM; ++i)
#pragma unroll
    for (int j = 0; j < S::TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) run[i][j][e] += acc[i][j][e];
}

// The block's (ku, kv) partial of the Gram from the warps' running sums
// (gram_mma_tile), the warps sharing G as S (MmaGram<W>, or another split
// with its MT, NT, P, TM and TN): scratch[p][r][c] over the padded (16 MT,
// 8 NT) Gram (S::kScratch floats of shared memory that no thread reads any
// more), then added in warp order for each entry in double (an entry below
// the diagonal from its mirror when SYM), so G is exactly symmetric when
// SYM and a repeated call gives the same bits.
template <typename S, bool SYM>
__device__ __forceinline__ void gram_mma_store(const double (&run)[S::TM][S::TN][4],
                                               float* scratch, float* mine, int ku, int kv,
                                               int mt0, int nt0, int p) {
  constexpr int kR = 16 * S::MT, kC = 8 * S::NT;
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < S::TM; ++i)
#pragma unroll
    for (int jj = 0; jj < S::TN; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * (mt0 + i) + g + 8 * (e >> 1), c = 8 * (nt0 + jj) + 2 * tq + (e & 1);
        scratch[(p * kR + r) * kC + c] = static_cast<float>(run[i][jj][e]);
      }
  __syncthreads();
  for (int e = threadIdx.x; e < ku * kv; e += blockDim.x) {
    int r = e / kv, c = e % kv;
    if (SYM && r > c) {
      const int u = r; r = c; c = u;
    }
    double v = 0.0;
    for (int w = 0; w < S::P; ++w) v += scratch[(w * kR + r) * kC + c];
    mine[e] = static_cast<float>(v);
  }
}

}  // namespace
