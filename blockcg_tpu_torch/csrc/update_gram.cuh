// The streaming coefficient update with the Gram of its output, on lanes-major
// (k, n) fields, in one pass over the inputs:
//
//   NF = 1:  Y = M1 B1 (+ A)        (mm_update_gram.cu: mm_update_gram; without the
//                                    Gram, mm_update's row chunks above 128 rows)
//   NF = 2:  Y = M1 B1 + M2 B2      (mm2_update_gram.cu: mm2_update_gram)
//
// and G = Y Y^T of the stored Y.
//
// Bound: the inputs read once and Y written once: at (32, 2,097,152), 805 MB
// (0.24 ms at 3.35 TB/s) with two inputs, 537 MB (0.16 ms) with one; beside
// them NF k^2 FMAs a column for Y and k (k + 1) / 2 for the Gram (its upper
// triangle), 10.8 or 6.5 GFLOP, 0.16 or 0.10 ms at the f32 rate: about as
// much arithmetic as traffic, so the FMAs have to overlap the copies. The
// kernel these replaced (coeff_update of the former fused_update.cu: one
// thread a column of 128-thread blocks, scalar loads of B inside the
// coefficient loop, a Gram of 2x4 register tiles fed by 6 scalar shared
// loads for 8 FMAs between two barriers a tile, one launch per 64-row chunk,
// each reading all of B) ran at 30-33% of the bound.
//
// Design: mm_update.cu's streaming schedule on the stacked input [B1; B2]
// (NF kin rows), as the Pallas kernel stacks M1 and M2 into one (k, 2k)
// contraction. A persistent grid of 256-thread blocks walks 128-column
// tiles. Each block stages the stacked coefficients once, transposed: sM[c][r]
// = M1[r, c] for c < kin, M2[r, c - kin] after. Each tile's input is copied
// into shared memory with cp.async in stages of kc stacked rows,
// double-buffered, so the next stage's copy is in flight while this one
// computes; kc is NF kin (one stage a tile) wherever shared memory allows
// (ops/fused.py update_plan). Warp w owns output rows w*R .. w*R+R-1, lane l
// columns 4l .. 4l+3: 16-byte copies and stores, conflict-free float4 reads
// of the staged input, broadcast reads of the coefficients. The additive
// field A is not contracted: the thread that writes four entries of Y loads
// the same four of A as a float4 into registers at the tile's first stage,
// ahead of the coefficient loop that hides their latency, and adds them in
// the tile's epilogue. After a tile's
// last stage Y goes to global memory and to a (k, 136) shared tile (row
// stride 8 mod 32 words), from which SymGram (common.cuh) takes the Gram in
// 4x4 register tiles of float4 reads (8x8 from 64 rows; up to 96 rows with
// one input field), only the tiles on
// and above the diagonal (G is symmetric): 36/64 of a full tiling's FMAs at
// 32 rows. 8x8 tiles at 32 rows (VecGram's) kept the whole block at the
// barrier behind the few threads with two column quads: 0.537-0.552 ms
// against 0.491 at (32, 2,097,152) with two inputs, H100
// (tools/torch_kernel_times.py --variants). The buffer of a stage is refilled
// as soon as it has been read, before the Gram, so the Gram runs with two
// stages' copies in flight; up to 32 rows the kernel is held to 128
// registers for two blocks an SM, which the plan leaves room for in shared
// memory. Every block writes one (k, k) partial; launch_reduce sums them in
// block order in double. The grid depends on the card and the build alone,
// so a repeated call gives the same bits. A field whose rows are not 16-byte
// aligned (n % 4 != 0, or an offset view) takes 4-byte copies and scalar
// loads and stores on the same schedule.
//
// Arithmetic: y_r = fmaf over c = 0..kin-1 of M1[r, c] B1[c, i], then over
// M2[r, c] B2[c, i], in that order, then y_r += A[r, i]: the order of the
// coeff_update these replaced, so Y keeps its bits (mm_update's row chunks
// above 128 rows too).
//
// bf16 fields (E = bf16): the staged inputs are bf16, 16-byte copies of 8
// elements, lifted to f32 four at a time as they are read (load4); the
// staged coefficients stay f32, every FMA is f32, Y and A are read and
// written four bf16 at a time, and the Gram is taken on the stored, rounded
// Y: the sY tile holds rounded<E>(y). That is the reference's bf16 contract
// on its f32 coefficient route (f32 coefficients and accumulation, G on the
// stored output). The bf16 launches with the fused Gram (k <= 64) run
// update_gram_mma on the tensor cores instead (below); this kernel takes the
// bf16 launches without it, and one field's fused Gram of 65 to 96 rows.
//
// Width: one launch writes k <= 128 rows of Y and contracts over kin >= k
// input rows of each field (a row chunk of a wider field, ops/fused.py).
// The fused Gram is taken on a launch that covers a field of up to 64 rows
// with two input fields, 96 with one (G == nullptr otherwise: the wrapper
// takes the Gram from gram.cu on 64-row blocks).
//
// In place: Y may be B1 (the solvers' donated operand), on a launch that
// covers all of Y's rows, or A (mm_update's donated A), on any launch. A block copies all stages of its input tile into
// shared memory before it writes the tile's columns of Y, the copies in
// flight meanwhile are of its later tiles' columns, no block reads columns
// that another block writes, and the thread that writes Y[r, i] has read
// A[r, i] first; B1, B2, A and Y are therefore not __restrict__.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

// Blocks an SM the kernel is built for: two with the Gram up to 32 rows (at
// most 128 registers a thread), else one (ops/fused.py _blocks_per_sm).
template <int GK>
constexpr int kUgBlocksPerSm = GK > 0 && GK <= 32 ? 2 : 1;

// E: the field element (float or bf16). NF: stacked input fields (1 or 2).
// HAS_A: the additive field (NF == 1). GK: the Gram's register width (>= k:
// dispatch); 0: no Gram. MINB: blocks an SM for __launch_bounds__
// (tools/torch_kernel_times.py --variants builds other values).
template <typename E, int NF, bool HAS_A, int R, int GK, int MINB = kUgBlocksPerSm<GK>>
__global__ void __launch_bounds__(kUpThreads, MINB)
    update_gram_kernel(const float* __restrict__ M1, const E* B1,
                       const float* __restrict__ M2, const E* B2, const E* A,
                       E* Y, float* __restrict__ part, int k, int kin, long long n,
                       int kc, bool vec) {
  static_assert(NF == 1 || (NF == 2 && !HAS_A), "A goes with one input field");
  extern __shared__ __align__(16) float smem[];  // sM (NF kin x 8R) | kUpStages (kc, 128) stages | sY
  constexpr int kRows = 8 * R;
  const int nin = NF * kin;
  float* sM = smem;
  E* sB = reinterpret_cast<E*>(smem + nin * kRows);
  float* sY = reinterpret_cast<float*>(sB + kUpStages * kc * kUpTile);
  for (int e = threadIdx.x; e < nin * kRows; e += kUpThreads) {
    const int c = e / kRows, r = e % kRows;
    sM[e] = r >= k ? 0.f : (c < kin ? M1[r * kin + c] : M2[r * kin + c - kin]);
  }
  using Gram = SymGram<GK ? GK : 8, kUpThreads, GK >= 64 ? 8 : 4>;
  static_assert(Gram::kScratch <= kUpThreads * (GK > 32 ? 64 : 16),
                "the Gram's scratch must fit update_smem_bytes' floor");
  Gram g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * R;
  const int nk = (nin + kc - 1) / kc;
  const long long ntiles = (n + kUpTile - 1) / kUpTile;
  StageCursor cur{blockIdx.x, 0}, ahead = cur;
  for (int s = 0; s < kUpStages; ++s, ahead.next(nk))
    load_stage(sB + s * kc * kUpTile, B1, B2, kin, nin, n, ahead, kc, ntiles, vec);
  int buf = 0;
  float acc[R][4];
  float4 av[HAS_A ? R : 1];  // the tile's entries of A, loaded at its first stage
  while (cur.t < ntiles) {
    cp_async_wait<kUpStages - 1>();  // this stage's copy has landed
    __syncthreads();                 // ... for every thread's share of it (and the coefficients)
    const long long t = cur.t;
    const int j = cur.j;
    if (j == 0) {
#pragma unroll
      for (int a = 0; a < R; ++a) acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.f;
      if constexpr (HAS_A) {
        const long long i = t * kUpTile + 4 * lane;
#pragma unroll
        for (int a = 0; a < R; ++a) {
          const long long at = (r0 + a) * n + i;
          if (r0 + a >= k) {
            av[a] = make_float4(0.f, 0.f, 0.f, 0.f);
          } else if (vec && i + 3 < n) {
            av[a] = load4(A + at);
          } else {  // 0 past n, where Y is not stored
            av[a] = make_float4(i < n ? to_f32(A[at]) : 0.f, i + 1 < n ? to_f32(A[at + 1]) : 0.f,
                                i + 2 < n ? to_f32(A[at + 2]) : 0.f,
                                i + 3 < n ? to_f32(A[at + 3]) : 0.f);
          }
        }
      }
    }
    if (r0 < k) {
      const int c0 = j * kc, c1 = min(c0 + kc, nin);
      const E* sb = sB + buf * kc * kUpTile + 4 * lane;
#pragma unroll 2
      for (int c = c0; c < c1; ++c) {
        const float4 b = load4(sb + (c - c0) * kUpTile);
        float m[R];
        load_rows<R>(m, sM + c * kRows + r0);
#pragma unroll
        for (int a = 0; a < R; ++a) {
          acc[a][0] = fmaf(m[a], b.x, acc[a][0]);
          acc[a][1] = fmaf(m[a], b.y, acc[a][1]);
          acc[a][2] = fmaf(m[a], b.z, acc[a][2]);
          acc[a][3] = fmaf(m[a], b.w, acc[a][3]);
        }
      }
    }
    const bool last = j == nk - 1;  // the tile's last stage: store Y, then its Gram
    if (last) {
      const long long i = t * kUpTile + 4 * lane;
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int r = r0 + a;
        if (r >= k) continue;
        const long long at = r * n + i;
        float4 y = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
        if constexpr (HAS_A) {
          y.x += av[a].x; y.y += av[a].y; y.z += av[a].z; y.w += av[a].w;
        }
        if (vec && i + 3 < n) {
          store4(Y + at, y);
        } else {
          if (i < n) Y[at] = from_f32<E>(y.x);
          if (i + 1 < n) Y[at + 1] = from_f32<E>(y.y);
          if (i + 2 < n) Y[at + 2] = from_f32<E>(y.z);
          if (i + 3 < n) Y[at + 3] = from_f32<E>(y.w);
        }
        if constexpr (GK > 0)  // 0 past n: the stage was zero-filled there, and A taken as 0
          *reinterpret_cast<float4*>(sY + r * kUpLd + 4 * lane) =
              make_float4(rounded<E>(y.x), rounded<E>(y.y), rounded<E>(y.z), rounded<E>(y.w));
      }
    }
    __syncthreads();  // every read of this stage's buffer is done (and sY is written)
    // Refill the buffer kUpStages stages ahead before the Gram, so the Gram
    // runs with kUpStages copies in flight.
    load_stage(sB + buf * kc * kUpTile, B1, B2, kin, nin, n, ahead, kc, ntiles, vec);
    ahead.next(nk);
    if constexpr (GK > 0)
      if (last) g.accumulate(sY, kUpLd, kUpTile, k);
    buf = (buf + 1) % kUpStages;
    cur.next(nk);
  }
  cp_async_wait<0>();
  if constexpr (GK > 0) {
    __syncthreads();
    g.store(part + static_cast<long long>(blockIdx.x) * k * k, k, smem);
  }
}

template <typename E, int NF, bool HAS_A, int R, int GK, int MINB = kUgBlocksPerSm<GK>>
cudaError_t launch(const float* M1, const E* B1, const float* M2, const E* B2, const E* A,
                   E* Y, float* part, float* G, int k, int kin, long long n, int kc,
                   int max_blocks, int device, cudaStream_t stream) {
  auto kernel = update_gram_kernel<E, NF, HAS_A, R, GK, MINB>;
  const size_t smem = update_smem_bytes(k, kin, kc, NF, GK > 0, sizeof(E));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(kernel, kUpThreads, smem, device, (n + kUpTile - 1) / kUpTile,
                        max_blocks, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = n % kVec<E> == 0 && aligned16(B1) && aligned16(Y) &&
                   (NF == 1 || aligned16(B2)) && (!HAS_A || aligned16(A));
  kernel<<<grid, kUpThreads, smem, stream>>>(M1, B1, M2, B2, A, Y, part, k, kin, n, kc, vec);
  if (GK > 0) launch_reduce(part, G, k, grid, stream);
  return cudaGetLastError();
}

// The launch of a k-row update at its built register widths: R =
// rows_per_warp(k); the Gram (G != nullptr) up to 64 rows, 96 with one
// input field.
template <typename E, int NF, bool HAS_A>
cudaError_t dispatch(const float* M1, const E* B1, const float* M2, const E* B2, const E* A,
                     E* Y, float* part, float* G, int k, int kin, long long n, int kc,
                     int max_blocks, int device, cudaStream_t stream) {
  if (n < 1 || k < 1 || kin < k || kc < 1 || kc > NF * kin || max_blocks < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
#define BCG_UG(R, GK)                                                                         \
  return launch<E, NF, HAS_A, R, GK>(M1, B1, M2, B2, A, Y, part, G, k, kin, n, kc, max_blocks, \
                                     device, stream)
  // With one input field the Gram's register width follows k from 33 rows
  // (48, 96): at (48, 32^4) 315 us against 426 at 64; at (96, 32^4) 983 us
  // against 1510 at 128 (136 of 256 threads in the Gram), so no 128-row
  // Gram is built and 97-128 rows take theirs from gram.cu; H100
  // (tools/torch_kernel_times.py --variants).
  if (G != nullptr) {
    if constexpr (std::is_same_v<E, bf16>) {
      // bf16 Grams up to 64 rows run update_gram_mma; one field's of 65-96
      // rows runs here.
      if constexpr (NF == 1)
        if (rows_per_warp(k) == 12) BCG_UG(12, 96);
      return cudaErrorInvalidValue;
    } else {
      switch (rows_per_warp(k)) {  // R = 1, 2, 4, 6, 8, 12 for k <= 8, 16, 32, 48, 64, 96
        case 1: BCG_UG(1, 8);
        case 2: BCG_UG(2, 16);
        case 4: BCG_UG(4, 32);
        case 6:
          if constexpr (NF == 1) BCG_UG(6, 48);
          BCG_UG(6, 64);
        case 8: BCG_UG(8, 64);
        case 12:
          if constexpr (NF == 1) BCG_UG(12, 96);
          return cudaErrorInvalidValue;
        default: return cudaErrorInvalidValue;
      }
    }
  }
  switch (rows_per_warp(k)) {  // Y alone: above 64 rows, or a row chunk of a wider field
    case 1: BCG_UG(1, 0);
    case 2: BCG_UG(2, 0);
    case 4: BCG_UG(4, 0);
    case 6: BCG_UG(6, 0);
    case 8: BCG_UG(8, 0);
    case 12: BCG_UG(12, 0);
    case 16: BCG_UG(16, 0);
    default: return cudaErrorInvalidValue;
  }
#undef BCG_UG
}

// ---- bf16 fields on the tensor cores (update_gram_mma: rows 7 and 8 with
// their fused Gram, k <= 64)
//
// mm_update.cu's mm_update_mma on NF stacked input fields, with the Gram of
// the stored Y: the stacked coefficient [M1 M2] (k x NF k) is split exactly
// into three bf16 pieces once a block (split3) and held as A fragments in
// registers; each warp owns one 16-row tile of Y and takes every CG-th pair
// of 8-column fragments of a tile; a ring of TMA stages holds each field's
// (k, T) tile in boxes of W rows (the rows past k zero), read by
// ldmatrix.trans as the B operand; three mma.sync an output fragment and
// k-step (hi, mid, lo) sum the exact products in f32. Each fragment adds A
// (NF == 1) in f32 and is rounded once into the bf16 tile of Y, which the
// block writes in 16-byte stores; the Gram Y Y^T of that stored tile runs on
// the tensor cores too (mma.cuh gram_mma_tile, symmetric: the fragments
// below the diagonal are skipped and mirrored, so G is exactly symmetric),
// bf16 x bf16 products exact in f32, each tile's fragments added to double
// running sums. One block an SM (its A fragments and running sums take the
// registers of two).
//
// Bound: bytes, at (32, 256^3) with two fields 3,221 MB (0.962 ms at 3.35
// TB/s) against 206 GFLOP of products in three pieces and the Gram's 18
// (0.23 ms at 989 TFLOP/s); f32 FMAs on the lifted fields (the kernel above)
// needed 1.3 ms of issue alone and took 3.97 ms. PERF.md section 6 has this
// kernel's timings.

// How the 8 warps share the update of width W (k padded to 16, 32 or 64):
// one of the MT = W / 16 row tiles of Y a warp, the CG = 8 / MT warps of a
// row tile taking every CG-th pair of 8-column fragments of a tile.
template <int W>
struct MmaUpdateGram {
  static constexpr int MT = W / 16;
  static constexpr int CG = 8 / MT;
};

// Shared bytes of a launch: `stages` stages of NF fields' tiles (W rows
// each) and, with A, of A (round8(k) rows), the bf16 tile of Y, all in
// swizzled boxes, at least the Gram's sums, and 1 KB to align the boxes;
// mirrored by ops/fused.py update_gram_mma_smem_bytes.
__host__ __device__ inline long long update_mma_smem_bytes(int k, int W, int T, int stages,
                                                           int nf, bool has_a) {
  const long long b = 2LL * T * (stages * (nf * W + (has_a ? round8(k) : 0)) + round8(k));
  const long long scratch = 4LL * 9216;  // MmaGram<W>::kScratch, at most 9,216 floats
  return (b > scratch ? b : scratch) + 1024;
}

// W: the update's width; GW: the Gram's (gram.cu gram_width, >= k). tb1, tb2,
// ta: tensor maps of B1, B2 and A (vec; unused otherwise).
template <int NF, int W, int GW>
__global__ void __launch_bounds__(kUpThreads, 1)
    update_gram_mma(const __grid_constant__ CUtensorMap tb1,
                    const __grid_constant__ CUtensorMap tb2,
                    const __grid_constant__ CUtensorMap ta, const float* __restrict__ M1,
                    const bf16* B1, const float* __restrict__ M2, const bf16* B2, const bf16* A,
                    bf16* Y, float* __restrict__ part, int k, long long n, int T, int stages,
                    bool vec) {
  using S = MmaUpdateGram<W>;
  using SG = MmaGram<GW>;
  constexpr int KS = NF * S::MT;  // k-steps of the stacked contraction
  extern __shared__ __align__(16) float smem[];  // stages of [B1; B2; A] | the tile of Y
  __shared__ unsigned long long full[kRingMaxStages];
  char* base = align1k(smem);
  const bool has_a = A != nullptr;
  const int r8 = round8(k);
  const int fbytes = 2 * T * W, stage = NF * fbytes + (has_a ? 2 * T * r8 : 0);
  char* ys = base + stages * stage;  // the bf16 tile of Y, boxes of r8 rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int rg = warp / S::CG, cg = warp % S::CG;
  // The A fragments of this warp's row tile: a[ks][piece], k-step ks of the
  // stacked coefficient (field ks / MT, its columns 16 (ks % MT) ..), rows
  // and columns past k zero.
  unsigned a[KS][3][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* M = ks < S::MT ? M1 : M2;
      const int r = 16 * rg + g + 8 * (e & 1);
      const int c = 16 * (ks % S::MT) + 2 * tq + 8 * (e >> 1);
      bf16 x0[3], x1[3];  // the pieces of M[r, c] and M[r, c + 1]
      split3(r < k && c < k ? M[r * k + c] : 0.f, x0);
      split3(r < k && c + 1 < k ? M[r * k + c + 1] : 0.f, x1);
#pragma unroll
      for (int piece = 0; piece < 3; ++piece) a[ks][piece][e] = pack_bf16(x0[piece], x1[piece]);
    }
  // Rows k .. W-1 of every stage's fields stay zero: their products meet
  // the coefficient's zero columns.
  for (int e = threadIdx.x; e < stages * NF * (W - k) * T; e += kUpThreads) {
    const int s = e / (NF * (W - k) * T), x = e % (NF * (W - k) * T);
    const int f = x / ((W - k) * T), y = x % ((W - k) * T);
    *reinterpret_cast<bf16*>(base + s * stage + f * fbytes + swz(k + y / T, y % T, W)) =
        __float2bfloat16_rn(0.f);
  }
  // The Gram's share of this warp (mma.cuh MmaGram).
  const int gp = warp % SG::P, gq = warp / SG::P;
  const int mt0 = gq / SG::QN * SG::TM, nt0 = gq % SG::QN * SG::TN;
  double run[SG::TM][SG::TN][4] = {};
  const TmaRing ring{full, stages, (n + T - 1) / T};
  const auto load = [&](int s, long long t) {  // stage s takes the tiles t by TMA
    char* sb = base + s * stage;
    tma_post(&full[s], (NF + (has_a ? 1 : 0)) * k, T);
    tma_tile(sb, &tb1, W, t * T, T, &full[s]);
    if (NF == 2) tma_tile(sb + fbytes, &tb2, W, t * T, T, &full[s]);
    if (has_a) tma_tile(sb + NF * fbytes, &ta, r8, t * T, T, &full[s]);
  };
  ring.init();
  __syncthreads();  // the barriers, and the zero rows
  if (vec) ring.prime(load);
  // ldmatrix.trans rows of this lane (as mm_update_mma).
  const int brow = (lane & 7) + 8 * ((lane >> 3) & 1), bcol = 8 * (lane >> 4);
  for (long long j = 0, t = blockIdx.x; t < ring.ntiles; ++j, t += gridDim.x) {
    char* sb = base + ring.stage(j) * stage;
    if (vec) {
      ring.wait(j);
    } else {  // element copies into the same stage
      elem_tile(sb, B1, k, W, n, t * T, T);
      if (NF == 2) elem_tile(sb + fbytes, B2, k, W, n, t * T, T);
      if (has_a) elem_tile(sb + NF * fbytes, A, k, r8, n, t * T, T);
    }
    // Every thread is done with the last tile (its stage, and the tile of Y
    // the Gram read).
    __syncthreads();
    if (vec && j > 0) ring.refill(j - 1, load);
    const char* sa = sb + NF * fbytes;
    for (int pair = cg; pair < T / 16; pair += S::CG) {
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned b[4];  // fragment 2 pair (k 0-7, 8-15), then 2 pair + 1
        ldsm_x4_trans(b, sb + (ks / S::MT) * fbytes +
                             swz(16 * (ks % S::MT) + brow, 16 * pair + bcol, W));
#pragma unroll
        for (int piece = 0; piece < 3; ++piece) {
          mma_bf16(acc[0], a[ks][piece], b[0], b[1]);
          mma_bf16(acc[1], a[ks][piece], b[2], b[3]);
        }
      }
      // + A in f32, rounded once into the tile of Y.
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * rg + g + 8 * h, c = 16 * pair + 8 * f + 2 * tq;
          if (r >= k) continue;
          float2 y = make_float2(acc[f][2 * h], acc[f][2 * h + 1]);
          if (has_a) {
            const float2 av =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sa + swz(r, c, r8)));
            y.x += av.x;
            y.y += av.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(ys + swz(r, c, r8)) = __floats2bfloat162_rn(y.x, y.y);
        }
    }
    __syncthreads();  // the tile of Y is complete
    // Y out, 8 columns (16 bytes) a thread.
    const long long i0 = t * T;
    const int chunks = T / 8;
    for (int e = threadIdx.x; e < k * chunks; e += kUpThreads) {
      const int r = e / chunks, c = 8 * (e % chunks);
      const long long i = i0 + c;
      if (i >= n) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(ys + swz(r, c, r8));
      bf16* out = Y + r * n + i;
      if (vec) {
        *reinterpret_cast<uint4*>(out) = v;
      } else {
        const bf16* w = reinterpret_cast<const bf16*>(&v);
        for (int q = 0; q < 8 && i + q < n; ++q) out[q] = w[q];
      }
    }
    // The Gram of the stored tile (0 past n: the stages were zero-filled
    // there, and A taken as 0).
    gram_mma_tile<GW, true>(run, ys, ys, r8, r8, T, k, k, mt0, nt0, gp);
  }
  __syncthreads();  // every read of the stages and of the tile of Y is done
  gram_mma_store<SG, true>(run, reinterpret_cast<float*>(base),
                           part + static_cast<long long>(blockIdx.x) * k * k, k, k, mt0, nt0, gp);
}

template <int NF, int W, int GW>
cudaError_t launch_update_mma(const float* M1, const bf16* B1, const float* M2, const bf16* B2,
                              const bf16* A, bf16* Y, float* part, float* G, int k, long long n,
                              int T, int stages, int max_blocks, int device,
                              cudaStream_t stream) {
  static_assert(MmaGram<GW>::kScratch <= 9216, "the warps' sums must fit the floor");
  auto kernel = update_gram_mma<NF, W, GW>;
  const size_t smem = update_mma_smem_bytes(k, W, T, stages, NF, A != nullptr);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(kernel, kUpThreads, smem, device, (n + T - 1) / T, max_blocks, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = tma_ok(B1, n) && (NF == 1 || tma_ok(B2, n)) && aligned16(Y) &&
                   (A == nullptr || tma_ok(A, n));
  CUtensorMap tb1{}, tb2{}, ta{};
  if (vec) {
    err = make_tmap(&tb1, B1, n, k);
    if (err == cudaSuccess && NF == 2) err = make_tmap(&tb2, B2, n, k);
    if (err == cudaSuccess && A != nullptr) err = make_tmap(&ta, A, n, k);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kUpThreads, smem, stream>>>(tb1, tb2, ta, M1, B1, M2, B2, A, Y, part, k, n, T,
                                             stages, vec);
  launch_reduce(part, G, k, grid, stream);
  return cudaGetLastError();
}

// The launch of a k-row update with its Gram on the tensor cores (1 <= k
// <= 64): the update's width W (16, 32, 64) and the Gram's (gram_width).
// T (128 to 512), stages and max_blocks come from ops/fused.py
// update_gram_mma_plan; Y may equal B1 (or A).
template <int NF>
cudaError_t dispatch_mma(const float* M1, const bf16* B1, const float* M2, const bf16* B2,
                         const bf16* A, bf16* Y, float* part, float* G, int k, long long n, int T,
                         int stages, int max_blocks, int device, cudaStream_t stream) {
  if (n < 1 || k < 1 || k > 64 || T < 128 || T > 512 || T % 128 != 0 || stages < 2 ||
      stages > kRingMaxStages || max_blocks < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
#define BCG_UM(W, GW)                                                                   \
  return launch_update_mma<NF, W, GW>(M1, B1, M2, B2, A, Y, part, G, k, n, T, stages, \
                                      max_blocks, device, stream)
  if (k <= 8) BCG_UM(16, 8);
  if (k <= 16) BCG_UM(16, 16);
  if (k <= 32) BCG_UM(32, 32);
  if (k <= 48) BCG_UM(64, 48);
  BCG_UM(64, 64);
#undef BCG_UM
}

}  // namespace
