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
// stored output).
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

#include "common.cuh"

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
    switch (rows_per_warp(k)) {  // R = 1, 2, 4, 6, 8, 12, 16 for k <= 8, 16, 32, 48, 64, 96, 128
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

}  // namespace
