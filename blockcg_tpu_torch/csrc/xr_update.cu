// The BCG/BCGA solution and residual updates with the next residual Gram:
// Xn = X + alpha P, Rn = R - alpha Z and G = Rn Rn^T, in one pass.
//
// Replaces the Pallas kernel blockcg_tpu/ops/fused.py xr_update_gram (:496).
//
// Bound: bytes, six field passes (read P, Z, X, R; write Xn, Rn). At config
// 2's (16, 512^2) that is 100.7 MB in f32 (0.030 ms at 3.35 TB/s) and 50.3 MB
// in bf16 (0.015 ms). Beside them each column costs 2 k^2 FMAs for the
// updates and k (k + 1) / 2 for the Gram's upper triangle: 648 at k = 16,
// 170 M FMAs over the 262,144 columns, about 5 us at the f32 rate (67
// TFLOP/s), a third of even the bf16 bytes' time. At (48, 32^4) in bf16 the
// two meet: 604 MB (0.180 ms) against 6.07 G FMAs (0.181 ms), the FMAs
// counted as the kernel does them, over all 48 x 48 entries of alpha. The
// tensor cores would buy nothing at config 2's width, and mma.sync would
// sum the products in another order than the fmaf chains below, so Xn and
// Rn would lose their bits.
//
// Design: px_update.cu's two-output streaming schedule on the stacked input
// [P; Z] (2 kin rows), with the Gram of update_gram.cuh. A persistent grid of
// 256-thread blocks (blocks an SM times the SMs, ops/fused.py
// xr_update_gram_plan) walks 128-column tiles. Each block stages alpha once,
// transposed: sA[c][r] = alpha[r, c]. Each tile's [P; Z] is copied into
// shared memory with cp.async in stages of kc stacked rows, double-buffered:
// a stage's buffer is refilled as soon as it has been read, so the next
// stage's copy is in flight while this one computes. Warp w owns rows w*R ..
// w*R+R-1 of BOTH outputs and lane l columns 4l .. 4l+3: P's rows feed Xn's
// FMAs (+alpha), Z's rows Rn's (-alpha), each a float4 shared read of the
// stage and a broadcast read of R coefficients. X and R reach the thread
// ahead of the coefficient loop: on f32 fields as float4 loads of the
// block's next tile, issued as soon as this tile's Xn and Rn are stored, so
// they are in flight through the Gram; on bf16 fields with the tile's first
// stage, as 2k more rows of its cp.async copy (eight-byte loads of four bf16
// a thread, as the f32 route loads its float4s, left the bf16 kernel no
// faster than the f32 one: PERF.md section 6). Xn and Rn are written
// with 16-byte stores (four bf16 a store on bf16 fields). After the tile's
// last stage Rn, as stored, goes into a (k, 136) shared tile from which
// SymGram (common.cuh) takes the Gram in register tiles on and above the
// diagonal (4x4 up to 32 rows, 8x8 above), so G is exactly symmetric. Every block writes one (k, k)
// partial and launch_reduce sums them in block order, in double; the grid
// depends on the card and the build alone, so a repeated call gives the same
// bits. A field whose rows are not 16-byte aligned (n % 4 != 0 on f32, n % 8
// != 0 on bf16, or an offset view) takes element copies and scalar loads and
// stores on the same schedule.
//
// The kernel this replaced ran one thread a column in 128-thread blocks,
// held KMAX-wide columns of X and R in registers, loaded P and Z by scalar
// loads inside the coefficient loop with no copy in flight ahead of use,
// took the Gram in GramTile's register tiles between two barriers a tile,
// and wrote min(n / 128, 1024) partials (1,024 at config 2's width).
//
// Arithmetic: xn_r = X[r, i], then fmaf over c = 0..kin-1 of alpha[r, c]
// P[c, i]; rn_r = R[r, i], then fmaf over c of -alpha[r, c] Z[c, i]; each
// output rounded once, where it is stored. That is the chain of the kernel
// this replaced, so Xn and Rn keep its bits; only G's summation order moved.
//
// Width: one launch writes k <= 64 rows of Xn and Rn with the Gram of its
// rows, and contracts over kin >= k rows of P and Z; a wider field runs
// fused.py's row chunks, whose diagonal Gram blocks wide_gram completes with
// the cross blocks.
//
// bf16 fields (bcg_xr_update_gram_bf16): P, X, Z, R, Xn and Rn are bf16,
// alpha stays f32. The stages hold bf16 (16-byte copies of 8 elements), X
// and R among them, lifted to f32 four at a time as they are read (load4);
// every FMA runs in f32, Xn and Rn are rounded once, and the Gram is of the
// stored, rounded Rn.
//
// In place: Xn may be the same buffer as X and Rn the same as R (the solvers
// donate both). A block copies every stage of a tile's P and Z (and X and R)
// before it writes the tile's columns, the thread that writes Xn[r, i] and
// Rn[r, i] has read X[r, i] and R[r, i] first, the copies and loads in flight
// meanwhile are of its later tiles' columns, and no block reads columns that
// another block writes; X, R, Xn and Rn are therefore not __restrict__. P and
// Z are only read.
#include "common.cuh"

namespace {

// Blocks an SM the kernel is built for: two up to 32 rows (at most 128
// registers a thread), one above, where SymGram's 8x8 tiles and two R x 4
// outputs need more (ops/fused.py _blocks_per_sm, the rule of rows 7 and 8).
template <int GK>
constexpr int kXrBlocksPerSm = GK <= 32 ? 2 : 1;

// Whether a launch stages X and R through shared memory with the tile's first
// stage of [P; Z] (bf16 fields), or loads them into registers (f32 fields).
template <typename E>
constexpr bool kStageXR = sizeof(E) == 2;

// Shared bytes of a launch: alpha's (kin, 8R) float table, kUpStages
// buffers of kc stacked rows of [P; Z] (and on bf16 fields the 2k rows of
// [X; R] a tile's first stage brings), the float (k, kUpLd) tile of Rn, at
// least the Gram's end-of-kernel scratch (SymGram::kScratch <= kUpThreads x
// TS^2 floats). Mirrored by ops/fused.py xr_smem_bytes.
inline long long xr_smem_bytes(int k, int kin, int kc, int esize) {
  const long long rows = kc + (esize == 2 ? 2LL * k : 0);
  const long long b = 4 * (8LL * rows_per_warp(k) * kin + 1LL * k * kUpLd) +
                      esize * kUpStages * rows * kUpTile;
  const long long scratch = 4LL * kUpThreads * (k > 32 ? 64 : 16);
  return b > scratch ? b : scratch;
}

// Copy the stage at `at` into the buffer s (nothing past the last tile): kc
// stacked rows of [P; Z] and, on a tile's first stage of a bf16 launch, the
// tile's X and R after them; one cp.async group, empty or not (load_stage's
// rule).
template <typename E>
__device__ __forceinline__ void load_xr_stage(E* s, const E* P, const E* Z, const E* X,
                                              const E* Rf, int k, int kin, long long n,
                                              StageCursor at, int kc, long long ntiles,
                                              bool vec) {
  if (at.t < ntiles) {
    const long long i0 = at.t * kUpTile;
    load_stacked(s, P, Z, kin, n, i0, at.j * kc, min(kc, 2 * kin - at.j * kc), vec);
    if (kStageXR<E> && at.j == 0) load_stacked(s + kc * kUpTile, X, Rf, k, n, i0, 0, 2 * k, vec);
  }
  cp_async_commit();
}

// E: the field element (float or bf16). R: rows of each output a warp owns.
// GK: the Gram's register width (>= k).
template <typename E, int R, int GK>
__global__ void __launch_bounds__(kUpThreads, kXrBlocksPerSm<GK>)
    xr_update_gram_kernel(const float* __restrict__ Alpha, const E* P, const E* X,
                          const E* Z, const E* Rf, E* Xn, E* Rn, float* __restrict__ part,
                          int k, int kin, long long n, int kc, bool vec) {
  // sA (kin x 8R) | kUpStages x (kc [+ 2k], 128) | sY
  extern __shared__ __align__(16) float smem[];
  constexpr int kRows = 8 * R;
  const int nin = 2 * kin;
  const int ld = (kc + (kStageXR<E> ? 2 * k : 0)) * kUpTile;  // elements of a stage buffer
  float* sA = smem;
  E* sB = reinterpret_cast<E*>(sA + kin * kRows);
  float* sY = reinterpret_cast<float*>(sB + kUpStages * ld);
  for (int e = threadIdx.x; e < kin * kRows; e += kUpThreads) {
    const int c = e / kRows, r = e % kRows;
    sA[e] = r >= k ? 0.f : Alpha[r * kin + c];
  }
  using Gram = SymGram<GK, kUpThreads, (GK > 32 ? 8 : 4)>;
  static_assert(Gram::kScratch <= kUpThreads * (GK > 32 ? 64 : 16),
                "the Gram's scratch must fit xr_smem_bytes' floor");
  Gram g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * R;
  const int nk = (nin + kc - 1) / kc;
  const long long ntiles = (n + kUpTile - 1) / kUpTile;
  StageCursor cur{blockIdx.x, 0}, ahead = cur;
  for (int s = 0; s < kUpStages; ++s, ahead.next(nk))
    load_xr_stage(sB + s * ld, P, Z, X, Rf, k, kin, n, ahead, kc, ntiles, vec);
  int buf = 0;
  float xn[R][4], rn[R][4];  // 0 past n, where nothing is stored
  if (!kStageXR<E> && r0 < k) {  // f32: the block's first tile of X and R
    load_rows4<E, R>(xn, X, r0, k, n, cur.t * kUpTile + 4 * lane, vec);
    load_rows4<E, R>(rn, Rf, r0, k, n, cur.t * kUpTile + 4 * lane, vec);
  }
  while (cur.t < ntiles) {
    cp_async_wait<kUpStages - 1>();  // this stage's copy has landed
    __syncthreads();                 // ... for every thread's share of it (and alpha)
    const long long i = cur.t * kUpTile + 4 * lane;
    const bool last = cur.j == nk - 1;  // the tile's last stage: store Xn and Rn
    const E* sb = sB + buf * ld + 4 * lane;
    if (r0 < k) {
      if (kStageXR<E> && cur.j == 0) {  // bf16: X and R from the stage (rows past k repeat
#pragma unroll                          // row k - 1 and are never stored)
        for (int a = 0; a < R; ++a) {
          const int r = min(r0 + a, k - 1);
          const float4 x = load4(sb + (kc + r) * kUpTile), y = load4(sb + (kc + k + r) * kUpTile);
          xn[a][0] = x.x; xn[a][1] = x.y; xn[a][2] = x.z; xn[a][3] = x.w;
          rn[a][0] = y.x; rn[a][1] = y.y; rn[a][2] = y.z; rn[a][3] = y.w;
        }
      }
      const int c0 = cur.j * kc, c1 = min(c0 + kc, nin);
#pragma unroll 2
      for (int c = c0; c < min(c1, kin); ++c) {  // P's rows: xn += alpha P
        const float4 b = load4(sb + (c - c0) * kUpTile);
        float m[R];
        load_rows<R>(m, sA + c * kRows + r0);
#pragma unroll
        for (int a = 0; a < R; ++a) {
          xn[a][0] = fmaf(m[a], b.x, xn[a][0]);
          xn[a][1] = fmaf(m[a], b.y, xn[a][1]);
          xn[a][2] = fmaf(m[a], b.z, xn[a][2]);
          xn[a][3] = fmaf(m[a], b.w, xn[a][3]);
        }
      }
#pragma unroll 2
      for (int c = max(c0, kin); c < c1; ++c) {  // Z's rows: rn -= alpha Z
        const float4 b = load4(sb + (c - c0) * kUpTile);
        float m[R];
        load_rows<R>(m, sA + (c - kin) * kRows + r0);
#pragma unroll
        for (int a = 0; a < R; ++a) {
          rn[a][0] = fmaf(-m[a], b.x, rn[a][0]);
          rn[a][1] = fmaf(-m[a], b.y, rn[a][1]);
          rn[a][2] = fmaf(-m[a], b.z, rn[a][2]);
          rn[a][3] = fmaf(-m[a], b.w, rn[a][3]);
        }
      }
      if (last) {
        store_rows4<E, R>(Xn, xn, r0, k, n, i, vec);
        store_rows4<E, R>(Rn, rn, r0, k, n, i, vec);
#pragma unroll
        for (int a = 0; a < R; ++a)  // the stored Rn (0 past n) for the Gram
          if (r0 + a < k)
            *reinterpret_cast<float4*>(sY + (r0 + a) * kUpLd + 4 * lane) =
                make_float4(rounded<E>(rn[a][0]), rounded<E>(rn[a][1]),
                            rounded<E>(rn[a][2]), rounded<E>(rn[a][3]));
        if (!kStageXR<E>) {  // f32: the block's next tile of X and R, in flight through the Gram
          const long long next = i + static_cast<long long>(gridDim.x) * kUpTile;
          load_rows4<E, R>(xn, X, r0, k, n, next, vec);
          load_rows4<E, R>(rn, Rf, r0, k, n, next, vec);
        }
      }
    }
    __syncthreads();  // every read of this stage's buffer is done (and sY is written)
    // Refill the buffer kUpStages stages ahead before the Gram, so the Gram
    // runs with kUpStages copies in flight.
    load_xr_stage(sB + buf * ld, P, Z, X, Rf, k, kin, n, ahead, kc, ntiles, vec);
    ahead.next(nk);
    if (last) g.accumulate(sY, kUpLd, kUpTile, k);
    buf = (buf + 1) % kUpStages;
    cur.next(nk);
  }
  cp_async_wait<0>();
  __syncthreads();
  g.store(part + static_cast<long long>(blockIdx.x) * k * k, k, smem);
}

template <typename E, int R, int GK>
cudaError_t launch(const float* Alpha, const E* P, const E* X, const E* Z, const E* Rf, E* Xn,
                   E* Rn, float* part, float* G, int k, int kin, long long n, int kc,
                   int max_blocks, int device, cudaStream_t stream) {
  auto kernel = xr_update_gram_kernel<E, R, GK>;
  const size_t smem = xr_smem_bytes(k, kin, kc, sizeof(E));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(kernel, kUpThreads, smem, device, (n + kUpTile - 1) / kUpTile,
                        max_blocks, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = n % kVec<E> == 0 && aligned16(P) && aligned16(Z) && aligned16(X) &&
                   aligned16(Rf) && aligned16(Xn) && aligned16(Rn);
  kernel<<<grid, kUpThreads, smem, stream>>>(Alpha, P, X, Z, Rf, Xn, Rn, part, k, kin, n, kc,
                                             vec);
  launch_reduce(part, G, k, grid, stream);
  return cudaGetLastError();
}

template <typename E>
int xr_update_gram_entry(const float* Alpha, const E* P, const E* X, const E* Z, const E* Rf,
                         E* Xn, E* Rn, float* part, float* G, int k, int kin, long long n,
                         int kc, int max_blocks, int device, cudaStream_t stream) {
  if (n < 1 || k < 1 || kin < k || kc < 1 || kc > 2 * kin || max_blocks < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
#define BCG_XR(R, GK)                                                                  \
  return launch<E, R, GK>(Alpha, P, X, Z, Rf, Xn, Rn, part, G, k, kin, n, kc, max_blocks, \
                          device, stream)
  switch (rows_per_warp(k)) {  // R = 1, 2, 4, 6, 8 for k <= 8, 16, 32, 48, 64
    case 1: BCG_XR(1, 8);
    case 2: BCG_XR(2, 16);
    case 4: BCG_XR(4, 32);
    case 6: BCG_XR(6, 48);
    case 8: BCG_XR(8, 64);
    default: return cudaErrorInvalidValue;
  }
#undef BCG_XR
}

}  // namespace

// Xn (k, n) = X + alpha P and Rn = R - alpha Z with alpha k x kin (row stride
// kin), P and Z (kin, n), X, R, Xn and Rn (k, n) at row stride n, k <= 64;
// G (k x k) = Rn Rn^T of the stored Rn. kc: stacked rows of [P; Z] a stage
// copies; part holds (max_blocks, k, k) and the launch uses at most
// max_blocks blocks (ops/fused.py xr_update_gram_plan). Xn may equal X and Rn
// may equal R.
extern "C" int bcg_xr_update_gram(const float* Alpha, const float* P, const float* X,
                                  const float* Z, const float* R, float* Xn, float* Rn,
                                  float* part, float* G, int k, int kin, long long n, int kc,
                                  int max_blocks, int device, cudaStream_t stream) {
  return xr_update_gram_entry(Alpha, P, X, Z, R, Xn, Rn, part, G, k, kin, n, kc, max_blocks,
                              device, stream);
}

// The same on bf16 fields; alpha stays f32, and G is the f32 Gram of the
// stored bf16 Rn.
extern "C" int bcg_xr_update_gram_bf16(const float* Alpha, const bf16* P, const bf16* X,
                                       const bf16* Z, const bf16* R, bf16* Xn, bf16* Rn,
                                       float* part, float* G, int k, int kin, long long n,
                                       int kc, int max_blocks, int device,
                                       cudaStream_t stream) {
  return xr_update_gram_entry(Alpha, P, X, Z, R, Xn, Rn, part, G, k, kin, n, kc, max_blocks,
                              device, stream);
}
