// The SBCGrQ iteration tail: Pn = M1 W + rho P and Xn = X + C P in one pass;
// and, on the same schedule (QR), the shifted-block SBCGrQ tail Q = M2 Q1,
// Pn = Q + rho P.
//
// Replaces the Pallas kernels blockcg_tpu/ops/fused.py px_update (:588) and
// qr_p_update (:730).
//
// Bound: bytes, five field passes (read W, P, X; write Pn, Xn), 1,342 MB at
// (32, 2,097,152), 0.40 ms at 3.35 TB/s, with 3 k^2 FMAs a column beside
// them (0.19 ms at the f32 rate): traffic-bound only if the FMAs overlap the
// copies. The kernel it replaced (one thread a column of 128-thread blocks,
// scalar loads of W and P inside the coefficient loops, loads behind per-row
// conditions, two KMAX-wide output columns in registers) ran at 47% of the
// bound.
//
// Design: mm_update.cu's streaming schedule on the stacked input [W; P]
// (2 kin rows). A persistent grid of 256-thread blocks walks 128-column
// tiles. Each block stages M1, rho and C once, transposed: sA[c][r] = M1[r,
// c] over W's rows and rho[r, c] over P's, sC[c][r] = C[r, c]. Each tile's
// input is copied into shared memory with cp.async in stages of kc stacked
// rows, double-buffered: a stage's buffer is refilled as soon as it has been
// read, so the next stage's copy is in flight while this one computes (kc =
// 2 kin, one stage a tile, where the shared memory of the blocks an SM
// allows: ops/fused.py update_plan; up to 64 rows the kernel is held to 128
// registers for two blocks an SM). Warp w owns rows w*R .. w*R+R-1
// of BOTH outputs and lane l columns 4l .. 4l+3, so one float4 shared read
// of P feeds rho's FMAs and C's, every warp does the same work, and global
// accesses are 16 bytes a thread: cp.async of W and P, float4 loads of X
// (issued at the tile's first stage, ahead of their use) and float4 stores
// of Pn and Xn. A field whose rows are not 16-byte aligned takes 4-byte
// copies and scalar accesses on the same schedule.
//
// Arithmetic: pn_r = fmaf over c of M1[r, c] W[c, i], then of rho[r, c]
// P[c, i]; xn_r = X[r, i], then fmaf over c of C[r, c] P[c, i]: the order of
// the kernel this replaced, so Pn and Xn keep their bits.
//
// Width: one launch writes k <= 128 rows of Pn and Xn and contracts over kin
// >= k rows of W and P (a row chunk of a wider field, ops/fused.py).
//
// bf16 fields (bcg_px_update_bf16): W and P are staged as bf16, 16-byte
// copies of 8 elements (n % 8 == 0), lifted to f32 four at a time as they
// are read; M1, rho and C stay f32; X is
// read and Pn and Xn written four bf16 at a time. The FMAs and their order
// are those of the f32 kernel. QR mode takes bf16 fields too
// (bcg_qr_p_update_bf16): Q is rounded where it is stored mid-tile, while pn
// goes on from the unrounded f32 sums, so Pn = Q + rho P adds rho P to the
// f32 Q (the reference's q + rho p) and is rounded once, at its own store.
//
// QR: the stacked input is [Q1; P], the first table M2 over Q1's rows and
// rho over P's, and there is no C, X or Xn. Q is pn after Q1's kin rows:
// the stage that holds Q1's last row stores it (float4 stores, as Pn), and
// Pn goes on from there over rho's rows. Q and Pn are the fmaf chains of
// the one-thread-a-column kernel this replaced (q over c of M2[r, c] Q1[c,
// i] from 0, then pn from q over rho[r, c] P[c, i]), so they keep its
// bits. Bound: bytes, four field passes (read Q1, P; write Q, Pn), 805 MB
// at (48, 32^4), 0.24 ms; at 96 rows its 2 k^2 FMAs a column take longer
// than the bytes (0.58 ms). The kernel it replaced held KMAX = 64 sums a
// column, read one 4-byte element of Q1 or P per coefficient column, 64
// shared coefficients for each, a third of them padding at 48 rows; it took
// 1.15 ms at (48, 32^4) and two launches at 96 rows, each reading all of Q1
// and P.
//
// In place: Pn may be P (on a launch that covers all rows) and Xn may be X
// (the solver donates both); with QR, Q may be Q1 and Pn P (one launch): Q
// is stored mid-tile, after every stage holding Q1's rows of the tile has
// been copied. A block copies all stages of its input tile before it
// writes the tile's columns, the thread that writes Xn[r, i] has read X[r,
// i] first, the copies in flight meanwhile are of its later tiles' columns,
// and no block reads columns that another block writes; the field pointers
// are therefore not __restrict__.
#include "common.cuh"

namespace {

// Blocks an SM the kernel is built for: two up to 64 rows (at most 128
// registers a thread; the plan keeps the stages within half the SM's shared
// memory), one above.
template <int R>
constexpr int kPxBlocksPerSm = R <= 8 ? 2 : 1;

// F[r0 + a, i .. i + 3] = v[a] for the rows below k: 4-element stores, or
// scalar ones past n and on unaligned fields.
template <typename E, int R>
__device__ __forceinline__ void store_rows4(E* F, const float (&v)[R][4], int r0, int k,
                                            long long n, long long i, bool vec) {
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int r = r0 + a;
    if (r >= k) continue;
    const long long at = r * n + i;
    if (vec && i + 3 < n) {
      store4(F + at, make_float4(v[a][0], v[a][1], v[a][2], v[a][3]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (i + q < n) F[at + q] = from_f32<E>(v[a][q]);
    }
  }
}

// E: the field element (float or bf16). QR: W is Q1, M1 is M2, Xn receives
// Q; C and X are unused.
template <typename E, int R, bool QR>
__global__ void __launch_bounds__(kUpThreads, kPxBlocksPerSm<R>)
    px_update_kernel(const float* __restrict__ M1, const E* W, const float* __restrict__ Rho,
                     const E* P, const float* __restrict__ C, const E* X, E* Pn, E* Xn, int k,
                     int kin, long long n, int kc, bool vec) {
  extern __shared__ __align__(16) float smem[];  // sA (2kin x 8R) | sC (kin x 8R) | stages
  constexpr int kRows = 8 * R;
  const int nin = 2 * kin;
  float* sA = smem;
  float* sC = sA + nin * kRows;
  E* sB = reinterpret_cast<E*>(sC + (QR ? 0 : kin * kRows));
  for (int e = threadIdx.x; e < nin * kRows; e += kUpThreads) {
    const int c = e / kRows, r = e % kRows;
    sA[e] = r >= k ? 0.f : (c < kin ? M1[r * kin + c] : Rho[r * kin + c - kin]);
  }
  if constexpr (!QR) {
    for (int e = threadIdx.x; e < kin * kRows; e += kUpThreads) {
      const int c = e / kRows, r = e % kRows;
      sC[e] = r >= k ? 0.f : C[r * kin + c];
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * R;
  const int nk = (nin + kc - 1) / kc;
  const long long ntiles = (n + kUpTile - 1) / kUpTile;
  StageCursor cur{blockIdx.x, 0}, ahead = cur;
  for (int s = 0; s < kUpStages; ++s, ahead.next(nk))
    load_stage(sB + s * kc * kUpTile, W, P, kin, nin, n, ahead, kc, ntiles, vec);
  int buf = 0;
  float pn[R][4], xn[R][4];
  while (cur.t < ntiles) {
    cp_async_wait<kUpStages - 1>();  // this stage's copy has landed
    __syncthreads();                 // ... for every thread's share of it (and the coefficients)
    const long long t = cur.t;
    const int j = cur.j;
    const long long i = t * kUpTile + 4 * lane;
    if (r0 < k) {
      if (j == 0) {
#pragma unroll
        for (int a = 0; a < R; ++a) {
          const int r = r0 + a;
          pn[a][0] = pn[a][1] = pn[a][2] = pn[a][3] = 0.f;
          if constexpr (QR) continue;
          const long long at = r * n + i;
          if (r >= k) {
            xn[a][0] = xn[a][1] = xn[a][2] = xn[a][3] = 0.f;
          } else if (vec && i + 3 < n) {
            const float4 x = load4(X + at);
            xn[a][0] = x.x; xn[a][1] = x.y; xn[a][2] = x.z; xn[a][3] = x.w;
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) xn[a][q] = i + q < n ? to_f32(X[at + q]) : 0.f;
          }
        }
      }
      const int c0 = j * kc, c1 = min(c0 + kc, nin), cw = min(c1, kin);
      const E* sb = sB + buf * kc * kUpTile + 4 * lane;
#pragma unroll 2
      for (int c = c0; c < cw; ++c) {  // W's rows: pn += M1 W
        const float4 b = load4(sb + (c - c0) * kUpTile);
        float m[R];
        load_rows<R>(m, sA + c * kRows + r0);
#pragma unroll
        for (int a = 0; a < R; ++a) {
          pn[a][0] = fmaf(m[a], b.x, pn[a][0]);
          pn[a][1] = fmaf(m[a], b.y, pn[a][1]);
          pn[a][2] = fmaf(m[a], b.z, pn[a][2]);
          pn[a][3] = fmaf(m[a], b.w, pn[a][3]);
        }
      }
      if (QR && c0 < kin && c1 >= kin) store_rows4<E, R>(Xn, pn, r0, k, n, i, vec);  // Q
#pragma unroll 2
      for (int c = c0 > kin ? c0 : kin; c < c1; ++c) {  // P's rows: pn += rho P, xn += C P
        const float4 b = load4(sb + (c - c0) * kUpTile);
        float m[R], cc[R];
        load_rows<R>(m, sA + c * kRows + r0);
        if constexpr (!QR) load_rows<R>(cc, sC + (c - kin) * kRows + r0);
#pragma unroll
        for (int a = 0; a < R; ++a) {
          pn[a][0] = fmaf(m[a], b.x, pn[a][0]);
          pn[a][1] = fmaf(m[a], b.y, pn[a][1]);
          pn[a][2] = fmaf(m[a], b.z, pn[a][2]);
          pn[a][3] = fmaf(m[a], b.w, pn[a][3]);
          if constexpr (!QR) {
            xn[a][0] = fmaf(cc[a], b.x, xn[a][0]);
            xn[a][1] = fmaf(cc[a], b.y, xn[a][1]);
            xn[a][2] = fmaf(cc[a], b.z, xn[a][2]);
            xn[a][3] = fmaf(cc[a], b.w, xn[a][3]);
          }
        }
      }
      if (j == nk - 1) {  // the tile's last stage: store the outputs
        store_rows4<E, R>(Pn, pn, r0, k, n, i, vec);
        if constexpr (!QR) store_rows4<E, R>(Xn, xn, r0, k, n, i, vec);
      }
    }
    __syncthreads();  // every read of this stage's buffer is done: refill it
    load_stage(sB + buf * kc * kUpTile, W, P, kin, nin, n, ahead, kc, ntiles, vec);
    ahead.next(nk);
    buf = (buf + 1) % kUpStages;
    cur.next(nk);
  }
  cp_async_wait<0>();
}

template <typename E, int R, bool QR>
cudaError_t launch(const float* M1, const E* W, const float* Rho, const E* P, const float* C,
                   const E* X, E* Pn, E* Xn, int k, int kin, long long n, int kc, int device,
                   cudaStream_t stream) {
  auto kernel = px_update_kernel<E, R, QR>;
  const size_t smem = update_smem_bytes(k, kin, kc, QR ? 2 : 3, false, sizeof(E));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long ntiles = (n + kUpTile - 1) / kUpTile;
  int grid = 0;
  err = persistent_grid(kernel, kUpThreads, smem, device, ntiles, ntiles, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = n % kVec<E> == 0 && aligned16(W) && aligned16(P) && (QR || aligned16(X)) &&
                   aligned16(Pn) && aligned16(Xn);
  kernel<<<grid, kUpThreads, smem, stream>>>(M1, W, Rho, P, C, X, Pn, Xn, k, kin, n, kc, vec);
  return cudaGetLastError();
}

template <typename E>
int px_update_entry(const float* M1, const E* W, const float* Rho, const E* P, const float* C,
                    const E* X, E* Pn, E* Xn, int k, int kin, long long n, int kc, int device,
                    cudaStream_t stream) {
  if (n < 1 || k < 1 || kin < k || kc < 1 || kc > 2 * kin) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
#define BCG_PX(R) \
  return launch<E, R, false>(M1, W, Rho, P, C, X, Pn, Xn, k, kin, n, kc, device, stream)
  switch (rows_per_warp(k)) {
    case 1: BCG_PX(1);
    case 2: BCG_PX(2);
    case 4: BCG_PX(4);
    case 6: BCG_PX(6);
    case 8: BCG_PX(8);
    case 12: BCG_PX(12);
    case 16: BCG_PX(16);
    default: return cudaErrorInvalidValue;
  }
#undef BCG_PX
}

template <typename E>
int qr_p_update_entry(const float* M2, const E* Q1, const float* Rho, const E* P, E* Q, E* Pn,
                      int k, int kin, long long n, int kc, int device, cudaStream_t stream) {
  if (n < 1 || k < 1 || kin < k || kc < 1 || kc > 2 * kin) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
#define BCG_QR(R)                                                                            \
  return launch<E, R, true>(M2, Q1, Rho, P, nullptr, nullptr, Pn, Q, k, kin, n, kc, device, \
                            stream)
  switch (rows_per_warp(k)) {
    case 1: BCG_QR(1);
    case 2: BCG_QR(2);
    case 4: BCG_QR(4);
    case 6: BCG_QR(6);
    case 8: BCG_QR(8);
    case 12: BCG_QR(12);
    case 16: BCG_QR(16);
    default: return cudaErrorInvalidValue;
  }
#undef BCG_QR
}

}  // namespace

// Pn, Xn, X (k, n); M1, rho, C k x kin (row stride kin); W, P (kin, n). kc:
// stacked input rows a stage copies (ops/fused.py update_plan). Xn may equal
// X; Pn may equal P when k == kin.
extern "C" int bcg_px_update(const float* M1, const float* W, const float* Rho,
                             const float* P, const float* C, const float* X, float* Pn,
                             float* Xn, int k, int kin, long long n, int kc, int device,
                             cudaStream_t stream) {
  return px_update_entry(M1, W, Rho, P, C, X, Pn, Xn, k, kin, n, kc, device, stream);
}

// The same on bf16 fields W, P, X, Pn and Xn; M1, rho and C stay f32.
extern "C" int bcg_px_update_bf16(const float* M1, const bf16* W, const float* Rho,
                                  const bf16* P, const float* C, const bf16* X, bf16* Pn,
                                  bf16* Xn, int k, int kin, long long n, int kc, int device,
                                  cudaStream_t stream) {
  return px_update_entry(M1, W, Rho, P, C, X, Pn, Xn, k, kin, n, kc, device, stream);
}

// Q, Pn (k, n); M2, rho k x kin (row stride kin); Q1, P (kin, n). kc: stacked
// input rows a stage copies (ops/fused.py qr_p_update_plan). Q may equal Q1
// and Pn may equal P when k == kin.
extern "C" int bcg_qr_p_update(const float* M2, const float* Q1, const float* Rho,
                               const float* P, float* Q, float* Pn, int k, int kin,
                               long long n, int kc, int device, cudaStream_t stream) {
  return qr_p_update_entry(M2, Q1, Rho, P, Q, Pn, k, kin, n, kc, device, stream);
}

// The same on bf16 fields Q1, P, Q and Pn; M2 and rho stay f32.
extern "C" int bcg_qr_p_update_bf16(const float* M2, const bf16* Q1, const float* Rho,
                                    const bf16* P, bf16* Q, bf16* Pn, int k, int kin,
                                    long long n, int kc, int device, cudaStream_t stream) {
  return qr_p_update_entry(M2, Q1, Rho, P, Q, Pn, k, kin, n, kc, device, stream);
}
