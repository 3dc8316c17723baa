// The SBCGrQ iteration tail: Pn = M1 W + rho P and Xn = X + C P in one pass;
// and, on the same schedule, the shifted-block SBCGrQ tail (QR) Q = M2 Q1,
// Pn = Q + rho P, and that tail with the solution's update (QR with X) Q =
// M2 Q1, Pn = Q + rho P, Xn = X + C P.
//
// Replaces the Pallas kernels blockcg_tpu/ops/fused.py px_update (:588),
// qr_p_update (:730) and qr_px_update (:795).
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
// are those of the f32 kernel. That route takes bf16 fields above 64 rows;
// up to 64 rows they run px_update_mma on the tensor cores (below). QR mode takes bf16 fields too
// (bcg_qr_p_update_bf16; with X bcg_qr_px_update_bf16): Q is rounded where
// it is stored mid-tile, while pn
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
// QR with X (qr_px_update): QR's stages and Q store with px's C table, X
// loads and Xn stores; xn = X[r, i], then fmaf over c of C[r, c] P[c, i],
// from the same shared read of P as pn's rho terms. Q, Pn and Xn are the
// fmaf chains of the one-thread-a-column kernel this replaced
// (csrc/qr_p_update.cu, deleted), so they keep its bits. Bound: bytes, six
// field passes (read Q1, P, X; write Q, Pn, Xn), 1,611 MB at (32,
// 2,097,152) in f32 (0.48 ms), with 3 k^2 FMAs a column beside them (0.19
// ms). One launch takes up to 128 rows; the kernel it replaced held KMAX =
// 64 sums a column in each of three register arrays, read one 4-byte element
// of Q1 or P per coefficient column, and ran two launches at 96 rows, each
// reading all of Q1 and P. It takes f32 fields, and bf16 ones above 64 rows
// (px_update_mma's QR-with-X mode takes them up to 64).
//
// In place: Pn may be P (on a launch that covers all rows) and Xn may be X
// (the solver donates both); with QR, Q may be Q1 and Pn P (one launch): Q
// is stored mid-tile, after every stage holding Q1's rows of the tile has
// been copied; with QR and X, Q1, P and X all three (one launch). A block
// copies all stages of its input tile before it writes the tile's columns,
// the thread that writes Xn[r, i] has read X[r, i] first, the copies in
// flight meanwhile are of its later tiles' columns, and no block reads
// columns that another block writes; the field pointers are therefore not
// __restrict__.
#include "common.cuh"
#include "mma.cuh"

namespace {

// Blocks an SM the kernel is built for: two up to 64 rows (at most 128
// registers a thread; the plan keeps the stages within half the SM's shared
// memory), one above.
template <int R>
constexpr int kPxBlocksPerSm = R <= 8 ? 2 : 1;

// E: the field element (float or bf16). QR: W is Q1 and M1 is M2, and Q
// receives M2 Q1 (else Q is unused); XN: C, X and Xn are read and written
// (else unused). px_update: XN alone; qr_p_update: QR alone; qr_px_update:
// both.
template <typename E, int R, bool QR, bool XN>
__global__ void __launch_bounds__(kUpThreads, kPxBlocksPerSm<R>)
    px_update_kernel(const float* __restrict__ M1, const E* W, const float* __restrict__ Rho,
                     const E* P, const float* __restrict__ C, const E* X, E* Q, E* Pn, E* Xn,
                     int k, int kin, long long n, int kc, bool vec) {
  extern __shared__ __align__(16) float smem[];  // sA (2kin x 8R) | sC (kin x 8R) | stages
  constexpr int kRows = 8 * R;
  const int nin = 2 * kin;
  float* sA = smem;
  float* sC = sA + nin * kRows;
  E* sB = reinterpret_cast<E*>(sC + (XN ? kin * kRows : 0));
  for (int e = threadIdx.x; e < nin * kRows; e += kUpThreads) {
    const int c = e / kRows, r = e % kRows;
    sA[e] = r >= k ? 0.f : (c < kin ? M1[r * kin + c] : Rho[r * kin + c - kin]);
  }
  if constexpr (XN) {
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
        for (int a = 0; a < R; ++a) pn[a][0] = pn[a][1] = pn[a][2] = pn[a][3] = 0.f;
        if constexpr (XN) load_rows4<E, R>(xn, X, r0, k, n, i, vec);
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
      if (QR && c0 < kin && c1 >= kin) store_rows4<E, R>(Q, pn, r0, k, n, i, vec);
#pragma unroll 2
      for (int c = c0 > kin ? c0 : kin; c < c1; ++c) {  // P's rows: pn += rho P, xn += C P
        const float4 b = load4(sb + (c - c0) * kUpTile);
        float m[R], cc[R];
        load_rows<R>(m, sA + c * kRows + r0);
        if constexpr (XN) load_rows<R>(cc, sC + (c - kin) * kRows + r0);
#pragma unroll
        for (int a = 0; a < R; ++a) {
          pn[a][0] = fmaf(m[a], b.x, pn[a][0]);
          pn[a][1] = fmaf(m[a], b.y, pn[a][1]);
          pn[a][2] = fmaf(m[a], b.z, pn[a][2]);
          pn[a][3] = fmaf(m[a], b.w, pn[a][3]);
          if constexpr (XN) {
            xn[a][0] = fmaf(cc[a], b.x, xn[a][0]);
            xn[a][1] = fmaf(cc[a], b.y, xn[a][1]);
            xn[a][2] = fmaf(cc[a], b.z, xn[a][2]);
            xn[a][3] = fmaf(cc[a], b.w, xn[a][3]);
          }
        }
      }
      if (j == nk - 1) {  // the tile's last stage: store the outputs
        store_rows4<E, R>(Pn, pn, r0, k, n, i, vec);
        if constexpr (XN) store_rows4<E, R>(Xn, xn, r0, k, n, i, vec);
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

template <typename E, int R, bool QR, bool XN>
cudaError_t launch(const float* M1, const E* W, const float* Rho, const E* P, const float* C,
                   const E* X, E* Q, E* Pn, E* Xn, int k, int kin, long long n, int kc,
                   int device, cudaStream_t stream) {
  auto kernel = px_update_kernel<E, R, QR, XN>;
  const size_t smem = update_smem_bytes(k, kin, kc, XN ? 3 : 2, false, sizeof(E));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long ntiles = (n + kUpTile - 1) / kUpTile;
  int grid = 0;
  err = persistent_grid(kernel, kUpThreads, smem, device, ntiles, ntiles, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = n % kVec<E> == 0 && aligned16(W) && aligned16(P) && aligned16(Pn) &&
                   (!XN || (aligned16(X) && aligned16(Xn))) && (!QR || aligned16(Q));
  kernel<<<grid, kUpThreads, smem, stream>>>(M1, W, Rho, P, C, X, Q, Pn, Xn, k, kin, n, kc,
                                             vec);
  return cudaGetLastError();
}

// The streaming launch of a k-row update (k <= 128) contracting over kin
// rows, by the mode (QR, XN) of px_update_kernel.
template <typename E, bool QR, bool XN>
int update_entry(const float* M1, const E* W, const float* Rho, const E* P, const float* C,
                 const E* X, E* Q, E* Pn, E* Xn, int k, int kin, long long n, int kc, int device,
                 cudaStream_t stream) {
  if (n < 1 || k < 1 || kin < k || kc < 1 || kc > 2 * kin) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
#define BCG_PX(R)                                                                            \
  return launch<E, R, QR, XN>(M1, W, Rho, P, C, X, Q, Pn, Xn, k, kin, n, kc, device, stream)
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

// ---- bf16 fields on the tensor cores (px_update_mma: row 9 in bf16, k <= 64)
//
// update_gram.cuh's update_gram_mma with two outputs and no Gram. The
// stacked coefficient [M1 rho] (k x 2k) and C (k x k) are split exactly
// into three bf16 pieces once a block (split3); each warp owns one 16-row
// tile of both outputs and takes every CG-th pair of 8-column fragments of
// a tile. A ring of TMA stages holds W's and P's (k, T) tiles in boxes of W
// rows (the rows past k zero) and X's in boxes of round8(k) rows, staged as
// update_gram_mma stages its additive field. Per fragment pair and k-step,
// one ldmatrix.trans of W's rows feeds [M1 rho]'s W half, and one of P's
// rows feeds both its rho half and C: the shared read of P the reference
// fuses the two outputs for. Three mma.sync a fragment and k-step (hi, mid,
// lo) sum the exact products in f32. Pn is rounded once into a bf16 tile;
// Xn's fragments add X from the stage in f32 and are rounded once back into
// the stage's X, each element by the thread that read it. The block then
// writes both tiles in 16-byte stores. C's fragments stay in registers up
// to 32 rows; at 64 the three pieces of [M1 rho] already take 96 registers
// a lane, so C's are read from shared memory (one swizzled box of 64
// columns a piece) by ldmatrix, where they cost 24 KB instead of 48
// registers. One block an SM.
//
// Bound: bytes, five field passes (read W, P, X; write Pn, Xn), at (32,
// 256^3) 5,369 MB (1.603 ms at 3.35 TB/s) against 309 GFLOP of products in
// three pieces (0.31 ms at 989 TFLOP/s). The f32-FMA kernel above took 4.4
// ms there on an H100 (its FMAs on the lifted fields at the f32 kernel's
// issue); this one 2.1 ms (PERF.md section 6).
//
// QR with X (QR, bcg_qr_px_update_mma: row 13b, qr_px_update on bf16
// fields up to 64 rows): Q1 takes W's place and [M2 rho] [M1 rho]'s; C and
// X stay. For each fragment pair all of Q1's k-steps run first; Q is then
// rounded once from the f32 sums and stored straight from the fragments (a
// lane's two columns in one 4-byte store: no tile of Q, so the plan and the
// shared bytes are px mode's), and P's k-steps go on from the same,
// unrounded f32 sums, so Pn = Q_f32 + rho P (the reference's q + rho p on
// bf16 fields) is rounded once at its own store; one ldmatrix.trans of P
// feeds rho and C as in px mode. Bound: bytes, six field passes, 604 MB at
// (48, 32^4) (0.18 ms at 3.35 TB/s), against 3 k^2 FMAs a column in f32
// (0.21 ms at 67 TFLOP/s) for the one-thread-a-column kernel it replaced
// (csrc/qr_p_update.cu, deleted), which took 1.79 ms there on an H100 80GB
// HBM3 at 700 W (PERF.md section 6).
//
// In place: Pn may be P and Xn may be X (the solver donates both), and with
// QR, Q may be Q1. A block stages the whole tile (all of W, P and X at its
// columns) before it writes the tile's columns (Q's mid-tile), the TMA
// copies in flight meanwhile are of its later tiles' columns, and no block
// reads columns another block writes; the field pointers are therefore not
// __restrict__.

// Shared bytes of a launch: `stages` stages of W's and P's tiles (W rows
// each) and X's (round8(k) rows), the bf16 tile of Pn, C's three pieces at
// W = 64, and 1 KB to align the boxes; mirrored by ops/fused.py
// px_update_mma_smem_bytes.
__host__ __device__ inline long long px_mma_smem_bytes(int k, int W, int T, int stages) {
  return 2LL * T * (stages * (2 * W + round8(k)) + round8(k)) +
         (W == 64 ? 3LL * 64 * 128 : 0) + 1024;
}

// W: the outputs' width (16, 32, 64: k padded). tw, tp, tx: tensor maps of
// W, P and X (vec; unused otherwise). QR: Wf is Q1, M1 is M2, and Q
// receives M2 Q1 (else Q is unused).
template <int W, bool QR>
__global__ void __launch_bounds__(kUpThreads, 1)
    px_update_mma(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tp,
                  const __grid_constant__ CUtensorMap tx, const float* __restrict__ M1,
                  const bf16* Wf, const float* __restrict__ Rho, const bf16* P,
                  const float* __restrict__ C, const bf16* X, bf16* Q, bf16* Pn, bf16* Xn,
                  int k, long long n, int T, int stages, bool vec) {
  constexpr int MT = W / 16;      // 16-row tiles of the outputs, and k-steps of each field
  constexpr int CG = 8 / MT;      // warps a row tile
  constexpr bool kCs = W == 64;   // C's fragments from shared memory
  extern __shared__ __align__(16) float smem[];  // stages of [W; P; X] | the tile of Pn | C
  __shared__ unsigned long long full[kRingMaxStages];
  char* base = align1k(smem);
  const int r8 = round8(k);
  const int fbytes = 2 * T * W, stage = 2 * fbytes + 2 * T * r8;
  char* pt = base + stages * stage;  // the bf16 tile of Pn, boxes of r8 rows
  char* cs = pt + 2 * T * r8;        // C's piece p: one box of 64 rows at cs + p 64 128
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int rg = warp / CG, cg = warp % CG;
  // The A fragments of this warp's row tile, f[piece][e], of the k x k
  // coefficient M at k-step ks (rows and columns past k zero).
  const auto split_frag = [&](const float* M, int ks, unsigned (&f)[3][4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * rg + g + 8 * (e & 1);
      const int c = 16 * ks + 2 * tq + 8 * (e >> 1);
      bf16 x0[3], x1[3];  // the pieces of M[r, c] and M[r, c + 1]
      split3(r < k && c < k ? M[r * k + c] : 0.f, x0);
      split3(r < k && c + 1 < k ? M[r * k + c + 1] : 0.f, x1);
#pragma unroll
      for (int piece = 0; piece < 3; ++piece) f[piece][e] = pack_bf16(x0[piece], x1[piece]);
    }
  };
  unsigned a[2 * MT][3][4];     // [M1 rho]: k-step ks of W's rows (ks < MT), then of P's
  [[maybe_unused]] unsigned c[kCs ? 1 : MT][3][4];  // C, in registers up to 32 rows
#pragma unroll
  for (int ks = 0; ks < MT; ++ks) {
    split_frag(M1, ks, a[ks]);
    split_frag(Rho, ks, a[MT + ks]);
    if constexpr (!kCs) split_frag(C, ks, c[ks]);
  }
  if constexpr (kCs) {
    for (int e = threadIdx.x; e < 64 * 64; e += kUpThreads) {
      const int r = e / 64, q = e % 64;
      bf16 x[3];
      split3(r < k && q < k ? C[r * k + q] : 0.f, x);
#pragma unroll
      for (int piece = 0; piece < 3; ++piece)
        *reinterpret_cast<bf16*>(cs + piece * 64 * 128 + swz(r, q, 64)) = x[piece];
    }
  }
  // Rows k .. W-1 of every stage's W and P stay zero: their products meet
  // the coefficients' zero columns.
  for (int e = threadIdx.x; e < stages * 2 * (W - k) * T; e += kUpThreads) {
    const int s = e / (2 * (W - k) * T), x = e % (2 * (W - k) * T);
    const int f = x / ((W - k) * T), y = x % ((W - k) * T);
    *reinterpret_cast<bf16*>(base + s * stage + f * fbytes + swz(k + y / T, y % T, W)) =
        __float2bfloat16_rn(0.f);
  }
  const TmaRing ring{full, stages, (n + T - 1) / T};
  const auto load = [&](int s, long long t) {  // stage s takes the tiles t by TMA
    char* sb = base + s * stage;
    tma_post(&full[s], 3 * k, T);
    tma_tile(sb, &tw, W, t * T, T, &full[s]);
    tma_tile(sb + fbytes, &tp, W, t * T, T, &full[s]);
    tma_tile(sb + 2 * fbytes, &tx, r8, t * T, T, &full[s]);
  };
  ring.init();
  __syncthreads();  // the barriers, the zero rows and C's pieces
  if (vec) ring.prime(load);
  // ldmatrix rows of this lane: .trans of a field's (k 16, n 16) block as
  // two B fragments (mm_update_mma), and C's A fragment (gram_mma_tile).
  const int brow = (lane & 7) + 8 * ((lane >> 3) & 1), bcol = 8 * (lane >> 4);
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 8 * (lane >> 4);
  for (long long j = 0, t = blockIdx.x; t < ring.ntiles; ++j, t += gridDim.x) {
    char* sb = base + ring.stage(j) * stage;
    char* sx = sb + 2 * fbytes;
    if (vec) {
      ring.wait(j);
    } else {  // element copies into the same stage
      elem_tile(sb, Wf, k, W, n, t * T, T);
      elem_tile(sb + fbytes, P, k, W, n, t * T, T);
      elem_tile(sx, X, k, r8, n, t * T, T);
    }
    // Every thread is done with the last tile (its stage, which held Xn,
    // and the tile of Pn).
    __syncthreads();
    if (vec && j > 0) ring.refill(j - 1, load);
    for (int pair = cg; pair < T / 16; pair += CG) {
      float pa[2][4] = {}, xa[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < MT; ++ks) {  // W's rows: Pn += M1 W (with QR, Q = M2 Q1)
        unsigned b[4];  // fragment 2 pair (k 0-7, 8-15), then 2 pair + 1
        ldsm_x4_trans(b, sb + swz(16 * ks + brow, 16 * pair + bcol, W));
#pragma unroll
        for (int piece = 0; piece < 3; ++piece) {
          mma_bf16(pa[0], a[ks][piece], b[0], b[1]);
          mma_bf16(pa[1], a[ks][piece], b[2], b[3]);
        }
      }
      if constexpr (QR) {  // Q rounded once and stored; pa goes on unrounded
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * rg + g + 8 * h;
            const long long i = t * T + 16 * pair + 8 * f + 2 * tq;
            if (r >= k || i >= n) continue;
            const __nv_bfloat162 v = __floats2bfloat162_rn(pa[f][2 * h], pa[f][2 * h + 1]);
            bf16* out = Q + r * n + i;
            if (vec) {  // n % 8 == 0 and i even: the pair lies in the row
              *reinterpret_cast<__nv_bfloat162*>(out) = v;
            } else {
              out[0] = __low2bfloat16(v);
              if (i + 1 < n) out[1] = __high2bfloat16(v);
            }
          }
      }
#pragma unroll
      for (int ks = 0; ks < MT; ++ks) {  // P's rows, read once: Pn += rho P, Xn = C P
        unsigned b[4];
        ldsm_x4_trans(b, sb + fbytes + swz(16 * ks + brow, 16 * pair + bcol, W));
#pragma unroll
        for (int piece = 0; piece < 3; ++piece) {
          mma_bf16(pa[0], a[MT + ks][piece], b[0], b[1]);
          mma_bf16(pa[1], a[MT + ks][piece], b[2], b[3]);
          if constexpr (kCs) {
            unsigned cf[4];
            ldsm_x4(cf, cs + piece * 64 * 128 + swz(16 * rg + arow, 16 * ks + acol, 64));
            mma_bf16(xa[0], cf, b[0], b[1]);
            mma_bf16(xa[1], cf, b[2], b[3]);
          } else {
            mma_bf16(xa[0], c[ks][piece], b[0], b[1]);
            mma_bf16(xa[1], c[ks][piece], b[2], b[3]);
          }
        }
      }
      // Pn rounded once into its tile; Xn = X + C P in f32, rounded once
      // into the stage's X where this thread read it.
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * rg + g + 8 * h, q = 16 * pair + 8 * f + 2 * tq;
          if (r >= k) continue;
          *reinterpret_cast<__nv_bfloat162*>(pt + swz(r, q, r8)) =
              __floats2bfloat162_rn(pa[f][2 * h], pa[f][2 * h + 1]);
          __nv_bfloat162* xp = reinterpret_cast<__nv_bfloat162*>(sx + swz(r, q, r8));
          const float2 xv = __bfloat1622float2(*xp);
          *xp = __floats2bfloat162_rn(xv.x + xa[f][2 * h], xv.y + xa[f][2 * h + 1]);
        }
    }
    __syncthreads();  // both tiles are complete
    // Pn and Xn out, 8 columns (16 bytes) a thread.
    const long long i0 = t * T;
    const int chunks = T / 8;
    for (int e = threadIdx.x; e < 2 * k * chunks; e += kUpThreads) {
      const int o = e / (k * chunks), rc = e % (k * chunks);
      const int r = rc / chunks, q = 8 * (rc % chunks);
      const long long i = i0 + q;
      if (i >= n) continue;
      const uint4 v = *reinterpret_cast<const uint4*>((o == 0 ? pt : sx) + swz(r, q, r8));
      bf16* out = (o == 0 ? Pn : Xn) + r * n + i;
      if (vec) {
        *reinterpret_cast<uint4*>(out) = v;
      } else {
        const bf16* w = reinterpret_cast<const bf16*>(&v);
        for (int x = 0; x < 8 && i + x < n; ++x) out[x] = w[x];
      }
    }
    // This thread's writes of Xn into the stage come before the TMA copy
    // that refills it.
    fence_proxy_async();
  }
}

template <int W, bool QR>
cudaError_t launch_px_mma(const float* M1, const bf16* Wf, const float* Rho, const bf16* P,
                          const float* C, const bf16* X, bf16* Q, bf16* Pn, bf16* Xn, int k,
                          long long n, int T, int stages, int device, cudaStream_t stream) {
  auto kernel = px_update_mma<W, QR>;
  const size_t smem = px_mma_smem_bytes(k, W, T, stages);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long ntiles = (n + T - 1) / T;
  int grid = 0;
  err = persistent_grid(kernel, kUpThreads, smem, device, ntiles, ntiles, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = tma_ok(Wf, n) && tma_ok(P, n) && tma_ok(X, n) && aligned16(Pn) &&
                   aligned16(Xn) && (!QR || aligned16(Q));
  CUtensorMap tw{}, tp{}, tx{};
  if (vec) {
    err = make_tmap(&tw, Wf, n, k);
    if (err == cudaSuccess) err = make_tmap(&tp, P, n, k);
    if (err == cudaSuccess) err = make_tmap(&tx, X, n, k);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kUpThreads, smem, stream>>>(tw, tp, tx, M1, Wf, Rho, P, C, X, Q, Pn, Xn, k, n,
                                             T, stages, vec);
  return cudaGetLastError();
}

// The tensor-core launch of a k-row px_update (1 <= k <= 64; with QR
// qr_px_update) at its width: W = 16, 32 or 64. T (128 to 512) and stages
// come from ops/fused.py px_update_mma_plan.
template <bool QR>
int px_update_mma_entry(const float* M1, const bf16* Wf, const float* Rho, const bf16* P,
                        const float* C, const bf16* X, bf16* Q, bf16* Pn, bf16* Xn, int k,
                        long long n, int T, int stages, int device, cudaStream_t stream) {
  if (n < 1 || k < 1 || k > 64 || T < 128 || T > 512 || T % 128 != 0 || stages < 2 ||
      stages > kRingMaxStages)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k <= 16)
    return launch_px_mma<16, QR>(M1, Wf, Rho, P, C, X, Q, Pn, Xn, k, n, T, stages, device,
                                 stream);
  if (k <= 32)
    return launch_px_mma<32, QR>(M1, Wf, Rho, P, C, X, Q, Pn, Xn, k, n, T, stages, device,
                                 stream);
  return launch_px_mma<64, QR>(M1, Wf, Rho, P, C, X, Q, Pn, Xn, k, n, T, stages, device,
                               stream);
}

}  // namespace

// Pn, Xn, X (k, n); M1, rho, C k x kin (row stride kin); W, P (kin, n). kc:
// stacked input rows a stage copies (ops/fused.py update_plan). Xn may equal
// X; Pn may equal P when k == kin.
extern "C" int bcg_px_update(const float* M1, const float* W, const float* Rho,
                             const float* P, const float* C, const float* X, float* Pn,
                             float* Xn, int k, int kin, long long n, int kc, int device,
                             cudaStream_t stream) {
  return update_entry<float, false, true>(M1, W, Rho, P, C, X, nullptr, Pn, Xn, k, kin, n, kc,
                                          device, stream);
}

// The same on bf16 fields W, P, X, Pn and Xn; M1, rho and C stay f32.
extern "C" int bcg_px_update_bf16(const float* M1, const bf16* W, const float* Rho,
                                  const bf16* P, const float* C, const bf16* X, bf16* Pn,
                                  bf16* Xn, int k, int kin, long long n, int kc, int device,
                                  cudaStream_t stream) {
  return update_entry<bf16, false, true>(M1, W, Rho, P, C, X, nullptr, Pn, Xn, k, kin, n, kc,
                                         device, stream);
}

// Q, Pn (k, n); M2, rho k x kin (row stride kin); Q1, P (kin, n). kc: stacked
// input rows a stage copies (ops/fused.py qr_p_update_plan). Q may equal Q1
// and Pn may equal P when k == kin.
extern "C" int bcg_qr_p_update(const float* M2, const float* Q1, const float* Rho,
                               const float* P, float* Q, float* Pn, int k, int kin,
                               long long n, int kc, int device, cudaStream_t stream) {
  return update_entry<float, true, false>(M2, Q1, Rho, P, nullptr, nullptr, Q, Pn, nullptr, k,
                                          kin, n, kc, device, stream);
}

// The same on bf16 fields Q1, P, Q and Pn; M2 and rho stay f32.
extern "C" int bcg_qr_p_update_bf16(const float* M2, const bf16* Q1, const float* Rho,
                                    const bf16* P, bf16* Q, bf16* Pn, int k, int kin,
                                    long long n, int kc, int device, cudaStream_t stream) {
  return update_entry<bf16, true, false>(M2, Q1, Rho, P, nullptr, nullptr, Q, Pn, nullptr, k,
                                         kin, n, kc, device, stream);
}

// Q, Pn, Xn, X (k, n); M2, rho, C k x kin (row stride kin); Q1, P (kin, n).
// kc: stacked input rows a stage copies (ops/fused.py qr_px_update_plan). Xn
// may equal X; Q may equal Q1 and Pn P when k == kin.
extern "C" int bcg_qr_px_update(const float* M2, const float* Q1, const float* Rho,
                                const float* P, const float* C, const float* X, float* Q,
                                float* Pn, float* Xn, int k, int kin, long long n, int kc,
                                int device, cudaStream_t stream) {
  return update_entry<float, true, true>(M2, Q1, Rho, P, C, X, Q, Pn, Xn, k, kin, n, kc, device,
                                         stream);
}

// The same on bf16 fields Q1, P, X, Q, Pn and Xn; M2, rho and C stay f32.
extern "C" int bcg_qr_px_update_bf16(const float* M2, const bf16* Q1, const float* Rho,
                                     const bf16* P, const float* C, const bf16* X, bf16* Q,
                                     bf16* Pn, bf16* Xn, int k, int kin, long long n, int kc,
                                     int device, cudaStream_t stream) {
  return update_entry<bf16, true, true>(M2, Q1, Rho, P, C, X, Q, Pn, Xn, k, kin, n, kc, device,
                                        stream);
}

// The same on bf16 fields on the tensor cores (px_update_mma), k <= 64: Pn =
// M1 W + rho P and Xn = X + C P with M1, rho and C f32 k x k, each split
// exactly into three bf16 pieces. T and stages come from ops/fused.py
// px_update_mma_plan. Pn may equal P and Xn X.
extern "C" int bcg_px_update_mma(const float* M1, const bf16* W, const float* Rho,
                                 const bf16* P, const float* C, const bf16* X, bf16* Pn,
                                 bf16* Xn, int k, long long n, int T, int stages, int device,
                                 cudaStream_t stream) {
  return px_update_mma_entry<false>(M1, W, Rho, P, C, X, nullptr, Pn, Xn, k, n, T, stages,
                                    device, stream);
}

// qr_px_update on bf16 fields on the tensor cores (px_update_mma, QR with X),
// k <= 64: Q = M2 Q1, Pn = Q + rho P (on the unrounded f32 Q) and Xn = X + C
// P, M2, rho and C f32 k x k. T and stages come from ops/fused.py
// px_update_mma_plan. Q may equal Q1, Pn P and Xn X.
extern "C" int bcg_qr_px_update_mma(const float* M2, const bf16* Q1, const float* Rho,
                                    const bf16* P, const float* C, const bf16* X, bf16* Q,
                                    bf16* Pn, bf16* Xn, int k, long long n, int T, int stages,
                                    int device, cudaStream_t stream) {
  return px_update_mma_entry<true>(M2, Q1, Rho, P, C, X, Q, Pn, Xn, k, n, T, stages, device,
                                   stream);
}
