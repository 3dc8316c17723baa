// Toroidal DIA SpMM, optionally with the fused Gram G = X Y^T.
//
// Replaces the Pallas kernels blockcg_tpu/ops/stencil.py (stencil_spmm_t,
// stencil_spmm_gram_t) and blockcg_tpu/ops/stencil_ring.py (ring_spmm_t,
// ring_spmm_gram_t). Contract: Y[r, i] = sum_d diags[d, i] * X[r, (i + o_d) mod n];
// the Gram variant also returns G = X Y^T (k x k) on the stored Y. The TPU
// windowing and the ring schedule are schedules, not part of the contract.
//
// Bound: bytes. Per column it reads ndiag coefficients and k values of X and
// writes k values of Y (0.18 ms at 128^3, k = 32). The kernel this replaced
// read all k rows of X once per diagonal and left the reuse to L2: 7x X of
// L2->SM traffic at 128^3, which alone takes about as long as the whole
// apply did (0.44 ms).
//
// Design. A persistent grid walks column tiles [i0, i0 + T), T = 256 (128 on
// small fields): one column a thread. For each tile a block copies the window
// X[:, i0 - h, i0 + T + h) (taken mod n, so a window that crosses 0 or n
// wraps) and the tile's diags into shared memory with cp.async,
// double-buffered: the next tile's copies are in flight while this tile's
// SpMM runs. Diagonals with a signed offset |s| <= h (the near ones)
// read X from the window; the others (far) read global memory, which L2
// serves, since neighbouring blocks touch the same planes. The host picks h
// and T (ops/stencil.py stencil_plan) to
// minimise the L2->SM traffic per column, (T + 2h) / T + the far diagonals,
// per busy thread: two blocks an SM (KMAX <= 32) beat a wider halo in one, so
// at 128^3, k = 32, h = 4 serves 0 and +-1 from the window and the traffic
// falls from 7x X to 5x. The thread keeps its k sums in registers and issues
// all k loads of a diagonal before their FMAs (rows past k repeat row k - 1
// and are never stored): with a branch per row, as the kernel before this
// one had, each load waited for the one before, which the old grid's 32-64
// warps an SM hid and a window-sized block's 8-16 do not. Window reads are
// conflict-free scalar loads (consecutive lanes, consecutive columns); Y goes
// out in coalesced 128-byte lines per warp and row. Each diagonal's terms are
// added in the order d = 0..ndiag-1 with fmaf, as the kernel before this one
// did, so Y keeps its bits.
//
// Gram. A launch with the Gram runs one of the tensor-core kernels below
// (stencil_mma on a bf16 field, stencil_mma_f32 on an f32 one of at most 32
// rows) or, on an f32 field of 33 to 64 rows, this kernel's Gram form
// (stencil_vec_gram below); each block writes one (k, k) partial, and a
// second kernel sums the partials in block order in double (common.cuh). No
// atomics: a repeated call gives the same bits.
//
// Width: one launch holds k <= 64 rows (the Python wrapper issues one launch
// per row chunk; the window's budget shrinks h or T as k grows). Y is always
// a separate buffer: other blocks still read the X columns this block's Y
// covers.
//
// bf16 (bcg_stencil_spmm_bf16: bf16 X, diagonals and Y): the window and the
// coefficient tiles are staged as bf16, 16-byte copies of 8 elements, so h
// is a multiple of 8 (the window's first column then is too) and n % 8 == 0
// for the vector copies; the window's row stride is T + 2h. Every product
// of two bf16 is exact in f32 and accumulates in f32 in the same order as
// the f32 kernel's; Y is stored rounded to bf16. With the Gram, a bf16 field
// runs stencil_mma below: the same sums, the Gram X Y^T of the unrounded f32
// sums on the tensor cores, Y split into three exact bf16 pieces (its design
// and bound are described there), as the reference's Pallas kernel takes the
// Gram from its f32 accumulator. Without the Gram (rows 1b and 1x) a bf16
// field runs stencil_ring below, the reference's ring of planes cut to fit
// an SM, where its plan finds a stride that takes every offset, else
// stencil_spmm; so does an f32 field on bf16 diagonals (row 1m).
//
// Mixed pairs (the reference's gate takes bf16 or f32 for the diagonals and
// the field independently): bcg_stencil_spmm_bf16d takes bf16 diagonals with
// f32 X and Y (its Gram as the f32 field's),
// bcg_stencil_spmm_bf16x f32 diagonals with bf16 X and Y (its Gram on
// stencil_mma, as the bf16 field's). The
// diagonals' element (ED) and the field's (EX) are separate template
// parameters: the window is staged in EX (h a multiple of kVec<EX>), the
// coefficient tiles in ED, each lifted to f32 at its use, and every sum runs
// in f32 in the order d = 0..ndiag-1, so a pair whose values are exact in
// both types gives the unmixed kernel's bits.
//
// f32 field with the Gram (rows 2 and 2m, any diagonals' element): a launch
// of at most 32 rows runs stencil_mma_f32 below, the Gram on the tensor
// cores from X and the f32 sums in three exact bf16 pieces; a launch of 33
// to 64 rows runs stencil_vec_gram, this kernel with its Gram in f32 FMAs
// (VecGram) flushed to double sums every kVecGramFlush tiles.
//
// Wide bf16 Gram: where Y is bf16 and the field is wider than one launch,
// the solvers' Gram needs the f32 sums of every row, which the stored Y has
// lost. Each launch then runs stencil_mma_cols below: its rows of Y and the
// whole column block of G they give, G[:, r0:r1] = X Y_f32[r0:r1]^T, from
// the sums it has just computed (ops/stencil.py).
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kMaxDiags = 32;
constexpr int kStThreads = 256;
constexpr int kFar = 0x7fffffff;

struct Diags {
  int o[kMaxDiags];      // each in [0, n)
  int s[kMaxDiags];      // signed shift in [-h, h] for a near diagonal, kFar otherwise
  // stencil_mma: the far slab a far diagonal is staged in, or -1 (stencil_mma_f32:
  // the first kStF32Prefetch of them are loaded a step ahead)
  int stage[kMaxDiags];
  int far[kMaxDiags];  // stencil_mma: the diagonal of each staged far slab
  int nst;             // stencil_mma: staged far slabs
};

// Window of the tile at i0: sw[r * W + v] = X[r, (i0 - h + v) mod n] for
// v < T + 2h; the tile's coefficients: sd[d * T + c] = diags[d, i0 + c]
// (0 past n).
template <typename ED, typename EX>
__device__ __forceinline__ void load_tile(EX* sw, ED* sd, const EX* X, const ED* diags, int ndiag,
                                          int k, long long n, long long i0, int h, int T, int W,
                                          bool vec) {
  constexpr int kx = kVec<EX>, kd = kVec<ED>;
  const int span = T + 2 * h;
  long long base = (i0 - h) % n;  // the window's first column, in [0, n)
  if (base < 0) base += n;
  if (vec) {  // n, h, T and i0 are multiples of kx and kd: a 16-byte copy never straddles n
    const int q = span / kx;
    for (int e = threadIdx.x; e < k * q; e += kStThreads) {
      const int r = e / q, v = kx * (e - r * q);
      long long j = base + v;
      while (j >= n) j -= n;  // more than once only where the window is wider than n
      cp_async16(sw + r * W + v, X + r * n + j, true);
    }
    const int tq = T / kd;
    for (int e = threadIdx.x; e < ndiag * tq; e += kStThreads) {
      const int d = e / tq, c = kd * (e - d * tq);
      const bool in = i0 + c < n;
      cp_async16(sd + d * T + c, diags + (in ? d * n + i0 + c : 0), in);
    }
  } else {
    for (int e = threadIdx.x; e < k * span; e += kStThreads) {
      const int r = e / span, v = e - r * span;
      long long j = base + v;
      while (j >= n) j -= n;
      cp_elem(sw + r * W + v, X + r * n + j, true);
    }
    for (int e = threadIdx.x; e < ndiag * T; e += kStThreads) {
      const int d = e / T, c = e - d * T;
      const bool in = i0 + c < n;
      cp_elem(sd + d * T + c, diags + (in ? d * n + i0 + c : 0), in);
    }
  }
}

// Row stride of the window, in elements of esize bytes: its T + 2h columns,
// plus 4 for floats up to 32 rows (without them row 1m at (32, 128^3) ran 2%
// slower on an H100, 371.5-376.5 against 363.6-370.4 device us; PERF.md). A
// bf16 window keeps T + 2h, a multiple of 8: every row's 16-byte copies stay
// aligned.
__host__ __device__ inline int window_ld(int k, int h, int T, int esize) {
  return T + 2 * h + (esize == 4 && k <= 32 ? 4 : 0);
}

// Shared bytes of one launch: two windows of k rows of window_ld esize-byte
// elements and two coefficient tiles of dsize-byte ones; mirrored by
// ops/stencil.py smem_bytes.
__host__ __device__ inline long long smem_bytes(int k, int ndiag, int h, int T, int esize,
                                                int dsize) {
  return 2LL * (esize * k * static_cast<long long>(window_ld(k, h, T, esize)) +
                dsize * static_cast<long long>(ndiag) * T);
}

// ---- an f32 field's Gram at 33 to 64 rows (stencil_vec_gram)
//
// Rows 2 and 2m at 33 to 64 rows a launch (config 5's f32 route: 64 rows):
// stencil_spmm below with WITH_GRAM, the schedule the tensor-core Gram
// replaced, whose SpMM is the kernel's own (so Y keeps its bits). After a
// tile's SpMM its f32 sums go to a tile of Y in shared memory (0 past n)
// and, behind a barrier, the
// block adds X Y^T of the tile into VecGram<64> register tiles: 8 x 8 a
// thread, rows rt + 8a and columns st + 8b, fed by float4 shared loads along
// the columns of the window's centre and of the tile of Y (16 loads for 256
// FMAs); the block's 256 threads hold four copies of G, each over every
// fourth group of 4 columns. At 64 rows the tensor-core schedule
// (stencil_mma_f32 on StMma<64>, no longer built: that kernel takes 32 rows
// at most) computed every row's SpMM in each of its two row groups and read X
// in each of its four column groups: 15.3 ms at (64, 256^3) against this
// schedule's 11.5 (H100 80GB HBM3 at 700 W; PERF.md section 6).
//
// Summation. Kept in f32 across all of a block's tiles (the kernel before),
// each entry of G summed a few thousand products in f32, and its distance
// from the f64 Gram grew with n (1.37x the tensor-core route's at (64,
// 128^3)). Here the f32 tiles restart every F = kVecGramFlush tiles: the
// four copies' tiles go through
// the tile of Y's shared memory (the copy's slot e = (t mod 64) + 64 (8a +
// b), conflict-free both ways), and thread u adds slots u + 256 j (j < 16)
// of the four copies, in copy order, into its 16 double sums, which no
// thread but u touches. At the end each block writes its double sums as a
// (k, k) partial, and reduce_partials_f64 (common.cuh) adds the partials in
// block order in double. No atomics: a repeat gives the same bits.
//
// Bound: bytes, 9.06 GB at (64, 256^3) (2.70 ms at 3.35 TB/s; the SpMM's
// and the Gram's 152 GFLOP of f32 FMAs 2.27 ms at 67 TFLOP/s). The Gram's
// FMAs, two barriers a tile and the far diagonals' reads from L2 run one
// after another in each block, one 8-warp block an SM.

// Blocks an SM the kernel is built for: two for the SpMM up to KMAX = 32
// (128 registers a thread), one at KMAX = 64 and with the Gram, whose 8x8
// register tiles want the registers more than a second block.
// ops/stencil.py stencil_plan assumes the same.
template <int KMAX, bool WITH_GRAM = false>
constexpr int kStBlocksPerSm = !WITH_GRAM && KMAX <= 32 ? 2 : 1;

// Tiles a block's f32 Gram tiles sum before flush_gram adds them into
// doubles; mirrored by ops/stencil.py VEC_GRAM_FLUSH. At (64, 256^3) F = 1,
// 2 and 4 took 11,641, 11,427 and 11,330 device us, 8 and 16 about 11,330,
// G's distance from its f64 contract at (64, 64^3) rising from 2.49e-08 (F
// = 1) to 2.57e-08 (4) and 3.06e-08 (8) (H100 80GB HBM3 at 700 W, L2
// flushed; tools/torch_kernel_times.py --storage --variants, PERF.md
// section 6).
constexpr int kVecGramFlush = 4;

// The Gram form's register tiles, and the double sums each thread keeps of
// the block's (64, 64) tile.
using StGram = VecGram<64, kStThreads>;
constexpr int kStGramSlots = 64 * 64 / kStThreads;
static_assert(StGram::TS == 8 && StGram::S == 8 &&
                  StGram::kGroups * StGram::kCopy == kStThreads,
              "flush_gram's slots assume 8x8 tiles in four copies of 64 threads");

// Add the copies' f32 tiles into the threads' double sums, in copy order,
// and restart them; scratch: StGram::kScratch floats no thread still reads.
__device__ __forceinline__ void flush_gram(StGram& g, double (&sum)[kStGramSlots],
                                           float* scratch) {
  float* mine = scratch + g.grp * 4096 + threadIdx.x % 64;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      mine[64 * (8 * a + b)] = g.acc[a][b];
      g.acc[a][b] = 0.f;
    }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kStGramSlots; ++j) {
    const float* e = scratch + threadIdx.x + kStThreads * j;
    double v = sum[j];
#pragma unroll
    for (int c = 0; c < StGram::kGroups; ++c) v += static_cast<double>(e[4096 * c]);
    sum[j] = v;
  }
}

// ED: the element of the diagonals, EX: of X and Y (float or bf16 each).
// WITH_GRAM (f32 X, KMAX = 64): part (gridDim.x, k, k) doubles, the tiles'
// f32 sums flushed to double every F tiles (kVecGramFlush; other F in the
// timing tool's probe builds alone).
template <typename ED, typename EX, int KMAX, bool WITH_GRAM = false, int F = kVecGramFlush>
__global__ void __launch_bounds__(kStThreads, (kStBlocksPerSm<KMAX, WITH_GRAM>))
    stencil_spmm(const ED* __restrict__ diags, Diags dg, int ndiag, const EX* __restrict__ X,
                 EX* __restrict__ Y, double* __restrict__ part, int k, long long n, int h,
                 int T, bool vec) {
  static_assert(!WITH_GRAM || (KMAX == 64 && std::is_same_v<EX, float>),
                "the Gram form takes an f32 field of up to 64 rows");
  static_assert(F >= 1, "a flush every F >= 1 tiles");
  extern __shared__ __align__(16) float smem[];  // 2 windows | 2 coefficient tiles | sY
  const int W = window_ld(k, h, T, sizeof(EX));
  EX* sw0 = reinterpret_cast<EX*>(smem);
  ED* sd0 = reinterpret_cast<ED*>(sw0 + 2 * k * W);
  [[maybe_unused]] float* sy = reinterpret_cast<float*>(sd0 + 2 * ndiag * T);
  [[maybe_unused]] const int LY = T + 4;
  using Gram = std::conditional_t<WITH_GRAM, StGram, char>;
  [[maybe_unused]] Gram g{};
  [[maybe_unused]] double sum[WITH_GRAM ? kStGramSlots : 1] = {};
  [[maybe_unused]] int f = 0;
  const long long ntiles = (n + T - 1) / T;
  long long t = blockIdx.x;
  int buf = 0;
  if (t < ntiles) load_tile(sw0, sd0, X, diags, ndiag, k, n, t * T, h, T, W, vec);
  cp_async_commit();
  for (; t < ntiles; t += gridDim.x) {
    const long long tn = t + gridDim.x;
    if (tn < ntiles)
      load_tile(sw0 + (buf ^ 1) * k * W, sd0 + (buf ^ 1) * ndiag * T, X, diags, ndiag, k, n,
                tn * T, h, T, W, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const EX* sw = sw0 + buf * k * W;
    const ED* sd = sd0 + buf * ndiag * T;
    const long long i0 = t * T;
    for (int c = threadIdx.x; c < T; c += kStThreads) {
      const long long i = i0 + c;
      const bool valid = i < n;
      float acc[KMAX];
#pragma unroll
      for (int r = 0; r < KMAX; ++r) acc[r] = 0.f;
      if (valid) {
        for (int d = 0; d < ndiag; ++d) {
          const float coef = to_f32(sd[d * T + c]);
          const int s = dg.s[d];
          // All KMAX loads first, unconditionally (rows past k repeat row
          // k - 1 and are never stored), so they are in flight together.
          float x[KMAX];
          if (s != kFar) {
            const EX* w = sw + h + s + c;
#pragma unroll
            for (int r = 0; r < KMAX; ++r) x[r] = to_f32(w[min(r, k - 1) * W]);
          } else {
            long long j = i + dg.o[d];
            if (j >= n) j -= n;
            const EX* xj = X + j;
#pragma unroll
            for (int r = 0; r < KMAX; ++r) x[r] = to_f32(xj[min(r, k - 1) * n]);
          }
#pragma unroll
          for (int r = 0; r < KMAX; ++r) acc[r] = fmaf(coef, x[r], acc[r]);
        }
#pragma unroll
        for (int r = 0; r < KMAX; ++r)
          if (r < k) Y[r * n + i] = from_f32<EX>(acc[r]);
      }
      if constexpr (WITH_GRAM) {
#pragma unroll
        for (int r = 0; r < KMAX; ++r)
          if (r < k) sy[r * LY + c] = acc[r];  // 0 past n
      }
    }
    if constexpr (WITH_GRAM) {
      __syncthreads();  // sY is written
      g.accumulate(sw + h, W, sy, LY, T, k);
    }
    __syncthreads();  // every read of this buffer (and of sY) is done
    if constexpr (WITH_GRAM) {
      if (++f == F) {  // the next tile's first barrier orders the flush's reads of sY
        flush_gram(g, sum, sy);
        f = 0;
      }
    }
    buf ^= 1;
  }
  cp_async_wait<0>();
  if constexpr (WITH_GRAM) {
    if (f != 0) flush_gram(g, sum, sy);
    double* mine = part + static_cast<long long>(blockIdx.x) * k * k;
#pragma unroll
    for (int j = 0; j < kStGramSlots; ++j) {
      const int e = threadIdx.x + kStThreads * j, s = e % 64, ab = e / 64;
      const int r = s / 8 + 8 * (ab / 8), c = s % 8 + 8 * (ab % 8);
      if (r < k && c < k) mine[r * k + c] = sum[j];
    }
  }
}

template <typename ED, typename EX, int KMAX>
cudaError_t launch(const ED* diags, const Diags& dg, int ndiag, const EX* X, EX* Y, int k,
                   long long n, int h, int T, int max_blocks, int device, cudaStream_t stream) {
  auto kernel = stencil_spmm<ED, EX, KMAX>;
  const size_t smem = smem_bytes(k, ndiag, h, T, sizeof(EX), sizeof(ED));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(kernel, kStThreads, smem, device, (n + T - 1) / T, max_blocks, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = n % kVec<EX> == 0 && n % kVec<ED> == 0 && aligned16(X) && aligned16(diags);
  kernel<<<grid, kStThreads, smem, stream>>>(diags, dg, ndiag, X, Y, nullptr, k, n, h, T, vec);
  return cudaGetLastError();
}

// Shared bytes of a stencil_vec_gram launch: stencil_spmm's two f32 windows
// and coefficient tiles of dsize-byte elements, then the float (k, T + 4)
// tile of Y, at least the copies' tiles that flush_gram stages there;
// mirrored by ops/stencil.py vec_gram_smem_bytes.
__host__ __device__ inline long long vec_gram_smem_bytes(int k, int ndiag, int h, int T,
                                                         int dsize) {
  const long long ly = 1LL * k * (T + 4);
  return smem_bytes(k, ndiag, h, T, 4, dsize) +
         4 * (ly > StGram::kScratch ? ly : StGram::kScratch);
}

template <typename ED, int F = kVecGramFlush>
cudaError_t launch_vec_gram(const ED* diags, const Diags& dg, int ndiag, const float* X,
                            float* Y, double* part, float* G, int k, long long n, int h, int T,
                            int max_blocks, int device, cudaStream_t stream) {
  auto kernel = stencil_spmm<ED, float, 64, true, F>;
  const size_t smem = vec_gram_smem_bytes(k, ndiag, h, T, sizeof(ED));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(kernel, kStThreads, smem, device, (n + T - 1) / T, max_blocks, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = n % 4 == 0 && n % kVec<ED> == 0 && aligned16(X) && aligned16(diags);
  kernel<<<grid, kStThreads, smem, stream>>>(diags, dg, ndiag, X, Y, part, k, n, h, T, vec);
  launch_reduce_f64(part, G, k * k, grid, stream);
  return cudaGetLastError();
}

// ---- the DIA stencil without the Gram on a ring of planes (stencil_ring)
//
// Rows 1b and 1x (bf16 X and Y; bf16 or f32 diagonals) and 1m (f32 X and
// Y, bf16 diagonals; and row 1, f32 diagonals, where its plan sends it), the reference's
// ring schedule (blockcg_tpu/ops/stencil_ring.py) cut to fit an SM. Each
// offset decomposes as o = m S + r with |r| <= h and |m| <= M, S a stride
// that divides n (at (32, 256^3) S = 65,536, h = 256: 0, +-1 and +-256 are
// near, +-65,536 one plane away; at 128^3 S = 16,384, h = 128). A work item
// owns a patch of P = kRingCols columns [c0, c0 + P), a group of R rows
// and a run of planes j; it walks the columns c0 + j S + [0, P) plane by
// plane. Its ring holds 2M + 2 slots in shared memory: the planes j - M ..
// j + M that step j reads and the one being filled. A slot holds the R rows
// of X at columns c0 + j S - h .. c0 + j S + P + h (mod n), so a term of
// offset m S + r reads slot j + m at its column + h + r, and no X is read
// from L2 at its use. Each slot is copied once, as one TMA tensor box of a
// 3-D view of X ((granule, granule index, row): boxes of at most 256 in
// each dimension and rows that start on 16-byte boundaries); the windows
// that cross 0 or n (the first patch's first plane, the last patch's last)
// are copied by the producer warp's lanes. Beside the X slots, two buffers
// take the coefficients of the step's plane, one box of the (256, n / 256,
// ndiag) view of the diagonals.
//
// Pipeline: one producer warp and 8 consumer warps. Stage q (the block's
// q-th step) brings X of plane j + M and the coefficients of plane j (the
// item's first stage also the planes j - M .. j + M - 1) and completes on
// full[q % 2] (lane 0 posts its bytes, expect_tx); it is issued once step q
// - 2 is done (empty[q % 2]), which freed the slot and the coefficient
// buffer it takes, so up to two stages are in flight while a step computes.
// An item's first stage also waits for the step before it: the ring
// restarts with each item.
//
// Consumers: thread t computes the patch's columns 4t .. 4t + 3 for the R
// rows of its group, the sums in registers, each term added with fmaf in the
// order d = 0..ndiag-1 from operands lifted exactly to f32 (stencil_spmm's
// chain, so Y keeps its bits), Y stored in the field's element, 8 bytes a
// row on bf16, 16 on f32. One warp-uniform branch a diagonal on the shift
// h + r mod 4 picks the slot reads: on bf16 an 8-byte read where the shift
// is a multiple of 4, else 4-byte reads of the aligned words holding the
// four values (two for an even shift, three for an odd one); on f32 a
// 16-byte read where it is a multiple of 4, two 8-byte reads for an even
// shift, and a 4-byte, an 8-byte and a 4-byte read for an odd one.
//
// Element of the field (EX, beside the diagonals' ED): a slot holds R rows of
// P + 2h elements of EX, so an f32 slot holds half the rows a bf16 one does
// in the same bytes: R = 8 or 16 rows on bf16, 4 or 8 on f32. The 3-D view
// of X takes boxes of EX, and a row starts on a 16-byte boundary (n % 1,024
// == 0 from the plan).
//
// The host plan (ops/stencil.py stencil_ring_plan) picks S, h, M, R and the
// planes an item walks (enough items to fill the SMs, the ring's refills
// of the first planes counted) by L2->SM traffic, and sends a launch where
// no S fits (no stride that divides n and takes every offset, a window
// wider than the boxes take, a ragged or unaligned field) to stencil_spmm.
// Traffic at (32, 256^3) on bf16 diagonals: X (P + 2h) / P = 1.5 times (R =
// 16 rows of 32), the diagonals once per row group: about 2.1 GB of
// L2->SM copies against stencil_spmm's 5 X = 5.4 GB. Row 1m at (32, 128^3):
// X 1.25 times (R = 8 f32 rows of a 40 KB slot, four slots and two 14 KB
// coefficient buffers in 189 KB), the diagonals once per row group: about
// 0.45 GB against the window kernel's 5 X = 1.34 GB.
//
// Bound: bytes, 2,382 MB at (32, 256^3) with bf16 diagonals (0.711 ms at
// 3.35 TB/s), 327 MB at (32, 128^3) with f32 diagonals (0.098 ms). On an
// H100 with L2 flushed: 0.852 ms (83% of the bound) against stencil_spmm's
// 2.46-2.48 at 256^3, and 0.124 (79%) against 0.287-0.289 at 128^3 (PERF.md
// section 6).
constexpr int kRingThreads = 256;                 // consumer threads, 4 columns each
constexpr int kRingCols = 4 * kRingThreads;       // P: the columns of a patch
constexpr int kRingMaxSlots = 8;                  // 2M + 2 slots: M <= 3
constexpr int kRingBox = 256;                     // the largest dimension of a TMA box

struct Ring {
  int m[kMaxDiags], r[kMaxDiags];  // o_d = m S + r (mod n)
  long long n, S;
  int ndiag, k, h, M, slots, npl, len, npatch, ngrp, items, g;
};

struct RingMaps {
  CUtensorMap x, d;  // X as (g, n / g, k); the diagonals as (256, n / 256, ndiag)
};

__host__ __device__ inline long long ring_round128(long long b) { return (b + 127) / 128 * 128; }
__host__ __device__ inline int ring_span(int h) { return kRingCols + 2 * h; }

// Bytes of a slot of R rows of esize-byte elements (rounded up to 128, a
// box's alignment) and of a coefficient buffer of dsize-byte elements.
__host__ __device__ inline long long ring_slot_bytes(int R, int h, int esize) {
  return ring_round128(1LL * esize * R * ring_span(h));
}
__host__ __device__ inline long long ring_coef_bytes(int ndiag, int dsize) {
  return ring_round128(1LL * dsize * ndiag * kRingCols);
}

// Shared bytes of a launch: the slots, two coefficient buffers, 128 bytes to
// align the boxes and 128 past the last buffer, which an odd shift's last
// 4-byte read may touch; mirrored by ops/stencil.py ring_smem_bytes.
__host__ __device__ inline long long ring_smem_bytes(int R, int h, int slots, int ndiag,
                                                     int dsize, int esize) {
  return slots * ring_slot_bytes(R, h, esize) + 2 * ring_coef_bytes(ndiag, dsize) + 256;
}

// The item's patch, first row, first plane and planes: items run patch
// fastest, then row group, then run of planes, so the blocks in flight
// together share planes (their halos and coefficients meet in L2).
struct RingItem {
  long long c0;
  int r0, j0, len;
};

__device__ __forceinline__ RingItem ring_item(const Ring& rg, int R, int it) {
  const int patch = it % rg.npatch, rest = it / rg.npatch;
  RingItem a;
  a.c0 = static_cast<long long>(patch) * kRingCols;
  a.r0 = (rest % rg.ngrp) * R;
  a.j0 = (rest / rg.ngrp) * rg.len;
  a.len = min(rg.len, rg.npl - a.j0);
  return a;
}

// The first column of the window of the item's plane j0 + v (v may be
// negative or pass the last plane: the planes are taken mod npl); may lie
// below 0 or end past n, where the window wraps.
__device__ __forceinline__ long long ring_window(const Ring& rg, const RingItem& a, int v) {
  int jr = a.j0 + v;  // in [-M, npl + M): no division on the producer's path
  while (jr < 0) jr += rg.npl;
  while (jr >= rg.npl) jr -= rg.npl;
  return a.c0 + jr * rg.S - rg.h;
}

// f32 of the lower and upper bf16 of a word.
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// Four consecutive bf16 of a staged row from element 4 q + SH, lifted to f32
// (p: the 8-byte aligned element 4 q).
template <int SH>
__device__ __forceinline__ void ring_quad(float (&x)[4], const bf16* p) {
  const unsigned* w = reinterpret_cast<const unsigned*>(p);
  if constexpr (SH == 0) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    x[0] = bf_lo(u.x); x[1] = bf_hi(u.x); x[2] = bf_lo(u.y); x[3] = bf_hi(u.y);
  } else if constexpr (SH == 2) {
    const unsigned a = w[1], b = w[2];
    x[0] = bf_lo(a); x[1] = bf_hi(a); x[2] = bf_lo(b); x[3] = bf_hi(b);
  } else {
    constexpr int i = SH == 1 ? 0 : 1;
    const unsigned a = w[i], b = w[i + 1], c = w[i + 2];
    x[0] = bf_hi(a); x[1] = bf_lo(b); x[2] = bf_hi(b); x[3] = bf_lo(c);
  }
}

// Four consecutive f32 of a staged row from element 4 q + SH (p: the
// 16-byte aligned element 4 q): one 16-byte read, two 8-byte reads, or a
// 4-byte, an 8-byte and a 4-byte read, none past element 4 q + 7.
template <int SH>
__device__ __forceinline__ void ring_quad(float (&x)[4], const float* p) {
  if constexpr (SH == 0) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  } else if constexpr (SH == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p + 2);
    const float2 b = *reinterpret_cast<const float2*>(p + 4);
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  } else {
    const float2 b = *reinterpret_cast<const float2*>(p + SH + 1);
    x[0] = p[SH]; x[1] = b.x; x[2] = b.y; x[3] = p[SH + 3];
  }
}

// One diagonal's terms for the thread's R x 4 sums: all R rows' reads first,
// then the FMAs (coefficient c[e] for column e).
template <int R, int SH, typename EX>
__device__ __forceinline__ void ring_diag(float (&acc)[R][4], const float (&c)[4],
                                          const EX* xs, int ld) {
  float x[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) ring_quad<SH>(x[r], xs + r * ld);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(c[e], x[r][e], acc[r][e]);
}

// The producer warp's share of stage q: the windows of the item's planes v0
// .. v1 into their slots (by TMA, or by the lanes where a window wraps) and
// the coefficients of plane s into buffer q % 2.
template <int R, typename ED, typename EX>
__device__ __forceinline__ void ring_produce(const RingMaps& maps, const Ring& rg,
                                             const RingItem& a, const EX* X, char* slots,
                                             char* coefs, int s, int v0, int v1, unsigned q,
                                             unsigned long long* bar, int lane) {
  const int span = ring_span(rg.h);
  const int sbytes = static_cast<int>(ring_slot_bytes(R, rg.h, sizeof(EX)));
  unsigned tx = static_cast<unsigned>(sizeof(ED)) * rg.ndiag * kRingCols;
  bool copied = false;
  for (int v = v0; v <= v1; ++v) {
    const long long w0 = ring_window(rg, a, v);
    if (w0 >= 0 && w0 + span <= rg.n) {
      tx += static_cast<unsigned>(sizeof(EX)) * R * span;
      continue;
    }
    EX* dst = reinterpret_cast<EX*>(slots + ((v + rg.M) % rg.slots) * sbytes);
    constexpr int kv = kVec<EX>;  // elements of a 16-byte chunk
    const int qv = span / kv;     // chunks a row: w0 and n are multiples of 8
    for (int e = lane; e < R * qv; e += 32) {
      const int r = e / qv, c = kv * (e - r * qv);
      long long j = w0 + c;
      if (j < 0) j += rg.n;
      if (j >= rg.n) j -= rg.n;
      const bool in = a.r0 + r < rg.k;
      cp_async16(dst + r * span + c, in ? X + (a.r0 + r) * rg.n + j : X, in);
    }
    copied = true;
  }
  if (copied) {
    cp_async_commit();  // wait_group waits only on committed groups
    cp_async_wait<0>();
    fence_proxy_async();  // before later TMA copies into the same bytes
  }
  __syncwarp();
  if (lane == 0) {
    mbar_expect_tx(bar, tx);
    for (int v = v0; v <= v1; ++v) {
      const long long w0 = ring_window(rg, a, v);
      if (w0 >= 0 && w0 + span <= rg.n)
        tma_box3(slots + ((v + rg.M) % rg.slots) * sbytes, &maps.x, 0,
                 static_cast<int>(w0 / rg.g), a.r0, bar);
    }
    const long long c = ring_window(rg, a, s) + rg.h;  // the step's plane's first column
    tma_box3(coefs + (q & 1) * ring_coef_bytes(rg.ndiag, sizeof(ED)), &maps.d, 0,
             static_cast<int>(c / 256), 0, bar);
  }
}

// R rows a work item (8 or 16 on bf16, 4 or 8 on f32); ED: the diagonals'
// element, EX: the field's. Warps 0-7 consume, warp 8 produces.
template <typename ED, typename EX, int R>
__global__ void __launch_bounds__(kRingThreads + 32, 1)
    stencil_ring(const __grid_constant__ RingMaps maps, const Ring rg, const EX* __restrict__ X,
                 EX* __restrict__ Y) {
  extern __shared__ __align__(16) float smem[];  // slots | 2 coefficient buffers
  __shared__ unsigned long long full[2], empty[2];
  const int span = ring_span(rg.h);
  const int sbytes = static_cast<int>(ring_slot_bytes(R, rg.h, sizeof(EX)));
  const int cbytes = static_cast<int>(ring_coef_bytes(rg.ndiag, sizeof(ED)));
  char* slots = reinterpret_cast<char*>(smem) + ((128 - (smem_u32(smem) & 127)) & 127);
  char* coefs = slots + rg.slots * sbytes;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&full[b], 1);
      mbar_init(&empty[b], kRingThreads / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= kRingThreads) {  // the producer warp
    unsigned q = 0;
    for (int it = blockIdx.x; it < rg.items; it += gridDim.x) {
      const RingItem a = ring_item(rg, R, it);
      for (int s = 0; s < a.len; ++s, ++q) {
        if (lane == 0) {
          if (q >= 2) mbar_wait(&empty[q & 1], ((q - 2) >> 1) & 1);  // step q - 2 is done
          if (s == 0 && q >= 1)  // the ring restarts: step q - 1 is done too
            mbar_wait(&empty[(q - 1) & 1], ((q - 1) >> 1) & 1);
        }
        __syncwarp();
        ring_produce<R, ED, EX>(maps, rg, a, X, slots, coefs, s, s == 0 ? -rg.M : s + rg.M,
                                s + rg.M, q, &full[q & 1], lane);
      }
    }
  } else {  // consumers
    const int t = threadIdx.x;
    unsigned q = 0;
    for (int it = blockIdx.x; it < rg.items; it += gridDim.x) {
      const RingItem a = ring_item(rg, R, it);
      for (int s = 0; s < a.len; ++s, ++q) {
        mbar_wait(&full[q & 1], (q >> 1) & 1);  // the stage has landed
        const ED* cf = reinterpret_cast<const ED*>(coefs + (q & 1) * cbytes) + 4 * t;
        const int s0 = s % rg.slots;  // the slot of plane s - M
        float acc[R][4];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
        for (int d = 0; d < rg.ndiag; ++d) {
          const int m = rg.m[d];
          const float4 c4 = load4(cf + d * kRingCols);
          const float c[4] = {c4.x, c4.y, c4.z, c4.w};
          const int p = rg.h + rg.r[d] + 4 * t;  // >= 0: |r| <= h
          int sl = s0 + m + rg.M;  // the slot of plane s + m
          if (sl >= rg.slots) sl -= rg.slots;
          const EX* xs = reinterpret_cast<const EX*>(slots + sl * sbytes) + (p & ~3);
          switch (p & 3) {  // (h + r) mod 4: uniform across the block
            case 0: ring_diag<R, 0>(acc, c, xs, span); break;
            case 1: ring_diag<R, 1>(acc, c, xs, span); break;
            case 2: ring_diag<R, 2>(acc, c, xs, span); break;
            default: ring_diag<R, 3>(acc, c, xs, span); break;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[q & 1]);  // this warp is done with the stage
        const long long col = ring_window(rg, a, s) + rg.h + 4 * t;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (a.r0 + r < rg.k)
            store4(Y + (a.r0 + r) * rg.n + col, make_float4(acc[r][0], acc[r][1], acc[r][2],
                                                            acc[r][3]));
      }
    }
  }
}

// The ring of a launch: each offset's (m, r) for the stride S (|r| <= h,
// |m| <= M), the item count; false where an offset does not decompose, S
// does not divide n into planes of whole patches, or the ring or its boxes
// do not fit their limits. segs: runs of planes a patch's walk is cut into.
inline bool make_ring(Ring* rg, const int* offsets, int ndiag, int k, long long n, long long S,
                      int h, int M, int R, int segs) {
  if (ndiag < 1 || ndiag > kMaxDiags || k < 1 || k > 64 || n < 1 || S < kRingCols ||
      S % kRingCols != 0 || n % S != 0 || n / S < 2 || n >= (1LL << 31) || h < 0 ||
      h % 8 != 0 || 2LL * h >= S || M < 1 || 2 * M + 2 > kRingMaxSlots || segs < 1 ||
      segs > n / S)
    return false;
  rg->n = n;
  rg->S = S;
  rg->ndiag = ndiag;
  rg->k = k;
  rg->h = h;
  rg->M = M;
  rg->slots = 2 * M + 2;
  rg->npl = static_cast<int>(n / S);
  rg->len = (rg->npl + segs - 1) / segs;
  rg->npatch = static_cast<int>(S / kRingCols);
  rg->ngrp = (k + R - 1) / R;
  rg->items = rg->npatch * rg->ngrp * ((rg->npl + rg->len - 1) / rg->len);
  // the boxes' granule: the largest power of two up to 256 dividing h and P
  // (S is a multiple of P), so every window starts on one
  rg->g = kRingBox;
  while (h % rg->g != 0) rg->g /= 2;
  if (rg->g < 8 || ring_span(h) / rg->g > kRingBox) return false;
  for (int d = 0; d < ndiag; ++d) {
    const long long o = offsets[d];
    if (o < 0 || o >= n) return false;
    const long long so = o <= n / 2 ? o : o - n;  // signed, in (-n/2, n/2]
    const long long m = so >= 0 ? (so + S / 2) / S : -((-so + S / 2) / S);
    const long long r = so - m * S;
    if (r < -h || r > h || m < -M || m > M) return false;
    rg->m[d] = static_cast<int>(m);
    rg->r[d] = static_cast<int>(r);
  }
  return true;
}

template <typename ED, typename EX, int R>
cudaError_t launch_ring(const ED* diags, const Ring& rg, const EX* X, EX* Y, int max_blocks,
                        int device, cudaStream_t stream) {
  RingMaps maps{};
  const cuuint64_t xdims[3] = {static_cast<cuuint64_t>(rg.g),
                               static_cast<cuuint64_t>(rg.n / rg.g),
                               static_cast<cuuint64_t>(rg.k)};
  const cuuint64_t xstrides[2] = {sizeof(EX) * rg.g, sizeof(EX) * rg.n};
  const cuuint32_t xbox[3] = {static_cast<cuuint32_t>(rg.g),
                              static_cast<cuuint32_t>(ring_span(rg.h) / rg.g),
                              static_cast<cuuint32_t>(R)};
  const cuuint64_t ddims[3] = {256, static_cast<cuuint64_t>(rg.n / 256),
                               static_cast<cuuint64_t>(rg.ndiag)};
  const cuuint64_t dstrides[2] = {256ULL * sizeof(ED), static_cast<cuuint64_t>(rg.n) * sizeof(ED)};
  const cuuint32_t dbox[3] = {256, kRingCols / 256, static_cast<cuuint32_t>(rg.ndiag)};
  cudaError_t err = encode_tmap(&maps.x,
                                sizeof(EX) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                3, X, xdims, xstrides, xbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = encode_tmap(&maps.d,
                      sizeof(ED) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                      3, diags, ddims, dstrides, dbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  auto kernel = stencil_ring<ED, EX, R>;
  const size_t smem = ring_smem_bytes(R, rg.h, rg.slots, rg.ndiag, sizeof(ED), sizeof(EX));
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(kernel, kRingThreads + 32, smem, device, rg.items, max_blocks, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kRingThreads + 32, smem, stream>>>(maps, rg, X, Y);
  return cudaGetLastError();
}

// R: 8 or 16 rows on a bf16 field, 4 or 8 on an f32 one (the same slot
// bytes).
template <typename ED, typename EX>
int ring_entry(const ED* diags, const int* offsets, int ndiag, const EX* X, EX* Y, int k,
               long long n, long long S, int h, int M, int R, int segs, int max_blocks,
               int device, cudaStream_t stream) {
  constexpr int lo = sizeof(EX) == 2 ? 8 : 4;  // the narrower of the two row tiles
  Ring rg{};
  if (max_blocks < 1 || (R != lo && R != 2 * lo) ||
      !make_ring(&rg, offsets, ndiag, k, n, S, h, M, R, segs) || !aligned16(X) ||
      !aligned16(Y) || !aligned16(diags))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return R == lo ? launch_ring<ED, EX, lo>(diags, rg, X, Y, max_blocks, device, stream)
                 : launch_ring<ED, EX, 2 * lo>(diags, rg, X, Y, max_blocks, device, stream);
}

// ---- bf16 fields with the Gram on the tensor cores (stencil_mma)

constexpr int kStMmaThreads = 512;  // 16 warps
// Floor of a launch's shared floats: room for the warps' sums of any Gram
// width (StMma<W>::kScratch); mirrored by ops/stencil.py MMA_SCRATCH.
constexpr int kStMmaScratch = 9216;
// Diagonals whose shared-memory reads are in flight together before their
// FMAs: at (32, 256^3) 3.63 ms with 3, 3.72 with 2 and 4.06 with 8, where
// the 128 registers of 16 warps spill (H100, tools/torch_kernel_times.py
// --bf16 --variants).
constexpr int kStChunk = 3;
// Far diagonals whose X a stencil_mma tile stages in shared memory (the
// rest are read from L2 at their use); mirrored by ops/stencil.py
// MMA_MAX_STAGED.
constexpr int kStMaxStaged = 4;

// How the 16 warps of a stencil_mma block share G (k padded to W = 8, 16,
// 32 or 64 rows, 48 taking 64): G's MT x NT fragments of 16 x 8 in QM x QN
// groups of TM x TN, each group's P warps taking every P-th 16-column step
// of a tile. At W = 32 a warp holds 2 x 2 fragments: 16 f32 and 32 f64
// registers of the 128 that 16 warps leave a thread.
template <int W>
struct StMma {
  static constexpr int MT = (W + 15) / 16, NT = W / 8;
  static constexpr int QM = W >= 64 ? 2 : 1;
  static constexpr int QN = W == 8 ? 1 : W >= 64 ? 4 : 2;
  static constexpr int P = 16 / (QM * QN);
  static constexpr int TM = MT / QM, TN = NT / QN;
  static constexpr int kScratch = P * 16 * MT * 8 * NT;  // floats of the warps' sums
  static_assert(QM * TM == MT && QN * TN == NT && P * QM * QN == 16, "the warps must tile G");
};

// Row stride of stencil_mma's window, in elements: the least L >= T + 2h
// with L = 16 mod 64, so a row is 32 bytes mod 128 past the one before and
// the 4 rows of 4 lanes' 8-byte reads in each half warp touch 128 distinct
// bytes; mirrored by ops/stencil.py mma_window_ld.
__host__ __device__ inline int mma_window_ld(int h, int T) {
  return T + 2 * h + ((16 - T - 2 * h) & 63);
}

// The same for the tile of Y (T columns).
__host__ __device__ inline int mma_tile_ld(int T) { return T + ((16 - T) & 63); }

// Bytes of one stage of a stencil_mma launch, a multiple of 1 KB: nst far
// slabs of k rows in swizzled boxes (mma.cuh), the bf16 window of k rows,
// the coefficient tile of dsize-byte elements.
__host__ __device__ inline int mma_stage_bytes(int k, int ndiag, int nst, int h, int T,
                                               int dsize) {
  const int b = 2 * nst * T * round8(k) + 2 * k * mma_window_ld(h, T) + dsize * ndiag * T;
  return (b + 1023) / 1024 * 1024;
}

// Shared bytes of a stencil_mma launch: two stages, the bf16 tile of Y, at
// least the warps' sums, and 1 KB to align the boxes; mirrored by
// ops/stencil.py mma_smem_bytes.
__host__ __device__ inline long long mma_smem_bytes(int k, int ndiag, int nst, int h, int T,
                                                    int dsize) {
  const long long b = 2LL * mma_stage_bytes(k, ndiag, nst, h, T, dsize) +
                      2LL * k * mma_tile_ld(T);
  return (b > 4LL * kStMmaScratch ? b : 4LL * kStMmaScratch) + 1024;
}

// The two f32 values of a bf16 pair (the element of the lower index in the
// lower 16 bits): exact.
__device__ __forceinline__ float2 unpack_bf16(unsigned w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// Elements v .. v + 3 of a bf16 row in shared memory (8-byte aligned), as
// two words (the lower index in the lower 16 bits): one 8-byte read where v
// = 0 mod 4, two 4-byte reads where v = 2 mod 4, an 8-byte and a 4-byte read
// and two byte permutes where v is odd.
__device__ __forceinline__ uint2 quad_at(const bf16* row, int v) {
  const unsigned* w = reinterpret_cast<const unsigned*>(row);
  switch (v & 3) {
    case 0: return *reinterpret_cast<const uint2*>(row + v);
    case 2: return make_uint2(w[v / 2], w[v / 2 + 1]);
    case 1: {
      const uint2 a = *reinterpret_cast<const uint2*>(row + v - 1);
      const unsigned b = w[(v + 3) / 2];
      return make_uint2(__byte_perm(a.x, a.y, 0x5432), __byte_perm(a.y, b, 0x5432));
    }
    default: {
      const unsigned a = w[(v - 1) / 2];
      const uint2 b = *reinterpret_cast<const uint2*>(row + v + 1);
      return make_uint2(__byte_perm(a, b.x, 0x5432), __byte_perm(b.x, b.y, 0x5432));
    }
  }
}

// a and b rounded to bf16, as one word (a in the lower 16 bits).
__device__ __forceinline__ unsigned bf16_pair(float a, float b) {
  const __nv_bfloat162 w = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&w);
}

// Four coefficients (c = 0 mod 4): four bf16 or four floats.
__device__ __forceinline__ float4 coef_quad(const bf16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = unpack_bf16(q.x), b = unpack_bf16(q.y);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 coef_quad(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// X[r, (i + o) mod n] and X[r, (i + 1 + o) mod n] of an unstaged far
// diagonal from global memory (L2), as one word, 0 for a column past n: one
// 4-byte read where pairs (n even, X 4-byte aligned, o even: the pair never
// straddles n), else two element reads.
__device__ __forceinline__ unsigned far_word(const bf16* __restrict__ Xr, long long n,
                                             long long i, int o, bool pairs) {
  if (i >= n) return 0u;
  long long j = i + o;
  if (j >= n) j -= n;
  if (pairs) return __ldg(reinterpret_cast<const unsigned*>(Xr + j));
  long long j1 = j + 1;
  if (j1 >= n) j1 -= n;
  const unsigned hi = i + 1 < n ? __bfloat16_as_ushort(Xr[j1]) : 0u;
  return __bfloat16_as_ushort(Xr[j]) | (hi << 16);
}

// One stage of stencil_mma's tile at i0: the window sw[r * L + v] = X[r,
// (i0 - h + v) mod n], v < T + 2h; the coefficients sd[d T + c] =
// diags[d, i0 + c] (0 past n); unless the far slabs come by TMA (nst == 0
// here then), each staged far slab f at sf + f 2 T r8 holds X[r, (i0 + c +
// o) mod n] (0 past n) at byte swz(r, c, r8), as a TMA box would put it.
// Warps copy whole rows, 16 bytes a lane (one row's 512 contiguous bytes a
// warp copy), where vec (and, for a far slab, o % 8 == 0: its copies never
// straddle n); else element copies.
template <typename ED>
__device__ __forceinline__ void load_tile_mma(bf16* sw, char* sf, ED* sd, const bf16* X,
                                              const ED* diags, const Diags& dg, int nst,
                                              int ndiag, int k, long long n, long long i0, int h,
                                              int T, int L, bool vec) {
  const int r8 = round8(k);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  const int span = T + 2 * h;
  long long base = (i0 - h) % n;  // the window's first column, in [0, n)
  if (base < 0) base += n;
  for (int r = warp; r < k; r += nw) {
    const bf16* Xr = X + static_cast<long long>(r) * n;
    bf16* w = sw + r * L;
    if (vec) {
      for (int v = 8 * lane; v < span; v += 256) {
        long long j = base + v;
        while (j >= n) j -= n;  // more than once only where the window is wider than n
        cp_async16(w + v, Xr + j, true);
      }
    } else {
      for (int v = lane; v < span; v += 32) {
        long long j = base + v;
        while (j >= n) j -= n;
        cp_elem(w + v, Xr + j, true);
      }
    }
    for (int f = 0; f < nst; ++f) {
      const int o = dg.o[dg.far[f]];
      char* slab = sf + 2 * f * T * r8;
      if (vec && o % 8 == 0) {
        for (int c = 8 * lane; c < T; c += 256) {
          const bool in = i0 + c < n;
          long long j = i0 + c + o;
          if (j >= n) j -= n;
          cp_async16(slab + swz(r, c, r8), in ? Xr + j : X, in);
        }
      } else {
        for (int c = lane; c < T; c += 32) {
          const bool in = i0 + c < n;
          long long j = i0 + c + o;
          if (j >= n) j -= n;
          cp_elem(reinterpret_cast<bf16*>(slab + swz(r, c, r8)), in ? Xr + j : X, in);
        }
      }
    }
  }
  constexpr int kd = kVec<ED>;
  if (vec) {
    const int tq = T / kd;
    for (int e = threadIdx.x; e < ndiag * tq; e += blockDim.x) {
      const int d = e / tq, c = kd * (e - d * tq);
      const bool in = i0 + c < n;
      cp_async16(sd + d * T + c, diags + (in ? d * n + i0 + c : 0), in);
    }
  } else {
    for (int e = threadIdx.x; e < ndiag * T; e += blockDim.x) {
      const int d = e / T, c = e - d * T;
      const bool in = i0 + c < n;
      cp_elem(sd + d * T + c, diags + (in ? d * n + i0 + c : 0), in);
    }
  }
}

// PROBE: bits that switch parts of the kernel off, for timing probes only
// (tools/torch_kernel_times.py --bf16 --variants).
constexpr int kMmaProbeNoFar = 1, kMmaProbeNoGram = 2, kMmaProbeNoStore = 4,
              kMmaProbeNoRefill = 8;

// bf16 X and Y (ED: the diagonals' element) with the Gram G = X Y^T of the
// f32 sums, W the Gram's width, on the tensor cores. A persistent grid of
// 16-warp blocks, one an SM, walks tiles of T columns, double-buffered: each
// tile's window and coefficients are copied into shared memory with
// cp.async, a warp copying whole rows, and the slabs of X its far diagonals
// read (up to kStMaxStaged) come by TMA, one request a box of 64 columns by
// k rows in the 128-byte swizzle (by cp.async into the same layout where a
// box would straddle n). The warps share the tile's 16-column steps and
// G's fragments (StMma): for each of its steps a warp computes the Y rows
// 8 (nt0 + j) + g of the fragments it holds at columns 4t .. 4t + 3 of the
// step for lane (g, t), reading every X quad from shared memory (the window
// at h + s, a far slab, or, past the staged slabs, L2) in 8-byte reads, so
// each sum goes from its FMAs straight into an mma B fragment, split into
// three exact bf16 pieces (split3_pair). The Gram sums over a step's 16
// columns in any order, so the step's column 4t + e stands at the mma's k
// index 2t + e (e < 2) or 2t + 6 + e (e >= 2): lane (g, t) then carries its
// own four columns in its B fragment, and the A fragments of X come from
// the window's centre in the same order, two 8-byte reads an m16 tile. Three
// mma.sync a fragment and step, hi first, into f32 fragments that restart
// every tile and are added to double running sums after it. Y, rounded once to bf16,
// goes to a tile in shared memory and out after the tile, 16 bytes a lane,
// a warp writing one row's 512 contiguous bytes. Each element's sum is the
// fmaf chain over d = 0..ndiag-1 of stencil_spmm, so Y keeps its bits.
//
// Bound: bytes, 2,382 MB at (32, 256^3) (0.711 ms at 3.35 TB/s; the Gram's
// 103 GFLOP in three pieces take 0.10 ms at 989 TFLOP/s). The kernel it
// replaced took the Gram in f32 FMAs (VecGram) behind the tile's SpMM, 4.52
// ms; this one takes 3.63 ms (H100; PERF.md section 6 has the timings and
// probe builds): its SpMM alone takes 1.8 ms, the window's copies (h = 256,
// T = 256: 3.0 reads of X a column) do not overlap it, and wider tiles,
// which would cut that traffic, do not fit beside the staged far slabs. At
// 8 warps with the far diagonals read from L2 in 4-byte pairs (8 rows a
// request) it took 5.5-7.4 ms.
template <typename ED, int W, int PROBE = 0, int CH = kStChunk>
__global__ void __launch_bounds__(kStMmaThreads, 1)
    stencil_mma(const __grid_constant__ CUtensorMap tx, const ED* __restrict__ diags,
                const Diags dgp, int ndiag, const bf16* __restrict__ X, bf16* __restrict__ Y,
                float* __restrict__ part, int k, long long n, int h, int T, bool vec, bool pairs,
                bool yvec, bool tma) {
  using S = StMma<W>;
  extern __shared__ __align__(16) float smem[];  // 2 stages | the tile of Y
  __shared__ Diags dg;  // read with a per-diagonal index: from shared memory
  __shared__ unsigned long long full[2];  // a stage's far slabs have landed (TMA)
  const int nst = PROBE & kMmaProbeNoFar ? 0 : dgp.nst;
  const bool far_tma = tma && nst > 0;
  if (threadIdx.x == 0) {
    dg = dgp;
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
  }
  const int L = mma_window_ld(h, T), Lf = mma_tile_ld(T), r8 = round8(k);
  const int fbytes = 2 * dgp.nst * T * r8, wbytes = 2 * k * L;
  const int sbytes = mma_stage_bytes(k, ndiag, dgp.nst, h, T, sizeof(ED));
  char* base = align1k(smem);  // stage: far slabs | window | coefficients
  bf16* ytile = reinterpret_cast<bf16*>(base + 2 * sbytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int p = warp % S::P, q = warp / S::P;
  const int mt0 = q / S::QN * S::TM, nt0 = q % S::QN * S::TN;
  // The Y rows of this lane (rows past k repeat row k - 1: their products
  // land in entries of G that are dropped, and they are not stored). Where
  // two row groups hold the same Y rows (QM == 2) the first stores them.
  int yr[S::TN];
  bool ys[S::TN];
#pragma unroll
  for (int j = 0; j < S::TN; ++j) {
    const int r = 8 * (nt0 + j) + g;
    yr[j] = min(r, k - 1);
    ys[j] = r < k && q / S::QN == 0;
  }
  double run[S::TM][S::TN][4] = {};
  const long long ntiles = (n + T - 1) / T;
  long long t = blockIdx.x;
  int buf = 0;
  __syncthreads();  // dg, the barriers
  // Stage b takes the tile: its far slabs by TMA (thread 0: one request a
  // box of 64 columns by k rows) where far_tma, else with the rest by
  // cp.async (load_tile_mma).
  const auto load = [&](int b, long long tile) {
    char* st = base + b * sbytes;
    const long long i0 = tile * T;
    if (far_tma && threadIdx.x == 0) {
      mbar_expect_tx(&full[b], 2u * nst * k * T);
      for (int f = 0; f < nst; ++f) {
        long long c = i0 + dg.o[dg.far[f]];
        for (int bb = 0; bb < T / kBoxCols; ++bb, c += kBoxCols) {
          if (c >= n) c -= n;
          tma_box(st + 2 * f * T * r8 + bb * r8 * 128, &tx, static_cast<int>(c), &full[b]);
        }
      }
    }
    load_tile_mma(reinterpret_cast<bf16*>(st + fbytes), st,
                  reinterpret_cast<ED*>(st + fbytes + wbytes), X, diags, dg, far_tma ? 0 : nst,
                  ndiag, k, n, i0, h, T, L, vec);
  };
  if (t < ntiles) load(0, t);
  cp_async_commit();
  for (long long it = 0; t < ntiles; t += gridDim.x, ++it) {
    const long long tn = t + gridDim.x;
    if (tn < ntiles && !(PROBE & kMmaProbeNoRefill && t > blockIdx.x)) load(buf ^ 1, tn);
    cp_async_commit();
    cp_async_wait<1>();
    if (far_tma && !(PROBE & kMmaProbeNoRefill && it >= 2))
      mbar_wait(&full[buf], static_cast<unsigned>(it >> 1) & 1);
    __syncthreads();  // this tile's stage (and the tile of Y is free)
    const char* sf = base + buf * sbytes;
    const bf16* sw = reinterpret_cast<const bf16*>(sf + fbytes);
    const ED* sd = reinterpret_cast<const ED*>(sf + fbytes + wbytes);
    const long long i0 = t * T;
    float acc[S::TM][S::TN][4] = {};
    for (int c0 = 16 * p; c0 < T; c0 += 16 * S::P) {
      const int c = c0 + 4 * tq;  // this lane's columns: c .. c + 3
      const long long i = i0 + c;
      float y[S::TN][4] = {};
      for (int d0 = 0; d0 < ndiag; d0 += CH) {
        // Every read of the chunk, then its FMAs in the order d = d0, d0 + 1, ...
        uint2 xw[CH][S::TN];
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const int d = d0 + u;
          if (d >= ndiag) continue;
          const int s = dg.s[d];
          if (s != kFar) {  // the window at column h + s + c holds X[:, i + s]
#pragma unroll
            for (int j = 0; j < S::TN; ++j) xw[u][j] = quad_at(sw + yr[j] * L, h + s + c);
          } else if (dg.stage[d] >= 0 && !(PROBE & kMmaProbeNoFar)) {
            // a far slab's swizzled boxes at column c hold X[:, i + o]
            const char* slab = sf + 2 * dg.stage[d] * T * r8;
#pragma unroll
            for (int j = 0; j < S::TN; ++j)
              xw[u][j] = *reinterpret_cast<const uint2*>(slab + swz(yr[j], c, r8));
          } else if (PROBE & kMmaProbeNoFar) {
#pragma unroll
            for (int j = 0; j < S::TN; ++j) xw[u][j] = make_uint2(0u, 0u);
          } else {
            const bool fp = pairs && (dg.o[d] & 1) == 0;
#pragma unroll
            for (int j = 0; j < S::TN; ++j) {
              const bf16* Xr = X + static_cast<long long>(yr[j]) * n;
              xw[u][j] = make_uint2(far_word(Xr, n, i, dg.o[d], fp),
                                    far_word(Xr, n, i + 2, dg.o[d], fp));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const int d = d0 + u;
          if (d >= ndiag) continue;
          const float4 cf = coef_quad(sd + d * T + c);
#pragma unroll
          for (int j = 0; j < S::TN; ++j) {
            const float2 xa = unpack_bf16(xw[u][j].x), xb = unpack_bf16(xw[u][j].y);
            y[j][0] = fmaf(cf.x, xa.x, y[j][0]);
            y[j][1] = fmaf(cf.y, xa.y, y[j][1]);
            y[j][2] = fmaf(cf.z, xb.x, y[j][2]);
            y[j][3] = fmaf(cf.w, xb.y, y[j][3]);
          }
        }
      }
      // Columns past n hold 0 (their coefficients were zero-filled; an
      // infinite X must not leak into G).
      const bool in[4] = {i < n, i + 1 < n, i + 2 < n, i + 3 < n};
#pragma unroll
      for (int j = 0; j < S::TN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!in[e]) y[j][e] = 0.f;
      // Y, rounded once to bf16, into the tile of Y.
#pragma unroll
      for (int j = 0; j < S::TN; ++j) {
        if (!ys[j]) continue;
        const __nv_bfloat162 lo = __floats2bfloat162_rn(y[j][0], y[j][1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(y[j][2], y[j][3]);
        *reinterpret_cast<uint2*>(ytile + yr[j] * Lf + c) =
            make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                       *reinterpret_cast<const unsigned*>(&hi));
      }
      if (PROBE & kMmaProbeNoGram) {
#pragma unroll
        for (int j = 0; j < S::TN; ++j) acc[0][j][0] += y[j][0] + y[j][1] + y[j][2] + y[j][3];
        continue;
      }
      // The Gram: X's rows from the window's centre (A: rows g and g + 8 of
      // the m16 tile at this lane's columns), Y's f32 sums in three exact
      // bf16 pieces (B), hi first.
      unsigned a[S::TM][4];
#pragma unroll
      for (int m = 0; m < S::TM; ++m) {
        const uint2 qa = *reinterpret_cast<const uint2*>(
            sw + min(16 * (mt0 + m) + g, k - 1) * L + h + c);
        const uint2 qb = *reinterpret_cast<const uint2*>(
            sw + min(16 * (mt0 + m) + 8 + g, k - 1) * L + h + c);
        a[m][0] = qa.x;
        a[m][1] = qb.x;
        a[m][2] = qa.y;
        a[m][3] = qb.y;
      }
      unsigned b[S::TN][2][3];
#pragma unroll
      for (int j = 0; j < S::TN; ++j) {
        split3_pair(y[j][0], y[j][1], b[j][0]);
        split3_pair(y[j][2], y[j][3], b[j][1]);
      }
      // Piece by piece, every fragment's mma of a piece before the next
      // piece's: TM x TN independent products between two that chain.
#pragma unroll
      for (int piece = 0; piece < 3; ++piece)
#pragma unroll
        for (int j = 0; j < S::TN; ++j)
#pragma unroll
          for (int m = 0; m < S::TM; ++m)
            mma_bf16(acc[m][j], a[m], b[j][0][piece], b[j][1][piece]);
    }
#pragma unroll
    for (int m = 0; m < S::TM; ++m)
#pragma unroll
      for (int j = 0; j < S::TN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[m][j][e] += acc[m][j][e];
    __syncthreads();  // the tile of Y is complete, and every read of this stage done
    // Y out: a warp writes a row's 16-byte chunks.
    if (!(PROBE & kMmaProbeNoStore)) {
      const int chunks = T / 8;
      for (int e = threadIdx.x; e < k * chunks; e += blockDim.x) {
        const int r = e / chunks, c8 = 8 * (e - r * chunks);
        const long long i = i0 + c8;
        if (i >= n) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(ytile + r * Lf + c8);
        bf16* out = Y + static_cast<long long>(r) * n + i;
        if (yvec) {
          *reinterpret_cast<uint4*>(out) = v;
        } else {
          const bf16* w = reinterpret_cast<const bf16*>(&v);
          for (int e2 = 0; e2 < 8 && i + e2 < n; ++e2) out[e2] = w[e2];
        }
      }
    }
    buf ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();
  gram_mma_store<S, false>(run, smem, part + static_cast<long long>(blockIdx.x) * k * k, k, k,
                           mt0, nt0, p);
}

template <typename ED, int W, int PROBE = 0, int CH = kStChunk>
cudaError_t launch_mma(const ED* diags, const Diags& dg, int ndiag, const bf16* X, bf16* Y,
                       float* part, float* G, int k, long long n, int h, int T, int max_blocks,
                       int device, cudaStream_t stream) {
  static_assert(StMma<W>::kScratch <= kStMmaScratch, "the warps' sums must fit the floor");
  auto kernel = stencil_mma<ED, W, PROBE, CH>;
  const size_t smem = mma_smem_bytes(k, ndiag, dg.nst, h, T, sizeof(ED));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(kernel, kStMmaThreads, smem, device, (n + T - 1) / T, max_blocks,
                        &grid);
  if (err != cudaSuccess) return err;
  const bool vec = n % kVec<bf16> == 0 && n % kVec<ED> == 0 && aligned16(X) && aligned16(diags);
  const bool pairs = n % 2 == 0 && (reinterpret_cast<size_t>(X) & 3) == 0;
  const bool yvec = n % kVec<bf16> == 0 && aligned16(Y);
  // The far slabs by TMA where every box is whole: 64-column boxes at
  // offsets of whole boxes never straddle n.
  bool tma = dg.nst > 0 && tma_ok(X, n) && n % kBoxCols == 0;
  for (int f = 0; f < dg.nst; ++f) tma = tma && dg.o[dg.far[f]] % kBoxCols == 0;
  CUtensorMap tx{};
  if (tma) {
    err = make_tmap(&tx, X, n, k);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kStMmaThreads, smem, stream>>>(tx, diags, dg, ndiag, X, Y, part, k, n, h, T,
                                                vec, pairs, yvec, tma);
  launch_reduce(part, G, k, grid, stream);
  return cudaGetLastError();
}

// The Gram's width of a launch of k <= 64 rows (48 rows take 64's split).
inline int mma_gram_width(int k) { return k <= 8 ? 8 : k <= 16 ? 16 : k <= 32 ? 32 : 64; }

template <typename ED>
cudaError_t dispatch_mma(const ED* diags, const Diags& dg, int ndiag, const bf16* X, bf16* Y,
                         float* part, float* G, int k, long long n, int h, int T, int max_blocks,
                         int device, cudaStream_t stream) {
#define BCG_SM(W)                                                                       \
  return launch_mma<ED, W>(diags, dg, ndiag, X, Y, part, G, k, n, h, T, max_blocks, device, \
                           stream)
  switch (mma_gram_width(k)) {
    case 8: BCG_SM(8);
    case 16: BCG_SM(16);
    case 32: BCG_SM(32);
    default: BCG_SM(64);
  }
#undef BCG_SM
}

// ---- f32 fields with the Gram on the tensor cores (stencil_mma_f32)
//
// Rows 2 and 2m (f32 X and Y, f32 or bf16 diagonals) with their Gram, up to
// 32 rows a launch: G = X Y^T of the f32 sums, which are Y. The kernel it
// replaced (stencil_spmm's Gram form, now at 33 to 64 rows) took the SpMM one
// column a thread at one 8-warp block an SM, then, behind a barrier, the
// Gram in f32 FMAs (VecGram) from an f32 tile of Y in shared memory: about
// 0.59 ms at (32, 128^3), 0.24 of it the Gram (H100; PERF.md section 6).
// This one is
// stencil_mma's schedule on an f32 field: 16 warps share each tile's
// 16-column steps and G's fragments (StMma), lane (g, t) of a warp computes
// the Y rows 8 (nt0 + j) + g of its fragments at columns 4t .. 4t + 3 of a
// step (the fmaf chain over d = 0..ndiag-1 of stencil_spmm, so Y keeps its
// bits), stores them from its registers (16 bytes a lane) and splits them
// into three exact bf16 pieces for the mma B fragments (split3_pair), with
// no tile of Y and no barrier between the SpMM and the Gram. X is f32 too,
// so its A fragments (rows 16 m + g and + 8 at the same four columns of the
// window's centre, one 16-byte read each) are split as well; of the nine
// products of the pieces the six whose weight is at least 2^-24 of hi x hi
// are taken (hi hi, hi mid, mid hi, hi lo, lo hi, mid mid): six mma.sync a
// fragment and step, hi x hi into one sum from 0 and the others into a
// second, smallest first, both added to f32 sums that restart every tile and
// go into double running sums after it (a chain of mma.sync sums through a
// tile left stencil_mma_cols's Gram ten times farther from the f64 one).
// Each block writes one (k, k) partial, summed in block order in double: a
// repeated call gives the same bits. A diagonal's window reads take one
// warp-uniform branch on its shift mod 4 (one, two 8-byte or two aligned
// 16-byte reads a row), from row pointers set once a step: with a branch a
// read and the row addresses rematerialised in the loop, the near SpMM alone
// took 216 us at (32, 128^3), 142-152 since.
//
// Memory. The f32 window of k rows (T + 2h columns) and the coefficient tile
// are double-buffered by cp.async, one barrier a tile; at (32, 128^3) T =
// 256 and h = 128 (ops/stencil.py stencil_mma_f32_plan): 0, +-1, +-128 from
// the window, 2 reads of X a column (T = 512 read 1.5 and ran slower). Far
// slabs of f32 columns do not fit beside two such windows, so the far
// diagonals (+-16384) are read from L2, 16 bytes a lane, those of the first
// kStF32Prefetch far diagonals one step ahead (issued as soon as a step has
// its sums, so they are in flight across its stores and Gram; read at their
// use instead, +64-80 us).
//
// Bound: bytes, 567 MB at (32, 128^3) with bf16 diagonals (0.169 ms at 3.35
// TB/s; the Gram's 4.3 GFLOP in six bf16 products a pair take 0.026 ms at
// 989 TFLOP/s). It takes about 0.45 ms there on an H100 (row 2, f32
// diagonals, 0.47; 0.60 and 0.61 before):
// probe builds (tools/torch_kernel_times.py --storage --variants) put the
// near SpMM at about 150 us and add the Gram (+90-125), the far X (+70-80),
// the window's refills (+48-70) and the stores of Y (+18-20) rather than
// overlapping them. Tried and slower: X split once a tile into shared
// memory by the whole block (538 us: a second pass and barrier), the
// window's rows as 1-D bulk copies (557), Y through a shared tile and TMA
// tensor stores (521), the two warps of a step each splitting one m-tile of
// X and swapping the pieces behind a 64-thread barrier (502), the far X
// issued after the Gram (581, at T = 512);
// moving the halo within shared memory between a block's contiguous tiles
// (half the window's reads) gained what the contiguous walk lost (444 against
// 443).

// Far diagonals whose X a step loads one step ahead, into registers;
// mirrored by ops/stencil.py MMA_F32_PREFETCH.
constexpr int kStF32Prefetch = 2;
// Rows of one stencil_mma_f32 launch (StMma<8>, <16> or <32>); 33 to 64
// rows run stencil_vec_gram; mirrored by ops/stencil.py MMA_F32_MAX_K.
constexpr int kStMmaF32MaxK = 32;

// Row stride of stencil_mma_f32's window, in floats: the least L >= T + 2h
// with L = 16 mod 32, so the two rows a quarter warp's 16-byte reads touch
// fall in the two halves of the banks; mirrored by ops/stencil.py
// mma_f32_window_ld.
__host__ __device__ inline int mma_f32_window_ld(int h, int T) {
  return T + 2 * h + ((16 - T - 2 * h) & 31);
}

// Shared bytes of a stencil_mma_f32 launch: two f32 windows of k rows, two
// coefficient tiles of dsize-byte elements, at least the warps' sums;
// mirrored by ops/stencil.py mma_f32_smem_bytes.
__host__ __device__ inline long long mma_f32_smem_bytes(int k, int ndiag, int h, int T,
                                                        int dsize) {
  const long long b = 2LL * (4LL * k * mma_f32_window_ld(h, T) + 1LL * dsize * ndiag * T);
  return b > 4LL * kStMmaScratch ? b : 4LL * kStMmaScratch;
}

// The four f32 elements s .. s + 3 past each row pointer wr[j] (16-byte
// aligned) of the window, s warp-uniform (one branch a diagonal): one
// 16-byte read a row where s = 0 mod 4, two 8-byte reads where s = 2 mod
// 4, two aligned 16-byte reads where s is odd (within the row: |s| <= h,
// and h and the tile's columns are multiples of 4).
template <int TN>
__device__ __forceinline__ void window_quads(float4 (&x)[TN], const float* const (&wr)[TN],
                                             int s) {
  switch (s & 3) {
    case 0:
#pragma unroll
      for (int j = 0; j < TN; ++j) x[j] = *reinterpret_cast<const float4*>(wr[j] + s);
      break;
    case 2:
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float2 a = *reinterpret_cast<const float2*>(wr[j] + s);
        const float2 b = *reinterpret_cast<const float2*>(wr[j] + s + 2);
        x[j] = make_float4(a.x, a.y, b.x, b.y);
      }
      break;
    case 1:
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(wr[j] + s - 1);
        const float4 b = *reinterpret_cast<const float4*>(wr[j] + s + 3);
        x[j] = make_float4(a.y, a.z, a.w, b.x);
      }
      break;
    default:
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(wr[j] + s - 3);
        const float4 b = *reinterpret_cast<const float4*>(wr[j] + s + 1);
        x[j] = make_float4(a.w, b.x, b.y, b.z);
      }
  }
}

// X[r, (i + e + o) mod n], e < 4, of a far diagonal from global memory (L2),
// 0 for a column past n: one 16-byte read where quads (n % 4 == 0, X
// 16-byte aligned, o % 4 == 0: i = 0 mod 4, so the quad never straddles n),
// else element reads (o < n: one wrap at most).
__device__ __forceinline__ float4 far_quad(const float* __restrict__ Xr, long long n,
                                           long long i, int o, bool quads) {
  if (quads) {
    if (i >= n) return make_float4(0.f, 0.f, 0.f, 0.f);
    long long j = i + o;
    if (j >= n) j -= n;
    return __ldg(reinterpret_cast<const float4*>(Xr + j));
  }
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool in = i + e < n;
    long long j = (in ? i + e : 0) + o;
    if (j >= n) j -= n;
    v[e] = in ? __ldg(Xr + j) : 0.f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// One stage of stencil_mma_f32's tile at i0: the window sw[r * L + v] = X[r,
// (i0 - h + v) mod n], v < T + 2h, warps copying whole rows (16 bytes a lane
// where vec, else 4), and the coefficients sd[d T + c] = diags[d, i0 + c] (0
// past n).
template <typename ED>
__device__ __forceinline__ void load_tile_f32(float* sw, ED* sd, const float* X, const ED* diags,
                                              int ndiag, int k, long long n, long long i0, int h,
                                              int T, int L, bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  const int span = T + 2 * h;
  long long base = (i0 - h) % n;  // the window's first column, in [0, n)
  if (base < 0) base += n;
  for (int r = warp; r < k; r += nw) {
    const float* Xr = X + static_cast<long long>(r) * n;
    float* w = sw + r * L;
    for (int v = (vec ? 4 : 1) * lane; v < span; v += (vec ? 4 : 1) * 32) {
      long long j = base + v;
      while (j >= n) j -= n;  // more than once only where the window is wider than n
      if (vec) cp_async16(w + v, Xr + j, true);
      else cp_async4(w + v, Xr + j, true);
    }
  }
  constexpr int kd = kVec<ED>;
  for (int e = threadIdx.x; e < ndiag * (vec ? T / kd : T); e += blockDim.x) {
    const int d = vec ? e / (T / kd) : e / T;
    const int c = vec ? kd * (e - d * (T / kd)) : e - d * T;
    const bool in = i0 + c < n;
    if (vec) cp_async16(sd + d * T + c, diags + (in ? d * n + i0 + c : 0), in);
    else cp_elem(sd + d * T + c, diags + (in ? d * n + i0 + c : 0), in);
  }
}

// PROBE: bits that switch parts of stencil_mma_f32 off, for timing probes
// only (tools/torch_kernel_times.py --storage --variants); kF32ProbeAtUse:
// the far diagonals read at their use, not a step ahead; kF32ProbeDirect:
// each step's products straight into the double sums, without the tile's
// f32 sums.
constexpr int kF32ProbeNoFar = 1, kF32ProbeNoGram = 2, kF32ProbeNoStore = 4,
              kF32ProbeNoRefill = 8, kF32ProbeAtUse = 16, kF32ProbeDirect = 32;

// ED: the diagonals' element; W: the Gram's width (StMma<W>).
template <typename ED, int W, int PROBE = 0>
__global__ void __launch_bounds__(kStMmaThreads, 1)
    stencil_mma_f32(const ED* __restrict__ diags, const __grid_constant__ Diags dg, int ndiag,
                    const float* __restrict__ X, float* __restrict__ Y,
                    float* __restrict__ part, int k, long long n, int h, int T, bool vec,
                    bool quads, bool yvec) {
  using S = StMma<W>;
  constexpr int FP = PROBE & (kF32ProbeNoFar | kF32ProbeAtUse) ? 0 : kStF32Prefetch;
  constexpr bool tile_sums = !(PROBE & kF32ProbeDirect);
  extern __shared__ __align__(16) float smem[];  // 2 windows | 2 coefficient tiles
  const int L = mma_f32_window_ld(h, T);
  ED* sd0 = reinterpret_cast<ED*>(smem + 2 * k * L);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int p = warp % S::P, q = warp / S::P;
  const int mt0 = q / S::QN * S::TM, nt0 = q % S::QN * S::TN;
  // The Y rows of this lane (rows past k repeat row k - 1: their products
  // land in entries of G that are dropped, and they are not stored). Where
  // two row groups hold the same Y rows (QM == 2) the first stores them.
  int yr[S::TN];
  bool ys[S::TN];
#pragma unroll
  for (int j = 0; j < S::TN; ++j) {
    const int r = 8 * (nt0 + j) + g;
    yr[j] = min(r, k - 1);
    ys[j] = r < k && q / S::QN == 0;
  }
  // X's rows 16 (mt0 + m) + g and + 8 (the A fragments), as offsets in a window.
  int ar[S::TM][2];
#pragma unroll
  for (int m = 0; m < S::TM; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) ar[m][hh] = min(16 * (mt0 + m) + 8 * hh + g, k - 1) * L + h;
  const int nfp = min(dg.nst, FP);  // far diagonals loaded a step ahead
  double run[S::TM][S::TN][4] = {};
  const long long ntiles = (n + T - 1) / T;
  long long t = blockIdx.x;
  int buf = 0;
  // This lane's X quads of the first nfp far diagonals at the step of
  // column c0 of tile `tile` (into fx).
  float4 fx[FP > 0 ? FP : 1][S::TN];
  const auto prefetch = [&](long long tile, int c0) {
#pragma unroll
    for (int f = 0; f < FP; ++f) {
      if (f >= nfp) break;
      const int o = dg.o[dg.far[f]];
#pragma unroll
      for (int j = 0; j < S::TN; ++j)
        fx[f][j] = far_quad(X + static_cast<long long>(yr[j]) * n, n, tile * T + c0 + 4 * tq,
                            o, quads && o % 4 == 0);
    }
  };
  if (t < ntiles) {
    load_tile_f32(smem, sd0, X, diags, ndiag, k, n, t * T, h, T, L, vec);
    if (16 * p < T) prefetch(t, 16 * p);
  }
  cp_async_commit();
  for (long long it = 0; t < ntiles; t += gridDim.x, ++it) {
    cp_async_wait<0>();
    __syncthreads();  // this tile's stage; every read of the other stage is done
    const float* sw = smem + buf * k * L;
    const long long tn = t + gridDim.x;
    if (tn < ntiles && !(PROBE & kF32ProbeNoRefill && it >= 1))
      load_tile_f32(smem + (buf ^ 1) * k * L, sd0 + (buf ^ 1) * ndiag * T, X, diags, ndiag, k,
                    n, tn * T, h, T, L, vec);
    cp_async_commit();
    const ED* sd = sd0 + buf * ndiag * T;
    const long long i0 = t * T;
    float acc[tile_sums ? S::TM : 1][tile_sums ? S::TN : 1][4] = {};
    for (int c0 = 16 * p; c0 < T; c0 += 16 * S::P) {
      const int c = c0 + 4 * tq;  // this lane's columns: c .. c + 3
      const long long i = i0 + c;
      const float* wr[S::TN];  // this lane's window rows at column h + c: X[yr, i]
#pragma unroll
      for (int j = 0; j < S::TN; ++j) wr[j] = sw + yr[j] * L + h + c;
      float y[S::TN][4] = {};
      // Each element's fmaf chain in the order d = 0..ndiag-1.
      for (int d = 0; d < ndiag; ++d) {
        const int s = dg.s[d];
        float4 x[S::TN];
        if (s != kFar) {  // the window at column h + s + c holds X[:, i + s]
          window_quads(x, wr, s);
        } else if (PROBE & kF32ProbeNoFar) {
#pragma unroll
          for (int j = 0; j < S::TN; ++j) x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          const int f = dg.stage[d];
          if (FP > 0 && f == 0) {
#pragma unroll
            for (int j = 0; j < S::TN; ++j) x[j] = fx[0][j];
          } else if (FP > 1 && f == 1) {
#pragma unroll
            for (int j = 0; j < S::TN; ++j) x[j] = fx[FP > 1 ? 1 : 0][j];
          } else {
            const int o = dg.o[d];
#pragma unroll
            for (int j = 0; j < S::TN; ++j)
              x[j] = far_quad(X + static_cast<long long>(yr[j]) * n, n, i, o,
                              quads && o % 4 == 0);
          }
        }
        const float4 cf = coef_quad(sd + d * T + c);
#pragma unroll
        for (int j = 0; j < S::TN; ++j) {
          y[j][0] = fmaf(cf.x, x[j].x, y[j][0]);
          y[j][1] = fmaf(cf.y, x[j].y, y[j][1]);
          y[j][2] = fmaf(cf.z, x[j].z, y[j][2]);
          y[j][3] = fmaf(cf.w, x[j].w, y[j][3]);
        }
      }
      // The far quads of this warp's next step (the next tile's first one
      // after its last), in flight across this step's stores and Gram.
      if (FP > 0) {
        const int nc0 = c0 + 16 * S::P;
        if (nc0 < T) prefetch(t, nc0);
        else if (tn < ntiles && 16 * p < T) prefetch(tn, 16 * p);
      }
      // Columns past n hold 0 (their coefficients were zero-filled; an
      // infinite X must not leak into G).
#pragma unroll
      for (int j = 0; j < S::TN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i + e >= n) y[j][e] = 0.f;
      // Y from the registers: 16 bytes a lane, 64 contiguous bytes a row
      // and quarter warp.
      if (!(PROBE & kF32ProbeNoStore)) {
#pragma unroll
        for (int j = 0; j < S::TN; ++j) {
          if (!ys[j]) continue;
          float* out = Y + static_cast<long long>(yr[j]) * n + i;
          if (yvec && i + 3 < n) {
            *reinterpret_cast<float4*>(out) = make_float4(y[j][0], y[j][1], y[j][2], y[j][3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (i + e < n) out[e] = y[j][e];
          }
        }
      }
      if (PROBE & kF32ProbeNoGram) {
#pragma unroll
        for (int j = 0; j < S::TN; ++j) run[0][j][0] += y[j][0] + y[j][1] + y[j][2] + y[j][3];
        continue;
      }
      // The Gram. B: Y's f32 sums in three exact bf16 pieces; A: X's rows
      // 16 (mt0 + m) + g and + 8 at this lane's columns of the window's
      // centre, in three pieces too (the step's column 4t + e at the mma's k
      // index 2t + e, e < 2, or 2t + 6 + e, e >= 2, as stencil_mma).
      unsigned b[S::TN][2][3];
#pragma unroll
      for (int j = 0; j < S::TN; ++j) {
        split3_pair(y[j][0], y[j][1], b[j][0]);
        split3_pair(y[j][2], y[j][3], b[j][1]);
      }
#pragma unroll
      for (int m = 0; m < S::TM; ++m) {
        const float4 qa = *reinterpret_cast<const float4*>(sw + ar[m][0] + c);
        const float4 qb = *reinterpret_cast<const float4*>(sw + ar[m][1] + c);
        unsigned w0[3], w1[3], w2[3], w3[3];
        split3_pair(qa.x, qa.y, w0);
        split3_pair(qb.x, qb.y, w1);
        split3_pair(qa.z, qa.w, w2);
        split3_pair(qb.z, qb.w, w3);
        unsigned a[3][4];
#pragma unroll
        for (int piece = 0; piece < 3; ++piece) {
          a[piece][0] = w0[piece];
          a[piece][1] = w1[piece];
          a[piece][2] = w2[piece];
          a[piece][3] = w3[piece];
        }
#pragma unroll
        for (int j = 0; j < S::TN; ++j) {
          float hi[4] = {}, rest[4] = {};
          mma_bf16(hi, a[0], b[j][0][0], b[j][1][0]);
          mma_bf16(rest, a[1], b[j][0][1], b[j][1][1]);  // mid x mid
          mma_bf16(rest, a[2], b[j][0][0], b[j][1][0]);  // lo x hi
          mma_bf16(rest, a[0], b[j][0][2], b[j][1][2]);  // hi x lo
          mma_bf16(rest, a[1], b[j][0][0], b[j][1][0]);  // mid x hi
          mma_bf16(rest, a[0], b[j][0][1], b[j][1][1]);  // hi x mid
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (tile_sums) acc[m][j][e] += hi[e] + rest[e];
            else run[m][j][e] += hi[e] + rest[e];
          }
        }
      }
    }
    if constexpr (tile_sums) {
#pragma unroll
      for (int m = 0; m < S::TM; ++m)
#pragma unroll
        for (int j = 0; j < S::TN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) run[m][j][e] += acc[m][j][e];
    }
    buf ^= 1;
  }
  cp_async_wait<0>();
  __syncthreads();
  gram_mma_store<S, false>(run, smem, part + static_cast<long long>(blockIdx.x) * k * k, k, k,
                           mt0, nt0, p);
}

template <typename ED, int W, int PROBE = 0>
cudaError_t launch_mma_f32(const ED* diags, const Diags& dg, int ndiag, const float* X,
                           float* Y, float* part, float* G, int k, long long n, int h, int T,
                           int max_blocks, int device, cudaStream_t stream) {
  static_assert(StMma<W>::kScratch <= kStMmaScratch, "the warps' sums must fit the floor");
  auto kernel = stencil_mma_f32<ED, W, PROBE>;
  const size_t smem = mma_f32_smem_bytes(k, ndiag, h, T, sizeof(ED));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(kernel, kStMmaThreads, smem, device, (n + T - 1) / T, max_blocks,
                        &grid);
  if (err != cudaSuccess) return err;
  const bool vec = n % 4 == 0 && n % kVec<ED> == 0 && aligned16(X) && aligned16(diags);
  const bool quads = n % 4 == 0 && aligned16(X);
  const bool yvec = n % 4 == 0 && aligned16(Y);
  kernel<<<grid, kStMmaThreads, smem, stream>>>(diags, dg, ndiag, X, Y, part, k, n, h, T, vec,
                                                quads, yvec);
  launch_reduce(part, G, k, grid, stream);
  return cudaGetLastError();
}

template <typename ED>
cudaError_t dispatch_mma_f32(const ED* diags, const Diags& dg, int ndiag, const float* X,
                             float* Y, float* part, float* G, int k, long long n, int h, int T,
                             int max_blocks, int device, cudaStream_t stream) {
#define BCG_SF(W)                                                                           \
  return launch_mma_f32<ED, W>(diags, dg, ndiag, X, Y, part, G, k, n, h, T, max_blocks, device, \
                               stream)
  switch (mma_gram_width(k)) {
    case 8: BCG_SF(8);
    case 16: BCG_SF(16);
    default: BCG_SF(32);
  }
#undef BCG_SF
}

// ---- a bf16 field's Gram above one launch's 64 rows (stencil_mma_cols)
//
// The solvers' Gram of a (kg, n) bf16 field, G = X Y_f32^T with kg > 64,
// is cut into column blocks: the launch of Y's rows r0 .. r0 + k (k <= 64,
// ops/stencil.py) computes those rows of Y and G[a0:a1, r0:r0+k] = X[a0:a1]
// Y_f32[r0:r0+k]^T for the Gram's rows a0 .. a1 (all kg of them up to 128
// rows beside chunks of 41 to 64), so every entry of G comes from exactly
// one launch and no f32 copy of X or of the sums is ever written to device
// memory. The launch's window, coefficient tiles and far slabs are
// stencil_mma's (load_tile_mma, TMA); beside them each tile copies,
// single-buffered by cp.async, the centre columns of the Gram's other rows
// (those past the launch's own, whose centre the window already holds),
// issued as the tile starts, so they land while its SpMM runs.
//
// A tile runs in two phases split by a barrier. The SpMM: 16 warps take
// units (8 rows, 16 columns), two at a time, lane (g, t) the fmaf chain over
// d = 0..ndiag-1 of stencil_spmm for row 8 u + g at four columns, so Y keeps
// its bits; the f32 sums go to a tile in shared memory. The Gram: warp w
// owns a column tile of 8 rows of Y and up to kStColsFw m-tiles of 16 rows
// of X of the (a1 - a0, k) block over all of the tile's columns, so its
// running sums are its own and need no reduction inside the block, and it
// splits each step's B operand, the f32 sums in three exact bf16 pieces
// (split3_pair), once for all of its m-tiles; A comes from X at the tile's
// centre (the window for the launch's own rows, else the centre copy). With
// stencil_mma's column permutation every read is 8 or 16 bytes and
// conflict-free. Y goes out, rounded once, between the two phases. Three
// mma.sync a fragment and step, hi first, into f32 sums that restart every
// tile and are added to double running sums after it.
//
// Bound: bytes, at (96, 128^3) with two launches 835 MB (0.249 ms at 3.35
// TB/s; the Gram's 116 GFLOP in three pieces 0.12 ms at 989 TFLOP/s). The
// route it replaced wrote the f32 sums to a (k, n) scratch beside Y, lifted
// X to f32 and took the cross blocks from gram.cu: 3.81 ms there (H100).

// G's fragments of 16 x 8 a warp holds: m-tiles of one column tile. A
// launch of k rows takes a Gram of up to 16 kStColsFw (16 / ceil(k / 8))
// rows: 128 beside 41 to 64, 256 beside 32. It is built for 3 (FW) and 4
// m-tiles a warp; at 4 a step takes them two at a time (MH), which keeps
// the kernel within its 128 registers.
constexpr int kStColsFw = 4;
// Diagonals whose shared-memory reads are in flight together in the SpMM.
constexpr int kStColsChunk = 2;

// Row stride of the f32 tile of Y's sums: the least L >= T with L = 16 mod
// 32 floats, so the two rows of a quarter warp's 16-byte reads fall in the
// two halves of the banks.
__host__ __device__ inline int mma_sums_ld(int T) { return T + ((16 - T) & 31); }

// Shared bytes of a stencil_mma_cols launch of k rows whose Gram takes
// `others` rows of X besides them: two stages of stencil_mma's far slabs,
// window and coefficients (laid out by kind, so only the far slabs' swizzled
// boxes need the 1 KB alignment: the stages are not rounded), the f32 sums,
// the centre copy of the others, and 1 KB to align the boxes; mirrored by
// ops/stencil.py mma_cols_smem_bytes.
__host__ __device__ inline long long mma_cols_smem_bytes(int k, int ndiag, int nst, int h,
                                                         int T, int others, int dsize) {
  return 2LL * (2LL * nst * T * round8(k) + 2LL * k * mma_window_ld(h, T) +
                1LL * dsize * ndiag * T) +
         4LL * k * mma_sums_ld(T) + 2LL * others * mma_tile_ld(T) + 1024;
}

// PROBE: bits that switch parts of stencil_mma_cols off, for timing probes
// only (tools/torch_kernel_times.py --bf16 --variants).
// (kColsProbeChain: one chain of mma.sync sums through a tile's steps.)
constexpr int kColsProbeNoGram = 1, kColsProbeNoCentre = 2, kColsProbeNoSpmm = 4,
              kColsProbeNoRefill = 8, kColsProbeNoCentreWait = 16, kColsProbeChain = 32;

// X: the launch's k rows; Xa: the Gram's ga rows, of which X's are rows own
// .. own + k - 1 (own >= 0), or none (own = -1); Y: the launch's rows of Y,
// or null (another launch stores them); part: (gridDim.x, ga, k).
// FW: m-tiles a warp holds (3 or 4, kStColsFw), MH of them at a time.
template <typename ED, int FW, int PROBE = 0>
__global__ void __launch_bounds__(kStMmaThreads, 1)
    stencil_mma_cols(const __grid_constant__ CUtensorMap tx, const ED* __restrict__ diags,
                     const Diags dgp, int ndiag, const bf16* __restrict__ X,
                     const bf16* __restrict__ Xa, bf16* __restrict__ Y,
                     float* __restrict__ part, int k, int ga, int own, long long n, int h, int T,
                     bool vec, bool pairs, bool yvec, bool tma) {
  // 2 stages' far slabs | 2 windows | 2 coefficient tiles | the f32 sums | the centre copy
  extern __shared__ __align__(16) float smem[];
  __shared__ Diags dg;
  __shared__ unsigned long long full[2];  // a stage's far slabs have landed (TMA)
  constexpr int MH = FW == 4 ? 2 : FW;
  const int nst = dgp.nst;
  const bool far_tma = tma && nst > 0;
  if (threadIdx.x == 0) {
    dg = dgp;
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
  }
  const int L = mma_window_ld(h, T), Lc = mma_tile_ld(T), Ly = mma_sums_ld(T), r8 = round8(k);
  const int fbytes = 2 * nst * T * r8, wbytes = 2 * k * L, dbytes = sizeof(ED) * ndiag * T;
  char* base = align1k(smem);
  char* sfar = base;                  // stage b's far slabs at sfar + b fbytes
  char* swin = base + 2 * fbytes;     // its window at swin + b wbytes
  char* scoef = swin + 2 * wbytes;    // its coefficients at scoef + b dbytes
  float* ys = reinterpret_cast<float*>(scoef + 2 * dbytes);
  bf16* xc = reinterpret_cast<bf16*>(ys + k * Ly);
  const int others = ga - (own >= 0 ? k : 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = kStMmaThreads / 32;
  const int g = lane / 4, tq = lane % 4;
  const int RG = (k + 7) / 8, units = RG * (T / 16);
  // The Gram's share of this warp: column tile nt, m-tiles mg TM .. mg TM +
  // tm - 1 of the MT (MG groups of TM, RG MG <= 16 warps).
  const int MT = (ga + 15) / 16, MG = nw / RG, TM = (MT + MG - 1) / MG;
  const int nt = warp % RG, mg = warp / RG;
  const int tm = warp < MG * RG ? max(0, min(TM, MT - mg * TM)) : 0;
  // X's row 16 (mg TM + m) + g + 8 hh of Xa at the centre of stage b: the
  // window for X's own rows, else the centre copy.
  const auto arow = [&](int m, int hh, int b) -> const bf16* {
    const int a = min(16 * (mg * TM + m) + g + 8 * hh, ga - 1);
    if (own >= 0 && a >= own && a < own + k)
      return reinterpret_cast<const bf16*>(swin + b * wbytes) + (a - own) * L + h;
    return xc + (own >= 0 && a >= own + k ? a - k : a) * Lc;
  };
  double run[FW][4] = {};
  const long long ntiles = (n + T - 1) / T;
  long long t = blockIdx.x;
  int buf = 0;
  __syncthreads();  // dg, the barriers
  const auto load = [&](int b, long long tile) {  // as stencil_mma's
    char* st = sfar + b * fbytes;
    const long long i0 = tile * T;
    if (far_tma && threadIdx.x == 0) {
      mbar_expect_tx(&full[b], 2u * nst * k * T);
      for (int f = 0; f < nst; ++f) {
        long long c = i0 + dg.o[dg.far[f]];
        for (int bb = 0; bb < T / kBoxCols; ++bb, c += kBoxCols) {
          if (c >= n) c -= n;
          tma_box(st + 2 * f * T * r8 + bb * r8 * 128, &tx, static_cast<int>(c), &full[b]);
        }
      }
    }
    load_tile_mma(reinterpret_cast<bf16*>(swin + b * wbytes), st,
                  reinterpret_cast<ED*>(scoef + b * dbytes), X, diags, dg, far_tma ? 0 : nst,
                  ndiag, k, n, i0, h, T, L, vec);
  };
  // The centre copy: xc[j Lc + c] = Xa[a, i0 + c] (0 past n) for the j-th
  // row a of Xa that is not one of X's.
  const auto load_centre = [&](long long i0) {
    const int per = vec ? T / 8 : T;
    for (int e = threadIdx.x; e < others * per; e += kStMmaThreads) {
      const int j = e / per, c = (vec ? 8 : 1) * (e - j * per);
      const int a = own >= 0 && j >= own ? j + k : j;
      const bool in = i0 + c < n;
      const bf16* src = in ? Xa + static_cast<long long>(a) * n + i0 + c : Xa;
      if (vec) cp_async16(xc + j * Lc + c, src, in);
      else cp_elem(xc + j * Lc + c, src, in);
    }
  };
  if (t < ntiles) load(0, t);
  cp_async_commit();
  for (long long it = 0; t < ntiles; t += gridDim.x, ++it) {
    const long long i0 = t * T;
    const bool refill = !(PROBE & kColsProbeNoRefill && it >= 2);
    // The last Gram that read the centre copy is done (the loop's last barrier).
    if (!(PROBE & kColsProbeNoCentre) && refill) load_centre(i0);
    cp_async_commit();
    const long long tn = t + gridDim.x;
    if (tn < ntiles && !(PROBE & kColsProbeNoRefill && t > blockIdx.x)) load(buf ^ 1, tn);
    cp_async_commit();
    cp_async_wait<2>();  // this tile's stage; the centre copy and the next stage may fly on
    if (far_tma && !(PROBE & kColsProbeNoRefill && it >= 2))
      mbar_wait(&full[buf], static_cast<unsigned>(it >> 1) & 1);
    __syncthreads();
    const char* sf = sfar + buf * fbytes;
    const bf16* sw = reinterpret_cast<const bf16*>(swin + buf * wbytes);
    const ED* sd = reinterpret_cast<const ED*>(scoef + buf * dbytes);
    // The SpMM: unit u is rows 8 (u % RG) .. + 7 at the 16-column step u /
    // RG (rows past k repeat row k - 1 and are not kept).
    for (int u = warp; u < (PROBE & kColsProbeNoSpmm ? 0 : units); u += nw) {
      const int r = 8 * (u % RG) + g, row = min(r, k - 1);
      const int c = 16 * (u / RG) + 4 * tq;  // this lane's columns: c .. c + 3
      const long long i = i0 + c;
      float y[4] = {};
      for (int d0 = 0; d0 < ndiag; d0 += kStColsChunk) {
        // Every read of the chunk, then its FMAs in the order d = d0, d0 + 1, ...
        uint2 xw[kStColsChunk];
        int sv[kStColsChunk], stv[kStColsChunk];  // the chunk's shifts and slabs, read first
#pragma unroll
        for (int v = 0; v < kStColsChunk; ++v) {
          const int d = min(d0 + v, ndiag - 1);
          sv[v] = dg.s[d];
          stv[v] = dg.stage[d];
        }
#pragma unroll
        for (int v = 0; v < kStColsChunk; ++v) {
          const int d = d0 + v;
          if (d >= ndiag) continue;
          if (sv[v] != kFar) {  // the window at column h + s + c holds X[:, i + s]
            xw[v] = quad_at(sw + row * L, h + sv[v] + c);
          } else if (stv[v] >= 0) {  // a far slab's boxes at column c hold X[:, i + o]
            xw[v] = *reinterpret_cast<const uint2*>(sf + 2 * stv[v] * T * r8 + swz(row, c, r8));
          } else {
            const bool fp = pairs && (dg.o[d] & 1) == 0;
            const bf16* Xr = X + static_cast<long long>(row) * n;
            xw[v] = make_uint2(far_word(Xr, n, i, dg.o[d], fp),
                               far_word(Xr, n, i + 2, dg.o[d], fp));
          }
        }
#pragma unroll
        for (int v = 0; v < kStColsChunk; ++v) {
          const int d = d0 + v;
          if (d >= ndiag) continue;
          const float4 cf = coef_quad(sd + d * T + c);
          const float2 xa = unpack_bf16(xw[v].x), xb = unpack_bf16(xw[v].y);
          y[0] = fmaf(cf.x, xa.x, y[0]);
          y[1] = fmaf(cf.y, xa.y, y[1]);
          y[2] = fmaf(cf.z, xb.x, y[2]);
          y[3] = fmaf(cf.w, xb.y, y[3]);
        }
      }
      // Columns past n hold 0 (an infinite X there must not leak into G).
      if (r < k)
        *reinterpret_cast<float4*>(ys + r * Ly + c) =
            make_float4(i < n ? y[0] : 0.f, i + 1 < n ? y[1] : 0.f, i + 2 < n ? y[2] : 0.f,
                        i + 3 < n ? y[3] : 0.f);
    }
    if (!(PROBE & kColsProbeNoCentreWait))
      cp_async_wait<1>();  // the centre copy, not the next stage
    __syncthreads();  // the sums, and every thread's share of the centre copy
    // Y out, rounded once: 8 columns (16 bytes) a thread.
    if (Y != nullptr) {
      const int chunks = T / 8;
      for (int e = threadIdx.x; e < k * chunks; e += kStMmaThreads) {
        const int r = e / chunks, c8 = 8 * (e - r * chunks);
        const long long i = i0 + c8;
        if (i >= n) continue;
        const float4 lo = *reinterpret_cast<const float4*>(ys + r * Ly + c8);
        const float4 hi = *reinterpret_cast<const float4*>(ys + r * Ly + c8 + 4);
        const uint4 v = make_uint4(bf16_pair(lo.x, lo.y), bf16_pair(lo.z, lo.w),
                                   bf16_pair(hi.x, hi.y), bf16_pair(hi.z, hi.w));
        bf16* out = Y + static_cast<long long>(r) * n + i;
        if (yvec) {
          *reinterpret_cast<uint4*>(out) = v;
        } else {
          const bf16* w = reinterpret_cast<const bf16*>(&v);
          for (int e2 = 0; e2 < 8 && i + e2 < n; ++e2) out[e2] = w[e2];
        }
      }
    }
    // The Gram: warp w < MG RG takes the column tile nt = w % RG of the
    // block and its m-tiles mt = (w / RG) TM + i, i < tm, over all of the
    // tile's 16-column steps: Y's sums at row 8 nt + g split once a step,
    // X's rows 16 mt + g and + 8 for each m-tile (rows past ga repeat row ga
    // - 1: their entries are dropped).
    if (tm > 0 && !(PROBE & kColsProbeNoGram)) {
      const float* br = ys + min(8 * nt + g, k - 1) * Ly;
      const bf16* sb = reinterpret_cast<const bf16*>(base);
      int ao[FW][2];  // X's rows, as offsets from the base
#pragma unroll
      for (int m = 0; m < FW; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          ao[m][hh] = static_cast<int>(arow(min(m, tm - 1), hh, buf) - sb);
      float acc[FW][4] = {};  // the tile's f32 sums, added to run after it
      for (int c0 = 0; c0 < T; c0 += 16) {
        const int c = c0 + 4 * tq;
        const float4 yv = *reinterpret_cast<const float4*>(br + c);
        unsigned b0[3], b1[3];
        split3_pair(yv.x, yv.y, b0);
        split3_pair(yv.z, yv.w, b1);
        // The m-tiles MH at a time (registers), piece by piece: every
        // m-tile's mma of a piece before the next piece's (independent
        // products between two that chain).
#pragma unroll
        for (int m0 = 0; m0 < FW; m0 += MH) {
          unsigned af[MH][4];
#pragma unroll
          for (int m = 0; m < MH; ++m) {
            const uint2 qa = *reinterpret_cast<const uint2*>(sb + ao[m0 + m][0] + c);
            const uint2 qb = *reinterpret_cast<const uint2*>(sb + ao[m0 + m][1] + c);
            af[m][0] = qa.x;
            af[m][1] = qb.x;
            af[m][2] = qa.y;
            af[m][3] = qb.y;
          }
          if constexpr (PROBE & kColsProbeChain) {
#pragma unroll
            for (int piece = 0; piece < 3; ++piece)
#pragma unroll
              for (int m = 0; m < MH; ++m)
                if (m0 + m < tm) mma_bf16(acc[m0 + m], af[m], b0[piece], b1[piece]);
          } else {
            // Each step's hi products and the others' in two sums from 0,
            // added to the tile's sums in f32 (rounded to nearest):
            // mma.sync's f32 sums lose more than rounding to nearest, and a
            // chain through the tile's steps (kColsProbeChain) left G ten
            // times farther from its contract at (96, 128^3).
            float hi[MH][4] = {}, rest[MH][4] = {};
#pragma unroll
            for (int m = 0; m < MH; ++m)
              if (m0 + m < tm) mma_bf16(hi[m], af[m], b0[0], b1[0]);
#pragma unroll
            for (int piece = 1; piece < 3; ++piece)
#pragma unroll
              for (int m = 0; m < MH; ++m)
                if (m0 + m < tm) mma_bf16(rest[m], af[m], b0[piece], b1[piece]);
#pragma unroll
            for (int m = 0; m < MH; ++m)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[m0 + m][e] += hi[m][e] + rest[m][e];
          }
        }
      }
#pragma unroll
      for (int m = 0; m < FW; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) run[m][e] += acc[m][e];
    }
    __syncthreads();  // every read of this stage, of the sums and of the centre copy is done
    buf ^= 1;
  }
  cp_async_wait<0>();
  // The block's partial: each entry of G is one lane's running sum.
  float* mine = part + static_cast<long long>(blockIdx.x) * ga * k;
#pragma unroll
  for (int m = 0; m < FW; ++m) {
    if (m >= tm) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * (mg * TM + m) + g + 8 * (e >> 1), s = 8 * nt + 2 * tq + (e & 1);
      if (r < ga && s < k) mine[r * k + s] = static_cast<float>(run[m][e]);
    }
  }
}

template <typename ED, int FW, int PROBE = 0>
cudaError_t launch_mma_cols(const ED* diags, const Diags& dg, int ndiag, const bf16* X,
                            const bf16* Xa, bf16* Y, float* part, float* G, int k, int ga,
                            int own, long long n, int h, int T, int max_blocks, int device,
                            cudaStream_t stream) {
  auto kernel = stencil_mma_cols<ED, FW, PROBE>;
  const int others = ga - (own >= 0 ? k : 0);
  const size_t smem = mma_cols_smem_bytes(k, ndiag, dg.nst, h, T, others, sizeof(ED));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(kernel, kStMmaThreads, smem, device, (n + T - 1) / T, max_blocks,
                        &grid);
  if (err != cudaSuccess) return err;
  const bool vec = n % kVec<bf16> == 0 && n % kVec<ED> == 0 && aligned16(X) && aligned16(Xa) &&
                   aligned16(diags);
  const bool pairs = n % 2 == 0 && (reinterpret_cast<size_t>(X) & 3) == 0;
  const bool yvec = n % kVec<bf16> == 0 && aligned16(Y);
  bool tma = dg.nst > 0 && tma_ok(X, n) && n % kBoxCols == 0;
  for (int f = 0; f < dg.nst; ++f) tma = tma && dg.o[dg.far[f]] % kBoxCols == 0;
  CUtensorMap tx{};
  if (tma) {
    err = make_tmap(&tx, X, n, k);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kStMmaThreads, smem, stream>>>(tx, diags, dg, ndiag, X, Xa, Y, part, k, ga, own,
                                                n, h, T, vec, pairs, yvec, tma);
  launch_reduce(part, G, ga, k, grid, stream);
  return cudaGetLastError();
}

// The launch's diagonals: offsets (each in [0, n)), near shifts within h,
// and stencil_mma's staged far slabs (the first kStMaxStaged far
// diagonals); false on an offset out of range.
inline bool make_diags(Diags* dg, const int* offsets, int ndiag, long long n, int h) {
  dg->nst = 0;
  for (int d = 0; d < ndiag; ++d) {
    const int o = offsets[d];
    if (o < 0 || o >= n) return false;
    dg->o[d] = o;
    dg->s[d] = o <= h ? o : (n - o <= h ? static_cast<int>(o - n) : kFar);
    dg->stage[d] = -1;
    if (dg->s[d] == kFar && dg->nst < kStMaxStaged) {
      dg->stage[d] = dg->nst;
      dg->far[dg->nst++] = d;
    }
  }
  return true;
}

template <typename ED, typename EX>
int stencil_entry(const ED* diags, const int* offsets, int ndiag, const EX* X, EX* Y,
                  float* part, float* G, int k, long long n, int h, int T, int max_blocks,
                  int device, cudaStream_t stream) {
  if (ndiag < 1 || ndiag > kMaxDiags || max_blocks < 1 || n < 1 || h < 0 ||
      h % kVec<EX> != 0 || T < 128 || T % 128 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Diags dg{};
  if (!make_diags(&dg, offsets, ndiag, n, h)) return cudaErrorInvalidValue;
  if (G != nullptr) {  // the Gram: on the tensor cores, k <= 64 rows a launch
    if (k > 64) return cudaErrorInvalidValue;
    if constexpr (std::is_same_v<EX, bf16>)
      return dispatch_mma(diags, dg, ndiag, X, Y, part, G, k, n, h, T, max_blocks, device,
                          stream);
    else if (k > kStMmaF32MaxK)  // an f32 field's 33 to 64 rows: bcg_stencil_vec_gram
      return cudaErrorInvalidValue;
    else
      return dispatch_mma_f32(diags, dg, ndiag, X, Y, part, G, k, n, h, T, max_blocks, device,
                              stream);
  }
#define BCG_STENCIL(KM) \
  return launch<ED, EX, KM>(diags, dg, ndiag, X, Y, k, n, h, T, max_blocks, device, stream)
  switch (kmax_for(k)) {
    case 8: BCG_STENCIL(8);
    case 16: BCG_STENCIL(16);
    case 32: BCG_STENCIL(32);
    case 64: BCG_STENCIL(64);
    default: return cudaErrorInvalidValue;
  }
#undef BCG_STENCIL
}

template <typename ED>
int vec_gram_entry(const ED* diags, const int* offsets, int ndiag, const float* X, float* Y,
                   double* part, float* G, int k, long long n, int h, int T, int max_blocks,
                   int device, cudaStream_t stream) {
  if (ndiag < 1 || ndiag > kMaxDiags || max_blocks < 1 || n < 1 || h < 0 || h % 4 != 0 ||
      T < 128 || T % 128 != 0 || k <= kStMmaF32MaxK || k > 64 || part == nullptr ||
      G == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Diags dg{};
  if (!make_diags(&dg, offsets, ndiag, n, h)) return cudaErrorInvalidValue;
  return launch_vec_gram(diags, dg, ndiag, X, Y, part, G, k, n, h, T, max_blocks, device,
                         stream);
}

template <typename ED>
int stencil_cols_entry(const ED* diags, const int* offsets, int ndiag, const bf16* X,
                       const bf16* Xa, bf16* Y, float* part, float* G, int k, int ga, int own,
                       long long n, int h, int T, int max_blocks, int device,
                       cudaStream_t stream) {
  if (ndiag < 1 || ndiag > kMaxDiags || max_blocks < 1 || n < 1 || h < 0 || h % 8 != 0 ||
      T < 128 || T % 128 != 0 || k < 1 || k > 64 || ga < 1 || own < -1 ||
      (own >= 0 && own + k > ga) || (ga + 15) / 16 > kStColsFw * (16 / ((k + 7) / 8)) ||
      part == nullptr || G == nullptr)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Diags dg{};
  if (!make_diags(&dg, offsets, ndiag, n, h)) return cudaErrorInvalidValue;
  // m-tiles a warp: ceil(MT / MG), MG = 16 / ceil(k / 8) warps a column tile.
  const int mg = 16 / ((k + 7) / 8), tm = ((ga + 15) / 16 + mg - 1) / mg;
  if (tm <= 3)
    return launch_mma_cols<ED, 3>(diags, dg, ndiag, X, Xa, Y, part, G, k, ga, own, n, h, T,
                                  max_blocks, device, stream);
  return launch_mma_cols<ED, 4>(diags, dg, ndiag, X, Xa, Y, part, G, k, ga, own, n, h, T,
                                max_blocks, device, stream);
}

}  // namespace

// offsets: host array of ndiag offsets, each already reduced to [0, n); a
// diagonal is near when o <= h or n - o <= h. h (a multiple of 4; of 8 on a
// bf16 field) and T (a multiple of 128) come from ops/stencil.py
// stencil_plan. G == nullptr selects the plain SpMM; otherwise the Gram
// (h and T from stencil_mma_plan on a bf16 field, k <= 64; from
// stencil_mma_f32_plan on an f32 one, k <= 32), part holds (max_blocks, k,
// k) and the launch uses at most max_blocks blocks.
extern "C" int bcg_stencil_spmm(const float* diags, const int* offsets, int ndiag,
                                const float* X, float* Y, float* part, float* G, int k,
                                long long n, int h, int T, int max_blocks, int device,
                                cudaStream_t stream) {
  return stencil_entry(diags, offsets, ndiag, X, Y, part, G, k, n, h, T, max_blocks, device,
                       stream);
}

// The same on bf16 diagonals, X and Y; G is f32, of the unrounded sums.
extern "C" int bcg_stencil_spmm_bf16(const bf16* diags, const int* offsets, int ndiag,
                                     const bf16* X, bf16* Y, float* part, float* G, int k,
                                     long long n, int h, int T, int max_blocks, int device,
                                     cudaStream_t stream) {
  return stencil_entry(diags, offsets, ndiag, X, Y, part, G, k, n, h, T, max_blocks, device,
                       stream);
}

// bf16 diagonals with f32 X and Y.
extern "C" int bcg_stencil_spmm_bf16d(const bf16* diags, const int* offsets, int ndiag,
                                      const float* X, float* Y, float* part, float* G, int k,
                                      long long n, int h, int T, int max_blocks, int device,
                                      cudaStream_t stream) {
  return stencil_entry(diags, offsets, ndiag, X, Y, part, G, k, n, h, T, max_blocks, device,
                       stream);
}

// f32 diagonals with bf16 X and Y; G is f32, of the unrounded sums.
extern "C" int bcg_stencil_spmm_bf16x(const float* diags, const int* offsets, int ndiag,
                                      const bf16* X, bf16* Y, float* part, float* G, int k,
                                      long long n, int h, int T, int max_blocks, int device,
                                      cudaStream_t stream) {
  return stencil_entry(diags, offsets, ndiag, X, Y, part, G, k, n, h, T, max_blocks, device,
                       stream);
}

// An f32 field's SpMM with its Gram at 33 <= k <= 64 rows (stencil_vec_gram):
// offsets as above, h (a multiple of 4) and T from ops/stencil.py
// stencil_vec_gram_plan; part holds (max_blocks, k, k) doubles.
extern "C" int bcg_stencil_vec_gram(const float* diags, const int* offsets, int ndiag,
                                    const float* X, float* Y, double* part, float* G, int k,
                                    long long n, int h, int T, int max_blocks, int device,
                                    cudaStream_t stream) {
  return vec_gram_entry(diags, offsets, ndiag, X, Y, part, G, k, n, h, T, max_blocks, device,
                        stream);
}

// The same on bf16 diagonals.
extern "C" int bcg_stencil_vec_gram_bf16d(const bf16* diags, const int* offsets, int ndiag,
                                          const float* X, float* Y, double* part, float* G,
                                          int k, long long n, int h, int T, int max_blocks,
                                          int device, cudaStream_t stream) {
  return vec_gram_entry(diags, offsets, ndiag, X, Y, part, G, k, n, h, T, max_blocks, device,
                        stream);
}

// A bf16 field without the Gram on the ring of planes (stencil_ring): Y's k
// <= 64 rows from X's; offsets as above, S, h, M, R (8 or 16 rows a work
// item) and segs (runs a patch's planes are cut into) from ops/stencil.py
// stencil_ring_plan; X, Y and the diagonals 16-byte aligned. bf16 diagonals.
extern "C" int bcg_stencil_ring_bf16(const bf16* diags, const int* offsets, int ndiag,
                                     const bf16* X, bf16* Y, int k, long long n, long long S,
                                     int h, int M, int R, int segs, int max_blocks, int device,
                                     cudaStream_t stream) {
  return ring_entry(diags, offsets, ndiag, X, Y, k, n, S, h, M, R, segs, max_blocks, device,
                    stream);
}

// The same with f32 diagonals.
extern "C" int bcg_stencil_ring_bf16x(const float* diags, const int* offsets, int ndiag,
                                      const bf16* X, bf16* Y, int k, long long n, long long S,
                                      int h, int M, int R, int segs, int max_blocks, int device,
                                      cudaStream_t stream) {
  return ring_entry(diags, offsets, ndiag, X, Y, k, n, S, h, M, R, segs, max_blocks, device,
                    stream);
}

// An f32 field (X and Y) on bf16 diagonals (row 1m): R is 4 or 8 rows.
extern "C" int bcg_stencil_ring_bf16d(const bf16* diags, const int* offsets, int ndiag,
                                      const float* X, float* Y, int k, long long n, long long S,
                                      int h, int M, int R, int segs, int max_blocks, int device,
                                      cudaStream_t stream) {
  return ring_entry(diags, offsets, ndiag, X, Y, k, n, S, h, M, R, segs, max_blocks, device,
                    stream);
}

// The same on f32 diagonals (row 1).
extern "C" int bcg_stencil_ring(const float* diags, const int* offsets, int ndiag,
                                const float* X, float* Y, int k, long long n, long long S, int h,
                                int M, int R, int segs, int max_blocks, int device,
                                cudaStream_t stream) {
  return ring_entry(diags, offsets, ndiag, X, Y, k, n, S, h, M, R, segs, max_blocks, device,
                    stream);
}

// A bf16 field's Gram above one launch (stencil_mma_cols): Y's k <= 64 rows
// at X (null Y: not stored) and G (ga x k) = Xa Y_f32^T, where Xa holds the
// Gram's ga rows (X's among them from row own, or own = -1) and part
// (max_blocks, ga, k); h, T from ops/stencil.py stencil_mma_plan with the
// Gram's rows. bf16 diagonals.
extern "C" int bcg_stencil_mma_cols_bf16(const bf16* diags, const int* offsets, int ndiag,
                                         const bf16* X, const bf16* Xa, bf16* Y, float* part,
                                         float* G, int k, int ga, int own, long long n, int h,
                                         int T, int max_blocks, int device,
                                         cudaStream_t stream) {
  return stencil_cols_entry(diags, offsets, ndiag, X, Xa, Y, part, G, k, ga, own, n, h, T,
                            max_blocks, device, stream);
}

// The same with f32 diagonals.
extern "C" int bcg_stencil_mma_cols_bf16x(const float* diags, const int* offsets, int ndiag,
                                          const bf16* X, const bf16* Xa, bf16* Y, float* part,
                                          float* G, int k, int ga, int own, long long n, int h,
                                          int T, int max_blocks, int device,
                                          cudaStream_t stream) {
  return stencil_cols_entry(diags, offsets, ndiag, X, Xa, Y, part, G, k, ga, own, n, h, T,
                            max_blocks, device, stream);
}
