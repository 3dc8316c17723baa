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
// apply did (0.44 ms). Its Gram staged X and Y between two barriers and took
// 6 scalar shared loads for 8 FMAs, so the Gram was bound by shared-memory
// issue and serialised behind the tile's loads (1.05 ms with the Gram).
//
// Design. A persistent grid walks column tiles [i0, i0 + T), T = 256 (128 on
// small fields): one column a thread. For each tile a block copies the window
// X[:, i0 - h, i0 + T + h) (taken mod n, so a window that crosses 0 or n
// wraps) and the tile's diags into shared memory with cp.async,
// double-buffered: the next tile's copies are in flight while this tile's
// SpMM and Gram run. Diagonals with a signed offset |s| <= h (the near ones)
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
// Gram. The tile's X is the window's centre; Y goes to shared memory once.
// VecGram (common.cuh) holds a TS x TS register tile of G per thread (8x8 from KMAX = 32,
// 4x4 below), rows rt + S*a and columns st + S*b (S = KMAX / TS), fed by
// float4 shared loads along the columns: 16 loads for 256 FMAs. A 4x4 tile
// (8 loads for 64 FMAs) left the Gram bound by shared-memory wavefronts at
// half the FMA rate. The row strides of Y and (up to KMAX = 32) of the window
// are 4 mod 8 words, so the lanes of a quarter warp read their different
// rows from different bank groups (at KMAX = 64 they share their X row, a
// broadcast). Blocks of 256 threads hold 256 / S^2 copies of the tile, each
// over its own columns, summed in a fixed order at the end; every block
// writes one (k, k) partial, and a second kernel sums the partials in block
// order in double (common.cuh). No atomics: a repeated call gives the same
// bits.
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
// the f32 kernel's; Y is stored rounded to bf16, and the Gram is taken on
// the unrounded f32 sums in sY, against the window's bf16 X read four at a
// time (load4), as the reference's Pallas kernel takes it from its f32
// accumulator.
//
// Mixed pairs (the reference's gate takes bf16 or f32 for the diagonals and
// the field independently): bcg_stencil_spmm_bf16d takes bf16 diagonals with
// f32 X and Y, bcg_stencil_spmm_bf16x f32 diagonals with bf16 X and Y. The
// diagonals' element (ED) and the field's (EX) are separate template
// parameters: the window is staged in EX (h a multiple of kVec<EX>), the
// coefficient tiles in ED, each lifted to f32 at its use, and every sum runs
// in f32 in the order d = 0..ndiag-1, so a pair whose values are exact in
// both types gives the unmixed kernel's bits.
//
// Wide bf16 Gram: where Y is bf16 and the field is wider than one launch,
// the solvers' Gram needs the f32 sums of every row, which the stored Y has
// lost. A launch given S (f32, the launch's rows of a (k, n) scratch) also
// writes its f32 sums there, and the wrapper takes the Gram's cross blocks
// from gram.cu on X lifted to f32 and S (ops/stencil.py).
#include "common.cuh"

namespace {

constexpr int kMaxDiags = 32;
constexpr int kStThreads = 256;
constexpr int kFar = 0x7fffffff;

struct Diags {
  int o[kMaxDiags];  // each in [0, n)
  int s[kMaxDiags];  // signed shift in [-h, h] for a near diagonal, kFar otherwise
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
// plus 4 for floats where VecGram puts two or more rows of X in one quarter
// warp (KMAX <= 32), which makes the stride 4 mod 8 words. A bf16 window
// keeps T + 2h, a multiple of 8: every row's 16-byte copies stay aligned.
__host__ __device__ inline int window_ld(int k, int h, int T, int esize) {
  return T + 2 * h + (esize == 4 && k <= 32 ? 4 : 0);
}

// Shared bytes of one launch: two windows of esize-byte elements, two
// coefficient tiles of dsize-byte ones, and with the Gram the float Y tile,
// at least the Gram's scratch; mirrored by ops/stencil.py smem_bytes.
__host__ __device__ inline long long smem_bytes(int k, int ndiag, int h, int T, bool gram,
                                                int esize, int dsize) {
  const long long W = window_ld(k, h, T, esize), LY = T + 4;
  long long b = 2LL * (esize * k * W + dsize * static_cast<long long>(ndiag) * T) +
                (gram ? 4 * k * LY : 0);
  const long long scratch = 4 * 256LL * (k > 16 ? 64 : 16);  // VecGram::kScratch (common.cuh)
  if (gram && b < scratch) b = scratch;
  return b;
}

// Blocks an SM the kernel is built for: two for the SpMM up to KMAX = 32
// (128 registers a thread), one at KMAX = 64 and with the Gram, whose 8x8
// register tiles want the registers more than a second block (held to 128,
// the Gram variant spilled). ops/stencil.py stencil_plan assumes the same.
template <int KMAX, bool WITH_GRAM>
constexpr int kStBlocksPerSm = !WITH_GRAM && KMAX <= 32 ? 2 : 1;

// ED: the element of the diagonals, EX: of X and Y (float or bf16 each).
// S: null, or the launch's rows of an f32 (k, n) scratch that takes the
// f32 sums (the wide bf16 Gram's).
template <typename ED, typename EX, int KMAX, bool WITH_GRAM>
__global__ void __launch_bounds__(kStThreads, kStBlocksPerSm<KMAX, WITH_GRAM>)
    stencil_spmm(const ED* __restrict__ diags, Diags dg, int ndiag, const EX* __restrict__ X,
                 EX* __restrict__ Y, float* __restrict__ S, float* __restrict__ part, int k,
                 long long n, int h, int T, bool vec) {
  extern __shared__ __align__(16) float smem[];  // 2 windows | 2 coefficient tiles | sY
  const int W = window_ld(k, h, T, sizeof(EX)), LY = T + 4;
  EX* sw0 = reinterpret_cast<EX*>(smem);
  ED* sd0 = reinterpret_cast<ED*>(sw0 + 2 * k * W);
  float* sy = reinterpret_cast<float*>(sd0 + 2 * ndiag * T);
  VecGram<KMAX, kStThreads> g;
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
        if (S != nullptr) {
#pragma unroll
          for (int r = 0; r < KMAX; ++r)
            if (r < k) S[r * n + i] = acc[r];
        }
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
    __syncthreads();  // every read of this buffer and of sY is done
    buf ^= 1;
  }
  cp_async_wait<0>();
  if constexpr (WITH_GRAM) {
    __syncthreads();
    g.store(part + static_cast<long long>(blockIdx.x) * k * k, k, smem);
  }
}

template <typename ED, typename EX, int KMAX, bool WITH_GRAM>
cudaError_t launch(const ED* diags, const Diags& dg, int ndiag, const EX* X, EX* Y, float* S,
                   float* part, float* G, int k, long long n, int h, int T, int max_blocks,
                   int device, cudaStream_t stream) {
  auto kernel = stencil_spmm<ED, EX, KMAX, WITH_GRAM>;
  const size_t smem = smem_bytes(k, ndiag, h, T, WITH_GRAM, sizeof(EX), sizeof(ED));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(kernel, kStThreads, smem, device, (n + T - 1) / T, max_blocks, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = n % kVec<EX> == 0 && n % kVec<ED> == 0 && aligned16(X) && aligned16(diags);
  kernel<<<grid, kStThreads, smem, stream>>>(diags, dg, ndiag, X, Y, S, part, k, n, h, T, vec);
  if (WITH_GRAM) launch_reduce(part, G, k, grid, stream);
  return cudaGetLastError();
}

template <typename ED, typename EX>
int stencil_entry(const ED* diags, const int* offsets, int ndiag, const EX* X, EX* Y, float* S,
                  float* part, float* G, int k, long long n, int h, int T, int max_blocks,
                  int device, cudaStream_t stream) {
  if (ndiag < 1 || ndiag > kMaxDiags || max_blocks < 1 || n < 1 || h < 0 ||
      h % kVec<EX> != 0 || T < 128 || T % 128 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Diags dg{};
  for (int d = 0; d < ndiag; ++d) {
    const int o = offsets[d];
    if (o < 0 || o >= n) return cudaErrorInvalidValue;
    dg.o[d] = o;
    dg.s[d] = o <= h ? o : (n - o <= h ? static_cast<int>(o - n) : kFar);
  }
  const bool gram = G != nullptr;
#define BCG_STENCIL(KM)                                                                        \
  return gram ? launch<ED, EX, KM, true>(diags, dg, ndiag, X, Y, S, part, G, k, n, h, T,        \
                                         max_blocks, device, stream)                           \
              : launch<ED, EX, KM, false>(diags, dg, ndiag, X, Y, S, part, G, k, n, h, T,       \
                                          max_blocks, device, stream)
  switch (kmax_for(k)) {
    case 8: BCG_STENCIL(8);
    case 16: BCG_STENCIL(16);
    case 32: BCG_STENCIL(32);
    case 64: BCG_STENCIL(64);
    default: return cudaErrorInvalidValue;
  }
#undef BCG_STENCIL
}

}  // namespace

// offsets: host array of ndiag offsets, each already reduced to [0, n); a
// diagonal is near when o <= h or n - o <= h. h (a multiple of 4; of 8 on a
// bf16 field) and T (a multiple of 128) come from ops/stencil.py
// stencil_plan. G == nullptr selects the plain SpMM; otherwise part holds
// (max_blocks, k, k) and the launch uses at most max_blocks blocks. S: null,
// or f32 (k, n) rows that also take the f32 sums.
extern "C" int bcg_stencil_spmm(const float* diags, const int* offsets, int ndiag,
                                const float* X, float* Y, float* S, float* part, float* G, int k,
                                long long n, int h, int T, int max_blocks, int device,
                                cudaStream_t stream) {
  return stencil_entry(diags, offsets, ndiag, X, Y, S, part, G, k, n, h, T, max_blocks, device,
                       stream);
}

// The same on bf16 diagonals, X and Y; G is f32, of the unrounded sums.
extern "C" int bcg_stencil_spmm_bf16(const bf16* diags, const int* offsets, int ndiag,
                                     const bf16* X, bf16* Y, float* S, float* part, float* G,
                                     int k, long long n, int h, int T, int max_blocks,
                                     int device, cudaStream_t stream) {
  return stencil_entry(diags, offsets, ndiag, X, Y, S, part, G, k, n, h, T, max_blocks, device,
                       stream);
}

// bf16 diagonals with f32 X and Y.
extern "C" int bcg_stencil_spmm_bf16d(const bf16* diags, const int* offsets, int ndiag,
                                      const float* X, float* Y, float* S, float* part, float* G,
                                      int k, long long n, int h, int T, int max_blocks,
                                      int device, cudaStream_t stream) {
  return stencil_entry(diags, offsets, ndiag, X, Y, S, part, G, k, n, h, T, max_blocks, device,
                       stream);
}

// f32 diagonals with bf16 X and Y; G is f32, of the unrounded sums.
extern "C" int bcg_stencil_spmm_bf16x(const float* diags, const int* offsets, int ndiag,
                                      const bf16* X, bf16* Y, float* S, float* part, float* G,
                                      int k, long long n, int h, int T, int max_blocks,
                                      int device, cudaStream_t stream) {
  return stencil_entry(diags, offsets, ndiag, X, Y, S, part, G, k, n, h, T, max_blocks, device,
                       stream);
}
