// Gram G = U V^T of two lanes-major fields, U (ku, n) and V (kv, n), each
// at most 96 rows: the square Gram of a (k, n) pair, or one block of a wider
// Gram, which the Python wrapper tiles into such launches (ops/fused.py
// wide_gram).
//
// Replaces the Pallas kernel blockcg_tpu/ops/fused.py gram (the optional
// `seed` operand is not part of the port's contract: it only stopped XLA
// hoisting timing loops).
//
// Bound: at (32, 2,097,152), U != V, the 537 MB of the two fields (0.160 ms
// at the H100's 3.35 TB/s) against 4.3 GFLOP (0.064 ms at 67 TFLOP/s f32):
// bytes. At (96, 32^4) the 19.3 GFLOP of U V^T (0.289 ms) pass the 805 MB
// (0.240 ms): the FMA pipe; U V^T with U == V is symmetric and needs only
// its upper triangle, 9.8 GFLOP (0.146 ms). The kernel this replaced (one
// thread a column of 128-thread blocks, per-row-conditional scalar loads of
// each column, two barriers a 128-column tile, GramTile's 4x4 register tiles
// fed by scalar shared reads, at most 64 rows a launch) took 0.319 ms at
// (32, 2,097,152) and 1.643 ms at (96, 32^4) as four 48-row launches, each
// field read twice.
//
// Design (f32 fields, bcg_gram): a persistent grid of 256-thread blocks, one
// an SM, walks tiles of T columns (ops/fused.py gram_plan: the widest tile
// whose two stages fit, 128 columns at 96 + 96 rows, 256 at 32 + 32 and at
// 48 + 48). Each tile of the stacked rows [U; V] (U alone when U is V) is
// copied into shared memory with cp.async, double-buffered: the next tile's
// copy is in flight while this one computes. 16-byte copies where
// n % 4 == 0 and both fields are 16-byte aligned, else 4-byte copies on the
// same schedule; columns past n are zero-filled. The Gram comes from
// common.cuh's register tiles fed by float4 shared reads: VecGram for U V^T
// (8x8 tiles, 6x6 at 96 rows, whose 256 threads make one whole copy), and,
// when the wrapper passes the same storage for U and V, SymGram, which takes
// only the tiles on and above the diagonal and mirrors the rest, so G is
// exactly symmetric. Every block writes one (ku, kv) partial and
// launch_reduce sums the partials in block order in double; the grid depends
// on the card and the plan alone, so a repeated call gives the same bits (no
// atomics).
//
// bf16 fields (bcg_gram_bf16, gram_mma): on the tensor cores. A bf16 x bf16
// product is exact in f32, so G is the f32 sum of exact products, as the
// reference's native-bf16 Gram. At (32, 256^3) the 2.15 GB of the two
// fields take 0.641 ms at 3.35 TB/s and the 34.4 GFLOP 0.035 ms at 989
// TFLOP/s, so bytes bind, and f32 FMAs on lifted bf16 (0.51 ms of issue
// alone) would not keep up with them. A ring of `stages` tiles
// (ops/fused.py gram_plan) is filled by TMA tensor copies in 128-byte
// swizzled boxes of 64 columns (mma.cuh TmaRing), each stage completing on
// its mbarrier, so stages - 1 tiles are in flight while one computes and no
// thread spends an instruction on the copies: one TMA request a box of all
// rows, not one a row, as each request costs the SM time of its own
// (PERF.md section 6 has the timings). G is
// tiled into m16n8 fragments (ku padded to 16 rows, kv to 8, by clamping
// the rows ldmatrix reads to the last real one: their products land only
// in entries the store drops); the staged tile, n contiguous, is the
// row-major A operand for U and the column-major B operand for V, so
// ldmatrix feeds mma.sync m16n8k16 without a transpose. Up to 32 rows each
// warp holds every fragment of G over its own 16-column steps of a tile
// (2 x 4 fragments at 32 x 32); at 48-96 rows the warps split G's
// fragments over the tile's columns (mma.cuh MmaGram). Each
// warp's fragments start at zero every tile and are added to a double
// running sum after it, so the f32 chains inside the tensor cores stay a
// few k-steps long (the library's one long chain is what puts it 1.4e-4
// from the f64 Gram). When U is V the fragments below the diagonal are
// skipped and the store mirrors the upper entries, so G is exactly
// symmetric. The warps' sums are added in warp order, the blocks' partials
// by launch_reduce as above: no atomics, the same bits on every call. A
// ragged n (n % 8 != 0) or an unaligned field takes element copies into
// the same stages.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kGrThreads = 256;
// Tiles in shared memory: one in flight while one computes. Three (two in
// flight) ran (32, 128^3) in 237 us against 245, but leave room for only 64
// columns at 96 + 96 rows, which took 1161 us against 814 at 128
// (tools/torch_kernel_times.py --variants, H100).
constexpr int kGrStages = 2;
// Floor of a launch's shared floats: room for every Gram's end-of-kernel
// scratch (VecGram / SymGram kScratch), mirrored by ops/fused.py.
constexpr int kGrScratch = 16384;

// Row stride of a staged tile of T floats: 4 mod 8 words for VecGram's
// float4 reads, 8 mod 32 for SymGram's.
__host__ __device__ inline int gram_ld(int T, bool sym) { return T + (sym ? 8 : 4); }

// Shared bytes of a launch: `stages` tiles of `rows` stacked rows; mirrored
// by ops/fused.py gram_smem_bytes.
__host__ __device__ inline long long gram_smem_bytes(int rows, int T, bool sym, int stages) {
  const long long b = 4LL * stages * rows * gram_ld(T, sym);
  return b > 4LL * kGrScratch ? b : 4LL * kGrScratch;
}

// Copy columns i0 .. i0+T-1 of the stacked rows [U; V] (U alone: rows == ku)
// into s (row stride ld) with cp.async: warp w copies rows w, w + 8, ...,
// each lane 16 bytes (or one element) at a time; columns past n are
// zero-filled.
__device__ __forceinline__ void load_tile(float* s, const float* U, const float* V, int ku,
                                          int rows, long long n, long long i0, int T, int ld,
                                          bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kGrThreads / 32) {
    const float* F = (r < ku ? U + static_cast<long long>(r) * n
                             : V + static_cast<long long>(r - ku) * n) + i0;
    float* d = s + r * ld;
    if (vec) {
      for (int q = 4 * lane; q < T; q += 32 * 4)
        cp_async16(d + q, i0 + q < n ? F + q : U, i0 + q < n);
    } else {
      for (int q = lane; q < T; q += 32) cp_elem(d + q, i0 + q < n ? F + q : U, i0 + q < n);
    }
  }
}

// The register tile's side: VecGram's own (common.cuh) for U V^T; for
// SymGram 8x8 from 64 rows, 4x4 below (as update_gram.cuh).
template <int KMAX, bool SYM>
constexpr int kGrTS = SYM ? (KMAX >= 64 ? 8 : 4) : VecGram<KMAX, kGrThreads>::TS;

// The Gram of a launch: SymGram when U is V, else VecGram, on TS x TS tiles.
template <int KMAX, bool SYM, int TS>
using GramOf =
    std::conditional_t<SYM, SymGram<KMAX, kGrThreads, TS>, VecGram<KMAX, kGrThreads, TS>>;

// TS, MINB (blocks an SM for __launch_bounds__) and ST (tiles in shared
// memory) other than the built ones are for timing probes
// (tools/torch_kernel_times.py --variants).
template <int KMAX, bool SYM, int TS = kGrTS<KMAX, SYM>, int MINB = 1, int ST = kGrStages>
__global__ void __launch_bounds__(kGrThreads, MINB)
    gram_kernel(const float* __restrict__ U, const float* __restrict__ V,
                float* __restrict__ part, int ku, int kv, long long n, int T, bool vec) {
  extern __shared__ __align__(16) float smem[];  // ST tiles of (rows, ld) floats
  float* tiles = smem;
  const int rows = SYM ? ku : ku + kv;
  const int ld = gram_ld(T, SYM);
  const long long stage = static_cast<long long>(rows) * ld;
  GramOf<KMAX, SYM, TS> g;
  const long long ntiles = (n + T - 1) / T;
  for (int s = 0; s < ST - 1; ++s) {  // the first ST - 1 tiles of the walk
    const long long ts = blockIdx.x + static_cast<long long>(s) * gridDim.x;
    if (ts < ntiles) load_tile(tiles + s * stage, U, V, ku, rows, n, ts * T, T, ld, vec);
    cp_async_commit();
  }
  int buf = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    // Refill the buffer the previous tile computed on, ST - 1 tiles ahead.
    const long long tn = t + static_cast<long long>(ST - 1) * gridDim.x;
    if (tn < ntiles)
      load_tile(tiles + (buf + ST - 1) % ST * stage, U, V, ku, rows, n, tn * T, T, ld, vec);
    cp_async_commit();
    cp_async_wait<ST - 1>();  // this tile's copy has landed
    __syncthreads();          // ... for every thread's share of it
    const float* s = tiles + buf * stage;
    if constexpr (SYM) g.accumulate(s, ld, T, ku);
    else g.accumulate(s, ld, s + ku * ld, ld, T, ku, kv);
    __syncthreads();  // every read of this buffer is done before its refill
    buf = (buf + 1) % ST;
  }
  cp_async_wait<0>();
  __syncthreads();
  float* mine = part + static_cast<long long>(blockIdx.x) * ku * kv;
  if constexpr (SYM) g.store(mine, ku, smem);
  else g.store(mine, ku, kv, smem);
}

template <int KMAX, bool SYM, int TS = kGrTS<KMAX, SYM>, int MINB = 1, int ST = kGrStages>
cudaError_t launch(const float* U, const float* V, float* part, float* G, int ku, int kv,
                   long long n, int T, int max_blocks, int device, cudaStream_t stream) {
  static_assert(GramOf<KMAX, SYM, TS>::kScratch <= kGrScratch,
                "the Gram's scratch must fit the shared floor");
  auto kernel = gram_kernel<KMAX, SYM, TS, MINB, ST>;
  const size_t smem = gram_smem_bytes(SYM ? ku : ku + kv, T, SYM, ST);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(kernel, kGrThreads, smem, device, (n + T - 1) / T, max_blocks, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = n % 4 == 0 && aligned16(U) && aligned16(V);
  kernel<<<grid, kGrThreads, smem, stream>>>(U, V, part, ku, kv, n, T, vec);
  launch_reduce(part, G, ku, kv, grid, stream);
  return cudaGetLastError();
}

// The register width of a launch of up to k rows (0 past 96); mirrored by
// ops/fused.py GRAM_WIDTHS.
inline int gram_width(int k) {
  static const int widths[] = {8, 16, 32, 48, 64, 96};
  for (int w : widths)
    if (k <= w) return w;
  return 0;
}

template <bool SYM>
cudaError_t dispatch(const float* U, const float* V, float* part, float* G, int ku, int kv,
                     long long n, int T, int max_blocks, int device, cudaStream_t stream) {
#define BCG_GR(W) return launch<W, SYM>(U, V, part, G, ku, kv, n, T, max_blocks, device, stream)
  switch (gram_width(ku > kv ? ku : kv)) {
    case 8: BCG_GR(8);
    case 16: BCG_GR(16);
    case 32: BCG_GR(32);
    case 48: BCG_GR(48);
    case 64: BCG_GR(64);
    case 96: BCG_GR(96);
    default: return cudaErrorInvalidValue;
  }
#undef BCG_GR
}


// ---- bf16 fields on the tensor cores (bcg_gram_bf16)

// Shared bytes of a launch: `stages` tiles of ku (+ kv) rows of T columns in
// swizzled boxes (mma.cuh), at least the warps' sums, and 1 KB to align the
// boxes; mirrored by ops/fused.py gram_mma_smem_bytes.
__host__ __device__ inline long long gram_mma_smem_bytes(int ku, int kv, bool sym, int T,
                                                         int stages) {
  const long long b = 2LL * stages * T * (round8(ku) + (sym ? 0 : round8(kv)));
  return (b > 4LL * kGrScratch ? b : 4LL * kGrScratch) + 1024;
}

// tu, tv: the fields' tensor maps (vec; unused otherwise).
template <int W, bool SYM>
__global__ void __launch_bounds__(kGrThreads, 1)
    gram_mma(const __grid_constant__ CUtensorMap tu, const __grid_constant__ CUtensorMap tv,
             const bf16* __restrict__ U, const bf16* __restrict__ V, float* __restrict__ part,
             int ku, int kv, long long n, int T, int stages, bool vec) {
  using S = MmaGram<W>;
  extern __shared__ __align__(16) float smem[];  // `stages` tiles of [U; V] (mma.cuh boxes)
  __shared__ unsigned long long full[kRingMaxStages];
  char* base = align1k(smem);
  const int r8u = round8(ku), r8v = SYM ? r8u : round8(kv);
  const int stage = 2 * T * (r8u + (SYM ? 0 : r8v));
  const int warp = threadIdx.x / 32;
  const int p = warp % S::P, q = warp / S::P;
  const int mt0 = q / S::QN * S::TM, nt0 = q % S::QN * S::TN;
  double run[S::TM][S::TN][4] = {};
  const TmaRing ring{full, stages, (n + T - 1) / T};
  const auto load = [&](int s, long long t) {  // stage s takes tile t by TMA
    char* su = base + s * stage;
    tma_post(&full[s], SYM ? ku : ku + kv, T);
    tma_tile(su, &tu, r8u, t * T, T, &full[s]);
    if (!SYM) tma_tile(su + 2 * T * r8u, &tv, r8v, t * T, T, &full[s]);
  };
  ring.init();
  __syncthreads();  // the barriers
  if (vec) ring.prime(load);
  for (long long j = 0, t = blockIdx.x; t < ring.ntiles; ++j, t += gridDim.x) {
    char* su = base + ring.stage(j) * stage;
    if (vec) {
      ring.wait(j);
    } else {  // element copies into the same stage
      elem_tile(su, U, ku, r8u, n, t * T, T);
      if (!SYM) elem_tile(su + 2 * T * r8u, V, kv, r8v, n, t * T, T);
      __syncthreads();
    }
    gram_mma_tile<W, SYM>(run, su, SYM ? su : su + 2 * T * r8u, r8u, r8v, T, ku, kv, mt0, nt0,
                          p);
    __syncthreads();  // every read of this stage is done before its refill
    if (vec) ring.refill(j, load);
  }
  // The warps' sums, through the drained stages.
  gram_mma_store<S, SYM>(run, reinterpret_cast<float*>(base),
                         part + static_cast<long long>(blockIdx.x) * ku * kv, ku, kv, mt0, nt0, p);
}

template <int W, bool SYM>
cudaError_t launch_mma(const bf16* U, const bf16* V, float* part, float* G, int ku, int kv,
                       long long n, int T, int stages, int max_blocks, int device,
                       cudaStream_t stream) {
  static_assert(MmaGram<W>::kScratch <= kGrScratch, "the warps' sums must fit the shared floor");
  auto kernel = gram_mma<W, SYM>;
  const size_t smem = gram_mma_smem_bytes(ku, kv, SYM, T, stages);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(kernel, kGrThreads, smem, device, (n + T - 1) / T, max_blocks, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = tma_ok(U, n) && tma_ok(V, n);
  CUtensorMap tu{}, tv{};
  if (vec) {
    err = make_tmap(&tu, U, n, ku);
    if (err == cudaSuccess) err = make_tmap(&tv, V, n, kv);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kGrThreads, smem, stream>>>(tu, tv, U, V, part, ku, kv, n, T, stages, vec);
  launch_reduce(part, G, ku, kv, grid, stream);
  return cudaGetLastError();
}

template <bool SYM>
cudaError_t dispatch_mma(const bf16* U, const bf16* V, float* part, float* G, int ku, int kv,
                         long long n, int T, int stages, int max_blocks, int device,
                         cudaStream_t stream) {
#define BCG_GM(W) \
  return launch_mma<W, SYM>(U, V, part, G, ku, kv, n, T, stages, max_blocks, device, stream)
  switch (gram_width(ku > kv ? ku : kv)) {
    case 8: BCG_GM(8);
    case 16: BCG_GM(16);
    case 32: BCG_GM(32);
    case 48: BCG_GM(48);
    case 64: BCG_GM(64);
    case 96: BCG_GM(96);
    default: return cudaErrorInvalidValue;
  }
#undef BCG_GM
}

}  // namespace

// G (ku, kv) = U V^T; U and V are (ku, n) and (kv, n) with row stride n. The
// same storage for both (U == V, ku == kv) takes the symmetric Gram. T (a
// multiple of 128, at most 1024) and max_blocks (the rows of part, (max_blocks,
// ku, kv)) come from ops/fused.py gram_plan.
extern "C" int bcg_gram(const float* U, const float* V, float* part, float* G, int ku, int kv,
                        long long n, int T, int max_blocks, int device, cudaStream_t stream) {
  if (max_blocks < 1 || n < 1 || ku < 1 || kv < 1 || T < 128 || T > 1024 || T % 128 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (U == V && ku == kv)
    return dispatch<true>(U, V, part, G, ku, kv, n, T, max_blocks, device, stream);
  return dispatch<false>(U, V, part, G, ku, kv, n, T, max_blocks, device, stream);
}

// The same on bf16 fields on the tensor cores (gram_mma); G is f32. T (a
// multiple of 128, at most 1024), stages (2 to kRingMaxStages) and
// max_blocks come from ops/fused.py gram_plan.
extern "C" int bcg_gram_bf16(const bf16* U, const bf16* V, float* part, float* G, int ku,
                             int kv, long long n, int T, int stages, int max_blocks, int device,
                             cudaStream_t stream) {
  if (max_blocks < 1 || n < 1 || ku < 1 || kv < 1 || T < 128 || T > 1024 || T % 128 != 0 ||
      stages < 2 || stages > kRingMaxStages)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (U == V && ku == kv)
    return dispatch_mma<true>(U, V, part, G, ku, kv, n, T, stages, max_blocks, device, stream);
  return dispatch_mma<false>(U, V, part, G, ku, kv, n, T, stages, max_blocks, device, stream);
}

extern "C" const char* bcg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory one block may opt in to on `device` (the cap that
// allow_smem raises a kernel to), or -1 on a CUDA error.
extern "C" int bcg_max_smem(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}
