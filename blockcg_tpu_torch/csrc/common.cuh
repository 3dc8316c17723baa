// Pieces shared by the kernels of blockcg_tpu_torch: launch geometry,
// column loads, the k x k coefficient apply, the per-block Gram tile and the
// deterministic second-stage reduction of the Gram partials.
//
// Layout: every field is lanes-major (k, n) float32, row r of column i at
// F[r * n + i], so the threads of a warp (neighbouring columns i) read
// neighbouring addresses. One thread owns one column of a 128-column tile and
// keeps its k <= KMAX values in registers; a block walks its tiles with a
// grid-stride loop. KMAX is the compile-time register width (8, 16, 32 or
// 64); rows k..KMAX-1 are held at zero so the unrolled loops need no guards.
//
// Wider fields (more than 64 rows) run as row-chunked launches, which the
// Python wrappers issue: output rows r0:r1 of Y = M B (+ A) need only rows
// r0:r1 of M and all of B, so a launch writes k <= 64 output rows and
// contracts over kin >= k input rows (kin == k on a narrow field, where the
// arithmetic is what it was before the split).
//
// Everything here has internal linkage: each .cu includes this header, is
// compiled to its own object, and the objects are linked into one library.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per block == columns per tile

// Row stride of a staged (KMAX, kThreads) tile in shared memory. The +1 pad
// puts rows r and r + 1 of one column in neighbouring banks, so the Gram
// tile's row-strided reads are free of bank conflicts.
constexpr int kLd = kThreads + 1;

inline int kmax_for(int k) {
  if (k < 1) return 0;
  if (k <= 8) return 8;
  if (k <= 16) return 16;
  if (k <= 32) return 32;
  if (k <= 64) return 64;
  return 0;
}

// v[r] = F[r, i] for r < k on a valid column, else 0.
template <int KMAX>
__device__ __forceinline__ void load_col(float (&v)[KMAX], const float* F,
                                         int k, long long n, long long i,
                                         bool valid) {
#pragma unroll
  for (int r = 0; r < KMAX; ++r) v[r] = (valid && r < k) ? F[r * n + i] : 0.f;
}

template <int KMAX>
__device__ __forceinline__ void store_col(float* F, const float (&v)[KMAX],
                                          int k, long long n, long long i,
                                          bool valid) {
  if (!valid) return;
#pragma unroll
  for (int r = 0; r < KMAX; ++r)
    if (r < k) F[r * n + i] = v[r];
}

// Columns of a staged coefficient: kin, and at least KMAX (a narrow launch
// keeps its zero-padded KMAX x KMAX table).
template <int KMAX>
__host__ __device__ inline int coeff_cols(int kin) {
  return kin > KMAX ? kin : KMAX;
}

// Stage the k x kin row-major coefficient block M (row stride kin) into
// shared memory TRANSPOSED and zero-padded to coeff_cols x KMAX:
// sT[c * KMAX + r] = M[r, c]. Every thread reads the same sT entry at the
// same time (a broadcast), and the r-contiguous layout lets the compiler
// fetch four coefficients per load.
template <int KMAX>
__device__ void stage_coeff(float* sT, const float* M, int k, int kin) {
  const int cols = kin > KMAX ? kin : KMAX;
  for (int e = threadIdx.x; e < cols * KMAX; e += blockDim.x) {
    const int c = e / KMAX, r = e % KMAX;
    sT[e] = (r < k && c < kin) ? M[r * kin + c] : 0.f;
  }
}

// y += M F[:, i], with M staged by stage_coeff: the loop runs over the kin
// real columns of M and reads F's column straight from global memory (no
// register copy, and a small unroll keeps the code short at KMAX = 64).
template <int KMAX>
__device__ __forceinline__ void apply_coeff(float (&y)[KMAX], const float* sT,
                                            const float* F, int kin, long long n,
                                            long long i, bool valid) {
  if (!valid) return;
#pragma unroll 4
  for (int c = 0; c < kin; ++c) {
    const float fc = F[c * n + i];
    const float* m = sT + c * KMAX;
#pragma unroll
    for (int r = 0; r < KMAX; ++r) y[r] = fmaf(m[r], fc, y[r]);
  }
}

// Write the thread's column into a staged (KMAX, kLd) tile.
template <int KMAX>
__device__ __forceinline__ void stage_col(float* s, const float (&v)[KMAX]) {
#pragma unroll
  for (int r = 0; r < KMAX; ++r) s[r * kLd + threadIdx.x] = v[r];
}

// The block's share of G = X Y^T. Thread t owns a kTR x kTS register tile of
// the KMAX x KMAX Gram and, for every staged 128-column tile, adds the
// products over those columns. Partials stay in registers across the
// grid-stride loop and are written once per block by store().
template <int KMAX>
struct GramTile {
  static constexpr int kPer =
      KMAX * KMAX >= kThreads ? KMAX * KMAX / kThreads : 1;
  static constexpr int kTS = kPer < 4 ? kPer : 4;
  static constexpr int kTR = kPer / kTS;
  static constexpr int kColTiles = KMAX / kTS;
  static constexpr int kActive = (KMAX / kTR) * kColTiles;  // <= kThreads

  float acc[kTR][kTS];
  int r0, s0;

  __device__ GramTile()
      : r0((static_cast<int>(threadIdx.x) / kColTiles) * kTR),
        s0((static_cast<int>(threadIdx.x) % kColTiles) * kTS) {
#pragma unroll
    for (int a = 0; a < kTR; ++a)
#pragma unroll
      for (int b = 0; b < kTS; ++b) acc[a][b] = 0.f;
  }

  // xs, ys: staged (KMAX, kLd) tiles; call between two __syncthreads().
  __device__ __forceinline__ void accumulate(const float* xs, const float* ys) {
    if (threadIdx.x >= kActive) return;
#pragma unroll 4
    for (int c = 0; c < kThreads; ++c) {
      float xv[kTR], yv[kTS];
#pragma unroll
      for (int a = 0; a < kTR; ++a) xv[a] = xs[(r0 + a) * kLd + c];
#pragma unroll
      for (int b = 0; b < kTS; ++b) yv[b] = ys[(s0 + b) * kLd + c];
#pragma unroll
      for (int a = 0; a < kTR; ++a)
#pragma unroll
        for (int b = 0; b < kTS; ++b) acc[a][b] = fmaf(xv[a], yv[b], acc[a][b]);
    }
  }

  // part: this block's (rows, cols) slot of the (nblocks, rows, cols)
  // partials.
  __device__ void store(float* part, int rows, int cols) const {
    if (threadIdx.x >= kActive) return;
#pragma unroll
    for (int a = 0; a < kTR; ++a)
#pragma unroll
      for (int b = 0; b < kTS; ++b) {
        const int r = r0 + a, s = s0 + b;
        if (r < rows && s < cols) part[r * cols + s] = acc[a][b];
      }
  }

  __device__ void store(float* part, int k) const { store(part, k, k); }
};

// Second stage: G[e] = base[e] + sum over blocks of part[b, e] (base may be
// null), in block order and in double, so a repeated call gives the same
// bits (no atomics anywhere).
__global__ void reduce_partials(const float* __restrict__ part,
                                const float* __restrict__ base,
                                float* __restrict__ G, int kk, int nblocks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kk) return;
  double s = base ? static_cast<double>(base[e]) : 0.0;
  for (int b = 0; b < nblocks; ++b) s += static_cast<double>(part[static_cast<long long>(b) * kk + e]);
  G[e] = static_cast<float>(s);
}

// G (rows x cols) from the (nblocks, rows, cols) partials.
inline void launch_reduce(const float* part, float* G, int rows, int cols,
                          int nblocks, cudaStream_t stream,
                          const float* base = nullptr) {
  const int kk = rows * cols;
  reduce_partials<<<(kk + 255) / 256, 256, 0, stream>>>(part, base, G, kk, nblocks);
}

inline void launch_reduce(const float* part, float* G, int k, int nblocks,
                          cudaStream_t stream, const float* base = nullptr) {
  launch_reduce(part, G, k, k, nblocks, stream, base);
}

// ---- per-site register tiles of the lattice kernels (const_block_stencil.cu,
// block_stencil.cu). A thread owns one site column of a (m = bs * k, ns)
// field as acc[BS][KI]: BS >= bs spins, KI >= k right-hand sides; entries
// with a >= bs or i >= k stay zero. The field's row map is a pair of runtime
// strides, row(a, i) = a * sa + i * si:
//   merged: (sa, si) = (ks, 1), row a * ks + i, the merged spin-major view
//           (m, ns) with ks = k; a row-chunked launch on RHS j0..j0+k of a
//           field with ks > k right-hand sides per spin gets X and Y offset
//           by j0 rows and keeps ks as the spin stride;
//   else:   (sa, si) = (1, bs), row i * bs + a, the (k, bs, ns) view (= flat
//           (k, bs * ns)).
// One instantiation serves both views. At k = 1 the two maps are the same
// memory, so the two views do the same arithmetic in the same order.

// Element offset of row(a, i) in a field of ns sites: a * a + i * i.
struct RowStrides {
  long long a, i;
};

struct RowMap {
  int sa, si;
  __device__ __forceinline__ int operator()(int a, int i) const { return a * sa + i * si; }
  // Called once per diagonal. The empty asm makes the strides opaque there,
  // so the compiler forms the row addresses per diagonal instead of hoisting
  // all BS * KI of them out of the diagonal loop: hoisted, a KMAX = 64 thread
  // needs about 250 registers, and on an H100 the apply ran 25-45% slower.
  __device__ __forceinline__ RowStrides times(long long ns) const {
    RowStrides r{sa * ns, si * ns};
    asm volatile("" : "+l"(r.a), "+l"(r.i));
    return r;
  }
};

inline RowMap row_map(bool merged, int bs, int ks) {
  return merged ? RowMap{ks, 1} : RowMap{1, bs};
}

template <int BS, int KI>
__device__ __forceinline__ void zero(float (&v)[BS][KI]) {
#pragma unroll
  for (int a = 0; a < BS; ++a)
#pragma unroll
    for (int i = 0; i < KI; ++i) v[a][i] = 0.f;
}

// The thread's column of a staged (KMAX, kLd) Gram tile: v[a][i] in row
// row(a, i), the field's own row order.
template <int BS, int KI>
__device__ __forceinline__ void stage_rows(float* s, const float (&v)[BS][KI],
                                           int bs, int k, RowMap row) {
#pragma unroll
  for (int a = 0; a < BS; ++a)
#pragma unroll
    for (int i = 0; i < KI; ++i)
      if (a < bs && i < k) s[row(a, i) * kLd + threadIdx.x] = v[a][i];
}

// The thread's column of a staged tile: X[:, col] for the m real rows.
__device__ __forceinline__ void stage_x(float* s, const float* __restrict__ X,
                                        int m, long long ns, long long col,
                                        bool valid) {
  for (int r = 0; r < m; ++r) s[r * kLd + threadIdx.x] = valid ? X[r * ns + col] : 0.f;
}

// Rows m..KMAX-1 of both staged tiles stay zero for the whole kernel.
template <int KMAX>
__device__ __forceinline__ void zero_pad_rows(float* xs, float* ys, int m) {
  for (int r = m; r < KMAX; ++r) {
    xs[r * kLd + threadIdx.x] = 0.f;
    ys[r * kLd + threadIdx.x] = 0.f;
  }
}

// ---- asynchronous global -> shared copies (cp.async, sm_80 and later) for
// the streaming kernels (mm_update.cu, stencil.cu). A copy whose predicate
// is false reads nothing and fills its shared bytes with zeros; gmem must
// still be a valid address.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

inline bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// Raise the dynamic shared-memory cap of a kernel that needs more than the
// default 48 KB (a launch above the cap is refused).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
