// Pieces shared by the kernels of blockcg_tpu_torch: launch geometry,
// column loads, the k x k coefficient apply, the per-block Gram tiles
// (GramTile, and VecGram and SymGram of the streaming kernels), the
// deterministic second-stage reduction of the Gram partials, the cp.async
// pieces of the streaming kernels (stencil.cu, mm_update.cu,
// update_gram.cuh, px_update.cu, xr_update.cu, gram.cu) and the mbarriers of the
// warp-specialised block stencil (block_stencil.cu).
//
// Layout: every field is lanes-major (k, n), row r of column i at
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
// Field elements: float32, or bfloat16 on the kernels that take bf16 fields
// (stencil.cu, gram.cu, mm_update.cu, update_gram.cuh, px_update.cu,
// xr_update.cu, qr_p_update.cu). A bf16 element is converted to f32 where it
// enters registers and every FMA runs in f32; an output is rounded to bf16
// where it is stored (from_f32). The
// k x k coefficients of a bf16 update stay f32 (the reference's f32
// coefficient route, BLOCKCG_NO_BF16_MXU=1), so the kernels and their plain
// versions differ in summation order alone. The bf16 variants of gram.cu
// and mm_update.cu run on the tensor cores instead (mma.cuh): exact bf16
// products summed in f32, mm_update's f32 coefficient as three exact bf16
// pieces.
//
// Everything here has internal linkage: each .cu includes this header, is
// compiled to its own object, and the objects are linked into one library.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

// Elements of E a 16-byte copy carries: 4 floats, 8 bf16.
template <typename E>
constexpr int kVec = 16 / static_cast<int>(sizeof(E));

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename E>
__device__ __forceinline__ E from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v as a field of E holds it: the identity on f32, the f32 of v's bf16
// rounding on bf16.
template <typename E>
__device__ __forceinline__ float rounded(float v) {
  return to_f32(from_f32<E>(v));
}

// Four consecutive elements, as f32: one 16-byte load of floats, one 8-byte
// load of bf16 (p 16- or 8-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<unsigned*>(&lo) = u.x;
  *reinterpret_cast<unsigned*>(&hi) = u.y;
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

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

// v[r] = F[r, i] (lifted to f32) for r < k on a valid column, else 0.
template <int KMAX, typename E>
__device__ __forceinline__ void load_col(float (&v)[KMAX], const E* F,
                                         int k, long long n, long long i,
                                         bool valid) {
#pragma unroll
  for (int r = 0; r < KMAX; ++r) v[r] = (valid && r < k) ? to_f32(F[r * n + i]) : 0.f;
}

// F[r, i] = v[r] (rounded to E) for r < k on a valid column.
template <int KMAX, typename E>
__device__ __forceinline__ void store_col(E* F, const float (&v)[KMAX],
                                          int k, long long n, long long i,
                                          bool valid) {
  if (!valid) return;
#pragma unroll
  for (int r = 0; r < KMAX; ++r)
    if (r < k) F[r * n + i] = from_f32<E>(v[r]);
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
// fetch four coefficients per load. The coefficients stay f32 on bf16
// fields too.
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
template <int KMAX, typename E>
__device__ __forceinline__ void apply_coeff(float (&y)[KMAX], const float* sT,
                                            const E* F, int kin, long long n,
                                            long long i, bool valid) {
  if (!valid) return;
#pragma unroll 4
  for (int c = 0; c < kin; ++c) {
    const float fc = to_f32(F[c * n + i]);
    const float* m = sT + c * KMAX;
#pragma unroll
    for (int r = 0; r < KMAX; ++r) y[r] = fmaf(m[r], fc, y[r]);
  }
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

// The block's share of the symmetric G = Y Y^T: VecGram's interleaved TS x
// TS register tiles (rows rb + S*a, columns cb + S*b, S = KMAX / TS), taken
// only at the S (S + 1) / 2 tile positions with rb <= cb; store() fills the
// lower triangle from the mirror tiles, so G is exactly symmetric (a
// diagonal tile holds both (i, j) and (j, i), the same products in the same
// order). A block holds THREADS / (S (S + 1) / 2) copies, each over its own
// columns. Rows of Y are read one at a time after the TS columns' (TS + 1
// float4s live). With a row stride ly of 8 mod 32 words, the different
// (row, column) float4s of a warp's load fall at most two to a bank group.
template <int KMAX, int THREADS, int TS_>  // TS_: the register tile's side, 4 or 8
struct SymGram {
  static constexpr int TS = TS_;
  static constexpr int S = KMAX / TS;
  static constexpr int kPairs = S * (S + 1) / 2;            // threads a copy
  static constexpr int kGroups = THREADS / kPairs;          // copies a block
  static constexpr int kScratch = kGroups * kPairs * TS * TS;  // floats of store()
  float acc[TS][TS];
  int rb, cb, grp, pair;

  __device__ SymGram() {
    const int t = threadIdx.x;
    grp = t / kPairs;
    pair = t % kPairs;
    int p = pair, r = 0;  // pair -> (rb, cb), row by row over the upper triangle
    while (p >= S - r) {
      p -= S - r;
      ++r;
    }
    rb = r;
    cb = r + p;
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) acc[a][b] = 0.f;
  }

  // ys: a row-major staged tile of float or bf16 with row stride ly (a
  // multiple of 4 elements), ncol columns (a multiple of 4). Rows past k read
  // row k - 1, whose products land only in entries of G that store() drops.
  template <typename E>
  __device__ __forceinline__ void accumulate(const E* ys, int ly, int ncol, int k) {
    if (grp >= kGroups) return;
    for (int c = 4 * grp; c < ncol; c += 4 * kGroups) {
      float4 y[TS];
#pragma unroll
      for (int b = 0; b < TS; ++b) y[b] = load4(ys + min(cb + S * b, k - 1) * ly + c);
#pragma unroll
      for (int a = 0; a < TS; ++a) {
        const float4 x = load4(ys + min(rb + S * a, k - 1) * ly + c);
#pragma unroll
        for (int b = 0; b < TS; ++b) {
          float v = acc[a][b];
          v = fmaf(x.x, y[b].x, v);
          v = fmaf(x.y, y[b].y, v);
          v = fmaf(x.z, y[b].z, v);
          v = fmaf(x.w, y[b].w, v);
          acc[a][b] = v;
        }
      }
    }
  }

  // Sum the block's copies in group order through scratch (kScratch floats
  // of shared memory no thread still reads) and write the (k, k) partial.
  __device__ void store(float* part, int k, float* scratch) const {
    if (grp < kGroups) {
      float* mine = scratch + (grp * kPairs + pair) * TS * TS;
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int b = 0; b < TS; ++b) mine[a * TS + b] = acc[a][b];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < k * k; e += THREADS) {
      int pr = e / k % S, ps = e % k % S, a = e / k / S, b = e % k / S;
      if (pr > ps) {  // a lower entry: its mirror in tile (ps, pr)
        const int t = pr; pr = ps; ps = t;
        const int u = a; a = b; b = u;
      }
      const float* src = scratch + (pr * S - pr * (pr - 1) / 2 + ps - pr) * TS * TS + a * TS + b;
      float v = src[0];
      for (int g = 1; g < kGroups; ++g) v += src[g * kPairs * TS * TS];
      part[e] = v;
    }
  }
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

// The same on partials kept in double (stencil.cu's stencil_vec_gram): G[e]
// = sum over blocks of part[b, e], in block order, rounded once.
__global__ void reduce_partials_f64(const double* __restrict__ part, float* __restrict__ G,
                                    int kk, int nblocks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kk) return;
  double s = 0.0;
  for (int b = 0; b < nblocks; ++b) s += part[static_cast<long long>(b) * kk + e];
  G[e] = static_cast<float>(s);
}

inline void launch_reduce_f64(const double* part, float* G, int kk, int nblocks,
                              cudaStream_t stream) {
  reduce_partials_f64<<<(kk + 255) / 256, 256, 0, stream>>>(part, G, kk, nblocks);
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
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 4 : 0));
}

// One element into shared memory where a 16-byte copy does not fit: a 4-byte
// cp.async for a float; a bf16 (2 bytes, below cp.async's least size) is
// loaded and stored by the thread. !pred stores 0 and reads nothing.
__device__ __forceinline__ void cp_elem(float* smem, const float* gmem, bool pred) {
  cp_async4(smem, gmem, pred);
}
__device__ __forceinline__ void cp_elem(bf16* smem, const bf16* gmem, bool pred) {
  *smem = pred ? *gmem : __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

inline bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// ---- the streaming coefficient updates (mm_update.cu, update_gram.cuh,
// px_update.cu, xr_update.cu). A persistent grid of kUpThreads-thread blocks walks
// kUpTile-column tiles; warp w owns output rows w*R .. w*R+R-1 and lane l
// columns 4l .. 4l+3, so global accesses are 16 bytes a thread and shared
// reads of a staged tile are conflict-free float4s.
constexpr int kUpThreads = 256;  // 8 warps: 8 row groups
constexpr int kUpTile = 128;     // columns a tile: 32 lanes x 4
constexpr int kUpLd = kUpTile + 8;  // row stride of a staged Y tile: 8 mod 32 words (SymGram)
constexpr int kUpStages = 2;  // input stages in shared memory: one in flight while one computes

// R, the output rows of a warp: ceil(k / 8) rounded up to a built width (0
// above 128 rows).
inline int rows_per_warp(int k) {
  static const int widths[] = {1, 2, 4, 6, 8, 12, 16};
  const int r = (k + 7) / 8;
  for (int w : widths)
    if (r <= w) return w;
  return 0;
}

// R consecutive floats of shared memory into registers, in the widest loads
// their alignment allows (rows w*R of a stride-8R table).
template <int R>
__device__ __forceinline__ void load_rows(float (&m)[R], const float* p) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int j = 0; j < R; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      m[j] = v.x; m[j + 1] = v.y; m[j + 2] = v.z; m[j + 3] = v.w;
    }
  } else if constexpr (R % 2 == 0) {
#pragma unroll
    for (int j = 0; j < R; j += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + j);
      m[j] = v.x; m[j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) m[j] = p[j];
  }
}

// v[a][q] = F[r0 + a, i + q], lifted to f32, for the rows below k and the
// columns below n, else 0: 4-element loads, or scalar ones past n and on
// unaligned fields (a thread's rows of a tile, loaded ahead of use).
template <typename E, int R>
__device__ __forceinline__ void load_rows4(float (&v)[R][4], const E* F, int r0, int k,
                                           long long n, long long i, bool vec) {
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int r = r0 + a;
    const long long at = r * n + i;
    if (r >= k) {
      v[a][0] = v[a][1] = v[a][2] = v[a][3] = 0.f;
    } else if (vec && i + 3 < n) {
      const float4 x = load4(F + at);
      v[a][0] = x.x; v[a][1] = x.y; v[a][2] = x.z; v[a][3] = x.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[a][q] = i + q < n ? to_f32(F[at + q]) : 0.f;
    }
  }
}

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

// Copy rows c0 .. c0+rows-1 of the stacked field [A; B] (A and B (kin, n))
// at columns i0 .. i0+kUpTile-1 into s (row stride kUpTile) with cp.async;
// columns past n are zero-filled. vec: 16-byte copies (n % kVec<E> == 0 and
// A, B 16-byte aligned), else element copies (cp_elem) on the same schedule.
template <typename E>
__device__ __forceinline__ void load_stacked(E* s, const E* A, const E* B, int kin,
                                             long long n, long long i0, int c0, int rows,
                                             bool vec) {
  constexpr int kv = kVec<E>;
  const int per = vec ? kUpTile / kv : kUpTile;
  for (int e = threadIdx.x; e < rows * per; e += kUpThreads) {
    const int c = e / per, q = (vec ? kv : 1) * (e - c * per);
    const int row = c0 + c;
    const E* F = row < kin ? A + static_cast<long long>(row) * n
                           : B + static_cast<long long>(row - kin) * n;
    const bool in = i0 + q < n;
    const E* g = in ? F + i0 + q : A;
    if (vec) cp_async16(s + c * kUpTile + q, g, in);
    else cp_elem(s + c * kUpTile + q, g, in);
  }
}

// The pipeline position of a block of a streaming update: tile t of its
// grid-stride walk, stage j (stacked input rows j*kc ..) of the tile's nk.
struct StageCursor {
  long long t;
  int j;
  __device__ __forceinline__ void next(int nk) {
    if (++j == nk) {
      j = 0;
      t += gridDim.x;
    }
  }
};

// Copy the stage at `at` of the stacked field [A; B] (nin = kin stacked rows:
// A alone; 2 kin: A then B) into s (nothing past the last tile) and commit it
// as one cp.async group, empty or not, so that cp_async_wait<kUpStages - 1>
// always finds the stage kUpStages - 1 back.
template <typename E>
__device__ __forceinline__ void load_stage(E* s, const E* A, const E* B, int kin, int nin,
                                           long long n, StageCursor at, int kc,
                                           long long ntiles, bool vec) {
  if (at.t < ntiles)
    load_stacked(s, A, B, kin, n, at.t * kUpTile, at.j * kc, min(kc, nin - at.j * kc), vec);
  cp_async_commit();
}

// Shared bytes of a streaming update launch: nmat float coefficient tables of
// kin columns by 8R rows, kUpStages (kc, kUpTile) input buffers of esize-byte
// field elements and, with the Gram, the float (k, kUpLd) Y tile, at least
// the Gram's end-of-kernel scratch (update_gram.cuh's SymGram::kScratch <=
// kUpThreads x TS^2 floats: TS = 8 above 32 rows, 4 up to 32). Mirrored by
// ops/fused.py update_smem_bytes.
inline long long update_smem_bytes(int k, int kin, int kc, int nmat, bool gram, int esize) {
  const long long rp = 8LL * rows_per_warp(k);
  long long b = 4 * (nmat * kin * rp + (gram ? 1LL * k * kUpLd : 0)) +
                1LL * esize * kUpStages * kc * kUpTile;
  const long long scratch = 4LL * kUpThreads * (k > 32 ? 64 : 16);
  if (gram && b < scratch) b = scratch;
  return b;
}

// A persistent grid for kernel: as many blocks as the card holds at once, at
// most ntiles and max_blocks. It depends on the card, the build and the
// caps alone, so a fixed-order reduction over its blocks repeats bitwise.
template <typename Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem, int device,
                                   long long ntiles, long long max_blocks, int* grid) {
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;  // the plan passes the cap
  long long g = static_cast<long long>(sms) * per_sm;
  if (g > ntiles) g = ntiles;
  if (g > max_blocks) g = max_blocks;
  *grid = static_cast<int>(g);
  return cudaSuccess;
}

// The block's share of G = X Y^T from TS x TS register tiles (8x8 from KMAX
// = 32, 6x6 at 96 rows, 4x4 below 32), rows rt + S*a and columns st + S*b (S
// = KMAX / TS), fed by float4 shared loads along the columns: 16 loads for
// 256 FMAs at 8x8. xs and ys are row-major staged tiles with row strides lx
// and ly (multiples of 4 words; 4 mod 8 words puts the lanes of a quarter
// warp that read different rows in different bank groups), ncol columns (a
// multiple of 4); X has kx rows and Y ky (a square Gram: both k). A block of
// THREADS threads holds THREADS / S^2 copies of the tile (threads past the
// last whole copy idle), each over its own columns, summed in a fixed order
// by store(): no atomics, so a repeated call gives the same bits. 96 rows
// take 6x6 tiles: 256 threads are one whole copy, where 8x8 tiles would keep
// 144 of them busy (gram.cu).
template <int KMAX, int THREADS, int TS_ = (KMAX == 96 ? 6 : KMAX >= 32 ? 8 : 4)>
struct VecGram {
  static constexpr int TS = TS_;                         // register tile side
  static constexpr int S = KMAX / TS;
  static_assert(S * TS == KMAX, "the register tile must divide KMAX");
  static constexpr int kCopy = S * S;                    // threads a copy
  static constexpr int kGroups = THREADS / kCopy;        // copies a block
  static_assert(kGroups >= 1, "a block must hold one copy of the tile");
  static constexpr int kScratch = kGroups * KMAX * KMAX; // floats of store()
  float acc[TS][TS];
  int rt, st, grp;

  __device__ VecGram() {
    const int t = threadIdx.x;
    grp = t / kCopy;
    rt = (t % kCopy) / S;
    st = t % S;
#pragma unroll
    for (int a = 0; a < TS; ++a)
#pragma unroll
      for (int b = 0; b < TS; ++b) acc[a][b] = 0.f;
  }

  template <typename EX, typename EY>
  __device__ __forceinline__ void accumulate(const EX* xs, int lx, const EY* ys, int ly,
                                             int ncol, int k) {
    accumulate(xs, lx, ys, ly, ncol, k, k);
  }

  // xs and ys: staged tiles of float or bf16 (load4: a float4 or four bf16
  // a read, lifted to f32).
  template <typename EX, typename EY>
  __device__ __forceinline__ void accumulate(const EX* xs, int lx, const EY* ys, int ly,
                                             int ncol, int kx, int ky) {
    if (grp >= kGroups) return;
    // Rows past kx (ky) read row kx - 1 (ky - 1): unconditional loads, whose
    // products land only in entries of G that store() drops.
    for (int c = 4 * grp; c < ncol; c += 4 * kGroups) {
      float4 x[TS], y[TS];
#pragma unroll
      for (int a = 0; a < TS; ++a) x[a] = load4(xs + min(rt + S * a, kx - 1) * lx + c);
#pragma unroll
      for (int b = 0; b < TS; ++b) y[b] = load4(ys + min(st + S * b, ky - 1) * ly + c);
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int b = 0; b < TS; ++b) {
          float v = acc[a][b];
          v = fmaf(x[a].x, y[b].x, v);
          v = fmaf(x[a].y, y[b].y, v);
          v = fmaf(x[a].z, y[b].z, v);
          v = fmaf(x[a].w, y[b].w, v);
          acc[a][b] = v;
        }
    }
  }

  // Sum the block's copies in group order through scratch (kScratch floats
  // of shared memory no thread still reads) and write the (kx, ky) partial.
  __device__ void store(float* part, int k, float* scratch) const { store(part, k, k, scratch); }

  __device__ void store(float* part, int kx, int ky, float* scratch) const {
    store(part, kx, ky, ky, scratch);
  }

  // The (kx, ky) partial at rows ld apart (a block of a wider partial).
  __device__ void store(float* part, int kx, int ky, int ld, float* scratch) const {
    if (grp < kGroups) {
      float* mine = scratch + grp * KMAX * KMAX;
#pragma unroll
      for (int a = 0; a < TS; ++a)
#pragma unroll
        for (int b = 0; b < TS; ++b) mine[(rt + S * a) * KMAX + st + S * b] = acc[a][b];
    }
    __syncthreads();
    if (threadIdx.x >= THREADS) return;  // a block's other warps (block_stencil.cu's producers)
    for (int e = threadIdx.x; e < KMAX * KMAX; e += THREADS) {
      const int r = e / KMAX, s = e % KMAX;
      if (r >= kx || s >= ky) continue;
      float v = scratch[e];
      for (int g = 1; g < kGroups; ++g) v += scratch[g * KMAX * KMAX + e];
      part[r * ld + s] = v;
    }
  }
};

// ---- mbarriers (sm_80 and later) for warp-specialised pipelines
// (block_stencil.cu): producer warps' cp.async copies of a stage arrive on
// the stage's barrier when they land (cp_async_mbar_arrive), consumers wait
// on the phase's parity and arrive on a second barrier once the stage's
// buffer may be refilled.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

// Make initialised mbarriers visible to the asynchronous proxy (call before
// the barrier that publishes them to the block).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Arrive on bar once this thread's earlier cp.async copies have landed (the
// arrival counts against bar's initial count).
__device__ __forceinline__ void cp_async_mbar_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Raise the dynamic shared-memory cap of a kernel that needs more than the
// default 48 KB (a launch above the cap is refused).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace
