// General-sparsity SpMM over dense T x T tiles (T = 128):
//   Y[:, rt*T:(rt+1)*T] = sum over the row tile's tiles of X[:, ct*T:(ct+1)*T] A_tile^T
// on lanes-major (k, n) float32 fields, tiles stored as float32 or bfloat16.
//
// Replaces the Pallas kernel blockcg_tpu/ops/spmm_tiled.py tiled_spmm_t.
//
// Contract: tiles (ntiles, T, T) sorted by row tile, rt/ct/first int32
// (ntiles,); first[t] == 1 resets the row tile's sum at tile t. row_ptr
// (nrt + 1) int32 holds each row tile's first tile (the wrapper derives it
// from rt), so a block finds its tiles without a search. A row tile with no
// tile gets zeros. bf16 tiles are widened to f32 before the f32 FMA, against
// f32 X, as the reference upcasts in VMEM; the sum is a full-precision f32 dot.
//
// The TPU kernel walks the tiles on one sequential grid and keeps the output
// block in VMEM between revisits. Here one block (256 threads) owns one row
// tile: it loops over that row tile's tiles, stages each 128 x 128 tile
// (64 KB as f32; bf16 is widened while staging) and the (k, 128) X block in
// shared memory, and keeps the (k, 128) output in registers, written once at
// the end: no atomics, and a repeated call gives the same bits. Thread
// (ti, tk), ti < 32, tk < 8, owns output columns ti + 32 r (r < 4) and rows
// tk + 8 q (q < KMAX / 8): per step j it reads 4 tile entries (the tile is
// staged with a row pitch of 129 floats, so the warp's 32 rows fall in 32
// banks) and KMAX / 8 X entries (one address per warp, a broadcast), and
// does 4 * KMAX / 8 FMAs. KMAX (8, 16, 32, 64 or 128) is the compile-time
// register width >= k; wider fields are split into row chunks by the wrapper.
//
// Bound: at low fill the padded tiles dominate the bytes (4 B or 2 B per
// entry against 8 B per stored nonzero of CSR); per tile the work is
// 2 k T^2 FLOPs against T^2 tile bytes, so at k = 32 an f32 tile run sits
// near the card's balance of FP32 FLOPs and HBM bytes, and with bf16 tiles
// the FP32 FMAs bound it. This first kernel stages without overlap
// (cp.async / TMA double buffering and a tensor-core path are later work).
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kT = 128;          // tile side
constexpr int kTP = kT + 1;      // staged tile row pitch (bank-conflict free)
constexpr int kSpmmThreads = 256;
constexpr int kRowsPer = 4;      // output columns per thread
constexpr int kTI = kT / kRowsPer;          // 32 column groups
constexpr int kTK = kSpmmThreads / kTI;     // 8 row groups

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int KMAX, typename TT>
__global__ void __launch_bounds__(kSpmmThreads)
    tiled_spmm(const TT* __restrict__ tiles, const int* __restrict__ row_ptr,
               const int* __restrict__ ct, const int* __restrict__ first,
               const float* __restrict__ X, float* __restrict__ Y, int k,
               long long n) {
  constexpr int KQ = KMAX / kTK > 0 ? KMAX / kTK : 1;
  extern __shared__ __align__(16) float smem[];  // as (T x kTP) | xs (KMAX x T)
  float* as = smem;
  float* xs = smem + kT * kTP;
  const int tid = threadIdx.x;
  const int ti = tid % kTI, tk = tid / kTI;
  const long long rt = blockIdx.x;
  const int t0 = row_ptr[rt], t1 = row_ptr[rt + 1];

  // Rows k..KMAX-1 of the X block stay zero for the whole kernel.
  for (int e = tid; e < (KMAX - k) * kT; e += kSpmmThreads) xs[k * kT + e] = 0.f;

  float acc[kRowsPer][KQ];
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r)
#pragma unroll
    for (int q = 0; q < KQ; ++q) acc[r][q] = 0.f;

  for (int t = t0; t < t1; ++t) {
    if (first[t]) {
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r)
#pragma unroll
        for (int q = 0; q < KQ; ++q) acc[r][q] = 0.f;
    }
    __syncthreads();  // the previous tile's reads are done
    const TT* tile = tiles + static_cast<long long>(t) * kT * kT;
    for (int e = tid; e < kT * kT; e += kSpmmThreads) {
      as[(e / kT) * kTP + e % kT] = widen(tile[e]);
    }
    const float* xb = X + static_cast<long long>(ct[t]) * kT;
    for (int e = tid; e < k * kT; e += kSpmmThreads) {
      const int r = e / kT, j = e % kT;
      xs[r * kT + j] = xb[r * n + j];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kT; ++j) {
      float a[kRowsPer], x[KQ];
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) a[r] = as[(ti + kTI * r) * kTP + j];
#pragma unroll
      for (int q = 0; q < KQ; ++q) x[q] = xs[(tk + kTK * q) * kT + j];
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r)
#pragma unroll
        for (int q = 0; q < KQ; ++q) acc[r][q] = fmaf(x[q], a[r], acc[r][q]);
    }
  }
  float* yb = Y + rt * kT;
#pragma unroll
  for (int q = 0; q < KQ; ++q) {
    const int row = tk + kTK * q;
    if (row < k) {
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) yb[row * n + ti + kTI * r] = acc[r][q];
    }
  }
}

template <int KMAX, typename TT>
cudaError_t launch(const void* tiles, const int* row_ptr, const int* ct,
                   const int* first, const float* X, float* Y, int k, int nrt,
                   long long n, cudaStream_t stream) {
  auto kernel = tiled_spmm<KMAX, TT>;
  const size_t smem = (kT * kTP + KMAX * kT) * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<nrt, kSpmmThreads, smem, stream>>>(static_cast<const TT*>(tiles), row_ptr, ct,
                                              first, X, Y, k, n);
  return cudaGetLastError();
}

template <typename TT>
cudaError_t by_kmax(const void* tiles, const int* row_ptr, const int* ct,
                    const int* first, const float* X, float* Y, int k, int nrt,
                    long long n, cudaStream_t stream) {
  const int kmax = k <= 64 ? kmax_for(k) : k <= 128 ? 128 : 0;
  switch (kmax) {
    case 8: return launch<8, TT>(tiles, row_ptr, ct, first, X, Y, k, nrt, n, stream);
    case 16: return launch<16, TT>(tiles, row_ptr, ct, first, X, Y, k, nrt, n, stream);
    case 32: return launch<32, TT>(tiles, row_ptr, ct, first, X, Y, k, nrt, n, stream);
    case 64: return launch<64, TT>(tiles, row_ptr, ct, first, X, Y, k, nrt, n, stream);
    case 128: return launch<128, TT>(tiles, row_ptr, ct, first, X, Y, k, nrt, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// tiles: device (ntiles, 128, 128), float32 (bf16 == 0) or bfloat16 (bf16 !=
// 0). row_ptr: device (nrt + 1) int32; ct, first: device (ntiles) int32.
// X, Y: device (k, n) float32 row chunks with row stride n = nrt * 128
// (1 <= k <= 128); Y is written in full.
extern "C" int bcg_tiled_spmm(const void* tiles, int bf16, const int* row_ptr,
                              const int* ct, const int* first, const float* X,
                              float* Y, int k, int nrt, long long n, int device,
                              cudaStream_t stream) {
  if (k < 1 || k > 128 || nrt < 1 || n != static_cast<long long>(nrt) * kT)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return bf16 ? by_kmax<__nv_bfloat16>(tiles, row_ptr, ct, first, X, Y, k, nrt, n, stream)
              : by_kmax<float>(tiles, row_ptr, ct, first, X, Y, k, nrt, n, stream);
}
