// Toroidal DIA SpMM, optionally with the fused Gram G = X Y^T.
//
// Replaces the Pallas kernels blockcg_tpu/ops/stencil.py (stencil_spmm_t,
// stencil_spmm_gram_t) and blockcg_tpu/ops/stencil_ring.py (ring_spmm_t,
// ring_spmm_gram_t). Contract: Y[r, i] = sum_d diags[d, i] * X[r, (i + o_d) mod n];
// the Gram variant also returns G = X Y^T (k x k). The TPU windowing and the
// ring schedule are schedules, not part of the contract.
//
// Bound: bytes. Per column it reads ndiag coefficients and ndiag * k values of
// X, and writes k values of Y. X is read from DRAM once only if the L2 cache
// holds the window between the far offsets: at 128^3 rows and k = 32 that is
// +-16,384 columns * 32 rows * 4 B, about 4 MB, well inside the H100's 50 MB.
// So the design leaves X reuse to L2 (neighbouring blocks run at neighbouring
// columns) instead of staging windows by hand, and keeps each thread's k sums
// in registers. The column index wraps by one conditional subtraction: the
// host passes every offset already reduced to [0, n). Y is always a separate
// buffer: other blocks still read the X columns this block's Y covers.
//
// Gram: each block stages its tile's X and Y columns in shared memory, adds
// them into a register tile (GramTile), writes one (k, k) partial, and a
// second kernel sums the partials in a fixed order.
#include "common.cuh"

namespace {

constexpr int kMaxDiags = 32;

struct Offsets {
  int o[kMaxDiags];  // each in [0, n)
};

template <int KMAX, bool WITH_GRAM>
__global__ void __launch_bounds__(kThreads)
    stencil_spmm(const float* __restrict__ diags, Offsets offs, int ndiag,
                 const float* __restrict__ X, float* __restrict__ Y,
                 float* __restrict__ part, int k, long long n) {
  extern __shared__ __align__(16) float smem[];  // WITH_GRAM: xs | ys
  GramTile<KMAX> g;
  const long long ntiles = (n + kThreads - 1) / kThreads;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long i = t * kThreads + threadIdx.x;
    const bool valid = i < n;
    float acc[KMAX];
#pragma unroll
    for (int r = 0; r < KMAX; ++r) acc[r] = 0.f;
    if (valid) {
      for (int d = 0; d < ndiag; ++d) {
        const float c = diags[d * n + i];
        long long j = i + offs.o[d];
        if (j >= n) j -= n;
#pragma unroll
        for (int r = 0; r < KMAX; ++r)
          if (r < k) acc[r] = fmaf(c, X[r * n + j], acc[r]);
      }
    }
    store_col<KMAX>(Y, acc, k, n, i, valid);
    if constexpr (WITH_GRAM) {
      float x[KMAX];
      load_col<KMAX>(x, X, k, n, i, valid);
      __syncthreads();  // the previous tile's Gram reads are done
      stage_col<KMAX>(smem, x);
      stage_col<KMAX>(smem + KMAX * kLd, acc);
      __syncthreads();
      g.accumulate(smem, smem + KMAX * kLd);
    }
  }
  if constexpr (WITH_GRAM) g.store(part + static_cast<long long>(blockIdx.x) * k * k, k);
}

template <int KMAX, bool WITH_GRAM>
cudaError_t launch(const float* diags, const Offsets& offs, int ndiag,
                   const float* X, float* Y, float* part, float* G, int k,
                   long long n, int nblocks, cudaStream_t stream) {
  auto kernel = stencil_spmm<KMAX, WITH_GRAM>;
  const size_t smem = WITH_GRAM ? 2 * KMAX * kLd * sizeof(float) : 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<nblocks, kThreads, smem, stream>>>(diags, offs, ndiag, X, Y, part, k, n);
  if (WITH_GRAM) launch_reduce(part, G, k, nblocks, stream);
  return cudaGetLastError();
}

}  // namespace

// offsets: host array of ndiag offsets, each already reduced to [0, n).
// G == nullptr selects the plain SpMM; otherwise part holds (nblocks, k, k).
extern "C" int bcg_stencil_spmm(const float* diags, const int* offsets,
                                int ndiag, const float* X, float* Y,
                                float* part, float* G, int k, long long n,
                                int nblocks, int device, cudaStream_t stream) {
  if (ndiag < 1 || ndiag > kMaxDiags || nblocks < 1 || n < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Offsets offs{};
  for (int d = 0; d < ndiag; ++d) {
    if (offsets[d] < 0 || offsets[d] >= n) return cudaErrorInvalidValue;
    offs.o[d] = offsets[d];
  }
  const bool gram = G != nullptr;
#define BCG_STENCIL(KM)                                                        \
  return gram ? launch<KM, true>(diags, offs, ndiag, X, Y, part, G, k, n,     \
                                 nblocks, stream)                              \
              : launch<KM, false>(diags, offs, ndiag, X, Y, part, G, k, n,    \
                                  nblocks, stream)
  switch (kmax_for(k)) {
    case 8: BCG_STENCIL(8);
    case 16: BCG_STENCIL(16);
    case 32: BCG_STENCIL(32);
    case 64: BCG_STENCIL(64);
    default: return cudaErrorInvalidValue;
  }
#undef BCG_STENCIL
}
