// k x k-coefficient field update Y = M B (+ A), optionally with the Gram
// G = Y Y^T of the stored Y.
//
// Replaces the Pallas kernel blockcg_tpu/ops/fused.py mm_update_gram, and
// mm_update on fields wider than 128 rows; up to 128 rows mm_update runs
// mm_update.cu (mm2_update_gram runs mm2_update_gram.cu).
//
// Bound: bytes at small k on paper (1 + HAS_A field reads, one write),
// but each column also costs k * k FMAs plus k * k for the Gram, so
// at k = 32 the arithmetic is of the same order as the traffic. The design
// keeps the coefficients in shared memory (broadcast reads, transposed so
// four come per load), the output column in registers, reads each input
// value once inside the coefficient loop, and takes the Gram in a register
// tile over staged 128-column tiles (GramTile), reduced across blocks by a
// second kernel in a fixed order.
//
// Row chunks: Y has k <= 64 rows, M is k x kin, B (kin, n); a wider update
// is one launch per chunk of Y's rows (ops/fused.py).
//
// In place: Y may be the same buffer as B or as A (the solvers' donated
// operand). Column i of Y depends only on column i of the inputs, and a thread
// reads all of its column before it writes it, so that is safe; B, A and Y
// are therefore not declared __restrict__.
#include "common.cuh"

namespace {

template <int KMAX, bool HAS_A, bool WITH_GRAM>
__global__ void __launch_bounds__(kThreads)
    coeff_update(const float* __restrict__ M, const float* B, const float* A, float* Y,
                 float* __restrict__ part, int k, int kin, long long n) {
  extern __shared__ __align__(16) float smem[];  // mT | ys (WITH_GRAM)
  float* m = smem;
  float* ys = smem + coeff_cols<KMAX>(kin) * KMAX;
  stage_coeff<KMAX>(m, M, k, kin);
  __syncthreads();
  GramTile<KMAX> g;
  const long long ntiles = (n + kThreads - 1) / kThreads;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long i = t * kThreads + threadIdx.x;
    const bool valid = i < n;
    float y[KMAX];
#pragma unroll
    for (int r = 0; r < KMAX; ++r) y[r] = 0.f;
    apply_coeff<KMAX>(y, m, B, kin, n, i, valid);
    if constexpr (HAS_A) {
      float a[KMAX];
      load_col<KMAX>(a, A, k, n, i, valid);
#pragma unroll
      for (int r = 0; r < KMAX; ++r) y[r] += a[r];
    }
    store_col<KMAX>(Y, y, k, n, i, valid);
    if constexpr (WITH_GRAM) {
      __syncthreads();
      stage_col<KMAX>(ys, y);
      __syncthreads();
      g.accumulate(ys, ys);
    }
  }
  if constexpr (WITH_GRAM) g.store(part + static_cast<long long>(blockIdx.x) * k * k, k);
}

template <int KMAX, bool HAS_A, bool WITH_GRAM>
cudaError_t launch(const float* M, const float* B, const float* A, float* Y, float* part,
                   float* G, int k, int kin, long long n, int nblocks, cudaStream_t stream) {
  auto kernel = coeff_update<KMAX, HAS_A, WITH_GRAM>;
  const size_t smem = (coeff_cols<KMAX>(kin) * KMAX + (WITH_GRAM ? KMAX * kLd : 0)) *
                      sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<nblocks, kThreads, smem, stream>>>(M, B, A, Y, part, k, kin, n);
  if (WITH_GRAM) launch_reduce(part, G, k, nblocks, stream);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t dispatch(const float* M, const float* B, const float* A, float* Y, float* part,
                     float* G, int k, int kin, long long n, int nblocks, cudaStream_t stream) {
  // The combinations the solvers use: mm_update (+A) above 128 rows,
  // mm_update_gram (+A).
  if (G != nullptr)
    return A ? launch<KMAX, true, true>(M, B, A, Y, part, G, k, kin, n, nblocks, stream)
             : launch<KMAX, false, true>(M, B, A, Y, part, G, k, kin, n, nblocks, stream);
  return A ? launch<KMAX, true, false>(M, B, A, Y, part, G, k, kin, n, nblocks, stream)
           : launch<KMAX, false, false>(M, B, A, Y, part, G, k, kin, n, nblocks, stream);
}

}  // namespace

// A == nullptr: no additive field. G == nullptr: no Gram (part is then
// unused). Y may equal B or A. M is k x kin (row stride kin), B (kin, n), A
// and Y (k, n).
extern "C" int bcg_coeff_update(const float* M, const float* B, const float* A, float* Y,
                                float* part, float* G, int k, int kin, long long n,
                                int nblocks, int device, cudaStream_t stream) {
  if (nblocks < 1 || n < 1 || kin < k) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (kmax_for(k)) {
    case 8: return dispatch<8>(M, B, A, Y, part, G, k, kin, n, nblocks, stream);
    case 16: return dispatch<16>(M, B, A, Y, part, G, k, kin, n, nblocks, stream);
    case 32: return dispatch<32>(M, B, A, Y, part, G, k, kin, n, nblocks, stream);
    case 64: return dispatch<64>(M, B, A, Y, part, G, k, kin, n, nblocks, stream);
    default: return cudaErrorInvalidValue;
  }
}
