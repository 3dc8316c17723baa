// k x k-coefficient field update Y = M1 B1 (+ M2 B2) (+ A), optionally with
// the Gram G = Y Y^T of the stored Y.
//
// Replaces the Pallas kernels blockcg_tpu/ops/fused.py mm_update_gram (1 term,
// Gram) and mm2_update_gram (2 terms, Gram), and mm_update (1 term, no Gram)
// on fields wider than 128 rows; up to 128 rows mm_update runs mm_update.cu.
//
// Bound: bytes at small k on paper (NTERMS + HAS_A field reads, one write),
// but each column also costs NTERMS * k * k FMAs plus k * k for the Gram, so
// at k = 32 the arithmetic is of the same order as the traffic. The design
// keeps the coefficients in shared memory (broadcast reads, transposed so
// four come per load), the output column in registers, reads each input
// value once inside the coefficient loop, and takes the Gram in a register
// tile over staged 128-column tiles (GramTile), reduced across blocks by a
// second kernel in a fixed order.
//
// Row chunks: Y has k <= 64 rows, M1 and M2 are k x kin, B1 and B2 (kin, n);
// a wider update is one launch per chunk of Y's rows (ops/fused.py).
//
// In place: Y may be the same buffer as B1 or as A (the solvers' donated
// operand). Column i of Y depends only on column i of the inputs, and a thread
// reads all of its column before it writes it, so that is safe; B1, A and Y
// are therefore not declared __restrict__.
#include "common.cuh"

namespace {

template <int KMAX, int NTERMS, bool HAS_A, bool WITH_GRAM>
__global__ void __launch_bounds__(kThreads)
    coeff_update(const float* __restrict__ M1, const float* B1,
                 const float* __restrict__ M2, const float* B2,
                 const float* A, float* Y, float* __restrict__ part, int k,
                 int kin, long long n) {
  // m1T | m2T (NTERMS == 2) | ys (WITH_GRAM)
  extern __shared__ __align__(16) float smem[];
  float* m1 = smem;
  const int mfloats = coeff_cols<KMAX>(kin) * KMAX;
  float* m2 = smem + mfloats;
  float* ys = smem + NTERMS * mfloats;
  stage_coeff<KMAX>(m1, M1, k, kin);
  if constexpr (NTERMS == 2) stage_coeff<KMAX>(m2, M2, k, kin);
  __syncthreads();
  GramTile<KMAX> g;
  const long long ntiles = (n + kThreads - 1) / kThreads;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long i = t * kThreads + threadIdx.x;
    const bool valid = i < n;
    float y[KMAX];
#pragma unroll
    for (int r = 0; r < KMAX; ++r) y[r] = 0.f;
    apply_coeff<KMAX>(y, m1, B1, kin, n, i, valid);
    if constexpr (NTERMS == 2) apply_coeff<KMAX>(y, m2, B2, kin, n, i, valid);
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

template <int KMAX, int NTERMS, bool HAS_A, bool WITH_GRAM>
cudaError_t launch(const float* M1, const float* B1, const float* M2,
                   const float* B2, const float* A, float* Y, float* part,
                   float* G, int k, int kin, long long n, int nblocks,
                   cudaStream_t stream) {
  auto kernel = coeff_update<KMAX, NTERMS, HAS_A, WITH_GRAM>;
  const size_t smem = (NTERMS * coeff_cols<KMAX>(kin) * KMAX + (WITH_GRAM ? KMAX * kLd : 0)) *
                      sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<nblocks, kThreads, smem, stream>>>(M1, B1, M2, B2, A, Y, part, k, kin, n);
  if (WITH_GRAM) launch_reduce(part, G, k, nblocks, stream);
  return cudaGetLastError();
}

template <int KMAX>
cudaError_t dispatch(const float* M1, const float* B1, const float* M2,
                     const float* B2, const float* A, float* Y, float* part,
                     float* G, int k, int kin, long long n, int nblocks,
                     cudaStream_t stream) {
  const bool two = M2 != nullptr, has_a = A != nullptr, gram = G != nullptr;
  // The combinations the solvers use: mm_update (+A), mm_update_gram (+A),
  // mm2_update_gram.
  if (two) {
    if (has_a || !gram) return cudaErrorInvalidValue;
    return launch<KMAX, 2, false, true>(M1, B1, M2, B2, A, Y, part, G, k, kin, n, nblocks, stream);
  }
  if (gram)
    return has_a ? launch<KMAX, 1, true, true>(M1, B1, M2, B2, A, Y, part, G, k, kin, n, nblocks, stream)
                 : launch<KMAX, 1, false, true>(M1, B1, M2, B2, A, Y, part, G, k, kin, n, nblocks, stream);
  return has_a ? launch<KMAX, 1, true, false>(M1, B1, M2, B2, A, Y, part, G, k, kin, n, nblocks, stream)
               : launch<KMAX, 1, false, false>(M1, B1, M2, B2, A, Y, part, G, k, kin, n, nblocks, stream);
}

}  // namespace

// M2/B2 == nullptr: one term. A == nullptr: no additive field. G == nullptr:
// no Gram (part is then unused). Y may equal B1 or A. M1 and M2 are k x kin
// (row stride kin), B1 and B2 (kin, n), A and Y (k, n).
extern "C" int bcg_coeff_update(const float* M1, const float* B1,
                                const float* M2, const float* B2,
                                const float* A, float* Y, float* part,
                                float* G, int k, int kin, long long n, int nblocks,
                                int device, cudaStream_t stream) {
  if (nblocks < 1 || n < 1 || kin < k || (M2 == nullptr) != (B2 == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (kmax_for(k)) {
    case 8: return dispatch<8>(M1, B1, M2, B2, A, Y, part, G, k, kin, n, nblocks, stream);
    case 16: return dispatch<16>(M1, B1, M2, B2, A, Y, part, G, k, kin, n, nblocks, stream);
    case 32: return dispatch<32>(M1, B1, M2, B2, A, Y, part, G, k, kin, n, nblocks, stream);
    case 64: return dispatch<64>(M1, B1, M2, B2, A, Y, part, G, k, kin, n, nblocks, stream);
    default: return cudaErrorInvalidValue;
  }
}
