// The fused SBCGrQ iteration tail that also updates the solution: Q = M2 Q1,
// Pn = Q + rho P and Xn = X + C P in one pass. (The shifted-block tail
// without Xn, qr_p_update, runs on px_update.cu's streaming schedule.)
//
// Replaces the Pallas kernel blockcg_tpu/ops/fused.py qr_px_update (:795).
//
// Bound: bytes, six field passes (read Q1, P, X; write Q, Pn, Xn) with 3 k
// x k FMAs per column beside them, against seven for qr_p_update and a
// separate mm_update (P read twice). The TPU kernel stacked the applies into
// one (3k, 2k) MXU dot; here the coefficient matrices sit in shared memory
// (transposed, broadcast reads), one thread owns a column, and Q's column,
// still in registers, seeds Pn's, so Q1 and P are each read once (one read
// of P feeds both Pn and Xn).
//
// Row chunks: the outputs have k <= 64 rows, M2, rho and C are k x kin, Q1
// and P (kin, n); a wider update is one launch per chunk of rows
// (ops/fused.py).
//
// bf16 fields (bcg_qr_px_update_bf16): Q1, P, X, Q, Pn and Xn are bf16; M2,
// rho and C stay f32. Every FMA runs in f32, Pn goes on from the unrounded f32 Q (as the reference's
// q + rho P does), and Q, Pn and Xn are each rounded once where they are
// stored.
//
// In place: Q may be the same buffer as Q1, Pn the same as P and Xn the same
// as X (the solver donates them). Column i of each output depends only on
// column i of the inputs, and a thread reads all of its column before it
// writes it, so the field pointers are not declared __restrict__.
#include "common.cuh"

namespace {

// E: the field element (float or bf16).
template <typename E, int KMAX>
__global__ void __launch_bounds__(kThreads)
    qr_px_update(const float* __restrict__ M2, const E* Q1,
                 const float* __restrict__ Rho, const E* P,
                 const float* __restrict__ C, const E* X, E* Q,
                 E* Pn, E* Xn, int k, int kin, long long n) {
  extern __shared__ __align__(16) float smem[];  // m2T | rhoT | cT
  const int mfloats = coeff_cols<KMAX>(kin) * KMAX;
  float* m2 = smem;
  float* rho = smem + mfloats;
  float* cc = smem + 2 * mfloats;
  stage_coeff<KMAX>(m2, M2, k, kin);
  stage_coeff<KMAX>(rho, Rho, k, kin);
  stage_coeff<KMAX>(cc, C, k, kin);
  __syncthreads();
  const long long ntiles = (n + kThreads - 1) / kThreads;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long i = t * kThreads + threadIdx.x;
    const bool valid = i < n;
    float q[KMAX], pn[KMAX], xn[KMAX];
#pragma unroll
    for (int r = 0; r < KMAX; ++r) q[r] = 0.f;
    apply_coeff<KMAX>(q, m2, Q1, kin, n, i, valid);
    store_col<KMAX>(Q, q, k, n, i, valid);
#pragma unroll
    for (int r = 0; r < KMAX; ++r) pn[r] = q[r];
    load_col<KMAX>(xn, X, k, n, i, valid);
    if (valid) {
      // One read of P feeds both outputs.
#pragma unroll 4
      for (int c = 0; c < kin; ++c) {
        const float pc = to_f32(P[c * n + i]);
#pragma unroll
        for (int r = 0; r < KMAX; ++r) {
          pn[r] = fmaf(rho[c * KMAX + r], pc, pn[r]);
          xn[r] = fmaf(cc[c * KMAX + r], pc, xn[r]);
        }
      }
    }
    store_col<KMAX>(Pn, pn, k, n, i, valid);
    store_col<KMAX>(Xn, xn, k, n, i, valid);
  }
}

template <typename E, int KMAX>
cudaError_t launch_px(const float* M2, const E* Q1, const float* Rho, const E* P,
                      const float* C, const E* X, E* Q, E* Pn, E* Xn, int k, int kin,
                      long long n, int nblocks, cudaStream_t stream) {
  auto kernel = qr_px_update<E, KMAX>;
  const size_t smem = 3 * coeff_cols<KMAX>(kin) * KMAX * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<nblocks, kThreads, smem, stream>>>(M2, Q1, Rho, P, C, X, Q, Pn, Xn, k, kin, n);
  return cudaGetLastError();
}

template <typename E>
int qr_px_update_entry(const float* M2, const E* Q1, const float* Rho, const E* P,
                       const float* C, const E* X, E* Q, E* Pn, E* Xn, int k, int kin,
                       long long n, int nblocks, int device, cudaStream_t stream) {
  if (nblocks < 1 || n < 1 || kin < k) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
#define BCG_QPX(KMAX) \
  return launch_px<E, KMAX>(M2, Q1, Rho, P, C, X, Q, Pn, Xn, k, kin, n, nblocks, stream)
  switch (kmax_for(k)) {
    case 8: BCG_QPX(8);
    case 16: BCG_QPX(16);
    case 32: BCG_QPX(32);
    case 64: BCG_QPX(64);
    default: return cudaErrorInvalidValue;
  }
#undef BCG_QPX
}

}  // namespace

// Q may equal Q1, Pn may equal P and Xn may equal X.
extern "C" int bcg_qr_px_update(const float* M2, const float* Q1, const float* Rho,
                                const float* P, const float* C, const float* X,
                                float* Q, float* Pn, float* Xn, int k, int kin,
                                long long n, int nblocks, int device,
                                cudaStream_t stream) {
  return qr_px_update_entry(M2, Q1, Rho, P, C, X, Q, Pn, Xn, k, kin, n, nblocks, device,
                            stream);
}

// The same on bf16 fields; M2, rho and C stay f32.
extern "C" int bcg_qr_px_update_bf16(const float* M2, const bf16* Q1, const float* Rho,
                                     const bf16* P, const float* C, const bf16* X, bf16* Q,
                                     bf16* Pn, bf16* Xn, int k, int kin, long long n,
                                     int nblocks, int device, cudaStream_t stream) {
  return qr_px_update_entry(M2, Q1, Rho, P, C, X, Q, Pn, Xn, k, kin, n, nblocks, device,
                            stream);
}
