// The SBCGrQ iteration tail: Pn = M1 W + rho P and Xn = X + C P in one pass.
//
// Replaces the Pallas kernel blockcg_tpu/ops/fused.py px_update.
//
// Bound: bytes, five field passes (read W, P, X; write Pn, Xn), with 3 k x k
// FMAs per column beside them. P is read once for both outputs. The three
// coefficient matrices sit in shared memory (transposed, broadcast reads),
// both output columns in registers.
//
// Row chunks: Pn and Xn have k <= 64 rows, M1, rho and C are k x kin, W and P
// (kin, n); a wider update is one launch per chunk of rows (ops/fused.py).
//
// In place: Pn may be the same buffer as P and Xn the same as X (the solver
// donates both). Column i of each output depends only on column i of the
// inputs, and a thread reads all of its column before it writes it, so the
// field pointers are not declared __restrict__.
#include "common.cuh"

namespace {

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
    px_update(const float* __restrict__ M1, const float* W,
              const float* __restrict__ Rho, const float* P,
              const float* __restrict__ C, const float* X, float* Pn,
              float* Xn, int k, int kin, long long n) {
  extern __shared__ __align__(16) float smem[];  // m1T | rhoT | cT
  float* m1 = smem;
  const int mfloats = coeff_cols<KMAX>(kin) * KMAX;
  float* rho = smem + mfloats;
  float* cc = smem + 2 * mfloats;
  stage_coeff<KMAX>(m1, M1, k, kin);
  stage_coeff<KMAX>(rho, Rho, k, kin);
  stage_coeff<KMAX>(cc, C, k, kin);
  __syncthreads();
  const long long ntiles = (n + kThreads - 1) / kThreads;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long i = t * kThreads + threadIdx.x;
    const bool valid = i < n;
    float pn[KMAX], xn[KMAX];
#pragma unroll
    for (int r = 0; r < KMAX; ++r) pn[r] = 0.f;
    apply_coeff<KMAX>(pn, m1, W, kin, n, i, valid);
    load_col<KMAX>(xn, X, k, n, i, valid);
    if (valid) {
      // One read of P feeds both outputs.
#pragma unroll 4
      for (int c = 0; c < kin; ++c) {
        const float pc = P[c * n + i];
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

template <int KMAX>
cudaError_t launch(const float* M1, const float* W, const float* Rho,
                   const float* P, const float* C, const float* X, float* Pn,
                   float* Xn, int k, int kin, long long n, int nblocks,
                   cudaStream_t stream) {
  auto kernel = px_update<KMAX>;
  const size_t smem = 3 * coeff_cols<KMAX>(kin) * KMAX * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<nblocks, kThreads, smem, stream>>>(M1, W, Rho, P, C, X, Pn, Xn, k, kin, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bcg_px_update(const float* M1, const float* W, const float* Rho,
                             const float* P, const float* C, const float* X,
                             float* Pn, float* Xn, int k, int kin, long long n,
                             int nblocks, int device, cudaStream_t stream) {
  if (nblocks < 1 || n < 1 || kin < k) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (kmax_for(k)) {
    case 8: return launch<8>(M1, W, Rho, P, C, X, Pn, Xn, k, kin, n, nblocks, stream);
    case 16: return launch<16>(M1, W, Rho, P, C, X, Pn, Xn, k, kin, n, nblocks, stream);
    case 32: return launch<32>(M1, W, Rho, P, C, X, Pn, Xn, k, kin, n, nblocks, stream);
    case 64: return launch<64>(M1, W, Rho, P, C, X, Pn, Xn, k, kin, n, nblocks, stream);
    default: return cudaErrorInvalidValue;
  }
}
