// The shifted-block SBCGrQ tail: Q = M2 Q1 and Pn = Q + rho P in one pass.
//
// Replaces the Pallas kernel blockcg_tpu/ops/fused.py qr_p_update.
//
// Bound: bytes, four field passes (read Q1, P; write Q, Pn), with 2 k x k FMAs
// per column beside them. The TPU kernel stacked the two applies into one
// (2k, 2k) MXU dot; here, as in px_update.cu, both coefficient matrices sit in
// shared memory (transposed, broadcast reads), one thread owns a column, and
// Q's column, still in registers, seeds Pn's, so Q1 and P are each read once.
//
// In place: Q may be the same buffer as Q1 and Pn the same as P (the solver
// donates both). Column i of each output depends only on column i of the
// inputs, and a thread reads all of its column before it writes it, so the
// field pointers are not declared __restrict__.
#include "common.cuh"

namespace {

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
    qr_p_update(const float* __restrict__ M2, const float* Q1,
                const float* __restrict__ Rho, const float* P, float* Q,
                float* Pn, int k, long long n) {
  extern __shared__ __align__(16) float smem[];  // m2T | rhoT
  float* m2 = smem;
  float* rho = smem + KMAX * KMAX;
  stage_coeff<KMAX>(m2, M2, k);
  stage_coeff<KMAX>(rho, Rho, k);
  __syncthreads();
  const long long ntiles = (n + kThreads - 1) / kThreads;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long i = t * kThreads + threadIdx.x;
    const bool valid = i < n;
    float q[KMAX], pn[KMAX];
#pragma unroll
    for (int r = 0; r < KMAX; ++r) q[r] = 0.f;
    apply_coeff<KMAX>(q, m2, Q1, k, n, i, valid);
#pragma unroll
    for (int r = 0; r < KMAX; ++r) pn[r] = q[r];
    apply_coeff<KMAX>(pn, rho, P, k, n, i, valid);
    store_col<KMAX>(Q, q, k, n, i, valid);
    store_col<KMAX>(Pn, pn, k, n, i, valid);
  }
}

template <int KMAX>
cudaError_t launch(const float* M2, const float* Q1, const float* Rho,
                   const float* P, float* Q, float* Pn, int k, long long n,
                   int nblocks, cudaStream_t stream) {
  auto kernel = qr_p_update<KMAX>;
  const size_t smem = 2 * KMAX * KMAX * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<nblocks, kThreads, smem, stream>>>(M2, Q1, Rho, P, Q, Pn, k, n);
  return cudaGetLastError();
}

}  // namespace

// Q may equal Q1 and Pn may equal P.
extern "C" int bcg_qr_p_update(const float* M2, const float* Q1, const float* Rho,
                               const float* P, float* Q, float* Pn, int k,
                               long long n, int nblocks, int device,
                               cudaStream_t stream) {
  if (nblocks < 1 || n < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (kmax_for(k)) {
    case 8: return launch<8>(M2, Q1, Rho, P, Q, Pn, k, n, nblocks, stream);
    case 16: return launch<16>(M2, Q1, Rho, P, Q, Pn, k, n, nblocks, stream);
    case 32: return launch<32>(M2, Q1, Rho, P, Q, Pn, k, n, nblocks, stream);
    case 64: return launch<64>(M2, Q1, Rho, P, Q, Pn, k, n, nblocks, stream);
    default: return cudaErrorInvalidValue;
  }
}
