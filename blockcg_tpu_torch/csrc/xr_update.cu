// The BCG/BCGA solution and residual updates with the next residual Gram:
// Xn = X + alpha P, Rn = R - alpha Z and G = Rn Rn^T, in one pass.
//
// Replaces the Pallas kernel blockcg_tpu/ops/fused.py xr_update_gram.
//
// Bound: bytes at small k, six field passes (read P, Z, X, R; write Xn, Rn),
// but each column also costs 2 k x k FMAs for the updates and k x k for the
// Gram, so at k = 16..48 the arithmetic is of the same order as the traffic
// (the regime of mm2_update_gram). The TPU kernel stacked the two k x k
// applies into one (2k, 2k) MXU dot; here there is no matrix unit to fill:
// alpha sits in shared memory once (transposed, broadcast reads), one thread
// owns a column and keeps both output columns in registers, reads each value
// of P and Z once inside the coefficient loop, and the Gram of the stored Rn
// is taken in a register tile over staged 128-column tiles (GramTile) and
// reduced across blocks by a second kernel in a fixed order, so repeated
// solves are bitwise identical.
//
// Row chunks: Xn, Rn, X and R have k <= 64 rows, alpha is k x kin, P and Z
// (kin, n); a wider update is one launch per chunk of rows, each with the
// Gram of its own rows (ops/fused.py adds the cross blocks).
//
// bf16 fields (bcg_xr_update_gram_bf16): P, X, Z, R, Xn and Rn are bf16,
// alpha stays f32. X and R are lifted to f32, every FMA runs in f32, Xn and Rn
// are rounded once where they are stored, and the Gram is of the stored Rn:
// the tile stages each rounded value, lifted back to f32.
//
// In place: Xn may be the same buffer as X and Rn the same as R (the solvers
// donate both). Column i of each output depends only on column i of the
// inputs, and a thread reads all of its column before it writes it, so those
// pointers are not declared __restrict__; P and Z are only read.
#include "common.cuh"

namespace {

// E: the field element (float or bf16).
template <typename E, int KMAX>
__global__ void __launch_bounds__(kThreads)
    xr_update_gram(const float* __restrict__ Alpha, const E* __restrict__ P,
                   const E* X, const E* __restrict__ Z, const E* R,
                   E* Xn, E* Rn, float* __restrict__ part, int k,
                   int kin, long long n) {
  extern __shared__ __align__(16) float smem[];  // alphaT | rs
  float* a = smem;
  float* rs = smem + coeff_cols<KMAX>(kin) * KMAX;
  stage_coeff<KMAX>(a, Alpha, k, kin);
  __syncthreads();
  GramTile<KMAX> g;
  const long long ntiles = (n + kThreads - 1) / kThreads;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long i = t * kThreads + threadIdx.x;
    const bool valid = i < n;
    float x[KMAX], r[KMAX];
    load_col<KMAX>(x, X, k, n, i, valid);
    load_col<KMAX>(r, R, k, n, i, valid);
    if (valid) {
#pragma unroll 4
      for (int c = 0; c < kin; ++c) {
        const float pc = to_f32(P[c * n + i]);
        const float zc = to_f32(Z[c * n + i]);
        const float* ac = a + c * KMAX;
#pragma unroll
        for (int s = 0; s < KMAX; ++s) {
          x[s] = fmaf(ac[s], pc, x[s]);
          r[s] = fmaf(-ac[s], zc, r[s]);
        }
      }
    }
    store_col<KMAX>(Xn, x, k, n, i, valid);
    store_col<KMAX>(Rn, r, k, n, i, valid);
    __syncthreads();
    stage_col<KMAX, E>(rs, r);  // the stored Rn
    __syncthreads();
    g.accumulate(rs, rs);
  }
  g.store(part + static_cast<long long>(blockIdx.x) * k * k, k);
}

template <typename E, int KMAX>
cudaError_t launch(const float* Alpha, const E* P, const E* X, const E* Z, const E* R, E* Xn,
                   E* Rn, float* part, float* G, int k, int kin, long long n, int nblocks,
                   cudaStream_t stream) {
  auto kernel = xr_update_gram<E, KMAX>;
  const size_t smem = (coeff_cols<KMAX>(kin) * KMAX + KMAX * kLd) * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<nblocks, kThreads, smem, stream>>>(Alpha, P, X, Z, R, Xn, Rn, part, k, kin, n);
  launch_reduce(part, G, k, nblocks, stream);
  return cudaGetLastError();
}

template <typename E>
int xr_update_gram_entry(const float* Alpha, const E* P, const E* X, const E* Z, const E* R,
                         E* Xn, E* Rn, float* part, float* G, int k, int kin, long long n,
                         int nblocks, int device, cudaStream_t stream) {
  if (nblocks < 1 || n < 1 || kin < k) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
#define BCG_XR(KMAX) \
  return launch<E, KMAX>(Alpha, P, X, Z, R, Xn, Rn, part, G, k, kin, n, nblocks, stream)
  switch (kmax_for(k)) {
    case 8: BCG_XR(8);
    case 16: BCG_XR(16);
    case 32: BCG_XR(32);
    case 64: BCG_XR(64);
    default: return cudaErrorInvalidValue;
  }
#undef BCG_XR
}

}  // namespace

// Xn may equal X and Rn may equal R.
extern "C" int bcg_xr_update_gram(const float* Alpha, const float* P,
                                  const float* X, const float* Z,
                                  const float* R, float* Xn, float* Rn,
                                  float* part, float* G, int k, int kin, long long n,
                                  int nblocks, int device, cudaStream_t stream) {
  return xr_update_gram_entry(Alpha, P, X, Z, R, Xn, Rn, part, G, k, kin, n, nblocks, device,
                              stream);
}

// The same on bf16 fields; alpha stays f32, and G is the f32 Gram of the
// stored bf16 Rn.
extern "C" int bcg_xr_update_gram_bf16(const float* Alpha, const bf16* P, const bf16* X,
                                       const bf16* Z, const bf16* R, bf16* Xn, bf16* Rn,
                                       float* part, float* G, int k, int kin, long long n,
                                       int nblocks, int device, cudaStream_t stream) {
  return xr_update_gram_entry(Alpha, P, X, Z, R, Xn, Rn, part, G, k, kin, n, nblocks, device,
                              stream);
}
