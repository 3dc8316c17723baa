// Gram G = U V^T of two lanes-major fields, U (ku, n) and V (kv, n), each
// at most 64 rows: the square Gram of a (k, n) pair, or one block of a wider
// Gram, which the Python wrapper tiles into such launches.
//
// Replaces the Pallas kernel blockcg_tpu/ops/fused.py gram (the optional
// `seed` operand is not part of the port's contract: it only stopped XLA
// hoisting timing loops).
//
// Bound: bytes, two field reads and a k x k output. The TPU kernel carried the
// sum across sequential grid steps; CUDA blocks run in no order, so each block
// keeps a register tile of its partial (GramTile) over a grid-stride walk of
// 128-column tiles staged in shared memory, writes one (k, k) partial, and a
// second kernel sums the partials in a fixed order (no atomics), which makes
// repeated calls bitwise identical.
#include "common.cuh"

namespace {

template <int KMAX>
__global__ void __launch_bounds__(kThreads)
    gram_kernel(const float* __restrict__ U, const float* __restrict__ V,
                float* __restrict__ part, int ku, int kv, long long n) {
  extern __shared__ __align__(16) float smem[];  // us | vs
  GramTile<KMAX> g;
  const long long ntiles = (n + kThreads - 1) / kThreads;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long i = t * kThreads + threadIdx.x;
    const bool valid = i < n;
    float u[KMAX], v[KMAX];
    load_col<KMAX>(u, U, ku, n, i, valid);
    load_col<KMAX>(v, V, kv, n, i, valid);
    __syncthreads();
    stage_col<KMAX>(smem, u);
    stage_col<KMAX>(smem + KMAX * kLd, v);
    __syncthreads();
    g.accumulate(smem, smem + KMAX * kLd);
  }
  g.store(part + static_cast<long long>(blockIdx.x) * ku * kv, ku, kv);
}

template <int KMAX>
cudaError_t launch(const float* U, const float* V, float* part, float* G,
                   int ku, int kv, long long n, int nblocks, cudaStream_t stream) {
  auto kernel = gram_kernel<KMAX>;
  const size_t smem = 2 * KMAX * kLd * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<nblocks, kThreads, smem, stream>>>(U, V, part, ku, kv, n);
  launch_reduce(part, G, ku, kv, nblocks, stream);
  return cudaGetLastError();
}

}  // namespace

// G (ku, kv) = U V^T; part holds (nblocks, ku, kv).
extern "C" int bcg_gram(const float* U, const float* V, float* part, float* G,
                        int ku, int kv, long long n, int nblocks, int device,
                        cudaStream_t stream) {
  if (nblocks < 1 || n < 1 || ku < 1 || kv < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (kmax_for(ku > kv ? ku : kv)) {
    case 8: return launch<8>(U, V, part, G, ku, kv, n, nblocks, stream);
    case 16: return launch<16>(U, V, part, G, ku, kv, n, nblocks, stream);
    case 32: return launch<32>(U, V, part, G, ku, kv, n, nblocks, stream);
    case 64: return launch<64>(U, V, part, G, ku, kv, n, nblocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* bcg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory one block may opt in to on `device` (the cap that
// allow_smem raises a kernel to), or -1 on a CUDA error.
extern "C" int bcg_max_smem(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}
