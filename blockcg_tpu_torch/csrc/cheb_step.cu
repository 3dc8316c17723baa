// One step of the Chebyshev semi-iteration, in one pass over the fields.
//
// Replaces the Pallas kernel blockcg_tpu/ops/fused.py cheb_step (:670).
//
// Contract: on four float32 fields of n elements each (any contiguous
// layout: flat (k, n) or merged (m, ns); the update is elementwise),
//   D'[e] = c1 * D[e] + c2 * (R[e] - AZ[e]),   Z'[e] = Z[e] + D'[e].
// Zo and Do may be Z and D themselves (the in-place update of the
// reference's input_output_aliases): each element is read and then written by
// one thread and by no other, so the update is safe in place. Zo and Do must
// not share storage; the inputs may (the first step reads Z and D from one
// buffer).
//
// The arithmetic is the plain composition's, rounding after every operation
// (__fmul_rn, __fsub_rn, __fadd_rn: no contraction into FMAs), so the kernel
// gives the same bits as the plain PyTorch version on the same f32 scalars.
//
// Bound: bytes. Four fields read and two written, 24 bytes per element: at
// (32, 2,097,152) 1.61 GB, 0.48 ms at the H100's 3.35 TB/s; four FLOPs per
// element are nothing beside it. The design is the plain streaming one:
// 16-byte float4 loads and stores (neighbouring threads on neighbouring
// 16-byte words) when every pointer is 16-byte aligned, a grid-stride loop
// over enough blocks to fill every SM, and a scalar loop for the tail.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStepThreads = 256;
constexpr int kStepMaxBlocks = 132 * 8;  // 8 blocks of 256 threads per SM

__device__ __forceinline__ void step1(float r, float z, float d, float az,
                                      float c1, float c2, float& zn, float& dn) {
  dn = __fadd_rn(__fmul_rn(c1, d), __fmul_rn(c2, __fsub_rn(r, az)));
  zn = __fadd_rn(z, dn);
}

__global__ void __launch_bounds__(kStepThreads)
    cheb_step_vec(const float4* R, const float4* Z, const float4* D,
                  const float4* AZ, float4* Zo, float4* Do, float c1, float c2,
                  long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < n4; e += stride) {
    const float4 r = R[e], z = Z[e], d = D[e], az = AZ[e];
    float4 zn, dn;
    step1(r.x, z.x, d.x, az.x, c1, c2, zn.x, dn.x);
    step1(r.y, z.y, d.y, az.y, c1, c2, zn.y, dn.y);
    step1(r.z, z.z, d.z, az.z, c1, c2, zn.z, dn.z);
    step1(r.w, z.w, d.w, az.w, c1, c2, zn.w, dn.w);
    Do[e] = dn;
    Zo[e] = zn;
  }
}

// Elements [begin, n), one per thread.
__global__ void __launch_bounds__(kStepThreads)
    cheb_step_scalar(const float* R, const float* Z, const float* D,
                     const float* AZ, float* Zo, float* Do, float c1, float c2,
                     long long begin, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = begin + blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < n; e += stride) {
    float zn, dn;
    step1(R[e], Z[e], D[e], AZ[e], c1, c2, zn, dn);
    Do[e] = dn;
    Zo[e] = zn;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

int grid_for(long long items) {
  const long long b = (items + kStepThreads - 1) / kStepThreads;
  return static_cast<int>(b < kStepMaxBlocks ? b : kStepMaxBlocks);
}

}  // namespace

// R, Z, D, AZ, Zo, Do: device float32 arrays of n elements; Zo/Do may be
// Z/D (in place), but not each other.
extern "C" int bcg_cheb_step(const float* R, const float* Z, const float* D,
                             const float* AZ, float* Zo, float* Do, float c1,
                             float c2, long long n, int device,
                             cudaStream_t stream) {
  if (n < 1 || Zo == Do) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool vec = aligned16(R) && aligned16(Z) && aligned16(D) && aligned16(AZ) &&
                   aligned16(Zo) && aligned16(Do);
  const long long n4 = vec ? n / 4 : 0;
  if (n4 > 0)
    cheb_step_vec<<<grid_for(n4), kStepThreads, 0, stream>>>(
        reinterpret_cast<const float4*>(R), reinterpret_cast<const float4*>(Z),
        reinterpret_cast<const float4*>(D), reinterpret_cast<const float4*>(AZ),
        reinterpret_cast<float4*>(Zo), reinterpret_cast<float4*>(Do), c1, c2, n4);
  if (4 * n4 < n)
    cheb_step_scalar<<<grid_for(n - 4 * n4), kStepThreads, 0, stream>>>(
        R, Z, D, AZ, Zo, Do, c1, c2, 4 * n4, n);
  return cudaGetLastError();
}
