// Y = M B (+ A) on lanes-major (k, n) fields, k <= 128, in one launch.
//
// Replaces the Pallas kernel blockcg_tpu/ops/fused.py mm_update. Wider fields
// (k > 128) run row chunks of update_gram.cuh's kernel without its Gram
// (mm_update_gram.cu; ops/fused.py).
//
// Bound: bytes. B is read once and Y written once (A read once too): at
// (32, 2,097,152) that is 537 MB, 0.16 ms at 3.35 TB/s, against 4.3 GFLOP,
// 0.064 ms at the f32 rate. Above k = 64 the arithmetic catches up: at
// (96, 2^20) 19 GFLOP (0.29 ms) against 0.81 GB (0.24 ms). The kernel it
// replaced (one thread a column, scalar loads of B inside the coefficient
// loop, a grid of at most 1,024 blocks of 128 threads, one launch per 64-row
// chunk that read all of B again) kept too few bytes in flight to stream HBM
// and ran at 46% of the bound.
//
// Design: a persistent grid (as many 256-thread blocks as fit on the card)
// walks 128-column tiles. Each block stages M once, transposed into shared
// memory, and copies each (k, 128) tile of B into shared memory with
// cp.async, double-buffered: the next tile's copy is in flight while this
// tile computes. Warp w owns output rows w*R .. w*R+R-1 (R = ceil(k / 8)
// rounded to a built width), lane l owns columns 4l .. 4l+3, so every global
// access is 16 bytes a thread (cp.async of B, float4 loads of A, float4
// stores of Y) and every shared read of B is a conflict-free float4 (the M
// reads are broadcasts). Because warps split the output rows over one staged
// input tile, a field of up to 128 rows reads B once, in one launch. A field
// whose rows are not 16-byte aligned (n % 4 != 0) takes 4-byte copies and
// scalar stores on the same schedule.
//
// Arithmetic: y_r = sum over c = 0..k-1 in order of fmaf(M[r, c], B[c, i], .),
// then + A[r, i]: f32 FMA only, the same order on every call, and the same
// order as update_gram.cuh's (so the row chunks above 128 rows give the
// bits a launch of this kernel would).
//
// bf16 fields (bcg_mm_update_bf16): B's tiles are staged as bf16, 16-byte
// copies of 8 elements (n % 8 == 0), lifted to f32 four at a time as they
// are read; M stays f32; A is read and Y written
// four bf16 at a time. The FMAs and their order are those of the f32 kernel.
//
// In place: Y may be B or A (the solvers' donated operand). A block copies
// its whole input tile into shared memory before it writes the tile's
// columns, reads A[r, i] before it writes Y[r, i] in the same thread, and no
// block reads columns that another block writes; B, A and Y are therefore
// not declared __restrict__.
#include "common.cuh"

namespace {

constexpr int kMmThreads = kUpThreads;  // 8 warps: 8 row groups (common.cuh)
constexpr int kMmTile = kUpTile;        // columns a tile: 32 lanes x 4
constexpr int kMmMaxK = 128;

// Copy the (k, 128) tile of B at column i0 into s (row stride 128); columns
// past n are zero-filled.
template <typename E>
__device__ __forceinline__ void load_tile(E* s, const E* B, int k, long long n, long long i0,
                                          bool vec) {
  constexpr int kv = kVec<E>;
  if (vec) {
    for (int e = threadIdx.x; e < k * (kMmTile / kv); e += kMmThreads) {
      const int c = e / (kMmTile / kv), q = kv * (e % (kMmTile / kv));
      const bool in = i0 + q < n;
      cp_async16(s + c * kMmTile + q, B + (in ? c * n + i0 + q : 0), in);
    }
  } else {
    for (int e = threadIdx.x; e < k * kMmTile; e += kMmThreads) {
      const int c = e / kMmTile, q = e % kMmTile;
      const bool in = i0 + q < n;
      cp_elem(s + c * kMmTile + q, B + (in ? c * n + i0 + q : 0), in);
    }
  }
}

template <typename E, int R, bool HAS_A>
__global__ void __launch_bounds__(kMmThreads)
    mm_update_kernel(const float* __restrict__ M, const E* B, const E* A, E* Y, int k,
                     long long n, bool vec) {
  extern __shared__ __align__(16) float smem[];  // sM (k x 8R) | two (k, 128) tiles of B
  constexpr int kRows = 8 * R;
  float* sM = smem;
  E* sB = reinterpret_cast<E*>(smem + k * kRows);
  const int tile_floats = k * kMmTile;  // elements of a tile
  for (int e = threadIdx.x; e < k * kRows; e += kMmThreads) {
    const int c = e / kRows, r = e % kRows;
    sM[e] = r < k ? M[r * k + c] : 0.f;  // sM[c][r] = M[r, c]
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * R;
  const long long ntiles = (n + kMmTile - 1) / kMmTile;
  long long t = blockIdx.x;
  int buf = 0;
  if (t < ntiles) load_tile(sB, B, k, n, t * kMmTile, vec);
  cp_async_commit();
  for (; t < ntiles; t += gridDim.x) {
    const long long tn = t + gridDim.x;
    if (tn < ntiles) load_tile(sB + (buf ^ 1) * tile_floats, B, k, n, tn * kMmTile, vec);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copy has landed
    __syncthreads();     // ... for every thread's share of it (and sM)
    if (r0 < k) {
      const E* sb = sB + buf * tile_floats + 4 * lane;
      float acc[R][4];
#pragma unroll
      for (int j = 0; j < R; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 2
      for (int c = 0; c < k; ++c) {
        const float4 b = load4(sb + c * kMmTile);
        float m[R];
        load_rows<R>(m, sM + c * kRows + r0);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          acc[j][0] = fmaf(m[j], b.x, acc[j][0]);
          acc[j][1] = fmaf(m[j], b.y, acc[j][1]);
          acc[j][2] = fmaf(m[j], b.z, acc[j][2]);
          acc[j][3] = fmaf(m[j], b.w, acc[j][3]);
        }
      }
      const long long i = t * kMmTile + 4 * lane;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = r0 + j;
        if (r >= k) continue;
        const long long at = r * n + i;
        if (vec && i + 3 < n) {
          float4 y = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
          if constexpr (HAS_A) {
            const float4 a = load4(A + at);
            y.x += a.x; y.y += a.y; y.z += a.z; y.w += a.w;
          }
          store4(Y + at, y);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (i + q < n)
              Y[at + q] = from_f32<E>(HAS_A ? acc[j][q] + to_f32(A[at + q]) : acc[j][q]);
        }
      }
    }
    __syncthreads();  // every read of this buffer is done before it is refilled
    buf ^= 1;
  }
  cp_async_wait<0>();
}

template <typename E, int R, bool HAS_A>
cudaError_t launch(const float* M, const E* B, const E* A, E* Y, int k, long long n,
                   int device, cudaStream_t stream) {
  auto kernel = mm_update_kernel<E, R, HAS_A>;
  const size_t smem = static_cast<size_t>(k) * 8 * R * sizeof(float) +
                      2 * static_cast<size_t>(k) * kMmTile * sizeof(E);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long ntiles = (n + kMmTile - 1) / kMmTile;
  int grid = 0;
  err = persistent_grid(kernel, kMmThreads, smem, device, ntiles, ntiles, &grid);
  if (err != cudaSuccess) return err;
  const bool vec =
      n % kVec<E> == 0 && aligned16(B) && aligned16(Y) && (A == nullptr || aligned16(A));
  kernel<<<grid, kMmThreads, smem, stream>>>(M, B, A, Y, k, n, vec);
  return cudaGetLastError();
}

template <typename E, int R>
cudaError_t dispatch(const float* M, const E* B, const E* A, E* Y, int k, long long n,
                     int device, cudaStream_t stream) {
  return A ? launch<E, R, true>(M, B, A, Y, k, n, device, stream)
           : launch<E, R, false>(M, B, A, Y, k, n, device, stream);
}

template <typename E>
int mm_update_entry(const float* M, const E* B, const E* A, E* Y, int k, long long n,
                    int device, cudaStream_t stream) {
  if (n < 1 || k < 1 || k > kMmMaxK) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (rows_per_warp(k)) {
    case 1: return dispatch<E, 1>(M, B, A, Y, k, n, device, stream);
    case 2: return dispatch<E, 2>(M, B, A, Y, k, n, device, stream);
    case 4: return dispatch<E, 4>(M, B, A, Y, k, n, device, stream);
    case 6: return dispatch<E, 6>(M, B, A, Y, k, n, device, stream);
    case 8: return dispatch<E, 8>(M, B, A, Y, k, n, device, stream);
    case 12: return dispatch<E, 12>(M, B, A, Y, k, n, device, stream);
    case 16: return dispatch<E, 16>(M, B, A, Y, k, n, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// M (k, k) row-major, B, A and Y (k, n); A == nullptr: no additive field. Y
// may equal B or A. 1 <= k <= 128.
extern "C" int bcg_mm_update(const float* M, const float* B, const float* A, float* Y, int k,
                             long long n, int device, cudaStream_t stream) {
  return mm_update_entry(M, B, A, Y, k, n, device, stream);
}

// The same on bf16 fields B, A and Y; M stays f32.
extern "C" int bcg_mm_update_bf16(const float* M, const bf16* B, const bf16* A, bf16* Y, int k,
                                  long long n, int device, cudaStream_t stream) {
  return mm_update_entry(M, B, A, Y, k, n, device, stream);
}
