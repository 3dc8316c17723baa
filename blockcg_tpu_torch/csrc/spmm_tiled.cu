// General-sparsity SpMM over dense T x T tiles (T = 128):
//   Y[:, rt*T:(rt+1)*T] = sum over the row tile's tiles of X[:, ct*T:(ct+1)*T] A_tile^T
// on lanes-major (k, n) float32 fields, tiles stored as float32 or bfloat16.
//
// Replaces the Pallas kernel blockcg_tpu/ops/spmm_tiled.py tiled_spmm_t.
//
// Contract: tiles (ntiles, T, T) sorted by row tile, ct/first int32
// (ntiles,); first[t] == 1 resets the row tile's sum at tile t. row_ptr
// (nrt + 1) int32 holds each row tile's first tile. A row tile with no tile
// gets zeros. bf16 tiles are widened to f32 before the f32 FMA, against f32
// X, as the reference upcasts in VMEM; the sum is a full-precision f32 dot.
//
// Bound: at k = 32 on the [sparse] tiles an f32 tile run moves 4.1 GB of
// tiles (1.22 ms at 3.35 TB/s) for 65.75 GFLOP (0.98 ms at the f32 rate):
// bytes, with the FMAs close behind; bf16 tiles halve the bytes and leave
// the FMAs as the bound. So the FMAs must overlap the copies, and the
// inner loop must issue FMAs faster than shared loads. The kernel this
// replaced (one block a row tile; each tile and X block staged between two
// barriers with 4-byte loads, no overlap; per j, 4 scalar tile loads and
// KMAX / 8 broadcast X loads for 4 KMAX / 8 FMAs: twice as many shared
// wavefronts as FMA issue clocks; KMAX = 128 at k = 96) ran at 32% of the
// bound.
//
// Schedule (ops/spmm_tiled.py tiled_plan, computed once on the host and
// kept by the operator): a persistent grid; block b sums the row tiles
// bptr[b] .. bptr[b+1] - 1, each by itself and in storage order, so there
// are no atomics and a repeated call gives the same bits. The plan cuts the
// row tiles into one contiguous range a block of about equal tile counts
// (balanced to a row tile). The other order measured gave each block
// several ranges, range w grid + b to block b, so that the blocks running
// together work on neighbouring row tiles, whose column tiles of X overlap
// and come from L2; but each range's cut adds up to a row tile of
// imbalance. On the [sparse] tiles at k = 32 (H100,
// tools/torch_kernel_times.py --variants, three stages) contiguous ranges
// ran 2.204 ms, 2, 4 and 16 interleaved ranges a block 2.243, 2.399 and
// 3.276 ms: the balance counts more than X's reuse.
//
// Pipeline: a block streams its tiles as slices of J columns: A[:, j0:j0+J]
// (128 x J) and X[:k, ct*T + j0 : + J] (k x J), through a ring of `stages`
// shared-memory buffers filled with 16-byte cp.async (bf16 tiles copied raw
// and widened after the shared read: half the copied bytes). The slices of
// the next tile of the row tile, and of the next row tile, flow through the
// same ring, so their copies overlap this slice's FMAs; one barrier a
// slice. The plan takes J = 32 and two stages (five blocks an SM at k = 32:
// 1.99 ms against 2.20 with three stages and three blocks), or J = 16 and
// three stages where that fits two blocks an SM and J = 32 one (k = 96:
// 5.85 ms against 6.52).
//
// Register tile: warp w owns rows w*R .. w*R+R-1 of X and Y (R = 8 from k =
// 8; the block has ceil(k / R) warps, so k = 96 runs 12 warps, not 16), lane
// l owns output columns l + 32 c (c < 4). For each 4 j's a thread reads 4
// float4 of A's rows (A[i, j:j+4] is contiguous; the row pitch is J + 4
// floats, an odd number of 16-byte chunks, so a quarter warp's float4s hit
// distinct banks) and R broadcast float4 of X, and does 16 R FMAs: at R = 8,
// 24 shared wavefronts a warp against 32 FMA issue clocks. bf16: 4 16-byte
// reads of 8 entries each per 8 j's (pitch J + 8), widened in registers.
//
// Arithmetic: per output, fmaf over the row tile's tiles in storage order
// and j ascending inside a tile, restarting at the row tile's first tile
// and wherever first[t] is set: the order of the kernel this replaced, so Y
// keeps its bits.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kT = 128;           // tile side
constexpr int kCols = 4;          // output columns a lane owns: lane + 32 c
constexpr int kMaxThreads = 512;  // 16 warps of 8 rows: k = 128

// Staged row pitch of a slice of A, in tile entries of tb bytes: J plus one
// 16-byte chunk (an odd number of chunks a row).
__host__ __device__ constexpr int a_pitch(int J, int tb) { return J + 16 / tb; }

// Bytes of one ring stage: the (128, J) slice of A at its pitch and the
// (kp, J) slice of X, kp = warps x R rows. Mirrored by ops/spmm_tiled.py
// stage_bytes.
__host__ __device__ constexpr int stage_bytes(int J, int kp, int tb) {
  return kT * a_pitch(J, tb) * tb + kp * J * 4;
}

// A block's position in its schedule: row tile rt (tiles t0 .. t1 - 1) of
// the block's range rt .. end - 1, tile t, slice j.
struct TileCursor {
  int rt, end, t0, t1, t, j;

  // To the first row tile with a tile at or after rt (rt == end: done).
  __device__ void seek(const int* row_ptr) {
    for (; rt < end; ++rt) {
      t0 = row_ptr[rt];
      t1 = row_ptr[rt + 1];
      if (t0 < t1) {
        t = t0;
        j = 0;
        return;
      }
    }
  }

  __device__ void next(int nsl, const int* row_ptr) {
    if (++j < nsl) return;
    j = 0;
    if (++t < t1) return;
    ++rt;
    seek(row_ptr);
  }
};

// Copy the slice at `at` into stage st and commit it as one cp.async group
// (empty past the block's last slice, so the wait counts stay uniform). X
// rows k .. kp-1 are zero-filled. xvec: 16-byte copies of X (X 16-byte
// aligned; n is a multiple of 128), else 4-byte copies on the same schedule.
template <int J, typename TT>
__device__ __forceinline__ void load_slice(unsigned char* st, const TT* tiles, const int* ct,
                                           const float* X, int k, int kp, long long n,
                                           const TileCursor& at, bool xvec) {
  if (at.rt < at.end) {
    constexpr int per = 16 / static_cast<int>(sizeof(TT));  // entries a 16-byte chunk
    constexpr int ch = J / per;                              // chunks a row of the slice
    constexpr int pa = a_pitch(J, sizeof(TT));
    TT* sA = reinterpret_cast<TT*>(st);
    float* sX = reinterpret_cast<float*>(st + kT * pa * sizeof(TT));
    const TT* tile = tiles + static_cast<long long>(at.t) * kT * kT + at.j * J;
    for (int e = threadIdx.x; e < kT * ch; e += blockDim.x) {
      const int i = e / ch, q = (e % ch) * per;
      cp_async16(reinterpret_cast<float*>(sA + i * pa + q),
                 reinterpret_cast<const float*>(tile + i * kT + q), true);
    }
    const float* xb = X + static_cast<long long>(ct[at.t]) * kT + at.j * J;
    if (xvec) {
      for (int e = threadIdx.x; e < kp * (J / 4); e += blockDim.x) {
        const int r = e / (J / 4), q = 4 * (e % (J / 4));
        cp_async16(sX + r * J + q, r < k ? xb + r * n + q : X, r < k);
      }
    } else {
      for (int e = threadIdx.x; e < kp * J; e += blockDim.x) {
        const int r = e / J, q = e % J;
        cp_async4(sX + r * J + q, r < k ? xb + r * n + q : X, r < k);
      }
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  if (pending <= 0) cp_async_wait<0>();
  else if (pending == 1) cp_async_wait<1>();
  else cp_async_wait<2>();
}

__device__ __forceinline__ void fma4(float (&acc)[kCols], int c, const float4& x, float a0,
                                     float a1, float a2, float a3) {
  float v = acc[c];
  v = fmaf(x.x, a0, v);
  v = fmaf(x.y, a1, v);
  v = fmaf(x.z, a2, v);
  v = fmaf(x.w, a3, v);
  acc[c] = v;
}

// acc[b][c] += sum over the slice's j of X[r0 + b, j] A[lane + 32 c, j].
template <int R, int J>
__device__ __forceinline__ void slice_fma(float (&acc)[R][kCols], const float* sA,
                                          const float* sX, int r0, int lane) {
  constexpr int pa = a_pitch(J, 4);
#pragma unroll
  for (int j = 0; j < J; j += 4) {
    float4 a[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      a[c] = *reinterpret_cast<const float4*>(sA + (lane + 32 * c) * pa + j);
#pragma unroll
    for (int b = 0; b < R; ++b) {
      const float4 x = *reinterpret_cast<const float4*>(sX + (r0 + b) * J + j);
#pragma unroll
      for (int c = 0; c < kCols; ++c) fma4(acc[b], c, x, a[c].x, a[c].y, a[c].z, a[c].w);
    }
  }
}

// The same on bf16 tiles: 16-byte reads of 8 entries, widened exactly (a
// bf16 is the high half of its f32).
template <int R, int J>
__device__ __forceinline__ void slice_fma(float (&acc)[R][kCols], const __nv_bfloat16* sA,
                                          const float* sX, int r0, int lane) {
  constexpr int pa = a_pitch(J, 2);
#pragma unroll
  for (int j = 0; j < J; j += 8) {
    uint4 raw[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      raw[c] = *reinterpret_cast<const uint4*>(sA + (lane + 32 * c) * pa + j);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const float4 x = *reinterpret_cast<const float4*>(sX + (r0 + b) * J + j + 4 * h);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const unsigned w0 = h ? raw[c].z : raw[c].x, w1 = h ? raw[c].w : raw[c].y;
          fma4(acc[b], c, x, __uint_as_float(w0 << 16), __uint_as_float(w0 & 0xffff0000u),
               __uint_as_float(w1 << 16), __uint_as_float(w1 & 0xffff0000u));
        }
      }
    }
  }
}

template <int R, int J, typename TT>
__global__ void __launch_bounds__(kMaxThreads)
    tiled_spmm(const TT* __restrict__ tiles, const int* __restrict__ row_ptr,
               const int* __restrict__ ct, const int* __restrict__ first,
               const int* __restrict__ bptr, const float* __restrict__ X,
               float* __restrict__ Y, int k, long long n, int stages, bool xvec) {
  extern __shared__ __align__(16) unsigned char smem[];  // `stages` ring stages
  constexpr int nsl = kT / J;
  const int kp = blockDim.x / 32 * R;
  const int sbytes = stage_bytes(J, kp, sizeof(TT));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * R;
  const int begin = bptr[blockIdx.x], end = bptr[blockIdx.x + 1];
  for (int rt = begin; rt < end; ++rt) {  // the block's row tiles with no tile: zeros
    if (row_ptr[rt] == row_ptr[rt + 1])
      for (int e = threadIdx.x; e < k * kT; e += blockDim.x)
        Y[(e / kT) * n + static_cast<long long>(rt) * kT + e % kT] = 0.f;
  }
  TileCursor cur{begin, end, 0, 0, 0, 0};
  cur.seek(row_ptr);
  TileCursor ahead = cur;
  for (int s = 0; s < stages - 1; ++s) {
    load_slice<J, TT>(smem + s * sbytes, tiles, ct, X, k, kp, n, ahead, xvec);
    if (ahead.rt < end) ahead.next(nsl, row_ptr);
  }
  float acc[R][kCols];
  int buf = 0;
  while (cur.rt < end) {
    cp_async_wait_upto(stages - 2);  // this slice's copy has landed
    __syncthreads();  // ... for every thread's share; the previous slice's reads are done
    load_slice<J, TT>(smem + (buf == 0 ? stages - 1 : buf - 1) * sbytes, tiles, ct, X, k, kp,
                      n, ahead, xvec);
    if (ahead.rt < end) ahead.next(nsl, row_ptr);
    if (cur.j == 0 && (cur.t == cur.t0 || first[cur.t])) {
#pragma unroll
      for (int b = 0; b < R; ++b)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[b][c] = 0.f;
    }
    const unsigned char* st = smem + buf * sbytes;
    slice_fma<R, J>(acc, reinterpret_cast<const TT*>(st),
                    reinterpret_cast<const float*>(st + kT * a_pitch(J, sizeof(TT)) * sizeof(TT)),
                    r0, lane);
    if (cur.j == nsl - 1 && cur.t + 1 == cur.t1) {  // the row tile's last slice: store Y
      float* yb = Y + static_cast<long long>(cur.rt) * kT + lane;
#pragma unroll
      for (int b = 0; b < R; ++b)
        if (r0 + b < k)
#pragma unroll
          for (int c = 0; c < kCols; ++c) yb[(r0 + b) * n + 32 * c] = acc[b][c];
    }
    cur.next(nsl, row_ptr);
    buf = buf + 1 == stages ? 0 : buf + 1;
  }
  cp_async_wait<0>();
}

template <typename TT>
using TiledKernel = void (*)(const TT*, const int*, const int*, const int*, const int*,
                             const float*, float*, int, long long, int, bool);

// The build of (R, J), or nullptr (ops/spmm_tiled.py BUILT).
template <typename TT>
TiledKernel<TT> kernel_for(int R, int J) {
#define BCG_TS(RR, JJ) \
  if (R == RR && J == JJ) return tiled_spmm<RR, JJ, TT>;
  BCG_TS(8, 32);
  BCG_TS(8, 16);
  BCG_TS(4, 32);
  BCG_TS(2, 32);
  BCG_TS(1, 32);
#undef BCG_TS
  return nullptr;
}

// The kernel of a launch of k rows at (J, stages, R), its threads and shared
// bytes, with the shared-memory cap raised to them.
template <typename TT>
cudaError_t prepare(int k, int J, int stages, int R, TiledKernel<TT>* kernel, int* threads,
                    size_t* smem) {
  *kernel = kernel_for<TT>(R, J);
  if (*kernel == nullptr) return cudaErrorInvalidValue;
  const int warps = (k + R - 1) / R;
  *threads = 32 * warps;
  *smem = static_cast<size_t>(stages) * stage_bytes(J, warps * R, sizeof(TT));
  return allow_smem(*kernel, *smem);
}

template <typename TT>
cudaError_t launch(const void* tiles, const int* row_ptr, const int* ct, const int* first,
                   const int* bptr, int grid, const float* X, float* Y, int k, long long n,
                   int J, int stages, int R, cudaStream_t stream) {
  TiledKernel<TT> kernel;
  int threads;
  size_t smem;
  cudaError_t err = prepare<TT>(k, J, stages, R, &kernel, &threads, &smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(static_cast<const TT*>(tiles), row_ptr, ct, first,
                                          bptr, X, Y, k, n, stages, aligned16(X));
  return cudaGetLastError();
}

template <typename TT>
cudaError_t blocks_per_sm(int k, int J, int stages, int R, int* blocks) {
  TiledKernel<TT> kernel;
  int threads;
  size_t smem;
  cudaError_t err = prepare<TT>(k, J, stages, R, &kernel, &threads, &smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

bool bad_args(int k, int stages, int R) {
  return k < 1 || k > 128 || stages < 2 || stages > 4 || R < 1 ||
         (k + R - 1) / R > kMaxThreads / 32;
}

}  // namespace

// tiles: device (ntiles, 128, 128), float32 (bf16 == 0) or bfloat16 (bf16 !=
// 0), 16-byte aligned. row_ptr: device (nrt + 1) int32; ct, first: device
// (ntiles) int32; bptr (grid + 1): the plan's ranges of row tiles, one a
// block (ops/spmm_tiled.py tiled_plan). X, Y: device (k, n) float32 row
// chunks with row stride n = nrt * 128 (1 <= k <= 128); Y is written in
// full. J: slice width (16 or 32; 32 at R < 8), stages: ring depth (2 to 4),
// R: rows of X a warp owns (1, 2, 4 or 8; ceil(k / R) <= 16 warps).
extern "C" int bcg_tiled_spmm(const void* tiles, int bf16, const int* row_ptr, const int* ct,
                              const int* first, const int* bptr, int grid, const float* X,
                              float* Y, int k, int nrt, long long n, int J, int stages, int R,
                              int device, cudaStream_t stream) {
  if (bad_args(k, stages, R) || nrt < 1 || n != static_cast<long long>(nrt) * kT || grid < 1)
    return cudaErrorInvalidValue;
  if (!aligned16(tiles)) return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return bf16 ? launch<__nv_bfloat16>(tiles, row_ptr, ct, first, bptr, grid, X, Y, k, n, J,
                                      stages, R, stream)
              : launch<float>(tiles, row_ptr, ct, first, bptr, grid, X, Y, k, n, J, stages, R,
                              stream);
}

// Blocks of a launch of k rows at (J, stages, R) that one SM holds at once
// (the occupancy of the build: registers, threads and shared memory), or a
// negative CUDA error (ops/spmm_tiled.py tiled_plan sizes the grid by it).
extern "C" int bcg_tiled_spmm_blocks_per_sm(int bf16, int k, int J, int stages, int R,
                                            int device) {
  if (bad_args(k, stages, R)) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  int blocks = 0;
  if (err == cudaSuccess)
    err = bf16 ? blocks_per_sm<__nv_bfloat16>(k, J, stages, R, &blocks)
               : blocks_per_sm<float>(k, J, stages, R, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
