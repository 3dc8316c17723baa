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
// bf16 fields (bcg_mm_update_bf16, mm_update_mma): on the tensor cores,
// with the f32 coefficient held exactly. At (32, 256^3) B and Y are 2.15 GB,
// 0.641 ms at 3.35 TB/s, against 34.4 GFLOP (0.035 ms at 989 TFLOP/s):
// bytes bind, which f32 FMAs on lifted bf16 would not reach. Rounding M to
// bf16 for the tensor cores stalls bf16 BCG and breaks BCGA down (ROADMAP,
// "The bf16 coefficient rule"), so M is split exactly into three bf16 pieces,
// M = M_hi + M_mid + M_lo (mma.cuh split3), once a block, and each warp
// keeps the A fragments of its output rows in registers (2 x 2 x 3 at
// k = 32). Y = M_hi B + M_mid B + M_lo B runs three mma.sync m16n8k16 an
// output fragment and k-step, every product exact in f32 and summed in
// f32 (103 GFLOP, still under the bytes), hi pieces first (all k-steps),
// then mid, then lo: the same order on every call, but not the plain
// version's f32 FMA chain, so Y may differ from it by one bf16 rounding.
// A ring of `stages` tiles of B (and of A) of T columns is filled by TMA
// tensor copies in 128-byte swizzled boxes of 64 columns (mma.cuh TmaRing),
// so stages - 1 tiles are in flight while one computes; one request a box,
// not one a row, as each request costs the SM time of its own (PERF.md
// section 6 has the timings). B's rows past k stay zero in shared memory;
// its tile is K-major along rows, so ldmatrix.trans gives the B operand. Up to 32
// rows every warp owns all output rows over its own 16-column steps;
// above, the warps split the output row tiles (one 16-row tile a warp at 64
// and 128 rows). Each fragment adds A from the staged tile in f32 and is
// rounded once into a bf16 tile of Y, which the block writes in 16-byte
// stores of 8 bf16; up to 64 rows two blocks share an SM, so one block's
// stores overlap the other's products. A ragged n (n % 8 != 0) or an
// unaligned field takes element copies into the same stages and scalar
// stores.
//
// In place: Y may be B or A (the solvers' donated operand). A block copies
// its whole input tile into shared memory before it writes the tile's
// columns, reads A[r, i] before it writes Y[r, i] in the same thread, and no
// block reads columns that another block writes; B, A and Y are therefore
// not declared __restrict__.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kMmThreads = kUpThreads;  // 8 warps: 8 row groups (common.cuh)
constexpr int kMmTile = kUpTile;        // columns a tile: 32 lanes x 4
constexpr int kMmMaxK = 128;

// Copy the (k, 128) tile of B at column i0 into s (row stride 128); columns
// past n are zero-filled.
__device__ __forceinline__ void load_tile(float* s, const float* B, int k, long long n,
                                          long long i0, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < k * (kMmTile / 4); e += kMmThreads) {
      const int c = e / (kMmTile / 4), q = 4 * (e % (kMmTile / 4));
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

template <int R, bool HAS_A>
__global__ void __launch_bounds__(kMmThreads)
    mm_update_kernel(const float* __restrict__ M, const float* B, const float* A, float* Y,
                     int k, long long n, bool vec) {
  extern __shared__ __align__(16) float smem[];  // sM (k x 8R) | two (k, 128) tiles of B
  constexpr int kRows = 8 * R;
  float* sM = smem;
  float* sB = smem + k * kRows;
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
      const float* sb = sB + buf * tile_floats + 4 * lane;
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
              Y[at + q] = HAS_A ? acc[j][q] + A[at + q] : acc[j][q];
        }
      }
    }
    __syncthreads();  // every read of this buffer is done before it is refilled
    buf ^= 1;
  }
  cp_async_wait<0>();
}

template <int R, bool HAS_A>
cudaError_t launch(const float* M, const float* B, const float* A, float* Y, int k, long long n,
                   int device, cudaStream_t stream) {
  auto kernel = mm_update_kernel<R, HAS_A>;
  const size_t smem = static_cast<size_t>(k) * 8 * R * sizeof(float) +
                      2 * static_cast<size_t>(k) * kMmTile * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long ntiles = (n + kMmTile - 1) / kMmTile;
  int grid = 0;
  err = persistent_grid(kernel, kMmThreads, smem, device, ntiles, ntiles, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = n % 4 == 0 && aligned16(B) && aligned16(Y) && (A == nullptr || aligned16(A));
  kernel<<<grid, kMmThreads, smem, stream>>>(M, B, A, Y, k, n, vec);
  return cudaGetLastError();
}

template <int R>
cudaError_t dispatch(const float* M, const float* B, const float* A, float* Y, int k,
                     long long n, int device, cudaStream_t stream) {
  return A ? launch<R, true>(M, B, A, Y, k, n, device, stream)
           : launch<R, false>(M, B, A, Y, k, n, device, stream);
}

// ---- bf16 fields on the tensor cores (bcg_mm_update_bf16)

// How the 8 warps share a launch of width W (k padded to 16, 32, 64 or
// 128): MT = W / 16 output row tiles and k-steps; RG groups of MW row
// tiles, each group's CG = 8 / RG warps taking every CG-th pair of 8-column
// fragments of a tile.
template <int W>
struct MmaUpdate {
  static constexpr int MT = W / 16;
  static constexpr int RG = W <= 32 ? 1 : MT;
  static constexpr int MW = MT / RG;
  static constexpr int CG = 8 / RG;
};

// Shared bytes of a launch: `stages` tiles of B (W rows, the rows past k
// zero) and, with A, of A (k rows), the bf16 (k, T) tile of Y, all in
// swizzled boxes (mma.cuh), and 1 KB to align them; mirrored by
// ops/fused.py mm_update_mma_smem_bytes.
__host__ __device__ inline long long mm_mma_smem_bytes(int k, int W, int T, int stages,
                                                       bool has_a) {
  return 2LL * T * (stages * (W + (has_a ? round8(k) : 0)) + round8(k)) + 1024;
}

// Blocks an SM: two up to 64 rows, so one block's epilogue overlaps the
// other's products; one at 128 rows, whose 96 registers of A fragments a
// thread leave room for one; mirrored by ops/fused.py mm_mma_blocks_per_sm.
template <int W>
constexpr int kMmMmaBlocks = W <= 64 ? 2 : 1;

// tb, ta: the tensor maps of B and A (vec; unused otherwise).
template <int W>
__global__ void __launch_bounds__(kMmThreads, kMmMmaBlocks<W>)
    mm_update_mma(const __grid_constant__ CUtensorMap tb, const __grid_constant__ CUtensorMap ta,
                  const float* __restrict__ M, const bf16* B, const bf16* A, bf16* Y, int k,
                  long long n, int T, int stages, bool vec) {
  using S = MmaUpdate<W>;
  constexpr int KT = S::MT;
  extern __shared__ __align__(16) float smem[];  // stages of [B; A] | the tile of Y
  __shared__ unsigned long long full[kRingMaxStages];
  char* base = align1k(smem);
  const bool has_a = A != nullptr;
  const int r8 = round8(k);
  const int bbytes = 2 * T * W, stage = bbytes + (has_a ? 2 * T * r8 : 0);
  char* ys = base + stages * stage;  // the bf16 tile of Y, boxes of r8 rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int rg = warp / S::CG, cg = warp % S::CG;
  // The A fragments of this warp's row tiles: a[i][ks][piece], M's rows
  // and columns past k zero.
  unsigned a[S::MW][KT][3][4];
#pragma unroll
  for (int i = 0; i < S::MW; ++i)
#pragma unroll
    for (int ks = 0; ks < KT; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * (rg * S::MW + i) + g + 8 * (e & 1);
        const int c = 16 * ks + 2 * tq + 8 * (e >> 1);
        bf16 x0[3], x1[3];  // the pieces of M[r, c] and M[r, c + 1]
        split3(r < k && c < k ? M[r * k + c] : 0.f, x0);
        split3(r < k && c + 1 < k ? M[r * k + c + 1] : 0.f, x1);
#pragma unroll
        for (int piece = 0; piece < 3; ++piece)
          a[i][ks][piece][e] = pack_bf16(x0[piece], x1[piece]);
      }
  // Rows k .. W-1 of every stage's B stay zero: their products meet M's
  // zero columns.
  for (int e = threadIdx.x; e < stages * (W - k) * T; e += kMmThreads) {
    const int s = e / ((W - k) * T), x = e % ((W - k) * T);
    *reinterpret_cast<bf16*>(base + s * stage + swz(k + x / T, x % T, W)) =
        __float2bfloat16_rn(0.f);
  }
  const TmaRing ring{full, stages, (n + T - 1) / T};
  const auto load = [&](int s, long long t) {  // stage s takes the tiles t of B and A by TMA
    char* sb = base + s * stage;
    tma_post(&full[s], has_a ? 2 * k : k, T);
    tma_tile(sb, &tb, W, t * T, T, &full[s]);
    if (has_a) tma_tile(sb + bbytes, &ta, r8, t * T, T, &full[s]);
  };
  ring.init();
  __syncthreads();  // the barriers, and the zero rows
  if (vec) ring.prime(load);
  // ldmatrix.trans rows of this lane: (k 0-7, columns 0-7), (k 8-15,
  // columns 0-7), (k 0-7, columns 8-15), (k 8-15, columns 8-15) of a
  // 16-column pair of fragments.
  const int brow = (lane & 7) + 8 * ((lane >> 3) & 1), bcol = 8 * (lane >> 4);
  for (long long j = 0, t = blockIdx.x; t < ring.ntiles; ++j, t += gridDim.x) {
    char* sb = base + ring.stage(j) * stage;
    if (vec) {
      ring.wait(j);
    } else {  // element copies into the same stage
      elem_tile(sb, B, k, W, n, t * T, T);
      if (has_a) elem_tile(sb + bbytes, A, k, r8, n, t * T, T);
    }
    // Every thread is done with the last tile (its stage and the tile of Y).
    __syncthreads();
    if (vec && j > 0) ring.refill(j - 1, load);
    const char* sa = sb + bbytes;
    for (int pair = cg; pair < T / 16; pair += S::CG) {
      unsigned b[KT][4];  // b[ks]: fragment 2 pair (k 0-7, 8-15), then 2 pair + 1
#pragma unroll
      for (int ks = 0; ks < KT; ++ks)
        ldsm_x4_trans(b[ks], sb + swz(16 * ks + brow, 16 * pair + bcol, W));
      float acc[S::MW][2][4] = {};
#pragma unroll
      for (int piece = 0; piece < 3; ++piece)
#pragma unroll
        for (int ks = 0; ks < KT; ++ks)
#pragma unroll
          for (int i = 0; i < S::MW; ++i) {
            mma_bf16(acc[i][0], a[i][ks][piece], b[ks][0], b[ks][1]);
            mma_bf16(acc[i][1], a[i][ks][piece], b[ks][2], b[ks][3]);
          }
      // + A in f32, rounded once into the tile of Y.
#pragma unroll
      for (int i = 0; i < S::MW; ++i)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * (rg * S::MW + i) + g + 8 * h, c = 16 * pair + 8 * f + 2 * tq;
            if (r >= k) continue;
            float2 y = make_float2(acc[i][f][2 * h], acc[i][f][2 * h + 1]);
            if (has_a) {
              const float2 av =
                  __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sa + swz(r, c, r8)));
              y.x += av.x;
              y.y += av.y;
            }
            *reinterpret_cast<__nv_bfloat162*>(ys + swz(r, c, r8)) = __floats2bfloat162_rn(y.x, y.y);
          }
    }
    __syncthreads();  // the tile of Y is complete
    // Y out, 8 columns (16 bytes) a thread.
    const long long i0 = t * T;
    const int chunks = T / 8;
    for (int e = threadIdx.x; e < k * chunks; e += kMmThreads) {
      const int r = e / chunks, c = 8 * (e % chunks);
      const long long i = i0 + c;
      if (i >= n) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(ys + swz(r, c, r8));
      bf16* out = Y + r * n + i;
      if (vec) {
        *reinterpret_cast<uint4*>(out) = v;
      } else {
        const bf16* w = reinterpret_cast<const bf16*>(&v);
        for (int q = 0; q < 8 && i + q < n; ++q) out[q] = w[q];
      }
    }
  }
}

template <int W>
cudaError_t launch_mma(const float* M, const bf16* B, const bf16* A, bf16* Y, int k, long long n,
                       int T, int stages, int device, cudaStream_t stream) {
  auto kernel = mm_update_mma<W>;
  const size_t smem = mm_mma_smem_bytes(k, W, T, stages, A != nullptr);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long ntiles = (n + T - 1) / T;
  int grid = 0;
  err = persistent_grid(kernel, kMmThreads, smem, device, ntiles, ntiles, &grid);
  if (err != cudaSuccess) return err;
  const bool vec = tma_ok(B, n) && aligned16(Y) && (A == nullptr || tma_ok(A, n));
  CUtensorMap tb{}, ta{};
  if (vec) {
    err = make_tmap(&tb, B, n, k);
    if (err == cudaSuccess && A != nullptr) err = make_tmap(&ta, A, n, k);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kMmThreads, smem, stream>>>(tb, ta, M, B, A, Y, k, n, T, stages, vec);
  return cudaGetLastError();
}

// The padded width of a launch of k rows; mirrored by ops/fused.py
// MM_MMA_WIDTHS.
inline int mm_mma_width(int k) {
  static const int widths[] = {16, 32, 64, 128};
  for (int w : widths)
    if (k <= w) return w;
  return 0;
}

}  // namespace

// M (k, k) row-major, B, A and Y (k, n); A == nullptr: no additive field. Y
// may equal B or A. 1 <= k <= 128.
extern "C" int bcg_mm_update(const float* M, const float* B, const float* A, float* Y, int k,
                             long long n, int device, cudaStream_t stream) {
  if (n < 1 || k < 1 || k > kMmMaxK) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (rows_per_warp(k)) {
    case 1: return dispatch<1>(M, B, A, Y, k, n, device, stream);
    case 2: return dispatch<2>(M, B, A, Y, k, n, device, stream);
    case 4: return dispatch<4>(M, B, A, Y, k, n, device, stream);
    case 6: return dispatch<6>(M, B, A, Y, k, n, device, stream);
    case 8: return dispatch<8>(M, B, A, Y, k, n, device, stream);
    case 12: return dispatch<12>(M, B, A, Y, k, n, device, stream);
    case 16: return dispatch<16>(M, B, A, Y, k, n, device, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The same on bf16 fields B, A and Y on the tensor cores (mm_update_mma);
// M stays f32, split exactly into three bf16 pieces. T (128 or 256) and
// stages (2 to kRingMaxStages) come from ops/fused.py
// mm_update_mma_plan.
extern "C" int bcg_mm_update_bf16(const float* M, const bf16* B, const bf16* A, bf16* Y, int k,
                                  long long n, int T, int stages, int device,
                                  cudaStream_t stream) {
  if (n < 1 || k < 1 || k > kMmMaxK || T < 128 || T > 256 || T % 128 != 0 || stages < 2 ||
      stages > kRingMaxStages)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (mm_mma_width(k)) {
    case 16: return launch_mma<16>(M, B, A, Y, k, n, T, stages, device, stream);
    case 32: return launch_mma<32>(M, B, A, Y, k, n, T, stages, device, stream);
    case 64: return launch_mma<64>(M, B, A, Y, k, n, T, stages, device, stream);
    case 128: return launch_mma<128>(M, B, A, Y, k, n, T, stages, device, stream);
    default: return cudaErrorInvalidValue;
  }
}
