// Per-site block stencil (matrix-valued links) on lanes-major fields, with
// an optional fused Gram.
//
// Replaces the Pallas kernels blockcg_tpu/ops/block_stencil.py
// block_stencil_spmm_t (:94), block_stencil_spmm_m_t (:371) and
// block_stencil_spmm_m_gram_t (:383), and the ring schedule of the same
// contract, blockcg_tpu/ops/block_stencil_ring.py ring_block_spmm_m_t (:359)
// and ring_block_spmm_m_gram_t (:371).
//
// Contract: blocks (noff, bs, bs, ns) float32, each (d, a, b) row contiguous
// over the sites; offsets reduced to [0, ns). For every right-hand side i,
//   Y[row(a, i), s] = sum_d sum_b blocks[d, a, b, s] * X[row(b, i), (s + o_d) mod ns]
// on a (bs * k, ns) field whose row map is a runtime pair of strides
// (RowMap in common.cuh): the merged spin-major view (m, ns), or the
// (k, bs, ns) view (= flat (k, bs * ns)).
// The Gram variant (merged only) also returns G = X Y^T (m x m).
//
// Design: one thread owns one site column s. For each diagonal it loads the
// bs^2 coefficients blocks[d, :, :, s] (the warp's 32 threads read 32
// neighbouring sites of one (d, a, b) row: one coalesced 128-byte line), and
// for each input spin b the k values of X at column (s + o_d) mod ns, and
// adds them into its m = bs * k outputs, held in registers as acc[BS][KI]
// (common.cuh). BS (4 or 8) is the compile-time spin width >= bs, KMAX (8,
// 16, 32 or 64) the register tile >= BS * k, KI = KMAX / BS.
//
// Bound: bytes. At 32^4 sites, bs = 4, k = 12 (m = 48) and 15 diagonals, the
// contract reads the blocks once (15 * 16 * 4 B * 1,048,576 = 1.007 GB, 71%
// of it), X once (201 MB) and writes Y once (201 MB): 1.41 GB, 0.42 ms at the
// H100's 3.35 TB/s. The arithmetic, 2 * 15 * 16 * 12 * ns = 6.0 GFLOP (+ 4.8
// for the Gram), takes 0.16 ms at 67 TFLOP/s f32, so the blocks' stream sets
// the pace. Each block coefficient is read once and used k times from a
// register; X's columns are re-read per diagonal through L1/L2 (the far
// +-L^3 window of 48 rows is 12.6 MB, inside the 50 MB L2), so X comes from
// DRAM about once. The realified complex operator (bs = 8, k = 6) moves 4.03
// GB of blocks and 0.40 GB of fields: 1.32 ms. Staging X windows in shared
// memory, TMA and wgmma are later work.
//
// Gram: as in const_block_stencil.cu, each block stages its tile's X and Y
// columns in shared memory, adds them into a register tile (GramTile),
// writes one (m, m) partial, and reduce_partials sums the partials in a fixed
// order. No atomics: a repeated call gives the same bits.
#include "common.cuh"

namespace {

constexpr int kMaxDiags = 32;
constexpr int kMaxBs = 8;

struct Offsets {
  int o[kMaxDiags];  // site offsets, each in [0, ns)
};

template <int BS, int KMAX, bool WITH_GRAM>
__global__ void __launch_bounds__(kThreads)
    bs_spmm(const float* __restrict__ blocks, Offsets offs, int nd, int bs,
            const float* __restrict__ X, float* __restrict__ Y,
            float* __restrict__ part, RowMap row, int k, long long ns) {
  constexpr int KI = KMAX / BS;
  extern __shared__ __align__(16) float smem[];  // [xs | ys] (WITH_GRAM)
  __shared__ int s_off[kMaxDiags];
  float* xs = smem;
  float* ys = smem + KMAX * kLd;
  const int m = bs * k;
  if (threadIdx.x < nd) s_off[threadIdx.x] = offs.o[threadIdx.x];
  if constexpr (WITH_GRAM) zero_pad_rows<KMAX>(xs, ys, m);
  __syncthreads();

  const long long plane = static_cast<long long>(bs) * bs * ns;  // one diagonal
  GramTile<KMAX> g;
  const long long ntiles = (ns + kThreads - 1) / kThreads;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long s = t * kThreads + threadIdx.x;
    const bool valid = s < ns;
    float acc[BS][KI];
    zero(acc);
    if (valid) {
      for (int d = 0; d < nd; ++d) {
        long long src = s + s_off[d];
        if (src >= ns) src -= ns;
        const float* c = blocks + d * plane + s;  // blocks[d, a, b, s] = c[(a*bs+b)*ns]
        const RowStrides rows = row.times(ns);
#pragma unroll
        for (int b = 0; b < BS; ++b) {
          if (b < bs) {
            const float* xrow = X + src + b * rows.a;
            float xb[KI];
#pragma unroll
            for (int i = 0; i < KI; ++i) xb[i] = i < k ? xrow[i * rows.i] : 0.f;
#pragma unroll
            for (int a = 0; a < BS; ++a) {
              if (a < bs) {
                const float w = c[static_cast<long long>(a * bs + b) * ns];
#pragma unroll
                for (int i = 0; i < KI; ++i) acc[a][i] = fmaf(w, xb[i], acc[a][i]);
              }
            }
          }
        }
      }
      const RowStrides rows = row.times(ns);
#pragma unroll
      for (int a = 0; a < BS; ++a)
#pragma unroll
        for (int i = 0; i < KI; ++i)
          if (a < bs && i < k) Y[s + a * rows.a + i * rows.i] = acc[a][i];
    }
    if constexpr (WITH_GRAM) {
      __syncthreads();  // the previous tile's Gram reads are done
      stage_x(xs, X, m, ns, s, valid);
      stage_rows(ys, acc, bs, k, row);
      __syncthreads();
      g.accumulate(xs, ys);
    }
  }
  if constexpr (WITH_GRAM) g.store(part + static_cast<long long>(blockIdx.x) * m * m, m);
}

struct Args {
  const float* blocks;
  Offsets offs;
  int nd, bs;
  const float* X;
  float *Y, *part, *G;
  int k, ks;
  long long ns;
  bool merged;
  int nblocks;
  cudaStream_t stream;
};

template <int BS, int KMAX, bool WITH_GRAM>
cudaError_t launch(const Args& a) {
  auto kernel = bs_spmm<BS, KMAX, WITH_GRAM>;
  const size_t smem = WITH_GRAM ? 2 * KMAX * kLd * sizeof(float) : 0;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.nblocks, kThreads, smem, a.stream>>>(a.blocks, a.offs, a.nd, a.bs, a.X,
                                                  a.Y, a.part,
                                                  row_map(a.merged, a.bs, a.ks), a.k, a.ns);
  if (WITH_GRAM) launch_reduce(a.part, a.G, a.bs * a.k, a.nblocks, a.stream);
  return cudaGetLastError();
}

template <int BS, int KMAX>
cudaError_t by_gram(bool gram, const Args& a) {
  return gram ? launch<BS, KMAX, true>(a) : launch<BS, KMAX, false>(a);
}

template <int BS>
cudaError_t by_kmax(int kmax, bool gram, const Args& a) {
  switch (kmax) {
    case 8: return by_gram<BS, 8>(gram, a);
    case 16: return by_gram<BS, 16>(gram, a);
    case 32: return by_gram<BS, 32>(gram, a);
    case 64: return by_gram<BS, 64>(gram, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// offsets: host array of nd entries, each already reduced to [0, ns).
// blocks: device (nd, bs, bs, ns). X, Y: device (bs * k, ns) fields, merged
// (row a * ks + i) when merged != 0, else the (k, bs, ns) view (row i * bs +
// a). ks: the merged view's right-hand sides per spin, k on a whole field; a
// row-chunked launch covers RHS j0..j0+k of a field of ks, with X and Y
// offset by j0 rows (the view's chunks are contiguous and take ks = k).
// G == nullptr selects the plain apply; otherwise (merged only, ks == k) part
// holds (nblocks, m, m) and G receives X Y^T.
extern "C" int bcg_block_stencil_spmm(const float* blocks, const int* offsets,
                                      int nd, int bs, const float* X, float* Y,
                                      float* part, float* G, int k, int ks,
                                      long long ns, int merged, int nblocks,
                                      int device, cudaStream_t stream) {
  const int bsw = bs < 1 ? 0 : bs <= 4 ? 4 : bs <= kMaxBs ? 8 : 0;
  const int kmax = kmax_for(bsw * k);
  if (nd < 1 || nd > kMaxDiags || bsw == 0 || k < 1 || kmax == 0 || ns < 1 ||
      nblocks < 1 || (G != nullptr && !merged) || ks < k || (G != nullptr && ks != k))
    return cudaErrorInvalidValue;
  Args a{blocks, {}, nd, bs, X, Y, part, G, k, ks, ns, merged != 0, nblocks, stream};
  for (int d = 0; d < nd; ++d) {
    if (offsets[d] < 0 || offsets[d] >= ns) return cudaErrorInvalidValue;
    a.offs.o[d] = offsets[d];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool gram = G != nullptr;
  return bsw == 4 ? by_kmax<4>(kmax, gram, a) : by_kmax<8>(kmax, gram, a);
}
