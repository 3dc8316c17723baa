// Const-hop block stencil with the fused Gram on the (k, bs, ns) view. (The
// main kernels without the Gram, both views, run cbs_merged.cu, and the slab
// adds of both views slab_stream.cu; this one's plain apply, G null, serves
// the on-card tests as the bitwise reference of the view's apply there.)
//
// Replaces the Pallas kernel blockcg_tpu/ops/const_block_stencil.py
// const_block_stencil_spmm_gram_t (:361) on the (k, bs, ns) view.
//
// Layout: a field is (m, ns) float32 with m = bs * k; site s of row r sits at
// F[r * ns + s]. The row map is a runtime pair of strides (RowMap in
// common.cuh): on the (k, bs, ns) view row i * bs + a holds spin a of
// right-hand side i. The main kernel here does the arithmetic of
// cbs_merged.cu's groups of one, so on the ungrouped plan the two give the
// same bits.
//
// Contract, main kernel: for every diagonal d of the main set,
//   Y[row(a, i), s] += w_d(s) * sum_b H_d[a][b] * X[row(b, i), (s + o_d) mod ns],
// w_d(s) = masks[slot_d, s] when slot_d >= 0, else 1. The mask is a value,
// not a gate: the gauged operators carry +-1 links in it. The Gram variant
// also returns the contraction of G = X Y^T over spins and sites, the (k, k)
// G[i, j] = sum_{a, s} X[i, a, s] Y[j, a, s].
//
// The TPU kernels build the MXU weight W = H ⊗ I_k, which is 3/4 zeros at
// bs = 4. Here one thread owns one site column and applies the bs x bs hop
// to each of its k-row spin groups directly: its m outputs sit in registers
// as acc[BS][KI], and for each diagonal and input spin b it loads the k
// values X[row(b, :), src] once and adds H[a][b] times them into every output
// spin a. BS (1, 2, 4 or 8) is the compile-time spin width >= bs, KMAX (8,
// 16, 32 or 64) the register tile >= BS * k, KI = KMAX / BS; rows with
// a >= bs or i >= k stay zero and are never stored.
//
// Bound: bytes, and L2 traffic. Per apply at 32^4 sites, m = 48: X read once
// from DRAM when L2 holds the +-32,768-site window of the far diagonals
// (about 12.6 MB of the H100's 50 MB), Y written once, 10 mask rows read:
// about 444 MB. Each diagonal re-reads X's column from L1/L2, so the 13
// main diagonals move about 2.6 GB through the cache hierarchy; staging
// windows in shared memory is later work. At k = 1 (the even-odd CG's parity
// hops, 2^19 sites) the masks outweigh the fields: a thread issues bs = 4
// loads per diagonal, so the apply is bound by load count and latency more
// than by bytes. The hop table (at most 32 x 8 x 8 floats) and the offsets
// sit in shared memory; the offsets come reduced to [0, ns), so the column
// wraps with one conditional subtraction. Y is a fresh buffer (other blocks
// still read X).
//
// Gram: each block stages its tile's X and Y columns in shared memory in the
// field's own row order, adds them into a register tile (GramTile) and writes
// one (m, m) partial; reduce_spin_contract sums and contracts the spins: one
// block per (i, j), each thread a fixed stride of the terms, then a tree in
// shared memory. No atomics: a repeated call gives the same bits.
#include "common.cuh"

namespace {

constexpr int kMaxDiags = 32;
constexpr int kMaxBs = 8;

struct Diags {
  int o[kMaxDiags];     // site offsets, each in [0, ns)
  int slot[kMaxDiags];  // mask row, or -1 for an unmasked diagonal
};

// acc[a][i] += w * sum_b h[a * bs + b] * X[row(b, i), src].
template <int BS, int KI>
__device__ __forceinline__ void hop_apply(float (&acc)[BS][KI], const float* h,
                                          float w, const float* __restrict__ X,
                                          int bs, int k, RowStrides rows,
                                          long long src) {
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
          const float hw = w * h[a * bs + b];
#pragma unroll
          for (int i = 0; i < KI; ++i) acc[a][i] = fmaf(hw, xb[i], acc[a][i]);
        }
      }
    }
  }
}

// Y[row(a, i), col] = v[a][i] for a < bs, i < k.
template <int BS, int KI>
__device__ __forceinline__ void store_rows(float* __restrict__ Y,
                                           const float (&v)[BS][KI], int bs,
                                           int k, RowStrides rows, long long col) {
#pragma unroll
  for (int a = 0; a < BS; ++a)
#pragma unroll
    for (int i = 0; i < KI; ++i)
      if (a < bs && i < k) Y[col + a * rows.a + i * rows.i] = v[a][i];
}

template <int BS, int KMAX, bool WITH_GRAM>
__global__ void __launch_bounds__(kThreads)
    cbs_spmm(const float* __restrict__ hops, Diags diags, int nd, int bs,
             const float* __restrict__ masks, const float* __restrict__ X,
             float* __restrict__ Y, float* __restrict__ part, RowMap row, int k,
             long long ns) {
  constexpr int KI = KMAX / BS;
  // Dynamic shared memory: [xs | ys] (WITH_GRAM) then the hop table.
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_off[kMaxDiags], s_slot[kMaxDiags];
  float* xs = smem;
  float* ys = smem + KMAX * kLd;
  float* sh = WITH_GRAM ? smem + 2 * KMAX * kLd : smem;
  const int m = bs * k;
  for (int e = threadIdx.x; e < nd * bs * bs; e += blockDim.x) sh[e] = hops[e];
  if (threadIdx.x < nd) {
    s_off[threadIdx.x] = diags.o[threadIdx.x];
    s_slot[threadIdx.x] = diags.slot[threadIdx.x];
  }
  if constexpr (WITH_GRAM) zero_pad_rows<KMAX>(xs, ys, m);
  __syncthreads();

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
        const int sl = s_slot[d];
        const float w = sl < 0 ? 1.f : masks[sl * ns + s];
        hop_apply(acc, sh + d * bs * bs, w, X, bs, k, row.times(ns), src);
      }
      store_rows(Y, acc, bs, k, row.times(ns), s);
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

// The (k, bs, ns) view's Gram: G[i, j] = sum over blocks b and spins a of
// part[b, i * bs + a, j * bs + a], in double. Block (i, j) of the grid owns
// one entry: thread t sums terms t, t + kReduceThreads, ... (term = b * bs +
// a), then a fixed tree adds the threads' sums.
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
    reduce_spin_contract(const float* __restrict__ part, float* __restrict__ G,
                         int bs, int k, int nblocks) {
  __shared__ double s_sum[kReduceThreads];
  const int i = blockIdx.x / k, j = blockIdx.x % k, m = bs * k;
  const long long mm = static_cast<long long>(m) * m;
  const int terms = nblocks * bs;
  double s = 0.0;
  for (int t = threadIdx.x; t < terms; t += kReduceThreads) {
    const int b = t / bs, a = t - b * bs;
    s += static_cast<double>(part[b * mm + (i * bs + a) * m + j * bs + a]);
  }
  s_sum[threadIdx.x] = s;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s_sum[threadIdx.x] += s_sum[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) G[blockIdx.x] = static_cast<float>(s_sum[0]);
}

struct MainArgs {
  const float* hops;
  Diags diags;
  int nd, bs;
  const float *masks, *X;
  float *Y, *part, *G;
  int k;
  long long ns;
  int nblocks;
  cudaStream_t stream;
};

size_t staged_bytes(int kmax, bool gram, int hop_floats) {
  return ((gram ? 2 * kmax * kLd : 0) + hop_floats) * sizeof(float);
}

template <int BS, int KMAX, bool WITH_GRAM>
cudaError_t launch_main(const MainArgs& a) {
  auto kernel = cbs_spmm<BS, KMAX, WITH_GRAM>;
  const size_t smem = staged_bytes(KMAX, WITH_GRAM, a.nd * a.bs * a.bs);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.nblocks, kThreads, smem, a.stream>>>(a.hops, a.diags, a.nd, a.bs,
                                                  a.masks, a.X, a.Y, a.part,
                                                  row_map(false, a.bs, a.k), a.k, a.ns);
  if (WITH_GRAM)
    reduce_spin_contract<<<a.k * a.k, kReduceThreads, 0, a.stream>>>(a.part, a.G, a.bs, a.k,
                                                                       a.nblocks);
  return cudaGetLastError();
}

// The compile-time spin width for bs: the next power of two.
int bs_width(int bs) {
  if (bs < 1) return 0;
  if (bs <= 1) return 1;
  if (bs <= 2) return 2;
  if (bs <= 4) return 4;
  if (bs <= kMaxBs) return 8;
  return 0;
}

template <int BS, int KMAX>
cudaError_t main_by_gram(bool gram, const MainArgs& a) {
  return gram ? launch_main<BS, KMAX, true>(a) : launch_main<BS, KMAX, false>(a);
}

template <int BS>
cudaError_t main_by_kmax(int kmax, bool gram, const MainArgs& a) {
  switch (kmax) {
    case 8: return main_by_gram<BS, 8>(gram, a);
    case 16: return main_by_gram<BS, 16>(gram, a);
    case 32: return main_by_gram<BS, 32>(gram, a);
    case 64: return main_by_gram<BS, 64>(gram, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// offsets, slots: host arrays of nd entries; each offset already reduced to
// [0, ns). hops: device (nd, bs, bs). masks: device (nmask, ns), or null when
// every slot is -1. k: right-hand sides (m = bs * k). X, Y: device (k, bs,
// ns) views (row i * bs + a); a row-chunked launch gets X and Y offset by
// its first RHS's rows. G == nullptr selects the plain apply; otherwise part
// holds (nblocks, m, m) and G receives the (k, k) contraction of X Y^T.
extern "C" int bcg_cbs_spmm(const float* hops, const int* offsets,
                            const int* slots, int nd, int bs,
                            const float* masks, const float* X, float* Y,
                            float* part, float* G, int k, long long ns, int nblocks,
                            int device, cudaStream_t stream) {
  const int bsw = bs_width(bs);
  const int kmax = kmax_for(bsw * k);
  if (nd < 1 || nd > kMaxDiags || bsw == 0 || k < 1 || kmax == 0 || ns < 1 || nblocks < 1)
    return cudaErrorInvalidValue;
  MainArgs a{hops, {}, nd, bs, masks, X, Y, part, G, k, ns, nblocks, stream};
  for (int d = 0; d < nd; ++d) {
    if (offsets[d] < 0 || offsets[d] >= ns) return cudaErrorInvalidValue;
    if (slots[d] >= 0 && masks == nullptr) return cudaErrorInvalidValue;
    a.diags.o[d] = offsets[d];
    a.diags.slot[d] = slots[d];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool gram = G != nullptr;
  switch (bsw) {
    case 1: return main_by_kmax<1>(kmax, gram, a);
    case 2: return main_by_kmax<2>(kmax, gram, a);
    case 4: return main_by_kmax<4>(kmax, gram, a);
    default: return main_by_kmax<8>(kmax, gram, a);
  }
}
