// The slab adds of the const-hop operator (rows 18-21), with and without
// their Gram, as one streaming launch at any width, on either view.
//
// Replaces the Pallas kernels blockcg_tpu/ops/const_block_stencil.py
// slab_m_accumulate (:780), the periodic wrap diagonals of the merged field,
// and slab_m_accumulate_from (:846), the distributed layer's halo crossings,
// and on the (k, bs, ns) view slab_block_accumulate (:691) and
// slab_block_accumulate_from (:955), which have no Gram and no vals.
//
// Layout: (m = bs * k, ns) float32 fields, site s of row r at F[r * ns + s];
// the row of spin a of right-hand side i is a runtime map, row(a, i) = a sa +
// i si (RowMap in common.cuh): (sa, si) = (k, 1) on the merged spin-major
// view, (1, bs) on the (k, bs, ns) view. At k = 1 both are the same memory.
//
// Contract: for site e = j * g + c of slab j < nblocks (c < g), destination
// column dst(e) = ((dst_mul * j + dst_off) mod nb) * g + c of Y (nb = ns / g)
// and source column src(e) = ((src_mul * j + src_off) mod src_nb) * g + c of
// X (xn columns, src_nb = xn / g):
//   Y[row(a, i), dst(e)] += v(e) * sum_b H[a][b] * X[row(b, i), src(e)],
// in place on Y, v(e) = vals[e] or 1. X is the field itself (xn = ns, the
// periodic wraps) or a separate halo buffer. With the Gram (merged fields
// alone: the view's slab adds have none),
//   G = Gin + sum_e Xd[:, dst(e)] dY[:, e]^T   (m x m; Gin may be null),
// Xd the field whose destination columns the Gram reads.
// Each element's sum is taken over b in order with fmaf(H[a][b], x_b, acc)
// from 0, then multiplied by v, then added to Y: the arithmetic of the
// kernel these replaced (slab_accumulate, a site a thread), so Y keeps its bits.
//
// Bound: bytes. At config 4's slabs (m = 48, 32,768 slab sites of 32^4) a
// slab add reads X at the sources and Y and writes Y, 18.87 MB (5.63 us at
// 3.35 TB/s); with the Gram X at the destinations too, 25.2 MB (7.52 us);
// m = 96 doubles both. The kernel it replaces (slab_accumulate) took one site
// a thread with all m rows, 4-byte loads spin by spin and 48 one-float
// read-modify-writes of Y, on 8 warps an SM, a launch per 64 rows, and its
// Gram in GramTile partials summed by a second launch. On the (k, bs, ns)
// view a warp still reads 512 contiguous bytes of one row: an item is one
// right-hand side and V sites, whichever the row map.
//
// Design. A work item is one right-hand side i and V consecutive slab sites
// (V = 4 where g % 4 == 0 and X, Y, Xd and vals are 16-byte aligned: every
// access is a float4; else V = 1, the 4-byte route, the same code): the bs
// loads of X at the sources, the bs reads of Y (and with the Gram the bs
// loads of X at the destinations), in flight together, then bs * V fmaf
// chains on the hop (staged in shared memory) and bs stores. Without the
// Gram (slab_stream) the items are one flat range, right-hand side outer and
// the sites inner, so a warp reads 512 contiguous bytes of a row, walked by
// a grid of blocks sized by occupancy (ops/const_block_stencil.py
// slab_plan). With it (slab_stream_gram) a block of 8 warps, one an SM
// with every register it needs (at two blocks an SM the Gram builds spilled
// 120-416 bytes a thread), walks tiles of tc slab sites with every
// right-hand side: it streams a tile's items and stages its X at the
// destinations and its dY (KMAX rows) in shared memory, then adds X_dst
// dY^T into a VecGram register tile. A Gram wider than
// kSlabGramRows is taken in passes of (KMAX, KMAX) blocks, each pass
// recomputing dY (Y is stored in the first). Each block writes its (m, m)
// partial; the launch is cooperative (every block resident), so after one
// grid-wide barrier every block sums its share of G's entries over all
// partials, in block order and in double, adds Gin, and stores G: one
// launch, no atomics on G, and a repeat gives the same bits (the grid
// depends on the shapes and the card alone). At two blocks an SM it took
// 27.4 us at m = 48 and 72 at 96; a pipeline of 8 producer and 8 consumer
// warps on two buffers (named barriers) spilled 240 bytes a thread at 128
// registers and took 31 and 80 (H100, PERF.md).
#include "common.cuh"

namespace {

constexpr int kSlabThreads = 256;
constexpr int kSlabMaxBs = 8;
constexpr int kSlabGramRows = 128;  // the widest Gram tile; wider Grams in passes

// Slab j < nblocks: destination block (dst_mul * j + dst_off) mod nb of Y,
// source block (src_mul * j + src_off) mod src_nb of X; total = nblocks * g.
struct SlabMap {
  long long nb, dst_mul, dst_off, src_nb, src_mul, src_off, g, total;
};

// Blocks an SM the build without the Gram is built for (its register cap):
// 4 up to bs = 4, else 2; the Gram's takes one. Mirrored by
// ops/const_block_stencil.py slab_blocks.
template <int BS>
constexpr int kSlabBlocksPerSm = BS <= 4 ? 4 : 2;

// The side of a thread's VecGram register tile for a Gram tile of KMAX rows:
// 6 x 6 at 48 and 96 rows, 4 x 4 at 32 and 64, 8 x 8 at 128, the least that
// 256 threads hold; mirrored by ops/const_block_stencil.py slab_ts.
template <int KMAX>
constexpr int kSlabTS = KMAX == 128 ? 8 : (KMAX == 48 || KMAX == 96) ? 6 : 4;

template <int KMAX>
using SlabGram = VecGram<KMAX, kSlabThreads, kSlabTS<KMAX>>;

template <int V>
__device__ __forceinline__ void load_ro(float (&v)[V], const float* __restrict__ p) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load_rw(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else *p = v[0];
}

// dy[a][u] = v(e + u) * sum_b H[a][b] X[row(b, i), src(e) + u] for a < bs,
// u < V, added into Y's destination columns when `store`; with Xd, xd[a] =
// Xd[row(a, i), dst(e) ..] for the rows row(a, i) in [r0, r1), loaded with
// the item's other loads. The V sites share their slab (g % V == 0).
template <int BS, int V>
__device__ __forceinline__ void slab_item(const float* hs, int bs, RowMap row, int i,
                                          long long e, const SlabMap& mp,
                                          const float* __restrict__ X, long long xn,
                                          const float* __restrict__ vals, float* Y,
                                          long long ns, bool store, float (&dy)[BS][V],
                                          const float* __restrict__ Xd, float (&xd)[BS][V],
                                          int r0, int r1) {
  const long long j = e / mp.g, c = e - j * mp.g;
  const long long dst = (mp.dst_mul * j + mp.dst_off) % mp.nb * mp.g + c;
  const long long src = (mp.src_mul * j + mp.src_off) % mp.src_nb * mp.g + c;
  float x[BS][V], y[BS][V], v[V];
#pragma unroll
  for (int b = 0; b < BS; ++b)
    if (b < bs) load_ro<V>(x[b], X + static_cast<long long>(row(b, i)) * xn + src);
  if (store) {
#pragma unroll
    for (int a = 0; a < BS; ++a)
      if (a < bs) load_rw<V>(y[a], Y + static_cast<long long>(row(a, i)) * ns + dst);
  }
  if (Xd != nullptr) {
#pragma unroll
    for (int a = 0; a < BS; ++a) {
      const int r = row(a, i);
      if (a < bs && r >= r0 && r < r1) load_ro<V>(xd[a], Xd + static_cast<long long>(r) * ns + dst);
    }
  }
  if (vals != nullptr) load_ro<V>(v, vals + e);
#pragma unroll
  for (int a = 0; a < BS; ++a) {
    if (a >= bs) break;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      float acc = 0.f;
#pragma unroll
      for (int b = 0; b < BS; ++b)
        if (b < bs) acc = fmaf(hs[a * bs + b], x[b][u], acc);
      if (vals != nullptr) acc *= v[u];
      dy[a][u] = acc;
      if (store) y[a][u] += acc;
    }
    if (store) store_v<V>(Y + static_cast<long long>(row(a, i)) * ns + dst, y[a]);
  }
}

// Shared floats of a Gram launch: the staged X_dst and dY tiles, (KMAX, tc
// + 4) each, or VecGram's scratch where larger; mirrored by
// ops/const_block_stencil.py slab_smem_bytes.
template <int KMAX>
constexpr long long slab_smem_floats(int tc) {
  constexpr long long scratch = SlabGram<KMAX>::kScratch;
  const long long tiles = 2LL * KMAX * (tc + 4);
  return tiles > scratch ? tiles : scratch;
}

// Wait until every block of the (cooperative) launch has arrived.
__device__ __forceinline__ void grid_barrier(unsigned* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's partial is visible to the others
    atomicAdd(arrived, 1u);
    while (*reinterpret_cast<volatile unsigned*>(arrived) < gridDim.x) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// Without the Gram.
template <int BS, int V>
__global__ void __launch_bounds__(kSlabThreads, kSlabBlocksPerSm<BS>)
    slab_stream(const float* __restrict__ hop, int bs, SlabMap mp, const float* __restrict__ X,
                long long xn, const float* __restrict__ vals, float* __restrict__ Y, int k,
                long long ns, RowMap row) {
  __shared__ float hs[kSlabMaxBs * kSlabMaxBs];
  for (int e = threadIdx.x; e < bs * bs; e += kSlabThreads) hs[e] = hop[e];
  __syncthreads();
  const long long nq = mp.total / V, items = nq * k;
  for (long long it = static_cast<long long>(blockIdx.x) * kSlabThreads + threadIdx.x;
       it < items; it += static_cast<long long>(gridDim.x) * kSlabThreads) {
    const long long i = it / nq;
    float dy[BS][V], xd[BS][V];
    slab_item<BS, V>(hs, bs, row, static_cast<int>(i), (it - i * nq) * V, mp, X, xn, vals, Y,
                     ns, true, dy, nullptr, xd, 0, 0);
  }
}

// With the Gram (the merged view's rows 19 and 20 alone, its map known to
// the compiler): Xd's destination columns, Gin (or null), part (gridDim.x,
// m, m), arrived (one unsigned, zeroed before the launch), tiles of tc sites.
template <int BS, int V, int KMAX>
__global__ void __launch_bounds__(kSlabThreads, 1)
    slab_stream_gram(const float* __restrict__ hop, int bs, SlabMap mp,
                     const float* __restrict__ X, long long xn, const float* __restrict__ vals,
                     const float* __restrict__ Xd, float* __restrict__ Y, int k, long long ns,
                     const float* __restrict__ Gin, float* __restrict__ part,
                     float* __restrict__ G, unsigned* arrived, int tc) {
  const RowMap row{k, 1};  // the merged view's: the (k, bs, ns) view's slab adds have no Gram
  __shared__ float hs[kSlabMaxBs * kSlabMaxBs];
  __shared__ double red[kSlabThreads];
  extern __shared__ __align__(16) float smem[];
  for (int e = threadIdx.x; e < bs * bs; e += kSlabThreads) hs[e] = hop[e];
  __syncthreads();
  const int m = bs * k, lx = tc + 4, tq = tc / V;
  float* xs = smem;              // X_dst, rows r0 .. r0 + kx - 1 of the pass
  float* ys = smem + KMAX * lx;  // dY, rows s0 .. s0 + ky - 1
  const int nrb = (m + KMAX - 1) / KMAX;
  const long long ntiles = (mp.total + tc - 1) / tc;
  float* mine = part + static_cast<long long>(blockIdx.x) * m * m;
  for (int pass = 0; pass < nrb * nrb; ++pass) {
    const int r0 = pass / nrb * KMAX, s0 = pass % nrb * KMAX;
    const int kx = min(KMAX, m - r0), ky = min(KMAX, m - s0);
    SlabGram<KMAX> gr;
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int ncol = static_cast<int>(min(static_cast<long long>(tc), mp.total - t * tc));
      for (int it = threadIdx.x; it < k * tq; it += kSlabThreads) {
        const int i = it / tq, col = (it - i * tq) * V;
        float dy[BS][V], xd[BS][V];
        const bool in = col < ncol;  // all V sites: ncol % V == 0
        if (in)
          slab_item<BS, V>(hs, bs, row, i, t * tc + col, mp, X, xn, vals, Y, ns, pass == 0,
                           dy, Xd, xd, r0, r0 + kx);
#pragma unroll
        for (int a = 0; a < BS; ++a) {
          if (a >= bs) break;
          const int r = row(a, i);
          if (!in) {
#pragma unroll
            for (int u = 0; u < V; ++u) xd[a][u] = dy[a][u] = 0.f;
          }
          if (r >= r0 && r < r0 + kx) store_v<V>(xs + (r - r0) * lx + col, xd[a]);
          if (r >= s0 && r < s0 + ky) store_v<V>(ys + (r - s0) * lx + col, dy[a]);
        }
      }
      __syncthreads();
      // Columns past ncol up to a multiple of 4 hold zeros (the 4-byte route).
      gr.accumulate(xs, lx, ys, lx, (ncol + 3) / 4 * 4, kx, ky);
      __syncthreads();
    }
    gr.store(mine + static_cast<long long>(r0) * m + s0, kx, ky, m, smem);
    __syncthreads();  // the scratch reads are done before the next pass stages
  }
  grid_barrier(arrived);
  // This block's entries of G: a contiguous share, 256 at a time; thread
  // (eo, c) sums partials c, c + C, ... of entry eo in double, then the C
  // chunk sums are added in order, after Gin.
  const long long E = static_cast<long long>(m) * m;
  const long long e1 = E * (blockIdx.x + 1) / gridDim.x;
  for (long long eb = E * blockIdx.x / gridDim.x; eb < e1; eb += kSlabThreads) {
    const int ne = static_cast<int>(min(static_cast<long long>(kSlabThreads), e1 - eb));
    const int C = kSlabThreads / ne, eo = threadIdx.x % ne, c = threadIdx.x / ne;
    // Partials c, c + C, ... in order, eight loads in flight at a time.
    double sum = 0.0;
    if (c < C) {
      const float* q = part + eb + eo;
      long long p = c;
      for (; p + 7LL * C < gridDim.x; p += 8LL * C) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = __ldcg(q + (p + u * C) * E);
#pragma unroll
        for (int u = 0; u < 8; ++u) sum += static_cast<double>(v[u]);
      }
      for (; p < gridDim.x; p += C) sum += static_cast<double>(__ldcg(q + p * E));
    }
    red[threadIdx.x] = sum;
    __syncthreads();
    if (threadIdx.x < ne) {
      double v = Gin != nullptr ? static_cast<double>(Gin[eb + threadIdx.x]) : 0.0;
      for (int cc = 0; cc < C; ++cc) v += red[cc * ne + threadIdx.x];
      G[eb + threadIdx.x] = static_cast<float>(v);
    }
    __syncthreads();
  }
}

struct StreamArgs {
  const float* hop;
  int bs;
  SlabMap mp;
  const float* X;
  long long xn;
  const float *vals, *Xd;
  float* Y;
  int k;
  long long ns;
  RowMap row;
  const float* Gin;
  float *part, *G;
  unsigned* arrived;
  int tc, grid;
  int device;
  cudaStream_t stream;
};

template <int BS, int V>
cudaError_t launch_plain(const StreamArgs& a) {
  slab_stream<BS, V><<<a.grid, kSlabThreads, 0, a.stream>>>(a.hop, a.bs, a.mp, a.X, a.xn,
                                                              a.vals, a.Y, a.k, a.ns, a.row);
  return cudaGetLastError();
}

template <int BS, int V, int KMAX>
cudaError_t launch_gram(StreamArgs a) {
  auto kernel = slab_stream_gram<BS, V, KMAX>;
  const size_t smem = 4 * slab_smem_floats<KMAX>(a.tc);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // Every block must be resident for the grid barrier: the plan's grid
  // within what the card holds at once (a cooperative launch refuses more).
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, a.device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSlabThreads, smem);
  if (err != cudaSuccess) return err;
  if (a.grid > sms * per_sm) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaMemsetAsync(a.arrived, 0, sizeof(unsigned), a.stream);
  if (err != cudaSuccess) return err;
  void* args[] = {&a.hop, &a.bs, &a.mp, &a.X, &a.xn, &a.vals, &a.Xd, &a.Y,
                  &a.k,   &a.ns, &a.Gin, &a.part, &a.G, &a.arrived, &a.tc};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), a.grid,
                                     kSlabThreads, args, smem, a.stream);
}

template <int BS, int V>
cudaError_t stream_by_kmax(int kmax, const StreamArgs& a) {
  switch (kmax) {
    case 0: return launch_plain<BS, V>(a);
    case 32: return launch_gram<BS, V, 32>(a);
    case 48: return launch_gram<BS, V, 48>(a);
    case 64: return launch_gram<BS, V, 64>(a);
    case 96: return launch_gram<BS, V, 96>(a);
    case 128: return launch_gram<BS, V, kSlabGramRows>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The Gram's tile rows for m rows: the least of 32, 48, 64, 96, 128 that
// holds them, 128 above (passes); mirrored by slab_plan.
int slab_kmax(int m) {
  return m <= 32 ? 32 : m <= 48 ? 48 : m <= 64 ? 64 : m <= 96 ? 96 : kSlabGramRows;
}

template <int V>
int slab_entry(const float* hop, int bs, int g, int nblocks, long long dst_mul,
               long long dst_off, long long src_mul, long long src_off, const float* X,
               long long xn, const float* vals, const float* Xd, float* Y, const float* Gin,
               float* part, float* G, unsigned* arrived, int k, long long ns, int sa, int si,
               int kmax, int tc, int grid, int device, cudaStream_t stream) {
  const bool gram = G != nullptr;
  if (bs < 1 || bs > kSlabMaxBs || k < 1 || g < 1 || ns < 1 || ns % g != 0 || xn < 1 ||
      xn % g != 0 || nblocks < 1 || grid < 1 || g % V != 0 ||
      !((sa == k && si == 1) || (sa == 1 && si == bs)))
    return cudaErrorInvalidValue;
  if (gram && (part == nullptr || Xd == nullptr || arrived == nullptr || sa != k || si != 1 ||
               kmax != slab_kmax(bs * k) || tc < 4 || tc % 4 != 0 || tc % V != 0))
    return cudaErrorInvalidValue;
  if (V == 4 && !(aligned16(X) && aligned16(Y) && (vals == nullptr || aligned16(vals)) &&
                  (!gram || aligned16(Xd))))
    return cudaErrorInvalidValue;
  const long long nb = ns / g, src_nb = xn / g;
  if (nblocks > nb || dst_mul < 0 || dst_mul >= nb || dst_off < 0 || dst_off >= nb ||
      src_mul < 0 || src_mul >= src_nb || src_off < 0 || src_off >= src_nb)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const StreamArgs a{hop, bs, {nb, dst_mul, dst_off, src_nb, src_mul, src_off, g,
                     static_cast<long long>(nblocks) * g}, X, xn, vals, Xd, Y, k, ns,
                     RowMap{sa, si}, Gin, part, G, arrived, tc, grid, device, stream};
  const int km = gram ? kmax : 0;
  return bs <= 4 ? stream_by_kmax<4, V>(km, a) : stream_by_kmax<kSlabMaxBs, V>(km, a);
}

}  // namespace

// hop: device (bs, bs). Y ((bs k, ns), nb = ns / g blocks of g sites) is
// updated in place from X ((bs k, xn), src_nb = xn / g blocks): destination
// block (dst_mul * j + dst_off) mod nb gets (H ⊗ I_k) times source block
// (src_mul * j + src_off) mod src_nb, j < nblocks, each of the four reduced
// to its range (the destination blocks distinct). Rows by the map (sa, si):
// (k, 1) merged, (1, bs) the (k, bs, ns) view (no Gram). vals: device (nblocks * g),
// or null. G == nullptr: no Gram; else G (m x m) = Gin + the slab's Xd_dst
// dY^T (Gin may be null) on the Gram's tile of kmax rows and tiles of tc
// sites, part (grid, m, m) and arrived (one unsigned, zeroed here) its
// scratch. grid: blocks (ops/const_block_stencil.py slab_plan).
// bcg_slab_stream takes 16-byte accesses (g % 4 == 0, X, Y, Xd, vals
// 16-byte aligned), bcg_slab_stream_scalar 4-byte ones.
extern "C" int bcg_slab_stream(const float* hop, int bs, int g, int nblocks,
                               long long dst_mul, long long dst_off, long long src_mul,
                               long long src_off, const float* X, long long xn,
                               const float* vals, const float* Xd, float* Y, const float* Gin,
                               float* part, float* G, unsigned* arrived, int k, long long ns,
                               int sa, int si, int kmax, int tc, int grid, int device,
                               cudaStream_t stream) {
  return slab_entry<4>(hop, bs, g, nblocks, dst_mul, dst_off, src_mul, src_off, X, xn, vals,
                       Xd, Y, Gin, part, G, arrived, k, ns, sa, si, kmax, tc, grid, device,
                       stream);
}

extern "C" int bcg_slab_stream_scalar(const float* hop, int bs, int g, int nblocks,
                                      long long dst_mul, long long dst_off, long long src_mul,
                                      long long src_off, const float* X, long long xn,
                                      const float* vals, const float* Xd, float* Y,
                                      const float* Gin, float* part, float* G,
                                      unsigned* arrived, int k, long long ns, int sa, int si,
                                      int kmax, int tc, int grid, int device,
                                      cudaStream_t stream) {
  return slab_entry<1>(hop, bs, g, nblocks, dst_mul, dst_off, src_mul, src_off, X, xn, vals,
                       Xd, Y, Gin, part, G, arrived, k, ns, sa, si, kmax, tc, grid, device,
                       stream);
}
