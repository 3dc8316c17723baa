// Const-hop block stencil on merged spin-major fields: a window of X in
// shared memory, four sites a lane, far diagonals from L2, hops applied
// once per group.
//
// Replaces the Pallas kernels blockcg_tpu/ops/const_block_stencil.py
// const_block_stencil_spmm_m_t (:617), with the Gram taken by gram.cu on the
// stored Y const_block_stencil_spmm_m_gram_t (:637), and on the (k, bs, ns)
// view const_block_stencil_spmm_t (:330). The view's Gram kernel and the
// slab adds stay in const_block_stencil.cu.
//
// Contract: a field is (m = bs * k, ns) float32 whose row map (RowMap in
// common.cuh) puts spin a of right-hand side i in row a * k + i on the
// merged view, in row i * bs + a on the (k, bs, ns) view. For every
// diagonal d,
//   Y[row(a, i), s] += w_d(s) * sum_b H_d[a][b] * X[row(b, i), (s + o_d) mod ns],
// w_d(s) = masks[slot_d, s] when slot_d >= 0, else 1 (a value, not a gate:
// the gauged operators carry +-1 links in it).
//
// Bound: bytes. At 32^4 sites, m = 48 (config 4), X is read once (201 MB),
// Y written once (201 MB) and the 10 mask rows read once (42 MB): 444 MB,
// 0.13 ms at the H100's 3.35 TB/s. The arithmetic, about 130 FMAs a site
// and right-hand side with the hops grouped, takes 0.05 ms at the f32 rate.
//
// Design. A persistent grid walks items: a tile of T = 128 * sw sites and a
// group of kb right-hand sides. Warp w of a block owns right-hand side w /
// sw of the group, its lanes the site quads c = 4 * ((w % sw) * 32 + lane)
// of the tile: a thread holds the sums of all bs spins of one right-hand
// side at four sites, so one float4 read of the window feeds four sites. A
// block double-buffers, with cp.async, the window of its items, the group's
// bs * kb rows at sites i0 - h .. i0 + T + h (mod ns), and the tile's mask
// rows, copying its next item while it computes this one. Near diagonals
// (|o| <= h) read the window: a shift that is not a multiple of 4 reads two
// aligned quads and funnels them, the shift mod 4 a template argument. Far
// ones read X from L2 a quad at a time, where L2 holds the band of the far
// offsets (+-32,768 sites at m = 48 is 12.6 MB); the far diagonals of a hop
// group come first in plan order, and the loads of up to NFB consecutive
// far diagonals are issued together. The diagonals are walked in hop-group
// order: a group's masked windows are summed first (u = sum_d w_d X_d),
// then its bs x bs hop is applied once (y += H u), as the reference's
// _m_kernel does with _group_offsets: on config 4, 5 hop applies a site
// instead of 13. The host
// plan (ops/const_block_stencil.py const_block_stencil_plan) picks h, sw,
// kb and the order from the offsets, the hops, the rows and the card's
// shared memory. One launch takes any k. The staged window's rows are in the
// order b * kb + ii on either view (the copies apply the row map), so the
// sums do not depend on the view.
//
// What the variants showed (H100, tools/torch_kernel_times.py --const-hop
// --variants, at (48, 32^4) on config 4; PERF.md section 6 has the tables):
// in one call, groups of 4 right-hand sides on 256-site tiles (8 warps, two
// blocks an SM) took 0.459 ms, all 12 on 128-site tiles (12 warps, one
// block an SM) 0.604, groups of 6 0.531, of 2 on 512-site tiles 0.494;
// sweeping the tiles one group at a time, not a tile's groups together,
// took 0.459 against 0.471. One site a thread with 6 right-hand sides (one
// shared float read a spin, RHS and site) took 0.63-0.65 where this kernel
// took 0.47. Two or three right-hand sides a thread were slower, and a
// runtime funnel (selects on the shift) cost 30%. Without the far loads
// this kernel takes 0.33 ms, without the window copies 0.37, without
// either 0.25. block_stencil.cu's warp-specialised schedule, with the far
// X staged through an mbarrier ring by producer warps, took 0.80 ms; a
// fused Gram (VecGram) made every schedule slower than this kernel followed
// by gram.cu. A z-plane ring (the tool's probe: a slice of 1,024-site
// planes a block, only +-32,768 from L2) took 0.47-0.58.
//
// Arithmetic: each output's sums run over the groups in plan order; within
// a group u accumulates the members' masked values in plan order with
// fmaf, then y_a = fmaf(H[a][b], u_b, y_a) for b = 0 .. bs - 1. A group of
// one adds fmaf(w H[a][b], x_b, y_a), the arithmetic of the (k, bs, ns)
// view's kernel, so without grouping (the plan's default at k = 1) Y has
// its bits; grouped sums change them.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kCmMaxDiags = 32;
constexpr int kCmMaxBs = 8;
constexpr int kCmMaxRows = 96;     // bs * kb rows a block
constexpr int kCmMaxThreads = 384;  // 12 warps: kb * sw
constexpr int kCmFar = 0x7fffffff;

// Flags of a diagonal in plan order.
constexpr int kFirstOfGroup = 1, kLastOfGroup = 2;

// The diagonals in plan (hop-group) order.
struct CmDiags {
  int o[kCmMaxDiags];      // offset in [0, ns)
  int sh[kCmMaxDiags];     // signed shift in [-h, h] of a near diagonal, kCmFar for a far one
  int slot[kCmMaxDiags];   // mask row, or -1
  int hop[kCmMaxDiags];    // row of the hop table
  int flags[kCmMaxDiags];
  int run[kCmMaxDiags];    // consecutive far diagonals from this one on (0: near)
};

// Row stride of a window of T + 2h sites.
__host__ __device__ inline int cm_window_ld(int T, int h) { return T + 2 * h + 4; }

// The compile-time spin width of bs.
__host__ __device__ inline int cm_spins(int bs) { return bs <= 4 ? 4 : 8; }

// Shared floats of a launch; mirrored by ops/const_block_stencil.py
// cm_smem_bytes. Two buffers of the window (m rows of T + 2h + 4) and the
// nmask mask rows of T, then the hop table padded to (nhop, BS, BS).
__host__ __device__ inline long long cm_smem_floats(int bs, int m, int T, int h, int nmask,
                                                    int nhop) {
  const int BS = cm_spins(bs);
  return 2LL * (1LL * m * cm_window_ld(T, h) + 1LL * nmask * T) + 1LL * nhop * BS * BS;
}

// kb: right-hand sides a block (a warp each, in sw warps over the tile's
// sites); a launch's items are (tile, group of kb right-hand sides) pairs,
// ng = ceil(k / kb) groups a tile.
struct CmLaunch {
  const float* hops;
  const float* masks;
  const float* X;
  float* Y;
  CmDiags dg;
  long long ns;
  int nd, bs, k, kb, ng, h, T, nmask, nhop;
  bool vec;
  RowMap row;  // the field's rows: the merged view's or the (k, bs, ns) view's
};

// PROBE: bits that switch parts of the kernel off, for timing probes only
// (tools/torch_kernel_times.py --variants builds them; the library's
// launches take 0): 2 no window copies, 4 no far loads. (Without the hop
// applies or the stores the compiler drops the loads that feed them, so
// the arithmetic has no probe of its own.)
constexpr int kCmNoWindow = 2, kCmNoFar = 4;

// Copy F[(j0 + v) mod ns], v < span, into d: the lanes of a warp share the
// row; vec takes 16-byte copies (j0, span, ns multiples of 4: a quad never
// straddles ns).
__device__ __forceinline__ void cm_copy_row(float* d, const float* F, long long j0, int span,
                                            long long ns, bool vec, int lane) {
  for (int v = (vec ? 4 : 1) * lane; v < span; v += (vec ? 4 : 1) * 32) {
    long long j = j0 + v;
    while (j >= ns) j -= ns;  // more than once only where the span is wider than ns
    if (vec) cp_async16(d + v, F + j, true);
    else cp_async4(d + v, F + j, true);
  }
}

// The block's copy of item (tile at i0, right-hand sides j0 .. j0 + kb - 1):
// the window (bs * kb rows at sites i0 - h .. i0 + T + h, mod ns, in the
// staged row order b * kb + ii, the field's row p.row(b, j0 + ii); a group
// past k repeats RHS k - 1) and the mask rows (sites i0 .. i0 + T - 1, zero
// past ns) into buf. Warp w of nw copies rows w, w + nw, ..., its lanes
// over the sites.
__device__ __forceinline__ void cm_copy_tile(const CmLaunch& p, float* buf, long long i0,
                                             int j0) {
  const int m = p.bs * p.kb, W = cm_window_ld(p.T, p.h);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  long long base = (i0 - p.h) % p.ns;  // the window's first site, in [0, ns)
  if (base < 0) base += p.ns;
  for (int r = warp; r < m; r += nwarps) {
    const int b = r / p.kb, i = min(j0 + r - b * p.kb, p.k - 1);
    cm_copy_row(buf + r * W, p.X + static_cast<long long>(p.row(b, i)) * p.ns, base,
                p.T + 2 * p.h, p.ns, p.vec, lane);
  }
  float* wm = buf + m * W;
  for (int r = warp; r < p.nmask; r += nwarps) {
    const float* F = p.masks + r * p.ns + i0;
    for (int q = (p.vec ? 4 : 1) * lane; q < p.T; q += (p.vec ? 4 : 1) * 32) {
      const bool in = i0 + q < p.ns;
      if (p.vec) cp_async16(wm + r * p.T + q, in ? F + q : p.masks, in);
      else cp_async4(wm + r * p.T + q, in ? F + q : p.masks, in);
    }
  }
}

// Two aligned quads of a row: the one at q - q % 4 and the next.
struct CmQuads {
  const float* lo;
  const float* hi;
};

// The four floats at q .. q + 3 from the aligned quads around q, R = q % 4
// (a diagonal's shift mod 4, the same for every thread).
template <int R>
__device__ __forceinline__ float4 cm_funnel(CmQuads q) {
  const float4 a = *reinterpret_cast<const float4*>(q.lo);
  if (R == 0) return a;
  const float4 b = *reinterpret_cast<const float4*>(q.hi);
  return R == 1 ? make_float4(a.y, a.z, a.w, b.x)
                : R == 2 ? make_float4(a.z, a.w, b.x, b.y) : make_float4(a.w, b.x, b.y, b.z);
}

template <int BS>
__device__ __forceinline__ void cm_add(float (&u)[BS][4], int b, float4 w, float4 x) {
  u[b][0] = fmaf(w.x, x.x, u[b][0]);
  u[b][1] = fmaf(w.y, x.y, u[b][1]);
  u[b][2] = fmaf(w.z, x.z, u[b][2]);
  u[b][3] = fmaf(w.w, x.w, u[b][3]);
}

// The (nhop, bs, bs) hop table into shared memory as (nhop, BS, BS) with
// hop e's entry (a, b) at e * BS * BS + b * BS + a, zero past bs: a float4
// read gives four rows a of a column b.
template <int BS>
__device__ __forceinline__ void cm_stage_hops(const CmLaunch& p, float* sh) {
  for (int e = threadIdx.x; e < p.nhop * BS * BS; e += blockDim.x) {
    const int hop = e / (BS * BS), b = e / BS % BS, a = e % BS;
    sh[e] = a < p.bs && b < p.bs ? p.hops[(hop * p.bs + a) * p.bs + b] : 0.f;
  }
}

// acc += (w H) u, in the order b, then a; hd: the hop's staged (BS, BS)
// table, column-major. SCALE: w per site (a masked group of one), else w = 1
// and the hop's entries are used as they are (the same bits: 1 * h = h).
template <bool SCALE, int BS>
__device__ __forceinline__ void cm_hop(const CmLaunch& p, const float* hd, float4 w,
                                       const float (&u)[BS][4], float (&acc)[BS][4]) {
#pragma unroll
  for (int b = 0; b < BS; ++b) {
    if (b < p.bs) {
      float hc[BS];
#pragma unroll
      for (int a4 = 0; a4 < BS; a4 += 4) {
        const float4 v = *reinterpret_cast<const float4*>(hd + b * BS + a4);
        hc[a4] = v.x;
        hc[a4 + 1] = v.y;
        hc[a4 + 2] = v.z;
        hc[a4 + 3] = v.w;
      }
#pragma unroll
      for (int a = 0; a < BS; ++a) {
        if (a < p.bs) {
          const float h = hc[a];
          const float4 hw = SCALE ? make_float4(w.x * h, w.y * h, w.z * h, w.w * h)
                                  : make_float4(h, h, h, h);
          acc[a][0] = fmaf(hw.x, u[b][0], acc[a][0]);
          acc[a][1] = fmaf(hw.y, u[b][1], acc[a][1]);
          acc[a][2] = fmaf(hw.z, u[b][2], acc[a][2]);
          acc[a][3] = fmaf(hw.w, u[b][3], acc[a][3]);
        }
      }
    }
  }
}

// row[(s + j + o) mod ns], j < 4, from L2; a site past ns reads column 0 (its
// sums are not stored). vec4: o and ns multiples of 4, row 16-byte aligned.
__device__ __forceinline__ float4 cm_far(const float* row, long long s, int o, long long ns,
                                         bool vec4) {
  if (vec4) {
    long long col = s + o;
    if (col >= ns) col -= ns;
    if (col >= ns) col = 0;
    return __ldg(reinterpret_cast<const float4*>(row + col));
  }
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    long long col = s + j + o;
    if (col >= ns) col -= ns;
    if (col >= ns) col = 0;
    v[j] = __ldg(row + col);
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// A thread's sums over the diagonals in plan order at sites s .. s + 3 of
// right-hand side i: near(shd, b) gives the aligned quads around a near
// diagonal's X of spin b, mask(slot) the quad of a mask row; hops: the table
// cm_stage_hops staged.
template <int BS, int PROBE, int NFB, typename Near, typename Mask>
__device__ __forceinline__ void cm_sums(const CmLaunch& p, const float* hops, long long s,
                                        int i, RowStrides rs, Near near, Mask mask,
                                        float (&acc)[BS][4]) {
  float u[BS][4];
#pragma unroll
  for (int a = 0; a < BS; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[a][j] = 0.f;
  // Diagonal d's share, its X from xq(b): u += w X (the group's first member
  // starts u), and at the group's last member acc += H u.
  auto member = [&](int d, auto&& xq) {
    const int fl = p.dg.flags[d], slot = p.dg.slot[d];
    if (fl & kFirstOfGroup) {
#pragma unroll
      for (int b = 0; b < BS; ++b)
#pragma unroll
        for (int j = 0; j < 4; ++j) u[b][j] = 0.f;
    }
    const float4 w = slot < 0 ? make_float4(1.f, 1.f, 1.f, 1.f) : mask(slot);
    // A group of one takes its mask into the hop, as the (k, bs, ns) view's
    // kernel does.
    const bool single = (fl & (kFirstOfGroup | kLastOfGroup)) == (kFirstOfGroup | kLastOfGroup);
    const float4 wu = single ? make_float4(1.f, 1.f, 1.f, 1.f) : w;
#pragma unroll
    for (int b = 0; b < BS; ++b)
      if (b < p.bs) cm_add(u, b, wu, xq(b));
    if (fl & kLastOfGroup) {
      const float* hd = hops + p.dg.hop[d] * BS * BS;
      if (single && slot >= 0) cm_hop<true>(p, hd, w, u, acc);
      else cm_hop<false>(p, hd, w, u, acc);
    }
  };
  for (int d = 0; d < p.nd;) {
    const int shd = p.dg.sh[d];
    if (shd != kCmFar) {
      const auto x = [&](auto r) {
        return [&, r](int b) { return cm_funnel<decltype(r)::value>(near(shd, b)); };
      };
      switch (shd & 3) {
        case 0: member(d, x(std::integral_constant<int, 0>())); break;
        case 1: member(d, x(std::integral_constant<int, 1>())); break;
        case 2: member(d, x(std::integral_constant<int, 2>())); break;
        default: member(d, x(std::integral_constant<int, 3>())); break;
      }
      ++d;
      continue;
    }
    // Up to NFB consecutive far diagonals at once, of one group or of
    // several: their loads are issued together, then added in plan order
    // (each member's sums as one at a time). On the ungrouped plan (a group
    // a diagonal, the (k, bs, ns) view's) loads batched by group would go
    // one at a time.
    const int nb = min(p.dg.run[d], NFB);
    float4 xf[NFB][BS];
#pragma unroll
    for (int f = 0; f < NFB; ++f) {
      if (f < nb && !(PROBE & kCmNoFar)) {
        const int o = p.dg.o[d + f];
        const bool v4 = p.vec && (o & 3) == 0;
#pragma unroll
        for (int b = 0; b < BS; ++b)
          if (b < p.bs) xf[f][b] = cm_far(p.X + b * rs.a + i * rs.i, s, o, p.ns, v4);
      }
    }
#pragma unroll
    for (int f = 0; f < NFB; ++f)
      if (f < nb)
        member(d + f, [&](int b) {
          return (PROBE & kCmNoFar) ? make_float4(0.f, 0.f, 0.f, 0.f) : xf[f][b];
        });
    d += nb;
  }
}

// Y at sites s .. s + 3 of right-hand side i: a float4 a row where the quad
// lies in the field and vec, else the sites below ns.
template <int BS>
__device__ __forceinline__ void cm_store(const CmLaunch& p, long long s, int i, RowStrides rs,
                                         const float (&acc)[BS][4]) {
#pragma unroll
  for (int a = 0; a < BS; ++a) {
    if (a >= p.bs) continue;
    float* y = p.Y + a * rs.a + i * rs.i + s;
    if (p.vec && s + 3 < p.ns) {
      *reinterpret_cast<float4*>(y) = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (s + j < p.ns) y[j] = acc[a][j];
    }
  }
}

// BS >= bs spins; kb * sw warps a block (blockDim.x). A block walks its
// items w = blockIdx.x + n * gridDim.x (group w / ntiles, tile w % ntiles:
// the grid sweeps the tiles one group at a time, so the far diagonals'
// band of the group stays in L2) with two buffers, by the parity of its
// item count. NFB: far diagonals whose loads are in flight together.
template <int BS, int PROBE = 0, int NFB = 2>
__global__ void __launch_bounds__(kCmMaxThreads) cm_spmm(const CmLaunch p) {
  extern __shared__ __align__(16) float smem[];  // 2 x (window | masks) | hops
  const int m = p.bs * p.kb, T = p.T, W = cm_window_ld(T, p.h);
  const int bfloats = m * W + p.nmask * T;
  float* sh = smem + 2 * bfloats;
  const long long ntiles = (p.ns + T - 1) / T, nitems = ntiles * p.ng;
  cm_stage_hops<BS>(p, sh);
  const int warp = threadIdx.x / 32, sw = T / 128;
  const int c = 4 * ((warp % sw) * 32 + threadIdx.x % 32), ii = warp / sw;
  const RowStrides rs = p.row.times(p.ns);
  float acc[BS][4];
  long long w = blockIdx.x;
  if (w < nitems && !(PROBE & kCmNoWindow))
    cm_copy_tile(p, smem, w % ntiles * T, static_cast<int>(w / ntiles) * p.kb);
  cp_async_commit();
  for (int lt = 0; w < nitems; w += gridDim.x, ++lt) {
    const float* wt = smem + (lt & 1) * bfloats;
    const float* wm = wt + m * W;
    const long long wn = w + gridDim.x;
    if (wn < nitems && !(PROBE & kCmNoWindow))
      cm_copy_tile(p, smem + ((lt + 1) & 1) * bfloats, wn % ntiles * T,
                   static_cast<int>(wn / ntiles) * p.kb);
    cp_async_commit();
    cp_async_wait<1>();  // this item's buffer has landed
    __syncthreads();     // ... for every thread's share of it (and the hop table)
    const long long s = w % ntiles * T + c;
    const int i = static_cast<int>(w / ntiles) * p.kb + ii;  // this warp's RHS
    const int q0 = p.h + c;
    cm_sums<BS, PROBE, NFB>(
        p, sh, s, min(i, p.k - 1), rs,
        [&](int shd, int b) {
          const float* lo = wt + (b * p.kb + ii) * W + ((q0 + shd) & ~3);
          return CmQuads{lo, lo + 4};
        },
        [&](int slot) { return *reinterpret_cast<const float4*>(wm + slot * T + c); }, acc);
    if (s < p.ns && i < p.k) cm_store(p, s, i, rs, acc);
    __syncthreads();  // every read of this buffer is done: refill it
  }
  cp_async_wait<0>();
}

template <int BS, int PROBE = 0, int NFB = 2>
cudaError_t cm_launch(const CmLaunch& p, int max_blocks, int device, cudaStream_t stream) {
  auto kernel = cm_spmm<BS, PROBE, NFB>;
  const int threads = p.kb * (p.T / 128) * 32;
  const size_t smem =
      cm_smem_floats(p.bs, p.bs * p.kb, p.T, p.h, p.nmask, p.nhop) * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(kernel, threads, smem, device, (p.ns + p.T - 1) / p.T * p.ng,
                        max_blocks, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Check a launch's arguments and fill in p; cudaSuccess or
// cudaErrorInvalidValue. order: nhop diagonal indices (into offsets, slots
// and the hop table) in plan order; gid: each ordered diagonal's hop group
// (a group's members consecutive, one hop). T: the tile's sites (a
// multiple of 4); kb: right-hand sides a block; merged: the field's view.
cudaError_t cm_make_launch(CmLaunch* p, const float* hops, int nhop, const int* offsets,
                           const int* slots, const int* order, const int* gid, int bs,
                           const float* masks, int nmask, const float* X, float* Y, int k,
                           long long ns, int h, int T, int kb, int max_blocks, int merged = 1) {
  if (nhop < 1 || nhop > kCmMaxDiags || bs < 1 || bs > kCmMaxBs || k < 1 || kb < 1 ||
      bs * kb > kCmMaxRows || ns < 1 || T < 4 || T % 4 != 0 || h < 0 ||
      h % 4 != 0 || nmask < 0 || (nmask > 0) != (masks != nullptr) || max_blocks < 1)
    return cudaErrorInvalidValue;
  const int nd = nhop;
  *p = CmLaunch{hops, masks, X, Y, {}, ns, nd, bs, k, kb, (k + kb - 1) / kb, h, T, nmask, nhop,
                false, row_map(merged != 0, bs, k)};
  bool seen[kCmMaxDiags] = {};
  for (int d = 0; d < nd; ++d) {
    const int e = order[d];
    if (e < 0 || e >= nhop || seen[e]) return cudaErrorInvalidValue;
    seen[e] = true;
    const int o = offsets[e];
    if (o < 0 || o >= ns || slots[e] < -1 || slots[e] >= nmask) return cudaErrorInvalidValue;
    // A group's members are consecutive: a group id seen before must be the
    // previous diagonal's.
    for (int c = 0; c + 1 < d; ++c)
      if (gid[c] == gid[d] && gid[d - 1] != gid[d]) return cudaErrorInvalidValue;
    int flags = 0;
    if (d == 0 || gid[d - 1] != gid[d]) flags |= kFirstOfGroup;
    if (d == nd - 1 || gid[d + 1] != gid[d]) flags |= kLastOfGroup;
    p->dg.o[d] = o;
    p->dg.sh[d] = o <= h ? o : (ns - o <= h ? static_cast<int>(o - ns) : kCmFar);
    p->dg.slot[d] = slots[e];
    p->dg.hop[d] = e;  // the group applies its last member's hop: the plan groups equal hops
    p->dg.flags[d] = flags;
  }
  for (int d = nd - 1; d >= 0; --d)
    p->dg.run[d] = p->dg.sh[d] != kCmFar ? 0 : 1 + (d + 1 < nd ? p->dg.run[d + 1] : 0);
  p->vec = ns % 4 == 0 && aligned16(X) && aligned16(Y) && (masks == nullptr || aligned16(masks));
  return cudaSuccess;
}

}  // namespace

// offsets, slots: host arrays of nhop entries (the operator's main
// diagonals; offsets reduced to [0, ns)); hops: device (nhop, bs, bs);
// masks: device (nmask, ns), or null with nmask = 0. order, gid: host arrays
// of nhop entries, the plan's diagonal order and hop groups. X, Y: device
// fields of m = bs * k rows, merged (row b * k + i) when merged != 0, else
// the (k, bs, ns) view (row i * bs + b). h, sw, kb and max_blocks come from
// ops/const_block_stencil.py const_block_stencil_plan (T = 128 * sw sites a
// tile, sw one of 1, 2, 4; kb right-hand sides a block, kb * sw <= 12).
extern "C" int bcg_cbs_merged_spmm(const float* hops, int nhop, const int* offsets,
                                   const int* slots, const int* order, const int* gid, int bs,
                                   const float* masks, int nmask, const float* X, float* Y,
                                   int k, long long ns, int merged, int h, int sw, int kb,
                                   int max_blocks, int device, cudaStream_t stream) {
  if ((sw != 1 && sw != 2 && sw != 4) || kb * sw * 32 > kCmMaxThreads)
    return cudaErrorInvalidValue;
  CmLaunch p;
  cudaError_t err = cm_make_launch(&p, hops, nhop, offsets, slots, order, gid, bs, masks, nmask,
                                   X, Y, k, ns, h, 128 * sw, kb, max_blocks, merged);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return bs <= 4 ? cm_launch<4>(p, max_blocks, device, stream)
                 : cm_launch<8>(p, max_blocks, device, stream);
}
