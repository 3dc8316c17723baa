// Per-site block stencil (matrix-valued links) on lanes-major fields, with
// an optional fused Gram.
//
// Replaces the Pallas kernels blockcg_tpu/ops/block_stencil.py
// block_stencil_spmm_t (:94), block_stencil_spmm_m_t (:371) and
// block_stencil_spmm_m_gram_t (:383), and the ring schedule of the same
// contract, blockcg_tpu/ops/block_stencil_ring.py ring_block_spmm_m_t (:359)
// and ring_block_spmm_m_gram_t (:371), their fold= mode included.
//
// Contract: blocks (noff, bs, bs, ns) float32 or bfloat16 (lifted exactly to
// f32), each (d, a, b) row contiguous
// over the sites; offsets reduced to [0, ns). For every right-hand side i,
//   Y[row(a, i), s] = sum_d sum_b blocks[d, a, b, s] * X[row(b, i), (s + o_d) mod ns]
// on a (bs * k, ns) field whose row map is a runtime pair of strides
// (RowMap in common.cuh): the merged spin-major view (m, ns), or the
// (k, bs, ns) view (= flat (k, bs * ns)).
// The Gram variant (merged only) also returns G = X Y^T (m x m).
//
// Bound: bytes. At 32^4 sites, bs = 4, k = 12 (m = 48) and 15 diagonals, the
// contract reads the blocks once (15 * 16 * 4 B * 1,048,576 = 1.007 GB, 71%
// of it), X once (201 MB) and writes Y once (201 MB): 1.41 GB, 0.42 ms at the
// H100's 3.35 TB/s. The arithmetic, 2 * 15 * 16 * 12 * ns = 6.0 GFLOP (+ 4.8
// for the Gram), takes 0.16 ms at 67 TFLOP/s f32, so the blocks' stream sets
// the pace. The realified complex operator (bs = 8, k = 6) moves 4.03 GB of
// blocks and 0.40 GB of fields: 1.32 ms. The kernel this replaced (one
// thread a site holding all m outputs in registers, 128-thread blocks, each
// coefficient and each X value a scalar global load at its use, X re-read
// per diagonal through L1/L2, a GramTile Gram) took 1.98 ms (3.26 with the
// Gram) at m = 48.
//
// Design. A persistent grid of blocks, one an SM, walks tiles of T sites, each
// as nd + 1 stages: first the tile's window of X (all m rows, sites i0 - h ..
// i0 + T + h mod ns; two windows, by the parity of the block's tile count),
// then one stage a diagonal: its bs^2 coefficient planes at the tile's sites
// and, for a far diagonal (|o| > h), the m rows of X at (s + o) mod ns; near
// diagonals read the window. The block is warp-specialised: PW producer
// warps copy the stages into a ring of `stages` shared slots with cp.async
// (16-byte copies; 4-byte ones where rows are not 16-byte aligned, ns % 4 !=
// 0 or an offset view, or a far offset is not a multiple of 4), and 8
// consumer warps compute, each thread a site and a group of KI right-hand
// sides (T = 256 / groups), BS x KI sums. mbarriers hand the slots over: a
// stage's copies arrive on its slot's `full` barrier when they land, the
// consumers arrive on `empty` when done with it and on `wfree` when done
// with a window, so the copies run up to `stages` stages ahead of the
// arithmetic. The host plan (ops/block_stencil.py block_stencil_plan) picks
// h, the split and the ring depth from the offsets, the rows and the card's
// shared memory: at m = 48 on the matrix-link offsets h = 32 (0, +-1, +-31,
// +-32 from the window), two groups of 6 over 128 sites, four stages.
// Staged rows are in the order b * k + i whatever the field's row map (the
// copies apply it), and lanes read consecutive sites: conflict-free shared
// reads.
//
// What the variants showed (H100, tools/torch_kernel_times.py --variants):
// the copies set the time. With the copies and the arithmetic done by the
// same 8 warps, stage after stage, the apply took 2.35 ms at m = 48, the
// copies alone 1.58: the arithmetic did not overlap them, and a deeper ring
// did not help. Split over warps, the copies run at the rate of the warps
// that issue them (2 producer warps: 4.1 ms, 4: 2.3, 8: 1.6), so 8 producer
// warps sit beside the 8 consumer warps. Without the window (every
// diagonal's X staged) the apply took 2.4 ms; on tiles of 64 or 32 sites
// (4 or 8 groups) 3.0 and 5.9. 1-D bulk copies (the TMA engine, one copy a
// 512-byte row) were slower than cp.async here (3.66 ms).
//
// Arithmetic: each output adds its terms in the order d = 0..nd-1, then b =
// 0..bs-1, with fmaf, as the kernel this replaced did, so Y keeps its bits.
//
// Gram: after a tile's last diagonal its Y goes to a (m, T + 4) shared tile,
// and VecGram (common.cuh; 4x4 register tiles fed by float4 reads, 6x6 at 96
// rows) adds X Y^T over the window's centre and that tile while the
// producers copy the next tile. Each block writes one (m, m) partial, and
// reduce_partials sums the partials in block order in double. No atomics: a
// repeated call gives the same bits.
//
// Width: one launch holds m = bs * k <= 96 rows (the wrapper issues one
// launch per chunk of right-hand sides beyond that); the Gram is fused where
// the split has at most two groups and the plan fits (the Gram's register
// width is 2 BS KI), else the wrapper takes it from gram.cu.
//
// bf16 blocks (CE = __nv_bfloat16; the reference's gate takes bf16 or f32
// blocks with f32 fields, a memory option): the ring's coefficient planes
// are staged as bf16, 16-byte copies of 8 sites where ns % 8 == 0 and the
// blocks are 16-byte aligned, else 4-byte copies of 2 sites (ns even), and
// each is lifted to f32 exactly at its use. X, Y and every sum stay f32, in
// the order of the f32 kernel, so bf16 blocks give the bits of the f32
// kernel on the lifted blocks. At 32^4, m = 48 the blocks' stream falls from
// 1.007 GB to 0.503 GB: 0.27 ms of bytes against 0.42.
//
// Folded wraps (fold != nullptr; the reference's fold=, block_stencil_ring.py
// :62-97): a folded diagonal's coefficients carry a bulk hop o and its
// toroidal wrap partner w = o (1 - L) on complementary sites, so one stream
// serves both. Its source site is chosen per destination s: (s + w) mod ns
// where (s / st) % L == phase (st = |o|; phase L - 1 for o > 0, 0 for o < 0),
// (s + o) mod ns elsewhere. Where both shifts lie within the window's halo
// (the x-axis pair at 32^4: +-1 and -+31 in h = 32), the consumer reads each
// site's X from the window at its own shift. Otherwise the diagonal is
// staged as a far one: the producers copy each site's X from its own
// source, 16 bytes at a time where four sites share their choice and an
// aligned source (st, o and w multiples of 4), else 4 bytes a site. Its
// terms are added where its bulk partner's were, so the sum is not bitwise
// the unfolded one.
#include "mma.cuh"

namespace {

constexpr int kMaxDiags = 32;
constexpr int kMaxBs = 8;
constexpr int kBsThreads = 256;  // consumer threads: T sites x groups
constexpr int kBsProducerWarps = 8;  // warps issuing the copies (as many as consume)
constexpr int kBsMaxRows = 96;  // m = bs * k of one launch
constexpr int kBsMaxStages = 4;
constexpr int kBsScratch = 16384;  // floor of a Gram launch's shared floats (VecGram::store)
constexpr int kFar = 0x7fffffff;

struct Offsets {
  int o[kMaxDiags];  // site offsets, each in [0, ns)
  int s[kMaxDiags];  // signed shift in [-h, h] of a near diagonal, kFar for a far one
  // Folded diagonals (st > 0): the wrap source offset in [0, ns), the run st
  // of sites sharing a choice, the axis extent L and the wrap phase; fs, the
  // wrap's signed shift in [-h, h] where the diagonal is near (s != kFar).
  int fw[kMaxDiags], fst[kMaxDiags], fL[kMaxDiags], fph[kMaxDiags], fs[kMaxDiags];
  int fgl[kMaxDiags];  // bs_tma: log2 of the sites of a far slab's granule (tma_launch_ok)
};

// Row stride of a window of T + 2h sites: plus 4, so it is 4 mod 8 words for
// VecGram's float4 reads of the centre.
__host__ __device__ inline int window_ld(int T, int h) { return T + 2 * h + 4; }

// Bytes of one ring slot: the bs^2 coefficient planes of T sites of
// csize-byte elements and, with any far diagonal, m float rows of X.
__host__ __device__ inline long long bs_slot_bytes(int bs, int m, int T, bool far, int csize) {
  return 1LL * csize * bs * bs * T + (far ? 4LL * m * T : 0);
}

// Shared bytes of a launch; mirrored by ops/block_stencil.py smem_bytes.
// Two float windows (m, W); `stages` ring slots; with the Gram the (m, T +
// 4) Y tile, and at least the Gram's end-of-kernel scratch.
__host__ __device__ inline long long bs_smem_bytes(int bs, int m, int T, int h, int stages,
                                                   bool far, bool gram, int csize) {
  long long b = 8LL * m * window_ld(T, h) + stages * bs_slot_bytes(bs, m, T, far, csize) +
                (gram ? 4LL * m * (T + 4) : 0);
  if (gram && b < 4LL * kBsScratch) b = 4LL * kBsScratch;
  return b;
}

struct Launch {
  const void* blocks;  // of the kernel's CE
  const float* X;
  float* Y;
  float* part;
  Offsets offs;
  RowMap row;
  long long ns;
  int nd, bs, k, h, T, stages;
  bool far, vec, cvec;  // vec: 16-byte copies of X; cvec: of the coefficients
  // bs_tma (tma_launch_ok): a folded diagonal near (read at each site's
  // shift) or far in granules narrower than T
  bool fold_near, fold_granules;
};

// PROBE: bits that switch parts of the kernel off, for timing probes only
// (tools/torch_kernel_times.py --variants builds them; the library's
// launches take 0): 1 no arithmetic, 2 no far-X copies, 4 no coefficient
// copies, 8 no window copies.
constexpr int kProbeNoMath = 1, kProbeNoFar = 2, kProbeNoCoef = 4, kProbeNoWindow = 8;

// Copy F[(j0 + v) mod ns], v < span, into d: the lanes of a warp share the
// row; vec takes 16-byte copies (j0, span, ns multiples of 4: a quad never
// straddles ns).
__device__ __forceinline__ void copy_row(float* d, const float* F, long long j0, int span,
                                         long long ns, bool vec, int lane) {
  for (int v = (vec ? 4 : 1) * lane; v < span; v += (vec ? 4 : 1) * 32) {
    long long j = j0 + v;
    while (j >= ns) j -= ns;  // more than once only where the span is wider than ns
    if (vec) cp_async16(d + v, F + j, true);
    else cp_async4(d + v, F + j, true);
  }
}

// Row r (staged order b * k + i) of X.
__device__ __forceinline__ const float* x_row(const Launch& p, int r) {
  const int b = r / p.k, i = r - b * p.k;
  return p.X +
         (static_cast<long long>(b) * p.row.sa + static_cast<long long>(i) * p.row.si) * p.ns;
}

// The m rows of X for folded diagonal d at the T sites from i0 into dst,
// each site's from its own source (see the header); the lanes of a warp take
// four consecutive sites each.
__device__ __forceinline__ void copy_folded(const Launch& p, float* dst, int d, long long i0,
                                            int warp, int nwarps, int lane) {
  const int m = p.bs * p.k, st = p.offs.fst[d], L = p.offs.fL[d], ph = p.offs.fph[d];
  const long long o = p.offs.o[d], w = p.offs.fw[d];
  const bool vec = p.vec && st % 4 == 0 && o % 4 == 0 && w % 4 == 0;
  for (int r = warp; r < m; r += nwarps) {
    const float* F = x_row(p, r);
    float* dr = dst + r * p.T;
    for (int q = 4 * lane; q < p.T; q += 4 * 32) {
      if (vec) {  // i0 + q, o and w multiples of 4: four sites, one choice, one aligned quad
        const long long s = i0 + q;
        long long j = s + ((s / st) % L == ph ? w : o);
        while (j >= p.ns) j -= p.ns;
        cp_async16(dr + q, F + j, true);
      } else {
        for (int e = 0; e < 4; ++e) {
          const long long s = i0 + q + e;
          long long j = s + ((s / st) % L == ph ? w : o);
          while (j >= p.ns) j -= p.ns;
          cp_async4(dr + q + e, F + j, true);
        }
      }
    }
  }
}

// The producer warps' share (thread `pt` of 32 PW) of stage j of the
// tile at i0: j = 0, the m rows of X at sites i0 - h .. i0 + T + h (mod ns)
// into the window; j = 1 + d, diagonal d's bs^2 coefficient planes at sites
// i0 .. i0 + T - 1 (zero past ns) and, for a far diagonal, the m rows of X at
// (s + o_d) mod ns into the slot (a folded one's from each site's source).
// Producer warp w copies rows w, w + PW, ..., its lanes over the sites.
template <typename CE, int PROBE, int PW>
__device__ __forceinline__ void produce(const Launch& p, float* win, char* slot, int j,
                                        long long i0, int pt) {
  const int m = p.bs * p.k, W = window_ld(p.T, p.h), planes = p.bs * p.bs;
  const int warp = pt / 32, lane = pt % 32, nwarps = PW;
  if (j == 0) {
    if (PROBE & kProbeNoWindow) return;
    long long base = (i0 - p.h) % p.ns;  // the window's first site, in [0, ns)
    if (base < 0) base += p.ns;
    for (int r = warp; r < m; r += nwarps)
      copy_row(win + r * W, x_row(p, r), base, p.T + 2 * p.h, p.ns, p.vec, lane);
    return;
  }
  const int d = j - 1;
  if (!(PROBE & kProbeNoCoef)) {
    // 16-byte copies of kVec<CE> sites, else 4-byte ones of 4 / sizeof(CE)
    const int step = p.cvec ? kVec<CE> : 4 / static_cast<int>(sizeof(CE));
    const CE* blocks = static_cast<const CE*>(p.blocks);
    const CE* base = blocks + static_cast<long long>(d) * planes * p.ns + i0;
    CE* cs = reinterpret_cast<CE*>(slot);
    for (int e = warp; e < planes; e += nwarps) {
      const CE* F = base + static_cast<long long>(e) * p.ns;
      for (int q = step * lane; q < p.T; q += step * 32) {
        const bool in = i0 + q < p.ns;
        if (p.cvec) cp_async16(cs + e * p.T + q, in ? F + q : blocks, in);
        else cp_async4(cs + e * p.T + q, in ? F + q : blocks, in);
      }
    }
  }
  if (p.offs.s[d] == kFar && !(PROBE & kProbeNoFar)) {
    float* xs = reinterpret_cast<float*>(slot + sizeof(CE) * planes * p.T);
    if (p.offs.fst[d] > 0) {
      copy_folded(p, xs, d, i0, warp, nwarps, lane);
      return;
    }
    long long j0 = i0 + p.offs.o[d];
    if (j0 >= p.ns) j0 -= p.ns;
    const bool vec = p.vec && p.offs.o[d] % 4 == 0;
    for (int r = warp; r < m; r += nwarps)
      copy_row(xs + r * p.T, x_row(p, r), j0, p.T, p.ns, vec, lane);
  }
}

// The fused Gram's register tiles: 4x4 (6x6 at 96 rows, where 4x4 tiles
// would pass 256 threads a copy), so that its sums fit beside the apply's
// under the 128 registers of a 512-thread block: 6x6 tiles at 48 rows
// spilled 132 bytes (tools/torch_ptxas.py).
template <int BS, int KI>
using BsGram = VecGram<2 * BS * KI, kBsThreads, 2 * BS * KI == 96 ? 6 : 4>;

// One diagonal's terms of a consumer thread (its site column, RHS i0g ..
// i0g + KI - 1) added to acc: X from xs (staged rows b * k + i at row stride
// lx: the window, or a slot's far rows), the coefficients from cs (the
// slot's planes at the thread's column, plane stride T). The diagonal's X
// loads first, then, for each b, its column of coefficients and their FMAs:
// the order b, then a, of the kernel this replaced.
template <int BS, int KI, typename CE>
__device__ __forceinline__ void apply_diag(float (&acc)[BS][KI], const Launch& p,
                                           const float* xs, int lx, const CE* cs, int T,
                                           int i0g) {
  float x[BS][KI];
#pragma unroll
  for (int b = 0; b < BS; ++b)
#pragma unroll
    for (int ii = 0; ii < KI; ++ii)
      x[b][ii] = b < p.bs ? xs[(b * p.k + min(i0g + ii, p.k - 1)) * lx] : 0.f;
#pragma unroll
  for (int b = 0; b < BS; ++b) {
    if (b < p.bs) {
      float w[BS];
#pragma unroll
      for (int a = 0; a < BS; ++a) w[a] = a < p.bs ? to_f32(cs[(a * p.bs + b) * T]) : 0.f;
#pragma unroll
      for (int a = 0; a < BS; ++a) {
        if (a < p.bs) {
#pragma unroll
          for (int ii = 0; ii < KI; ++ii) acc[a][ii] = fmaf(w[a], x[b][ii], acc[a][ii]);
        }
      }
    }
  }
}

// A barrier of the consumer warps alone (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kBsThreads) : "memory");
}

// BS >= bs spins, KI right-hand sides a consumer thread (group g holds RHS
// g*KI ..); GRAM: the fused Gram, on a VecGram of 2 BS KI rows (>= m with at
// most two groups); CE: the blocks' element (float or bf16). Warps 0-7
// consume, the PW after them produce. A block walks its tiles t = blockIdx.x
// + i * gridDim.x, each as nd + 1 stages (the window,
// then one a diagonal); stage q of the walk lives in ring slot q % stages.
// Barriers: full[s], the producers' copies of the slot's stage have landed
// (32 PW cp.async arrivals); empty[s], every consumer warp is done
// with it (kBsThreads / 32 arrivals); wfree[b], every consumer warp is done
// with window b's tile, its Gram included.
template <int BS, int KI, bool GRAM, int PROBE = 0, int PW = kBsProducerWarps,
          typename CE = float>
__global__ void __launch_bounds__(kBsThreads + 32 * PW, 1) bs_spmm(const Launch p) {
  extern __shared__ __align__(16) float smem[];  // 2 windows | ring | sY
  __shared__ unsigned long long full[kBsMaxStages], empty[kBsMaxStages], wfree[2];
  const int m = p.bs * p.k, T = p.T, W = window_ld(T, p.h), LY = T + 4;
  const int planes = p.bs * p.bs;
  const int slot_bytes = static_cast<int>(bs_slot_bytes(p.bs, m, T, p.far, sizeof(CE)));
  float* win = smem;
  char* ring = reinterpret_cast<char*>(smem + 2 * m * W);
  float* sy = reinterpret_cast<float*>(ring + p.stages * slot_bytes);
  const int per_tile = p.nd + 1;
  const long long ntiles = (p.ns + T - 1) / T;
  const int cwarps = kBsThreads / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 32 * PW);
      mbar_init(&empty[s], cwarps);
    }
    mbar_init(&wfree[0], cwarps);
    mbar_init(&wfree[1], cwarps);
    mbar_fence_init();
  }
  __syncthreads();
  BsGram<BS, KI> gram;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= kBsThreads) {  // producers
    const int pt = threadIdx.x - kBsThreads;
    unsigned q = 0;
    for (long long t = blockIdx.x, lt = 0; t < ntiles; t += gridDim.x, ++lt) {
      for (int j = 0; j < per_tile; ++j, ++q) {
        const int sl = static_cast<int>(q % p.stages);
        if (lane == 0) {
          if (q >= static_cast<unsigned>(p.stages))
            mbar_wait(&empty[sl], (q / p.stages - 1) & 1);  // the slot's last stage is consumed
          if (j == 0 && lt >= 2) mbar_wait(&wfree[lt & 1], (lt / 2 - 1) & 1);  // tile lt - 2 too
        }
        __syncwarp();
        produce<CE, PROBE, PW>(p, win + (lt & 1) * m * W, ring + sl * slot_bytes, j, t * T, pt);
        cp_async_mbar_arrive(&full[sl]);
      }
    }
  } else {  // consumers
    const int c = threadIdx.x % T, i0g = (threadIdx.x / T) * KI;  // site column, first RHS
    float acc[BS][KI];
    unsigned q = 0;
    for (long long t = blockIdx.x, lt = 0; t < ntiles; t += gridDim.x, ++lt) {
      const float* wt = win + (lt & 1) * m * W;
      const long long s = t * T + c;
      for (int j = 0; j < per_tile; ++j, ++q) {
        const int sl = static_cast<int>(q % p.stages);
        if (lane == 0) mbar_wait(&full[sl], (q / p.stages) & 1);  // the stage has landed
        __syncwarp();
        if (j > 0 && !(PROBE & kProbeNoMath)) {
          const int d = j - 1;
          if (d == 0) zero(acc);
          const char* sp = ring + sl * slot_bytes;
          int sh = p.offs.s[d];
          const int st = p.offs.fst[d];
          if (sh != kFar && st > 0 && (s / st) % p.offs.fL[d] == p.offs.fph[d])
            sh = p.offs.fs[d];  // a near folded diagonal's wrap site
          const float* xs = sh != kFar
                                ? wt + p.h + sh + c
                                : reinterpret_cast<const float*>(sp + sizeof(CE) * planes * T) + c;
          apply_diag(acc, p, xs, sh != kFar ? W : T, reinterpret_cast<const CE*>(sp) + c, T,
                     i0g);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[sl]);  // this warp is done with the slot
      }
      if (!(PROBE & kProbeNoMath)) {
        const bool valid = s < p.ns;
        const RowStrides rs = p.row.times(p.ns);
        if constexpr (GRAM) consumers_sync();  // the last tile's Gram is done with sY
#pragma unroll
        for (int a = 0; a < BS; ++a)
#pragma unroll
          for (int ii = 0; ii < KI; ++ii) {
            const int i = i0g + ii;
            if (a < p.bs && i < p.k) {
              if (valid) p.Y[s + a * rs.a + i * rs.i] = acc[a][ii];
              if constexpr (GRAM) sy[(a * p.k + i) * LY + c] = valid ? acc[a][ii] : 0.f;
            }
          }
        if constexpr (GRAM) {
          consumers_sync();  // sY is written
          gram.accumulate(wt + p.h, W, sy, LY, T, m);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&wfree[lt & 1]);  // this warp is done with the window
    }
  }
  if constexpr (GRAM) {
    __syncthreads();
    gram.store(p.part + static_cast<long long>(blockIdx.x) * m * m, m, smem);
  }
}

template <int BS, int KI, bool GRAM, int PROBE = 0, int PW = kBsProducerWarps,
          typename CE = float>
cudaError_t launch(const Launch& p, float* G, int max_blocks, int device, cudaStream_t stream) {
  static_assert(BsGram<BS, KI>::kScratch <= kBsScratch,
                "the Gram's scratch must fit the shared floor");
  auto kernel = bs_spmm<BS, KI, GRAM, PROBE, PW, CE>;
  const size_t smem =
      bs_smem_bytes(p.bs, p.bs * p.k, p.T, p.h, p.stages, p.far, GRAM, sizeof(CE));
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(kernel, kBsThreads + 32 * PW, smem, device, (p.ns + p.T - 1) / p.T,
                        max_blocks, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBsThreads + 32 * PW, smem, stream>>>(p);
  if (GRAM) launch_reduce(p.part, G, p.bs * p.k, grid, stream);
  return cudaGetLastError();
}

template <int BS, int KI, typename CE>
cudaError_t by_gram(const Launch& p, float* G, int max_blocks, int device, cudaStream_t stream) {
  return G != nullptr
             ? launch<BS, KI, true, 0, kBsProducerWarps, CE>(p, G, max_blocks, device, stream)
             : launch<BS, KI, false, 0, kBsProducerWarps, CE>(p, G, max_blocks, device, stream);
}

// Check a launch's arguments and fill in p (the near/far split of the
// offsets, the folds, the copy widths); cudaSuccess or
// cudaErrorInvalidValue. csize: bytes of a block element (4 or 2); fold:
// null, or a host array of nd quadruples (wrap offset in [0, ns), st, L,
// phase), st = 0 for a diagonal that is not folded.
cudaError_t make_launch(Launch* p, const void* blocks, const int* offsets, int nd, int bs,
                        const float* X, float* Y, float* part, bool gram, int k, int ks,
                        long long ns, int merged, int h, int groups, int ki, int stages,
                        int max_blocks, int csize = 4, const int* fold = nullptr) {
  const int bsw = bs < 1 ? 0 : bs <= 4 ? 4 : bs <= kMaxBs ? 8 : 0;
  const bool pow2 = groups == 1 || groups == 2 || groups == 4 || groups == 8;
  if (nd < 1 || nd > kMaxDiags || bsw == 0 || k < 1 || bs * k > kBsMaxRows || ns < 1 ||
      max_blocks < 1 || ks < k || !pow2 || ki * groups < k || stages < 2 ||
      stages > kBsMaxStages || h < 0 || h % 4 != 0 ||
      (gram && (!merged || ks != k || groups > 2)) || (csize != 4 && csize != 2) ||
      (csize == 2 && (ns % 2 != 0 || reinterpret_cast<size_t>(blocks) % 4 != 0)))
    return cudaErrorInvalidValue;
  *p = Launch{blocks, X, Y, part, {}, row_map(merged != 0, bs, ks), ns, nd, bs, k, h,
              kBsThreads / groups, stages, false, false, false, false, false};
  for (int d = 0; d < nd; ++d) {
    const int o = offsets[d];
    if (o < 0 || o >= ns) return cudaErrorInvalidValue;
    p->offs.o[d] = o;
    p->offs.s[d] = o <= h ? o : (ns - o <= h ? static_cast<int>(o - ns) : kFar);
    const int* f = fold != nullptr ? fold + 4 * d : nullptr;
    if (f != nullptr && f[1] > 0) {
      if (f[0] < 0 || f[0] >= ns || f[2] < 2 || f[3] < 0 || f[3] >= f[2])
        return cudaErrorInvalidValue;
      p->offs.fw[d] = f[0];
      p->offs.fst[d] = f[1];
      p->offs.fL[d] = f[2];
      p->offs.fph[d] = f[3];
      const int w = f[0];
      p->offs.fs[d] = w <= h ? w : (ns - w <= h ? static_cast<int>(w - ns) : kFar);
      if (p->offs.fs[d] == kFar) p->offs.s[d] = kFar;  // staged: each site's source
    }
    p->far = p->far || p->offs.s[d] == kFar;
  }
  p->vec = ns % 4 == 0 && aligned16(X);
  p->cvec = ns % (16 / csize) == 0 && aligned16(blocks);
  return cudaSuccess;
}

// ---- the merged view staged by TMA tensor boxes (bs_tma)
//
// Rows 23h and 24h (block_stencil_spmm_m_t on bf16 blocks, no Gram, no
// folds), row 22h (block_stencil_spmm_t, the (k, bs, ns) view, on bf16
// blocks) and the folded rows 24f and 24fg (fold=, f32 or bf16 blocks, with
// or without the Gram, which gram.cu takes). bs_spmm's copies set its pace
// at the rate of the warps that issue them (see the header: 8 producer
// warps of 16-byte cp.async, 1.57 ms at 32^4, m = 48, for 2.42 GB of L2->SM
// copies, about 1.5 TB/s). Here one elected lane issues each stage as TMA
// tensor copies that complete on the slot's `full` mbarrier (expect_tx):
// the window (a box of m rows by T + 2h sites of the f32 field), each
// diagonal's bs^2 coefficient planes at the tile's sites (a box of a 3-D
// map over (ns, bs^2, nd) of the blocks, f32 or bf16; sites past ns
// zero-filled) and, for a far diagonal, its slab of m rows by T sites. The
// field is one 3-D map over (ns, k, bs) with the strides of its row map,
// RHS i at si rows and spin b at sa rows (the merged view: 1 and ks; the (k,
// bs, ns) view: bs and 1, strides that do not increase), so a box lays the
// staged rows in the order b * k + i on either view, also on a launch of a
// chunk of right-hand sides, and the consumers are the same. A box lays its
// rows at its own width: the window's rows are T + 2h apart (the lanes of a
// warp read consecutive sites of a row, conflict-free).
//
// Folds. A near folded diagonal (the x-axis pair at 32^4: +-1 and -+31 in h
// = 32) reads the window at each site's own shift, as bs_spmm does. A far
// folded diagonal's source changes only every st = |o| sites, so a tile of
// T sites is at most T / g runs of g sites that share one (g = T where the
// runs are whole tiles, st % T == 0; else the largest power of two dividing
// st): its slab is laid granule by granule, each granule one box of g sites
// from its own source, its m rows g apart. At 32^4 on tiles of 128 sites:
// the y pair (st = 32) four boxes a slab, the z and t pairs (st = 1,024 and
// 32,768) one; with the window and nine coefficient boxes, 22 requests a
// tile.
//
// A box that would cross ns (the windows of the first and last tiles, a far
// slab or granule whose source runs past ns), start off a 16-byte boundary
// (an offset that is not a multiple of 4: such a box raised an illegal
// instruction on an H100), or land off a 128-byte boundary is copied
// instead by the producer warp's lanes with cp.async into the same layout,
// committed and waited on before lane 0 posts the stage.
//
// The consumer warps and their arithmetic are bs_spmm's (apply_diag, in the
// order d, then b, then a; a folded diagonal's terms where its bulk
// partner's were), so Y keeps its bits: bitwise bs_spmm's on the same
// blocks, and bf16 blocks bitwise the f32 kernel on the blocks lifted to
// f32. A folded launch's Gram (row 24fg) is gram.cu's on X and the stored Y:
// at 32^4, m = 48 the apply and gram.cu took 1.165 ms on an H100 where the
// Gram fused here (bs_spmm's VecGram beside the consumers, its Y tile
// taking a slot's room) took 1.275, both before the producer's lighter
// stages below (0.973 since, with gram.cu). The one producer warp frees
// shared memory and issue slots for a deeper ring (kBtMaxStages): at 32^4,
// m = 48 on bf16 blocks with 5 stages 0.750-0.765 ms against bs_spmm's 1.58
// on an H100 (2, 3 and 4 stages: 0.964, 0.812, 0.766), the copies still
// setting the pace (without the arithmetic 0.518); folded, 0.748 ms on f32
// blocks (4 stages) and 0.751 on bf16 (5) against bs_spmm's 1.398-1.400 and
// 1.389-1.400. The producer's per-stage latency is on that path: a stage's
// sources in 64-bit arithmetic and its granules by division cost the folded
// rows 0.19 ms (0.939 against 0.748; PERF.md section 6).
constexpr int kBtMaxStages = 6;

__host__ __device__ inline long long round128(long long b) { return (b + 127) / 128 * 128; }

// Bytes of one bs_tma ring slot: the bs^2 coefficient planes of T sites of
// csize-byte elements (rounded up to 128 bytes, a box's alignment) and, with
// any far diagonal, m f32 rows of X.
__host__ __device__ inline long long bt_slot_bytes(int bs, int m, int T, bool far, int csize) {
  return round128(1LL * csize * bs * bs * T) + (far ? 4LL * m * T : 0);
}

// Shared bytes of a bs_tma launch: two windows of m rows by T + 2h sites
// (each rounded up to 128 bytes), `stages` slots and 128 bytes to align the
// boxes; mirrored by ops/block_stencil.py tma_smem_bytes.
__host__ __device__ inline long long bt_smem_bytes(int bs, int m, int T, int h, int stages,
                                                   bool far, int csize) {
  return 2 * round128(4LL * m * (T + 2 * h)) + stages * bt_slot_bytes(bs, m, T, far, csize) +
         128;
}

struct BtMaps {
  // the field's window, far slab and far granule boxes; the blocks' planes
  CUtensorMap win, far, farg, coef;
};

// The source site of site a on far diagonal d: (a + w) mod ns on a folded
// diagonal's wrap phase, (a + o) mod ns elsewhere (a < ns + T; 32-bit: ns <
// 2^31 - 2 T, tma_launch_ok).
template <bool FOLD>
__device__ __forceinline__ int bt_source(const Launch& p, int d, int a) {
  const int ns = static_cast<int>(p.ns);
  int j = a + p.offs.o[d];
  if constexpr (FOLD) {
    const int st = p.offs.fst[d];
    if (st > 0 && (a / st) % p.offs.fL[d] == p.offs.fph[d]) j = a + p.offs.fw[d];
  }
  if (j >= ns) j -= ns;
  if (j >= ns) j -= ns;
  return j;
}

// Whether a far granule of 1 << gl sites from source site j goes by TMA: its
// box starts on a 16-byte boundary of the row, has a width of whole 16
// bytes, lands 128-byte aligned in the slot (m << gl floats a granule) and
// stays within ns.
__device__ __forceinline__ bool bt_boxed(const Launch& p, int j, int gl) {
  return (j & 3) == 0 && gl >= 2 && ((p.bs * p.k) << gl) % 32 == 0 && j + (1 << gl) <= p.ns;
}

// The producer warp's share of stage j of the tile at i0: j = 0 the window
// into win, j = 1 + d diagonal d's coefficient planes (and far slab) into
// the slot. A far slab is laid granule by granule (d's 1 << fgl sites, one
// run of a folded diagonal's sites that share their source: T unfolded or
// where the runs are whole tiles), granule q's staged rows b * k + i at (q m
// + b k + i) << fgl. Boxes that lie in [0, ns) by TMA (lane 0, after it
// posts their bytes on bar), the others by the lanes' cp.async, landed
// before lane 0 arrives. FOLD: the launch has folded diagonals (else every
// far slab is one granule and no source depends on the site).
template <int PROBE, typename CE, bool FOLD>
__device__ __forceinline__ void produce_tma(const Launch& p, const BtMaps& maps, float* win,
                                            char* slot, int cbytes, int j, int i0,
                                            unsigned long long* bar, int lane) {
  const int m = p.bs * p.k, T = p.T, W = T + 2 * p.h, ns = static_cast<int>(p.ns);
  unsigned tx = 0;
  bool win_box = false, coef_box = false, far = false, copied = false;
  int c0 = 0, src0 = 0;
  bool box0 = false;
  const int d = j - 1;
  const int gl = j > 0 ? p.offs.fgl[d] : 0, ng = FOLD ? T >> gl : 1;  // far slab granules
  float* xs = reinterpret_cast<float*>(slot + cbytes);
  if (j == 0) {
    if (!(PROBE & kProbeNoWindow)) {
      c0 = i0 - p.h;  // the window's first site, in [0, ns)
      if (c0 < 0) c0 += ns;
      win_box = c0 + W <= ns;
      if (win_box) {
        tx += 4u * m * W;
      } else {
        for (int r = 0; r < m; ++r) copy_row(win + r * W, x_row(p, r), c0, W, p.ns, p.vec, lane);
        copied = true;
      }
    }
  } else {
    coef_box = !(PROBE & kProbeNoCoef);
    if (coef_box) tx += static_cast<unsigned>(sizeof(CE)) * p.bs * p.bs * T;
    far = p.offs.s[d] == kFar && !(PROBE & kProbeNoFar);
    if (far && ng == 1) {  // one box of the tile's T sites
      src0 = bt_source<FOLD>(p, d, i0);
      box0 = bt_boxed(p, src0, gl);
      if (box0) {
        tx += 4u * m * T;
      } else {
        const bool vec = p.vec && (src0 & 3) == 0;
        for (int r = 0; r < m; ++r) copy_row(xs + r * T, x_row(p, r), src0, T, p.ns, vec, lane);
        copied = true;
      }
    }
    for (int q = 0; FOLD && far && ng > 1 && q < ng; ++q) {
      const int src = bt_source<FOLD>(p, d, i0 + (q << gl));
      if (bt_boxed(p, src, gl)) {
        tx += (4u * m) << gl;
      } else {
        const bool vec = p.vec && (src & 3) == 0 && gl >= 2;
        for (int r = 0; r < m; ++r)
          copy_row(xs + ((q * m + r) << gl), x_row(p, r), src, 1 << gl, p.ns, vec, lane);
        copied = true;
      }
    }
  }
  if (copied) {
    cp_async_commit();  // wait_group waits only on committed groups
    cp_async_wait<0>();
    fence_proxy_async();  // before later TMA copies into the same bytes
  }
  __syncwarp();
  if (lane == 0) {
    mbar_expect_tx(bar, tx);
    if (win_box) tma_box3(win, &maps.win, c0, 0, 0, bar);
    if (coef_box) tma_box3(slot, &maps.coef, i0, 0, d, bar);
    if (box0) tma_box3(xs, &maps.far, src0, 0, 0, bar);
    for (int q = 0; FOLD && far && ng > 1 && q < ng; ++q) {
      const int src = bt_source<FOLD>(p, d, i0 + (q << gl));
      if (bt_boxed(p, src, gl)) tma_box3(xs + ((q * m) << gl), &maps.farg, src, 0, 0, bar);
    }
  }
}

// BS >= bs spins, KI right-hand sides a consumer thread, as bs_spmm's
// apply and its folds; CE: the blocks' element; FOLD: a folded launch (an
// unfolded one compiles without the fold checks and the granule loop: on
// its path they cost 2-7% at 32^4, m = 48 on an H100, where the producer's
// per-stage latency sets the pace). Warps 0-7 consume, warp 8 produces.
// Barriers: full[s], the slot's stage has landed (lane 0's expect_tx
// arrival and the TMA bytes); empty[s] and wfree[b] as bs_spmm's.
template <int BS, int KI, typename CE, bool FOLD, int PROBE = 0>
__global__ void __launch_bounds__(kBsThreads + 32, 1)
    bs_tma(const __grid_constant__ BtMaps maps, const Launch p) {
  extern __shared__ __align__(16) float smem[];  // 2 windows | ring
  __shared__ unsigned long long full[kBtMaxStages], empty[kBtMaxStages], wfree[2];
  const int m = p.bs * p.k, T = p.T, W = T + 2 * p.h;
  const int wbytes = static_cast<int>(round128(4LL * m * W));
  const int cbytes = static_cast<int>(round128(1LL * sizeof(CE) * p.bs * p.bs * T));
  const int slot_bytes = static_cast<int>(bt_slot_bytes(p.bs, m, T, p.far, sizeof(CE)));
  char* base = reinterpret_cast<char*>(smem) + ((128 - (smem_u32(smem) & 127)) & 127);
  char* ring = base + 2 * wbytes;
  const int per_tile = p.nd + 1;
  const long long ntiles = (p.ns + T - 1) / T;
  const int cwarps = kBsThreads / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], cwarps);
    }
    mbar_init(&wfree[0], cwarps);
    mbar_init(&wfree[1], cwarps);
    mbar_fence_init();
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= kBsThreads) {  // the producer warp
    unsigned q = 0;
    for (long long t = blockIdx.x, lt = 0; t < ntiles; t += gridDim.x, ++lt) {
      for (int j = 0; j < per_tile; ++j, ++q) {
        const int sl = static_cast<int>(q % p.stages);
        if (lane == 0) {
          if (q >= static_cast<unsigned>(p.stages))
            mbar_wait(&empty[sl], (q / p.stages - 1) & 1);  // the slot's last stage is consumed
          if (j == 0 && lt >= 2) mbar_wait(&wfree[lt & 1], (lt / 2 - 1) & 1);  // tile lt - 2 too
        }
        __syncwarp();
        produce_tma<PROBE, CE, FOLD>(p, maps, reinterpret_cast<float*>(base + (lt & 1) * wbytes),
                               ring + sl * slot_bytes, cbytes, j, static_cast<int>(t * T),
                               &full[sl], lane);
      }
    }
  } else {  // consumers
    const int c = threadIdx.x % T, i0g = (threadIdx.x / T) * KI;  // site column, first RHS
    float acc[BS][KI];
    unsigned q = 0;
    for (long long t = blockIdx.x, lt = 0; t < ntiles; t += gridDim.x, ++lt) {
      const float* wt = reinterpret_cast<const float*>(base + (lt & 1) * wbytes);
      const long long s = t * T + c;
      for (int j = 0; j < per_tile; ++j, ++q) {
        const int sl = static_cast<int>(q % p.stages);
        mbar_wait(&full[sl], (q / p.stages) & 1);  // the stage has landed
        if (j > 0 && !(PROBE & kProbeNoMath)) {
          const int d = j - 1;
          if (d == 0) zero(acc);
          const char* sp = ring + sl * slot_bytes;
          int sh = p.offs.s[d];
          if (FOLD && p.fold_near && sh != kFar) {
            const int st = p.offs.fst[d];  // 32-bit: s < ns + T < 2^31
            if (st > 0 && (static_cast<int>(s) / st) % p.offs.fL[d] == p.offs.fph[d])
              sh = p.offs.fs[d];  // a near folded diagonal's wrap site
          }
          const float* xs = wt + p.h + sh + c;
          int lx = W;
          if (sh == kFar) {
            xs = reinterpret_cast<const float*>(sp + cbytes) + c;
            lx = T;
            if (FOLD && p.fold_granules) {  // granule c >> gl, its rows 1 << gl apart
              const int gl = p.offs.fgl[d];
              xs += ((((c >> gl) * m) << gl) + (c & ((1 << gl) - 1))) - c;
              lx = 1 << gl;
            }
          }
          apply_diag(acc, p, xs, lx, reinterpret_cast<const CE*>(sp) + c, T, i0g);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[sl]);  // this warp is done with the slot
      }
      if (!(PROBE & kProbeNoMath) && s < p.ns) {
        const RowStrides rs = p.row.times(p.ns);
#pragma unroll
        for (int a = 0; a < BS; ++a)
#pragma unroll
          for (int ii = 0; ii < KI; ++ii) {
            const int i = i0g + ii;
            if (a < p.bs && i < p.k) p.Y[s + a * rs.a + i * rs.i] = acc[a][ii];
          }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&wfree[lt & 1]);  // this warp is done with the window
    }
  }
}

template <int BS, int KI, typename CE, bool FOLD, int PROBE = 0>
cudaError_t launch_tma(const Launch& p, int max_blocks, int device, cudaStream_t stream) {
  const int m = p.bs * p.k;
  const size_t smem = bt_smem_bytes(p.bs, m, p.T, p.h, p.stages, p.far, sizeof(CE));
  // The far granule (tma_launch_ok): the least one (T without a folded far
  // diagonal whose runs are not whole tiles).
  int gf = p.T;
  for (int d = 0; d < p.nd; ++d) gf = min(gf, 1 << p.offs.fgl[d]);
  BtMaps maps{};
  // The field as (ns, k, bs) with the row map's strides (the RHS stride si
  // rows, the spin stride sa: 1 and ks on the merged view, bs and 1 on the
  // (k, bs, ns) view); the blocks as (ns, bs^2, nd).
  const cuuint64_t fdims[3] = {static_cast<cuuint64_t>(p.ns), static_cast<cuuint64_t>(p.k),
                               static_cast<cuuint64_t>(p.bs)};
  const cuuint64_t fstrides[2] = {4ULL * p.ns * p.row.si, 4ULL * p.ns * p.row.sa};
  const cuuint32_t wbox[3] = {static_cast<cuuint32_t>(p.T + 2 * p.h),
                              static_cast<cuuint32_t>(p.k), static_cast<cuuint32_t>(p.bs)};
  const cuuint32_t fbox[3] = {static_cast<cuuint32_t>(p.T), static_cast<cuuint32_t>(p.k),
                              static_cast<cuuint32_t>(p.bs)};
  const cuuint32_t gbox[3] = {static_cast<cuuint32_t>(max(gf, 4)), static_cast<cuuint32_t>(p.k),
                              static_cast<cuuint32_t>(p.bs)};
  const cuuint64_t cdims[3] = {static_cast<cuuint64_t>(p.ns),
                               static_cast<cuuint64_t>(p.bs * p.bs),
                               static_cast<cuuint64_t>(p.nd)};
  const cuuint64_t cstrides[2] = {sizeof(CE) * p.ns, sizeof(CE) * p.ns * p.bs * p.bs};
  const cuuint32_t cbox[3] = {static_cast<cuuint32_t>(p.T),
                              static_cast<cuuint32_t>(p.bs * p.bs), 1};
  cudaError_t err = encode_tmap(&maps.win, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, p.X, fdims,
                                fstrides, wbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = encode_tmap(&maps.far, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, p.X, fdims, fstrides, fbox,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = encode_tmap(&maps.farg, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, p.X, fdims, fstrides, gbox,
                      CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err == cudaSuccess)
    err = encode_tmap(&maps.coef,
                      sizeof(CE) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                      3, p.blocks, cdims, cstrides, cbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  auto kernel = bs_tma<BS, KI, CE, FOLD, PROBE>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = persistent_grid(kernel, kBsThreads + 32, smem, device, (p.ns + p.T - 1) / p.T,
                        max_blocks, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kBsThreads + 32, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

// Whether a launch can run bs_tma: 16-byte aligned field and blocks,
// ns % 8 == 0 (16-byte rows of both), sites that fit a box coordinate, a
// window box of at most 256 sites within ns, boxes of at most 256 rows and
// spins, and a ring it holds. Sets each far slab's granule (its log2, fgl):
// T, or on a far folded diagonal whose runs of st sites are not whole
// tiles, the least over those of the largest power of two dividing st (one
// box shape, the `farg` map's, serves them all; it divides each one's
// runs). T is a power of two (256 / groups).
inline bool tma_launch_ok(Launch* p, const void* blocks, int stages) {
  if (!(aligned16(p->X) && aligned16(blocks) && p->ns % 8 == 0 && p->ns < (1LL << 30) &&
        p->T + 2 * p->h <= 256 && p->T + 2 * p->h <= p->ns && p->k <= 256 &&
        stages <= kBtMaxStages))
    return false;
  int gf = p->T;
  for (int d = 0; d < p->nd; ++d) {
    const int st = p->offs.fst[d];
    if (st > 0 && p->offs.s[d] == kFar) gf = min(gf, st & -st);
    if (st > 0 && p->offs.s[d] != kFar) p->fold_near = true;
  }
  for (int d = 0; d < p->nd; ++d) {
    const int st = p->offs.fst[d];
    const int g = st > 0 && p->offs.s[d] == kFar && (st & -st) < p->T ? gf : p->T;
    p->offs.fgl[d] = __builtin_ctz(static_cast<unsigned>(g));
  }
  p->fold_granules = gf < p->T;
  return true;
}

}  // namespace

// offsets: host array of nd entries, each already reduced to [0, ns).
// blocks: device (nd, bs, bs, ns) of float (csize 4) or bf16 (csize 2; ns
// even). fold: null, or nd host quadruples (see make_launch) for folded
// diagonals. X, Y: device (bs * k, ns) float fields, merged
// (row a * ks + i) when merged != 0, else the (k, bs, ns) view (row i * bs +
// a). ks: the merged view's right-hand sides per spin, k on a whole field; a
// launch on a chunk of right-hand sides covers RHS j0..j0+k of a field of
// ks, with X and Y offset by j0 rows (the view's chunks are contiguous and
// take ks = k). h, groups, ki and stages come from ops/block_stencil.py
// block_stencil_plan (T = 256 / groups sites a tile; ki RHS a thread, one of
// the built widths: 1, 2, 3, 4, 6, 8, 12 for bs <= 4, 1, 2, 3 above).
// G == nullptr selects the plain apply; otherwise (merged only, ks == k, at
// most two groups) part holds (max_blocks, m, m) and G receives X Y^T.
extern "C" int bcg_block_stencil_spmm(const void* blocks, int csize, const int* offsets,
                                      const int* fold, int nd, int bs, const float* X, float* Y,
                                      float* part, float* G, int k, int ks, long long ns,
                                      int merged, int h, int groups, int ki, int stages,
                                      int max_blocks, int device, cudaStream_t stream) {
  Launch p;
  cudaError_t err = make_launch(&p, blocks, offsets, nd, bs, X, Y, part, G != nullptr, k, ks,
                                ns, merged, h, groups, ki, stages, max_blocks, csize, fold);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
#define BCG_BS(BS, KI)                                                          \
  return csize == 2 ? by_gram<BS, KI, bf16>(p, G, max_blocks, device, stream) \
                    : by_gram<BS, KI, float>(p, G, max_blocks, device, stream)
  if (bs <= 4) {
    switch (ki) {
      case 1: BCG_BS(4, 1);
      case 2: BCG_BS(4, 2);
      case 3: BCG_BS(4, 3);
      case 4: BCG_BS(4, 4);
      case 6: BCG_BS(4, 6);
      case 8: BCG_BS(4, 8);
      case 12: BCG_BS(4, 12);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (ki) {
    case 1: BCG_BS(8, 1);
    case 2: BCG_BS(8, 2);
    case 3: BCG_BS(8, 3);
    default: return cudaErrorInvalidValue;
  }
#undef BCG_BS
}

// bs_tma without the Gram (rows 23h and 24h, the merged view, and row 22h,
// the (k, bs, ns) view: bf16 blocks, no folds; rows 24f and 24fg's apply:
// merged and folded, f32 or bf16 blocks): bcg_block_stencil_spmm's
// arguments for such a launch (merged, ks and the chunks as there), h,
// groups, ki and stages from ops/block_stencil.py block_stencil_plan with
// tma=True (T + 2h <= 256, up to kBtMaxStages stages); X and the blocks
// 16-byte aligned, ns % 8 == 0.
extern "C" int bcg_block_stencil_tma(const void* blocks, int csize, const int* offsets,
                                     const int* fold, int nd, int bs, const float* X, float* Y,
                                     int k, int ks, long long ns, int merged, int h, int groups,
                                     int ki, int stages, int max_blocks, int device,
                                     cudaStream_t stream) {
  Launch p;
  // make_launch checks the rest with bs_spmm's ring depth; the stages are checked here
  cudaError_t err = make_launch(&p, blocks, offsets, nd, bs, X, Y, nullptr, false, k, ks, ns,
                                merged, h, groups, ki, 2, max_blocks, csize, fold);
  if (err != cudaSuccess) return err;
  p.stages = stages;
  // unfolded launches take bf16 blocks alone, folded ones the merged view alone
  if (stages < 2 || (fold == nullptr && csize != 2) || (fold != nullptr && merged == 0) ||
      !tma_launch_ok(&p, blocks, stages))
    return cudaErrorInvalidValue;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
#define BCG_BT(BS, KI)                                                                  \
  return fold == nullptr ? launch_tma<BS, KI, bf16, false>(p, max_blocks, device, stream) \
         : csize == 2    ? launch_tma<BS, KI, bf16, true>(p, max_blocks, device, stream)  \
                         : launch_tma<BS, KI, float, true>(p, max_blocks, device, stream)
  if (bs <= 4) {
    switch (ki) {
      case 1: BCG_BT(4, 1);
      case 2: BCG_BT(4, 2);
      case 3: BCG_BT(4, 3);
      case 4: BCG_BT(4, 4);
      case 6: BCG_BT(4, 6);
      case 8: BCG_BT(4, 8);
      case 12: BCG_BT(4, 12);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (ki) {
    case 1: BCG_BT(8, 1);
    case 2: BCG_BT(8, 2);
    case 3: BCG_BT(8, 3);
    default: return cudaErrorInvalidValue;
  }
#undef BCG_BT
}
