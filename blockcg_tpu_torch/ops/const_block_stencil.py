"""Const-hop block stencil and the slab accumulate of its periodic wrap
diagonals, on merged spin-major fields and on the (k, bs, ns) view.

Counterpart of ``blockcg_tpu/ops/const_block_stencil.py``:

- ``const_block_stencil_spmm_m_t``: ``Ym[a*k+i, s] = sum_d w_d(s) sum_b
  H_d[a][b] Xm[b*k+i, (s + o_d) mod ns]`` on an (m = bs*k, ns) field, with
  ``w_d = masks[mask_slot[d]]`` (a value: 0/1 gates or +-1 links), or 1 when
  ``mask_slot[d] == -1``;
- ``const_block_stencil_spmm_m_gram_t``: the same with ``Gm = X Y^T`` (m, m);
- ``slab_m_accumulate``: ``Y[:, dst slabs] += (H ⊗ I_k) X[:, src slabs]`` in
  place on Y, optionally with ``G = Gm + X_dst dY^T``;
- ``slab_m_accumulate_from``: ``Y[:, g-blocks dst_base + j] += v * (H ⊗
  I_k) Src[:, g-blocks src_base + j]`` from a separate (m, bw) source (the
  distributed layer's halo), v the per-site ``vals`` (gauged links) or 1,
  optionally with the Gram ``X_dst dY^T`` of the increment alone;
- ``const_block_stencil_spmm_t``, ``const_block_stencil_spmm_gram_t``,
  ``slab_block_accumulate`` and ``slab_block_accumulate_from``: the same sums
  on the (k, bs, ns) view (or its flat (k, bs*ns) form), ``Y[i, a, s] =
  sum_d w_d(s) sum_b H_d[a][b] X[i, b, (s + o_d) mod ns]``; the view's Gram
  contracts over spins and sites to (k, k), and its slab adds have no Gram
  or ``vals``, as in the reference. The reference's
  ``slab_block_accumulate_from`` body is broken (it passes ``_slab_kernel``
  three extra arguments and nothing calls it); the port follows its
  docstring's contract.

At k = 1 the two views are the same memory; ``ConstBlockDIAOperator`` sends
its single-RHS applies through the view's kernels, as the reference does.
The reference's merged kernel needs m % 8 == 0 (``plan_m``, a TPU sublane
rule) and falls back to XLA otherwise; the CUDA kernel takes any m, so
``ConstBlockDIAOperator.matmat_gram_t`` always returns a kernel's Gram. Hops
are the operator's (nd, bs, bs) buffer (nested tuples are accepted and
converted on each call).

The merged main kernels (rows 16 and 17) run ``csrc/cbs_merged.cu``: a
persistent grid over (tile of sites, group of right-hand sides) items, a
warp a right-hand side and four sites a lane, that double-buffers a window
of X around each tile in shared memory, reads the far diagonals' X from L2,
and applies each group of diagonals that share a hop once, on the masked
sum of their windows (``const_block_stencil_plan`` picks the window's halo,
the tile, the group of right-hand sides and the diagonals' order on the
host; ``hop_groups`` is the reference's ``_group_offsets``; an operator
keeps its plans in a ``MergedPlans``). Row 17's Gram is ``fused.gram`` of X and the stored Y:
on the card that took less time than every fused Gram tried (see the
kernel's notes). The (k, bs, ns) view's apply without the Gram (row 14)
runs the same kernel with the view's row map on the ungrouped plan (a group
a diagonal, in diagonal order), which gives the bits of the view's kernel in
``csrc/const_block_stencil.cu``; that kernel keeps the view's Gram (row 15).
The slab adds of both views (rows 18-21) run ``csrc/slab_stream.cu``: one
launch a slab add at any width, with or without ``vals`` and the Gram (the
merged view's; the view's have neither), a lane one right-hand side and
four slab sites in 16-byte accesses (``slab_plan`` sizes the grid; a slab
whose width or fields are not 16-byte aligned takes the same kernel's
4-byte route), the rows by the view's map, (sa, si) = (k, 1) merged or (1,
bs) on the (k, bs, ns) view, the Gram from each block's tiles in
``VecGram`` partials summed in the same launch behind one grid-wide
barrier.

Width: the merged kernel and the slab adds take any k in one launch (the
merged kernel's blocks take groups of right-hand sides); the view's Gram at
most 64 rows after bs is rounded up to a power of two (``rhs_width(bs)``
right-hand sides), and a wider field runs as one launch per chunk of
right-hand sides (on the (k, bs, ns) view a chunk is contiguous). A view
Gram wider than one launch is ``fused.gram`` of X and the stored Y on the
flat fields.

Dispatch follows ``ops/_native.py`` ``f32_kernel``: CPU tensors and CUDA
float64 and bfloat16 tensors run the plain versions below (the reference's
``_matmat_m_xla`` roll-and-einsum, and an in-place slab add), CUDA float32
tensors launch the kernels: the reference's kernels take float32 alone
(``ConstBlockDIAOperator._env_ok``). Kernel bounds: at most 32 diagonals
and bs <= 8; the wrappers raise outside them.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.solvers.common import acc_dtype, gram_t

MAX_DIAGS = 32  # csrc/const_block_stencil.cu kMaxDiags
MAX_BS = 8  # csrc/const_block_stencil.cu kMaxBs


def _hops(hops, Xm: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(hops, dtype=Xm.dtype, device=Xm.device)


def _check_main(hops, offsets, mask_slot, masks, Xm, name: str):
    if hops.dim() != 3 or hops.shape[1] != hops.shape[2]:
        raise ValueError(f"{name}: hops must be (nd, bs, bs), got {tuple(hops.shape)}")
    nd, bs, _ = hops.shape
    if Xm.dim() != 2 or Xm.shape[0] % bs:
        raise ValueError(f"{name}: expected an (m = {bs} * k, ns) field, got "
                         f"{tuple(Xm.shape)}")
    if len(offsets) != nd or len(mask_slot) != nd:
        raise ValueError(f"{name}: {nd} hops, {len(offsets)} offsets, "
                         f"{len(mask_slot)} mask slots")
    nmask = 0 if masks is None else masks.shape[0]
    if masks is not None and masks.shape != (nmask, Xm.shape[1]):
        raise ValueError(f"{name}: masks {tuple(masks.shape)} for {Xm.shape[1]} sites")
    if any(not -1 <= sl < nmask for sl in mask_slot):
        raise ValueError(f"{name}: mask slots {mask_slot} for {nmask} mask rows")


def rhs_width(bs: int, name: str = "const-hop kernel") -> int:
    """Right-hand sides one launch of the view's Gram kernel takes: 64 rows
    over bs rounded up to a power of two."""
    if not 1 <= bs <= MAX_BS:
        raise ValueError(f"{name}: the CUDA kernel takes bs <= {MAX_BS}, got {bs}")
    return _native.MAX_K // (1 << (bs - 1).bit_length())


# ------------------------------ the slab adds' host plan (rows 18-21)

SLAB_THREADS = 256  # csrc/slab_stream.cu kSlabThreads
SLAB_GRAM_ROWS = 128  # kSlabGramRows: the widest Gram tile; a wider Gram in passes
SLAB_KMAX = (32, 48, 64, 96, SLAB_GRAM_ROWS)  # slab_kmax: the Gram tile's rows
SLAB_TILES = (256, 128, 64, 32)  # slab sites a tile of the Gram route, widest first
# Static shared bytes of a Gram launch: the hop table and the reduction's doubles.
SLAB_STATIC_BYTES = 4 * MAX_BS * MAX_BS + 8 * SLAB_THREADS


class SlabPlan(NamedTuple):
    """A ``csrc/slab_stream.cu`` launch: the 16-byte route (``vec``: four
    slab sites an item) or the 4-byte one; with the Gram, its tile's rows
    ``kmax`` (``passes`` of (kmax, kmax) blocks above ``SLAB_GRAM_ROWS``)
    and the slab sites of a tile ``tc`` (0 and 0 without it); the blocks an
    SM it is built for, its grid and its dynamic shared bytes."""
    vec: bool
    kmax: int
    passes: int
    tc: int
    blocks_per_sm: int
    grid: int
    smem_bytes: int

    def describe(self) -> str:
        return (f"{'16-byte' if self.vec else '4-byte'} kmax={self.kmax} passes={self.passes} "
                f"tc={self.tc} blocks/SM={self.blocks_per_sm} grid={self.grid} "
                f"smem={self.smem_bytes}")


def slab_blocks(bs: int, kmax: int) -> int:
    """Blocks an SM a ``csrc/slab_stream.cu`` build takes: without the Gram
    (kmax 0) 4 up to bs = 4, else 2 (kSlabBlocksPerSm, its register cap);
    with it one, with every register its Gram tile needs."""
    return (4 if bs <= 4 else 2) if kmax == 0 else 1


def slab_kmax(m: int) -> int:
    """The Gram tile's rows for m rows (``csrc/slab_stream.cu`` slab_kmax):
    the least of ``SLAB_KMAX`` that holds them, ``SLAB_GRAM_ROWS`` above."""
    return next((w for w in SLAB_KMAX if m <= w), SLAB_GRAM_ROWS)


def slab_ts(kmax: int) -> int:
    """The side of a thread's VecGram tile for a Gram tile of kmax rows
    (``csrc/slab_stream.cu`` kSlabTS): 8 at 128 rows, 6 at 48 and 96, else
    4, the least that 256 threads hold."""
    return 8 if kmax == 128 else 6 if kmax in (48, 96) else 4


def vecgram_scratch(kmax: int, threads: int = SLAB_THREADS) -> int:
    """Floats of ``SlabGram<kmax>::kScratch`` (``VecGram`` in
    ``csrc/common.cuh`` on ``slab_ts``): its copies of the (kmax, kmax)
    tile, one a ``(kmax / TS)^2`` threads."""
    return threads // (kmax // slab_ts(kmax)) ** 2 * kmax * kmax


def slab_smem_bytes(kmax: int, tc: int) -> int:
    """Dynamic shared bytes of a Gram launch (``slab_smem_floats``): the
    staged X_dst and dY tiles, (kmax, tc + 4) floats each, or VecGram's
    scratch where larger."""
    return 4 * max(2 * kmax * (tc + 4), vecgram_scratch(kmax))


@functools.lru_cache(maxsize=256)
def slab_plan(m: int, bs: int, g: int, nblocks: int, gram: bool, vec: bool, sm_count: int,
              smem_cap: int) -> SlabPlan:
    """The launch of a slab add of m = bs * k rows (either view) over ``nblocks``
    slabs of g sites, with or without the Gram, on the 16-byte route
    (``vec``, which needs g % 4 == 0) or the 4-byte one, on a card of
    ``sm_count`` SMs and ``smem_cap`` shared bytes a block. Without the
    Gram the grid is the items' blocks of ``SLAB_THREADS`` (an item one
    right-hand side and four sites, or one), at most the blocks an SM the
    build takes (``slab_blocks``) times the SMs. With it one block an SM:
    the tile is the widest of ``SLAB_TILES`` that fits and leaves at least a
    tile an SM (else the narrowest that fits), and the grid is the tiles, at
    most one block an SM: every block is resident, as the grid-wide barrier
    needs. The plan depends on the shapes and the card alone, so a repeat
    sums the Gram's partials in the same order."""
    if not 1 <= bs <= MAX_BS:
        raise ValueError(f"slab add: the CUDA kernel takes bs <= {MAX_BS}, got {bs}")
    if m < bs or m % bs or g < 1 or nblocks < 1:
        raise ValueError(f"slab add: {m} rows of bs = {bs}, {nblocks} slabs of {g} "
                         "sites")
    if vec and g % 4:
        raise ValueError(f"slab add: the 16-byte route needs g % 4 == 0, got g = {g}")
    total = nblocks * g
    if not gram:
        per_sm = slab_blocks(bs, 0)
        items = m // bs * (total // 4 if vec else total)
        grid = min(-(-items // SLAB_THREADS), per_sm * sm_count)
        return SlabPlan(vec, 0, 0, 0, per_sm, grid, 0)
    kmax = slab_kmax(m)
    per_sm = slab_blocks(bs, kmax)
    fits = [tc for tc in SLAB_TILES
            if slab_smem_bytes(kmax, tc) + SLAB_STATIC_BYTES <= smem_cap]
    tc = next((tc for tc in fits if -(-total // tc) >= sm_count), fits[-1])
    grid = min(-(-total // tc), per_sm * sm_count)
    return SlabPlan(vec, kmax, (-(-m // kmax)) ** 2, tc, per_sm, grid,
                    slab_smem_bytes(kmax, tc))


# -------------------------------------------- the merged kernel's host plan

CM_MAX_ROWS = 96  # csrc/cbs_merged.cu kCmMaxRows: bs * kb rows a block
CM_MAX_WARPS = 12  # csrc/cbs_merged.cu kCmMaxThreads / 32: kb * sw warps a block
CM_SW = (4, 2, 1)  # warps a right-hand side (tiles of 128 * sw sites), widest first
# The plan's group: 4 right-hand sides on 8 warps (256-site tiles at k >= 4).
# At (48, 32^4) on config 4 that took 0.459 ms against 0.531 for groups of 6
# and 0.604 for all 12 on 12 warps (H100, tools/torch_kernel_times.py
# --const-hop --variants, one call): two blocks an SM hold 16 warps.
CM_KB, CM_WARPS = 4, 8
# Warps an SM the plan's second key counts up to (the blocks an SM the
# shared memory holds times kb * sw): at one right-hand side (kb = 1, the
# (k, bs, ns) view's apply on the even-odd hop) a 16-site halo that lets
# three 4-warp blocks onto an SM took 42.9 device us where the 512-site one
# that leaves only the +-16,384 diagonals to L2, at two blocks, took 49.9
# (H100, tools/torch_kernel_times.py --short --variants; PERF.md).
CM_SM_WARPS = 12


def _spin_width(bs: int) -> int:
    """BS, the compile-time spin width of the merged kernel for bs."""
    if not 1 <= bs <= MAX_BS:
        raise ValueError(f"const-hop kernel: the CUDA kernel takes bs <= {MAX_BS}, got {bs}")
    return 4 if bs <= 4 else 8


def cm_smem_bytes(bs: int, kb: int, T: int, h: int, nmask: int, nhop: int) -> int:
    """Dynamic shared bytes of a merged launch (``csrc/cbs_merged.cu``
    cm_smem_floats): two buffers of the window, a group's bs * kb rows of T
    + 2h + 4 sites, and the nmask mask rows of T; the hop table padded to
    (nhop, BS, BS)."""
    w = _spin_width(bs)
    return 4 * (2 * (bs * kb * (T + 2 * h + 4) + nmask * T) + nhop * w * w)


def hop_groups(hops) -> tuple[tuple[int, ...], ...]:
    """Diagonal indices grouped by identical hop, each group in diagonal
    order, the groups in order of first appearance: the reference's
    ``_group_offsets`` (``blockcg_tpu/ops/const_block_stencil.py:77``)."""
    index: dict = {}
    groups: list[list[int]] = []
    for d, h in enumerate(hops):
        g = index.setdefault(h, len(groups))
        if g == len(groups):
            groups.append([])
        groups[g].append(d)
    return tuple(map(tuple, groups))


class ConstHopPlan(NamedTuple):
    """A merged launch's schedule (``csrc/cbs_merged.cu``): the window's
    halo ``h`` (a multiple of 4), the tile of ``T = 128 * sw`` sites, ``sw``
    warps a right-hand side and ``kb`` right-hand sides a block (kb * sw
    warps, four sites a lane; an item is a tile and a group of kb); the
    diagonals in hop-group ``order`` (each group's far diagonals first),
    whether each reads the window (``near``; the others read X from L2) and
    its hop group ``gid``; the launch's shared bytes; the L2->SM traffic of
    X per site in units of X, ``(T + 2h) / T`` plus one a far diagonal; and
    its grid (the blocks an SM that the shared memory holds, at most one an
    item)."""
    h: int
    T: int
    sw: int
    kb: int
    order: tuple[int, ...]
    near: tuple[bool, ...]
    gid: tuple[int, ...]
    smem_bytes: int
    traffic: float
    blocks: int

    def describe(self) -> str:
        return (f"h={self.h} T={self.T} sw={self.sw} kb={self.kb} "
                f"groups={len(set(self.gid))}/{len(self.gid)} "
                f"near={sum(self.near)}/{len(self.near)} smem={self.smem_bytes} "
                f"traffic={self.traffic:g} blocks={self.blocks}")


@functools.lru_cache(maxsize=256)
def const_block_stencil_plan(offsets: tuple[int, ...], hops: tuple, nmask: int, bs: int,
                             k: int, ns: int, smem_cap: int, sm_count: int, *,
                             h: int | None = None, sw: int | None = None,
                             kb: int | None = None,
                             grouped: bool | None = None) -> ConstHopPlan:
    """The schedule of a merged launch of k right-hand sides on ns sites,
    for the diagonals' ``offsets`` and ``hops`` (nested tuples: equal hops
    form a group, by ``hop_groups``) and ``nmask`` mask rows. A block takes
    ``kb = min(k, 4)`` right-hand sides; among the tiles (``sw`` of 4, 2, 1
    with kb * sw <= 8 warps) and halos (0, and each offset's distance
    rounded up to 4) whose shared memory fits ``smem_cap``, it keeps two
    blocks an SM where it can, then the most warps an SM up to
    ``CM_SM_WARPS`` (blocks of fewer warps, kb = 1), then the least L2->SM
    traffic of X (wider tiles first), then the smaller halo. A diagonal is near when its offset mod ns lies
    within h of 0 or of ns, the rule the kernel applies. ``h``, ``sw``,
    ``kb`` (kb * sw <= 12, bs * kb <= 96) and ``grouped`` (False: a group a
    diagonal, the default at k = 1, where the merged kernel then gives the
    (k, bs, ns) route's bits) pin those choices (the timing tool's
    variants)."""
    nd = len(offsets)
    if not 1 <= nd <= MAX_DIAGS or len(hops) != nd:
        raise ValueError(f"const-hop kernel: {nd} diagonals and {len(hops)} hops (at most "
                         f"{MAX_DIAGS})")
    _spin_width(bs)
    kb = min(k, CM_KB) if kb is None else kb
    if not 1 <= kb or bs * kb > CM_MAX_ROWS:
        raise ValueError(f"const-hop kernel: a block takes bs * kb <= {CM_MAX_ROWS} rows, got "
                         f"{bs} x {kb}")
    if sw is not None and (sw not in CM_SW or kb * sw > CM_MAX_WARPS):
        raise ValueError(f"const-hop kernel: kb * sw = {kb} x {sw} passes {CM_MAX_WARPS} warps "
                         f"(or sw is not one of {CM_SW})")
    sws = [v for v in CM_SW if kb * v <= CM_WARPS] if sw is None else [sw]
    if not sws:
        raise ValueError(f"const-hop kernel: kb = {kb} passes {CM_WARPS} warps a block")
    offs = [int(o) % ns for o in offsets]
    dist = [min(o, ns - o) for o in offs]
    if grouped is None:  # one RHS keeps the (k, bs, ns) route's bits
        grouped = k > 1
    groups = hop_groups(hops) if grouped else tuple((d,) for d in range(nd))
    gid = tuple(j for j, g in enumerate(groups) for _ in g)
    halos = sorted({0} | {-(-d // 4) * 4 for d in dist}) if h is None else [h]
    best, best_key = None, None
    for ww, hh in ((ww, hh) for ww in sws for hh in halos):
        T = 128 * ww
        nbytes = cm_smem_bytes(bs, kb, T, hh, nmask, nd)
        if nbytes > smem_cap:
            continue
        fit = (smem_cap + 1024) // (nbytes + 1024)  # blocks an SM the shared memory holds
        far = [d > hh for d in dist]
        # Each group's far diagonals first, so that their loads go together.
        order = tuple(d for g in groups for d in sorted(g, key=lambda d: not far[d]))
        traffic = (T + 2 * hh) / T + sum(far)
        key = (-min(fit, 2), -min(fit * kb * ww, CM_SM_WARPS), traffic, hh)
        if best_key is None or key < best_key:
            best_key = key
            items = -(-ns // T) * -(-k // kb)
            best = ConstHopPlan(hh, T, ww, kb, order, tuple(not far[d] for d in order), gid,
                                nbytes, traffic, min(items, fit * sm_count, _native.MAX_BLOCKS))
    if best is None:
        raise ValueError(f"const-hop kernel: bs = {bs}, kb = {kb} leave no schedule in "
                         f"{smem_cap} bytes of shared memory")
    return best


def hop_table_key(hops) -> tuple:
    """The (nd, bs, bs) hop table as nested Python tuples, the plan's
    grouping key (equal hops form a group)."""
    return tuple(tuple(tuple(row) for row in h) for h in hops)


def launch_plan(hop_key: tuple, offsets, nmask: int, k: int, ns: int, device,
                view: bool = False) -> ConstHopPlan:
    """The plan of the one ``csrc/cbs_merged.cu`` launch of k right-hand
    sides, for the diagonals' ``hop_table_key``, on ``device``'s card: the
    merged view's, or (``view``) the (k, bs, ns) view's without the Gram (row
    14), ungrouped (a group a diagonal, in diagonal order), so that Y has the
    bits of the view's kernel in ``csrc/const_block_stencil.cu``."""
    offs = tuple(int(o) % ns for o in offsets)
    cap, sms = _native.max_smem(device.index), _native.sm_count(device.index)
    return const_block_stencil_plan(offs, hop_key, nmask, len(hop_key[0]), k, ns, cap, sms,
                                    grouped=False if view else None)


class MergedPlans:
    """The ``launch_plan`` of one operator's ``csrc/cbs_merged.cu`` applies
    (merged, and the (k, bs, ns) view's without the Gram), made from its
    host hop table (``hop_table_key``, taken when the operator is built)
    once per width, view and device."""

    def __init__(self, hop_key: tuple):
        self.hop_key = hop_key
        self._made: dict = {}

    def get(self, offsets, nmask: int, k: int, ns: int, device,
            view: bool = False) -> ConstHopPlan:
        key = (k, ns, device.index, view)
        got = self._made.get(key)
        if got is None:
            got = self._made[key] = launch_plan(self.hop_key, offsets, nmask, k, ns, device,
                                                view)
        return got


# ------------------------------------------------------------ plain versions


def const_block_stencil_plain(hops, offsets, mask_slot, masks, Xm,
                              with_gram: bool = False):
    """Plain PyTorch version: the roll-and-einsum of the reference's
    ``ConstBlockDIAOperator._matmat_m_xla`` (``blockcg_tpu/operators/cbdia.py:233-248``),
    which works in the field dtype: each diagonal's term, the bs x bs hop
    times the rolled X (exact products of a bf16 field summed in f32), is
    stored in the field dtype, masked there and added to Y there, diagonal
    by diagonal in the order given; on a bf16 field each of those steps
    rounds to bf16, as the reference's does. Returns ``(Ym, Gm or None)``
    with ``Gm = X Y^T`` of the stored Y."""
    bs = hops.shape[-1]
    m, ns = Xm.shape
    adt = acc_dtype(Xm.dtype)
    Xv = Xm.reshape(bs, m // bs, ns)
    H = hops.to(adt)
    Yv = torch.zeros_like(Xv)
    for d, o in enumerate(offsets):
        src = Xv if o % ns == 0 else torch.roll(Xv, -o, dims=2)
        t = torch.tensordot(H[d], src.to(adt), dims=1).to(Xm.dtype)
        if mask_slot[d] >= 0:
            t = t * masks[mask_slot[d]].to(Xm.dtype)
        Yv += t
    Y = Yv.reshape(m, ns)
    return Y, (gram_t(Xm, Y) if with_gram else None)


def slab_columns(g: int, nblocks: int, dst_mul: int, dst_off: int,
                 src_shift: int, ns: int, device=None):
    """(dst, src) site indices of the slab sites, as the kernel walks them:
    destination block j -> (dst_mul * j + dst_off) mod nb, its source
    ``src_shift`` blocks away (toroidal)."""
    nb = ns // g
    j = torch.arange(nblocks, device=device)
    dblk = (dst_mul * j + dst_off) % nb
    sblk = (dblk + src_shift) % nb
    c = torch.arange(g, device=device)
    return (dblk[:, None] * g + c).reshape(-1), (sblk[:, None] * g + c).reshape(-1)


def slab_plain(hop, g, nblocks, dst_mul, dst_off, src_shift, Xm, Ym, Gm=None,
               with_gram: bool = False):
    """Plain version of ``slab_m_accumulate``: adds the slab's rows into Ym
    in place; returns ``Ym``, or ``(Ym, Gm + X_dst dY^T)`` with the Gram."""
    m, ns = Xm.shape
    bs = hop.shape[-1]
    adt = acc_dtype(Xm.dtype)
    dst, src = slab_columns(g, nblocks, dst_mul, dst_off, src_shift, ns, Xm.device)
    Xs = Xm[:, src].reshape(bs, m // bs, -1).to(adt)
    dY = torch.tensordot(hop.to(adt), Xs, dims=1).reshape(m, -1)
    Ym.index_add_(1, dst, dY.to(Ym.dtype))
    if not with_gram:
        return Ym
    G = gram_t(Xm[:, dst], dY)
    return Ym, (G if Gm is None else Gm + G)


def slab_from_plain(hop, g, nblocks, dst_base, src_base, Src, Ym, Xm=None, vals=None,
                    with_gram: bool = False):
    """Plain version of ``slab_m_accumulate_from``: adds the increment into
    Ym's slab columns in place; returns ``Ym``, or ``(Ym, X_dst dY^T)`` with
    the Gram."""
    m = Ym.shape[0]
    bs = hop.shape[-1]
    adt = acc_dtype(Ym.dtype)
    cols = nblocks * g
    d0, s0 = dst_base * g, src_base * g
    Xs = Src[:, s0:s0 + cols].reshape(bs, m // bs, cols).to(adt)
    dY = torch.tensordot(hop.to(adt), Xs, dims=1).reshape(m, cols)
    if vals is not None:
        dY = dY * vals.to(adt)
    Ym[:, d0:d0 + cols] += dY.to(Ym.dtype)
    return (Ym, gram_t(Xm[:, d0:d0 + cols], dY)) if with_gram else Ym


def _to_merged(Xv: torch.Tensor) -> torch.Tensor:
    k, bs, ns = Xv.shape
    return Xv.transpose(0, 1).reshape(bs * k, ns)


def _from_merged(Ym: torch.Tensor, k: int) -> torch.Tensor:
    m, ns = Ym.shape
    return Ym.reshape(m // k, k, ns).transpose(0, 1).contiguous()


def const_block_stencil_v_plain(hops, offsets, mask_slot, masks, Xv,
                                with_gram: bool = False):
    """Plain version on the (k, bs, ns) view: the merged version on the
    transposed field. Returns ``(Yv, G or None)``, G the (k, k)
    ``sum_{a,s} X[i, a, s] Y[j, a, s]`` taken on the accumulator."""
    k = Xv.shape[0]
    Ym = const_block_stencil_plain(hops, offsets, mask_slot, masks, _to_merged(Xv))[0]
    Yv = _from_merged(Ym, k)
    return Yv, (gram_t(Xv, Yv) if with_gram else None)


def slab_v_plain(hop, g, nblocks, dst_mul, dst_off, src_shift, Xv, Yv):
    """Plain version of ``slab_block_accumulate``: adds the slab's sites into
    the (k, bs, ns) view Yv in place and returns it."""
    adt = acc_dtype(Xv.dtype)
    dst, src = slab_columns(g, nblocks, dst_mul, dst_off, src_shift, Xv.shape[-1],
                            Xv.device)
    dY = torch.einsum("ab,kbs->kas", hop.to(adt), Xv[:, :, src].to(adt))
    return Yv.index_add_(2, dst, dY.to(Yv.dtype))


def slab_v_from_plain(hop, g, nblocks, dst_base, src_base, Src, Yv):
    """Plain version of ``slab_block_accumulate_from`` on the (k, bs, ns)
    view: adds in place and returns Yv."""
    adt = acc_dtype(Yv.dtype)
    cols = nblocks * g
    d0, s0 = dst_base * g, src_base * g
    dY = torch.einsum("ab,kbs->kas", hop.to(adt), Src[:, :, s0:s0 + cols].to(adt))
    Yv[:, :, d0:d0 + cols] += dY.to(Yv.dtype)
    return Yv


# ------------------------------------------------------------------ wrappers


def _launch_view(hops, offsets, mask_slot, masks, X, k: int, with_gram: bool, name: str,
                 plans=None):
    """Launch on a contiguous (k, bs, ns) view or its flat form: without the
    Gram (row 14) one ``csrc/cbs_merged.cu`` launch with the view's row map,
    on the view's plan from ``plans`` (a ``MergedPlans``; by default made
    from the hop table, which is then read from the card); with it (row 15)
    ``csrc/const_block_stencil.cu``, one launch per chunk of right-hand
    sides. Returns (Y shaped like X, the (k, k) Gram or None)."""
    from blockcg_tpu_torch.ops import fused

    nd, bs, _ = hops.shape
    m = bs * k
    ns = X.numel() // m
    if nd > MAX_DIAGS:
        raise ValueError(f"{name}: {nd} diagonals, the CUDA kernel takes at most {MAX_DIAGS}")
    if not with_gram:
        if plans is None:
            plans = MergedPlans(hop_table_key(hops.tolist()))
        plan = plans.get(offsets, 0 if masks is None else masks.shape[0], k, ns, X.device,
                         view=True)
        return _launch_cm(hops, offsets, mask_slot, masks, X, k, ns, False, plan, name), None
    chunks = _native.row_chunks(k, rhs_width(bs, name))
    offs = (ctypes.c_int * nd)(*(int(o) % ns for o in offsets))
    slots = (ctypes.c_int * nd)(*mask_slot)
    Y = torch.empty_like(X)
    nb = _native.nblocks(ns)
    fused_gram = with_gram and len(chunks) == 1
    part = G = None
    if fused_gram:
        part = torch.empty((nb, m, m), dtype=torch.float32, device=X.device)
        G = torch.empty((k, k), dtype=torch.float32, device=X.device)
    row = ns * 4 * bs  # bytes from one RHS to the next
    p = _native.ptr
    for j0, j1 in chunks:
        _native.launch(name, "bcg_cbs_spmm", X.device, p(hops), offs, slots, nd, bs,
                       p(masks), p(X) + j0 * row, p(Y) + j0 * row, p(part), p(G), j1 - j0,
                       ns, nb)
    if with_gram and not fused_gram:
        G = fused.gram(X.reshape(k, -1), Y.reshape(k, -1))
    return Y, G


def _launch_merged(hops, offsets, mask_slot, masks, X, with_gram: bool, name: str,
                   plan=None):
    """Launch ``csrc/cbs_merged.cu`` once on a contiguous merged (bs * k, ns)
    field on ``plan`` (a ``ConstHopPlan``, or a ``MergedPlans``; by default
    made from the hop table, which is then read from the card); returns (Y,
    the (m, m) Gram ``gram(X, Y)`` or None)."""
    from blockcg_tpu_torch.ops import fused

    nd, bs, _ = hops.shape
    m, ns = X.shape
    k = m // bs
    if nd > MAX_DIAGS:
        raise ValueError(f"{name}: {nd} diagonals, the CUDA kernel takes at most {MAX_DIAGS}")
    nmask = 0 if masks is None else masks.shape[0]
    if plan is None:
        plan = MergedPlans(hop_table_key(hops.tolist()))
    if isinstance(plan, MergedPlans):
        plan = plan.get(offsets, nmask, k, ns, X.device)
    Y = _launch_cm(hops, offsets, mask_slot, masks, X, k, ns, True, plan, name)
    return Y, (fused.gram(X, Y) if with_gram else None)


def _launch_cm(hops, offsets, mask_slot, masks, X, k: int, ns: int, merged: bool,
               plan: ConstHopPlan, name: str) -> torch.Tensor:
    """One ``csrc/cbs_merged.cu`` launch on ``plan`` of a contiguous field
    of k right-hand sides, the merged view or (``merged`` False) the (k, bs,
    ns) view; returns Y shaped like X."""
    nd, bs, _ = hops.shape
    cint = ctypes.c_int * nd
    Y = torch.empty_like(X)
    p = _native.ptr
    _native.launch(name, "bcg_cbs_merged_spmm", X.device, p(hops), nd,
                   cint(*(int(o) % ns for o in offsets)), cint(*mask_slot), cint(*plan.order),
                   cint(*plan.gid), bs, p(masks), 0 if masks is None else masks.shape[0], p(X),
                   p(Y), k, ns, int(merged), plan.h, plan.sw, plan.kb, plan.blocks)
    return Y


def launch_planned(hops: torch.Tensor, offsets, mask_slot, masks, Xm: torch.Tensor,
                   plan: ConstHopPlan, name: str = "variant") -> torch.Tensor:
    """The merged launch on a given plan (a pinned ``const_block_stencil_plan``,
    as the tests and the timing tool's variants make) on a CUDA float32
    field; returns Ym and counts a launch for ``name``."""
    _check_main(hops, offsets, mask_slot, masks, Xm, name)
    if not _native.use_kernel(*((hops, Xm) if masks is None else (hops, masks, Xm))):
        raise ValueError(f"{name}: a planned launch takes CUDA float32 operands")
    return _launch_merged(hops, offsets, mask_slot, masks, Xm, False, name, plan)[0]


def _main(hops, offsets, mask_slot, masks, Xm, with_gram: bool, name: str, plans):
    hops = _hops(hops, Xm)
    _check_main(hops, offsets, mask_slot, masks, Xm, name)
    ops = (hops, Xm) if masks is None else (hops, masks, Xm)
    if not _native.f32_kernel(*ops):
        return const_block_stencil_plain(hops, offsets, mask_slot, masks, Xm, with_gram)
    return _launch_merged(hops, offsets, mask_slot, masks, Xm, with_gram, name, plans)


def _view(hops, offsets, mask_slot, masks, Xt, with_gram: bool, name: str, plans=None):
    """The (k, bs, ns) view or its flat (k, bs*ns) form; Y comes back in
    Xt's shape."""
    hops = _hops(hops, Xt)
    bs = hops.shape[-1]
    if Xt.dim() not in (2, 3) or (Xt.dim() == 3 and Xt.shape[1] != bs) or (
            Xt.dim() == 2 and Xt.shape[1] % bs):
        raise ValueError(f"{name}: expected a (k, {bs}, ns) or (k, {bs} * ns) field, "
                         f"got {tuple(Xt.shape)}")
    k = Xt.shape[0]
    ns = Xt.numel() // (bs * k)
    # The merged view's checks, on the field's (bs * k, ns) shape.
    _check_main(hops, offsets, mask_slot, masks, Xt.reshape(bs * k, ns), name)
    ops = (hops, Xt) if masks is None else (hops, masks, Xt)
    if not _native.f32_kernel(*ops):
        Yv, G = const_block_stencil_v_plain(hops, offsets, mask_slot, masks,
                                            Xt.reshape(k, bs, ns), with_gram)
        return Yv.reshape(Xt.shape), G
    return _launch_view(hops, offsets, mask_slot, masks, Xt, k, with_gram, name, plans)


def const_block_stencil_spmm_m_t(hops, offsets: tuple[int, ...],
                                 mask_slot: tuple[int, ...],
                                 masks: torch.Tensor | None,
                                 Xm: torch.Tensor,
                                 plans: MergedPlans | None = None) -> torch.Tensor:
    """Merged-layout const-hop block SpMM: hops (nd, bs, bs), masks
    (nmask, ns) or None, Xm (m = bs*k, ns) with row a*k + i. Returns Ym.
    ``plans``: the operator's ``MergedPlans`` (else the plan is made from
    the hop table on each kernel call)."""
    return _main(hops, offsets, mask_slot, masks, Xm, False,
                 "const_block_stencil_spmm_m_t", plans)[0]


def const_block_stencil_spmm_m_gram_t(hops, offsets: tuple[int, ...],
                                      mask_slot: tuple[int, ...],
                                      masks: torch.Tensor | None,
                                      Xm: torch.Tensor,
                                      plans: MergedPlans | None = None):
    """``(Ym, Gm = X Y^T)``, Gm (m, m); contract it to k x k with the
    operator's ``gram_contract``. ``plans`` as in
    :func:`const_block_stencil_spmm_m_t`."""
    return _main(hops, offsets, mask_slot, masks, Xm, True,
                 "const_block_stencil_spmm_m_gram_t", plans)


def const_block_stencil_spmm_t(hops, offsets: tuple[int, ...],
                               mask_slot: tuple[int, ...],
                               masks: torch.Tensor | None,
                               Xt: torch.Tensor,
                               plans: MergedPlans | None = None) -> torch.Tensor:
    """Const-hop block SpMM on the (k, bs, ns) view, or its flat (k, bs*ns)
    form; returns Yt shaped like Xt. ``plans`` as in
    :func:`const_block_stencil_spmm_m_t`."""
    return _view(hops, offsets, mask_slot, masks, Xt, False,
                 "const_block_stencil_spmm_t", plans)[0]


def const_block_stencil_spmm_gram_t(hops, offsets: tuple[int, ...],
                                    mask_slot: tuple[int, ...],
                                    masks: torch.Tensor | None,
                                    Xt: torch.Tensor):
    """``(Yt, G)`` on the (k, bs, ns) view, with the (k, k) Gram ``G[i, j] =
    sum_{a, s} X[i, a, s] Y[j, a, s]`` (the solvers' ``P^T A P``)."""
    return _view(hops, offsets, mask_slot, masks, Xt, True,
                 "const_block_stencil_spmm_gram_t")


def _check_slab(hop, g, nblocks, dst_mul, Xm, Ym, Gm, name):
    m, ns = Xm.shape
    bs = hop.shape[-1]
    if hop.shape != (bs, bs) or m % bs:
        raise ValueError(f"{name}: hop {tuple(hop.shape)} for an ({m}, {ns}) field")
    if Ym.shape != Xm.shape:
        raise ValueError(f"{name}: Y {tuple(Ym.shape)} for X {tuple(Xm.shape)}")
    if Gm is not None and Gm.shape != (m, m):
        raise ValueError(f"{name}: Gm {tuple(Gm.shape)}, expected ({m}, {m})")
    if g < 1 or ns % g:
        raise ValueError(f"{name}: slab width {g} does not divide {ns} sites")
    nb = ns // g
    # Distinct destination blocks: each destination column has one writer.
    if not 1 <= nblocks <= nb // math.gcd(dst_mul, nb):
        raise ValueError(f"{name}: {nblocks} slabs of stride {dst_mul} repeat a "
                         f"destination among {nb} blocks")


def slab_m_accumulate(hop, g: int, nblocks: int, dst_mul: int, dst_off: int,
                      src_shift: int, Xm: torch.Tensor, Ym: torch.Tensor,
                      Gm: torch.Tensor | None = None, *, with_gram: bool = False):
    """``Y[:, dst slabs] += (hop ⊗ I_k) X[:, src slabs]`` in place on Ym.

    Destination slab j < nblocks covers sites [(dst_mul*j + dst_off mod nb)*g,
    ... + g), nb = ns / g; its source sits ``src_shift`` slabs away
    (toroidal). Returns Ym, or with ``with_gram`` ``(Ym, G = Gm + X_dst
    dY^T)`` (Gm None counts as zero)."""
    name = "slab_m_accumulate"
    hop = _hops(hop, Xm)
    _check_slab(hop, g, nblocks, dst_mul, Xm, Ym, Gm if with_gram else None, name)
    ops = [hop, Xm, Ym] + ([Gm] if with_gram and Gm is not None else [])
    if not _native.f32_kernel(*ops):
        return slab_plain(hop, g, nblocks, dst_mul, dst_off, src_shift, Xm, Ym,
                          Gm, with_gram)
    if Ym.data_ptr() == Xm.data_ptr():
        raise ValueError(f"{name}: Y must not share X's storage")
    ns = Xm.shape[1]
    nb = ns // g
    G = _launch_stream(name, hop, g, nblocks, (dst_mul % nb, dst_off % nb),
                       (dst_mul % nb, (dst_off + src_shift) % nb), Xm, ns, None, Xm, Ym,
                       Gm if with_gram else None, with_gram)
    return (Ym, G) if with_gram else Ym


def slab_block_accumulate(hop, g: int, nblocks: int, dst_mul: int, dst_off: int,
                          src_shift: int, Xv: torch.Tensor,
                          Yv: torch.Tensor) -> torch.Tensor:
    """``Y[:, :, dst slabs] += hop @ X[:, :, src slabs]`` in place on the
    (k, bs, ns) view Yv (slab geometry as in :func:`slab_m_accumulate`);
    returns Yv."""
    name = "slab_block_accumulate"
    hop = _hops(hop, Xv)
    bs = hop.shape[-1]
    if Xv.dim() != 3 or Xv.shape[1] != bs or Yv.shape != Xv.shape:
        raise ValueError(f"{name}: expected (k, {bs}, ns) fields X and Y, got "
                         f"{tuple(Xv.shape)} and {tuple(Yv.shape)}")
    k, _, ns = Xv.shape
    _check_slab(hop, g, nblocks, dst_mul, Xv.reshape(bs * k, ns), Yv.reshape(bs * k, ns),
                None, name)
    if not _native.f32_kernel(hop, Xv, Yv):
        return slab_v_plain(hop, g, nblocks, dst_mul, dst_off, src_shift, Xv, Yv)
    if Yv.data_ptr() == Xv.data_ptr():
        raise ValueError(f"{name}: Y must not share X's storage")
    nb = ns // g
    _launch_stream(name, hop, g, nblocks, (dst_mul % nb, dst_off % nb),
                   (dst_mul % nb, (dst_off + src_shift) % nb), Xv, ns, None, None, Yv, None,
                   False, view=True)
    return Yv


def _check_from(hop, g, nblocks, dst_base, src_base, m, bw, ns, vals, name):
    """The halo slab's geometry on merged-shaped (m, bw) source and (m, ns)
    destination: whole g-site blocks inside both, vals one per slab site."""
    bs = hop.shape[-1]
    if hop.shape != (bs, bs) or m % bs:
        raise ValueError(f"{name}: hop {tuple(hop.shape)} for {m} rows")
    if g < 1 or ns % g or bw % g:
        raise ValueError(f"{name}: slab width {g} must divide the {ns} sites and the "
                         f"{bw}-site source")
    if nblocks < 1 or not 0 <= dst_base <= ns // g - nblocks or \
            not 0 <= src_base <= bw // g - nblocks:
        raise ValueError(f"{name}: {nblocks} blocks from {src_base} (of {bw // g}) to "
                         f"{dst_base} (of {ns // g})")
    if vals is not None and vals.shape != (1, nblocks * g):
        raise ValueError(f"{name}: vals {tuple(vals.shape)}, expected (1, {nblocks * g})")


def slab_m_accumulate_from(hop, g: int, nblocks: int, dst_base: int, src_base: int,
                           Src: torch.Tensor, Ym: torch.Tensor, Xm: torch.Tensor | None = None,
                           vals: torch.Tensor | None = None, *, with_gram: bool = False):
    """``Y[:, g-blocks dst_base + j] += v * (hop ⊗ I_k) Src[:, g-blocks
    src_base + j]``, j < nblocks, in place on the merged (m, ns) Ym, from a
    separate merged (m, bw) source (a received halo; its row stride is bw).
    ``vals`` (1, nblocks * g) scales each destination site (gauged
    crossings), or None. Returns Ym, or with ``with_gram`` ``(Ym, G)``, G
    the (m, m) Gram ``sum_dst X_dst dY^T`` of the increment alone, X the
    local field ``Xm``."""
    name = "slab_m_accumulate_from"
    hop = _hops(hop, Ym)
    if Src.dim() != 2 or Ym.dim() != 2 or Src.shape[0] != Ym.shape[0]:
        raise ValueError(f"{name}: Src {tuple(Src.shape)} and Y {tuple(Ym.shape)} must be "
                         "merged fields of one height")
    m, ns = Ym.shape
    bw = Src.shape[1]
    _check_from(hop, g, nblocks, dst_base, src_base, m, bw, ns, vals, name)
    if with_gram and (Xm is None or Xm.shape != Ym.shape):
        raise ValueError(f"{name}: the Gram needs the local field X shaped like Y")
    ops = ([hop, Src, Ym] + ([vals] if vals is not None else [])
           + ([Xm] if with_gram else []))
    if not _native.f32_kernel(*ops):
        return slab_from_plain(hop, g, nblocks, dst_base, src_base, Src, Ym, Xm, vals,
                               with_gram)
    if Ym.data_ptr() in (Src.data_ptr(), Xm.data_ptr() if with_gram else None):
        raise ValueError(f"{name}: Y must not share Src's or X's storage")
    nb, src_nb = ns // g, bw // g
    G = _launch_stream(name, hop, g, nblocks, (1 % nb, dst_base), (1 % src_nb, src_base), Src,
                       bw, vals, Xm, Ym, None, with_gram)
    return (Ym, G) if with_gram else Ym


def slab_block_accumulate_from(hop, g: int, nblocks: int, dst_base: int, src_base: int,
                               Src: torch.Tensor, Yv: torch.Tensor) -> torch.Tensor:
    """``Y[:, :, g-blocks dst_base + j] += hop @ Src[:, :, g-blocks src_base +
    j]`` in place on the (k, bs, ns) view Yv, from a separate (k, bs, bw)
    source; returns Yv. At k = 1 it is ``slab_m_accumulate_from`` without
    ``vals`` on the same memory."""
    name = "slab_block_accumulate_from"
    hop = _hops(hop, Yv)
    bs = hop.shape[-1]
    if (Yv.dim() != 3 or Src.dim() != 3 or Yv.shape[1] != bs
            or Src.shape[:2] != Yv.shape[:2]):
        raise ValueError(f"{name}: expected (k, {bs}, .) fields Src and Y, got "
                         f"{tuple(Src.shape)} and {tuple(Yv.shape)}")
    k, _, ns = Yv.shape
    bw = Src.shape[2]
    _check_from(hop, g, nblocks, dst_base, src_base, bs * k, bw, ns, None, name)
    if not _native.f32_kernel(hop, Src, Yv):
        return slab_v_from_plain(hop, g, nblocks, dst_base, src_base, Src, Yv)
    if Yv.data_ptr() == Src.data_ptr():
        raise ValueError(f"{name}: Y must not share Src's storage")
    _launch_stream(name, hop, g, nblocks, (1 % (ns // g), dst_base), (1 % (bw // g), src_base),
                   Src, bw, None, None, Yv, None, False, view=True)
    return Yv


def _slab_vec(g: int, *fields) -> bool:
    """Whether a slab add takes ``csrc/slab_stream.cu``'s 16-byte
    route: g % 4 == 0 and every field it reads or writes (None skipped) on a
    16-byte boundary (the row strides, multiples of g, keep every slab's
    quads aligned)."""
    return g % 4 == 0 and all(f.data_ptr() % 16 == 0 for f in fields if f is not None)


def _launch_stream(name, hop, g, nblocks, dst, src, X, xn, vals, Xd, Y, Gin, with_gram,
                   view: bool = False):
    """One ``csrc/slab_stream.cu`` launch of a slab add on ``slab_plan``,
    on a merged (m, ns) field or (``view``) the (k, bs, ns) view, whose row
    map (sa, si) it passes: (k, 1) merged, (1, bs) on the view. ``dst`` and
    ``src`` are the reduced (mul, off) block maps of Y (ns columns) and X (xn
    columns); with the Gram Xd is the field whose destination columns it
    reads. Returns the (m, m) Gram, Gin plus the slab's, or None. The Gram's
    scratch is one buffer: the (grid, m, m) partials, then the grid
    barrier's counter."""
    bs = hop.shape[-1]
    ns = Y.shape[-1]
    m = Y.numel() // ns
    k = m // bs
    sa, si = (1, bs) if view else (k, 1)
    dev = Y.device
    vec = _slab_vec(g, X, Y, vals, Xd if with_gram else None)
    plan = slab_plan(m, bs, g, nblocks, with_gram, vec, _native.sm_count(dev.index),
                     _native.max_smem(dev.index))
    p = _native.ptr
    part = G = arrived = None
    if with_gram:
        part = torch.empty(plan.grid * m * m + 4, dtype=torch.float32, device=dev)
        G = torch.empty((m, m), dtype=torch.float32, device=dev)
        arrived = p(part) + 4 * plan.grid * m * m
    _native.launch(name, "bcg_slab_stream" if vec else "bcg_slab_stream_scalar", dev, p(hop),
                   bs, g, nblocks, *dst, *src, p(X), xn, p(vals), p(Xd) if with_gram else None,
                   p(Y), p(Gin), p(part), p(G), arrived, k, ns, sa, si, plan.kmax, plan.tc,
                   plan.grid)
    return G
