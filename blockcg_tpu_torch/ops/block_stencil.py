"""Per-site block stencil: the apply of lattice operators with matrix-valued
links (``BlockDIAOperator``).

Counterpart of ``blockcg_tpu/ops/block_stencil.py`` and of the ring schedule
of the same contract, ``blockcg_tpu/ops/block_stencil_ring.py``; all run as
``csrc/block_stencil.cu``:

- ``block_stencil_spmm_m_t``: ``Ym[a*k+i, s] = sum_d sum_b blocks[d, a, b, s]
  Xm[b*k+i, (s + o_d) mod ns]`` on a merged (m = bs*k, ns) field;
- ``block_stencil_spmm_m_gram_t``: the same with ``Gm = X Y^T`` (m, m);
- ``block_stencil_spmm_t``: the same sum on the (k, bs, ns) view (or its
  flat (k, bs*ns) form), ``Y[i, a, s] = sum_d sum_b blocks[d, a, b, s]
  X[i, b, (s + o_d) mod ns]``.

The ring kernels are a TPU schedule (each X block fetched from HBM once),
not part of the contract: the port has no ring entry of its own. Their
``fold=`` mode is: the merged wrappers take ``fold``, the reference's
``((diagonal, L), ...)`` of folded periodic wraps (``blockcg_tpu/ops/
block_stencil_ring.py:62-97``), with the operator's folded blocks and
offsets: a folded diagonal's source site is ``(s + o (1 - L)) mod ns`` where
``(s // |o|) % L`` is its wrap phase (L - 1 for o > 0, 0 for o < 0) and
``(s + o) mod ns`` elsewhere. The reference's merged kernels need m % 8 == 0
(a TPU sublane rule); the CUDA kernel takes any m. Left out: ``donate``.

Dispatch follows ``ops/_native.py`` (``pair_kernel``): CPU and CUDA float64
tensors run the plain versions below (the reference's ``_matmat_m_xla``
roll-and-einsum, summed in f32 as its kernels sum), CUDA float32 fields
launch the kernel on float32 blocks, or its ``[bf16 coeffs]`` variant on
bfloat16 blocks (lifted exactly to f32; the reference's gate
``BlockDIAOperator._kernel_ok`` takes both with f32 fields), and anything
else raises, bf16 fields and complex blocks included (the operator sends a
bf16 field to its own plain route, ``operators/bdia.py``; the route of
complex blocks to the card is ``operators.realify``). A folded launch counts
as ``[fold]`` (``[fold, bf16 coeffs]``). Kernel bounds: at most 32
diagonals and bs <= 8, and an even ns on bf16 blocks; the wrappers raise
outside them.
One launch takes m = bs * k <= 96 rows; a wider field runs as one launch per
chunk of right-hand sides (on the merged view with the field's spin stride,
as in ``ops/const_block_stencil.py``). ``block_stencil_plan`` picks each
launch's schedule on the host (``csrc/block_stencil.cu``: the window of X
around a tile of sites, the split of a site's outputs over threads, the ring
of coefficient stages); a Gram the launch cannot fuse (several chunks, or a
plan without room for it) is ``fused.gram`` of X and the stored Y. A merged
launch on bf16 blocks without the Gram or folds (rows 23h, 24h) runs the
same arithmetic on TMA tensor boxes (``bs_tma``: one request a window, a
diagonal's coefficient planes or a far slab, issued by one producer warp;
``block_stencil_plan(..., tma=True)``) where TMA can map its operands
(``_tma_ok``) and the schedule fits, and so does a launch of the (k, bs, ns)
view on bf16 blocks (row 22h: the field's 3-D map takes the view's strides,
so the staged rows and the consumers are the merged launch's); so does a
folded launch on f32 or bf16 blocks (rows 24f, 24fg, whose Gram
``fused.gram`` takes), a far folded diagonal's slab as one box a run of
sites that share their source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.solvers.common import acc_dtype, gram_t

# The (field, blocks) dtype pairs the kernel takes on CUDA.
PAIRS = ((torch.float32, torch.float32), (torch.float32, torch.bfloat16))

MAX_DIAGS = 32  # csrc/block_stencil.cu kMaxDiags
MAX_BS = 8  # csrc/block_stencil.cu kMaxBs
THREADS = 256  # csrc/block_stencil.cu kBsThreads
MAX_ROWS = 96  # csrc/block_stencil.cu kBsMaxRows: m = bs * k of one launch
STAGES = (2, 3, 4)  # ring depths the kernel takes (kBsMaxStages = 4)
SCRATCH = 16384  # csrc/block_stencil.cu kBsScratch: floats of a Gram launch's floor
GROUPS = (1, 2, 4, 8)  # splits of a site's right-hand sides over threads
# The built right-hand sides a thread (bs_spmm<BS, KI, GRAM>), by BS = 4 or 8.
KI_BUILT = {4: (1, 2, 3, 4, 6, 8, 12), 8: (1, 2, 3)}
ACC = 24  # sums a thread holds on the natural split: BS * KI <= 24


def _check(blocks, offsets, rows: int, ns: int, name: str) -> None:
    if blocks.dim() != 4 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"{name}: blocks must be (noff, bs, bs, ns), got "
                         f"{tuple(blocks.shape)}")
    noff, bs, _, nsb = blocks.shape
    if len(offsets) != noff:
        raise ValueError(f"{name}: {noff} diagonals, {len(offsets)} offsets")
    if nsb != ns or rows % bs:
        raise ValueError(f"{name}: blocks {tuple(blocks.shape)} for a field of "
                         f"{rows} rows and {ns} sites")


def _rhs_width(bs: int, nd: int, name: str) -> int:
    """Right-hand sides one launch takes: m = bs * k <= 96 rows (bs <= 8);
    at most 32 diagonals."""
    if not 1 <= bs <= MAX_BS:
        raise ValueError(f"{name}: the CUDA kernel takes bs <= {MAX_BS}, got {bs}")
    if nd > MAX_DIAGS:
        raise ValueError(f"{name}: {nd} diagonals, the CUDA kernel takes at most {MAX_DIAGS}")
    return MAX_ROWS // bs


BARRIER_BYTES = 8 * (2 * max(STAGES) + 2)  # csrc/block_stencil.cu: static mbarriers


def smem_bytes(bs: int, k: int, T: int, h: int, stages: int, far: bool, gram: bool,
               csize: int = 4) -> int:
    """Dynamic shared bytes of a launch (``csrc/block_stencil.cu``
    bs_smem_bytes): two float windows of m = bs * k rows and T + 2h + 4
    columns; ``stages`` ring slots of the bs^2 coefficient planes of T sites
    (``csize``-byte elements) and, with any far diagonal, m float rows of X;
    with the Gram the (m, T + 4) Y tile, at least the Gram's end-of-kernel
    scratch."""
    m = bs * k
    b = 8 * m * (T + 2 * h + 4) + stages * (csize * bs * bs + (4 * m if far else 0)) * T
    if gram:
        b = max(b + 4 * m * (T + 4), 4 * SCRATCH)
    return b


# The merged bf16-block schedule on TMA tensor boxes (csrc/block_stencil.cu
# bs_tma): one producer warp, a deeper ring.
TMA_STAGES = (2, 3, 4, 5, 6)  # ring depths it takes (kBtMaxStages = 6)
TMA_MAX_BOX = 256  # sites of a window box: T + 2h <= 256
TMA_BARRIER_BYTES = 8 * (2 * max(TMA_STAGES) + 2)


def tma_smem_bytes(bs: int, k: int, T: int, h: int, stages: int, far: bool,
                   csize: int = 2) -> int:
    """Dynamic shared bytes of a bs_tma launch (``csrc/block_stencil.cu``
    bt_smem_bytes): two f32 windows of m = bs * k rows and T + 2h sites,
    ``stages`` ring slots of the bs^2 coefficient planes of T sites
    (``csize``-byte elements) and, with any far diagonal, m f32 rows of X
    (each window and each slot's planes rounded up to 128 bytes, a box's
    alignment), and 128 bytes to align the boxes."""
    m = bs * k

    def r128(b):
        return -(-b // 128) * 128
    return (2 * r128(4 * m * (T + 2 * h))
            + stages * (r128(csize * bs * bs * T) + (4 * m * T if far else 0)) + 128)


def tma_far_granules(T: int, steps) -> list[int]:
    """Sites of each far slab's granule in ``bs_tma``
    (``csrc/block_stencil.cu`` tma_launch_ok), for the far diagonals' runs
    ``steps`` (None unfolded): T, or on a folded diagonal whose runs of st
    sites are not whole tiles, the least over those of the largest power of
    two dividing st (one box shape serves them)."""
    g = [T if not st else min(T, st & -st) for st in steps]
    least = min(g, default=T)
    return [T if v == T else least for v in g]


def tma_far_boxes(m: int, T: int, g: int) -> int:
    """TMA boxes of one far slab of a tile laid in granules of g sites: one a
    granule, where a granule's box is whole 16 bytes wide and lands 128-byte
    aligned (``bt_boxed``), else none (the lanes copy it)."""
    return T // g if g % 4 == 0 and m * g % 32 == 0 else 0


class BlockStencilPlan(NamedTuple):
    """One launch's schedule (``csrc/block_stencil.cu``): the window's halo
    ``h`` (a multiple of 4), the tile of ``T`` sites, the ``groups`` a site's
    right-hand sides split into (T = 256 / groups) of ``ki`` each, the
    ring's depth ``stages``, which diagonals read the window (``near``),
    whether the launch takes the Gram (``fused_gram``), its shared bytes, the
    L2->SM traffic of X per site in units of X, ``(T + 2h) / T`` plus one
    per far diagonal, its grid (one block an SM, at most one a tile), also
    the row count of the Gram partials, and whether it runs on TMA tensor
    boxes (``tma``: ``bs_tma``, else ``bs_spmm``'s cp.async ring) and then
    the TMA requests a tile issues at most (``boxes``: the window, each
    diagonal's coefficients, each far slab or granule of a folded one;
    those that would cross ns are copied instead)."""
    h: int
    T: int
    groups: int
    ki: int
    stages: int
    near: tuple[bool, ...]
    fused_gram: bool | None
    smem_bytes: int
    traffic: float
    blocks: int
    tma: bool = False
    boxes: int = 0

    def describe(self) -> str:
        gram = {True: "fused", False: "gram.cu", None: "none"}[self.fused_gram]
        return (f"h={self.h} T={self.T} groups={self.groups} ki={self.ki} "
                f"stages={self.stages} near={sum(self.near)}/{len(self.near)} gram={gram} "
                f"smem={self.smem_bytes} traffic={self.traffic:g} blocks={self.blocks}"
                + (f" tma boxes/tile={self.boxes}" if self.tma else ""))


def _split(bs: int, k: int, groups: int | None) -> tuple[int, int]:
    """(groups, ki): by default the fewest groups (a power of two, at most 8)
    that hold k right-hand sides at most ``ACC`` sums a thread, then the
    narrowest built ki that covers k over them."""
    w = 4 if bs <= 4 else 8
    built = KI_BUILT[w]
    if groups is None:
        groups = next((g for g in GROUPS if g * (ACC // w) >= k), GROUPS[-1])
    ki = next((v for v in built if v * groups >= k), None)
    if ki is None:
        raise ValueError(f"block stencil: {k} right-hand sides over {groups} groups pass the "
                         f"built widths {built}")
    return groups, ki


@functools.lru_cache(maxsize=256)
def block_stencil_plan(offsets: tuple[int, ...], ns: int, bs: int, k: int, with_gram: bool,
                       smem_cap: int, sm_count: int, *, h: int | None = None,
                       groups: int | None = None, stages: int | None = None,
                       csize: int = 4, wraps: tuple = (), tma: bool = False
                       ) -> BlockStencilPlan:
    """The schedule of a launch of k right-hand sides (m = bs * k <= 96) on
    ns sites. With ``with_gram`` it first tries a fused Gram (at most two
    groups, so the Gram's register width 2 BS ki covers m), and falls back to
    the plain split (``fused_gram`` False: the wrapper takes the Gram from
    ``fused.gram``); without, ``fused_gram`` is None. Among the halos (0, and
    each offset's distance rounded up to 4) and ring depths whose shared
    memory fits ``smem_cap`` beside the kernel's mbarriers, it keeps the
    least L2->SM traffic of X, then the deeper ring, then the smaller halo. A
    diagonal is near when its offset mod ns lies within h of 0 or of ns, the
    rule the kernel applies; a folded diagonal (``wraps``: ``((d, w), ...)``,
    its wrap partner's offset w) is near when both its offsets are, and the
    kernel then reads each site's X from the window at its own shift; a far
    one stages each site's X from its own source. ``csize``: bytes of a
    block element (2 on bf16 blocks). ``h``, ``groups`` and ``stages`` pin those
    choices (the timing tool's variants). ``tma``: a launch whose field and
    blocks TMA can map (``_tma_ok``), on bf16 blocks without the Gram or
    folds (either view), or folded (``wraps``, merged) on either blocks, with
    or without the Gram (then from ``fused.gram``: at 32^4, m = 48 the apply and
    ``gram`` took 1.165 ms on an H100, the Gram fused in ``bs_tma`` 1.275,
    PERF.md); it takes ``bs_tma``'s schedule
    (``tma_smem_bytes``, halos with T + 2h at most ``TMA_MAX_BOX`` and ns,
    depths ``TMA_STAGES``) where one fits with no more L2->SM traffic than
    ``bs_spmm``'s, else ``bs_spmm``'s. Unfolded launches on f32 blocks, and
    unfolded ones with the Gram, keep ``bs_spmm``. At 32^4, m = 48 on an H100
    it ran in half ``bs_spmm``'s time at equal traffic, but pinned to
    narrower halos (more far slabs, many copied by the one producer warp) 1.8
    to 3 times slower than ``bs_spmm``: PERF.md."""
    if not 1 <= bs * k <= MAX_ROWS:
        raise ValueError(f"block stencil: one launch takes bs * k <= {MAX_ROWS} rows, "
                         f"got {bs} x {k}")
    offs = [int(o) % ns for o in offsets]
    dist = [min(o, ns - o) for o in offs]
    for d, w in wraps:
        dist[d] = max(dist[d], min(int(w) % ns, ns - int(w) % ns))
    halos = sorted({0} | {-(-d // 4) * 4 for d in dist}) if h is None else [h]
    if tma and (wraps or (csize == 2 and not with_gram)):
        cp = block_stencil_plan(offsets, ns, bs, k, with_gram, smem_cap, sm_count, h=h,
                                groups=groups, stages=None, csize=csize, wraps=wraps)
        steps = {int(d): min(offs[d], ns - offs[d]) for d, _ in wraps}  # a fold's run: |o|
        g, ki = _split(bs, k, groups)
        T = THREADS // g
        best, best_key = None, None
        for st in TMA_STAGES if stages is None else (stages,):
            for hh in halos:
                if T + 2 * hh > min(TMA_MAX_BOX, ns) or st not in TMA_STAGES:
                    break
                far = [d > hh for d in dist]
                nbytes = tma_smem_bytes(bs, k, T, hh, st, any(far), csize)
                if nbytes + TMA_BARRIER_BYTES > smem_cap:
                    break
                traffic = (T + 2 * hh) / T + sum(far)
                key = (traffic, -st, hh)
                if best_key is None or key < best_key:
                    best_key = key
                    boxes = 1 + len(dist) + sum(
                        tma_far_boxes(bs * k, T, gr) for gr in tma_far_granules(
                            T, [steps.get(d) for d, f in enumerate(far) if f]))
                    best = BlockStencilPlan(hh, T, g, ki, st, tuple(not f for f in far),
                                            False if with_gram else None, nbytes, traffic,
                                            min(-(-ns // T), sm_count, _native.MAX_BLOCKS),
                                            True, boxes)
        if best is not None and best.traffic <= cp.traffic:
            return best
    depths = STAGES if stages is None else (stages,)
    tries = [(groups, False)]
    if with_gram:
        tries.insert(0, (min(_split(bs, k, None)[0], 2) if groups is None else groups, True))
    for g_req, gram in tries:
        if gram and g_req > 2:
            continue
        try:
            g, ki = _split(bs, k, g_req)
        except ValueError:
            continue
        T = THREADS // g
        best, best_key = None, None
        for st in depths:
            for hh in halos:
                far = [d > hh for d in dist]
                nbytes = smem_bytes(bs, k, T, hh, st, any(far), gram, csize)
                if nbytes + BARRIER_BYTES > smem_cap:
                    break
                traffic = (T + 2 * hh) / T + sum(far)
                key = (traffic, -st, hh)
                if best_key is None or key < best_key:
                    best_key = key
                    best = BlockStencilPlan(
                        hh, T, g, ki, st, tuple(not f for f in far),
                        gram if with_gram else None, nbytes, traffic,
                        min(-(-ns // T), sm_count, _native.MAX_BLOCKS))
        if best is not None:
            return best
    raise ValueError(f"block stencil: bs = {bs}, k = {k} leave no schedule in {smem_cap} "
                     "bytes of shared memory")


# ------------------------------------------------------------ plain versions


def fold_terms(offsets, fold, ns: int) -> dict:
    """``{d: (w, st, L, phase)}`` of the folded diagonals of ``fold`` (the
    reference's ``((d, L), ...)``): the wrap partner's offset ``w = o (1 -
    L)``, the run ``st = |o|`` of sites sharing a source, the axis extent and
    the destination phase that reads the wrap (L - 1 for o > 0, 0 for o <
    0)."""
    out = {}
    for d, L in fold:
        o = int(offsets[d])
        st = abs(o)
        if st == 0 or L < 3 or ns % (st * L):
            raise ValueError(f"block stencil: fold ({d}, {L}) of offset {o} does not tile "
                             f"{ns} sites")
        out[int(d)] = (o * (1 - L), st, int(L), L - 1 if o > 0 else 0)
    return out


def block_stencil_plain(blocks, offsets, Xm, with_gram: bool = False, fold=()):
    """Plain PyTorch version on the merged (m, ns) view: the roll-and-einsum
    of the reference's ``BlockDIAOperator._matmat_m_xla``, one input spin at
    a time, summed in f32 on f32 and bf16 fields (the kernels' contract).
    Returns ``(Ym, Gm or None)`` with ``Gm = X^H Y`` taken on the
    accumulator. ``fold``: folded diagonals, whose source per site is the
    wrap partner's on its phase (``fold_terms``)."""
    bs = blocks.shape[1]
    m, ns = Xm.shape
    adt = acc_dtype(Xm.dtype)
    Xv = Xm.reshape(bs, m // bs, ns).to(adt)
    C = blocks.to(adt)
    Yv = torch.zeros_like(Xv)
    folds = fold_terms(offsets, fold, ns)
    sites = torch.arange(ns, device=Xm.device)
    for d, o in enumerate(offsets):
        src = Xv if o % ns == 0 else torch.roll(Xv, -o, dims=2)
        if d in folds:
            w, st, L, phase = folds[d]
            src = torch.where((sites // st) % L == phase, torch.roll(Xv, -w, dims=2), src)
        for b in range(bs):
            Yv += C[d, :, b, None, :] * src[b]
    Y = Yv.reshape(m, ns)
    return Y.to(Xm.dtype), (gram_t(Xm, Y) if with_gram else None)


def block_stencil_v_plain(blocks, offsets, Xv):
    """Plain version on the (k, bs, ns) view (the reference's
    ``_matmat_v_xla``): the merged version on the transposed field."""
    k, bs, ns = Xv.shape
    Xm = Xv.transpose(0, 1).reshape(bs * k, ns)
    Ym = block_stencil_plain(blocks, offsets, Xm)[0]
    return Ym.reshape(bs, k, ns).transpose(0, 1).contiguous()


# ------------------------------------------------------------------ wrappers


def _tma_ok(blocks, X) -> bool:
    """Whether TMA can map a launch's operands (``csrc/block_stencil.cu``
    tma_launch_ok): either view on f32 or bf16 blocks, ns % 8 == 0 (16-byte
    rows of both) and 16-byte aligned storage. Which launches take it is
    ``block_stencil_plan``'s choice (unfolded f32 blocks keep ``bs_spmm``)."""
    ns = blocks.shape[-1]
    return (blocks.dtype in (torch.float32, torch.bfloat16) and ns % 8 == 0
            and ns < 2 ** 30 and blocks.data_ptr() % 16 == 0 and X.data_ptr() % 16 == 0)


def launch_plans(blocks, offsets, k: int, with_gram: bool, device, name: str = "block stencil",
                 fold=(), tma: bool = False):
    """``[((j0, j1), plan), ...]``: the chunks of right-hand sides a field of
    k runs as, one launch each, and the plan of each (the Gram fused only on a
    field of one chunk; ``tma``: the operands suit ``bs_tma``, which the
    plan takes where it may and its schedule fits)."""
    nd, bs, _, ns = blocks.shape
    chunks = _native.row_chunks(k, _rhs_width(bs, nd, name))
    offs = tuple(int(o) % ns for o in offsets)
    wraps = tuple((d, t[0]) for d, t in sorted(fold_terms(offsets, fold, ns).items()))
    cap, sms = _native.max_smem(device.index), _native.sm_count(device.index)
    gram = with_gram and len(chunks) == 1
    return [((j0, j1), block_stencil_plan(offs, ns, bs, j1 - j0, gram, cap, sms,
                                          csize=blocks.element_size(), wraps=wraps,
                                          tma=tma)) for j0, j1 in chunks]


def label(name: str, blocks, fold=()) -> str:
    """The launch-count name of a launch on these blocks: ``name``, with
    ``[bf16 coeffs]`` on bf16 blocks, ``[fold]`` folded (``[fold, bf16
    coeffs]``)."""
    tags = (["fold"] if fold else []) + (["bf16 coeffs"] if blocks.dtype == torch.bfloat16
                                         else [])
    return f"{name}[{', '.join(tags)}]" if tags else name


def _launch(blocks, offsets, X, k: int, merged: bool, with_gram: bool, name: str, fold=()):
    """Launch on a contiguous (bs * k, ns)-shaped field X (the merged view, or
    the (k, bs, ns) view and its flat form), one launch per chunk of
    right-hand sides; returns (Y shaped like X, Gm or None)."""
    from blockcg_tpu_torch.ops import fused

    nd, bs, _, ns = blocks.shape
    if blocks.dtype == torch.bfloat16 and ns % 2:
        raise ValueError(f"{name}: the kernel takes bf16 blocks on an even number of sites, "
                         f"got {ns}")
    offs = (ctypes.c_int * nd)(*(int(o) % ns for o in offsets))
    folds = fold_terms(offsets, fold, ns)
    table = None  # (wrap offset mod ns, st, L, phase) a diagonal, st = 0 unfolded
    if folds:
        quads = [folds.get(d, (0, 0, 0, 0)) for d in range(nd)]
        table = (ctypes.c_int * (4 * nd))(*(v for w, st, L, ph in quads
                                            for v in (w % ns, st, L, ph)))
    Y = torch.empty_like(X)
    row = ns * 4 * (1 if merged else bs)  # bytes from one RHS to the next
    p = _native.ptr
    G = None
    for (j0, j1), plan in launch_plans(blocks, offsets, k, with_gram, X.device, name, fold,
                                       _tma_ok(blocks, X)):
        part = None
        if plan.fused_gram:
            m = bs * k
            part = torch.empty((plan.blocks, m, m), dtype=torch.float32, device=X.device)
            G = torch.empty((m, m), dtype=torch.float32, device=X.device)
        if plan.tma:
            _native.launch(label(name, blocks, fold), "bcg_block_stencil_tma", X.device,
                           p(blocks), blocks.element_size(), offs, table, nd, bs,
                           p(X) + j0 * row, p(Y) + j0 * row, j1 - j0,
                           k if merged else j1 - j0, ns, int(merged), plan.h, plan.groups,
                           plan.ki, plan.stages, plan.blocks)
            continue
        _native.launch(label(name, blocks, fold), "bcg_block_stencil_spmm", X.device,
                       p(blocks), blocks.element_size(), offs, table, nd, bs,
                       p(X) + j0 * row, p(Y) + j0 * row, p(part), p(G), j1 - j0,
                       k if merged else j1 - j0, ns, int(merged), plan.h, plan.groups,
                       plan.ki, plan.stages, plan.blocks)
    if with_gram and G is None:
        G = fused.gram(X, Y)
    return Y, G


def _merged(blocks, offsets, Xm, with_gram: bool, name: str, fold=()):
    if Xm.dim() != 2:
        raise ValueError(f"{name}: expected a merged (m, ns) field, got {tuple(Xm.shape)}")
    _check(blocks, offsets, Xm.shape[0], Xm.shape[1], name)
    if _native.pair_kernel(Xm, blocks, PAIRS) is None:
        return block_stencil_plain(blocks, offsets, Xm, with_gram, fold)
    return _launch(blocks, offsets, Xm, Xm.shape[0] // blocks.shape[1], True,
                   with_gram, name, fold)


def block_stencil_spmm_m_t(blocks: torch.Tensor, offsets: tuple[int, ...],
                           Xm: torch.Tensor, fold=()) -> torch.Tensor:
    """Merged-layout block SpMM: blocks (noff, bs, bs, ns), Xm (m = bs*k,
    ns) with row a*k + i. Returns Ym. ``fold``: the folded diagonals of
    folded blocks and offsets (module docstring)."""
    return _merged(blocks, offsets, Xm, False, "block_stencil_spmm_m_t", fold)[0]


def block_stencil_spmm_m_gram_t(blocks: torch.Tensor, offsets: tuple[int, ...],
                                Xm: torch.Tensor, fold=()):
    """``(Ym, Gm = X Y^T)``, Gm (m, m); contract it to k x k with the
    operator's ``gram_contract``."""
    return _merged(blocks, offsets, Xm, True, "block_stencil_spmm_m_gram_t", fold)


def block_stencil_spmm_t(blocks: torch.Tensor, offsets: tuple[int, ...],
                         Xt: torch.Tensor) -> torch.Tensor:
    """Block SpMM on the (k, bs, ns) view, or its flat (k, bs*ns) form;
    returns Y shaped like Xt."""
    name = "block_stencil_spmm_t"
    bs, ns = blocks.shape[1], blocks.shape[-1]
    if Xt.dim() not in (2, 3) or Xt.shape[1:] not in ((bs * ns,), (bs, ns)):
        raise ValueError(f"{name}: expected a (k, {bs}, {ns}) or (k, {bs * ns}) "
                         f"field, got {tuple(Xt.shape)}")
    k = Xt.shape[0]
    _check(blocks, offsets, bs * k, ns, name)
    if _native.pair_kernel(Xt, blocks, PAIRS) is None:
        return block_stencil_v_plain(blocks, offsets, Xt.reshape(k, bs, ns)).reshape(Xt.shape)
    return _launch(blocks, offsets, Xt, k, False, False, name)[0]
