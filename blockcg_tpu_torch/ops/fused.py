"""Fused per-iteration block updates on lanes-major (k, n) fields.

Counterpart of the main-path kernels of ``blockcg_tpu/ops/fused.py``:

- ``gram(U, V)``                      G = U V^T            (``csrc/gram.cu``)
- ``mm_update(M, B, A)``              Y = M B (+ A)        (``csrc/mm_update.cu``)
- ``mm_update_gram(M, B, A)``         Y = M B (+ A), G = Y Y^T (``csrc/mm_update_gram.cu``)
- ``mm2_update_gram(M1, B1, M2, B2)`` Y = M1 B1 + M2 B2, G = Y Y^T
                                                           (``csrc/mm2_update_gram.cu``)
- ``px_update(M1, W, rho, P, C, X)``  Pn = M1 W + rho P, Xn = X + C P
                                                           (``csrc/px_update.cu``)
- ``xr_update_gram(a, P, X, Z, R)``   Xn = X + a P, Rn = R - a Z, G = Rn Rn^T
                                                           (``csrc/xr_update.cu``)
- ``qr_p_update(M2, Q1, rho, P)``     Q = M2 Q1, Pn = Q + rho P
                                                           (``csrc/px_update.cu``)
- ``qr_px_update(M2, Q1, rho, P, C, X)`` Q = M2 Q1, Pn = Q + rho P, Xn = X + C P
                                                           (``csrc/px_update.cu``)
- ``cheb_step(R, Z, D, AZ, c1, c2)``  D' = c1 D + c2 (R - AZ), Z' = Z + D'
                                                           (``csrc/cheb_step.cu``)

Fields are (k, n), or any contiguous (k, ...) field, such as the (k, bs, ns)
view of the distributed per-site block operator: it is the same memory as its
flat (k, n) form, so the kernels launch on that form and each output comes
back in its input's shape.

Each has a plain PyTorch version beside it, the composition the reference's
solvers fall back to (``blockcg_tpu/solvers/common.py:216-218, 233-237,
254-255, 271-273, 286-287, 299-300``, ``blockcg_tpu/operators/cheb.py:54-55``). Dispatch follows
``ops/_native.py``: CPU and CUDA float64 run the plain version, CUDA float32
launches the kernel. Grams are taken on the stored output. Fields must be
contiguous; the k x k coefficients are made so (they are often transposed
views).

bf16 fields: every update here but ``cheb_step`` takes bfloat16 fields
with float32 k x k coefficients (CUDA: the kernels' bf16 variants, counted
as ``name[bf16]``). Their contract is the reference kernels' on bf16
fields with its f32 coefficient route (``blockcg_tpu/ops/fused.py``
``_mxu_pair`` under ``BLOCKCG_NO_BF16_MXU=1``; its default rounds each
coefficient to bf16 for the TPU's bf16 MXU rate, which stalls bf16 BCG and
breaks BCGA down): the f32 coefficient times the field lifted to f32,
summed in f32 (``mm_update`` on the tensor cores takes the coefficient as
three bf16 pieces whose sum is it exactly), outputs stored in bf16
(``qr_p_update`` and ``qr_px_update`` add rho P to the unrounded f32 Q),
and a fused Gram taken on the stored bf16 output, its f32 sum of exact
products. ``cheb_step`` runs its plain version on
bf16 fields on any device, as the reference's gate sends every dtype but
float32 to XLA (``cheb_step_available``; ``_native.f32_kernel``): each
operation rounds to bf16 there.

``donate`` writes an output into the storage of the named input, which the
caller must treat as dead afterwards; both routes honour it, so a caller that
still reads a donated input fails on the CPU as it would on the card. Column
i of every output depends only on column i of the inputs, which is what makes
the kernels' in-place writes safe.

Width: ``xr_update_gram`` takes the Gram of at most 64 rows a launch, and
the streaming updates at most 128 output rows. A wider field runs as one
launch per chunk of output rows (``xr_update_gram_plan``, ``_update_plan``:
64 rows, or 32, 16 or 8 where the staged k-column coefficients would pass
the card's shared memory), each contracting over all k input rows; a fused
Gram then takes its diagonal blocks from the chunks' launches and the rest
from ``gram`` on the stored output (``wide_gram``, laid out by
``gram_blocks``). A donated output whose chunks read rows that an earlier
chunk would overwrite is written to a fresh buffer first and copied over.

``gram`` streams tiles of [U; V] (U alone when U is V, whose Gram is then
exactly symmetric) through shared memory, one launch up to 96 rows
(``csrc/gram.cu``, ``gram_plan``); a wider Gram is blocks of at most 96
rows. On bf16 fields ``gram`` and ``mm_update`` (up to 128 rows) run on the
tensor cores, their tiles streamed through a ring of TMA tensor copies
(``gram_plan``, ``mm_update_mma_plan``), and so do ``mm_update_gram`` and
``mm2_update_gram`` with their fused Gram up to 64 rows
(``update_gram_mma_plan``: the coefficients in three exact bf16 pieces, the
Gram of the stored Y exactly symmetric), and ``px_update`` up to 64 rows
(``px_update_mma_plan``: [M1 rho] and C in three pieces, one read of P
feeding both outputs), and ``qr_px_update`` up to 64 rows on the same
kernel (``px_update_mma_plan``: [M2 rho] and C, Q rounded from the f32
sums and stored from the fragments, Pn going on from those sums).

``mm_update``, ``mm_update_gram``, ``mm2_update_gram``, ``px_update``,
``qr_p_update``, ``qr_px_update`` and ``xr_update_gram`` run streaming
kernels that stage their input tiles in shared memory and split the output
rows across warps (``csrc/mm_update.cu``, ``update_gram.cuh`` through
``mm_update_gram.cu`` and ``mm2_update_gram.cu``, ``px_update.cu`` for the
next three, ``xr_update.cu`` on 64 rows a launch with their Gram): one
launch reads the inputs once up to 96 rows (128 where they fit), so a
donated operand takes its output in place (``mm_update_plan``,
``mm_update_gram_plan``, ``mm2_update_gram_plan``, ``px_update_plan``,
``qr_p_update_plan``, ``qr_px_update_plan``, ``xr_update_gram_plan``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.solvers.common import gram_t, mm


def _into(dst, Y):
    """Write Y into the donated operand ``dst`` (or return Y as it is)."""
    return Y if dst is None else dst.copy_(Y)


# ------------------------------------------------------------ plain versions


def gram_plain(U, V):
    return gram_t(U, V)


def mm_update_plain(M, B, A=None):
    Y = mm(M, B)
    return (Y if A is None else Y + A).to(B.dtype)


def mm_update_gram_plain(M, B, A=None):
    Y = mm_update_plain(M, B, A)
    return Y, gram_t(Y, Y)


def mm2_update_gram_plain(M1, B1, M2, B2):
    Y = (mm(M1, B1) + mm(M2, B2)).to(B1.dtype)
    return Y, gram_t(Y, Y)


def px_update_plain(M1, W, rho, P, C, X):
    Pn = (mm(M1, W) + mm(rho, P)).to(P.dtype)
    return Pn, (X + mm(C, P)).to(X.dtype)


def xr_update_gram_plain(alpha, P, X, Z, R):
    Xn = (X + mm(alpha, P)).to(X.dtype)
    Rn = (R - mm(alpha, Z)).to(R.dtype)
    return Xn, Rn, gram_t(Rn, Rn)


def qr_p_update_plain(M2, Q1, rho, P):
    Q = mm(M2, Q1)
    return Q.to(Q1.dtype), (Q + mm(rho, P)).to(P.dtype)


def qr_px_update_plain(M2, Q1, rho, P, C, X):
    Q = mm(M2, Q1)
    return (Q.to(Q1.dtype), (Q + mm(rho, P)).to(P.dtype),
            (X + mm(C, P)).to(X.dtype))


def cheb_step_plain(R, Z, D, AZ, c1: float, c2: float):
    Dn = c1 * D + c2 * (R - AZ)
    return Z + Dn, Dn


# ------------------------------------------------------------------ wrappers


def _gram_buffers(k: int, n: int, device, blocks: int | None = None):
    """The (blocks, k, k) Gram partials of a launch (``nblocks(n)`` rows
    unless its plan gives ``blocks``) and its (k, k) Gram."""
    part = torch.empty((_native.nblocks(n) if blocks is None else blocks, k, k),
                       dtype=torch.float32, device=device)
    return part, torch.empty((k, k), dtype=torch.float32, device=device)


def _flat(name, F, *others):
    """The (k, n) form of a contiguous (k, ...) field F and of the others
    (fields of F's shape, or None): views of the same memory."""
    if F.dim() < 2:
        raise ValueError(f"{name}: CUDA kernels take (k, ...) fields, got {tuple(F.shape)}")
    for G in others:
        if G is not None and G.shape != F.shape:
            raise ValueError(f"{name}: fields {tuple(F.shape)} and {tuple(G.shape)}")
    k = F.shape[0]
    return [None if G is None else G.view(k, -1) for G in (F, *others)]


RING_MAX_STAGES = 8  # csrc/mma.cuh kRingMaxStages: stages of a TMA ring
RING_BARRIER_BYTES = 8 * RING_MAX_STAGES  # its mbarriers, in static shared memory
RING_ALIGN = 1024  # bytes a launch adds to align its swizzled boxes (csrc/mma.cuh align1k)


def round8(r: int) -> int:
    """Rows of a staged box (``csrc/mma.cuh`` round8)."""
    return -(-r // 8) * 8


def ring_stages(smem_cap: int, stage_bytes: int, fixed: int = 0, blocks: int = 1,
                most: int = RING_MAX_STAGES) -> int:
    """Stages of ``stage_bytes`` a TMA ring (``csrc/mma.cuh``) holds beside
    ``fixed`` bytes, its alignment and its mbarriers in a block's share of
    the SM when ``blocks`` blocks share it (the SM's cap + 1 KB, less 1 KB a
    block), at most ``most``."""
    room = (smem_cap + 1024) // blocks - 1024 - RING_BARRIER_BYTES - RING_ALIGN - fixed
    return min(most, room // stage_bytes)


MM_UPDATE_MAX_K = 128  # csrc/mm_update.cu: output rows of one launch
MM_MMA_WIDTHS = (16, 32, 64, 128)  # csrc/mm_update.cu mm_mma_width: the bf16 kernel's widths
MM_MMA_TILES = (256, 128)  # column tiles of the bf16 kernel, widest first
MM_MMA_MAX_STAGES = 4  # deepest ring its plan takes


def mm_mma_blocks_per_sm(k: int) -> int:
    """Blocks an SM the bf16 ``mm_update`` kernel is built for
    (``csrc/mm_update.cu`` kMmMmaBlocks): two up to 64 rows, where one
    block's epilogue overlaps the other's products; one at 128 rows, whose
    96 registers of coefficient fragments a thread leave room for one."""
    return 2 if k <= 64 else 1


def mm_update_mma_smem_bytes(k: int, T: int, stages: int, has_a: bool) -> int:
    """Shared bytes of one bf16 ``mm_update`` launch (``csrc/mm_update.cu``
    mm_mma_smem_bytes): ``stages`` tiles of B, its k rows padded to the
    launch's width, and with A of A, and the tile of Y, all bf16 (k, T)
    tiles in swizzled boxes of ``round8(k)`` rows, and the alignment."""
    w = next(w for w in MM_MMA_WIDTHS if k <= w)
    return 2 * T * (stages * (w + (round8(k) if has_a else 0)) + round8(k)) + RING_ALIGN


class RingPlan(NamedTuple):
    """One launch of a tensor-core kernel fed by a TMA ring: its column tile
    ``T``, the ring's ``stages`` and the launch's shared bytes."""
    T: int
    stages: int
    smem_bytes: int


@functools.lru_cache(maxsize=64)
def mm_update_mma_plan(k: int, n: int, has_a: bool, smem_cap: int, sm_count: int) -> RingPlan:
    """The bf16 ``mm_update`` launch of k <= 128 rows on n columns (with A
    or not): the widest tile of ``MM_MMA_TILES`` that leaves every SM a
    tile (waived at 128 columns) and whose ring, beside the tile of Y, holds
    two stages in the shared memory of ``mm_mma_blocks_per_sm`` blocks, with
    as many stages as fit there up to ``MM_MMA_MAX_STAGES``. At (32, 256^3)
    the kernel took 703.5-786.9 us on 256 columns at two blocks an SM with
    four stages, 772.0-790.2 with two, three or five, 781.8 on 512 (two
    stages, the deepest two blocks hold), and 996-1,016 on 128; one block an
    SM took 1,040-1,313 (H100, tools/torch_kernel_times.py --bf16
    --variants, four calls)."""
    if not 1 <= k <= MM_UPDATE_MAX_K:
        raise ValueError(f"mm_update: one bf16 launch takes 1 to {MM_UPDATE_MAX_K} rows, got {k}")
    w = next(w for w in MM_MMA_WIDTHS if k <= w)
    for T in MM_MMA_TILES:
        if T > 128 and T > n // sm_count:
            continue
        stages = ring_stages(smem_cap, 2 * T * (w + (round8(k) if has_a else 0)),
                             2 * T * round8(k), mm_mma_blocks_per_sm(k), MM_MMA_MAX_STAGES)
        if stages >= 2:
            return RingPlan(T, stages, mm_update_mma_smem_bytes(k, T, stages, has_a))
    raise ValueError(f"mm_update: {k} rows leave no bf16 tile in {smem_cap} bytes of shared "
                     "memory")


UPDATE_GRAM_MMA_MAX_K = 64  # rows of one tensor-core launch of rows 7 and 8 (with the Gram)
UPDATE_MMA_WIDTHS = (16, 32, 64)  # csrc/update_gram.cuh dispatch_mma: the update's widths
UPDATE_MMA_TILES = (512, 256, 128)  # column tiles of update_gram_mma, widest first
UPDATE_MMA_MAX_STAGES = 4  # deepest ring its plan takes
UPDATE_MMA_SCRATCH = 9216  # floats of the Gram's sums, the launch's shared floor


def update_gram_mma_smem_bytes(k: int, T: int, stages: int, nf: int, has_a: bool) -> int:
    """Shared bytes of one bf16 ``mm_update_gram`` (``nf`` 1) or
    ``mm2_update_gram`` (``nf`` 2) launch on the tensor cores
    (``csrc/update_gram.cuh`` update_mma_smem_bytes): ``stages`` stages of
    the nf fields' (k, T) tiles, each padded to the update's width, and with
    A of A, and the tile of Y, in swizzled boxes; at least the Gram's sums;
    and the alignment."""
    w = next(w for w in UPDATE_MMA_WIDTHS if k <= w)
    b = 2 * T * (stages * (nf * w + (round8(k) if has_a else 0)) + round8(k))
    return max(b, 4 * UPDATE_MMA_SCRATCH) + RING_ALIGN


@functools.lru_cache(maxsize=64)
def update_gram_mma_plan(k: int, n: int, nf: int, has_a: bool, smem_cap: int,
                         sm_count: int) -> RingPlan:
    """The bf16 launch of ``mm_update_gram`` (``nf`` 1, with A or not) or
    ``mm2_update_gram`` (``nf`` 2) with its fused Gram on k <= 64 rows
    (``csrc/update_gram.cuh`` update_gram_mma, one block an SM): the widest
    tile of ``UPDATE_MMA_TILES`` that leaves every SM a tile (waived at 128
    columns) and whose ring, beside the tile of Y, holds two stages, with as
    many stages as fit up to ``UPDATE_MMA_MAX_STAGES``. At (32, 256^3) row 8
    took 1,586-1,600 us on 512 columns (two or three stages), 1,854-1,878
    on 256 (two to six), 2,478-2,551 on 128; row 7 1,304-1,312, 1,589-1,610
    and 1,780-2,202 (H100, tools/torch_kernel_times.py --bf16 --variants)."""
    if not 1 <= k <= UPDATE_GRAM_MMA_MAX_K:
        raise ValueError(f"update_gram_mma: one launch takes 1 to {UPDATE_GRAM_MMA_MAX_K} rows, "
                         f"got {k}")
    w = next(w for w in UPDATE_MMA_WIDTHS if k <= w)
    for T in UPDATE_MMA_TILES:
        if T > 128 and T > n // sm_count:
            continue
        stages = ring_stages(smem_cap, 2 * T * (nf * w + (round8(k) if has_a else 0)),
                             2 * T * round8(k), 1, UPDATE_MMA_MAX_STAGES)
        if stages >= 2:
            return RingPlan(T, stages, update_gram_mma_smem_bytes(k, T, stages, nf, has_a))
    raise ValueError(f"update_gram_mma: {k} rows leave no tile in {smem_cap} bytes of shared "
                     "memory")


PX_MMA_MAX_K = 64  # rows of one tensor-core launch of px_update (bf16 fields)
PX_MMA_C_BYTES = 3 * 64 * 128  # C's three pieces in shared memory at the 64-row width


def px_update_mma_smem_bytes(k: int, T: int, stages: int) -> int:
    """Shared bytes of one bf16 ``px_update`` or ``qr_px_update`` launch on
    the tensor cores (``csrc/px_update.cu`` px_mma_smem_bytes): ``stages`` stages of W's and
    P's (k, T) tiles, each padded to the update's width, and of X's, the
    tile of Pn, all in swizzled boxes; C's three pieces at the 64-row width;
    and the alignment."""
    w = next(w for w in UPDATE_MMA_WIDTHS if k <= w)
    return (2 * T * (stages * (2 * w + round8(k)) + round8(k))
            + (PX_MMA_C_BYTES if w == 64 else 0) + RING_ALIGN)


@functools.lru_cache(maxsize=64)
def px_update_mma_plan(k: int, n: int, smem_cap: int, sm_count: int) -> RingPlan:
    """The bf16 ``px_update`` launch on k <= 64 rows (``csrc/px_update.cu``
    px_update_mma, one block an SM), and ``qr_px_update``'s (its QR mode,
    which stores Q from its fragments and stages nothing more): the widest tile of ``UPDATE_MMA_TILES``
    that leaves every SM a tile (waived at 128 columns) and whose ring,
    beside the tile of Pn (and C's pieces at 64 rows), holds two stages,
    with as many stages as fit up to ``UPDATE_MMA_MAX_STAGES``, the rule of
    ``update_gram_mma_plan``, whose kernel this one extends. At (48, 32^4)
    that is 256 columns in two stages."""
    if not 1 <= k <= PX_MMA_MAX_K:
        raise ValueError(f"px_update_mma: one launch takes 1 to {PX_MMA_MAX_K} rows, got {k}")
    w = next(w for w in UPDATE_MMA_WIDTHS if k <= w)
    for T in UPDATE_MMA_TILES:
        if T > 128 and T > n // sm_count:
            continue
        fixed = 2 * T * round8(k) + (PX_MMA_C_BYTES if w == 64 else 0)
        stages = ring_stages(smem_cap, 2 * T * (2 * w + round8(k)), fixed, 1,
                             UPDATE_MMA_MAX_STAGES)
        if stages >= 2:
            return RingPlan(T, stages, px_update_mma_smem_bytes(k, T, stages))
    raise ValueError(f"px_update_mma: {k} rows leave no tile in {smem_cap} bytes of shared "
                     "memory")


def mm_update_plan(k: int, donate: str | None, device,
                   esize: int = 4) -> tuple[list[tuple[int, int]], bool]:
    """(row chunks, written in place) of ``mm_update`` on k rows. Up to 128
    rows: one launch of ``csrc/mm_update.cu``, which reads B once, so a
    donated B or A takes Y in place. Wider: the row chunks of
    ``mm_update_gram_plan``, on the same kernel without its Gram
    (``csrc/mm_update_gram.cu``), each reading all of B, so a donated B
    waits in a fresh buffer for the last chunk (a donated A does not: a
    chunk reads only its own rows of A)."""
    if k <= MM_UPDATE_MAX_K:
        return [(0, k)], True
    chunks = mm_update_gram_plan(k, device, esize).chunks
    return chunks, len(chunks) == 1 or donate != "b"


UPDATE_TILE = 128  # csrc/common.cuh kUpTile: columns a tile of the streaming updates
UPDATE_LD = UPDATE_TILE + 8  # csrc/common.cuh kUpLd: row stride of the staged Y tile
UPDATE_MAX_K = 128  # output rows of one streaming launch: 8 warps x 16
UPDATE_GRAM_MAX_K = 64  # rows whose Gram a launch of update_gram.cuh takes on two fields
UPDATE_GRAM_MAX_K_ONE = 96  # ... on one field (row 7; SymGram's 8x8 tiles at 96)
UPDATE_STAGES = 2  # csrc/common.cuh kUpStages: input stages in shared memory
UPDATE_MIN_KC = 32  # fewest stacked input rows a stage copies, short of all of them
_UPDATE_WIDTHS = (1, 2, 4, 6, 8, 12, 16)  # csrc/common.cuh rows_per_warp


def rows_per_warp(k: int) -> int:
    """Output rows a warp owns in a launch of k rows (``csrc/common.cuh``)."""
    return next(w for w in _UPDATE_WIDTHS if -(-k // 8) <= w)


def update_smem_bytes(k: int, kin: int, kc: int, nmat: int, gram: bool,
                      esize: int = 4) -> int:
    """Shared bytes of one streaming launch (``csrc/common.cuh``
    update_smem_bytes): ``nmat`` float coefficient tables of kin columns by
    8R rows, two (kc, 128) input stages (kc of the stacked input rows) of
    ``esize``-byte field elements and, with the Gram, the float (k, 136) Y
    tile, at least the Gram's end-of-kernel scratch."""
    b = 4 * (nmat * kin * 8 * rows_per_warp(k) + (k * UPDATE_LD if gram else 0))
    b += esize * UPDATE_STAGES * kc * UPDATE_TILE
    return max(b, 4 * 256 * (64 if k > 32 else 16)) if gram else b


class UpdatePlan(NamedTuple):
    """The launches of a streaming update of k rows (``mm_update_gram``,
    ``mm2_update_gram``, ``px_update``): the output row ``chunks``, one
    launch each, every one contracting over all k rows of each input field;
    the tile width ``T``; ``kc``, the stacked input rows a pipeline stage
    copies (all of them, k a field: one stage a tile); whether a donated
    operand is written ``in_place`` (one launch: it reads all its inputs
    before it writes); whether the launch takes the Gram (``fused_gram``;
    else ``wide_gram`` does); the launch's shared bytes; and the blocks an SM
    they leave room for."""
    chunks: list[tuple[int, int]]
    T: int
    kc: int
    in_place: bool
    fused_gram: bool
    smem_bytes: int
    blocks_per_sm: int


def _blocks_per_sm(kout: int, fused: bool, px: bool) -> int:
    """Blocks an SM a launch of kout rows is built for (the kernels'
    ``__launch_bounds__``: csrc/update_gram.cuh kUgBlocksPerSm for rows 7
    and 8 (and csrc/xr_update.cu kXrBlocksPerSm for row 10, whose launches
    all take a Gram), csrc/px_update.cu kPxBlocksPerSm for rows 9 and 12,
    ``px``): two where registers allow, else one. At (48, 32^4) row 12 took
    324 us on two blocks an SM (two stages a tile) against 370 on one (one
    stage; H100, tools/torch_kernel_times.py --const-hop --variants)."""
    if not px:
        return 2 if fused and kout <= 32 else 1
    return 2 if kout <= 64 else 1


@functools.lru_cache(maxsize=64)
def _update_plan(name: str, k: int, nfield: int, nmat: int, gram_rows: int,
                 cap: int, px: bool, esize: int = 4) -> UpdatePlan:
    """Plan of an update that stacks ``nfield`` input fields of k rows and
    stages ``nmat`` coefficient tables, with its Gram fused on a launch of up
    to ``gram_rows`` rows (0: no Gram). Up to 128 rows one launch, if its
    coefficients leave room for stages of at least ``UPDATE_MIN_KC`` rows (or
    all nfield k); wider, the widest row chunks (64, 32, 16 or 8 rows) that
    do; failing those, 8-row chunks on any stage depth that fits. Stages are
    as deep as the shared memory of the blocks an SM the kernel is built for
    allows (two blocks share the SM's cap + 1 KB, less 1 KB a block), or of
    one block where two leave no such room; cut into equal parts of the
    nfield k stacked rows. The launch takes the Gram up to ``gram_rows`` (one
    launch); wider, ``gram`` takes it on 64-row blocks (narrow chunks'
    diagonal blocks would need as many more cross-block launches). ``px``:
    the kernel is ``csrc/px_update.cu`` (rows 9 and 12), whose blocks an SM
    follow its own rule (``_blocks_per_sm``). ``esize``: the bytes of a
    field element (4, or 2 on bf16 fields), which size the stages."""
    nin = nfield * k
    widths = ([k] if k <= UPDATE_MAX_K else []) + [w for w in (64, 32, 16, 8) if w < k]
    for w, min_kc in [(w, UPDATE_MIN_KC) for w in widths] + [(8, 1)]:
        chunks = _native.row_chunks(k, w)
        kout = max(r1 - r0 for r0, r1 in chunks)
        fused = k <= gram_rows
        # Bytes besides the stages (the Gram's scratch floor lies below any
        # room a plan is made for).
        fixed = update_smem_bytes(kout, k, 0, nmat, False) + fused * 4 * kout * UPDATE_LD
        for blocks in range(_blocks_per_sm(kout, fused, px), 0, -1):
            room = (cap + 1024) // blocks - 1024
            deepest = (room - fixed) // (UPDATE_STAGES * UPDATE_TILE * esize)
            if deepest < min(nin, min_kc):
                continue
            stages = -(-nin // min(deepest, nin))
            kc = -(-nin // stages)
            return UpdatePlan(chunks, UPDATE_TILE, kc, len(chunks) == 1, fused,
                              update_smem_bytes(kout, k, kc, nmat, fused, esize), blocks)
    raise ValueError(f"{name}: {k} right-hand sides leave no room for the "
                     f"coefficients in {cap} bytes of shared memory")


def mm_update_gram_plan(k: int, device, esize: int = 4) -> UpdatePlan:
    """The launches of ``mm_update_gram`` on k rows (``csrc/mm_update_gram.cu``):
    up to 128 rows one launch, which reads B once, with the fused Gram up to
    96 rows; wider, row chunks of Y; above 96 rows the Gram comes from
    ``wide_gram``. A donated B takes Y in place on one launch. ``esize``:
    bytes of a field element (2 on bf16 fields)."""
    return _update_plan("mm_update_gram", k, 1, 1, UPDATE_GRAM_MAX_K_ONE,
                        _native.max_smem(device.index), False, esize)


def mm2_update_gram_plan(k: int, device, esize: int = 4) -> UpdatePlan:
    """The launches of ``mm2_update_gram`` on k rows (``csrc/mm2_update_gram.cu``):
    up to 64 rows one launch with the fused Gram; up to 96 rows (128 where
    they fit) one launch of Y; wider, row chunks of Y; above 64 rows the
    Gram comes from ``wide_gram``. A donated B1 takes Y in place on one
    launch."""
    return _update_plan("mm2_update_gram", k, 2, 2, UPDATE_GRAM_MAX_K,
                        _native.max_smem(device.index), False, esize)


def qr_p_update_plan(k: int, device, esize: int = 4) -> UpdatePlan:
    """The launches of ``qr_p_update`` on k rows (``csrc/px_update.cu``, QR):
    up to 96 rows one launch (128 where the two coefficient tables leave
    room), which reads Q1 and P once, so donated Q1 and P take Q and Pn in
    place; wider, row chunks, each reading all of Q1 and P. ``esize``: bytes
    of a field element (2 on bf16 fields)."""
    return _update_plan("qr_p_update", k, 2, 2, 0, _native.max_smem(device.index), True, esize)


def qr_px_update_plan(k: int, device, esize: int = 4) -> UpdatePlan:
    """The launches of ``qr_px_update`` on k rows (``csrc/px_update.cu``, QR
    with X: f32 fields, and bf16 above 64 rows): up to 128 rows one launch
    where its three coefficient tables leave room (m = 96 in two stages a
    tile), which reads Q1 and P once, so donated Q1, P and X take Q, Pn and
    Xn in place; wider, row chunks, each reading all of Q1 and P and its own
    rows of X. ``esize``: bytes of a field element (2 on bf16 fields)."""
    return _update_plan("qr_px_update", k, 2, 3, 0, _native.max_smem(device.index), True, esize)


def px_update_plan(k: int, device, esize: int = 4) -> UpdatePlan:
    """The launches of ``px_update`` on k rows (``csrc/px_update.cu``): up to
    128 rows one launch where its three coefficient tables leave room (m = 96
    in two stages a tile), wider in row chunks. A donated X always takes Xn in
    place (a chunk reads only its own rows of X); a donated P takes Pn in
    place on one launch."""
    return _update_plan("px_update", k, 2, 3, 0, _native.max_smem(device.index), True, esize)


class XrPlan(NamedTuple):
    """The launches of ``xr_update_gram`` on k rows (``csrc/xr_update.cu``):
    the row ``chunks``, one launch each with the Gram of its rows, every one
    contracting over all k rows of P and Z; ``kc``, the stacked rows of
    [P; Z] a pipeline stage copies; the launch's shared bytes; the blocks an
    SM it is built for; and ``grid``, those blocks times the card's SMs: the
    persistent grid of every launch (at most one block a tile) and the row
    count of its Gram partials. It depends on the card and the build alone,
    not on n."""
    chunks: list[tuple[int, int]]
    kc: int
    smem_bytes: int
    blocks_per_sm: int
    grid: int


def xr_smem_bytes(k: int, kin: int, kc: int, esize: int = 4, floor: bool = True) -> int:
    """Shared bytes of one ``xr_update_gram`` launch of k rows
    (``csrc/xr_update.cu`` xr_smem_bytes): alpha's (kin, 8R) float table,
    two stage buffers of kc stacked rows of [P; Z] (on bf16 fields and the
    2k rows of [X; R]) in ``esize``-byte elements, the float (k, 136) tile
    of Rn, at least the Gram's end-of-kernel scratch (not with ``floor``
    False)."""
    rows = kc + (2 * k if esize == 2 else 0)
    b = 4 * (8 * rows_per_warp(k) * kin + k * UPDATE_LD)
    b += esize * UPDATE_STAGES * rows * UPDATE_TILE
    return max(b, 4 * 256 * (64 if k > 32 else 16)) if floor else b


@functools.lru_cache(maxsize=64)
def _xr_plan(k: int, cap: int, sms: int, esize: int) -> XrPlan:
    """Up to 64 rows one launch, else the widest row chunks (64, 32, 16 or 8
    rows) whose launch leaves room for stages of at least ``UPDATE_MIN_KC``
    stacked rows (or all 2k); failing those, 8-row chunks on any depth.
    Stages as deep as the shared memory of the blocks an SM the kernel is
    built for allows (two blocks share the SM's cap + 1 KB, less 1 KB a
    block), or of one block, cut into equal parts of the 2k rows of
    [P; Z]."""
    nin = 2 * k
    widths = ([k] if k <= UPDATE_GRAM_MAX_K else []) + [w for w in (64, 32, 16, 8) if w < k]
    for w, min_kc in [(w, UPDATE_MIN_KC) for w in widths] + [(8, 1)]:
        chunks = _native.row_chunks(k, w)
        kout = max(r1 - r0 for r0, r1 in chunks)
        # xr_smem_bytes less its stages of [P; Z] (its floor lies below any room)
        fixed = xr_smem_bytes(kout, k, 0, esize, floor=False)
        for blocks in range(_blocks_per_sm(kout, True, False), 0, -1):
            room = (cap + 1024) // blocks - 1024
            deepest = (room - fixed) // (esize * UPDATE_STAGES * UPDATE_TILE)
            if deepest < min(nin, min_kc):
                continue
            stages = -(-nin // min(deepest, nin))
            kc = -(-nin // stages)
            return XrPlan(chunks, kc, xr_smem_bytes(kout, k, kc, esize), blocks, blocks * sms)
    raise ValueError(f"xr_update_gram: {k} right-hand sides leave no room for the "
                     f"coefficients in {cap} bytes of shared memory")


def xr_update_gram_plan(k: int, device, esize: int = 4) -> XrPlan:
    """The launches of ``xr_update_gram`` on k rows (``csrc/xr_update.cu``):
    up to 64 rows one launch with the fused Gram, which reads P and Z once;
    wider, row chunks of at most 64 rows, each with the Gram of its own rows
    (``wide_gram`` adds the cross blocks). The stages and the blocks an SM
    follow rows 7 and 8 (two blocks up to 32 rows, one above); the grid is
    blocks an SM times SMs. ``esize``: bytes of a field element (2 on bf16
    fields). Cached per card, width and element size: a call does no more
    than a few cache lookups."""
    idx = device.index
    return _xr_plan(k, _native.max_smem(idx), _native.sm_count(idx), esize)


GRAM_THREADS = 256  # csrc/gram.cu kGrThreads
GRAM_MAX_K = 96  # rows of U (and of V) one gram launch takes
GRAM_WIDTHS = (8, 16, 32, 48, 64, 96)  # csrc/gram.cu gram_width: the built register widths
GRAM_TILES = (1024, 512, 256, 128)  # column tiles csrc/gram.cu takes, widest first
GRAM_STAGES = 2  # csrc/gram.cu kGrStages: tiles in shared memory
GRAM_SCRATCH = 16384  # csrc/gram.cu kGrScratch: floats of a launch's shared floor


def gram_smem_bytes(rows: int, T: int, same: bool) -> int:
    """Shared bytes of one ``gram`` launch on f32 fields (``csrc/gram.cu``
    gram_smem_bytes): two tiles of ``rows`` stacked rows of T columns at a
    row stride of T + 8 (``SymGram``, U is V) or T + 4 (``VecGram``), at
    least the Gram's end-of-kernel scratch."""
    return max(4 * GRAM_STAGES * rows * (T + (8 if same else 4)), 4 * GRAM_SCRATCH)


def gram_mma_smem_bytes(ku: int, kv: int, same: bool, T: int, stages: int) -> int:
    """Shared bytes of one ``gram`` launch on bf16 fields (``csrc/gram.cu``
    gram_mma_smem_bytes): ``stages`` tiles of U (and V) in swizzled boxes of
    ``round8`` rows, at least the Gram's end-of-kernel scratch, and the
    alignment."""
    b = 2 * stages * T * (round8(ku) + (0 if same else round8(kv)))
    return max(b, 4 * GRAM_SCRATCH) + RING_ALIGN


class GramPlan(NamedTuple):
    """One ``gram`` launch (``csrc/gram.cu``): the column tile ``T`` a stage
    copies, the launch's shared bytes, its grid (one block an SM, at most
    one a tile), which is also the row count of the Gram partials, and the
    tiles in shared memory (2 for f32 fields; the TMA ring's depth for bf16
    fields)."""
    T: int
    smem_bytes: int
    blocks: int
    stages: int = GRAM_STAGES


@functools.lru_cache(maxsize=256)
def gram_plan(ku: int, kv: int, same: bool, n: int, smem_cap: int, sm_count: int,
              esize: int = 4) -> GramPlan:
    """The widest column tile whose two stages of the ``ku + kv`` stacked
    rows (``ku`` when U is V) fit ``smem_cap`` and that leaves every SM a
    tile (waived at 128 columns). Wider tiles ran faster wherever they fit:
    at (48, 32^4) 224 us on 256 columns against 305 on 128, with U is V 171
    on 512 against 183 on 256; at (96, 32^4) with U is V 444 on 256 against
    508 on 128 (H100, tools/torch_kernel_times.py --variants). bf16 fields
    (``esize`` 2, the tensor-core kernel) take the widest such tile whose
    ring holds two stages, with as many as fit up to ``RING_MAX_STAGES``:
    at (32, 256^3) 682.4-705.0 us on 512 and 256 columns at any depth,
    1,122-1,158 on 128; with U is V 350.0-358.6 on 1,024, 407-421 on 512
    (H100, tools/torch_kernel_times.py --bf16 --variants)."""
    if not (1 <= ku <= GRAM_MAX_K and 1 <= kv <= GRAM_MAX_K):
        raise ValueError(f"gram: one launch takes at most {GRAM_MAX_K} rows, got {ku} x {kv}")
    rows = ku if same else ku + kv
    for T in GRAM_TILES:
        if T > 128 and T > n // sm_count:
            continue
        blocks = min(-(-n // T), sm_count, _native.MAX_BLOCKS)
        if esize == 2:
            stages = ring_stages(smem_cap, 2 * T * (round8(ku) + (0 if same else round8(kv))))
            if stages >= 2:
                return GramPlan(T, gram_mma_smem_bytes(ku, kv, same, T, stages), blocks, stages)
            continue
        nbytes = gram_smem_bytes(rows, T, same)
        if nbytes <= smem_cap:
            return GramPlan(T, nbytes, blocks)
    raise ValueError(f"gram: {rows} stacked rows leave no tile in {smem_cap} bytes of "
                     "shared memory")


def _launch_gram(U, V):
    """One launch: G = U V^T of two row blocks of at most 96 rows each; the
    same storage for U and V takes the symmetric Gram."""
    ku, n = U.shape
    kv = V.shape[0]
    same = U.data_ptr() == V.data_ptr() and ku == kv
    idx = U.device.index
    plan = gram_plan(ku, kv, same, n, _native.max_smem(idx), _native.sm_count(idx),
                     U.element_size())
    part = torch.empty((plan.blocks, ku, kv), dtype=torch.float32, device=U.device)
    G = torch.empty((ku, kv), dtype=torch.float32, device=U.device)
    ring = (plan.stages,) if U.dtype == torch.bfloat16 else ()
    _native.launch(*_native.variant("gram", "bcg_gram", U.dtype), U.device, _native.ptr(U),
                   _native.ptr(V), _native.ptr(part), _native.ptr(G), ku, kv, n, plan.T, *ring,
                   plan.blocks)
    return G


def _gram_groups(chunks):
    """Consecutive row chunks joined into groups of at most ``GRAM_MAX_K``
    rows: lists of chunk indices."""
    groups, rows = [], GRAM_MAX_K + 1
    for a, (r0, r1) in enumerate(chunks):
        if rows + r1 - r0 > GRAM_MAX_K:
            groups.append([])
            rows = 0
        groups[-1].append(a)
        rows += r1 - r0
    return groups


def gram_blocks(k: int, chunks=None, same: bool = False):
    """How ``wide_gram`` lays out G (k x k): ``(what, r0, r1, s0, s1, a)``
    for each block, ``what`` one of "diag" (``diag[a]`` from a fused
    kernel's launch on chunk a), "launch" (one ``gram`` launch of rows r0:r1
    of U by rows s0:s1 of V) or "mirror" (the transpose of block (s0:s1,
    r0:r1), when U is V). Without fused blocks (``chunks`` None) G is cut
    into the fewest square blocks of at most 96 rows, the diagonal ones
    symmetric launches when U is V. With them, the chunks are joined into
    groups of at most 96 rows: blocks between two groups are one launch (or
    a mirror), and inside a group each chunk's rows take the group's later
    columns in one rectangular launch (mirrored, or a second launch, below
    the diagonal)."""
    fused = chunks is not None
    chunks = chunks if fused else _native.row_chunks(k, GRAM_MAX_K)
    groups = _gram_groups(chunks) if fused else [[a] for a in range(len(chunks))]
    span = [(chunks[g[0]][0], chunks[g[-1]][1]) for g in groups]
    out = []
    for A, ga in enumerate(groups):
        a0, a1 = span[A]
        for B in range(len(groups)):
            b0, b1 = span[B]
            if A != B:
                out.append(("mirror" if same and B < A else "launch", a0, a1, b0, b1, None))
            elif not fused:
                out.append(("launch", a0, a1, a0, a1, None))
            else:
                for a in ga:
                    r0, r1 = chunks[a]
                    out.append(("diag", r0, r1, r0, r1, a))
                    if r1 < a1:
                        out.append(("launch", r0, r1, r1, a1, None))
                        out.append(("mirror" if same else "launch", r1, a1, r0, r1, None))
    return out


def wide_gram(U, V, diag=None, chunks=None):
    """G = U V^T of (k, n) fields wider than one launch, laid out by
    ``gram_blocks``: ``diag[a]`` on the diagonal where a fused kernel already
    gave it, in which case ``chunks`` must be the ones its launches ran on;
    when U is V the lower blocks mirror the upper ones (the same products,
    summed in the same order)."""
    k = U.shape[0]
    if diag is not None and len(diag) != len(chunks):
        raise ValueError(f"wide_gram: {len(diag)} diagonal blocks for {len(chunks)} chunks")
    same = U.data_ptr() == V.data_ptr() and U.shape == V.shape
    G = torch.empty((k, k), dtype=torch.float32, device=U.device)
    for what, r0, r1, s0, s1, a in gram_blocks(k, None if diag is None else chunks, same):
        if what == "diag":
            G[r0:r1, s0:s1] = diag[a]
        elif what == "mirror":
            G[r0:r1, s0:s1] = G[s0:s1, r0:r1].T
        else:
            G[r0:r1, s0:s1] = _launch_gram(U[r0:r1], V[s0:s1])
    return G


def gram(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """G = U V^T over the field dims: (k, n) x (k, n) -> (k, k)."""
    if _native.field_kernel((U, V)) is None:
        return gram_plain(U, V)
    U, V = _flat("gram", U, V)
    if U.shape[0] <= GRAM_MAX_K:
        return _launch_gram(U, V)
    return wide_gram(U, V)


def _wide_update(M, B, A, out):
    """``mm_update`` above 128 rows: the row chunks of ``mm_update_gram``'s
    kernel without its Gram (``bcg_mm_update_gram`` with G null): 976
    against 1,609 us at (400, 2^16), 4,718 against 10,585 at (800, 2^16) for
    the one-thread-a-column kernel it replaced, the same bits (H100,
    tools/torch_kernel_times.py --variants)."""
    k, n = B.shape
    _native.check_kk(M, k, "mm_update M")
    plan = mm_update_gram_plan(k, B.device, B.element_size())
    # Every chunk reads all of B: a donated B must wait for the last one.
    direct = out is None or len(plan.chunks) == 1 or out is A
    Y = out if out is not None and direct else torch.empty_like(B)
    p = _native.ptr
    name = _native.variant("mm_update", "bcg_mm_update_gram", B.dtype)
    for r0, r1 in plan.chunks:
        _native.launch(*name, B.device, p(M[r0:r1]), p(B),
                       p(None if A is None else A[r0:r1]), p(Y[r0:r1]), None, None, r1 - r0,
                       k, n, plan.kc, _native.nblocks(n))
    return Y if direct else out.copy_(Y)


def mm_update(M: torch.Tensor, B: torch.Tensor,
              A: torch.Tensor | None = None, *,
              donate: str | None = None) -> torch.Tensor:
    """Y = M B (+ A); M (k, k), fields (k, n). ``donate`` 'b' writes Y onto
    B, 'a' onto A."""
    M = M.contiguous()
    ops = (M, B) if A is None else (M, B, A)
    if donate not in (None, "a", "b") or (donate == "a" and A is None):
        raise ValueError(f"mm_update: donate must be None, 'b' or 'a' (with A), got {donate!r}")
    dst = {None: None, "a": A, "b": B}[donate]
    dt = _native.field_kernel((B, A), (M,))
    if dt is None:
        return _into(dst, mm_update_plain(M, B, A))
    Bf, Af = _flat("mm_update", B, A)
    df = {None: None, "a": Af, "b": Bf}[donate]
    k, n = Bf.shape
    if len(mm_update_plan(k, donate, Bf.device, Bf.element_size())[0]) > 1:
        return _wide_update(M, Bf, Af, df).view(B.shape)
    _native.check_kk(M, k, "mm_update M")
    Y = torch.empty_like(Bf) if df is None else df
    p = _native.ptr
    ring = ()
    if dt == torch.bfloat16:
        idx = Bf.device.index
        plan = mm_update_mma_plan(k, n, Af is not None, _native.max_smem(idx),
                                  _native.sm_count(idx))
        ring = (plan.T, plan.stages)
    _native.launch(*_native.variant("mm_update", "bcg_mm_update", dt), Bf.device, p(M), p(Bf),
                   p(Af), p(Y), k, n, *ring)
    return Y.view(B.shape)


def mm_update_gram(M: torch.Tensor, B: torch.Tensor,
                   A: torch.Tensor | None = None, *, donate: bool = False):
    """(Y = M B (+ A), G = Y Y^T); ``donate`` writes Y onto B."""
    M = M.contiguous()
    dst = B if donate else None
    dt = _native.field_kernel((B, A), (M,))
    if dt is None:
        Y, G = mm_update_gram_plain(M, B, A)
        return _into(dst, Y), G
    Bf, Af = _flat("mm_update_gram", B, A)
    k, n = Bf.shape
    _native.check_kk(M, k, "mm_update_gram M")
    p = _native.ptr
    if dt == torch.bfloat16 and k <= UPDATE_GRAM_MMA_MAX_K:  # the tensor cores, one launch
        idx = Bf.device.index
        mma = update_gram_mma_plan(k, n, 1, Af is not None, _native.max_smem(idx),
                                   _native.sm_count(idx))
        Y = Bf if donate else torch.empty_like(Bf)
        part, G = _gram_buffers(k, n, Bf.device)
        _native.launch("mm_update_gram[bf16]", "bcg_mm_update_gram_mma", Bf.device, p(M),
                       p(Bf), p(Af), p(Y), p(part), p(G), k, n, mma.T, mma.stages,
                       _native.nblocks(n))
        return Y.view(B.shape), G
    plan = mm_update_gram_plan(k, Bf.device, Bf.element_size())
    Y = Bf if donate and plan.in_place else torch.empty_like(Bf)
    part, G = _gram_buffers(k, n, Bf.device) if plan.fused_gram else (None, None)
    name = _native.variant("mm_update_gram", "bcg_mm_update_gram", dt)
    for r0, r1 in plan.chunks:
        _native.launch(*name, Bf.device, p(M[r0:r1]), p(Bf),
                       p(None if Af is None else Af[r0:r1]), p(Y[r0:r1]), p(part), p(G),
                       r1 - r0, k, n, plan.kc, _native.nblocks(n))
    if not plan.fused_gram:
        G = wide_gram(Y, Y)
    if donate and Y is not Bf:
        Y = Bf.copy_(Y)
    return Y.view(B.shape), G


def mm2_update_gram(M1: torch.Tensor, B1: torch.Tensor, M2: torch.Tensor,
                    B2: torch.Tensor, *, donate: bool = False):
    """(Y = M1 B1 + M2 B2, G = Y Y^T); ``donate`` writes Y onto B1."""
    M1, M2 = M1.contiguous(), M2.contiguous()
    dst = B1 if donate else None
    dt = _native.field_kernel((B1, B2), (M1, M2))
    if dt is None:
        Y, G = mm2_update_gram_plain(M1, B1, M2, B2)
        return _into(dst, Y), G
    B1f, B2f = _flat("mm2_update_gram", B1, B2)
    k, n = B1f.shape
    for M, what in ((M1, "M1"), (M2, "M2")):
        _native.check_kk(M, k, f"mm2_update_gram {what}")
    p = _native.ptr
    if dt == torch.bfloat16 and k <= UPDATE_GRAM_MMA_MAX_K:  # the tensor cores, one launch
        idx = B1f.device.index
        mma = update_gram_mma_plan(k, n, 2, False, _native.max_smem(idx), _native.sm_count(idx))
        Y = B1f if donate else torch.empty_like(B1f)
        part, G = _gram_buffers(k, n, B1f.device)
        _native.launch("mm2_update_gram[bf16]", "bcg_mm2_update_gram_mma", B1f.device, p(M1),
                       p(B1f), p(M2), p(B2f), p(Y), p(part), p(G), k, n, mma.T, mma.stages,
                       _native.nblocks(n))
        return Y.view(B1.shape), G
    plan = mm2_update_gram_plan(k, B1f.device, B1f.element_size())
    Y = B1f if donate and plan.in_place else torch.empty_like(B1f)
    part, G = _gram_buffers(k, n, B1f.device) if plan.fused_gram else (None, None)
    name = _native.variant("mm2_update_gram", "bcg_mm2_update_gram", dt)
    for r0, r1 in plan.chunks:
        _native.launch(*name, B1f.device, p(M1[r0:r1]),
                       p(B1f), p(M2[r0:r1]), p(B2f), p(Y[r0:r1]), p(part), p(G), r1 - r0, k,
                       n, plan.kc, _native.nblocks(n))
    if not plan.fused_gram:
        G = wide_gram(Y, Y)
    if donate and Y is not B1f:
        Y = B1f.copy_(Y)
    return Y.view(B1.shape), G


def px_update(M1: torch.Tensor, W: torch.Tensor, rho: torch.Tensor,
              P: torch.Tensor, C: torch.Tensor, X: torch.Tensor, *,
              donate: bool = False):
    """(Pn = M1 W + rho P, Xn = X + C P); ``donate`` writes Pn onto P and Xn
    onto X."""
    M1, rho, C = M1.contiguous(), rho.contiguous(), C.contiguous()
    dt = _native.field_kernel((W, P, X), (M1, rho, C))
    if dt is None:
        Pn, Xn = px_update_plain(M1, W, rho, P, C, X)
        if donate:
            return P.copy_(Pn), X.copy_(Xn)
        return Pn, Xn
    shape = W.shape
    W, P, X = _flat("px_update", W, P, X)
    k, n = W.shape
    for M, what in ((M1, "M1"), (rho, "rho"), (C, "C")):
        _native.check_kk(M, k, f"px_update {what}")
    p = _native.ptr
    if dt == torch.bfloat16 and k <= PX_MMA_MAX_K:  # the tensor cores, one launch
        idx = W.device.index
        mma = px_update_mma_plan(k, n, _native.max_smem(idx), _native.sm_count(idx))
        Pn, Xn = (P, X) if donate else (torch.empty_like(P), torch.empty_like(X))
        _native.launch("px_update[bf16]", "bcg_px_update_mma", W.device, p(M1), p(W), p(rho),
                       p(P), p(C), p(X), p(Pn), p(Xn), k, n, mma.T, mma.stages)
        return Pn.view(shape), Xn.view(shape)
    plan = px_update_plan(k, W.device, W.element_size())
    # A chunk reads all of P but only its own rows of X.
    Pn = P if donate and plan.in_place else torch.empty_like(P)
    Xn = X if donate else torch.empty_like(X)
    name = _native.variant("px_update", "bcg_px_update", dt)
    for r0, r1 in plan.chunks:
        _native.launch(*name, W.device, p(M1[r0:r1]), p(W),
                       p(rho[r0:r1]), p(P), p(C[r0:r1]), p(X[r0:r1]), p(Pn[r0:r1]),
                       p(Xn[r0:r1]), r1 - r0, k, n, plan.kc)
    return (P.copy_(Pn) if donate and Pn is not P else Pn).view(shape), Xn.view(shape)


def xr_update_gram(alpha: torch.Tensor, P: torch.Tensor, X: torch.Tensor,
                   Z: torch.Tensor, R: torch.Tensor, *, donate: bool = False):
    """(Xn = X + alpha P, Rn = R - alpha Z, G = Rn Rn^T); ``donate`` writes
    Xn onto X and Rn onto R (P and Z are only read)."""
    alpha = alpha.contiguous()
    dt = _native.field_kernel((P, X, Z, R), (alpha,))
    if dt is None:
        Xn, Rn, G = xr_update_gram_plain(alpha, P, X, Z, R)
        if donate:
            return X.copy_(Xn), R.copy_(Rn), G
        return Xn, Rn, G
    shape = P.shape
    P, X, Z, R = _flat("xr_update_gram", P, X, Z, R)
    k, n = P.shape
    _native.check_kk(alpha, k, "xr_update_gram alpha")
    # A chunk reads its own rows of X and R and all of P and Z, which no
    # chunk writes: in place is safe at every width.
    Xn, Rn = (X, R) if donate else (torch.empty_like(X), torch.empty_like(R))
    plan = xr_update_gram_plan(k, P.device, P.element_size())
    p = _native.ptr
    name = _native.variant("xr_update_gram", "bcg_xr_update_gram", dt)
    diag = []
    for r0, r1 in plan.chunks:
        part, G = _gram_buffers(r1 - r0, n, P.device, plan.grid)
        _native.launch(*name, P.device, p(alpha[r0:r1]),
                       p(P), p(X[r0:r1]), p(Z), p(R[r0:r1]), p(Xn[r0:r1]), p(Rn[r0:r1]),
                       p(part), p(G), r1 - r0, k, n, plan.kc, plan.grid)
        diag.append(G)
    return (Xn.view(shape), Rn.view(shape),
            diag[0] if len(plan.chunks) == 1 else wide_gram(Rn, Rn, diag, plan.chunks))


def qr_p_update(M2: torch.Tensor, Q1: torch.Tensor, rho: torch.Tensor,
                P: torch.Tensor, *, donate: bool = False):
    """(Q = M2 Q1, Pn = Q + rho P); ``donate`` writes Q onto Q1 and Pn onto
    P."""
    M2, rho = M2.contiguous(), rho.contiguous()
    dt = _native.field_kernel((Q1, P), (M2, rho))
    if dt is None:
        Q, Pn = qr_p_update_plain(M2, Q1, rho, P)
        if donate:
            return Q1.copy_(Q), P.copy_(Pn)
        return Q, Pn
    shape = Q1.shape
    Q1, P = _flat("qr_p_update", Q1, P)
    k, n = Q1.shape
    for M, what in ((M2, "M2"), (rho, "rho")):
        _native.check_kk(M, k, f"qr_p_update {what}")
    plan = qr_p_update_plan(k, Q1.device, Q1.element_size())
    # Every chunk reads all of Q1 and P: donated outputs wait for the last.
    direct = donate and plan.in_place
    Q, Pn = (Q1, P) if direct else (torch.empty_like(Q1), torch.empty_like(P))
    p = _native.ptr
    name = _native.variant("qr_p_update", "bcg_qr_p_update", dt)
    for r0, r1 in plan.chunks:
        _native.launch(*name, Q1.device, p(M2[r0:r1]), p(Q1),
                       p(rho[r0:r1]), p(P), p(Q[r0:r1]), p(Pn[r0:r1]), r1 - r0, k, n,
                       plan.kc)
    if donate and not direct:
        Q, Pn = Q1.copy_(Q), P.copy_(Pn)
    return Q.view(shape), Pn.view(shape)


def qr_px_update(M2: torch.Tensor, Q1: torch.Tensor, rho: torch.Tensor,
                 P: torch.Tensor, C: torch.Tensor, X: torch.Tensor, *,
                 donate: bool = False):
    """(Q = M2 Q1, Pn = Q + rho P, Xn = X + C P) in one pass: one read of P
    feeds both updates. ``donate`` writes Q onto Q1, Pn onto P and Xn onto
    X. No solver calls it (in the reference neither)."""
    M2, rho, C = M2.contiguous(), rho.contiguous(), C.contiguous()
    dt = _native.field_kernel((Q1, P, X), (M2, rho, C))
    if dt is None:
        Q, Pn, Xn = qr_px_update_plain(M2, Q1, rho, P, C, X)
        if donate:
            return Q1.copy_(Q), P.copy_(Pn), X.copy_(Xn)
        return Q, Pn, Xn
    shape = Q1.shape
    Q1, P, X = _flat("qr_px_update", Q1, P, X)
    k, n = Q1.shape
    for M, what in ((M2, "M2"), (rho, "rho"), (C, "C")):
        _native.check_kk(M, k, f"qr_px_update {what}")
    p = _native.ptr
    if dt == torch.bfloat16 and k <= PX_MMA_MAX_K:  # the tensor cores, one launch
        idx = Q1.device.index
        mma = px_update_mma_plan(k, n, _native.max_smem(idx), _native.sm_count(idx))
        Q, Pn, Xn = (Q1, P, X) if donate else (torch.empty_like(F) for F in (Q1, P, X))
        _native.launch("qr_px_update[bf16]", "bcg_qr_px_update_mma", Q1.device, p(M2), p(Q1),
                       p(rho), p(P), p(C), p(X), p(Q), p(Pn), p(Xn), k, n, mma.T, mma.stages)
        return Q.view(shape), Pn.view(shape), Xn.view(shape)
    plan = qr_px_update_plan(k, Q1.device, Q1.element_size())
    # Every chunk reads all of Q1 and P; Xn only reads its own rows of X.
    direct = donate and plan.in_place
    Q, Pn = (Q1, P) if direct else (torch.empty_like(Q1), torch.empty_like(P))
    Xn = X if donate else torch.empty_like(X)
    name = _native.variant("qr_px_update", "bcg_qr_px_update", dt)
    for r0, r1 in plan.chunks:
        _native.launch(*name, Q1.device, p(M2[r0:r1]), p(Q1), p(rho[r0:r1]), p(P),
                       p(C[r0:r1]), p(X[r0:r1]), p(Q[r0:r1]), p(Pn[r0:r1]), p(Xn[r0:r1]),
                       r1 - r0, k, n, plan.kc)
    if donate and not direct:
        Q, Pn = Q1.copy_(Q), P.copy_(Pn)
    return Q.view(shape), Pn.view(shape), Xn.view(shape)


def cheb_step(R: torch.Tensor, Z: torch.Tensor, D: torch.Tensor, AZ: torch.Tensor,
              c1: float, c2: float, *, donate: bool = False):
    """One Chebyshev semi-iteration step on four fields of one shape, any
    contiguous layout: returns ``(Z' = Z + D', D' = c1 D + c2 (R - AZ))``.
    ``c1`` and ``c2`` are host scalars (float32 on the kernel route).
    ``donate`` writes Z' onto Z and D' onto D, which must not share storage."""
    if donate and Z.data_ptr() == D.data_ptr():
        raise ValueError("cheb_step: donated Z and D share storage")
    if not (R.shape == Z.shape == D.shape == AZ.shape):
        raise ValueError(f"cheb_step: fields of shapes {[tuple(F.shape) for F in (R, Z, D, AZ)]}")
    if not _native.f32_kernel(R, Z, D, AZ):
        Zn, Dn = cheb_step_plain(R, Z, D, AZ, c1, c2)
        if donate:
            return Z.copy_(Zn), D.copy_(Dn)
        return Zn, Dn
    Zo, Do = (Z, D) if donate else (torch.empty_like(Z), torch.empty_like(D))
    p = _native.ptr
    _native.launch("cheb_step", "bcg_cheb_step", R.device, p(R), p(Z), p(D), p(AZ),
                   p(Zo), p(Do), float(c1), float(c2), R.numel())
    return Zo, Do
