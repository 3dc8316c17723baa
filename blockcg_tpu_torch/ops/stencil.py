"""Toroidal DIA SpMM on lanes-major fields, with an optional fused Gram.

Counterpart of ``blockcg_tpu/ops/stencil.py`` and
``blockcg_tpu/ops/stencil_ring.py``: one CUDA kernel (``csrc/stencil.cu``)
serves both contracts, since the TPU's windowed and ring schedules are not
part of them. Semantics are toroidal, ``Yt[:, i] = sum_d diags[d, i] *
Xt[:, (i + offsets[d]) mod n]``; Dirichlet builders zero every wrap-crossing
coefficient, which makes this the truncated apply.

Dispatch follows ``ops/_native.py`` (``pair_kernel``): CPU and CUDA float64
tensors run the plain roll-and-accumulate below; on CUDA the diagonals and
the field are each float32 or bfloat16, as the reference's gate takes them
(``DIAOperator._pallas_ok``), and each pair launches its variant: f32/f32
the kernel, bf16/bf16 ``[bf16]``, bf16 diagonals with an f32 field ``[bf16
coeffs]``, f32 diagonals with a bf16 field ``[bf16 field]``. Every variant
lifts its bf16 operands to f32 exactly and sums in f32 (the reference's
kernel sums in f32 whenever its output is bf16, and in f32 anyway on an f32
field, ``blockcg_tpu/ops/stencil.py`` ``_kernel``); Y is stored in the
field's dtype, and the fused Gram is taken on the unrounded f32 sums, as
the reference's Pallas kernel takes it. The kernel writes Y to a fresh
buffer, never onto X. The rows of a field are independent right-hand sides,
so a field wider than one launch (64 rows) runs as one launch per chunk of
rows. On an f32 field the fused Gram's cross blocks then come from
``fused.gram`` on X and the stored Y (its f32 sums). A bf16 Y has lost
them, so on a bf16 field each chunk's launch takes the whole column block
of G its rows give, ``G[:, r0:r1] = X Y_f32[r0:r1]^T``, from the sums it
has just computed (``wide_gram_launches``; no f32 copy of X or of the sums
is written); those launches count as ``[bf16, wide]`` (``[bf16 field,
wide]``).

Each launch stages a window of X in shared memory and serves the diagonals
near the tile from it (``csrc/stencil.cu``); ``stencil_plan`` picks the
window's halo and the tile width on the host from the offsets, the launch's
rows and the card's shared-memory cap. A bf16 field's launch with the Gram
runs the tensor-core kernel, which also stages the far diagonals' X and
takes the Gram of the f32 sums in three exact bf16 pieces
(``stencil_mma_plan``; with ``gram_rows`` the column-block launches of a
wider field). An f32 field's launch with the Gram, whatever its diagonals'
element, runs the f32 tensor-core kernel up to 32 rows: X and the sums each
in three exact bf16 pieces, the far diagonals read from L2 a step ahead
(``stencil_mma_f32_plan``); from 33 to 64 rows the window kernel with its
Gram in f32 register tiles that go into double sums every few tiles
(``stencil_vec_gram_plan``). Either way its Y is the SpMM's, bit for bit.
A launch without the Gram, on any pair, runs the ring of planes
(``stencil_ring``, the reference's ``stencil_ring.py`` schedule cut to fit
an SM: each offset o = m S + r for a stride S dividing n, a work item
walking the planes of a patch of columns with the planes it reads in shared
memory, each copied once by TMA) where ``stencil_ring_plan`` finds a stride
and its traffic is below the window's (``launch_plans``), else the window
kernel; an f32 field's slots hold half the rows a bf16 field's do.
``_native.functions`` counts the launches by route.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.solvers.common import acc_dtype, gram_t

MAX_DIAGS = 32  # csrc/stencil.cu kMaxDiags
THREADS = 256  # csrc/stencil.cu kStThreads: one column a thread
TILES = (128, 256)  # tile widths: at most one column a thread


class StencilPlan(NamedTuple):
    """One launch's schedule (``csrc/stencil.cu``): halo ``h`` (a multiple of
    4) and tile width ``T`` (128 or 256) of the shared-memory window, which
    diagonals read it (``near``), the launch's shared bytes, the L2->SM
    traffic per column in units of X, ``(T + 2h) / T`` plus one per far
    diagonal, and the blocks an SM takes."""
    h: int
    T: int
    near: tuple[bool, ...]
    smem_bytes: int
    traffic: float
    blocks_per_sm: int


def smem_bytes(k: int, ndiag: int, h: int, T: int, esize: int = 4,
               dsize: int | None = None) -> int:
    """Shared bytes of a launch (``csrc/stencil.cu`` smem_bytes): two
    windows of k rows and T + 2h columns (+4 at k <= 32 on floats) of
    ``esize``-byte elements and two (ndiag, T) coefficient tiles of
    ``dsize``-byte ones (``esize`` by default)."""
    dsize = esize if dsize is None else dsize
    W = T + 2 * h + (4 if esize == 4 and k <= 32 else 0)
    return 2 * (esize * k * W + dsize * ndiag * T)


# An f32 field's Gram at 33 to 64 rows a launch, on f32 or bf16 diagonals
# (csrc/stencil.cu stencil_vec_gram): the window kernel with its Gram in
# VecGram<64> register tiles, one block an SM, the tiles' f32 sums added into
# doubles every VEC_GRAM_FLUSH tiles.
VEC_GRAM_ROWS = (33, 64)
VEC_GRAM_FLUSH = 4  # csrc/stencil.cu kVecGramFlush
VEC_GRAM_SCRATCH = 4 * 64 * 64  # csrc/common.cuh VecGram<64, 256>::kScratch, floats


def vec_gram_smem_bytes(k: int, ndiag: int, h: int, T: int, dsize: int = 4) -> int:
    """Shared bytes of a ``stencil_vec_gram`` launch (``csrc/stencil.cu``
    vec_gram_smem_bytes): ``smem_bytes`` of its f32 windows and coefficient
    tiles, then the float (k, T + 4) tile of Y, at least the four VecGram
    copies' tiles that each flush stages there."""
    return smem_bytes(k, ndiag, h, T, 4, dsize) + 4 * max(k * (T + 4), VEC_GRAM_SCRATCH)


def vec_gram_takes(k: int) -> bool:
    """Whether an f32 field's Gram launch of k rows runs
    ``stencil_vec_gram`` (else ``stencil_mma_f32``)."""
    return VEC_GRAM_ROWS[0] <= k <= VEC_GRAM_ROWS[1]


@functools.lru_cache(maxsize=256)
def stencil_vec_gram_plan(offsets: tuple[int, ...], n: int, k: int, smem_cap: int,
                          sm_count: int, dsize: int = 4) -> StencilPlan:
    """The (h, T) of an f32 field's Gram launch of 33 to 64 rows
    (``csrc/stencil.cu`` stencil_vec_gram): ``stencil_plan``'s search at
    one block an SM on ``vec_gram_smem_bytes``. At config 5's (64, 256^3)
    that is h = 4, T = 256: 0 and +-1 from the window, +-256 and +-65,536
    from L2."""
    if not vec_gram_takes(k):
        raise ValueError(f"stencil: the Gram form takes {VEC_GRAM_ROWS[0]} to "
                         f"{VEC_GRAM_ROWS[1]} rows, got {k}")
    return _window_plan(offsets, n, k, smem_cap, sm_count, 4, 1,
                        lambda h, T: vec_gram_smem_bytes(k, len(offsets), h, T, dsize))


@functools.lru_cache(maxsize=256)
def stencil_plan(offsets: tuple[int, ...], n: int, k: int, smem_cap: int, sm_count: int,
                 esize: int = 4, dsize: int | None = None) -> StencilPlan:
    """The (h, T) for a launch of k rows on n columns without the Gram
    (``csrc/stencil.cu`` stencil_spmm) that
    minimises the L2->SM traffic per busy thread, ``traffic / (blocks_per_sm * T / 256)``,
    among those whose shared memory fits ``smem_cap``; ties go to the wider
    tile, then the smaller halo. A diagonal is near when its offset mod n
    lies within h of 0 or of n, the rule the kernel applies. Blocks an SM:
    as many as the SM's shared memory holds (the per-block cap plus the 1 KB
    the SM reserves for each block), at most the two the SpMM is built for
    up to 32 rows, one above (csrc/stencil.cu kStBlocksPerSm). T is 128 where n / sm_count < 256, so a small field
    still spreads over the card. ``esize``: bytes of an element of X (2 on
    bf16, whose halos are multiples of 8: a 16-byte copy carries 8
    elements); ``dsize``: of the diagonals (``esize`` by default)."""
    return _window_plan(offsets, n, k, smem_cap, sm_count, esize, 2 if k <= 32 else 1,
                        lambda h, T: smem_bytes(k, len(offsets), h, T, esize, dsize))


def _window_plan(offsets, n, k, smem_cap, sm_count, esize, built, nbytes_of) -> StencilPlan:
    """``stencil_plan``'s search over (h, T) for a window kernel built for
    ``built`` blocks an SM whose launch takes ``nbytes_of(h, T)`` shared
    bytes."""
    offs = [int(o) % n for o in offsets]
    dist = [min(o, n - o) for o in offs]
    quantum = 16 // esize
    best, best_key = None, None
    for T in TILES:
        if T > max(TILES[0], n // sm_count):
            continue
        for h in sorted({0} | {-(-d // quantum) * quantum for d in dist}):
            nbytes = nbytes_of(h, T)
            if nbytes > smem_cap:
                break
            blocks = min(built, (smem_cap + 1024) // (nbytes + 1024))
            traffic = (T + 2 * h) / T + sum(d > h for d in dist)
            key = (traffic / (blocks * T / THREADS), -T, h)
            if best_key is None or key < best_key:
                best_key = key
                best = StencilPlan(h, T, tuple(d <= h for d in dist), nbytes, traffic, blocks)
    if best is None:
        raise ValueError(f"stencil: {k} rows leave no tile in {smem_cap} bytes of "
                         "shared memory")
    return best


# The bf16 field with its Gram on the tensor cores (csrc/stencil.cu
# stencil_mma): one 16-warp block an SM.
MMA_TILES = (128, 256, 512, 768, 1024)  # tile widths it takes: 16-column steps of its warps
MMA_SCRATCH = 9216  # csrc/stencil.cu kStMmaScratch: floats of the warps' sums
MMA_MAX_K = 64  # rows of one launch
MMA_MAX_STAGED = 4  # csrc/stencil.cu kStMaxStaged: far diagonals a tile stages
MMA_STATIC_BYTES = 4 * (4 * MAX_DIAGS + 1) + 16  # its static shared memory: Diags, 2 mbarriers


def mma_window_ld(h: int, T: int) -> int:
    """Row stride of stencil_mma's window (``csrc/stencil.cu``
    mma_window_ld): the least L >= T + 2h with L = 16 mod 64 elements, so
    consecutive rows start 32 bytes apart modulo 128 and the 4 rows of a
    half warp's 8-byte reads touch 128 distinct bytes."""
    return T + 2 * h + ((16 - T - 2 * h) & 63)


def mma_tile_ld(T: int) -> int:
    """The same for the tile of Y (``mma_tile_ld``)."""
    return T + ((16 - T) & 63)


def mma_smem_bytes(k: int, ndiag: int, nst: int, h: int, T: int, dsize: int = 2) -> int:
    """Shared bytes of one stencil_mma launch (``csrc/stencil.cu``
    mma_smem_bytes): two stages, each ``nst`` far slabs of k rows in
    swizzled boxes of ``round8(k)`` rows, the bf16 window of k rows at
    ``mma_window_ld`` and the (ndiag, T) coefficient tile of
    ``dsize``-byte elements, rounded up to 1 KB; the bf16 tile of Y; at
    least the warps' sums; and 1 KB to align the boxes."""
    r8 = -(-k // 8) * 8
    stage = 2 * nst * T * r8 + 2 * k * mma_window_ld(h, T) + dsize * ndiag * T
    stage = -(-stage // 1024) * 1024
    return max(2 * stage + 2 * k * mma_tile_ld(T), 4 * MMA_SCRATCH) + 1024


MMA_COLS_FW = 4  # csrc/stencil.cu kStColsFw: m-tiles of 16 rows of X a warp's Gram holds


def mma_cols_gram_rows(k: int) -> int:
    """Rows of X a column-block launch of k rows takes in its Gram
    (``csrc/stencil.cu`` stencil_mma_cols): ``MMA_COLS_FW`` m-tiles of 16
    for each of the 16 // ceil(k / 8) warps of a column tile of 8 rows."""
    return 16 * MMA_COLS_FW * (16 // -(-k // 8))


def mma_sums_ld(T: int) -> int:
    """Row stride of stencil_mma_cols's f32 tile of Y's sums (``csrc/stencil.cu``
    mma_sums_ld): the least L >= T with L = 16 mod 32 floats."""
    return T + ((16 - T) & 31)


def mma_cols_smem_bytes(k: int, ndiag: int, nst: int, h: int, T: int, others: int,
                        dsize: int = 2) -> int:
    """Shared bytes of one stencil_mma_cols launch of k rows whose Gram also
    takes ``others`` rows of X (``csrc/stencil.cu`` mma_cols_smem_bytes):
    two stages of stencil_mma's far slabs, window and coefficients (not
    rounded to 1 KB: they are laid out by kind), the f32 tile of the sums,
    the centre copy of the others' X, and 1 KB to align the boxes."""
    r8 = -(-k // 8) * 8
    stage = 2 * nst * T * r8 + 2 * k * mma_window_ld(h, T) + dsize * ndiag * T
    return 2 * stage + 4 * k * mma_sums_ld(T) + 2 * others * mma_tile_ld(T) + 1024


@functools.lru_cache(maxsize=256)
def stencil_mma_plan(offsets: tuple[int, ...], n: int, k: int, smem_cap: int,
                     sm_count: int, dsize: int = 2, gram_rows: int | None = None,
                     own: bool = True) -> StencilPlan:
    """The (h, T) of a bf16 launch of k <= 64 rows with the fused Gram
    (``csrc/stencil.cu`` stencil_mma, one block an SM, every warp busy at
    any tile): the least L2->SM traffic per column, ``(T + 2h) / T`` plus
    one per far diagonal (staged in shared memory, up to
    ``MMA_MAX_STAGED``, or read from L2), among the tiles of ``MMA_TILES``
    up to ``max(128, n / sm_count)`` and the halos (multiples of 8: the
    window is copied in 16-byte chunks) whose shared memory, with its static
    ``MMA_STATIC_BYTES``, fits ``smem_cap``; ties go to the wider tile, then
    the smaller halo. At config 5's (32, 256^3) that is h = 256, T = 256:
    +-1 and +-256 from the window, +-65,536 from two staged slabs, traffic
    5.0. ``dsize``: bytes of a diagonal's element. ``gram_rows``: the rows of
    X a column-block launch's Gram takes (``stencil_mma_cols``, a bf16 field
    above 64 rows), its own k among them when ``own``; the centre of the
    others is staged beside the stages (at (96, 128^3) in two launches of
    48 rows: h = 128, T = 128)."""
    if not 1 <= k <= MMA_MAX_K:
        raise ValueError(f"stencil: one bf16 Gram launch takes 1 to {MMA_MAX_K} rows, got {k}")
    if gram_rows is not None and gram_rows > mma_cols_gram_rows(k):
        raise ValueError(f"stencil: a launch of {k} rows takes a Gram of at most "
                         f"{mma_cols_gram_rows(k)} rows, got {gram_rows}")
    offs = [int(o) % n for o in offsets]
    dist = [min(o, n - o) for o in offs]
    best, best_key = None, None
    for T in MMA_TILES:
        if T > max(MMA_TILES[0], n // sm_count):
            continue
        for h in sorted({0} | {-(-d // 8) * 8 for d in dist}):
            nfar = sum(d > h for d in dist)
            nst = min(nfar, MMA_MAX_STAGED)
            nbytes = (mma_smem_bytes(k, len(offs), nst, h, T, dsize) if gram_rows is None else
                      mma_cols_smem_bytes(k, len(offs), nst, h, T,
                                          gram_rows - (k if own else 0), dsize))
            if nbytes + MMA_STATIC_BYTES > smem_cap:
                continue
            traffic = (T + 2 * h) / T + nfar
            key = (traffic, -T, h)
            if best_key is None or key < best_key:
                best_key = key
                best = StencilPlan(h, T, tuple(d <= h for d in dist), nbytes, traffic, 1)
    if best is None:
        raise ValueError(f"stencil: {k} rows leave no bf16 tile in {smem_cap} bytes of "
                         "shared memory")
    return best

# An f32 field with its Gram on the tensor cores (csrc/stencil.cu
# stencil_mma_f32): stencil_mma's 16 warps on an f32 window, the far
# diagonals read from L2.
MMA_F32_PREFETCH = 2  # csrc/stencil.cu kStF32Prefetch: far diagonals loaded a step ahead
MMA_F32_MAX_K = 32  # csrc/stencil.cu kStMmaF32MaxK: rows of one launch (33-64: stencil_vec_gram)
# Tile widths of its plan: at (32, 128^3) T = 512 (1.5 reads of X a column)
# ran slower than T = 256 (2.0): 475 against 452 device us (H100, PERF.md).
MMA_F32_TILES = (128, 256)
def mma_f32_window_ld(h: int, T: int) -> int:
    """Row stride of stencil_mma_f32's f32 window (``csrc/stencil.cu``
    mma_f32_window_ld): the least L >= T + 2h with L = 16 mod 32 floats, so
    the two rows of a quarter warp's 16-byte reads fall in the two halves of
    the banks."""
    return T + 2 * h + ((16 - T - 2 * h) & 31)


def mma_f32_smem_bytes(k: int, ndiag: int, h: int, T: int, dsize: int = 4) -> int:
    """Shared bytes of one stencil_mma_f32 launch (``csrc/stencil.cu``
    mma_f32_smem_bytes): two f32 windows of k rows at ``mma_f32_window_ld``
    and two (ndiag, T) coefficient tiles of ``dsize``-byte elements, at
    least the warps' sums."""
    return max(2 * (4 * k * mma_f32_window_ld(h, T) + dsize * ndiag * T), 4 * MMA_SCRATCH)


@functools.lru_cache(maxsize=256)
def stencil_mma_f32_plan(offsets: tuple[int, ...], n: int, k: int, smem_cap: int,
                         sm_count: int, dsize: int = 4) -> StencilPlan:
    """The (h, T) of an f32 launch of k <= 32 rows with the fused Gram
    (``csrc/stencil.cu`` stencil_mma_f32, one 16-warp block an SM; f32 or
    bf16 diagonals, ``dsize`` bytes an element): the least L2->SM traffic
    per column, ``(T + 2h) / T`` plus one per far diagonal (read from L2),
    among the tiles of ``MMA_F32_TILES`` up to ``max(128, n / sm_count)`` and
    the halos (multiples of 4: the window is copied in 16-byte chunks) whose
    shared memory, with the static ``MMA_STATIC_BYTES``, fits ``smem_cap``;
    ties go to the wider tile, then the smaller halo. At the north star's
    (32, 128^3) that is h = 128, T = 256: 0, +-1 and +-128 from the window,
    +-16384 from L2, traffic 4.0."""
    if not 1 <= k <= MMA_F32_MAX_K:
        raise ValueError(f"stencil: one f32 Gram launch takes 1 to {MMA_F32_MAX_K} rows, "
                         f"got {k}")
    offs = [int(o) % n for o in offsets]
    dist = [min(o, n - o) for o in offs]
    best, best_key = None, None
    for T in MMA_F32_TILES:
        if T > max(MMA_F32_TILES[0], n // sm_count):
            continue
        for h in sorted({0} | {-(-d // 4) * 4 for d in dist}):
            nbytes = mma_f32_smem_bytes(k, len(offs), h, T, dsize)
            if nbytes + MMA_STATIC_BYTES > smem_cap:
                break
            traffic = (T + 2 * h) / T + sum(d > h for d in dist)
            key = (traffic, -T, h)
            if best_key is None or key < best_key:
                best_key = key
                best = StencilPlan(h, T, tuple(d <= h for d in dist), nbytes, traffic, 1)
    if best is None:
        raise ValueError(f"stencil: {k} rows leave no f32 tile in {smem_cap} bytes of "
                         "shared memory")
    return best


# The stencil without the Gram on a ring of planes (csrc/stencil.cu
# stencil_ring): one block an SM, 8 consumer warps of 4 columns a thread and
# one producer warp.
RING_COLS = 1024  # csrc/stencil.cu kRingCols: P, the columns of a patch
# Rows of a work item, the consumers' register tile, by the bytes of the
# field's element: a slot of f32 rows holds half as many.
RING_ROWS = {2: (8, 16), 4: (4, 8)}
RING_MAX_SLOTS = 8  # kRingMaxSlots: 2M + 2
RING_BOX = 256  # the largest dimension of a TMA box
RING_STATIC_BYTES = 4 * 8  # its static shared memory: four mbarriers


class RingPlan(NamedTuple):
    """One ring launch (``csrc/stencil.cu`` stencil_ring): the stride ``S``
    (planes of S columns), the halo ``h``, the reach ``M`` (each offset o =
    m S + r with |r| <= h, |m| <= M), the ``rows`` of a work item, the ring's
    ``slots`` (2M + 2), the ``segs`` runs a patch's planes are cut into, of
    ``len`` planes, the work ``items`` and the ``grid``, the boxes' ``granule``
    (columns), the launch's shared bytes and the L2->SM traffic per column in
    units of X: the slots' ``(P + 2h) / P``, times ``(len + 2M) / len`` for
    the ring's first fill of an item, plus the diagonals' reads past the
    first (once a row group) in units of X's bytes."""
    S: int
    h: int
    M: int
    rows: int
    slots: int
    segs: int
    len: int
    items: int
    grid: int
    granule: int
    smem_bytes: int
    traffic: float

    def describe(self) -> str:
        return (f"ring S={self.S} h={self.h} P={RING_COLS} M={self.M} rows={self.rows} "
                f"depth={self.slots} planes={self.len} items={self.items} grid={self.grid} "
                f"smem={self.smem_bytes} traffic={self.traffic:.4g}")


def ring_decompose(offsets, n: int, S: int) -> list[tuple[int, int]]:
    """``[(m, r), ...]``: each offset o (mod n) as ``m S + r``, the rule of
    ``csrc/stencil.cu`` make_ring: o taken signed in (-n/2, n/2], m its
    nearest multiple of S (halves away from 0)."""
    out = []
    for o in offsets:
        o = int(o) % n
        so = o if o <= n // 2 else o - n
        m = (so + S // 2) // S if so >= 0 else -((-so + S // 2) // S)
        out.append((m, so - m * S))
    return out


def ring_smem_bytes(rows: int, h: int, slots: int, ndiag: int, dsize: int,
                    esize: int = 2) -> int:
    """Shared bytes of a ring launch (``csrc/stencil.cu`` ring_smem_bytes):
    ``slots`` slots of ``rows`` rows of P + 2h ``esize``-byte elements of the
    field and two (ndiag, P) coefficient buffers of ``dsize``-byte elements
    (each rounded up to 128 bytes), 128 bytes to align the boxes and 128
    past the last buffer."""
    def r128(b):
        return -(-b // 128) * 128
    return (slots * r128(esize * rows * (RING_COLS + 2 * h))
            + 2 * r128(dsize * ndiag * RING_COLS) + 256)


@functools.lru_cache(maxsize=256)
def stencil_ring_plan(offsets: tuple[int, ...], n: int, k: int, smem_cap: int, sm_count: int,
                      dsize: int = 2, esize: int = 2) -> RingPlan | None:
    """The ring launch of a field of k <= 64 rows without the Gram
    (``csrc/stencil.cu`` stencil_ring), or None where no stride fits. The
    strides tried are the offsets' distances S that P divides and that
    divide n; each takes the offsets whose decomposition (``ring_decompose``)
    leaves |m| <= 3 (a ring of at most 8 slots), some m != 0 and a halo h
    (the largest |r| rounded up to 8) with 2h < S and P + 2h at most 256
    boxes' granules (the largest power of two up to 256 dividing h). For
    each that fits ``smem_cap`` with its static bytes, and each row tile of
    ``RING_ROWS[esize]`` (the narrower alone where k fits it), the planes of
    a patch are cut into the runs that minimise the modelled bytes a block
    copies, waves x (len + 2M slot fills + len coefficient buffers), the
    grid one block an SM; the least of those wins, ties to fewer runs and
    the narrower row tile. On a bf16 field at (32, 256^3) on bf16
    diagonals: S = 65,536, h = 256, M = 1, 16 rows, one run of 256 planes
    for each of 128 items (traffic 1.5 X and the diagonals once more); at
    (32, 128^3): S = 16,384, h = 128, 16 rows, four runs of 32 planes (128
    items). An f32 field (``esize`` 4) takes 4 or 8 rows: 8 at (32, 128^3)
    and (32, 256^3) on bf16 diagonals, in 189 and 220 KB. ``dsize``,
    ``esize``: bytes of a diagonal's and of the field's element."""
    if not 1 <= k <= 64 or n % RING_COLS or n >= 2 ** 31:
        return None
    offs = [int(o) % n for o in offsets]
    ndiag = len(offs)
    best, best_key = None, None
    for S in sorted({min(o, n - o) for o in offs}):
        if S < RING_COLS or S % RING_COLS or n % S or n // S < 2:
            continue
        dec = ring_decompose(offs, n, S)
        M = max(abs(m) for m, _ in dec)
        h = -(-max(abs(r) for _, r in dec) // 8) * 8
        g = RING_BOX
        while h % g:
            g //= 2
        slots = 2 * M + 2
        if (not 1 <= M or slots > RING_MAX_SLOTS or 2 * h >= S
                or (RING_COLS + 2 * h) // g > RING_BOX):
            continue
        npl, npatch = n // S, S // RING_COLS
        narrow = RING_ROWS[esize][0]
        for rows in RING_ROWS[esize]:
            if rows > narrow and k <= narrow:
                continue
            nbytes = ring_smem_bytes(rows, h, slots, ndiag, dsize, esize)
            if nbytes + RING_STATIC_BYTES > smem_cap:
                continue
            ngrp = -(-k // rows)
            slot = esize * rows * (RING_COLS + 2 * h)
            coef = dsize * ndiag * RING_COLS
            for segs in range(1, npl + 1):
                ln = -(-npl // segs)
                if -(-npl // ln) != segs:
                    continue  # the same runs as fewer segs
                items = npatch * ngrp * segs
                waves = -(-items // sm_count)
                cost = waves * ((ln + 2 * M) * slot + ln * coef)
                key = (cost, segs, rows)
                if best_key is None or key < best_key:
                    traffic = ((RING_COLS + 2 * h) / RING_COLS * (ln + 2 * M) / ln
                               + ndiag * dsize * (ngrp - 1) / (esize * k))
                    best_key = key
                    best = RingPlan(S, h, M, rows, slots, segs, ln, items,
                                    min(items, sm_count), g, nbytes, traffic)
    return best


def stencil_spmm_plain(diags: torch.Tensor, offsets: tuple[int, ...],
                       Xt: torch.Tensor, with_gram: bool = False):
    """Plain PyTorch version: the roll-and-accumulate of the reference's XLA
    path (``DIAOperator._matmat_t_xla``). Returns ``(Yt, G or None)`` with
    ``G = X Y^T`` taken on the accumulator, as the Pallas kernel does: on
    bf16 fields the f32 sums, before Y is rounded to bf16."""
    adt = acc_dtype(Xt.dtype)
    acc = torch.zeros(Xt.shape, dtype=adt, device=Xt.device)
    for d, o in enumerate(offsets):
        src = Xt if o == 0 else torch.roll(Xt, -o, dims=1)
        acc.addcmul_(diags[d].to(adt)[None, :], src.to(adt))
    G = gram_t(Xt, acc) if with_gram else None
    return acc.to(Xt.dtype), G


# The (field, diagonals) dtype pairs the kernel takes on CUDA: the
# reference's gate takes float32 or bfloat16 for each.
PAIRS = tuple(_native.PAIR_VARIANTS)


def wide_gram_launches(k: int) -> list[tuple[int, int, int, int]]:
    """The launches of a bf16 field's Gram above one launch's 64 rows, ``(r0,
    r1, a0, a1)``: Y's rows r0:r1 (``_native.row_chunks``) and the block
    ``G[a0:a1, r0:r1]``. The Gram's rows a0:a1 are runs of whole chunks of
    at most ``mma_cols_gram_rows`` of the widest chunk: all k rows up to 128
    beside chunks of 41 to 64 rows (two launches at k = 96 and at 128).
    Every entry of G is one launch's, and each chunk lies in one run of Gram
    rows, the launch that stores its Y."""
    chunks = _native.row_chunks(k)
    cap = mma_cols_gram_rows(max(r1 - r0 for r0, r1 in chunks))
    runs: list[list[int]] = []
    for r0, r1 in chunks:
        if not runs or r1 - runs[-1][0] > cap:
            runs.append([r0, r1])
        runs[-1][1] = r1
    return [(r0, r1, a0, a1) for r0, r1 in chunks for a0, a1 in runs]


def _launch_wide_mma(diags, offsets, Xt, label: str, fn: str):
    """(Y, G) of a bf16 field above one launch's 64 rows on the tensor cores
    (``csrc/stencil.cu`` stencil_mma_cols): one launch per (chunk, run of
    Gram rows) of ``wide_gram_launches``, each writing its block of G; the
    launch whose run holds its chunk stores that chunk's Y."""
    ndiag, n = diags.shape
    k = Xt.shape[0]
    offs = (ctypes.c_int * ndiag)(*(o % n for o in offsets))
    cap, sms = _native.max_smem(Xt.device.index), _native.sm_count(Xt.device.index)
    Y = torch.empty_like(Xt)
    G = torch.empty((k, k), dtype=torch.float32, device=Xt.device)
    p = _native.ptr
    for r0, r1, a0, a1 in wide_gram_launches(k):
        own = r0 - a0 if a0 <= r0 < a1 else -1
        plan = stencil_mma_plan(offsets, n, r1 - r0, cap, sms, diags.element_size(), a1 - a0,
                                own >= 0)
        max_blocks = min(-(-n // plan.T), _native.MAX_BLOCKS)
        part = torch.empty((max_blocks, a1 - a0, r1 - r0), dtype=torch.float32,
                           device=Xt.device)
        Gb = torch.empty((a1 - a0, r1 - r0), dtype=torch.float32, device=Xt.device)
        _native.launch(label, fn, Xt.device, p(diags), offs, ndiag, p(Xt[r0:r1]), p(Xt[a0:a1]),
                       p(Y[r0:r1]) if own >= 0 else None, p(part), p(Gb), r1 - r0, a1 - a0,
                       own, n, plan.h, plan.T, max_blocks)
        G[a0:a1, r0:r1] = Gb
    return Y, G


def _ring_ok(diags, Xt) -> bool:
    """Whether a launch's operands suit the ring's TMA boxes: rows on
    16-byte boundaries (n % 8 == 0; ``stencil_ring_plan`` asks n % 1024 ==
    0) and 16-byte aligned field and diagonals."""
    return (Xt.shape[1] % 8 == 0 and Xt.data_ptr() % 16 == 0
            and diags.data_ptr() % 16 == 0)


def launch_plans(diags, offsets, Xt, with_gram: bool):
    """``[((r0, r1), plan), ...]``: the row chunks a field runs as, one
    launch each (``_native.row_chunks``: chunks of at most 64 rows), and the
    plan of each: a ``RingPlan`` (``stencil_ring``) for
    a launch without the Gram where one fits with less traffic than
    ``stencil_plan``'s and the operands suit it (``_ring_ok``), else a
    ``StencilPlan``: ``stencil_mma_plan`` for a bf16 field's Gram; for an f32
    field's, ``stencil_vec_gram_plan`` where ``vec_gram_takes`` (33 to 64
    rows), else ``stencil_mma_f32_plan``; else ``stencil_plan``. An f32
    field's Gram above one launch takes its cross blocks from ``gram``
    (``fused.wide_gram``); a bf16 field's runs ``wide_gram_launches``
    instead. At (64, 256^3) on the 7-point Laplacian the Gram form took
    11,508-11,525 device us (with its f32 tiles kept for a block's whole
    run) against 12,244-12,324 for two 32-row ``stencil_mma_f32`` launches
    and ``gram``'s cross blocks (H100 80GB HBM3 at 700 W, L2 flushed;
    PERF.md section 6)."""
    n = diags.shape[1]
    offsets = tuple(int(o) for o in offsets)
    cap, sms = _native.max_smem(Xt.device.index), _native.sm_count(Xt.device.index)
    ring_ok = not with_gram and _ring_ok(diags, Xt)
    out = []
    for r0, r1 in _native.row_chunks(Xt.shape[0]):
        kc = r1 - r0
        if with_gram and Xt.dtype == torch.bfloat16:
            plan = stencil_mma_plan(offsets, n, kc, cap, sms, diags.element_size())
        elif with_gram and vec_gram_takes(kc):
            plan = stencil_vec_gram_plan(offsets, n, kc, cap, sms, diags.element_size())
        elif with_gram:
            plan = stencil_mma_f32_plan(offsets, n, kc, cap, sms, diags.element_size())
        else:
            plan = stencil_plan(offsets, n, kc, cap, sms, Xt.element_size(),
                                diags.element_size())
            ring = (stencil_ring_plan(offsets, n, kc, cap, sms, diags.element_size(),
                                      Xt.element_size()) if ring_ok else None)
            if ring is not None and ring.traffic < plan.traffic:
                plan = ring
        out.append(((r0, r1), plan))
    return out


def describe(plan) -> str:
    """One line of a launch's plan (``launch_plans``)."""
    if isinstance(plan, RingPlan):
        return plan.describe()
    return (f"window h={plan.h} T={plan.T} near={sum(plan.near)}/{len(plan.near)} "
            f"smem={plan.smem_bytes} traffic={plan.traffic:.4g} "
            f"blocks/SM={plan.blocks_per_sm}")


def _launch(diags, offsets, Xt, with_gram: bool, name: str, pair):
    from blockcg_tpu_torch.ops import fused

    ndiag, n = diags.shape
    k = Xt.shape[0]
    _native.check_field(Xt, k, n, name)
    if len(offsets) != ndiag or not 1 <= ndiag <= MAX_DIAGS:
        raise ValueError(f"{name}: {len(offsets)} offsets for {ndiag} "
                         f"diagonals (at most {MAX_DIAGS})")
    offsets = tuple(int(o) for o in offsets)
    label, fn = _native.pair_variant(name, "bcg_stencil_spmm", pair)
    if with_gram and Xt.dtype == torch.bfloat16 and k > _native.MAX_K:
        # a bf16 Y has lost the f32 sums the cross blocks need
        return _launch_wide_mma(diags, offsets, Xt, f"{label[:-1]}, wide]",
                                fn.replace("bcg_stencil_spmm", "bcg_stencil_mma_cols"))
    offs = (ctypes.c_int * ndiag)(*(o % n for o in offsets))
    Y = torch.empty_like(Xt)
    p = _native.ptr
    diag = []
    plans = launch_plans(diags, offsets, Xt, with_gram)
    chunks = [rows for rows, _ in plans]
    for (r0, r1), plan in plans:
        kc = r1 - r0
        if isinstance(plan, RingPlan):
            _native.launch(label, fn.replace("bcg_stencil_spmm", "bcg_stencil_ring"), Xt.device,
                           p(diags), offs, ndiag, p(Xt[r0:r1]), p(Y[r0:r1]), kc, n, plan.S,
                           plan.h, plan.M, plan.rows, plan.segs, plan.grid)
            continue
        max_blocks = min(-(-n // plan.T), _native.MAX_BLOCKS)
        part = G = None
        route = fn
        if with_gram:
            G = torch.empty((kc, kc), dtype=torch.float32, device=Xt.device)
            if Xt.dtype != torch.bfloat16 and vec_gram_takes(kc):
                # the window kernel's Gram form: its partials in double
                route = ("bcg_stencil_vec_gram_bf16d" if diags.dtype == torch.bfloat16
                         else "bcg_stencil_vec_gram")
                sms = _native.sm_count(Xt.device.index)
                max_blocks = min(max_blocks, plan.blocks_per_sm * sms)
                part = torch.empty((max_blocks, kc, kc), dtype=torch.float64, device=Xt.device)
            else:
                part = torch.empty((max_blocks, kc, kc), dtype=torch.float32, device=Xt.device)
        _native.launch(label, route, Xt.device, p(diags), offs, ndiag, p(Xt[r0:r1]),
                       p(Y[r0:r1]), p(part), p(G), kc, n, plan.h, plan.T, max_blocks)
        diag.append(G)
    if with_gram and len(chunks) > 1:
        return Y, fused.wide_gram(Xt, Y, diag, chunks)
    return Y, (diag[0] if diag else None)


def stencil_spmm_t(diags: torch.Tensor, offsets: tuple[int, ...],
                   Xt: torch.Tensor) -> torch.Tensor:
    """``Yt[:, i] = sum_d diags[d, i] * Xt[:, (i + offsets[d]) mod n]``;
    diags (ndiag, n), Xt (k, n)."""
    pair = _native.pair_kernel(Xt, diags, PAIRS)
    if pair is None:
        return stencil_spmm_plain(diags, offsets, Xt)[0]
    return _launch(diags, offsets, Xt, False, "stencil_spmm_t", pair)[0]


def stencil_spmm_gram_t(diags: torch.Tensor, offsets: tuple[int, ...],
                        Xt: torch.Tensor):
    """``(Yt, G = X Y^T)``: the SpMM with the solvers' ``P^T A P`` Gram,
    taken on the f32 sums (before a bf16 Y is rounded)."""
    pair = _native.pair_kernel(Xt, diags, PAIRS)
    if pair is None:
        return stencil_spmm_plain(diags, offsets, Xt, with_gram=True)
    return _launch(diags, offsets, Xt, True, "stencil_spmm_gram_t", pair)
