"""General-sparsity SpMM over dense 128 x 128 tiles (``TiledOperator``).

Counterpart of ``blockcg_tpu/ops/spmm_tiled.py``; runs as
``csrc/spmm_tiled.cu``. Contract, for tiles (ntiles, 128, 128) sorted by row
tile, ``rt``, ``ct``, ``first`` int32 (ntiles,) and a lanes-major field
``Xt`` (k, n), n % 128 == 0::

    Y[:, rt*T:(rt+1)*T] = sum_t X[:, ct[t]*T:(ct[t]+1)*T] @ tiles[t]^T

where ``first[t] == 1`` resets the row tile's sum (the tilizer sets it on
each row tile's first tile, and emits at least one tile per row tile).

Dispatch (the tile storage may be narrower than the field, as in the
reference, which upcasts bf16 tiles in VMEM):

- CPU tensors run the plain version below;
- CUDA with float32 X and float32 or bfloat16 tiles launches the kernel;
- CUDA float64 X and tiles run the plain version;
- anything else raises.

The kernel holds at most 128 rows of X per launch; a wider field runs as one
launch per chunk of rows, each reading every tile again. Each launch follows
a host schedule, :func:`tiled_plan`: a persistent grid in which every row
tile is summed by one block, the blocks balanced by tile count (the
operator computes it once per width and keeps it).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from blockcg_tpu_torch.ops import _native

T = 128  # tile side
MAX_K = 128  # csrc/spmm_tiled.cu: rows of X a launch (16 warps of 8 rows)
MAX_THREADS = 512  # csrc/spmm_tiled.cu kMaxThreads
COLS = 4  # csrc/spmm_tiled.cu kCols: output columns a lane owns
# (rows a warp R, slice width J) the kernel is built for (csrc/spmm_tiled.cu
# kernel_for).
BUILT = ((8, 32), (8, 16), (4, 32), (2, 32), (1, 32))


def tiled_spmm_plain(tiles, rt, ct, Xt):
    """Plain version: gather X's column tiles, one batched product with the
    tiles (bf16 storage widened to X's dtype), and a sum over each row tile's
    run of tiles: the reference's ``TiledOperator._matmat_t_xla``, whose
    scatter-add is a sorted segment sum here (``segment_reduce``: in order,
    no atomics, so an apply repeats bitwise). Assumes the tiles sorted by row
    tile, every row tile's sum starting at its first tile, as the tilizer
    emits them."""
    k, n = Xt.shape
    Xb = Xt.reshape(k, n // T, T)
    xg = Xb[:, ct.long(), :].transpose(0, 1)  # (ntiles, k, T)
    contrib = torch.bmm(xg, tiles.to(Xt.dtype).transpose(1, 2))  # (ntiles, k, T)
    per_row = torch.bincount(rt.long(), minlength=n // T)
    Yb = torch.segment_reduce(contrib, "sum", lengths=per_row, axis=0)  # (n // T, k, T)
    return Yb.transpose(0, 1).reshape(k, n)


def row_pointers(rt: torch.Tensor, nrt: int) -> torch.Tensor:
    """(nrt + 1,) int32: the first tile of each row tile in the sorted ``rt``
    (and ntiles at the end), computed on rt's device."""
    bounds = torch.arange(nrt + 1, dtype=rt.dtype, device=rt.device)
    return torch.searchsorted(rt, bounds, out_int32=True)


def stage_bytes(J: int, kp: int, tile_bytes: int) -> int:
    """Bytes of one ring stage (``csrc/spmm_tiled.cu`` stage_bytes): the (128,
    J) slice of A at a row pitch of J plus one 16-byte chunk, and the (kp, J)
    slice of X."""
    return T * (J + 16 // tile_bytes) * tile_bytes + kp * J * 4


class TiledPlan(NamedTuple):
    """The launch of ``tiled_spmm_t`` on k rows (:func:`tiled_plan`): the
    slice width ``J`` and ring depth ``stages``; ``R``, the rows of X a warp
    owns (the register tile is ``COLS`` x R); the block's ``threads``
    (ceil(k / R) warps) and shared bytes; the blocks an SM they allow and
    the persistent ``grid``; ``bptr`` (grid + 1,) int32 on the tiles'
    device: block b sums the row tiles ``bptr[b]`` .. ``bptr[b + 1] - 1``,
    in that order; ``busiest`` and ``mean``, the tiles a block sums."""
    J: int
    stages: int
    R: int
    threads: int
    smem_bytes: int
    blocks_per_sm: int
    grid: int
    bptr: torch.Tensor
    busiest: int
    mean: float

    def describe(self) -> str:
        return (f"J={self.J} stages={self.stages} tile={COLS}x{self.R} threads={self.threads} "
                f"smem={self.smem_bytes} blocks/SM={self.blocks_per_sm} grid={self.grid} "
                f"tiles/block busiest {self.busiest} mean {self.mean:.2f}")


def rows_per_warp(k: int) -> int:
    """R of a launch of k rows: 8 from k = 8, else the power of two >= k."""
    return 8 if k >= 8 else 1 << (k - 1).bit_length()


def _cuts(row_ptr: np.ndarray, nr: int, cap: int) -> np.ndarray | None:
    """Range boundaries (nr + 1 row-tile indices) of the greedy cut with at
    most ``cap`` tiles a range, or None where nr such ranges do not cover the
    row tiles."""
    nrt = len(row_ptr) - 1
    cut = [0]
    while cut[-1] < nrt and len(cut) <= nr:
        s = cut[-1]
        e = min(int(np.searchsorted(row_ptr, row_ptr[s] + cap, side="right")) - 1, nrt)
        if e == s:  # row tile s alone holds more than cap tiles
            return None
        cut.append(e)
    if cut[-1] < nrt:
        return None
    return np.asarray(cut + [nrt] * (nr + 1 - len(cut)))


def assign(row_ptr: np.ndarray, grid: int) -> np.ndarray:
    """bptr (grid + 1,): the row tiles cut into ``grid`` contiguous ranges
    holding at most C tiles each, C the least for which such a cut exists
    (a binary search over the greedy cut); block b takes range b. C is below
    the mean range plus one row tile."""
    counts = np.diff(row_ptr)
    lo = max(int(counts.max(initial=0)), -(-int(row_ptr[-1]) // grid), 1)
    hi = lo + int(counts.max(initial=0))
    while lo < hi:
        mid = (lo + hi) // 2
        if _cuts(row_ptr, grid, mid) is None:
            lo = mid + 1
        else:
            hi = mid
    return _cuts(row_ptr, grid, lo).astype(np.int32)


def _blocks_per_sm(k, R, J, stages, tile_bytes, index, cap) -> tuple[int, int, int]:
    """(threads, shared bytes, blocks an SM) of a launch of k rows at (R, J,
    stages): on a card (``index``) from the build's occupancy query, else
    from the shared memory alone (the registers are the build's)."""
    if (R, J) not in BUILT or not 2 <= stages <= 4:
        raise ValueError(f"tiled_plan: no build of R = {R}, J = {J}, stages = {stages}")
    warps = -(-k // R)
    threads = 32 * warps
    if threads > MAX_THREADS:
        raise ValueError(f"tiled_plan: {warps} warps of {R} rows pass {MAX_THREADS} threads")
    smem = stages * stage_bytes(J, warps * R, tile_bytes)
    if smem > cap:
        raise ValueError(f"tiled_plan: {smem} bytes of stages pass the cap of {cap}")
    if index is None:
        return threads, smem, (cap + 1024) // (smem + 1024)
    blocks = _native.library().bcg_tiled_spmm_blocks_per_sm(int(tile_bytes == 2), k, J, stages,
                                                            R, index)
    if blocks < 1:
        raise RuntimeError(f"tiled_plan: no block of {threads} threads and {smem} bytes "
                           f"fits an SM (CUDA error {-blocks})")
    return threads, smem, blocks


def tiled_plan(row_ptr: torch.Tensor, k: int, device=None, tile_dtype=torch.float32, *,
               J: int | None = None, stages: int | None = None, R: int | None = None,
               sms: int | None = None, cap: int | None = None) -> TiledPlan:
    """The schedule of ``tiled_spmm_t`` on k <= 128 rows of X over the row
    tiles of ``row_ptr``: slices of J = 32 columns through a two-stage ring
    (J = 16 through three stages where that fits two blocks an SM and J = 32
    fits one: k = 96 and 128), a 4 x 8 register tile from k = 8, one
    contiguous range of row tiles a block (``assign``). ``J``, ``stages`` and
    ``R`` override the choice (the timing tool's variants). The grid fills
    the card: ``sms`` SMs (the card's by default) of as many blocks as the
    build's occupancy allows (``bcg_tiled_spmm_blocks_per_sm``) under
    ``cap``, the per-block shared-memory cap (the card's by default). Off the
    card (the CPU tests) ``sms`` and ``cap`` must be given, and the blocks an
    SM are counted from the shared memory alone."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"tiled_plan: k = {k} outside 1..{MAX_K}")
    device = torch.device(device if device is not None else row_ptr.device)
    R = R or rows_per_warp(k)
    index = None
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        sms = sms or _native.sm_count(index)
        cap = cap or _native.max_smem(index)
    if sms is None or cap is None:
        raise ValueError("tiled_plan: off a CUDA device, give the card's sms and cap")
    tile_bytes = torch.finfo(tile_dtype).bits // 8
    shape = (J or 32, stages or 2)
    threads, smem, blocks = _blocks_per_sm(k, R, *shape, tile_bytes, index, cap)
    if J is None and stages is None and blocks < 2 and (R, 16) in BUILT:
        narrow = _blocks_per_sm(k, R, 16, 3, tile_bytes, index, cap)
        if narrow[2] > blocks:
            shape, (threads, smem, blocks) = (16, 3), narrow
    rp = row_ptr.detach().cpu().numpy().astype(np.int64)
    nrt = len(rp) - 1
    grid = max(1, min(sms * blocks, nrt))
    bptr = assign(rp, grid)
    per = rp[bptr[1:]] - rp[bptr[:-1]]
    return TiledPlan(*shape, R, threads, smem, blocks, grid,
                     torch.as_tensor(bptr, device=row_ptr.device), int(per.max()),
                     float(rp[-1]) / grid)


def _use_kernel(tiles, rt, ct, first, Xt) -> bool:
    dev = Xt.device
    if any(t.device != dev for t in (tiles, rt, ct, first)):
        raise ValueError("tiled_spmm_t: operands on several devices")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"tiled_spmm_t: unsupported device {dev}")
    if Xt.dtype == torch.float64 and tiles.dtype == torch.float64:
        return False
    if Xt.dtype != torch.float32 or tiles.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tiled_spmm_t: the CUDA kernel takes float32 X with float32 or "
                        f"bfloat16 tiles (float64 runs the plain version); got X "
                        f"{Xt.dtype}, tiles {tiles.dtype}")
    if any(t.dtype != torch.int32 for t in (rt, ct, first)):
        raise TypeError("tiled_spmm_t: rt, ct and first must be int32")
    if not all(t.is_contiguous() for t in (tiles, rt, ct, first, Xt)):
        raise ValueError("tiled_spmm_t: CUDA kernel operands must be contiguous")
    return True


def tiled_spmm_t(tiles: torch.Tensor, rt: torch.Tensor, ct: torch.Tensor,
                 first: torch.Tensor, Xt: torch.Tensor,
                 row_ptr: torch.Tensor | None = None, plan=None) -> torch.Tensor:
    """``Y = A X`` on a lanes-major (k, n) field from A's sorted tiles.
    ``row_ptr`` is :func:`row_pointers` of ``rt``, and ``plan`` a callable
    from a launch's rows to its :class:`TiledPlan`, when the caller keeps
    them (``TiledOperator`` builds both once); else they are derived here."""
    if Xt.dim() != 2 or tiles.dim() != 3 or tiles.shape[1:] != (T, T) or Xt.shape[1] % T:
        raise ValueError(f"tiled_spmm_t: tiles {tuple(tiles.shape)} and X "
                         f"{tuple(Xt.shape)}; expected (ntiles, {T}, {T}) and (k, n), "
                         f"n % {T} == 0")
    if not _use_kernel(tiles, rt, ct, first, Xt):
        return tiled_spmm_plain(tiles, rt, ct, Xt)
    k, n = Xt.shape
    nrt = n // T
    if row_ptr is None:
        row_ptr = row_pointers(rt, nrt)
    if row_ptr.shape != (nrt + 1,) or row_ptr.dtype != torch.int32:
        raise ValueError(f"tiled_spmm_t: row_ptr {tuple(row_ptr.shape)} {row_ptr.dtype} "
                         f"for {nrt} row tiles")
    if tiles.data_ptr() % 16:
        raise ValueError("tiled_spmm_t: the CUDA kernel takes 16-byte aligned tiles")
    if plan is None:
        def plan(kk):
            return tiled_plan(row_ptr, kk, Xt.device, tiles.dtype)
    Y = torch.empty_like(Xt)
    p = _native.ptr
    for r0, r1 in _native.row_chunks(k, MAX_K):
        pl = plan(r1 - r0)
        _native.launch("tiled_spmm_t", "bcg_tiled_spmm", Xt.device, p(tiles),
                       int(tiles.dtype == torch.bfloat16), p(row_ptr), p(ct), p(first),
                       p(pl.bptr), pl.grid, p(Xt[r0:r1]), p(Y[r0:r1]), r1 - r0,
                       nrt, n, pl.J, pl.stages, pl.R)
    return Y
