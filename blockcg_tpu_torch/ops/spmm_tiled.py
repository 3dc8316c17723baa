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
launch per chunk of rows, each reading every tile again.
"""

from __future__ import annotations

import torch

from blockcg_tpu_torch.ops import _native

T = 128  # tile side
MAX_K = 128  # csrc/spmm_tiled.cu: widest register tile (KMAX)


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
                 row_ptr: torch.Tensor | None = None) -> torch.Tensor:
    """``Y = A X`` on a lanes-major (k, n) field from A's sorted tiles.
    ``row_ptr`` is :func:`row_pointers` of ``rt``, when the caller keeps it
    (``TiledOperator`` builds it once); else it is derived here."""
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
    Y = torch.empty_like(Xt)
    p = _native.ptr
    for r0, r1 in _native.row_chunks(k, MAX_K):
        _native.launch("tiled_spmm_t", "bcg_tiled_spmm", Xt.device, p(tiles),
                       int(tiles.dtype == torch.bfloat16), p(row_ptr), p(ct), p(first),
                       p(Xt[r0:r1]), p(Y[r0:r1]), r1 - r0, nrt, n)
    return Y
