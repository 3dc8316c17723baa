"""Toroidal DIA SpMM on lanes-major fields, with an optional fused Gram.

Counterpart of ``blockcg_tpu/ops/stencil.py`` and
``blockcg_tpu/ops/stencil_ring.py``: one CUDA kernel (``csrc/stencil.cu``)
serves both contracts, since the TPU's windowed and ring schedules are not
part of them. Semantics are toroidal, ``Yt[:, i] = sum_d diags[d, i] *
Xt[:, (i + offsets[d]) mod n]``; Dirichlet builders zero every wrap-crossing
coefficient, which makes this the truncated apply.

Dispatch follows ``ops/_native.py``: CPU and CUDA float64 tensors run the
plain roll-and-accumulate below, CUDA float32 tensors launch the kernel.
The kernel writes Y to a fresh buffer, never onto X. The rows of a field are
independent right-hand sides, so a field wider than one launch (64 rows) runs
as one launch per chunk of rows; the fused Gram's cross blocks then come from
``fused.gram`` on the stored output.
"""

from __future__ import annotations

import ctypes

import torch

from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.solvers.common import acc_dtype, gram_t

MAX_DIAGS = 32  # csrc/stencil.cu kMaxDiags


def stencil_spmm_plain(diags: torch.Tensor, offsets: tuple[int, ...],
                       Xt: torch.Tensor, with_gram: bool = False):
    """Plain PyTorch version: the roll-and-accumulate of the reference's XLA
    path (``DIAOperator._matmat_t_xla``). Returns ``(Yt, G or None)`` with
    ``G = X Y^T`` taken on the accumulator, as the Pallas kernel does."""
    adt = acc_dtype(Xt.dtype)
    acc = torch.zeros(Xt.shape, dtype=adt, device=Xt.device)
    for d, o in enumerate(offsets):
        src = Xt if o == 0 else torch.roll(Xt, -o, dims=1)
        acc.addcmul_(diags[d].to(adt)[None, :], src.to(adt))
    G = gram_t(Xt, acc) if with_gram else None
    return acc.to(Xt.dtype), G


def _launch(diags, offsets, Xt, with_gram: bool, name: str):
    from blockcg_tpu_torch.ops import fused

    ndiag, n = diags.shape
    k = Xt.shape[0]
    _native.check_field(Xt, k, n, name)
    if len(offsets) != ndiag or not 1 <= ndiag <= MAX_DIAGS:
        raise ValueError(f"{name}: {len(offsets)} offsets for {ndiag} "
                         f"diagonals (at most {MAX_DIAGS})")
    offs = (ctypes.c_int * ndiag)(*(int(o) % n for o in offsets))
    Y = torch.empty_like(Xt)
    nb = _native.nblocks(n)
    chunks = _native.row_chunks(k)
    diag = []
    for r0, r1 in chunks:
        part = G = None
        if with_gram:
            part, G = fused._gram_buffers(r1 - r0, n, Xt.device)
        _native.launch(name, "bcg_stencil_spmm", Xt.device, _native.ptr(diags),
                       offs, ndiag, _native.ptr(Xt[r0:r1]), _native.ptr(Y[r0:r1]),
                       _native.ptr(part), _native.ptr(G), r1 - r0, n, nb)
        diag.append(G)
    if with_gram and len(chunks) > 1:
        return Y, fused.wide_gram(Xt, Y, diag, chunks)
    return Y, diag[0]


def stencil_spmm_t(diags: torch.Tensor, offsets: tuple[int, ...],
                   Xt: torch.Tensor) -> torch.Tensor:
    """``Yt[:, i] = sum_d diags[d, i] * Xt[:, (i + offsets[d]) mod n]``;
    diags (ndiag, n), Xt (k, n)."""
    if not _native.use_kernel(diags, Xt):
        return stencil_spmm_plain(diags, offsets, Xt)[0]
    return _launch(diags, offsets, Xt, False, "stencil_spmm_t")[0]


def stencil_spmm_gram_t(diags: torch.Tensor, offsets: tuple[int, ...],
                        Xt: torch.Tensor):
    """``(Yt, G = X Y^T)``: the SpMM with the solvers' ``P^T A P`` Gram."""
    if not _native.use_kernel(diags, Xt):
        return stencil_spmm_plain(diags, offsets, Xt, with_gram=True)
    return _launch(diags, offsets, Xt, True, "stencil_spmm_gram_t")
