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
not part of the contract: the port has no ring entry of its own. The
reference's merged kernels need m % 8 == 0 (a TPU sublane rule); the CUDA
kernel takes any m. Left out: the folded wrap diagonals (``fold=``), bf16
block storage and ``donate``.

Dispatch follows ``ops/_native.py``: CPU and CUDA float64 tensors run the
plain versions below (the reference's ``_matmat_m_xla`` roll-and-einsum),
CUDA float32 tensors launch the kernel, and anything else raises, complex
blocks included (their route to the card is ``operators.realify``). Kernel
bounds: at most 32 diagonals and bs <= 8; the wrappers raise outside them.
One launch takes k <= 64 / w right-hand sides, w = 4 for bs <= 4 and 8
above; a wider field runs as one launch per chunk of right-hand sides (on
the merged view with the field's spin stride, as in
``ops/const_block_stencil.py``), and a Gram wider than one launch is
``fused.gram`` of X and the stored Y.
"""

from __future__ import annotations

import ctypes

import torch

from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.solvers.common import acc_dtype, gram_t

MAX_DIAGS = 32  # csrc/block_stencil.cu kMaxDiags
MAX_BS = 8  # csrc/block_stencil.cu kMaxBs


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
    """Right-hand sides one launch takes: 64 rows over w (bs <= 8, rounded
    up to 4 or 8); at most 32 diagonals."""
    if not 1 <= bs <= MAX_BS:
        raise ValueError(f"{name}: the CUDA kernel takes bs <= {MAX_BS}, got {bs}")
    if nd > MAX_DIAGS:
        raise ValueError(f"{name}: {nd} diagonals, the CUDA kernel takes at most {MAX_DIAGS}")
    return _native.MAX_K // (4 if bs <= 4 else 8)


# ------------------------------------------------------------ plain versions


def block_stencil_plain(blocks, offsets, Xm, with_gram: bool = False):
    """Plain PyTorch version on the merged (m, ns) view: the roll-and-einsum
    of the reference's ``BlockDIAOperator._matmat_m_xla``, one input spin at
    a time. Returns ``(Ym, Gm or None)`` with ``Gm = X^H Y`` taken on the
    accumulator."""
    bs = blocks.shape[1]
    m, ns = Xm.shape
    adt = acc_dtype(Xm.dtype)
    Xv = Xm.reshape(bs, m // bs, ns).to(adt)
    C = blocks.to(adt)
    Yv = torch.zeros_like(Xv)
    for d, o in enumerate(offsets):
        src = Xv if o % ns == 0 else torch.roll(Xv, -o, dims=2)
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


def _launch(blocks, offsets, X, k: int, merged: bool, with_gram: bool, name: str):
    """Launch on a contiguous (bs * k, ns)-shaped field X (the merged view, or
    the (k, bs, ns) view and its flat form), one launch per chunk of
    right-hand sides; returns (Y shaped like X, Gm or None)."""
    from blockcg_tpu_torch.ops import fused

    nd, bs, _, ns = blocks.shape
    chunks = _native.row_chunks(k, _rhs_width(bs, nd, name))
    offs = (ctypes.c_int * nd)(*(int(o) % ns for o in offsets))
    Y = torch.empty_like(X)
    nb = _native.nblocks(ns)
    fused_gram = with_gram and len(chunks) == 1
    part = G = None
    if fused_gram:
        m = bs * k
        part = torch.empty((nb, m, m), dtype=torch.float32, device=X.device)
        G = torch.empty((m, m), dtype=torch.float32, device=X.device)
    row = ns * 4 * (1 if merged else bs)  # bytes from one RHS to the next
    p = _native.ptr
    for j0, j1 in chunks:
        _native.launch(name, "bcg_block_stencil_spmm", X.device, p(blocks), offs, nd, bs,
                       p(X) + j0 * row, p(Y) + j0 * row, p(part), p(G), j1 - j0,
                       k if merged else j1 - j0, ns, int(merged), nb)
    if with_gram and not fused_gram:
        G = fused.gram(X, Y)
    return Y, G


def _merged(blocks, offsets, Xm, with_gram: bool, name: str):
    if Xm.dim() != 2:
        raise ValueError(f"{name}: expected a merged (m, ns) field, got {tuple(Xm.shape)}")
    _check(blocks, offsets, Xm.shape[0], Xm.shape[1], name)
    if not _native.use_kernel(blocks, Xm):
        return block_stencil_plain(blocks, offsets, Xm, with_gram)
    return _launch(blocks, offsets, Xm, Xm.shape[0] // blocks.shape[1], True,
                   with_gram, name)


def block_stencil_spmm_m_t(blocks: torch.Tensor, offsets: tuple[int, ...],
                           Xm: torch.Tensor) -> torch.Tensor:
    """Merged-layout block SpMM: blocks (noff, bs, bs, ns), Xm (m = bs*k,
    ns) with row a*k + i. Returns Ym."""
    return _merged(blocks, offsets, Xm, False, "block_stencil_spmm_m_t")[0]


def block_stencil_spmm_m_gram_t(blocks: torch.Tensor, offsets: tuple[int, ...],
                                Xm: torch.Tensor):
    """``(Ym, Gm = X Y^T)``, Gm (m, m); contract it to k x k with the
    operator's ``gram_contract``."""
    return _merged(blocks, offsets, Xm, True, "block_stencil_spmm_m_gram_t")


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
    if not _native.use_kernel(blocks, Xt):
        return block_stencil_v_plain(blocks, offsets, Xt.reshape(k, bs, ns)).reshape(Xt.shape)
    return _launch(blocks, offsets, Xt, k, False, False, name)[0]
