"""Block-DIA operator: per-site bs x bs blocks on fixed site offsets.

Counterpart of ``blockcg_tpu/operators/bdia.py``: the lattice block operator
whose couplings vary per site, as matrix-valued gauge links do (they do not
factor into the const-hop form of ``operators/cbdia.py``). Semantics:

    A[(a, s), (b, (s + offsets[d]) mod ns)] = blocks[d, a, b, s]

with spin-major rows (row ``a * ns + s``) and toroidal site indexing; the
builders zero every slot with no true coupling, and periodic wraps on the
fast axes are extra diagonals.

The solvers keep their state in the merged spin-major view (m = bs * k, ns),
row ``a * k + i``, with the same codec as ``ConstBlockDIAOperator``. The
apply runs ``ops/block_stencil.py``. Complex blocks are a container: their
apply runs the plain version on CPU tensors and raises on the card, where
``operators.realify`` is their route. Left out of the reference's fields:
the folded wrap diagonals (``blocks_folded``, ``fold_offsets``, ``fold``,
opt-in there through ``BLOCKCG_FOLD``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from blockcg_tpu_torch.operators.base import MatmatMixin
from blockcg_tpu_torch.ops import block_stencil as bsk


class BlockDIAOperator(MatmatMixin, nn.Module):
    """blocks: (noff, bs, bs, ns) buffer; offsets: tuple of ints.

    ``wrap_zero`` records that every coefficient whose site column wraps
    modulo ns is exactly zero (the open-boundary builders check it); ``nnz``
    is the builder's structural count (default ``noff * bs^2 * ns``)."""

    def __init__(self, blocks: torch.Tensor, offsets, wrap_zero: bool = False,
                 nnz: int | None = None):
        super().__init__()
        if blocks.dim() != 4 or blocks.shape[1] != blocks.shape[2]:
            raise ValueError(f"blocks must be (noff, bs, bs, ns), got {tuple(blocks.shape)}")
        if blocks.shape[0] != len(offsets):
            raise ValueError(f"{blocks.shape[0]} diagonals, {len(offsets)} offsets")
        self.register_buffer("blocks", blocks)
        self.offsets = tuple(int(o) for o in offsets)
        self.wrap_zero = bool(wrap_zero)
        self._nnz = nnz

    # ------------------------------------------------------------ structure

    @property
    def bs(self) -> int:
        return self.blocks.shape[1]

    @property
    def ns(self) -> int:
        return self.blocks.shape[3]

    @property
    def n(self) -> int:
        return self.bs * self.ns

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        if self._nnz is not None:
            return self._nnz
        return self.blocks.shape[0] * self.bs * self.bs * self.ns

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    @classmethod
    def from_numpy(cls, blocks, offsets, wrap_zero: bool = False,
                   nnz: int | None = None, *, dtype: torch.dtype | None = None,
                   device="cuda") -> "BlockDIAOperator":
        """Build from host data, e.g. a reference operator's
        ``(np.asarray(op.blocks), op.offsets, op.wrap_zero, op.nnz)``, so
        both packages apply the same matrix."""
        t = torch.from_numpy(np.array(blocks))  # a writable host copy
        return cls(t.to(dtype=dtype or t.dtype, device=device), offsets, wrap_zero, nnz)

    def astype_op(self, dtype: torch.dtype) -> "BlockDIAOperator":
        return BlockDIAOperator(self.blocks.to(dtype), self.offsets, self.wrap_zero,
                                self._nnz)

    # ----------------------------------------------------------- the codec

    def to_internal(self, Xt: torch.Tensor) -> torch.Tensor:
        """Flat lanes-major (k, bs*ns) [rows a*ns + s] -> merged (bs*k, ns)
        [rows a*k + i], contiguous (the CUDA wrappers take nothing else)."""
        k = Xt.shape[0]
        Xv = Xt.reshape(k, self.bs, self.ns)
        return Xv.transpose(0, 1).reshape(self.bs * k, self.ns).contiguous()

    def from_internal(self, Xm: torch.Tensor) -> torch.Tensor:
        k = Xm.shape[0] // self.bs
        Xv = Xm.reshape(self.bs, k, self.ns)
        return Xv.transpose(0, 1).reshape(k, self.n).contiguous()

    def coeff_expand(self, C: torch.Tensor) -> torch.Tensor:
        """``I_bs ⊗ C`` (contiguous: ``torch.kron`` refuses some transposed
        views, which the solvers pass)."""
        return torch.kron(torch.eye(self.bs, dtype=C.dtype, device=C.device),
                          C.contiguous())

    def gram_contract(self, G: torch.Tensor) -> torch.Tensor:
        """(m, m) -> k x k: the sum of the diagonal spin blocks."""
        k = G.shape[0] // self.bs
        return torch.diagonal(G.reshape(self.bs, k, self.bs, k), dim1=0, dim2=2).sum(-1)

    def norms2_contract(self, v: torch.Tensor) -> torch.Tensor:
        return v.reshape(self.bs, -1).sum(dim=0)

    # ---------------------------------------------------------------- apply

    def _is_internal(self, Xt: torch.Tensor) -> bool:
        return Xt.dim() == 2 and Xt.shape[-1] == self.ns

    def _check_device(self, Xt: torch.Tensor) -> None:
        if self.blocks.is_complex() and Xt.device.type == "cuda":
            raise NotImplementedError(
                "complex BlockDIAOperator blocks apply on CPU tensors only; on "
                "the card solve with operators.realify(op)")

    def matmat_t(self, Xt: torch.Tensor, donate: bool = False) -> torch.Tensor:
        """Apply to a lanes-major block: the merged internal (m, ns) view,
        flat (k, bs*ns) or the (k, bs, ns) view. ``donate`` is accepted and
        ignored: the output is always a fresh buffer, as the reference's
        off its ring path."""
        self._check_device(Xt)
        if self._is_internal(Xt):
            return bsk.block_stencil_spmm_m_t(self.blocks, self.offsets, Xt)
        return bsk.block_stencil_spmm_t(self.blocks, self.offsets, Xt.contiguous())

    def matmat_gram_t(self, Xt: torch.Tensor, donate: bool = False):
        """Fused ``(Y = A X, G = X^H Y)`` with G contracted to k x k, on the
        merged or the flat view (``donate`` as in :meth:`matmat_t`)."""
        self._check_device(Xt)
        if not self._is_internal(Xt):
            Ym, G = self.matmat_gram_t(self.to_internal(Xt))
            return self.from_internal(Ym), G
        Ym, Gm = bsk.block_stencil_spmm_m_gram_t(self.blocks, self.offsets, Xt)
        return Ym, self.gram_contract(Gm)

    def extra_repr(self) -> str:
        return (f"bs={self.bs}, ns={self.ns}, offsets={self.offsets}, "
                f"wrap_zero={self.wrap_zero}")
