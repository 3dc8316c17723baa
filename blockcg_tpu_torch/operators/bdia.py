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
``operators.realify`` is their route.

Dtypes, as the reference's gate ``_kernel_ok`` takes them: f32 or bf16
blocks (bf16 storage halves the blocks' bytes) with f32 fields launch the
kernels; the Gram is fused only for f32 blocks with f32 fields
(``matmat_gram_t`` returns ``(Y, None)`` otherwise, and the solvers take the
Gram from ``gram``). A bf16 field, whatever the blocks, goes whole to the
plain route of the reference's XLA path, on any device
(``_native.f32_field_gate_refuses``): ``_matmat_m_plain`` rounds the blocks
to bf16, rounds each diagonal's product to bf16 and adds it to a bf16 Y in
offset order (``_matmat_m_xla``); ``_matmat_v_plain`` on the flat or (k, bs,
ns) view adds each diagonal's product in the promoted dtype of blocks and
field (``_matmat_v_xla``: f32 blocks with a bf16 field give an f32 Y).
float64 runs the plain version everywhere.

Folded wraps (``blocks_folded``, ``fold_offsets``, ``fold``; built by the
problem builders under ``BLOCKCG_FOLD``, as the reference's): each toroidal
wrap diagonal merged into its bulk hop partner, so the merged applies stream
fewer coefficient diagonals (9 of 15 at 32^4). They are used where
``_use_fold`` says, as the reference reads it (``BLOCKCG_FOLD`` and the
fields present; the port has no ring schedule, so this alone decides), on
the merged view with f32 fields. Every other consumer keeps ``blocks`` and
``offsets``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from blockcg_tpu_torch.operators.base import MatmatMixin
from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.ops import block_stencil as bsk


def _xla_products(c: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``Y[i, a, s] = sum_b c[a, b, s] src[i, b, s]`` of a bf16 field as the
    reference's XLA einsum takes it on the CPU: one f32 fused multiply-add
    per b, in order (checked bitwise against it). The products of bf16 with
    f32 or bf16 are exact in f64, so each step runs there and rounds to
    f32. Returns f32."""
    acc = torch.zeros(src.shape, dtype=torch.float64, device=src.device)
    for b in range(c.shape[1]):
        acc = (acc + c[None, :, b].double() * src[:, b, None].double()).float().double()
    return acc.float()


class BlockDIAOperator(MatmatMixin, nn.Module):
    """blocks: (noff, bs, bs, ns) buffer; offsets: tuple of ints.

    ``wrap_zero`` records that every coefficient whose site column wraps
    modulo ns is exactly zero (the open-boundary builders check it); ``nnz``
    is the builder's structural count (default ``noff * bs^2 * ns``).
    ``blocks_folded`` (a buffer, or None), ``fold_offsets`` and ``fold``
    (``((diagonal, L), ...)``) are the optional folded form (module
    docstring)."""

    def __init__(self, blocks: torch.Tensor, offsets, wrap_zero: bool = False,
                 nnz: int | None = None, blocks_folded: torch.Tensor | None = None,
                 fold_offsets=(), fold=()):
        super().__init__()
        if blocks.dim() != 4 or blocks.shape[1] != blocks.shape[2]:
            raise ValueError(f"blocks must be (noff, bs, bs, ns), got {tuple(blocks.shape)}")
        if blocks.shape[0] != len(offsets):
            raise ValueError(f"{blocks.shape[0]} diagonals, {len(offsets)} offsets")
        if blocks_folded is not None and (
                blocks_folded.shape[1:] != blocks.shape[1:]
                or blocks_folded.shape[0] != len(fold_offsets) or not fold):
            raise ValueError(f"folded blocks {tuple(blocks_folded.shape)} for "
                             f"{len(fold_offsets)} offsets and {len(fold)} folds")
        self.register_buffer("blocks", blocks)
        self.register_buffer("blocks_folded", blocks_folded)
        self.offsets = tuple(int(o) for o in offsets)
        self.fold_offsets = tuple(int(o) for o in fold_offsets)
        self.fold = tuple((int(d), int(L)) for d, L in fold)
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
                   device="cuda", blocks_folded=None, fold_offsets=(),
                   fold=()) -> "BlockDIAOperator":
        """Build from host data, e.g. a reference operator's
        ``(np.asarray(op.blocks), op.offsets, op.wrap_zero, op.nnz)`` (and its
        ``blocks_folded``, ``fold_offsets`` and ``fold``), so both packages
        apply the same matrix. ``dtype`` casts both block arrays."""
        def tensor(a):
            t = torch.from_numpy(np.array(a))  # a writable host copy
            return t.to(dtype=dtype or t.dtype, device=device)

        return cls(tensor(blocks), offsets, wrap_zero, nnz,
                   None if blocks_folded is None else tensor(blocks_folded), fold_offsets,
                   fold)

    def astype_op(self, dtype: torch.dtype) -> "BlockDIAOperator":
        """The operator in ``dtype``, both block arrays cast (the folded
        blocks are data, as in the reference's ``astype``)."""
        folded = None if self.blocks_folded is None else self.blocks_folded.to(dtype)
        return BlockDIAOperator(self.blocks.to(dtype), self.offsets, self.wrap_zero,
                                self._nnz, folded, self.fold_offsets, self.fold)

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

    def _use_fold(self) -> bool:
        """The folded form applies: it was built, and ``BLOCKCG_FOLD`` asks
        for it (the reference's opt-in)."""
        return bool(self.fold) and bool(os.environ.get("BLOCKCG_FOLD"))

    def _apply_m(self, Xm: torch.Tensor, with_gram: bool):
        """The merged kernels' apply, folded where ``_use_fold``."""
        if self._use_fold():
            args = (self.blocks_folded, self.fold_offsets, Xm, self.fold)
        else:
            args = (self.blocks, self.offsets, Xm)
        if with_gram:
            return bsk.block_stencil_spmm_m_gram_t(*args)
        return bsk.block_stencil_spmm_m_t(*args), None

    def matmat_t(self, Xt: torch.Tensor, donate: bool = False) -> torch.Tensor:
        """Apply to a lanes-major block: the merged internal (m, ns) view,
        flat (k, bs*ns) or the (k, bs, ns) view. ``donate`` is accepted and
        ignored: the output is always a fresh buffer, as the reference's
        off its ring path. A bf16 field takes the reference's XLA route
        (module docstring)."""
        self._check_device(Xt)
        bf16 = _native.f32_field_gate_refuses(Xt)
        if self._is_internal(Xt):
            return self._matmat_m_plain(Xt) if bf16 else self._apply_m(Xt, False)[0]
        if bf16:
            return self._matmat_v_plain(Xt)
        return bsk.block_stencil_spmm_t(self.blocks, self.offsets, Xt.contiguous())

    def matmat_gram_t(self, Xt: torch.Tensor, donate: bool = False):
        """Fused ``(Y = A X, G = X^H Y)`` with G contracted to k x k, on the
        merged or the flat view (``donate`` as in :meth:`matmat_t`); ``(Y,
        None)`` where the blocks or the field are bf16, as the reference
        fuses the Gram only for f32 blocks with f32 fields."""
        self._check_device(Xt)
        if torch.bfloat16 in (self.dtype, Xt.dtype):
            return self.matmat_t(Xt), None
        if not self._is_internal(Xt):
            Ym, G = self.matmat_gram_t(self.to_internal(Xt))
            return self.from_internal(Ym), G
        Ym, Gm = self._apply_m(Xt, True)
        return Ym, self.gram_contract(Gm)

    def _matmat_m_plain(self, Xm: torch.Tensor) -> torch.Tensor:
        """The reference's ``_matmat_m_xla`` on the merged (bf16) view: the
        blocks cast to bf16, each diagonal's product (``_xla_products``)
        rounded to bf16 and added to a bf16 Y, in offset order."""
        m, ns = Xm.shape
        bs = self.bs
        Xv = Xm.reshape(bs, m // bs, ns)
        Yv = torch.zeros_like(Xv)
        for d, o in enumerate(self.offsets):
            src = Xv if o % ns == 0 else torch.roll(Xv, -o, dims=2)
            c = self.blocks[d].to(Xm.dtype)
            Yv += _xla_products(c, src.transpose(0, 1)).transpose(0, 1).to(Xm.dtype)
        return Yv.reshape(m, ns)

    def _matmat_v_plain(self, Xt: torch.Tensor) -> torch.Tensor:
        """The reference's ``_matmat_v_xla`` on the flat (k, bs*ns) or the
        (k, bs, ns) view of a bf16 field: each diagonal's product
        (``_xla_products``) in the promoted dtype of the blocks and the field
        (f32 with f32 blocks), added to Y in that dtype, in offset order. Y
        comes back shaped like Xt."""
        k = Xt.shape[0]
        Xv = Xt.reshape(k, self.bs, self.ns)
        out = torch.promote_types(self.dtype, Xt.dtype)
        Yv = torch.zeros_like(Xv)
        for d, o in enumerate(self.offsets):
            src = Xv if o % self.ns == 0 else torch.roll(Xv, -o, dims=2)
            Yv = Yv + _xla_products(self.blocks[d], src).to(out)
        return Yv.reshape(Xt.shape)

    def extra_repr(self) -> str:
        return (f"bs={self.bs}, ns={self.ns}, offsets={self.offsets}, "
                f"wrap_zero={self.wrap_zero}, fold={self.fold}")
