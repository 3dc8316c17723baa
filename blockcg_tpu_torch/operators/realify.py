"""Realified Hermitian operators: the card's route for complex systems.

Counterpart of ``blockcg_tpu/operators/realify.py``. A complex Hermitian
system maps onto a real symmetric one of twice the size,

    A x = b   (A Hermitian)   <=>   A_R [re x; im x] = [re b; im b],
    A_R = [[Re A, -Im A], [Im A, Re A]]   (SPD iff A is HPD),

which the real solvers and every real kernel run on stacked (re, im)
fields. For the lattice containers the stacking rides the spin axis
(bs -> 2 bs): spins [0, bs) carry Re, [bs, 2 bs) carry Im, matching the
doubled blocks. ``A_R`` has A's spectrum with doubled multiplicity, so
CG-family iteration counts follow the complex solve's.

``RealifiedHermitianOperator`` speaks complex at its public applies and
hands the solvers real stacked fields through ``to_internal`` /
``from_internal``, so ``solve_sbcgrq(realify(op), B)`` with a complex ``B``
runs its whole loop in real f32. The codec stays on the field's device as
torch complex ops (the reference goes through host numpy because its TPU
backend has no complex64).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from blockcg_tpu_torch.operators.base import DelegatedCodecMixin


def real_mask_dtype(np_dtype) -> np.dtype:
    """Real dtype matching a complex one's width (mask/value arrays)."""
    return np.float32 if np.dtype(np_dtype) == np.complex64 else np.float64


def k1k2_blocks(B: np.ndarray, rdt) -> tuple[np.ndarray, np.ndarray]:
    """The realified split of a complex-scaled block:
    ``phi * B = phi_r * K1(B) + phi_i * K2(B)`` with
    K1 = [[Br, -Bi], [Bi, Br]] and K2 = [[-Bi, -Br], [Br, -Bi]], the one
    convention of the U(1)-gauged value-masked operators."""
    br, bi = B.real.astype(rdt), B.imag.astype(rdt)
    return (np.block([[br, -bi], [bi, br]]),
            np.block([[-bi, -br], [br, -bi]]))


def _doubled_block(h: np.ndarray) -> np.ndarray:
    """bs x bs complex -> 2bs x 2bs real [[Hr, -Hi], [Hi, Hr]]."""
    hr, hi = h.real, h.imag
    return np.block([[hr, -hi], [hi, hr]])


class RealifiedHermitianOperator(DelegatedCodecMixin, nn.Module):
    """Complex Hermitian operator applied as a real symmetric one.

    ``real_op`` (a submodule) acts on stacked fields; ``cbs`` is the complex
    spin-block size (0 for dense: the stacking is then along flat rows);
    ``cdtype`` the complex dtype of the public applies; ``nnz`` the complex
    operator's count (default the real core's)."""

    complex_codec = True  # the solvers accept complex fields on this operator
    codec_of = "real_op"  # coeff_expand and the contractions are the core's

    def __init__(self, real_op, cbs: int, num_sites: int, cdtype: torch.dtype,
                 nnz: int | None = None):
        super().__init__()
        if cdtype not in (torch.complex64, torch.complex128):
            raise TypeError(f"cdtype must be complex64 or complex128, got {cdtype}")
        self.real_op = real_op
        self.cbs = int(cbs)
        self.num_sites = int(num_sites)
        self.cdtype = cdtype
        self._nnz = nnz

    @property
    def n(self) -> int:
        return max(self.cbs, 1) * self.num_sites

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        return self.real_op.nnz if self._nnz is None else self._nnz

    @property
    def dtype(self) -> torch.dtype:
        return self.cdtype

    # -- field codecs: complex (k, n) <-> the real core's internal view -----

    def to_internal(self, Xt: torch.Tensor) -> torch.Tensor:
        """Complex (k, n) -> the real core's internal view of the stacked
        real field (the merged spin-major view for the lattice cores). A real
        field counts as complex with zero imaginary part."""
        k = Xt.shape[0]
        rdt = self.cdtype.to_real()
        re = Xt.real.to(rdt)
        im = Xt.imag.to(rdt) if Xt.is_complex() else torch.zeros_like(re)
        if self.cbs > 0:
            shape = (k, self.cbs, self.num_sites)
            flat = torch.cat([re.reshape(shape), im.reshape(shape)], dim=1)
            flat = flat.reshape(k, 2 * self.cbs * self.num_sites)
        else:
            flat = torch.cat([re, im], dim=1)
        return self.real_op.to_internal(flat)

    def from_internal(self, Xf: torch.Tensor) -> torch.Tensor:
        Xs = self.real_op.from_internal(Xf)
        k = Xs.shape[0]
        if self.cbs > 0:
            Xv = Xs.reshape(k, 2, self.cbs, self.num_sites)
            re, im = Xv[:, 0], Xv[:, 1]
        else:
            re, im = Xs[:, : self.n], Xs[:, self.n:]
        return torch.complex(re, im).reshape(k, self.n).to(self.cdtype)

    # ---------------------------------------------------------------- apply

    def matmat_t(self, Xt: torch.Tensor) -> torch.Tensor:
        if Xt.is_complex():
            # Public complex boundary: encode, apply the real core, decode.
            return self.from_internal(self.real_op.matmat_t(self.to_internal(Xt)))
        # Solver-internal stacked real field: straight through.
        return self.real_op.matmat_t(Xt)

    def matmat_gram_t(self, Xt: torch.Tensor):
        if Xt.is_complex():
            return self.matmat_t(Xt), None
        return self.real_op.matmat_gram_t(Xt)

    def astype_op(self, dtype: torch.dtype) -> "RealifiedHermitianOperator":
        """A new operator of the width ``dtype`` names, as the reference's
        ``astype`` reads it: an itemsize of 8 or more (float64, complex64,
        complex128) gives complex128 over a float64 core, float32 gives
        complex64 over a float32 core."""
        wide = dtype.itemsize >= 8
        rdt = torch.float64 if wide else torch.float32
        return RealifiedHermitianOperator(
            self.real_op.astype_op(rdt), self.cbs, self.num_sites,
            rdt.to_complex(), self._nnz)

    def extra_repr(self) -> str:
        return f"cbs={self.cbs}, num_sites={self.num_sites}, cdtype={self.cdtype}"


def realify(op) -> RealifiedHermitianOperator:
    """The real symmetric form of a complex Hermitian operator, on the
    operator's device: ``ConstBlockDIAOperator`` (hops doubled, slabs kept,
    so the const-hop kernels run it), ``BlockDIAOperator`` (per-site blocks
    doubled, for the block-stencil kernel) and ``DenseOperator``. The input
    must be Hermitian; realify does not check."""
    from blockcg_tpu_torch.operators.bdia import BlockDIAOperator
    from blockcg_tpu_torch.operators.cbdia import ConstBlockDIAOperator
    from blockcg_tpu_torch.operators.dense import DenseOperator

    if isinstance(op, ConstBlockDIAOperator):
        hops2 = tuple(
            tuple(tuple(float(v) for v in row)
                  for row in _doubled_block(np.asarray(h, dtype=np.complex128)))
            for h in op.hops)
        rdt = op.dtype.to_real()
        real_op = ConstBlockDIAOperator(op.masks, hops2, op.offsets, op.mask_slot,
                                        op.num_sites, op.slabs, dtype=rdt,
                                        device=op.hops_all.device)
        return RealifiedHermitianOperator(real_op, op.bs, op.num_sites,
                                          rdt.to_complex(), op.nnz)

    if isinstance(op, BlockDIAOperator):
        blocks = op.blocks
        rdt = blocks.dtype.to_real()
        br = blocks.real.to(rdt)
        bi = blocks.imag.to(rdt) if blocks.is_complex() else torch.zeros_like(br)
        top = torch.cat([br, -bi], dim=2)
        out = torch.cat([top, torch.cat([bi, br], dim=2)], dim=1)
        real_op = BlockDIAOperator(out, op.offsets, nnz=int(torch.count_nonzero(out)))
        return RealifiedHermitianOperator(real_op, op.bs, op.ns, rdt.to_complex(), op.nnz)

    if isinstance(op, DenseOperator):
        A = op.A
        rdt = A.dtype.to_real()
        Ar, Ai = A.real.to(rdt), (A.imag.to(rdt) if A.is_complex() else torch.zeros_like(A))
        real = torch.cat([torch.cat([Ar, -Ai], dim=1), torch.cat([Ai, Ar], dim=1)], dim=0)
        return RealifiedHermitianOperator(DenseOperator(real), 0, op.n, rdt.to_complex(),
                                          int(torch.count_nonzero(A)))

    raise TypeError(f"realify: unsupported operator type {type(op).__name__}")
