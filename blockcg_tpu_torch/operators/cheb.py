"""Chebyshev polynomial preconditioning.

Counterpart of ``blockcg_tpu/operators/cheb.py``. For SPD A with spectrum
inside [lo, hi], the Chebyshev semi-iteration of fixed degree d defines
M = p_d(A) ~ A^{-1} with p_d > 0 on [lo, hi] (Saad, Iterative Methods,
§12.3). M is a polynomial in A, so it commutes with A and M A is SPD: the
preconditioned system (M A) X = M B (same X) goes to the unmodified block
solvers, and preconditioning is an operator wrapper. Each preconditioned
apply costs d SpMMs and d - 1 fused Chebyshev steps (``ops.fused.cheb_step``,
``csrc/cheb_step.cu``). The solver's monitor sees the preconditioned
residual; ``solvers/poly.py`` wraps the solve in a true-residual outer loop.

The scalar recurrence (theta, delta, sigma1, rho, c1, c2) runs on the host
once per operator and field dtype, in the field's real dtype (bfloat16 on a
bf16 field, whose steps then run the plain ``cheb_step`` as the reference's
do) with the reference's operation order, so an apply reads nothing back
from the card.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from blockcg_tpu_torch.operators.base import DelegatedCodecMixin


_TORCH_OF_NP = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _real(dtype: torch.dtype) -> torch.dtype:
    """The real dtype the recurrence runs in for a field of ``dtype``."""
    if dtype in (torch.float64, torch.complex128):
        return torch.float64
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def cheb_coefficients(lo, hi, degree: int, field_dtype: torch.dtype):
    """``(theta, [(c1, c2), ...])`` of the degree-``degree`` semi-iteration:
    z0 = r / theta, then per step ``d' = c1 d + c2 (r - A z)``, ``z' = z +
    d'``. ``lo`` and ``hi`` are host scalars; numpy scalars keep their width
    (the reference sums them in their own dtype before the cast). Every
    operation rounds to the field's real dtype (bfloat16 too), as the
    reference's jnp scalars do; the results are Python floats holding those
    values."""
    rdt = _real(field_dtype)

    def scalar(v):
        if isinstance(v, np.generic):
            return torch.tensor(v.item(), dtype=_TORCH_OF_NP[v.dtype])
        return torch.tensor(v, dtype=rdt)

    two, one = torch.tensor(2, dtype=rdt), torch.tensor(1, dtype=rdt)
    lo, hi = scalar(lo), scalar(hi)
    theta = (hi + lo).to(rdt) / two
    delta = (hi - lo).to(rdt) / two
    sigma1 = theta / delta
    rho = one / sigma1
    steps = []
    for _ in range(degree - 1):
        rho_new = one / (two * sigma1 - rho)
        steps.append(((rho_new * rho).item(), (two * rho_new / delta).item()))
        rho = rho_new
    return theta.item(), steps


def _cheb_m_apply(base, Rt, theta: float, steps):
    """z = p_d(A) r, the d-step Chebyshev semi-iteration for A z = r from
    z0 = 0, with the host coefficients of :func:`cheb_coefficients`."""
    from blockcg_tpu_torch.ops import fused

    z = Rt / theta
    dlt = z
    for j, (c1, c2) in enumerate(steps):
        Az = base.matmat_t(z)
        # d' = c1 d + c2 (r - A z);  z' = z + d'. After the first step z and
        # d are separate dead buffers, so the kernel writes them in place.
        z, dlt = fused.cheb_step(Rt, z, dlt, Az, c1, c2, donate=j > 0)
    return z


class ChebyshevOperator(DelegatedCodecMixin, nn.Module):
    """M A with M = p_degree(A). ``base`` is a submodule; ``lo`` and ``hi``
    (host scalars, or 0-d tensors read once here) bound the spectrum."""

    def __init__(self, base, lo, hi, degree: int):
        super().__init__()
        if degree < 1:
            raise ValueError("degree must be >= 1")
        self.base = base
        self.degree = int(degree)
        lo, hi = (v.item() if isinstance(v, torch.Tensor) else v for v in (lo, hi))
        self.lo, self.hi = lo, hi
        self._coefficients = {}

    @property
    def shape(self):
        return self.base.shape

    @property
    def n(self):
        return self.base.shape[0]

    @property
    def nnz(self) -> int:
        return self.base.nnz * self.degree  # SpMMs per preconditioned apply

    @property
    def dtype(self):
        return self.base.dtype

    def matmat_t(self, Xt: torch.Tensor) -> torch.Tensor:
        return self.apply_m_t(self.base.matmat_t(Xt))

    def coefficients(self, field_dtype: torch.dtype):
        """``cheb_coefficients`` for fields of ``field_dtype``, computed once
        and kept."""
        if field_dtype not in self._coefficients:
            self._coefficients[field_dtype] = cheb_coefficients(self.lo, self.hi,
                                                                self.degree, field_dtype)
        return self._coefficients[field_dtype]

    def apply_m_t(self, Rt: torch.Tensor) -> torch.Tensor:
        """M r on a lanes-major field (the right-hand side's transform)."""
        return _cheb_m_apply(self.base, Rt, *self.coefficients(Rt.dtype))

    def extra_repr(self) -> str:
        return f"degree={self.degree}, lo={self.lo}, hi={self.hi}"


def estimate_spectrum(op, iters: int = 30, seed: int = 0, safety: float = 1.05):
    """(lo, hi) bounds on the spectrum of SPD ``op``, as 0-d tensors on its
    device: power iteration on A (for hi) and on hi I - A (for lo), from the
    reference's v0 (``default_rng(seed)``, a flat (1, n) draw converted with
    ``to_internal``). The loops read nothing back from the card."""
    rng = np.random.default_rng(seed)
    n = op.shape[0]
    if op.dtype.is_complex:
        v = rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n))
    else:
        v = rng.standard_normal((1, n))
    device = next(iter(op.buffers())).device
    v0 = op.to_internal(torch.as_tensor(v, dtype=op.dtype, device=device))

    def power(shift, flip: bool):
        def step(v):
            w = op.matmat_t(v)
            return shift * v - w if flip else w

        v = v0
        for _ in range(iters):
            w = step(v)
            nrm = torch.sqrt((w * w.conj()).real.sum())
            v = w / torch.clamp_min(nrm, 1e-30)
        w = step(v)
        num = (v.conj() * w).real.sum()
        den = (v * v.conj()).real.sum()
        return num / den

    hi = power(None, False) * safety
    gap = power(hi, True)  # ~ hi - lambda_min
    lo = torch.maximum((hi - gap) / safety, hi * 1e-6)
    return lo, hi
