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

The scalar recurrence (theta, delta, sigma1, rho, c1, c2) runs once per
operator on the host, in the field's real dtype with the reference's
operation order, so an apply reads nothing back from the card.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from blockcg_tpu_torch.operators.base import DelegatedCodecMixin


def _np_real(dtype: torch.dtype):
    return np.float64 if dtype in (torch.float64, torch.complex128) else np.float32


def cheb_coefficients(lo, hi, degree: int, field_dtype: torch.dtype):
    """``(theta, [(c1, c2), ...])`` of the degree-``degree`` semi-iteration:
    z0 = r / theta, then per step ``d' = c1 d + c2 (r - A z)``, ``z' = z +
    d'``. ``lo`` and ``hi`` are host scalars; numpy scalars keep their width
    (the reference sums them in their own dtype before the cast). Every
    operation rounds to the field's real dtype, as the reference's jnp
    scalars do; the results are Python floats holding those values."""
    rdt = _np_real(field_dtype)
    lo = lo if isinstance(lo, np.generic) else rdt(lo)
    hi = hi if isinstance(hi, np.generic) else rdt(hi)
    two, one = rdt(2), rdt(1)
    theta = rdt(hi + lo) / two
    delta = rdt(hi - lo) / two
    sigma1 = theta / delta
    rho = one / sigma1
    steps = []
    for _ in range(degree - 1):
        rho_new = one / (two * sigma1 - rho)
        steps.append((float(rho_new * rho), float(two * rho_new / delta)))
        rho = rho_new
    return float(theta), steps


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
        self.theta, self.steps = cheb_coefficients(lo, hi, self.degree, base.dtype)

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

    def apply_m_t(self, Rt: torch.Tensor) -> torch.Tensor:
        """M r on a lanes-major field (the right-hand side's transform)."""
        return _cheb_m_apply(self.base, Rt, self.theta, self.steps)

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
