"""CG for one right-hand side.

Counterpart of ``blockcg_tpu/solvers/cg.py``. State is a lanes-major
single-row field (1, ...) in the operator's internal view, applied through
``matmat_t`` (the kernel path: block operators take no relayout per apply).
Scalars (rho, alpha, beta, norms, history) live in the accumulation dtype;
only the fields are stored in the field dtype. ``p^H A p`` is the (1, 1)
Gram that the operator's apply emits fused (``f_matmat_gram``).

The reference's ``lax.while_loop`` is a Python loop with one host read per
iteration, the stop test ``rho > tol^2 ||b||^2``, so iteration counts match
the reference's.
"""

from __future__ import annotations

from typing import Any

import torch

from blockcg_tpu_torch.solvers.common import (
    acc_dtype,
    check_precision,
    check_complex_codec,
    f_matmat_gram,
    vdot_real,
)
from blockcg_tpu_torch.types import SolverInfo


def _to_field(op, v):
    """(n,) vector -> (1, ...) lanes-major internal field, contiguous."""
    return op.to_internal(v[None, :].contiguous())


def _from_field(op, f):
    return op.from_internal(f)[0]


def _cg_impl(op, b, x0, tol, max_iter, record_history, group=None):
    rdtype = acc_dtype(b.real.dtype)
    fadt = acc_dtype(b.dtype)
    bnorm2 = vdot_real(b, b, group)
    bnorm2 = torch.where(bnorm2 > 0, bnorm2, torch.ones_like(bnorm2))
    tol2 = torch.as_tensor(tol, dtype=rdtype, device=b.device) ** 2 * bnorm2

    def axpy(a, s, v):
        # a + s v in the accumulation dtype, stored in the field dtype.
        return torch.addcmul(a.to(fadt), s, v.to(fadt)).to(a.dtype)

    x = x0
    r = b - op.matmat_t(x0)
    p = r
    rho = vdot_real(r, r, group)
    hist = (torch.full((max_iter,), torch.nan, dtype=rdtype, device=b.device)
            if record_history else None)
    it = 0
    while it < max_iter and bool(rho > tol2):  # the iteration's host read
        z, M = f_matmat_gram(op, p, group)
        alpha = rho / M[0, 0].real.to(rdtype)
        x = axpy(x, alpha, p)
        r = axpy(r, -alpha, z)
        rho_new = vdot_real(r, r, group)
        p = axpy(r, rho_new / rho, p)
        rho = rho_new
        if hist is not None:
            hist[it] = torch.sqrt(rho / bnorm2)
        it += 1

    relres = torch.sqrt(rho / bnorm2)[None]
    info = SolverInfo(iterations=it, relres=relres, converged=relres <= tol,
                      matvecs=it + 1, history=hist)
    return x, info


def solve_cg(
    op: Any,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    record_history: bool = False,
) -> tuple[torch.Tensor, SolverInfo]:
    """Solve ``A x = b`` (A SPD) by conjugate gradients.

    ``b`` is (n,) or (n, 1), on the device the solve runs on; ``x0`` an
    optional initial guess (default zero). Stops at ``||r|| <= tol ||b||``.
    Returns (x shaped like b, SolverInfo). ``b`` and ``x0`` are not
    modified.
    """
    unsqueeze = b.dim() == 2
    if unsqueeze:
        if b.shape[1] != 1:
            raise ValueError("solve_cg is single-RHS; use solve_bcg/solve_sbcgrq")
        b = b[:, 0]
        if x0 is not None:
            x0 = x0[:, 0]
    check_complex_codec(op, b, "solve_cg")
    check_precision("solve_cg")
    bf = _to_field(op, b)
    x0f = torch.zeros_like(bf) if x0 is None else _to_field(op, x0)
    xf, info = _cg_impl(op, bf, x0f, tol, max_iter, record_history)
    x = _from_field(op, xf)
    return (x[:, None] if unsqueeze else x), info
