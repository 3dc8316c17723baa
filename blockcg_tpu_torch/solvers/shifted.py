"""Multi-shift CG: ``(A + sigma_j I) x_j = b`` for many shifts with one
Krylov space.

Counterpart of ``blockcg_tpu/solvers/shifted.py`` (Jegerlehner,
hep-lat/9612014): one apply per iteration for all shifts, the shifted
residuals kept collinear with the seed's, ``r_sigma = zeta_sigma r``, through
a three-term scalar recurrence. The seed system is sigma = 0. Per-shift state
carries a leading ``nshift`` axis over the lanes-major single-row field.

Converged shifts are frozen on the device (their zeta and step are held),
and the per-shift squared residual is carried, so a frozen shift reports the
norm at which it froze. One host read per iteration: the stop test.
"""

from __future__ import annotations

from typing import Any

import torch

from blockcg_tpu_torch.solvers.cg import _from_field, _to_field
from blockcg_tpu_torch.solvers.common import (
    acc_dtype,
    check_precision,
    check_complex_codec,
    f_matmat_gram,
    row_norms2_t,
)
from blockcg_tpu_torch.types import SolverInfo


def _shifted_cg_impl(op, b, sigmas, tol, max_iter, record_history):
    """``b`` is a (1, ...) internal field; per-shift fields are (nshift, 1, ...)."""
    rdtype = acc_dtype(b.real.dtype)
    dev = b.device
    nshift = sigmas.shape[0]
    fdims = (slice(None),) + (None,) * b.dim()  # (nshift,) -> fields
    bnorm2 = row_norms2_t(b, codec=op)[0]
    bnorm2 = torch.where(bnorm2 > 0, bnorm2, torch.ones_like(bnorm2))
    tol2 = torch.as_tensor(tol, dtype=rdtype, device=dev) ** 2 * bnorm2

    r, p, rho = b, b, bnorm2
    xs = torch.zeros((nshift,) + b.shape, dtype=b.dtype, device=dev)
    ps = b.expand((nshift,) + b.shape).clone()
    # The recurrence scalars are real for symmetric A and real shifts.
    zeta = torch.ones(nshift, dtype=rdtype, device=dev)  # zeta^i
    zeta_m = torch.ones(nshift, dtype=rdtype, device=dev)  # zeta^{i-1}
    a_old = torch.ones((), dtype=rdtype, device=dev)
    b_old = torch.zeros((), dtype=rdtype, device=dev)
    res2 = bnorm2.expand(nshift).clone()
    hist = (torch.full((max_iter,), torch.nan, dtype=rdtype, device=dev)
            if record_history else None)
    it = 0
    while it < max_iter and bool((res2 > tol2).any()):  # the host read
        z, M = f_matmat_gram(op, p)
        alpha = rho / M[0, 0].real
        # zeta recurrence (seed sigma = 0)
        num = zeta * zeta_m * a_old
        den = alpha * b_old * (zeta_m - zeta) + zeta_m * a_old * (1.0 + sigmas * alpha)
        zeta_new = num / den
        alpha_s = alpha * zeta_new / zeta
        # freeze converged shifts (their zeta and den can degenerate)
        active = res2 > tol2
        zeta_new = torch.where(active, zeta_new, zeta)
        alpha_s = torch.where(active, alpha_s, torch.zeros_like(alpha_s))

        xs = xs + alpha_s[fdims] * ps
        r_new = r - alpha * z
        rho_new = row_norms2_t(r_new, codec=op)[0]
        beta = rho_new / rho
        beta_s = beta * (zeta_new / zeta) ** 2
        ps = zeta_new[fdims] * r_new[None] + beta_s[fdims] * ps
        p = r_new + beta * p
        res2 = torch.where(active, zeta_new * zeta_new * rho_new, res2)
        r, rho, zeta_m, zeta, a_old, b_old = r_new, rho_new, zeta, zeta_new, alpha, beta
        if hist is not None:
            hist[it] = torch.sqrt(res2.max() / bnorm2)
        it += 1

    relres = torch.sqrt(res2 / bnorm2)
    info = SolverInfo(iterations=it, relres=relres, converged=relres <= tol,
                      matvecs=it, history=hist)
    return xs, info


def solve_shifted_cg(
    op: Any,
    b: torch.Tensor,
    sigmas,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    record_history: bool = False,
) -> tuple[torch.Tensor, SolverInfo]:
    """Solve ``(A + sigma_j I) x_j = b`` for all shifts at once.

    ``op`` is the unshifted SPD operator (the seed system), ``b`` an (n,)
    right-hand side and ``sigmas`` the (nshift,) shifts, each >= 0. Returns
    (X (n, nshift), SolverInfo) with per-shift ``relres`` and ``converged``;
    ``matvecs`` counts one apply per iteration for all shifts.
    """
    if b.dim() != 1:
        raise ValueError("solve_shifted_cg expects a single (n,) RHS")
    check_complex_codec(op, b, "solve_shifted_cg")
    check_precision("solve_shifted_cg")
    sig = torch.as_tensor(sigmas, dtype=acc_dtype(b.real.dtype), device=b.device)
    bf = _to_field(op, b)
    xs, info = _shifted_cg_impl(op, bf, sig, tol, max_iter, record_history)
    cols = [_from_field(op, xs[j]) for j in range(sig.shape[0])]
    return torch.stack(cols, dim=1), info
