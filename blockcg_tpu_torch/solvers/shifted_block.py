"""Multi-shift block CG: shifted SBCGrQ.

Counterpart of ``blockcg_tpu/solvers/shifted_block.py``. Solves
``(A + sigma_j I) X_j = B`` for many shifts sigma_j >= 0 and an (n, k) block
with ONE block Krylov space: one apply per iteration for all shifts.

SBCGrQ's orthonormal residual blocks Q_0, Q_1, ... are a block Lanczos basis,
``A [Q_0..Q_I] = [Q_0..Q_{I+1}] T`` with the Hermitian block tridiagonal

    T_ii      = M_i + rho_i M_{i-1} rho_i^H          (rho_0 = 0)
    T_{i+1,i} = -rho_{i+1} M_i ,

(M_i = P_i^H A P_i, rho_i the CholeskyQR factors). The space is shift
invariant, so the Galerkin solution of shift sigma is X_sigma = [Q_0..Q_I] y
with (T + sigma I) y = E_1 S_0, built by an incremental block LDL^H:

    Delta_0 = T_00 + sigma
    Lambda_{i-1} = T_{i,i-1} Delta_{i-1}^{-1}
    Delta_i = T_ii + sigma - Lambda_{i-1} Delta_{i-1} Lambda_{i-1}^H
    z_0 = S_0,   z_i = -Lambda_{i-1} z_{i-1}                (k x k)
    C_0 = Q_0,   C_i = Q_i - C_{i-1} Lambda_{i-1}^H         (n x k)
    X_sigma += C_i (Delta_i^{-1} z_i)

and the shifted residual is ``Q_{i+1} rho_{i+1} M_i Delta_i^{-1} z_i``, whose
column norms are the per-RHS residual norms (k x k work).

The shift axis is a written-out leading batch dimension: per shift two
internal fields (C and X) and a few k x k blocks. Their updates are batched
``torch.matmul`` with each shift's coefficient expanded by the operator's
codec (XLA products in the reference). The seed's tail is the fused
``qr_p_update``. One host read per iteration (the stop test), plus kappa_1
at ``qr_passes=1``.
"""

from __future__ import annotations

from typing import Any

import torch

from blockcg_tpu_torch.solvers.common import (
    _ce,
    acc_dtype,
    check_precision,
    check_complex_codec,
    chol_inverse_spd,
    cholqr_fused_t,
    f_matmat_gram,
    f_mm_update_gram,
    f_qr_p_update,
    kk_mm,
    qr_passes_from_gram,
    row_norms2_t,
)
from blockcg_tpu_torch.types import SolverInfo


def _smm_f(op, a, b):
    """Batched coefficient-times-field product over the shift axis,
    (nshift, k, k) @ (nshift, m, ...): each (k, k) of the stack is expanded
    to the operator's internal rows (codec) first."""
    out = torch.stack([_ce(op, c) for c in a]) @ b.reshape(b.shape[0], b.shape[1], -1)
    return out.reshape(b.shape)


def _shifted_sbcgrq_impl(op, Bt, sigmas, tol, max_iter, qr_passes, record_history,
                         group=None):
    dtype, dev = Bt.dtype, Bt.device
    rdtype = acc_dtype(Bt.real.dtype)
    ns = sigmas.shape[0]
    bnorm = torch.sqrt(row_norms2_t(Bt, codec=op, group=group))
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    tol_arr = torch.as_tensor(tol, dtype=rdtype, device=dev)

    Qt, S0 = cholqr_fused_t(Bt, passes=qr_passes, codec=op, group=group)
    # k from the contracted QR factor: merged layouts carry m = bs*k rows.
    k = S0.shape[0]
    eye = torch.eye(k, dtype=dtype, device=dev)
    shift_eye = sigmas[:, None, None].to(dtype) * eye

    def relres_of(coef):
        # coef: (nshift, k, k) = rho_{i+1} M_i Delta_i^{-1} z_i
        return torch.sqrt((coef * coef.conj()).real.sum(dim=1)) / bnorm[None, :]

    Xs = torch.zeros((ns,) + Bt.shape, dtype=dtype, device=dev)
    Cs = torch.zeros((ns,) + Bt.shape, dtype=dtype, device=dev)  # C_{-1} = 0
    Pt = Qt
    rho_prev = torch.zeros((k, k), dtype=dtype, device=dev)  # rho_0 = 0
    M_prev = eye  # unused while rho_0 = 0
    Dinv_prev = eye.expand(ns, k, k)  # unused while rho_0 = 0
    z = S0.expand(ns, k, k)
    rel = torch.full((ns, k), torch.inf, dtype=rdtype, device=dev)
    hist = (torch.full((max_iter,), torch.nan, dtype=rdtype, device=dev)
            if record_history else None)
    it = 0
    while it < max_iter and bool((rel > tol_arr).any()):  # the host read
        Zt, M = f_matmat_gram(op, Pt, group)  # P^H A P = alpha^{-1}
        alpha = chol_inverse_spd(M)

        # ---- per-shift incremental block LDL^H step (all k x k)
        rmp = kk_mm(rho_prev, M_prev)  # rho_i M_{i-1}
        D = M + kk_mm(rmp, rho_prev.mH)
        Lam = -(rmp @ Dinv_prev)
        Delta = D[None] + shift_eye + Lam @ rmp.mH
        if it > 0:
            z = -(Lam @ z)
        # C_i = Q_i - C_{i-1} Lambda^H: lanes-major Ct = Qt - conj(Lam) Ct
        Cs = Qt[None] - _smm_f(op, Lam.conj(), Cs)
        Dinv = chol_inverse_spd(Delta)
        eta = Dinv @ z  # Delta^{-1} z
        # X_sigma += C eta: lanes-major Xs += eta^T Cs
        Xs = Xs + _smm_f(op, eta.transpose(1, 2), Cs)

        # ---- seed SBCGrQ update (the shared Krylov engine). Z is dead after
        # V, and Q1 and P after the tail: both donate.
        Vt, G = f_mm_update_gram(-alpha.conj(), Zt, Qt, codec=op, donate=True, group=group)
        Mi, Wt, rho = qr_passes_from_gram(G, Vt, qr_passes, codec=op, group=group)
        Qt, Pt = f_qr_p_update(Mi, Wt, rho.conj(), Pt, codec=op, donate=True)

        # shifted residual coefficient: rho_{i+1} M_i eta
        rel = relres_of(kk_mm(rho, M) @ eta)
        rho_prev, M_prev, Dinv_prev = rho, M, Dinv
        if hist is not None:
            hist[it] = rel.max()
        it += 1

    info = SolverInfo(iterations=it, relres=rel, converged=rel <= tol_arr,
                      matvecs=it,  # Q_0 is the QR of B: no set-up apply
                      history=hist)
    return Xs, info


def solve_shifted_sbcgrq(
    op: Any,
    B: torch.Tensor,
    sigmas,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    qr_passes: int = 2,
    record_history: bool = False,
) -> tuple[torch.Tensor, SolverInfo]:
    """Solve ``(A + sigma_j I) X_j = B`` for all shifts with one Krylov space.

    ``op`` is SPD, ``B`` an (n, k) block shared by every shift, ``sigmas``
    the (nshift,) non-negative shifts (include 0.0 for the seed). Returns
    (Xs (nshift, n, k), SolverInfo) with ``relres`` (nshift, k) per shift
    and RHS; ``matvecs`` counts one apply per iteration for all shifts.
    ``B`` is not modified.
    """
    if B.dim() == 1:
        raise ValueError("solve_shifted_sbcgrq expects an (n, k) block")
    if qr_passes < 1:
        raise ValueError("qr_passes must be >= 1")
    check_complex_codec(op, B, "solve_shifted_sbcgrq")
    check_precision("solve_shifted_sbcgrq")
    sig = torch.atleast_1d(torch.as_tensor(sigmas, dtype=acc_dtype(B.real.dtype),
                                           device=B.device))
    Bt = op.to_internal(B.T.contiguous())
    Xs, info = _shifted_sbcgrq_impl(op, Bt, sig, tol, max_iter, qr_passes,
                                    record_history)
    return torch.stack([op.from_internal(Xs[j]).T for j in range(sig.shape[0])]), info
