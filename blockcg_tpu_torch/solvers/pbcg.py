"""Preconditioned block CG (O'Leary 1980, preconditioned form), and SBCGrQ
with its thin QR in the M-inner product.

Counterpart of ``blockcg_tpu/solvers/pbcg.py``. With a general SPD
preconditioner M ~ A^{-1}, applied as an operator:

    R = B - A X ;  Z = M R ;  P = Z ;  S = Z^H R
    loop:
        W     = A P                       # the hot SpMM, Gram fused
        alpha = (P^H W)^{-1} S
        X    += P alpha ;  R -= W alpha   # R's update fused with R R^H
        Z     = M R
        S'    = Z^H R ;  beta = S^{-1} S' ;  S = S'
        P     = Z + P beta

M acts on the same internal field view as ``op``: build it with
``jacobi_preconditioner(op)``, or wrap a custom operator that shares
``op.to_internal``. PBCG monitors the true residual norms (the diagonal of
the fused R R^H Gram); PSBCGrQ monitors the M-norm of the residual.

The M-apply of ``JacobiPreconditioner`` is one elementwise product, which
the reference leaves to XLA too: no kernel of its own. One host read per
iteration, the stop test, as in every solver of the port. Fields dead after
an update are overwritten in place (``donate``).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from blockcg_tpu_torch.solvers.bcg import block_monitor
from blockcg_tpu_torch.solvers.common import (
    acc_dtype,
    block_setup,
    chol_inverse_spd,
    chol_solve_spd,
    f_gram,
    f_matmat_gram,
    f_mm_update,
    f_mm_update_gram,
    kk_mm,
    qr_factors_from_gram,
    row_norms2_t,
)
from blockcg_tpu_torch.types import SolverInfo


class JacobiPreconditioner(nn.Module):
    """Elementwise M = diag(A)^{-1} in the owning operator's internal field
    layout: ``dinv_int`` is the inverse diagonal already converted, (1, n)
    for flat fields, (bs, ns) with one row per spin for the merged
    spin-major layouts. On those, ``apply_t`` repeats each spin row over the
    k rows of the field (``repeat_interleave``, the reference's
    ``jnp.repeat``); the repeated (m, ns) factor is built once per k."""

    def __init__(self, dinv_int: torch.Tensor):
        super().__init__()
        self.register_buffer("dinv_int", dinv_int)
        # k -> (the dinv_int it was built from, the repeated factor); moving
        # the module replaces the buffer, which rebuilds the entry.
        self._repeated: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    def apply_t(self, Ft: torch.Tensor) -> torch.Tensor:
        d = self.dinv_int
        if d.shape[0] != Ft.shape[0] and d.shape[0] > 1:
            k = Ft.shape[0] // d.shape[0]
            src, r = self._repeated.get(k, (None, None))
            if src is not d:
                r = torch.repeat_interleave(d, k, dim=0)
                self._repeated[k] = (d, r)
            d = r
        return Ft * d  # a (1, n) factor broadcasts over the k rows


def jacobi_preconditioner(op) -> JacobiPreconditioner:
    """diag(A)^{-1} for operators that expose their diagonal: DIAOperator
    (the offset-0 diagonal), DenseOperator, and ConstBlockDIAOperator with a
    scalar site-diagonal hop. The const-hop factor of an unmasked diagonal
    hop is float32 whatever the operator's dtype, as the reference builds
    it."""
    from blockcg_tpu_torch.operators.cbdia import ConstBlockDIAOperator
    from blockcg_tpu_torch.operators.dense import DenseOperator
    from blockcg_tpu_torch.operators.dia import DIAOperator

    if isinstance(op, DIAOperator):
        if 0 not in op.offsets:
            raise ValueError("operator has no main diagonal")
        d = op.diags[op.offsets.index(0)]
        return JacobiPreconditioner((1.0 / d)[None, :])
    if isinstance(op, DenseOperator):
        return JacobiPreconditioner((1.0 / torch.diagonal(op.A))[None, :])
    if isinstance(op, ConstBlockDIAOperator):
        if 0 not in op.offsets:
            raise ValueError("operator has no site-diagonal hop")
        d0 = op.offsets.index(0)
        h = np.asarray(op.hops[d0])
        if not np.allclose(h, np.diag(np.diag(h))) or np.ptp(np.diag(h)) != 0:
            raise ValueError(
                "ConstBlockDIA diagonal hop is not a scalar multiple of I; "
                "provide a custom preconditioner")
        c = float(np.diag(h)[0])
        ms = op.mask_slot[d0]
        if ms >= 0:
            dvec = c * op.masks[ms]
            dinv = torch.where(dvec != 0, 1.0 / dvec, 0.0)
        else:
            dinv = torch.full((op.ns,), 1.0 / c, dtype=torch.float32,
                              device=op.hops_all.device)
        return JacobiPreconditioner(dinv[None, :].repeat(op.bs, 1))
    raise TypeError(f"jacobi_preconditioner: unsupported operator {type(op).__name__}")


def _apply_m(M, Ft):
    if hasattr(M, "apply_t"):
        return M.apply_t(Ft)
    return M.matmat_t(Ft)


def _pbcg_impl(op, M, Bt, X0t, tol, max_iter, record_history):
    bnorm2, tol2 = block_monitor(Bt, tol, op)
    Rt = Bt - op.matmat_t(X0t)
    Zt = _apply_m(M, Rt)
    S = f_gram(Zt, Rt, codec=op)
    res2 = row_norms2_t(Rt, codec=op)
    Xt, Pt = X0t, Zt
    hist = (torch.full((max_iter,), torch.nan, dtype=bnorm2.dtype, device=Bt.device)
            if record_history else None)
    it = 0
    # The stop test on the true residual norms: the iteration's one host read.
    while it < max_iter and bool((res2 > tol2).any()):
        Wt, T = f_matmat_gram(op, Pt)  # W = A P, T = P^H A P
        alpha = chol_solve_spd(T, S)
        Xt = f_mm_update(alpha.T, Pt, Xt, codec=op, donate="a")
        # R's update with its Gram: diag(R R^H) are the true residual norms.
        # W is dead after it, so R' overwrites W.
        Rt, RR = f_mm_update_gram(-alpha.T, Wt, Rt, codec=op, donate=True)
        res2 = torch.diagonal(RR).real
        Zt = _apply_m(M, Rt)
        S_new = f_gram(Zt, Rt, codec=op)
        beta = chol_solve_spd(S, S_new)
        Pt = f_mm_update(beta.T, Pt, Zt, codec=op, donate="b")
        S = S_new
        if hist is not None:
            hist[it] = torch.sqrt((res2 / bnorm2).max())
        it += 1
    relres = torch.sqrt(res2 / bnorm2)
    info = SolverInfo(iterations=it, relres=relres, converged=relres <= tol,
                      matvecs=it + 1, history=hist)
    return Xt, info


def solve_pbcg(
    op: Any,
    B: torch.Tensor,
    M: Any,
    X0: torch.Tensor | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    record_history: bool = False,
) -> tuple[torch.Tensor, SolverInfo]:
    """Solve ``A X = B`` by preconditioned block CG with SPD ``M ~ A^{-1}``.

    ``M`` is a JacobiPreconditioner (``jacobi_preconditioner(op)``) or any
    object with ``apply_t`` or ``matmat_t`` acting on ``op``'s internal field
    view. Stops at ``||R e_j|| <= tol ||B e_j||`` for every column, on the
    true residual norms. Without preconditioning use ``solve_bcg``. Returns
    (X (n, k), SolverInfo); ``B`` and ``X0`` are not modified."""
    Bt, X0t = block_setup(op, B, X0, "solve_pbcg")
    Xt, info = _pbcg_impl(op, M, Bt, X0t, tol, max_iter, record_history)
    return op.from_internal(Xt).T, info


def _psbcgrq_impl(op, M, Bt, X0t, tol, max_iter, qr_passes, record_history, group=None):
    """Preconditioned SBCGrQ: Dubrulle's rQ stabilization in the M-inner
    product. Residuals factor as R = Q S with Q^H M Q = I (M-CholQR: G =
    V^H (M V), Q = V L^{-H}); the direction seed is P = M Q + P rho^H. It
    reduces to SBCGrQ at M = I and to PCG at k = 1. The per-RHS monitor
    ``||S e_j||`` is the M-norm of the residual, relative to ``||B_j||_M``."""
    rdtype = acc_dtype(Bt.real.dtype)
    MB = _apply_m(M, Bt)
    bnorm = torch.sqrt(torch.clamp_min(
        torch.diagonal(f_gram(Bt, MB, codec=op, group=group)).real, 0.0))
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    tol_arr = torch.as_tensor(tol, dtype=rdtype, device=Bt.device)

    def cholqr_m(Vt, passes):
        """M-inner-product CholeskyQR: (Qt, MQt, R) with Q^H M Q = I and
        V = Q R; M Q comes from M V by linearity on the last pass."""
        rho = None
        Qt, MQt = Vt, _apply_m(M, Vt)
        for p in range(passes):
            G = f_gram(Qt, MQt, codec=op, group=group)
            Mi, Ri = qr_factors_from_gram(G)
            rho = Ri if rho is None else kk_mm(Ri, rho)
            Qt = f_mm_update(Mi, Qt, codec=op)
            if p < passes - 1:
                MQt = _apply_m(M, Qt)  # re-measured (CholeskyQR2)
            else:
                MQt = f_mm_update(Mi, MQt, codec=op)  # M Q = Mi (M V)
        return Qt, MQt, rho

    def relres_of(S):
        return torch.sqrt((S * S.conj()).real.sum(dim=0)) / bnorm

    Qt, Pt, S = cholqr_m(Bt - op.matmat_t(X0t), qr_passes)  # P0 = M Q0
    Xt = X0t
    hist = (torch.full((max_iter,), torch.nan, dtype=rdtype, device=Bt.device)
            if record_history else None)
    it = 0
    while it < max_iter and bool((relres_of(S) > tol_arr).any()):  # the host read
        Wt, T = f_matmat_gram(op, Pt, group)  # W = A P, T = P^H A P
        alpha_t = chol_inverse_spd(T).conj()
        Xt = f_mm_update(kk_mm(S.T, alpha_t), Pt, Xt, codec=op, donate="a")
        # V = Q - W alpha; W is dead after it.
        Vt = f_mm_update(-alpha_t, Wt, Qt, codec=op, donate="b")
        Qt, MQt, rho = cholqr_m(Vt, qr_passes)
        S = kk_mm(rho, S)
        Pt = f_mm_update(rho.conj(), Pt, MQt, codec=op, donate="b")  # M Q + P rho^H
        if hist is not None:
            hist[it] = relres_of(S).max()
        it += 1
    relres = relres_of(S)
    info = SolverInfo(iterations=it, relres=relres, converged=relres <= tol_arr,
                      matvecs=it + 1, history=hist)
    return Xt, info


def solve_psbcgrq(
    op: Any,
    B: torch.Tensor,
    M: Any,
    X0: torch.Tensor | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    qr_passes: int = 2,
    record_history: bool = False,
) -> tuple[torch.Tensor, SolverInfo]:
    """Preconditioned stabilized block CG: SBCGrQ with its thin QR in the
    M-inner product (M SPD, applied as an operator, as in ``solve_pbcg``).
    Convergence is monitored in the M-norm; the 2-norm residual can exceed it
    by up to ``sqrt(kappa(M))``. Reduces to ``solve_sbcgrq`` at M = I."""
    if qr_passes < 1:
        raise ValueError("qr_passes must be >= 1")
    Bt, X0t = block_setup(op, B, X0, "solve_psbcgrq")
    Xt, info = _psbcgrq_impl(op, M, Bt, X0t, tol, max_iter, qr_passes, record_history)
    return op.from_internal(Xt).T, info
