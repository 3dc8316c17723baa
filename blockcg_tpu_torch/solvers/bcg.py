"""Block CG (O'Leary 1980): all k right-hand sides share one block Krylov
space; the per-iteration coefficients are k x k SPD solves.

Counterpart of ``blockcg_tpu/solvers/bcg.py``. Lanes-major, the recurrence
reads

    Xt += alpha^T Pt ;  Rt -= alpha^T Zt ;  Pt = Rt + beta^T Pt

with the X and R updates and the next Gram ``S' = R R^T`` in one fused pass
(``xr_update_gram``). The reported relres is the monitor ``sqrt(diag S)``,
not the true residual: BCG has no residual replacement, so in f32 the two
drift apart (the reference's caveat, kept as it is).

One host read per iteration: the stop test on ``diag S``.
"""

from __future__ import annotations

from typing import Any

import torch

from blockcg_tpu_torch.solvers.common import (
    acc_dtype,
    block_setup,
    chol_solve_spd,
    f_gram,
    f_matmat_gram,
    f_mm_update,
    f_xr_update_gram,
    row_norms2_t,
)
from blockcg_tpu_torch.types import SolverInfo


def block_monitor(Bt, tol, codec, group=None):
    """(squared RHS norms, squared per-RHS thresholds) of the BCG family's
    stop test ``sqrt(diag S) <= tol ||B e_j||``."""
    bnorm2 = row_norms2_t(Bt, codec=codec, group=group)
    bnorm2 = torch.where(bnorm2 > 0, bnorm2, torch.ones_like(bnorm2))
    tol_t = torch.as_tensor(tol, dtype=acc_dtype(Bt.real.dtype), device=Bt.device)
    return bnorm2, tol_t ** 2 * bnorm2


def block_info(S, bnorm2, tol, it, hist) -> SolverInfo:
    relres = torch.sqrt(torch.diagonal(S).real / bnorm2)
    return SolverInfo(iterations=it, relres=relres, converged=relres <= tol,
                      matvecs=it + 1, history=hist)


def _bcg_impl(op, Bt, X0t, tol, max_iter, record_history, group=None):
    bnorm2, tol2 = block_monitor(Bt, tol, op, group)
    Rt = Bt - op.matmat_t(X0t)
    S = f_gram(Rt, Rt, codec=op, group=group)
    Xt, Pt = X0t, Rt.clone()  # P is updated in place, R and X by donation
    hist = (torch.full((max_iter,), torch.nan, dtype=bnorm2.dtype, device=Bt.device)
            if record_history else None)
    it = 0
    # The stop test: the iteration's one host read.
    while it < max_iter and bool((torch.diagonal(S).real > tol2).any()):
        Zt, M = f_matmat_gram(op, Pt, group)  # Z = A P, M = P^T A P
        alpha = chol_solve_spd(M, S)  # M alpha = S
        # X and R are dead after this; P and Z stay live.
        Xt, Rt, S_new = f_xr_update_gram(alpha.T, Pt, Xt, Zt, Rt, codec=op, donate=True,
                                         group=group)
        beta = chol_solve_spd(S, S_new)  # S beta = S'
        Pt = f_mm_update(beta.T, Pt, Rt, codec=op, donate="b")
        S = S_new
        if hist is not None:
            hist[it] = torch.sqrt((torch.diagonal(S).real / bnorm2).max())
        it += 1
    return Xt, block_info(S, bnorm2, tol, it, hist)


def solve_bcg(
    op: Any,
    B: torch.Tensor,
    X0: torch.Tensor | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    record_history: bool = False,
) -> tuple[torch.Tensor, SolverInfo]:
    """Solve ``A X = B`` (A SPD, B an (n, k) block) by O'Leary block CG.

    Every RHS must reach ``||R e_j|| <= tol ||B e_j||`` as the recurrence
    reports it. Prefer ``solve_sbcgrq`` when k is large or iteration counts
    are high: plain BCG loses rank in its Grams as columns converge. Returns
    (X (n, k), SolverInfo); ``B`` and ``X0`` are not modified.
    """
    Bt, X0t = block_setup(op, B, X0, "solve_bcg")
    Xt, info = _bcg_impl(op, Bt, X0t, tol, max_iter, record_history)
    return op.from_internal(Xt).T, info
