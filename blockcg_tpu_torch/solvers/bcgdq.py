"""BCGdQ: block CG with a thin-QR-orthonormalized direction block.

Counterpart of ``blockcg_tpu/solvers/bcgdq.py``, a rung of Dubrulle's
ladder (BCG -> BCGA -> BCGdQ -> BCGrQ; ``solve_bcgrq`` is ``solve_sbcgrq``).
The direction block P is replaced by an orthonormal W, which keeps the k x k
Gram ``W^H A W`` well conditioned when BCG's ``P^H A P`` degenerates as
right-hand sides converge:

    R = B - A X0 ;  [W, ~] = thinQR(R)
    loop:
        Z     = A W ;  M = W^H Z
        alpha = M^{-1} (W^H R)
        X    += W alpha ;  R -= Z alpha
        beta  = -M^{-1} (Z^H R)
        [W, ~] = thinQR(R + W beta)

Every field step runs through the fused kernels, and the QRs take their
Grams from the fused updates. As in BCG, the reported relres is the monitor
``sqrt(diag S)``. Host reads per iteration: the stop test, and kappa_1 at
``qr_passes=1``.
"""

from __future__ import annotations

from typing import Any

import torch

from blockcg_tpu_torch.solvers.bcg import block_info, block_monitor
from blockcg_tpu_torch.solvers.common import (
    block_setup,
    chol_solve_spd,
    cholqr_fused_t,
    f_gram,
    f_matmat_gram,
    f_mm_update,
    f_mm_update_gram,
    qr_passes_from_gram,
)
from blockcg_tpu_torch.types import SolverInfo


def _bcgdq_impl(op, Bt, X0t, tol, max_iter, qr_passes, record_history):
    bnorm2, tol2 = block_monitor(Bt, tol, op)
    Rt = Bt - op.matmat_t(X0t)
    Wt, _ = cholqr_fused_t(Rt, passes=qr_passes, codec=op)
    S = f_gram(Rt, Rt, codec=op)
    Xt = X0t
    hist = (torch.full((max_iter,), torch.nan, dtype=bnorm2.dtype, device=Bt.device)
            if record_history else None)
    it = 0
    while it < max_iter and bool((torch.diagonal(S).real > tol2).any()):
        Zt, M = f_matmat_gram(op, Wt)  # W^H A W (k x k HPD)
        g = f_gram(Wt, Rt, codec=op)  # W^H R
        alpha = chol_solve_spd(M, g)
        Xt = f_mm_update(alpha.T, Wt, Xt, codec=op, donate="a")
        # Z is read again below, so R_new goes to a new buffer (the
        # reference donates Z here, and its XLA inserts the copy).
        Rt, S_new = f_mm_update_gram(-alpha.T, Zt, Rt, codec=op)
        h = f_gram(Zt, Rt, codec=op)  # Z^H R
        beta = -chol_solve_spd(M, h)
        Vt, Gv = f_mm_update_gram(beta.T, Wt, Rt, codec=op, donate=True)  # W dead
        M1, Vt, _rho = qr_passes_from_gram(Gv, Vt, qr_passes, codec=op)
        Wt = f_mm_update(M1, Vt, codec=op, donate="b")
        S = S_new
        if hist is not None:
            hist[it] = torch.sqrt((torch.diagonal(S).real / bnorm2).max())
        it += 1
    return Xt, block_info(S, bnorm2, tol, it, hist)


def solve_bcgdq(
    op: Any,
    B: torch.Tensor,
    X0: torch.Tensor | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    qr_passes: int = 1,
    record_history: bool = False,
) -> tuple[torch.Tensor, SolverInfo]:
    """Solve ``A X = B`` by block CG with QR'd directions (Dubrulle BCGdQ).

    ``qr_passes`` as in ``solve_sbcgrq`` (1: adaptive second pass, 2:
    CholeskyQR2). Returns (X (n, k), SolverInfo); ``B`` and ``X0`` are not
    modified.
    """
    if qr_passes < 1:
        raise ValueError("qr_passes must be >= 1")
    Bt, X0t = block_setup(op, B, X0, "solve_bcgdq")
    Xt, info = _bcgdq_impl(op, Bt, X0t, tol, max_iter, qr_passes, record_history)
    return op.from_internal(Xt).T, info
