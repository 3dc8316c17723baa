"""BCGA: block CG with A-orthonormal directions (Dubrulle 2001).

Counterpart of ``blockcg_tpu/solvers/bcga.py``. Each iteration normalizes
the direction block in the A-inner product,

    M = P^H A P = L L^H ;   P~ = P L^{-H} ,  Z~ = A P~ = Z L^{-H},

after which the coefficient systems trivialize (P~^H A P~ = I):

    alpha = P~^H R ;  X += P~ alpha ;  R -= Z~ alpha
    beta  = -Z~^H R ;  P_next = R + P~ beta.

In exact arithmetic this is BCG along another rounding path: the normalized
directions cannot grow or collapse in scale, so the k x k algebra stays well
conditioned without BCGdQ's thin QR. The normalization is MATERIALIZED (P~
and Z~ are formed, and alpha and beta cost two Grams that BCG's recurrences
get for free). Folding L^{-H} into the coefficients instead would be the
same algebra but BCG's rounding, which would defeat the variant.

As in BCG, the reported relres is the monitor ``sqrt(diag S)``. One host read
per iteration: the stop test.
"""

from __future__ import annotations

from typing import Any

import torch

from blockcg_tpu_torch.solvers.bcg import block_info, block_monitor
from blockcg_tpu_torch.solvers.common import (
    block_setup,
    f_gram,
    f_matmat_gram,
    f_mm_update,
    f_xr_update_gram,
    safe_cholesky,
)
from blockcg_tpu_torch.types import SolverInfo


def _bcga_impl(op, Bt, X0t, tol, max_iter, record_history):
    bnorm2, tol2 = block_monitor(Bt, tol, op)
    Rt = Bt - op.matmat_t(X0t)
    S = f_gram(Rt, Rt, codec=op)
    k = S.shape[0]
    eye = torch.eye(k, dtype=S.dtype, device=S.device)
    Xt, Pt = X0t, Rt.clone()
    hist = (torch.full((max_iter,), torch.nan, dtype=bnorm2.dtype, device=Bt.device)
            if record_history else None)
    it = 0
    while it < max_iter and bool((torch.diagonal(S).real > tol2).any()):
        Zt, M = f_matmat_gram(op, Pt)  # Z = A P, M = P^H A P
        # A-orthonormalize: lanes-major P~t = conj(L)^{-1} Pt, and Z~ rides
        # the same transform (no second apply). P and Z are dead after.
        L = safe_cholesky(M)
        G1 = torch.linalg.solve_triangular(L.conj(), eye, upper=False)
        Pn_t = f_mm_update(G1, Pt, codec=op, donate="b")
        Zn_t = f_mm_update(G1, Zt, codec=op, donate="b")
        alpha = f_gram(Pn_t, Rt, codec=op)  # P~^H R
        # X and R are dead after this; P~ and Z~ stay live for beta.
        Xt, Rt, S_new = f_xr_update_gram(alpha.T, Pn_t, Xt, Zn_t, Rt, codec=op,
                                         donate=True)
        beta = -f_gram(Zn_t, Rt, codec=op)  # -Z~^H R_new
        Pt = f_mm_update(beta.T, Pn_t, Rt, codec=op, donate="b")
        S = S_new
        if hist is not None:
            hist[it] = torch.sqrt((torch.diagonal(S).real / bnorm2).max())
        it += 1
    return Xt, block_info(S, bnorm2, tol, it, hist)


def solve_bcga(
    op: Any,
    B: torch.Tensor,
    X0: torch.Tensor | None = None,
    *,
    tol: float = 1e-6,
    max_iter: int = 1000,
    record_history: bool = False,
) -> tuple[torch.Tensor, SolverInfo]:
    """Solve ``A X = B`` by BCGA, block CG with A-orthonormal directions.

    Same stop rule as ``solve_bcg``; about 8 more field passes per iteration
    buy scale-stable directions. Returns (X (n, k), SolverInfo); ``B`` and
    ``X0`` are not modified.
    """
    Bt, X0t = block_setup(op, B, X0, "solve_bcga")
    Xt, info = _bcga_impl(op, Bt, X0t, tol, max_iter, record_history)
    return op.from_internal(Xt).T, info
