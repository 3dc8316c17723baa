"""SBCGrQ: thin-QR-stabilized block CG, the flagship solver.

Counterpart of ``blockcg_tpu/solvers/sbcgrq.py``; recurrence (Dubrulle's rQ
stabilization):

    [Q, S] = thinQR(B - A X0);  P = Q
    loop:
        Z   = A P                          # the hot SpMM
        a   = (P^T Z)^{-1}                 # k x k Cholesky inverse
        X  += P (a S)
        [Q, r] = thinQR(Q - Z a)           # re-orthonormalize the residual
        S   = r S                          # true residual R = Q S throughout
        P   = Q + P r^T

Q is never materialized: the residual basis is carried as the pair
``(M_qr, W)`` with ``Q = M_qr @ W``, so one iteration is the fused SpMM+Gram,
``mm2_update_gram`` and ``px_update`` (plus ``mm_update_gram`` for a second
QR pass). Per-RHS residual norms are the column norms of the k x k ``S``.

The reference's ``lax.while_loop`` is a Python loop here, with one host read
of the number of unconverged columns per iteration (the stop test), so
iteration counts match the reference's; the adaptive second QR pass
(``qr_passes=1``) and the kappa-triggered replacement read kappa_1 on the
host too. Fields that are dead after an update are overwritten in place
(``donate``).

bf16 fields (the capacity route, ``solve_refined_lean``): X, P, W, Z and V
stay bf16 and go through the kernels' bf16 variants; the k x k algebra, the
Grams and the monitors run in ``acc_dtype`` (f32), as in the reference
(``blockcg_tpu/solvers/sbcgrq.py:100``).

Residual replacement: every ``replace_every`` iterations, or when the QR
Gram's kappa_1 exceeds ``replace_kappa``, the true residual is recomputed with
one extra SpMM. ``replace_mode="restart"`` resets P to the fresh Q;
``"rebase"`` keeps P and re-expresses the fresh factorization in the old Q
basis (exact in f64, not safe in f32; see the reference's module docstring).
"""

from __future__ import annotations

from typing import Any

import torch

from blockcg_tpu_torch.solvers.common import (
    acc_dtype,
    block_setup,
    chol_inverse_spd,
    f_gram,
    f_matmat_gram,
    f_mm2_update_gram,
    f_mm_update,
    f_px_update,
    kk_mm,
    qr_passes_from_gram,
    residual_rebase,
    row_norms2_t,
)
from blockcg_tpu_torch.types import SolverInfo


def _sbcgrq_impl(op, Bt, X0t, tol, max_iter, qr_passes, replace_every,
                 record_history, active_floor=0, replace_kappa=0.0,
                 replace_mode="restart", iter_cap=None, group=None):
    """The solver on internal fields; ``X0t`` is overwritten. ``group``: the
    process group whose ranks hold the fields' row shards, or None."""
    rdtype = acc_dtype(Bt.real.dtype)
    dev = Bt.device
    bnorm = torch.sqrt(row_norms2_t(Bt, codec=op, group=group))
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    # tol may be a scalar or a per-RHS (k,) vector.
    tol_arr = torch.as_tensor(tol, dtype=rdtype, device=dev)
    cap = max_iter if iter_cap is None else min(int(iter_cap), max_iter)

    def fresh_qs(Xt):
        """True residual, factorized in deferred form (Q = Mi @ W), with the
        k x k-side orthogonality error as the last element."""
        Rt = Bt - op.matmat_t(Xt)
        G = f_gram(Rt, Rt, codec=op, group=group)
        return qr_passes_from_gram(G, Rt, qr_passes, codec=op, want_ortho=True, group=group)

    def relres_of(S):
        # R = Q S with orthonormal Q: per-RHS residual norm = ||S e_j||.
        return torch.sqrt((S * S.conj()).real.sum(dim=0)) / bnorm

    Mqr, Wt, S, orth = fresh_qs(X0t)
    k = S.shape[0]
    Pt = f_mm_update(Mqr, Wt, codec=op)  # P0 = Q0, the one materialized Q
    Xt = X0t
    hist = (torch.full((max_iter,), torch.nan, dtype=rdtype, device=dev)
            if record_history else None)
    per_rhs = torch.zeros((k,), dtype=torch.int32, device=dev)
    it, mv = 0, 1
    while it < cap:
        unconverged = relres_of(S) > tol_arr
        # The stop test: the iteration's one host read. More than
        # ``active_floor`` unconverged columns keep the loop going.
        if int(unconverged.sum()) <= active_floor:
            break
        per_rhs += unconverged.to(torch.int32)
        Zt, M = f_matmat_gram(op, Pt, group)
        alpha = chol_inverse_spd(M)  # Hermitian
        # Lanes-major: V = Q - Z alpha transposes to Vt = Qt - alpha^T Zt
        # with alpha^T = conj(alpha), and Qt = Mqr @ Wt applied on the fly.
        # W is dead after this, so V overwrites it.
        alpha_t = alpha.conj()
        Vt, G = f_mm2_update_gram(Mqr, Wt, -alpha_t, Zt, codec=op, donate=True, group=group)
        Mqr, Wt, rho, cond1, oe = qr_passes_from_gram(
            G, Vt, qr_passes, codec=op, want_cond=True, want_ortho=True, group=group)
        orth = torch.maximum(orth, oe)
        # P' = Mqr W + conj(rho) P and X' = X + (S^T alpha^T) P both read the
        # pre-update P; P and X are dead after, so both update in place.
        Pt, Xt = f_px_update(Mqr, Wt, rho.conj(), Pt, kk_mm(S.T, alpha_t), Xt,
                             codec=op, donate=True)
        S = kk_mm(rho, S)
        mv += 1

        do = replace_every > 0 and (it + 1) % replace_every == 0
        if replace_kappa > 0 and not do:
            do = float(cond1) > replace_kappa
        if do:
            Min, Wnt, Sn, oe2 = fresh_qs(Xt)
            if replace_mode == "rebase":
                # Fresh factorization in the old Q basis via U = S Sn^{-1},
                # folded into the deferred transform; P is kept.
                U = residual_rebase(S, Sn)
                Mqr, Wt, S = kk_mm(U.conj(), Min), Wnt, kk_mm(U, Sn)
            else:
                # Full restart: P reset to the new Q.
                Mqr, Wt, S = Min, Wnt, Sn
                Pt = f_mm_update(Min, Wnt, codec=op)
            mv += 1
            orth = torch.maximum(orth, oe2)

        if hist is not None:
            hist[it] = relres_of(S).max()
        it += 1

    relres = relres_of(S)
    info = SolverInfo(
        iterations=it,
        relres=relres,
        converged=relres <= tol_arr,
        matvecs=mv,
        history=hist,
        per_rhs_iters=per_rhs,
        breakdown=orth > 0.01,
    )
    return Xt, info


def solve_sbcgrq(
    op: Any,
    B: torch.Tensor,
    X0: torch.Tensor | None = None,
    *,
    tol=1e-6,
    max_iter: int = 1000,
    qr_passes: int = 1,
    replace_every: int = 0,
    record_history: bool = False,
    active_floor: int = 0,
    replace_kappa: float = 0.0,
    replace_mode: str = "restart",
    iter_cap: int | None = None,
) -> tuple[torch.Tensor, SolverInfo]:
    """Solve ``A X = B`` (A SPD, B (n, k)) by stabilized block CG (SBCGrQ).

    Runs on the device of ``B``. ``tol`` may be a scalar or a per-RHS (k,)
    vector. ``active_floor`` > 0 stops once at most that many RHS remain
    unconverged; ``iter_cap`` is a budget <= ``max_iter``. ``qr_passes``
    defaults to 1 (one CholeskyQR field pass with a k x k refinement,
    escalating to a second field pass when the Gram's kappa_1 crosses
    1/(2 sqrt(eps))). ``replace_every`` / ``replace_kappa`` re-anchor the
    residual to the true one; ``replace_mode`` is "restart" or "rebase"
    (f64 only). Returns (X (n, k), SolverInfo). ``B`` and ``X0`` are not
    modified.
    """
    if qr_passes < 1:
        raise ValueError("qr_passes must be >= 1")
    if replace_mode not in ("restart", "rebase"):
        raise ValueError("replace_mode must be 'restart' or 'rebase'")
    # Solver state lives in the operator's internal lanes-major view,
    # converted once here. X0t is a private copy: the solver updates it in
    # place.
    Bt, X0t = block_setup(op, B, X0, "solve_sbcgrq")
    Xt, info = _sbcgrq_impl(
        op, Bt, X0t, tol, max_iter, qr_passes, replace_every, record_history,
        active_floor, replace_kappa=float(replace_kappa),
        replace_mode=replace_mode, iter_cap=iter_cap,
    )
    return op.from_internal(Xt).T, info
