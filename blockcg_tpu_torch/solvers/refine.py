"""Mixed-precision iterative refinement to 1e-10.

Counterpart of ``solve_refined`` in ``blockcg_tpu/solvers/refine.py``. f32
epsilon is ~1.2e-7, so one f32 Krylov solve cannot reach 1e-10; refinement
wraps the hot f32 solver in an f64 outer cycle:

    X = 0 (f64)
    repeat:
        R = B - A X           # true residual in f64, one SpMM per cycle
        stop if max_j ||R e_j|| / ||B e_j|| <= tol
        D = inner_solve(A_f32, R_f32, tol=inner_tol)   # hot f32 SBCGrQ or BCG
        X += D

The f64 apply runs natively on the card through the plain version of the
stencil (the kernels are f32; the reference likewise sends f64 to XLA).
"""

from __future__ import annotations

from typing import Callable

import torch

from blockcg_tpu_torch.operators.base import astype as op_astype
from blockcg_tpu_torch.solvers.bcg import solve_bcg
from blockcg_tpu_torch.solvers.sbcgrq import solve_sbcgrq
from blockcg_tpu_torch.types import SolverInfo
from blockcg_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


def _refine_cycle(op64, X, D, scale, B64, bnorm, compute_dtype):
    """Apply the previous cycle's correction (none on the first cycle),
    recompute the true residual, rescale it per RHS and cast the next inner
    RHS. The per-RHS scaling hands the f32 inner solver O(1) columns."""
    if D is not None:
        X = X + D.to(X.dtype) * scale[None, :]
    R = B64 - op64.matmat(X)
    nrm = torch.linalg.vector_norm(R, dim=0)
    relres = nrm / bnorm
    sc = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    R_next = (R / sc[None, :]).to(compute_dtype)
    return X, R_next, sc, relres


def solve_refined(
    op,
    B: torch.Tensor,
    *,
    tol: float = 1e-10,
    inner_tol: float = 1e-5,
    max_cycles: int = 8,
    inner_solver: str = "sbcgrq",
    inner_max_iter: int = 2000,
    qr_passes: int = 2,
    replace_every: int = 0,
    solve_fn: Callable | None = None,
    op64=None,
    outer_dtype: torch.dtype | None = None,
    checkpoint_path: str | None = None,
    verbose: bool = False,
) -> tuple[torch.Tensor, SolverInfo]:
    """Solve ``A X = B`` to a tolerance below the inner dtype's reach.

    Args:
      op: operator in its compute dtype (f32, the hot path).
      B: (n, k) right-hand sides, on the operator's device.
      tol: outer true-residual target.
      inner_tol: per-cycle inner solve target.
      inner_solver: "sbcgrq" (default) or "bcg", the inner f32 solver.
      solve_fn: optional override ``(op, R, tol) -> (D, info)`` of
        ``inner_solver``.
      op64: optional full-precision operator for the outer residual; default
        is a new copy of ``op`` in ``outer_dtype`` (exact for stencil
        coefficients).
      outer_dtype: dtype of the outer accumulator and true residual
        (default float64, complex128 for a complex ``B`` on a realified
        operator).
      checkpoint_path: save X after every cycle, and resume from it.

    Returns:
      (X, SolverInfo) with X in ``outer_dtype``; ``info.iterations`` counts
      refinement cycles, ``info.matvecs`` totals inner and outer applies.
    """
    if solve_fn is None:
        if inner_solver == "sbcgrq":
            def solve_fn(o, r, t):
                return solve_sbcgrq(o, r, tol=t, max_iter=inner_max_iter,
                                    qr_passes=qr_passes,
                                    replace_every=replace_every)
        elif inner_solver == "bcg":
            def solve_fn(o, r, t):
                return solve_bcg(o, r, tol=t, max_iter=inner_max_iter)
        else:
            raise ValueError(f"unknown inner solver {inner_solver!r}")

    compute_dtype = op.dtype
    wide = outer_dtype or (torch.complex128 if B.is_complex() else torch.float64)
    if op64 is None:
        op64 = op_astype(op, wide)
    B64 = B.to(wide)
    bnorm = torch.linalg.vector_norm(B64, dim=0)
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    X = torch.zeros_like(B64)
    if checkpoint_path is not None:  # resume = warm start
        ckpt = load_checkpoint(checkpoint_path, device=B.device)
        if ckpt is not None:
            X = ckpt[0].to(wide)
            if verbose:
                print(f"[refine] resumed from {checkpoint_path} (cycle {ckpt[1]})")
    X, R_in, scale, relres = _refine_cycle(op64, X, None, None, B64, bnorm,
                                           compute_dtype)

    matvecs = 1
    cycles = 0
    if bool(relres.max() <= tol):
        max_cycles = 0  # e.g. resumed from a converged checkpoint
    for cycles in range(1, max_cycles + 1):
        D, inner_info = solve_fn(op, R_in, inner_tol)
        matvecs += int(inner_info.matvecs)
        X, R_in, scale, relres = _refine_cycle(op64, X, D, scale, B64, bnorm,
                                               compute_dtype)
        matvecs += 1
        if checkpoint_path is not None:
            save_checkpoint(checkpoint_path, X, iteration=cycles)
        worst = float(relres.max())
        if verbose:
            print(f"[refine] cycle {cycles}: max relres = {worst:.3e}")
        if worst <= tol:
            break

    info = SolverInfo(iterations=cycles, relres=relres,
                      converged=relres <= tol, matvecs=matvecs)
    return X, info
