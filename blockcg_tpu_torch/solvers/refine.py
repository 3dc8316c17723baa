"""Mixed-precision iterative refinement to 1e-10, and the memory-lean
capacity refinement.

Counterpart of ``solve_refined`` and ``solve_refined_lean`` in
``blockcg_tpu/solvers/refine.py``. f32
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

``solve_refined_lean`` is the composition that fits the 16.7M-row config 5
with 64 right-hand sides in a fraction of one card's memory: bf16 inner
fields, an f32 outer accumulator, B regenerated from a seed each cycle, and
the inner solves on column slices.
"""

from __future__ import annotations

from typing import Callable

import torch

from blockcg_tpu_torch.operators.base import astype as op_astype
from blockcg_tpu_torch.solvers.bcg import solve_bcg
from blockcg_tpu_torch.solvers.common import check_precision, row_norms2_t
from blockcg_tpu_torch.solvers.sbcgrq import _sbcgrq_impl, solve_sbcgrq
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


# --------------------------------------------- capacity (lean) refinement --


def lean_rhs(seed: int, k: int, n: int, bdtype: torch.dtype, device) -> torch.Tensor:
    """The lean refinement's right-hand sides, lanes-major (k, n): drawn in f32
    from a ``torch.Generator`` on ``device`` seeded with ``seed``, then
    rounded to ``bdtype``. The same seed gives the same values on every call,
    so the refinement regenerates B each cycle instead of keeping it, and a
    verifier regenerates it once more."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((k, n), generator=gen, dtype=torch.float32,
                       device=device).to(bdtype)


def _lean_cycle(op_out, Xt, Dt, scale, seed, bdtype, compute_dtype):
    """One outer cycle of the lean refinement, lanes-major: add the previous
    cycle's correction ``Dt`` (None on the first) into ``Xt`` in place,
    regenerate B, and return the next inner right-hand sides ``Rn`` (the
    true residual B - A X, through the f32 operator ``op_out``, scaled to
    unit columns and cast to ``compute_dtype``), the scales and the
    per-column relative residuals.

    The live set stays X (f32), Z (f32), B and Rn (bf16): the residual is
    formed in place in Z, and the bf16 B is lifted to f32 inside the
    elementwise ops and the norms, never as a whole field. The reference's
    ``optimization_barrier`` around B guards an elision of the
    f32 -> bf16 -> f32 round trip by a compiler inside one jitted program;
    eager torch rounds B when it is made and has nothing to elide."""
    if Dt is not None:
        Xt.addcmul_(Dt, scale[:, None])
    k, n = Xt.shape
    Bt = lean_rhs(seed, k, n, bdtype, Xt.device)
    Zt = op_out.matmat_t(Xt)  # pure-f32 outer apply
    Zt.neg_().add_(Bt)  # Z = B - A X
    bnorm = torch.sqrt(row_norms2_t(Bt))
    del Bt
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    nrm = torch.linalg.vector_norm(Zt, dim=1)
    relres = nrm / bnorm
    sc = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    Rn = Zt.div_(sc[:, None]).to(compute_dtype)
    return Rn, sc, relres


def _device_of(op) -> torch.device:
    """The device of an operator's data (its first buffer)."""
    return next(op.buffers()).device


def solve_refined_lean(
    op,
    seed: int,
    k: int,
    *,
    tol: float = 1e-6,
    inner_tol: float = 5e-3,
    max_cycles: int = 12,
    inner_max_iter: int = 2000,
    qr_passes: int = 1,
    inner_block: int | None = None,
    bdtype: torch.dtype = torch.bfloat16,
    deflate: bool = False,
    restart_overhead_s: float | None = None,
    verbose: bool = False,
) -> tuple[torch.Tensor, SolverInfo]:
    """Memory-lean iterative refinement for capacity runs on one card: the
    composition that fits the 16.7M-row, k = 64 config 5.

    - B: ``lean_rhs(seed, k, n, bdtype)``, regenerated on the card each outer
      cycle, never kept (the reference draws it from a JAX ``key``; here the
      ``seed`` of a ``torch.Generator``).
    - Outer accumulator X: f32, lanes-major, updated in place.
    - Outer residual: through the exact f32 widening of ``op``
      (``operators.astype``; bf16 entries lift exactly).
    - Inner solves: SBCGrQ in the operator's dtype (bf16 fields, f32
      accumulation and k x k algebra) on ``inner_block``-wide column slices
      (default k // 2 when k > 32), so the inner live set stays bounded.

    A cycle that improves the worst relres by less than 10% is slow; two in
    a row mark a precision floor and stop the refinement. ``deflate=True`` (the
    reference's converged-column deflation in the inner slices) is not
    ported; ``restart_overhead_s`` only serves it.

    Returns (X (n, k) f32, SolverInfo); relres is measured against the f32
    lift of the generated B (its bdtype values are exact in f32)."""
    if deflate:
        raise NotImplementedError(
            "solve_refined_lean(deflate=True): the deflated inner solves "
            "(blockcg_tpu/solvers/deflate.py) is not ported yet (ROADMAP queue 1 item 14)")
    del restart_overhead_s  # serves the deflated inner solves only
    check_precision("solve_refined_lean")
    n = op.n
    compute_dtype = op.dtype
    kb = inner_block or (k // 2 if k > 32 else k)
    if k % kb:
        raise ValueError(f"inner_block {kb} must divide k={k}")
    dev = _device_of(op)
    # +1 f32 copy of the diagonals (0.47 GB at full-size config 5).
    op_out = op if compute_dtype == torch.float32 else op_astype(op, torch.float32)

    Xt = torch.zeros((k, n), dtype=torch.float32, device=dev)
    Dt = None
    scale = torch.ones((k,), dtype=torch.float32, device=dev)
    matvecs = 0
    cycles = 0
    relres = None
    prev_worst = float("inf")
    stagnant = 0
    for cycles in range(0, max_cycles + 1):
        Rn, scale, relres = _lean_cycle(op_out, Xt, Dt, scale, seed, bdtype, compute_dtype)
        Dt = None
        matvecs += 1
        worst = float(relres.max())
        if verbose:
            print(f"[lean] cycle {cycles}: max relres = {worst:.3e}", flush=True)
        if worst <= tol or cycles == max_cycles:
            break
        if worst >= 0.9 * prev_worst:
            # One slow cycle is normal (the sliced inner solves alternate
            # slow and fast cycles); two in a row mark a precision floor.
            stagnant += 1
            if stagnant >= 2:
                if verbose:
                    print(f"[lean] stagnated at {worst:.3e} (floor); stopping", flush=True)
                break
        else:
            stagnant = 0
        prev_worst = worst
        parts = []
        nsl = k // kb
        for jj in range(nsl):
            Bs = Rn[jj * kb:(jj + 1) * kb]
            if jj == nsl - 1:
                # Rn (a whole (k, n) field, 2.1 GB at full-size config 5) is
                # dead once its last slice is copied out: drop it before the
                # last inner solve.
                Bs = Bs.clone()
                del Rn
            Dj, info_j = _sbcgrq_impl(
                op, Bs, torch.zeros((kb, n), dtype=compute_dtype, device=dev), inner_tol,
                inner_max_iter, qr_passes, 0, False)
            del Bs
            matvecs += int(info_j.matvecs)
            parts.append(Dj)
        Dt = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        del parts
    info = SolverInfo(iterations=cycles, relres=relres, converged=relres <= tol,
                      matvecs=matvecs)
    return Xt.T, info
