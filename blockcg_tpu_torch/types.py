"""Solver configuration and result types.

Counterpart of ``blockcg_tpu/types.py``: plain dataclasses holding tensors
and Python scalars.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Options shared by the solvers.

    Attributes:
      tol: per-RHS relative residual target, ``max_j ||R e_j|| / ||B e_j|| <= tol``.
      max_iter: hard iteration cap.
      qr_passes: CholeskyQR passes in the thin-QR stage. 1 runs one pass with
        an adaptive second pass when the Gram is ill-conditioned; 2 forces
        CholeskyQR2.
      replace_every: residual-replacement period (0 = never).
      record_history: record the per-iteration max relative residual into a
        ``(max_iter,)`` buffer returned in ``SolverInfo``.
    """

    tol: float = 1e-6
    max_iter: int = 1000
    qr_passes: int = 1
    replace_every: int = 0
    record_history: bool = False

    def kwargs(self) -> dict:
        """Expand into solver keyword arguments:
        ``solve_sbcgrq(op, B, **opts.kwargs())``."""
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SolverInfo:
    """Result metadata.

    Attributes:
      iterations: number of iterations executed (int).
      relres: per-RHS relative residual estimate at exit, shape (k,).
      converged: True where ``relres <= tol``, shape (k,).
      matvecs: number of operator applications (int).
      history: optional (max_iter,) max-relative-residual trace (NaN-padded).
      per_rhs_iters: optional (k,) int32, iterations each RHS column spent
        unconverged.
      breakdown: optional bool tensor, True when some thin QR's achieved
        orthogonality error exceeded 1% (a numerically rank-deficient
        residual block; see the reference's ``SolverInfo``).
    """

    iterations: int
    relres: torch.Tensor
    converged: torch.Tensor
    matvecs: int
    history: torch.Tensor | None = None
    per_rhs_iters: torch.Tensor | None = None
    breakdown: torch.Tensor | None = None

    def __repr__(self) -> str:
        return (f"SolverInfo(iterations={self.iterations}, "
                f"max_relres={float(self.relres.max()):.3e}, "
                f"converged={bool(self.converged.all())}, "
                f"matvecs={self.matvecs})")
