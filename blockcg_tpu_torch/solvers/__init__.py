"""Block Krylov solvers."""

from blockcg_tpu_torch.solvers.refine import solve_refined
from blockcg_tpu_torch.solvers.sbcgrq import solve_sbcgrq

__all__ = ["solve_refined", "solve_sbcgrq"]
