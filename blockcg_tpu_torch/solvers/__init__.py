"""Block Krylov solvers."""

from blockcg_tpu_torch.solvers.bcg import solve_bcg
from blockcg_tpu_torch.solvers.bcga import solve_bcga
from blockcg_tpu_torch.solvers.bcgdq import solve_bcgdq
from blockcg_tpu_torch.solvers.cg import solve_cg
from blockcg_tpu_torch.solvers.pbcg import jacobi_preconditioner, solve_pbcg, solve_psbcgrq
from blockcg_tpu_torch.solvers.poly import solve_sbcgrq_cheb
from blockcg_tpu_torch.solvers.refine import solve_refined, solve_refined_lean
from blockcg_tpu_torch.solvers.sbcgrq import solve_sbcgrq
from blockcg_tpu_torch.solvers.shifted import solve_shifted_cg
from blockcg_tpu_torch.solvers.shifted_block import solve_shifted_sbcgrq

# Dubrulle-ladder naming: "BCGrQ" is the residual-QR rung, SBCGrQ.
solve_bcgrq = solve_sbcgrq

__all__ = [
    "jacobi_preconditioner",
    "solve_bcg",
    "solve_bcga",
    "solve_bcgdq",
    "solve_bcgrq",
    "solve_cg",
    "solve_pbcg",
    "solve_psbcgrq",
    "solve_refined",
    "solve_refined_lean",
    "solve_sbcgrq",
    "solve_sbcgrq_cheb",
    "solve_shifted_cg",
    "solve_shifted_sbcgrq",
]
