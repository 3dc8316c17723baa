"""blockcg_tpu_torch: the PyTorch/CUDA port of blockcg_tpu.

Block conjugate-gradient solvers for ``A X = B`` with many right-hand sides,
on PyTorch tensors. The hot field passes run as hand-written CUDA kernels on
an NVIDIA Hopper card (``csrc/``, built with nvcc on first use); on CPU
tensors the same functions run their plain PyTorch versions. The JAX package
``blockcg_tpu`` is the reference the port is tested against; this package
never imports JAX.
"""

from blockcg_tpu_torch.operators import (
    BlockDIAOperator,
    BSROperator,
    ConstBlockDIAOperator,
    CSROperator,
    DenseOperator,
    DIAOperator,
    ELLOperator,
    RealifiedHermitianOperator,
    TiledOperator,
    from_scipy_auto,
    realify,
)
from blockcg_tpu_torch.solvers import (
    jacobi_preconditioner,
    solve_bcg,
    solve_bcga,
    solve_bcgdq,
    solve_bcgrq,
    solve_cg,
    solve_pbcg,
    solve_psbcgrq,
    solve_refined,
    solve_refined_lean,
    solve_sbcgrq,
    solve_sbcgrq_cheb,
    solve_shifted_cg,
    solve_shifted_sbcgrq,
)
from blockcg_tpu_torch.types import SolverInfo, SolverOptions

__all__ = [
    "BSROperator",
    "BlockDIAOperator",
    "CSROperator",
    "ConstBlockDIAOperator",
    "DIAOperator",
    "DenseOperator",
    "ELLOperator",
    "RealifiedHermitianOperator",
    "SolverInfo",
    "SolverOptions",
    "TiledOperator",
    "from_scipy_auto",
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
    "realify",
]
