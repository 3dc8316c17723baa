"""The distributed layer: row partitioning, ring halo exchange and the
solvers' k x k reductions over ``torch.distributed`` (counterpart of
``blockcg_tpu/parallel``)."""

from blockcg_tpu_torch.parallel.api import (
    row_group,
    solve_bcg_dist,
    solve_cg_dist,
    solve_psbcgrq_dist,
    solve_refined_dist,
    solve_sbcgrq_cheb_dist,
    solve_sbcgrq_dist,
    solve_shifted_sbcgrq_dist,
)
from blockcg_tpu_torch.parallel.dist_ops import (
    BlockDIAPartition,
    ConstBlockDIAPartition,
    DIAPartition,
    DiracEOPartition,
    DistBlockDIAOperator,
    DistConstBlockDIAOperator,
    DistDIAOperator,
    DistEONormalOperator,
    DistSchurEvenOperator,
    from_dist_order,
    partition_bdia,
    partition_cbdia,
    partition_dia,
    partition_dirac_eo,
    to_dist_order,
)
from blockcg_tpu_torch.parallel.halo import ring_halos, start_ring_halos

__all__ = [
    "BlockDIAPartition",
    "ConstBlockDIAPartition",
    "DIAPartition",
    "DiracEOPartition",
    "DistBlockDIAOperator",
    "DistConstBlockDIAOperator",
    "DistDIAOperator",
    "DistEONormalOperator",
    "DistSchurEvenOperator",
    "from_dist_order",
    "partition_bdia",
    "partition_cbdia",
    "partition_dia",
    "partition_dirac_eo",
    "ring_halos",
    "row_group",
    "solve_bcg_dist",
    "solve_cg_dist",
    "solve_psbcgrq_dist",
    "solve_refined_dist",
    "solve_sbcgrq_cheb_dist",
    "solve_sbcgrq_dist",
    "solve_shifted_sbcgrq_dist",
    "start_ring_halos",
    "to_dist_order",
]
