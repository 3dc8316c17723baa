"""Problem generators and presets."""

from blockcg_tpu_torch.problems.dirac import (
    bdia_scipy,
    dirac_bdia,
    dirac_bell,
    dirac_cbdia,
    dirac_gauged,
    dirac_gauged_cbdia,
    dirac_gauged_matrix,
    dirac_scipy,
    hopping_matrices,
)
from blockcg_tpu_torch.problems.dirac_eo import (
    EOContext,
    dirac_eo,
    dirac_gauged_eo,
    dirac_gauged_matrix_eo,
    eo_assemble,
    eo_split,
    solve_dirac_eo,
    solve_dirac_eo_dist,
    solve_dirac_eo_shifted,
)
from blockcg_tpu_torch.problems.laplacian import (
    laplacian_csr,
    laplacian_dia,
    laplacian_ell,
    laplacian_scipy,
)
from blockcg_tpu_torch.problems.random_spd import (
    random_block,
    random_block_c,
    random_hpd,
    random_spd,
)
from blockcg_tpu_torch.problems.unstructured import (
    delaunay_laplacian,
    random_regular_spd,
    rgg_laplacian,
    uniform_random_spd,
)
from blockcg_tpu_torch.problems.presets import (
    PRESETS,
    config1_cg_2d_128,
    config2_bcg_2d_512,
    config3_sbcgrq_3d_64,
    config4_dirac_32,
    config5_sbcgrq_3d_256,
)

__all__ = [
    "EOContext",
    "PRESETS",
    "config1_cg_2d_128",
    "config2_bcg_2d_512",
    "config3_sbcgrq_3d_64",
    "config4_dirac_32",
    "bdia_scipy",
    "config5_sbcgrq_3d_256",
    "delaunay_laplacian",
    "dirac_bdia",
    "dirac_bell",
    "dirac_cbdia",
    "dirac_eo",
    "dirac_gauged",
    "dirac_gauged_cbdia",
    "dirac_gauged_eo",
    "dirac_gauged_matrix",
    "dirac_gauged_matrix_eo",
    "dirac_scipy",
    "eo_assemble",
    "eo_split",
    "hopping_matrices",
    "laplacian_csr",
    "laplacian_dia",
    "laplacian_ell",
    "laplacian_scipy",
    "random_block",
    "random_block_c",
    "random_hpd",
    "random_regular_spd",
    "random_spd",
    "rgg_laplacian",
    "solve_dirac_eo",
    "solve_dirac_eo_dist",
    "solve_dirac_eo_shifted",
    "uniform_random_spd",
]
