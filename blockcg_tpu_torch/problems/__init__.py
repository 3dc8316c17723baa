"""Problem generators and presets."""

from blockcg_tpu_torch.problems.dirac import dirac_cbdia, dirac_gauged_cbdia, hopping_matrices
from blockcg_tpu_torch.problems.laplacian import laplacian_dia, laplacian_scipy
from blockcg_tpu_torch.problems.presets import (
    PRESETS,
    config3_sbcgrq_3d_64,
    config4_dirac_32,
    config5_sbcgrq_3d_256,
)

__all__ = [
    "PRESETS",
    "config3_sbcgrq_3d_64",
    "config4_dirac_32",
    "config5_sbcgrq_3d_256",
    "dirac_cbdia",
    "dirac_gauged_cbdia",
    "hopping_matrices",
    "laplacian_dia",
    "laplacian_scipy",
]
