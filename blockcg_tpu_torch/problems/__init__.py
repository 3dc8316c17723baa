"""Problem generators and presets."""

from blockcg_tpu_torch.problems.laplacian import laplacian_dia, laplacian_scipy
from blockcg_tpu_torch.problems.presets import (
    PRESETS,
    config3_sbcgrq_3d_64,
    config5_sbcgrq_3d_256,
)

__all__ = [
    "PRESETS",
    "config3_sbcgrq_3d_64",
    "config5_sbcgrq_3d_256",
    "laplacian_dia",
    "laplacian_scipy",
]
