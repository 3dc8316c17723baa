"""Operator formats (lanes-major applies)."""

from blockcg_tpu_torch.operators.base import MatmatMixin, assert_wrap_zero, astype
from blockcg_tpu_torch.operators.bdia import BlockDIAOperator
from blockcg_tpu_torch.operators.cbdia import ConstBlockDIAOperator, detect_slabs
from blockcg_tpu_torch.operators.dense import DenseOperator
from blockcg_tpu_torch.operators.dia import DIAOperator
from blockcg_tpu_torch.operators.realify import (
    RealifiedHermitianOperator,
    k1k2_blocks,
    real_mask_dtype,
    realify,
)

__all__ = [
    "BlockDIAOperator",
    "ConstBlockDIAOperator",
    "DIAOperator",
    "DenseOperator",
    "MatmatMixin",
    "RealifiedHermitianOperator",
    "assert_wrap_zero",
    "astype",
    "detect_slabs",
    "k1k2_blocks",
    "real_mask_dtype",
    "realify",
]
