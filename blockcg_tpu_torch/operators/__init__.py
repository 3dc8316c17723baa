"""Operator formats (lanes-major applies)."""

from blockcg_tpu_torch.operators.base import MatmatMixin, assert_wrap_zero, astype
from blockcg_tpu_torch.operators.bdia import BlockDIAOperator
from blockcg_tpu_torch.operators.cbdia import ConstBlockDIAOperator, detect_slabs
from blockcg_tpu_torch.operators.cheb import ChebyshevOperator, estimate_spectrum
from blockcg_tpu_torch.operators.dense import DenseOperator
from blockcg_tpu_torch.operators.dia import DIAOperator
from blockcg_tpu_torch.operators.realify import (
    RealifiedHermitianOperator,
    k1k2_blocks,
    real_mask_dtype,
    realify,
)
from blockcg_tpu_torch.operators.schur import EONormalOperator, SchurEvenOperator

__all__ = [
    "BlockDIAOperator",
    "ChebyshevOperator",
    "ConstBlockDIAOperator",
    "DIAOperator",
    "DenseOperator",
    "EONormalOperator",
    "MatmatMixin",
    "RealifiedHermitianOperator",
    "SchurEvenOperator",
    "assert_wrap_zero",
    "astype",
    "detect_slabs",
    "estimate_spectrum",
    "k1k2_blocks",
    "real_mask_dtype",
    "realify",
]
