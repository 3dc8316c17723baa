"""Operator formats (lanes-major applies)."""

from blockcg_tpu_torch.operators.base import MatmatMixin, assert_wrap_zero, astype
from blockcg_tpu_torch.operators.cbdia import ConstBlockDIAOperator, detect_slabs
from blockcg_tpu_torch.operators.dense import DenseOperator
from blockcg_tpu_torch.operators.dia import DIAOperator

__all__ = [
    "ConstBlockDIAOperator",
    "DIAOperator",
    "DenseOperator",
    "MatmatMixin",
    "assert_wrap_zero",
    "astype",
    "detect_slabs",
]
