"""Operator formats (lanes-major applies)."""

from blockcg_tpu_torch.operators.base import MatmatMixin, assert_wrap_zero, astype
from blockcg_tpu_torch.operators.dia import DIAOperator

__all__ = ["DIAOperator", "MatmatMixin", "assert_wrap_zero", "astype"]
