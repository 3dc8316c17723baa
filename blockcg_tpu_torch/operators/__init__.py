"""Operator formats (lanes-major applies)."""

from blockcg_tpu_torch.operators.base import (
    LinearOperator,
    MatmatMixin,
    assert_wrap_zero,
    astype,
)
from blockcg_tpu_torch.operators.bdia import BlockDIAOperator
from blockcg_tpu_torch.operators.bsr import BSROperator
from blockcg_tpu_torch.operators.cbdia import ConstBlockDIAOperator, detect_slabs
from blockcg_tpu_torch.operators.cheb import ChebyshevOperator, estimate_spectrum
from blockcg_tpu_torch.operators.csr import CSROperator, ELLOperator
from blockcg_tpu_torch.operators.dense import DenseOperator
from blockcg_tpu_torch.operators.dia import DIAOperator
from blockcg_tpu_torch.operators.realify import (
    RealifiedHermitianOperator,
    k1k2_blocks,
    real_mask_dtype,
    realify,
)
from blockcg_tpu_torch.operators.schur import EONormalOperator, SchurEvenOperator
from blockcg_tpu_torch.operators.tiled import TiledOperator
from blockcg_tpu_torch.operators.auto import from_scipy_auto

__all__ = [
    "BSROperator",
    "BlockDIAOperator",
    "CSROperator",
    "ChebyshevOperator",
    "ConstBlockDIAOperator",
    "DIAOperator",
    "DenseOperator",
    "ELLOperator",
    "EONormalOperator",
    "LinearOperator",
    "MatmatMixin",
    "RealifiedHermitianOperator",
    "SchurEvenOperator",
    "TiledOperator",
    "assert_wrap_zero",
    "astype",
    "detect_slabs",
    "estimate_spectrum",
    "from_scipy_auto",
    "k1k2_blocks",
    "real_mask_dtype",
    "realify",
]
