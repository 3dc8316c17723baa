"""Dense operator: the testing and small-problem path.

Counterpart of ``blockcg_tpu/operators/dense.py``. The apply is a plain
``torch.matmul``, as the reference leaves it to XLA; there is no kernel of
this repository behind it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from blockcg_tpu_torch.operators.base import MatmatMixin


class DenseOperator(MatmatMixin, nn.Module):
    """A: (n, n) buffer."""

    def __init__(self, A: torch.Tensor):
        super().__init__()
        if A.dim() != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"DenseOperator takes a square matrix, got {tuple(A.shape)}")
        self.register_buffer("A", A)

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.A.shape)

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def nnz(self) -> int:
        return self.A.shape[0] * self.A.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.A.dtype

    @classmethod
    def from_numpy(cls, A, *, dtype: torch.dtype | None = None,
                   device="cuda") -> "DenseOperator":
        t = torch.from_numpy(np.array(A))  # a writable host copy
        return cls(t.to(dtype=dtype or t.dtype, device=device))

    def astype_op(self, dtype: torch.dtype) -> "DenseOperator":
        return DenseOperator(self.A.to(dtype))

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.A, X).to(X.dtype)

    def matmat_t(self, Xt: torch.Tensor) -> torch.Tensor:
        return torch.matmul(Xt, self.A.T).to(Xt.dtype)

    def extra_repr(self) -> str:
        return f"n={self.n}"
