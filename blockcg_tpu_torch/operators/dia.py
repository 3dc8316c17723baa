"""DIA (diagonal / banded) operator, the stencil fast path.

Counterpart of ``blockcg_tpu/operators/dia.py``. ``diags[d, i]`` multiplies
``X[(i + offsets[d]) mod n]`` into ``Y[i]`` (diagonals aligned to the row
index). Dirichlet builders zero every wrap-crossing coefficient, so the
toroidal apply equals the truncated one.

A bf16 operator (``laplacian_dia(..., dtype=torch.bfloat16)``, the capacity
route of config 5) applies to bf16 fields through the stencil's bf16
variant on the card; its exact f32 widening, ``operators.astype(op,
torch.float32)``, is the lean refinement's outer operator (a bf16 value is
exact in f32). A bf16 operator on an f32 field, or the reverse, raises on the
card.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from blockcg_tpu_torch.operators.base import MatmatMixin
from blockcg_tpu_torch.ops import stencil


class DIAOperator(MatmatMixin, nn.Module):
    """diags: (ndiag, n) buffer; offsets: tuple of ints.

    ``wrap_zero`` records that every coefficient whose column wraps modulo n
    is exactly zero (the builders check it numerically)."""

    def __init__(self, diags: torch.Tensor, offsets, wrap_zero: bool = False):
        super().__init__()
        if diags.dim() != 2 or diags.shape[0] != len(offsets):
            raise ValueError(f"diags {tuple(diags.shape)} does not match "
                             f"{len(offsets)} offsets")
        self.register_buffer("diags", diags)
        self.offsets = tuple(int(o) for o in offsets)
        self.wrap_zero = bool(wrap_zero)

    @property
    def n(self) -> int:
        return self.diags.shape[1]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        """Structural nonzeros of truncated diagonals (n - |o| each)."""
        return sum(self.n - abs(o) for o in self.offsets)

    @property
    def dtype(self) -> torch.dtype:
        return self.diags.dtype

    @classmethod
    def from_numpy(cls, diags, offsets, wrap_zero: bool = False, *,
                   dtype: torch.dtype | None = None, device="cuda") -> "DIAOperator":
        """Build from host arrays, e.g. a reference operator's
        ``(np.asarray(op.diags), op.offsets, op.wrap_zero)``, so both
        packages apply the same matrix."""
        t = torch.from_numpy(np.array(diags))  # a writable host copy
        return cls(t.to(dtype=dtype or t.dtype, device=device), offsets, wrap_zero)

    @classmethod
    def from_scipy(cls, a, dtype: torch.dtype = torch.float32,
                   device="cuda") -> "DIAOperator":
        a = a.todia()
        offsets = tuple(int(o) for o in a.offsets)
        n = a.shape[0]
        # scipy DIA aligns data to the column index: data[d, j] is A[j-o, j].
        # Re-align to rows: row_diag[d, i] = A[i, i+o] = data[d, i+o].
        diags = np.zeros((len(offsets), n), dtype=np.float64)
        for d, o in enumerate(offsets):
            if o >= 0:
                diags[d, : n - o] = a.data[d, o:n]
            else:
                diags[d, -o:n] = a.data[d, : n + o]
        return cls.from_numpy(diags, offsets, dtype=dtype, device=device)

    def astype_op(self, dtype: torch.dtype) -> "DIAOperator":
        return DIAOperator(self.diags.to(dtype), self.offsets, self.wrap_zero)

    def matmat_t(self, Xt: torch.Tensor) -> torch.Tensor:
        """(k, n) lanes-major apply: ``Yt[:, i] = sum_d c_d[i] Xt[:, i+o_d]``."""
        return stencil.stencil_spmm_t(self.diags, self.offsets, Xt)

    def matmat_gram_t(self, Xt: torch.Tensor):
        """Fused (Y = A X, G = X^H Y), the solvers' ``P^H A P``."""
        return stencil.stencil_spmm_gram_t(self.diags, self.offsets, Xt)

    def extra_repr(self) -> str:
        return f"n={self.n}, offsets={self.offsets}, wrap_zero={self.wrap_zero}"
