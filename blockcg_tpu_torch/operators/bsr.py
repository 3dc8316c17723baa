"""BSR operator in block-ELL layout (fixed blocks per block row).

Counterpart of ``blockcg_tpu/operators/bsr.py`` (plain PyTorch apply, as the
reference's XLA one)::

  vals: (nbr, wb, bs, bs)  dense blocks; padded block slots are exactly 0
  cols: (nbr, wb)          block-column indices; padded slots point at the
                           block row itself (a local, inert gather)

with nbr = n / bs block rows and wb the most blocks in a block row.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from blockcg_tpu_torch.operators.base import MatmatMixin


class BSROperator(MatmatMixin, nn.Module):
    def __init__(self, vals: torch.Tensor, cols: torch.Tensor, nnz: int | None = None):
        super().__init__()
        self.register_buffer("vals", vals)
        self.register_buffer("cols", cols.to(torch.int64))
        self._nnz = nnz

    @property
    def bs(self) -> int:
        return self.vals.shape[-1]

    @property
    def nbr(self) -> int:
        return self.vals.shape[0]

    @property
    def wb(self) -> int:
        return self.vals.shape[1]

    @property
    def n(self) -> int:
        return self.nbr * self.bs

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        """Stored nonzeros where the builder recorded them, else every entry
        of every block slot."""
        return self._nnz if self._nnz is not None else self.nbr * self.wb * self.bs ** 2

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @classmethod
    def from_scipy(cls, a, bs: int, dtype: torch.dtype = torch.float32,
                   device="cuda") -> "BSROperator":
        a = a.tobsr(blocksize=(bs, bs))
        nbr = a.shape[0] // bs
        counts = np.diff(a.indptr)
        wb = int(counts.max())
        vals = np.zeros((nbr, wb, bs, bs), dtype=np.float64 if dtype == torch.float64
                        else np.float32)
        cols = np.tile(np.arange(nbr, dtype=np.int64)[:, None], (1, wb))
        mask = np.arange(wb)[None, :] < counts[:, None]
        vals[mask] = a.data
        cols[mask] = a.indices
        return cls(torch.from_numpy(vals).to(device, dtype), torch.from_numpy(cols).to(device),
                   int(np.count_nonzero(a.data)))

    def astype_op(self, dtype: torch.dtype) -> "BSROperator":
        return BSROperator(self.vals.to(dtype), self.cols, self._nnz)

    def matmat_t(self, Xt: torch.Tensor) -> torch.Tensor:
        """(k, n) lanes-major apply: per block slot, a gather of the block
        columns and a batched (bs, bs) product over the block rows."""
        k = Xt.shape[0]
        Xb = Xt.reshape(k, self.nbr, self.bs)
        vals = self.vals.to(Xt.dtype)
        Yb = torch.zeros_like(Xb)
        for j in range(self.wb):
            # Y[k, i, a] += sum_b vals[i, j, a, b] X[k, cols[i, j], b]
            Yb += torch.einsum("iab,kib->kia", vals[:, j], Xb[:, self.cols[:, j], :])
        return Yb.reshape(k, self.n)
