"""CSR and ELL sparse operators (plain PyTorch applies).

Counterpart of ``blockcg_tpu/operators/csr.py``. The reference applies both
through XLA gathers with no kernel of its own; here they are gathers with a
sorted segment sum (CSR) and a per-slot loop (ELL), which run as they are on
the card and on the CPU, in any float dtype. Neither adds with atomics, so an
apply repeats bitwise.

ELL pads every row to a fixed width ``w``; a padded slot points at the row's
own index with value 0 (a local, inert gather).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from blockcg_tpu_torch.operators.base import MatmatMixin


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


class CSROperator(MatmatMixin, nn.Module):
    """CSR as triplets: vals (nnz,), cols (nnz,) int64 and the sorted row ids
    (nnz,) int64; ``row_nnz`` (n,) counts each row's entries."""

    def __init__(self, vals: torch.Tensor, cols: torch.Tensor, row_ids: torch.Tensor,
                 n: int):
        super().__init__()
        self.register_buffer("vals", vals)
        self.register_buffer("cols", cols.to(torch.int64))
        self.register_buffer("row_ids", row_ids.to(torch.int64))
        self.register_buffer("row_nnz", torch.bincount(self.row_ids, minlength=n))
        self.n = int(n)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        return self.vals.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @classmethod
    def from_scipy(cls, a, dtype: torch.dtype = torch.float32, device="cuda") -> "CSROperator":
        a = a.tocsr()
        n = a.shape[0]
        row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.indptr))
        return cls(torch.as_tensor(np.asarray(a.data, _np_dtype(dtype))).to(device, dtype),
                   torch.as_tensor(np.asarray(a.indices, np.int64)).to(device),
                   torch.from_numpy(row_ids).to(device), n)

    def astype_op(self, dtype: torch.dtype) -> "CSROperator":
        return CSROperator(self.vals.to(dtype), self.cols, self.row_ids, self.n)

    def matmat_t(self, Xt: torch.Tensor) -> torch.Tensor:
        """(k, n) lanes-major apply: gather X's rows of (n, k) X^T, scale,
        and sum each row's run of entries in order (``segment_reduce``: one
        sequential sum per output, no atomics)."""
        contrib = Xt.T[self.cols] * self.vals.to(Xt.dtype)[:, None]
        Y = torch.segment_reduce(contrib, "sum", lengths=self.row_nnz, axis=0)
        return Y.T.contiguous()


class ELLOperator(MatmatMixin, nn.Module):
    """ELLPACK: vals (n, w), cols (n, w) int64; padded slots hold 0."""

    def __init__(self, vals: torch.Tensor, cols: torch.Tensor, nnz: int | None = None):
        super().__init__()
        self.register_buffer("vals", vals)
        self.register_buffer("cols", cols.to(torch.int64))
        self._nnz = nnz

    @property
    def n(self) -> int:
        return self.vals.shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def width(self) -> int:
        return self.vals.shape[1]

    @property
    def nnz(self) -> int:
        """Logical nonzeros: padded slots hold exactly 0, so a hand-built
        operator is counted by its nonzero values (one host read, kept)."""
        if self._nnz is None:
            self._nnz = int(torch.count_nonzero(self.vals))
        return self._nnz

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @classmethod
    def from_scipy(cls, a, dtype: torch.dtype = torch.float32, width: int | None = None,
                   device="cuda") -> "ELLOperator":
        a = a.tocsr()
        n = a.shape[0]
        counts = np.diff(a.indptr)
        w = int(counts.max()) if width is None else int(width)
        if w < counts.max():
            raise ValueError(f"width {w} < max row nnz {counts.max()}")
        vals = np.zeros((n, w), dtype=_np_dtype(dtype))
        # Padded slots point at the row itself: a local gather times zero.
        cols = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, w))
        mask = np.arange(w)[None, :] < counts[:, None]
        vals[mask] = a.data
        cols[mask] = a.indices
        return cls(torch.from_numpy(vals).to(device, dtype), torch.from_numpy(cols).to(device),
                   int(counts.sum()))

    def astype_op(self, dtype: torch.dtype) -> "ELLOperator":
        return ELLOperator(self.vals.to(dtype), self.cols, self._nnz)

    def matmat_t(self, Xt: torch.Tensor) -> torch.Tensor:
        """(k, n) lanes-major apply, one gather and multiply-add per slot (the
        intermediate stays (k, n))."""
        vals = self.vals.to(Xt.dtype)
        Y = torch.zeros_like(Xt)
        for j in range(self.width):
            Y.addcmul_(vals[:, j], Xt[:, self.cols[:, j]])
        return Y
