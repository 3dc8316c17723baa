"""Operator glue shared by the port's operators.

Counterpart of ``blockcg_tpu/operators/base.py``. Two apply entry points:

- ``matmat(X) -> A @ X`` for an (n, k) block, the public convention;
- ``matmat_t(Xt) -> (A @ X)^T`` for a lanes-major (k, n) block, the solvers'
  internal convention (neighbouring columns are neighbouring addresses, which
  is what the CUDA kernels read in one coalesced pass).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class LinearOperator(Protocol):
    """Anything that can apply ``A @ X`` to a dense block."""

    @property
    def shape(self) -> tuple[int, int]: ...

    @property
    def nnz(self) -> int: ...

    def matmat(self, X: torch.Tensor) -> torch.Tensor: ...

    def matmat_t(self, Xt: torch.Tensor) -> torch.Tensor: ...

    def __call__(self, X: torch.Tensor) -> torch.Tensor: ...


def assert_wrap_zero(vals, offsets, ns: int, what: str = "operator") -> None:
    """Verify the ``wrap_zero`` contract numerically at build time: every
    coefficient whose column index wraps modulo ``ns`` is exactly zero.

    ``vals``: (noff, ..., ns) host array, site axis last. Diagonal ``d``
    couples site ``s`` to column ``(s + offsets[d]) mod ns``. Offsets with
    ``|o| >= ns`` are skipped, as in the reference."""
    for d, o in enumerate(offsets):
        if o == 0 or abs(o) >= ns:
            continue
        wrap = vals[d, ..., ns - o:] if o > 0 else vals[d, ..., : -o]
        nz = int(np.count_nonzero(np.asarray(wrap)))
        if nz:
            raise AssertionError(
                f"{what}: wrap_zero claimed, but diagonal {d} "
                f"(offset {o:+d}) has {nz} nonzero wrap-crossing "
                "coefficients")


class MatmatMixin:
    """``forward`` (so ``op(X)`` works on an ``nn.Module``) and each of
    matmat/matmat_t in terms of the other; subclasses define at least one
    natively. The layout and codec hooks default to the identity: flat
    (k, n) fields are already the internal view."""

    def forward(self, X):
        return self.matmat(X)

    def matmat(self, X):
        squeeze = X.dim() == 1
        Xt = X[None, :] if squeeze else X.T.contiguous()
        Yt = self.matmat_t(Xt)
        return Yt[0] if squeeze else Yt.T

    def matmat_t(self, Xt):
        return self.matmat(Xt.T).T

    def matmat_gram_t(self, Xt):
        """(Y = A X, G = X^H Y) when the operator can emit the Gram fused
        with the apply, else (Y, None)."""
        return self.matmat_t(Xt), None

    def to_internal(self, Xt):
        """Lanes-major (k, n) -> the operator's internal field view."""
        return Xt

    def from_internal(self, Xf):
        """Internal field view -> lanes-major (k, n)."""
        return Xf

    # Row-order hooks at the API boundary. An operator that applies in a
    # permuted row order (the RCM-reordered TiledOperator) overrides them, so
    # user code is written once for every format:
    #   X = op.from_solver_order(solve(op, op.to_solver_order(B))).

    def to_solver_order(self, B):
        """(n, k) right-hand sides in the original row order -> the
        operator's order."""
        return B

    def from_solver_order(self, X):
        """Inverse of :meth:`to_solver_order`."""
        return X

    def coeff_expand(self, C):
        return C

    def gram_contract(self, G):
        return G

    def norms2_contract(self, v):
        return v


class DelegatedCodecMixin(MatmatMixin):
    """``MatmatMixin`` whose codec hooks forward to an inner operator, the
    submodule named by the class attribute ``codec_of``: a wrapper (the
    realified, Schur and Chebyshev operators) keeps its core's field view."""

    codec_of = "base"

    def _codec(self):
        return getattr(self, self.codec_of)

    def to_internal(self, Xt):
        return self._codec().to_internal(Xt)

    def from_internal(self, Xf):
        return self._codec().from_internal(Xf)

    def coeff_expand(self, C):
        return self._codec().coeff_expand(C)

    def gram_contract(self, G):
        return self._codec().gram_contract(G)

    def norms2_contract(self, v):
        return self._codec().norms2_contract(v)


def astype(op, dtype):
    """A new operator with its float data in ``dtype``; ``op`` is left as it
    was. (``nn.Module.to`` would convert the caller's operator in place.)
    The distributed shards of ``parallel/dist_ops.py`` define ``astype_op``
    too: ``solve_refined_dist`` takes its f64 outer operator from them."""
    return op.astype_op(dtype)
