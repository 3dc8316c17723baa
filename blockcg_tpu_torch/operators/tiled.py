"""Sparse-tile operator: the general-sparsity container (any CSR matrix).

Counterpart of ``blockcg_tpu/operators/tiled.py``. A scipy matrix is cut
into dense 128 x 128 tiles at its nonzero (row tile, column tile) positions
by the host tilizer (``blockcg_tpu_torch/native.py``), optionally after a
reverse Cuthill-McKee reordering that packs scattered-but-local sparsity
into fewer, denser tiles; the apply is ``ops.spmm_tiled.tiled_spmm_t``.

An operator built with a reordering applies in the permuted (and identity-
padded) row order: convert the right-hand sides and solutions at the API
boundary with ``to_solver_order`` / ``from_solver_order``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from blockcg_tpu_torch.operators.base import MatmatMixin
from blockcg_tpu_torch.ops import _native, spmm_tiled

T = spmm_tiled.T


class TiledOperator(MatmatMixin, nn.Module):
    """tiles (ntiles, T, T) buffer (float32, float64 or bfloat16 storage);
    rt, ct, first (ntiles,) int32 buffers, sorted by rt; ``n`` the padded
    order. ``perm`` (n0,) is the reordering (or None), ``n0`` the original
    order and ``nnz_logical`` the scipy matrix's stored entries."""

    def __init__(self, tiles: torch.Tensor, rt: torch.Tensor, ct: torch.Tensor,
                 first: torch.Tensor, n: int, perm: torch.Tensor | None = None,
                 n0: int | None = None, nnz_logical: int | None = None):
        super().__init__()
        if tiles.dim() != 3 or tiles.shape[1:] != (T, T) or n % T:
            raise ValueError(f"tiles {tuple(tiles.shape)} for n={n}: expected "
                             f"(ntiles, {T}, {T}) and n % {T} == 0")
        self.register_buffer("tiles", tiles)
        self.register_buffer("rt", rt.to(torch.int32))
        self.register_buffer("ct", ct.to(torch.int32))
        self.register_buffer("first", first.to(torch.int32))
        self.register_buffer("perm", None if perm is None else perm.to(torch.int64))
        # Each row tile's first tile, for the kernel (built once, here).
        self.register_buffer("row_ptr", spmm_tiled.row_pointers(self.rt, n // T),
                             persistent=False)
        self.n = int(n)
        self.n0 = self.n if n0 is None else int(n0)
        self.nnz_logical = nnz_logical
        self._iperm = None
        self._plans = {}

    @property
    def T(self) -> int:
        return T

    @property
    def ntiles(self) -> int:
        return self.tiles.shape[0]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        """Logical nonzeros where recorded at construction, else the padded
        tile footprint."""
        if self.nnz_logical is not None:
            return self.nnz_logical
        return self.ntiles * T * T

    @property
    def fill(self) -> float:
        """Tile density: logical nnz over the padded tile footprint, which
        sets the kernel's useful share of the bytes it streams."""
        return self.nnz / (self.ntiles * T * T)

    @property
    def dtype(self) -> torch.dtype:
        """The fields' dtype: bf16 tile storage still computes in f32."""
        t = self.tiles.dtype
        return torch.float32 if t == torch.bfloat16 else t

    @classmethod
    def from_scipy(cls, a, dtype: torch.dtype = torch.float32, reorder: str | None = None,
                   tile_dtype: torch.dtype | None = None, perm=None,
                   max_pad_bytes: int = 8 << 30, force_numpy: bool = False,
                   device="cuda") -> "TiledOperator":
        """Build from a square scipy matrix.

        ``reorder="rcm"`` applies reverse Cuthill-McKee (host side, scipy)
        before tiling, unless ``perm`` gives the reordering already (as
        ``from_scipy_auto`` does). The order is padded to a multiple of 128
        with identity rows. ``tile_dtype`` is the tile storage (default
        ``dtype``); ``torch.bfloat16`` halves the tile bytes while the
        kernel still computes in f32 against f32 fields (the entries are
        rounded to bf16: refine with an f64 ``op64`` for full accuracy).
        Raises where the padded tiles would exceed ``max_pad_bytes`` (use
        ``CSROperator``/``ELLOperator`` for such scattered matrices)."""
        import scipy.sparse as sp

        from blockcg_tpu_torch.native import tilize_csr

        a = a.tocsr()
        n0 = n = a.shape[0]
        if perm is None and reorder is not None:
            if reorder != "rcm":
                raise ValueError(f"unknown reorder {reorder!r} (use 'rcm')")
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            perm = reverse_cuthill_mckee(a, symmetric_mode=True)
        if perm is not None:
            perm = np.asarray(perm, dtype=np.int64)
            a = a[perm][:, perm].tocsr()
        if n % T:
            a = sp.block_diag([a, sp.eye(T - n % T)], format="csr")
            n = a.shape[0]
        col_t = np.asarray(a.indices).astype(np.int64) // T
        rtile = np.repeat(np.arange(n, dtype=np.int64) // T, np.diff(np.asarray(a.indptr)))
        ntiles_est = int(np.unique(rtile * (n // T) + col_t).size)
        pad_bytes = ntiles_est * T * T * 4
        if pad_bytes > max_pad_bytes:
            raise ValueError(
                f"matrix too scattered for the {T}x{T} tile format: "
                f"{ntiles_est} tiles = {pad_bytes / 2 ** 30:.1f} GiB padded "
                f"(fill {a.nnz / (ntiles_est * T * T):.2%}); use CSROperator/"
                "ELLOperator instead")
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        tiles, rt, ct, first = tilize_csr(a, T, force_numpy=force_numpy, dtype=np_dtype)
        store = dtype if tile_dtype is None else tile_dtype
        return cls(torch.from_numpy(tiles).to(device=device, dtype=store),
                   torch.from_numpy(rt).to(device), torch.from_numpy(ct).to(device),
                   torch.from_numpy(first).to(device), n,
                   None if perm is None else torch.from_numpy(perm).to(device),
                   n0, int(a.nnz))

    def astype_op(self, dtype: torch.dtype) -> "TiledOperator":
        """The same tiles in ``dtype`` (bf16 storage is widened exactly), with
        the same reordering: ``solve_refined``'s default f64 ``op64``, which
        runs the plain version."""
        return TiledOperator(self.tiles.to(dtype), self.rt, self.ct, self.first, self.n,
                             self.perm, self.n0, self.nnz_logical)

    def to_solver_order(self, B: torch.Tensor) -> torch.Tensor:
        """(n0, k) or (n0,) in the original row order -> the operator's
        (reordered, identity-padded) order; the identity without a
        reordering or padding."""
        if self.perm is not None:
            B = B[self.perm]
        if self.n0 != self.n:
            pad = B.new_zeros((self.n - self.n0,) + tuple(B.shape[1:]))
            B = torch.cat([B, pad])
        return B

    def from_solver_order(self, X: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`to_solver_order`: drop the padding rows and undo
        the reordering (its inverse is computed once and kept)."""
        X = X[: self.n0]
        if self.perm is not None:
            if self._iperm is None or self._iperm.device != self.perm.device:
                self._iperm = torch.argsort(self.perm)
            X = X[self._iperm]
        return X

    def reordered_scipy(self, a):
        """``a`` in this operator's internal order (reordered and identity-
        padded), e.g. for the f64 outer operator of ``solve_refined``:
        ``CSROperator.from_scipy(op.reordered_scipy(a), torch.float64)``."""
        import scipy.sparse as sp

        a = a.tocsr()
        if self.perm is not None:
            p = self.perm.cpu().numpy()
            a = a[p][:, p].tocsr()
        if a.shape[0] != self.n:
            a = sp.block_diag([a, sp.eye(self.n - a.shape[0])], format="csr")
        return a

    def tiled_plan(self, k: int) -> "spmm_tiled.TiledPlan":
        """The kernel's schedule for a launch of k rows of X
        (``spmm_tiled.tiled_plan``), computed once per width, device and
        tile dtype and kept."""
        key = (k, self.row_ptr.device, self.tiles.dtype)
        if key not in self._plans:
            self._plans[key] = spmm_tiled.tiled_plan(self.row_ptr, k, self.row_ptr.device,
                                                     self.tiles.dtype)
        return self._plans[key]

    def matmat_t(self, Xt: torch.Tensor) -> torch.Tensor:
        """(k, n) lanes-major apply in the internal order. A bf16 field takes
        the reference's route for it on any device: its kernel gate takes
        float32 X alone (``blockcg_tpu/operators/tiled.py:190-199``), and its
        XLA route casts the tiles to X's dtype and sums in it
        (``tiled_spmm_plain``; ``_native.f32_field_gate_refuses``)."""
        if _native.f32_field_gate_refuses(Xt):
            return spmm_tiled.tiled_spmm_plain(self.tiles, self.rt, self.ct, Xt)
        return spmm_tiled.tiled_spmm_t(self.tiles, self.rt, self.ct, self.first,
                                       Xt.contiguous(), self.row_ptr, self.tiled_plan)

    def extra_repr(self) -> str:
        return (f"n={self.n}, n0={self.n0}, ntiles={self.ntiles}, fill={self.fill:.4f}, "
                f"tiles={self.tiles.dtype}, reordered={self.perm is not None}")
