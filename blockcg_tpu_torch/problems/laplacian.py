"""Laplacian problem generators.

Counterpart of ``blockcg_tpu/problems/laplacian.py``: DIA, ELL and CSR
operators and the scipy export.
The band construction is numpy and is carried over as it is, since the port
may not import the reference package.

Convention: d-dimensional 2d+1-point Laplacian with Dirichlet boundaries on a
grid of ``shape``; lexicographic (row-major, last axis fastest) ordering.
Diagonal = 2d, neighbors = -1. SPD with eigenvalues in (0, 4d).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from blockcg_tpu_torch.operators.base import assert_wrap_zero
from blockcg_tpu_torch.operators.csr import CSROperator, ELLOperator
from blockcg_tpu_torch.operators.dia import DIAOperator


def _laplacian_bands(shape: tuple[int, ...], np_dtype) -> tuple[tuple[int, ...], np.ndarray]:
    """Row-aligned diagonals for the Dirichlet Laplacian on ``shape``.

    Returns (offsets, diags) with diags[d, i] multiplying X[i + offsets[d]].
    """
    ndim = len(shape)
    n = math.prod(shape)
    # Strides of each axis in lexicographic order (last axis fastest).
    strides = [math.prod(shape[ax + 1 :]) for ax in range(ndim)]
    offsets: list[int] = []
    diags: list[np.ndarray] = []

    idx = np.arange(n)
    coords = [(idx // strides[ax]) % shape[ax] for ax in range(ndim)]

    # Negative offsets first, then 0, then positive — sorted for DIA sanity.
    for ax in range(ndim):
        d = np.full(n, -1.0, dtype=np_dtype)
        d[coords[ax] == 0] = 0.0  # no neighbor below the boundary
        offsets.append(-strides[ax])
        diags.append(d)
    offsets.append(0)
    diags.append(np.full(n, 2.0 * ndim, dtype=np_dtype))
    for ax in range(ndim):
        d = np.full(n, -1.0, dtype=np_dtype)
        d[coords[ax] == shape[ax] - 1] = 0.0  # no neighbor above the boundary
        offsets.append(strides[ax])
        diags.append(d)

    order = np.argsort(offsets)
    offsets = [offsets[i] for i in order]
    diags = [diags[i] for i in order]
    return tuple(offsets), np.stack(diags)


def laplacian_dia(shape: tuple[int, ...], dtype: torch.dtype = torch.float32,
                  device="cuda") -> DIAOperator:
    """Dirichlet Laplacian as a DIAOperator. Every boundary (hence every mod-n
    wrap-crossing) coefficient is exactly zero, checked at build time. The
    band values (-1, 0, 2d) are exact in any float dtype."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    offsets, diags = _laplacian_bands(tuple(shape), np_dtype)
    assert_wrap_zero(diags, offsets, diags.shape[-1],
                     what=f"laplacian_dia{tuple(shape)}")
    return DIAOperator.from_numpy(diags, offsets, wrap_zero=True, dtype=dtype,
                                  device=device)


def laplacian_scipy(shape: tuple[int, ...]):
    """scipy CSR export, for test comparisons (small shapes only)."""
    import scipy.sparse as sp

    offsets, diags = _laplacian_bands(tuple(shape), np.float64)
    n = diags.shape[1]
    # scipy.diags wants column-aligned diagonal arrays of length n - |o|:
    # the row-aligned diags[d, i] multiplies X[i+o], i.e. entry A[i, i+o].
    arrs = []
    for d, o in enumerate(offsets):
        if o >= 0:
            arrs.append(diags[d, : n - o])
        else:
            arrs.append(diags[d, -o:])
    return sp.diags(arrs, offsets, shape=(n, n), format="csr")


def laplacian_ell(shape: tuple[int, ...], dtype: torch.dtype = torch.float32,
                  device="cuda") -> ELLOperator:
    """Dirichlet Laplacian as an ELLOperator (width 2 * ndim + 1). A slot past
    the boundary keeps a clipped, valid column index; its value is exactly
    0, so the gather is inert. ``nnz`` counts the nonzero values."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    offsets, diags = _laplacian_bands(tuple(shape), np_dtype)
    n = diags.shape[1]
    vals = np.ascontiguousarray(diags.T)  # (n, w)
    idx = np.arange(n)
    cols = np.stack([np.clip(idx + o, 0, n - 1) for o in offsets], axis=1)
    return ELLOperator(torch.from_numpy(vals).to(device, dtype),
                       torch.from_numpy(cols).to(device), int(np.count_nonzero(vals)))


def laplacian_csr(shape: tuple[int, ...], dtype: torch.dtype = torch.float32,
                  device="cuda") -> CSROperator:
    return CSROperator.from_scipy(laplacian_scipy(shape), dtype=dtype, device=device)
