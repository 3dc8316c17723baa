"""Automatic operator-format selection from a scipy sparse matrix.

Counterpart of ``blockcg_tpu/operators/auto.py``, with the same decision
tree, inspecting the matrix on the host with integer scans:

  1. few distinct diagonals        -> DIAOperator (stencil kernel)
  2. tile-densifiable under RCM    -> TiledOperator with the RCM perm
                                      (sparse-tile kernel; bf16 tiles
                                      optional via tile_dtype)
  3. bounded row width             -> ELLOperator (fixed-width gather)
  4. otherwise                     -> CSROperator (gather + segment sum)

The RCM choice applies in a permuted row order; every operator has
``to_solver_order`` / ``from_solver_order`` (the identity by default), so
caller code is the same for every format::

    op = from_scipy_auto(a)
    X, info = solve_sbcgrq(op, op.to_solver_order(B))
    X = op.from_solver_order(X)

The tiled-against-gather choice uses the reference's rate models, measured
on a TPU v5e (its BASELINE.md, k = 32): tiled nnz/s = 49 Gnnz/s times the
tile fill, ELL nnz/s = 0.55 Gnnz/s times (mean degree / max degree)^2. They
are kept as they are so that both packages pick the same format; the H100's
own rates (``chip_smoke.py``'s ``[scattered]`` lines) stand beside them in
PERF.md.
"""

from __future__ import annotations

import numpy as np
import torch


def _predicted_rcm_fill(a, T: int = 128):
    """(fill, ntiles, perm) of P A P^T under RCM, without building tiles; the
    perm is returned so that the TiledOperator built next reuses it."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    perm = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))
    ap = a[perm][:, perm].tocsr()
    n = ap.shape[0]
    ct = np.asarray(ap.indices, dtype=np.int64) // T
    rt = np.repeat(np.arange(n, dtype=np.int64) // T, np.diff(ap.indptr))
    ntiles = np.unique(rt * (-(-n // T)) + ct).size
    return ap.nnz / (ntiles * T * T), ntiles, perm


# The reference's rate-model constants (TPU v5e, k = 32), kept for parity.
_TILED_GNNZS_PER_FILL = 49.0   # tiled nnz/s = this x tile fill
_GATHER_BOUND_GNNZS = 0.55     # random-row-gather speed of light
_TILED_MARGIN = 1.3            # tile only when predicted to win by this


def from_scipy_auto(a, dtype: torch.dtype = torch.float32, *, max_diagonals: int = 48,
                    min_fill: float = 0.0028, max_ell_width: int = 64,
                    max_pad_bytes: int = 8 << 30, tile_dtype: torch.dtype | None = None,
                    verbose: bool = False, device="cuda"):
    """Pick and build the operator container for the square sparse ``a``.

    ``max_diagonals``: DIA when the matrix has at most this many distinct
    diagonals. ``min_fill``: the RCM tile format's fill floor. ``max_ell_width``:
    ELL when the most entries in a row is at most this, else CSR.
    ``tile_dtype`` goes to ``TiledOperator`` (e.g. ``torch.bfloat16``)."""
    from blockcg_tpu_torch.operators.csr import CSROperator, ELLOperator
    from blockcg_tpu_torch.operators.dia import DIAOperator
    from blockcg_tpu_torch.operators.tiled import TiledOperator

    a = a.tocsr()
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"square matrix required, got {a.shape}")
    coo = a.tocoo()
    offsets = np.unique(coo.col.astype(np.int64) - coo.row.astype(np.int64))

    if offsets.size <= max_diagonals:
        if verbose:
            print(f"[auto] DIA: {offsets.size} diagonals")
        return DIAOperator.from_scipy(a, dtype=dtype, device=device)

    counts = np.diff(a.indptr)
    fill, ntiles, perm = _predicted_rcm_fill(a)
    tiled_est = _TILED_GNNZS_PER_FILL * fill
    ell_ok = counts.max() <= max_ell_width
    gather_est = _GATHER_BOUND_GNNZS * (
        (counts.mean() / max(counts.max(), 1)) ** 2 if ell_ok else 0.25)
    if (fill >= min_fill and tiled_est >= _TILED_MARGIN * gather_est
            and ntiles * 128 * 128 * 4 <= max_pad_bytes):
        if verbose:
            print(f"[auto] tiled+RCM: predicted fill {fill:.2%}, {ntiles} tiles, est "
                  f"{tiled_est:.2f} vs gather {gather_est:.2f} Gnnz/s")
        try:
            return TiledOperator.from_scipy(a, dtype=dtype, perm=perm, tile_dtype=tile_dtype,
                                            max_pad_bytes=max_pad_bytes, device=device)
        except ValueError:
            # The padding to a tile multiple crossed the budget (the estimate
            # above is before it): the gather formats take the matrix.
            pass

    if ell_ok:
        if verbose:
            print(f"[auto] ELL: width {int(counts.max())} (tiled est {tiled_est:.2f} did "
                  f"not clear gather est {gather_est:.2f} Gnnz/s x {_TILED_MARGIN})")
        return ELLOperator.from_scipy(a, dtype=dtype, device=device)
    if verbose:
        print(f"[auto] CSR: max row degree {int(counts.max())}")
    return CSROperator.from_scipy(a, dtype=dtype, device=device)
