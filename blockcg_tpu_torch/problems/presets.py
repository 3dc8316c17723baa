"""Named problem presets of the north-star configs (BASELINE.json).

Counterpart of ``blockcg_tpu/problems/presets.py`` for configs 3, 4 and 5. Each
returns ``(op, B, meta)``: the operator, a deterministic random RHS block made
from a numpy seed (the same values as the reference's), and solver details.
"""

from __future__ import annotations

import numpy as np
import torch

from blockcg_tpu_torch.problems.dirac import dirac_cbdia
from blockcg_tpu_torch.problems.laplacian import laplacian_dia


def _rhs(n: int, k: int, dtype: torch.dtype, seed: int = 42, device=None):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((n, k)), dtype=dtype, device=device)


def config3_sbcgrq_3d_64(dtype: torch.dtype = torch.float32, device=None):
    """3D 7-pt Laplacian 64^3 (262k rows), 32 RHS, SBCGrQ."""
    op = laplacian_dia((64, 64, 64), dtype=dtype, device=device)
    return op, _rhs(op.n, 32, dtype, device=device), {
        "solver": "sbcgrq", "name": "sbcgrq_3d_64"}


def config4_dirac_32(dtype: torch.dtype = torch.float32, L: int = 32, device=None):
    """4x4-block lattice-Dirac-like SPD operator on L^4 (default 32^4, 4.2M
    rows) in the const-hop container, 12 RHS, SBCGrQ."""
    op = dirac_cbdia(L, m=0.5, dtype=dtype, device=device)
    return op, _rhs(op.n, 12, dtype, device=device), {
        "solver": "sbcgrq", "name": f"dirac_{L}"}


def config5_sbcgrq_3d_256(dtype: torch.dtype = torch.float32,
                          shape=(256, 256, 256), device=None):
    """3D Laplacian 256^3 (16.7M rows), 64 RHS, SBCGrQ."""
    op = laplacian_dia(shape, dtype=dtype, device=device)
    return op, _rhs(op.n, 64, dtype, device=device), {
        "solver": "sbcgrq", "name": "sbcgrq_3d_256"}


PRESETS = {
    "sbcgrq_3d_64": config3_sbcgrq_3d_64,
    "dirac_32": config4_dirac_32,
    "sbcgrq_3d_256": config5_sbcgrq_3d_256,
}
