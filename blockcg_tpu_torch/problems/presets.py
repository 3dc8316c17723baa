"""Named problem presets of the north-star configs (BASELINE.json).

Counterpart of ``blockcg_tpu/problems/presets.py``, all five configs. Each
returns ``(op, B, meta)``: the operator, a deterministic random RHS block made
from a numpy seed (the same values as the reference's), and solver details.
"""

from __future__ import annotations

import numpy as np
import torch

from blockcg_tpu_torch.problems.dirac import dirac_cbdia
from blockcg_tpu_torch.problems.laplacian import laplacian_dia


def _rhs(n: int, k: int, dtype: torch.dtype, seed: int = 42, device="cuda"):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((n, k)), dtype=dtype, device=device)


def config1_cg_2d_128(dtype: torch.dtype = torch.float32, device="cuda"):
    """2D 5-pt Laplacian 128x128 (16k rows), 4 RHS, plain CG."""
    op = laplacian_dia((128, 128), dtype=dtype, device=device)
    return op, _rhs(op.n, 4, dtype, device=device), {"solver": "cg", "name": "cg_2d_128"}


def config2_bcg_2d_512(dtype: torch.dtype = torch.float32, device="cuda"):
    """2D Laplacian 512x512 (262k rows), 16 RHS, BCG (vs per-RHS CG)."""
    op = laplacian_dia((512, 512), dtype=dtype, device=device)
    return op, _rhs(op.n, 16, dtype, device=device), {"solver": "bcg", "name": "bcg_2d_512"}


def config3_sbcgrq_3d_64(dtype: torch.dtype = torch.float32, device="cuda"):
    """3D 7-pt Laplacian 64^3 (262k rows), 32 RHS, SBCGrQ."""
    op = laplacian_dia((64, 64, 64), dtype=dtype, device=device)
    return op, _rhs(op.n, 32, dtype, device=device), {
        "solver": "sbcgrq", "name": "sbcgrq_3d_64"}


def config4_dirac_32(dtype: torch.dtype = torch.float32, L: int = 32, device="cuda"):
    """4x4-block lattice-Dirac-like SPD operator on L^4 (default 32^4, 4.2M
    rows) in the const-hop container, 12 RHS, SBCGrQ."""
    op = dirac_cbdia(L, m=0.5, dtype=dtype, device=device)
    return op, _rhs(op.n, 12, dtype, device=device), {
        "solver": "sbcgrq", "name": f"dirac_{L}"}


def config5_sbcgrq_3d_256(dtype: torch.dtype = torch.float32,
                          shape=(256, 256, 256), device="cuda"):
    """3D Laplacian 256^3 (16.7M rows), 64 RHS, SBCGrQ."""
    op = laplacian_dia(shape, dtype=dtype, device=device)
    return op, _rhs(op.n, 64, dtype, device=device), {
        "solver": "sbcgrq", "name": "sbcgrq_3d_256"}


PRESETS = {
    "cg_2d_128": config1_cg_2d_128,
    "bcg_2d_512": config2_bcg_2d_512,
    "sbcgrq_3d_64": config3_sbcgrq_3d_64,
    "dirac_32": config4_dirac_32,
    "sbcgrq_3d_256": config5_sbcgrq_3d_256,
}
