"""The bf16 presets of configs 1-4, plain and refined (``bench_cli.py
--dtype bf16 [--refined]``), cut to small sizes, against the reference on
CPU tensors: the same operator in both packages and the same right-hand
sides, made from a numpy seed and rounded to bf16.

Tolerances, each stated with its reason:

- plain bf16 solves: both converge, and their iteration counts are within
  10% (at least 1) of each other. XLA and torch sum bf16 products in other
  orders, and a bf16 recurrence amplifies one flipped rounding, so the counts
  are not held equal; the f64 runs of the same solvers keep their exact-count
  parity tests (``tests/test_torch_krylov.py``);
- refined solves: both reach the true f64 relres of 1e-6 against the f32 B,
  in cycle counts within 1 of each other.

The reference runs its bf16 fields through its XLA fallback here (no
``BLOCKCG_FUSED_INTERPRET``) unless a test says otherwise, the port through
its plain versions; neither rounds a k x k coefficient for the multiply of a
bf16 field (the port's contract: ROADMAP.md, "The bf16 coefficient rule").
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import blockcg_tpu as jbc
from blockcg_tpu.problems import dirac_cbdia as jdirac_cbdia
from blockcg_tpu.problems import laplacian_dia as jlaplacian_dia
import blockcg_tpu_torch as bt
from blockcg_tpu_torch.problems import dirac_cbdia, laplacian_dia, laplacian_scipy

BF = torch.bfloat16


def _rhs(n, k, seed=42):
    """(port's bf16 B, reference's bf16 B), the same values."""
    B = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)
    jB = jnp.asarray(B, jnp.bfloat16)
    return torch.from_numpy(np.array(jB.astype(jnp.float32))).to(BF), jB


def _within_10pct(a: int, b: int) -> bool:
    return abs(a - b) <= max(1, 0.1 * max(a, b))


def _laplacian(shape):
    return laplacian_dia(shape, dtype=BF, device="cpu"), jlaplacian_dia(shape, dtype=jnp.bfloat16)


@pytest.mark.parametrize("solver", ["bcg", "bcga", "bcgdq"])
def test_block_solvers_bf16(solver):
    """Config 2's solvers on a bf16 32^2 Laplacian, k = 4, tol 1e-2: X stays
    bf16, the monitors f32."""
    op, jop = _laplacian((32, 32))
    B, jB = _rhs(op.n, 4)
    X, info = getattr(bt, f"solve_{solver}")(op, B, tol=1e-2, max_iter=400)
    Xj, infoj = getattr(jbc, f"solve_{solver}")(jop, jB, tol=1e-2, max_iter=400)
    assert X.dtype == BF and Xj.dtype == jnp.bfloat16
    assert info.relres.dtype == torch.float32
    assert bool(info.converged.all()) and bool(infoj.converged.all())
    assert _within_10pct(int(info.iterations), int(infoj.iterations))


def test_cg_bf16_column():
    """Config 1's plain run: CG on column 0 of a bf16 32^2 Laplacian; the
    scalars stay f32 (the reference's ``test_cg_bf16_fields_converge``)."""
    op, jop = _laplacian((32, 32))
    B, jB = _rhs(op.n, 4)
    x, info = bt.solve_cg(op, B[:, 0], tol=1e-2, max_iter=400)
    xj, infoj = jbc.solve_cg(jop, jB[:, 0], tol=1e-2, max_iter=400)
    assert x.dtype == BF and info.relres.dtype == torch.float32
    assert bool(info.converged) and bool(infoj.converged)
    assert _within_10pct(int(info.iterations), int(infoj.iterations))


def _true_relres(a, X, B) -> float:
    X = np.asarray(X, np.float64)
    B = np.asarray(B, np.float64)
    return float((np.linalg.norm(a @ X - B, axis=0) / np.linalg.norm(B, axis=0)).max())


@pytest.mark.parametrize("inner", ["bcg", "sbcgrq"])
def test_refined_bf16_operator(inner):
    """``--refined``: ``solve_refined(op_bf16, B.float(), tol=1e-6,
    inner_tol=5e-3)`` with the f64 outer loop, inner BCG (config 2) or
    SBCGrQ (the others), on a bf16 24^2 Laplacian, k = 4."""
    shape = (24, 24)
    op, jop = _laplacian(shape)
    B, jB = _rhs(op.n, 4)
    kw = dict(tol=1e-6, inner_tol=5e-3, inner_solver=inner)
    X, info = bt.solve_refined(op, B.float(), **kw)
    Xj, infoj = jbc.solve_refined(jop, jB.astype(jnp.float32), **kw)
    a = laplacian_scipy(shape)
    Bf = B.double().numpy()
    assert X.dtype == torch.float64
    assert _true_relres(a, X.numpy(), Bf) <= 1e-6 and _true_relres(a, Xj, Bf) <= 1e-6
    assert bool(info.converged.all()) and bool(infoj.converged.all())
    assert abs(int(info.iterations) - int(infoj.iterations)) <= 1


def test_dirac_cbdia_bf16_sbcgrq():
    """Config 4's plain bf16 run, cut to 4^4: SBCGrQ on the bf16 const-hop
    operator, k = 4, converges in both packages within 10% of each other's
    iterations."""
    op = dirac_cbdia(4, dtype=BF, device="cpu")
    jop = jdirac_cbdia(4, dtype=jnp.bfloat16)
    B, jB = _rhs(op.n, 4)
    X, info = bt.solve_sbcgrq(op, B, tol=1e-2, max_iter=200)
    Xj, infoj = jbc.solve_sbcgrq(jop, jB, tol=1e-2, max_iter=200)
    assert X.dtype == BF and bool(info.converged.all()) and bool(infoj.converged.all())
    assert _within_10pct(int(info.iterations), int(infoj.iterations))


def _rounded_mm(plain, bf16, f32, cast):
    """A package's ``mm`` (``plain``) with each f32 k x k coefficient
    rounded to bf16 for the multiply of a bf16 field: the reference kernels'
    default bf16 MXU route (``blockcg_tpu/ops/fused.py`` ``_mxu_pair``) on
    that package's plain composition. ``cast(a, dtype)`` converts."""

    def mm(a, b):
        if b.dtype == bf16 and a.dtype == f32:
            a = cast(cast(a, bf16), f32)
        return plain(a, b)

    return mm


@pytest.mark.parametrize("solver", ["bcg", "bcga", "bcgdq"])
def test_block_solvers_bf16_coefficient_route(solver, monkeypatch):
    """Why the port keeps a bf16 field's k x k coefficients in f32 (ROADMAP.md,
    "The bf16 coefficient rule"), on a 32^2 Laplacian, k = 16, tol 1e-6, 300
    iterations. On the f32 coefficient route the port's solver and the
    reference's (its Pallas kernels in interpret mode under
    ``BLOCKCG_NO_BF16_MXU=1``) both converge. With each coefficient rounded
    to bf16 for the multiply (the reference kernels' default route, put on
    both packages' plain compositions) BCG stalls in both, its monitor ending
    between 10 tol and 1, and BCGA diverges in both, its monitor ending
    above 1 or not finite; BCGdQ, which orthonormalises its directions,
    converges in both. Iteration counts are not compared: at tol 1e-6 the
    bf16 counts of the reference's own two routes (XLA and kernels) differ
    by about 10%; ``test_block_solvers_bf16`` holds them at tol 1e-2."""
    import blockcg_tpu.solvers.common as jcommon
    from blockcg_tpu_torch.ops import fused
    from blockcg_tpu_torch.solvers import common

    op, jop = _laplacian((32, 32))
    B, jB = _rhs(op.n, 16)
    tsolve = getattr(bt, f"solve_{solver}")
    jsolve = getattr(jbc, f"solve_{solver}")
    kw = dict(tol=1e-6, max_iter=300)

    X, info = tsolve(op, B, **kw)
    with monkeypatch.context() as patch:
        patch.setenv("BLOCKCG_FUSED_INTERPRET", "1")
        patch.setenv("BLOCKCG_NO_BF16_MXU", "1")
        jax.clear_caches()  # the reference reads the switches when it traces
        _, infoj = jsolve(jop, jB, **kw)
    jax.clear_caches()
    assert X.dtype == BF and bool(info.converged.all()) and bool(infoj.converged.all())

    with monkeypatch.context() as patch:
        for mod in (fused, common):
            patch.setattr(mod, "mm", _rounded_mm(common.mm, BF, torch.float32,
                                                 lambda a, dt: a.to(dt)))
        patch.setattr(jcommon, "mm", _rounded_mm(jcommon.mm, jnp.bfloat16, jnp.float32,
                                                 lambda a, dt: a.astype(dt)))
        jax.clear_caches()
        _, rounded = tsolve(op, B, **kw)
        _, roundedj = jsolve(jop, jB, **kw)
    jax.clear_caches()  # no later test may reuse the traces with the rounding mm
    ends = [float(np.asarray(i.relres, np.float64).max()) for i in (rounded, roundedj)]
    if solver == "bcg":
        assert all(10 * kw["tol"] < e < 1 for e in ends), ends  # a stall
    elif solver == "bcga":
        assert all(not e <= 1 for e in ends), ends  # a divergence (NaN included)
    else:
        assert bool(rounded.converged.all()) and bool(np.all(roundedj.converged))
