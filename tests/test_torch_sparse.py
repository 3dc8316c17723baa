"""The port's gather formats (CSR, ELL, BSR), their problem builders and the
format selector against the reference's, on CPU tensors.

The same scipy matrices and numpy inputs go to both packages; applies agree
to 1e-12 in f64 (the sums run in other orders). ``from_scipy_auto`` must pick
the reference's class on the cases of tests/test_auto_format.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from blockcg_tpu import operators as jops
from blockcg_tpu import problems as jprob
from blockcg_tpu_torch import operators as ops
from blockcg_tpu_torch import problems as prob
from blockcg_tpu_torch import solve_sbcgrq

TOL = 1e-12


def _block(n, k, seed):
    return np.random.default_rng(seed).standard_normal((n, k))


def _agree(op, jop, k=3, seed=0):
    """op.matmat and op.matmat_t against the reference operator's matmat."""
    X = _block(op.shape[0], k, seed)
    want = np.asarray(jop.matmat(jnp.asarray(X)))
    got = op.matmat(torch.from_numpy(X)).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()
    got_t = op.matmat_t(torch.from_numpy(X.T.copy())).numpy()
    assert np.abs(got_t.T - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("fmt", ["csr", "ell", "bsr"])
def test_formats_from_scipy_match_the_reference(fmt):
    a = prob.delaunay_laplacian(1200, seed=2)
    if fmt == "csr":
        op, jop = (ops.CSROperator.from_scipy(a, torch.float64, device="cpu"),
                   jops.CSROperator.from_scipy(a, dtype=jnp.float64))
    elif fmt == "ell":
        op, jop = (ops.ELLOperator.from_scipy(a, torch.float64, device="cpu"),
                   jops.ELLOperator.from_scipy(a, dtype=jnp.float64))
        assert op.width == jop.width
        assert np.array_equal(op.cols.numpy(), np.asarray(jop.cols))
    else:
        op, jop = (ops.BSROperator.from_scipy(a, 4, torch.float64, device="cpu"),
                   jops.BSROperator.from_scipy(a, 4, dtype=jnp.float64))
        assert np.array_equal(op.vals.numpy(), np.asarray(jop.vals))
        assert np.array_equal(op.cols.numpy(), np.asarray(jop.cols))
    assert op.nnz == jop.nnz and op.shape == jop.shape
    _agree(op, jop)
    op32 = op.astype_op(torch.float32)
    assert op32.dtype == torch.float32 and op32.nnz == op.nnz


@pytest.mark.parametrize("builder", ["laplacian_csr", "laplacian_ell"])
def test_laplacian_builders_match_the_reference(builder):
    shape = (9, 8, 7)
    op = getattr(prob, builder)(shape, dtype=torch.float64, device="cpu")
    jop = getattr(jprob, builder)(shape, dtype=jnp.float64)
    assert op.nnz == jop.nnz
    _agree(op, jop, seed=1)


@pytest.mark.parametrize("L,bc", [(4, "periodic"), (3, "open"), (2, "periodic")])
def test_dirac_bell_matches_the_reference_and_scipy(L, bc):
    op = prob.dirac_bell(L, dtype=torch.float64, bc=bc, device="cpu")
    jop = jprob.dirac_bell(L, dtype=jnp.float64, bc=bc)
    assert np.array_equal(op.vals.numpy(), np.asarray(jop.vals))
    assert np.array_equal(op.cols.numpy(), np.asarray(jop.cols))
    assert op.nnz == jop.nnz
    _agree(op, jop, seed=2)
    a, ja = prob.dirac_scipy(L, bc=bc), jprob.dirac_scipy(L, bc=bc)
    assert abs(a - ja).max() == 0
    X = _block(op.n, 2, 3)
    assert np.abs(op.matmat(torch.from_numpy(X)).numpy() - a @ X).max() <= TOL * 10


def test_complex_dirac_bell_apply():
    op = prob.dirac_bell(3, dtype=torch.complex128, device="cpu")
    jop = jprob.dirac_bell(3, dtype=jnp.complex128)
    rng = np.random.default_rng(4)
    X = rng.standard_normal((op.n, 2)) + 1j * rng.standard_normal((op.n, 2))
    want = np.asarray(jop.matmat(jnp.asarray(X)))
    got = op.matmat(torch.from_numpy(X)).numpy()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("case", ["stencil", "mesh", "expander", "budget"])
def test_from_scipy_auto_picks_the_references_format(case):
    """Stencil -> DIA, mesh -> tiled + RCM, expander -> ELL/CSR, tile budget
    exceeded -> a gather format; the same class as the reference's."""
    kw = {}
    if case == "stencil":
        a = prob.laplacian_scipy((24, 24))
    elif case == "mesh":
        a = prob.delaunay_laplacian(3000, seed=1)
    elif case == "expander":
        a = prob.uniform_random_spd(4096, degree=8.0, seed=2)
    else:
        a = prob.delaunay_laplacian(3000, seed=1)
        kw = {"max_pad_bytes": 1 << 20}
    op = ops.from_scipy_auto(a, torch.float64, device="cpu", **kw)
    jop = jops.from_scipy_auto(a, dtype=jnp.float64, **kw)
    assert type(op).__name__ == type(jop).__name__
    want = {"stencil": ("DIAOperator",), "mesh": ("TiledOperator",),
            "expander": ("ELLOperator", "CSROperator"),
            "budget": ("ELLOperator", "CSROperator")}[case]
    assert type(op).__name__ in want
    if case == "mesh":
        assert op.perm is not None
        assert np.array_equal(op.perm.numpy(), np.asarray(jop.perm))


def test_format_agnostic_solve_through_the_order_hooks():
    """The documented generic pattern, for every auto choice (the identity
    hooks of the base class and the tile operator's permutation)."""
    for a in (prob.laplacian_scipy((16, 16)), prob.delaunay_laplacian(1500, seed=3),
              prob.uniform_random_spd(1024, degree=6.0, seed=4)):
        op = ops.from_scipy_auto(a, torch.float64, device="cpu")
        B = _block(a.shape[0], 4, 5)
        X, info = solve_sbcgrq(op, op.to_solver_order(torch.from_numpy(B)), tol=1e-9,
                               max_iter=2000)
        assert bool(info.converged.all())
        Xo = op.from_solver_order(X).numpy()
        res = np.linalg.norm(a @ Xo - B, axis=0) / np.linalg.norm(B, axis=0)
        assert res.max() <= 1e-8, type(op).__name__


def test_exports_cover_the_references():
    """Everything the reference's operators and problems export, the
    distributed even-odd solve included."""
    assert set(jops.__all__) <= set(ops.__all__)
    assert set(jprob.__all__) <= set(prob.__all__)
    assert isinstance(ops.CSROperator.from_scipy(prob.laplacian_scipy((4, 4)), device="cpu"),
                      ops.LinearOperator)
