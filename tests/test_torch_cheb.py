"""The port's Chebyshev preconditioning (``ops.fused.cheb_step``,
``operators/cheb.py``, ``solvers/poly.py``) against the reference package,
on CPU tensors.

The same inputs, made from numpy seeds, go through both packages. On the CPU
``cheb_step`` runs its plain version; it is held against the reference's
Pallas kernel in interpret mode to rtol 1e-6 (f32: one rounding per
operation on either side). f64: the preconditioned apply to 1e-12 relative,
``estimate_spectrum`` to 1e-10 relative, and ``solve_sbcgrq_cheb`` with the
reference's iteration and matvec counts and X to 1e-9.
"""

import gc

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import blockcg_tpu as jbc
from blockcg_tpu.operators import cheb as jcheb
from blockcg_tpu.ops import fused as jfused
from blockcg_tpu.problems import dirac as jdirac
from blockcg_tpu.problems import laplacian_dia as jlaplacian_dia
from blockcg_tpu_torch import solve_sbcgrq, solve_sbcgrq_cheb
from blockcg_tpu_torch.operators import ChebyshevOperator, estimate_spectrum
from blockcg_tpu_torch.operators.cheb import cheb_coefficients
from blockcg_tpu_torch.ops import _native, fused
from blockcg_tpu_torch.problems import dirac_cbdia, laplacian_dia, laplacian_scipy
from blockcg_tpu_torch.solvers import poly


def _relmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _ops(name, dtype=torch.float64):
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    if name == "laplacian":
        return (laplacian_dia((16, 16), dtype=dtype, device="cpu"),
                jlaplacian_dia((16, 16), dtype=jdt))
    return dirac_cbdia(4, dtype=dtype, device="cpu"), jdirac.dirac_cbdia(4, dtype=jdt)


# ------------------------------------------------------------ the kernel's plain


@pytest.mark.parametrize("shape", [(8, 1024), (48, 256)])
@pytest.mark.parametrize("donate", [False, True])
def test_cheb_step_plain_matches_pallas(shape, donate):
    rng = np.random.default_rng(0)
    R, Z, D, AZ = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    c1, c2 = 0.37, -1.21
    Zj, Dj = jfused.cheb_step(*(jnp.asarray(a) for a in (R, Z, D, AZ)), c1, c2,
                              interpret=True)
    Zt, Dt = torch.from_numpy(Z.copy()), torch.from_numpy(D.copy())
    _native.reset_launches()
    Zo, Do = fused.cheb_step(torch.from_numpy(R), Zt, Dt, torch.from_numpy(AZ), c1, c2,
                             donate=donate)
    assert sum(_native.launches.values()) == 0  # CPU tensors: the plain version
    np.testing.assert_allclose(Do.numpy(), np.asarray(Dj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(Zo.numpy(), np.asarray(Zj), rtol=1e-6, atol=1e-6)
    assert (Zo.data_ptr() == Zt.data_ptr()) == donate
    assert (Do.data_ptr() == Dt.data_ptr()) == donate
    Zp, Dp = fused.cheb_step_plain(*(torch.from_numpy(a) for a in (R, Z, D, AZ)), c1, c2)
    assert torch.equal(Zo, Zp) and torch.equal(Do, Dp)


def test_cheb_step_refuses_aliased_donation():
    F = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="share storage"):
        fused.cheb_step(F, F, F, F, 0.5, 0.5, donate=True)
    with pytest.raises(ValueError, match="shapes"):
        fused.cheb_step(F, F, F, torch.zeros((4, 8)), 0.5, 0.5)
    Zo, Do = fused.cheb_step(F, F, F, F, 0.5, 0.5)  # Z and D may be one buffer
    assert Zo.data_ptr() != Do.data_ptr()


# --------------------------------------------------------------- the operator


@pytest.mark.parametrize("name", ["laplacian", "cbdia"])
@pytest.mark.parametrize("degree", [1, 3, 6])
def test_cheb_apply_matches_reference(name, degree):
    op, jop = _ops(name)
    lo, hi = 0.05, 7.9
    pop = ChebyshevOperator(op, lo, hi, degree)
    jpop = jcheb.ChebyshevOperator(base=jop, lo=jnp.asarray(lo), hi=jnp.asarray(hi),
                                   degree=degree)
    X = np.random.default_rng(1).standard_normal((3, op.n))
    Xi = op.to_internal(torch.from_numpy(X))
    jXi = jop.to_internal(jnp.asarray(X))
    assert _relmax(pop.matmat_t(Xi), jpop.matmat_t(jXi)) <= 1e-12
    assert _relmax(pop.apply_m_t(Xi), jpop.apply_m_t(jXi)) <= 1e-12
    assert pop.nnz == op.nnz * degree and pop.shape == op.shape


def test_cheb_coefficients_round_in_the_field_dtype():
    """f32 fields: every scalar of the recurrence is a float32 value, as the
    reference's jnp scalars are; f64 from f32 bounds sums them in f32 first."""
    theta, steps = cheb_coefficients(np.float32(0.1), np.float32(8.0), 4, torch.float32)
    for v in (theta, *(c for st in steps for c in st)):
        assert float(np.float32(v)) == v
    theta64, _ = cheb_coefficients(np.float32(0.1), np.float32(8.0), 4, torch.float64)
    assert theta64 == float(np.float64(np.float32(0.1) + np.float32(8.0)) / 2)
    assert len(steps) == 3


def test_cheb_operator_spd_and_commutes():
    op = laplacian_dia((8, 8), dtype=torch.float64, device="cpu")
    lo, hi = estimate_spectrum(op)
    pop = ChebyshevOperator(op, lo, hi, 3)
    MA = pop.matmat_t(torch.eye(op.n, dtype=torch.float64)).numpy().T
    assert np.abs(MA - MA.T).max() < 1e-10 and np.linalg.eigvalsh(MA).min() > 0
    A = laplacian_scipy((8, 8)).toarray()
    M = pop.apply_m_t(torch.eye(op.n, dtype=torch.float64)).numpy().T
    np.testing.assert_allclose(M @ A, A @ M, atol=1e-10)


@pytest.mark.parametrize("name", ["laplacian", "cbdia"])
def test_estimate_spectrum_matches_reference(name):
    op, jop = _ops(name)
    lo, hi = estimate_spectrum(op)
    jlo, jhi = jcheb.estimate_spectrum(jop)
    assert lo.dim() == 0 and lo.dtype == torch.float64
    assert abs(float(lo) / float(jlo) - 1) <= 1e-10
    assert abs(float(hi) / float(jhi) - 1) <= 1e-10


# ------------------------------------------------------------------ the solver


@pytest.mark.parametrize("name,degree", [("laplacian", 4), ("cbdia", 3), ("cbdia", 6)])
def test_f64_cheb_solve_matches_reference(name, degree):
    op, jop = _ops(name)
    B = np.random.default_rng(2).standard_normal((op.n, 4))
    spectrum = (0.05, 8.5) if name == "laplacian" else (0.2, 16.5)
    X, info = solve_sbcgrq_cheb(op, torch.from_numpy(B), degree=degree, spectrum=spectrum,
                                tol=1e-10, max_iter=500)
    Xj, infoj = jbc.solve_sbcgrq_cheb(jop, jnp.asarray(B), degree=degree,
                                      spectrum=spectrum, tol=1e-10, max_iter=500)
    assert bool(info.converged.all()) and info.iterations == int(infoj.iterations)
    assert info.matvecs == int(infoj.matvecs)
    assert _relmax(X, Xj) <= 1e-9
    # True residuals; after a second cycle both sit at rounding level.
    np.testing.assert_allclose(info.relres.numpy(), np.asarray(infoj.relres), rtol=1e-4,
                               atol=1e-14)


def test_f32_cheb_solve_cuts_iterations():
    """The reference's own test at 64^2, k = 8, degree 4, in f32: true
    relres within 1.1 tol and fewer than 0.65x the plain SBCGrQ iterations."""
    op = laplacian_dia((64, 64), device="cpu")
    B = torch.as_tensor(np.random.default_rng(1).standard_normal((op.n, 8)),
                        dtype=torch.float32)
    X, info = solve_sbcgrq_cheb(op, B, degree=4, tol=1e-6, max_iter=500)
    a = laplacian_scipy((64, 64))
    Bn = B.double().numpy()
    rel = (np.linalg.norm(Bn - a @ X.double().numpy(), axis=0)
           / np.linalg.norm(Bn, axis=0)).max()
    assert X.dtype == torch.float32 and bool(info.converged.all()) and rel < 1.1e-6
    _, plain = solve_sbcgrq(op, B, tol=1e-6, max_iter=500)
    assert info.iterations < 0.65 * plain.iterations


def test_spectrum_is_cached_per_operator():
    op = laplacian_dia((8, 8), dtype=torch.float64, device="cpu")
    B = torch.as_tensor(np.random.default_rng(3).standard_normal((op.n, 2)))
    solve_sbcgrq_cheb(op, B, tol=1e-8)
    key = id(op)
    cached = poly._SPECTRUM_CACHE[key]
    assert all(torch.equal(a, b) for a, b in zip(cached, estimate_spectrum(op)))
    solve_sbcgrq_cheb(op, B, tol=1e-8)
    assert poly._SPECTRUM_CACHE[key] is cached  # estimated once
    del op
    gc.collect()
    assert key not in poly._SPECTRUM_CACHE  # evicted with the operator
    with pytest.raises(ValueError, match="max_cycles"):
        solve_sbcgrq_cheb(laplacian_dia((4, 4), device="cpu"), B[:16], max_cycles=0)
