"""The port's preconditioned block solvers (PBCG, PSBCGrQ and the Jacobi
preconditioner) against the reference package, on CPU tensors.

The same inputs, made from numpy seeds, go through both packages.
Tolerances: the Jacobi factor bitwise (it is one division per entry); f64
solves take the reference's iteration count and X to 1e-9 relative (max
norm); the f32 solve reaches the reference test's true-residual bound.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

import blockcg_tpu as jbc
from blockcg_tpu.operators import DenseOperator as JDense
from blockcg_tpu.operators import DIAOperator as JDIA
from blockcg_tpu.problems import dirac as jdirac
from blockcg_tpu.solvers import pbcg as jpbcg
from blockcg_tpu_torch import (
    BlockDIAOperator,
    ConstBlockDIAOperator,
    DenseOperator,
    DIAOperator,
    jacobi_preconditioner,
    solve_pbcg,
    solve_psbcgrq,
    solve_sbcgrq,
)
from blockcg_tpu_torch.ops import fused
from blockcg_tpu_torch.problems import bdia_scipy, dirac_bdia, dirac_cbdia
from blockcg_tpu_torch.solvers.pbcg import JacobiPreconditioner


def _scaled_spd_dia(n, seed=0, spread=4.0):
    """Badly diagonally scaled SPD banded matrix (the reference test's):
    D A D with rows scaled over decades."""
    rng = np.random.default_rng(seed)
    s = np.exp(spread * rng.standard_normal(n))
    offsets = [-2, -1, 0, 1, 2]
    base = sp.diags(
        [np.full(n - abs(o), -1.0) for o in offsets[:2]]
        + [np.full(n, 5.0)]
        + [np.full(n - abs(o), -1.0) for o in offsets[3:]],
        offsets,
    ).tocsr()
    D = sp.diags(np.sqrt(s))
    return (D @ base @ D).tocsr()


def _dense_spd(n, seed):
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, 2 * n))
    return V @ V.T + n * np.eye(n)


def _relmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _problem(name):
    """(port operator, reference operator, port M, reference M, n) in f64."""
    if name == "dia":
        a = _scaled_spd_dia(1024)
        op = DIAOperator.from_scipy(a, dtype=torch.float64, device="cpu")
        jop = JDIA.from_scipy(a, dtype=jnp.float64)
        return op, jop, jacobi_preconditioner(op), jpbcg.jacobi_preconditioner(jop), a.shape[0]
    if name == "dense_identity":
        A = _dense_spd(256, 2)
        return (DenseOperator.from_numpy(A, device="cpu"), JDense(A=jnp.asarray(A)),
                JacobiPreconditioner(torch.ones((1, 256), dtype=torch.float64)),
                jpbcg.JacobiPreconditioner(dinv_int=jnp.ones((1, 256))), 256)
    op = dirac_cbdia(4, dtype=torch.float64, device="cpu")
    jop = jdirac.dirac_cbdia(4, dtype=jnp.float64)
    return op, jop, jacobi_preconditioner(op), jpbcg.jacobi_preconditioner(jop), op.n


# ------------------------------------------------------------ preconditioner


@pytest.mark.parametrize("build", ["dia64", "dia32", "dense", "cbdia32", "cbdia64",
                                   "gauged_cbdia"])
def test_jacobi_factor_matches_reference_bitwise(build):
    if build.startswith("dia"):
        dt, jdt = ((torch.float64, jnp.float64) if build == "dia64"
                   else (torch.float32, jnp.float32))
        a = _scaled_spd_dia(512, seed=3)
        op = DIAOperator.from_scipy(a, dtype=dt, device="cpu")
        jop = JDIA.from_scipy(a, dtype=jdt)
    elif build == "dense":
        A = _dense_spd(64, 4)
        op, jop = DenseOperator.from_numpy(A, device="cpu"), JDense(A=jnp.asarray(A))
    elif build == "gauged_cbdia":
        from blockcg_tpu_torch.problems import dirac_gauged_cbdia

        op = dirac_gauged_cbdia(4, device="cpu")
        jop = jdirac.dirac_gauged_cbdia(4, dtype=jnp.float32)
    else:
        dt, jdt = ((torch.float64, jnp.float64) if build == "cbdia64"
                   else (torch.float32, jnp.float32))
        op = dirac_cbdia(4, dtype=dt, device="cpu")
        jop = jdirac.dirac_cbdia(4, dtype=jdt)
    d = jacobi_preconditioner(op).dinv_int
    jd = np.asarray(jpbcg.jacobi_preconditioner(jop).dinv_int)
    assert d.numpy().dtype == jd.dtype and np.array_equal(d.numpy(), jd)


@pytest.mark.parametrize("k", [1, 3])
def test_jacobi_apply_repeats_spin_rows(k):
    """On the merged (bs * k, ns) layout each spin row repeats over its k
    rows (``repeat_interleave``, the reference's ``jnp.repeat``), built once
    per k."""
    op = dirac_cbdia(4, dtype=torch.float64, device="cpu")
    jop = jdirac.dirac_cbdia(4, dtype=jnp.float64)
    d = np.exp(np.random.default_rng(5).standard_normal((op.bs, op.ns)))
    M = JacobiPreconditioner(torch.from_numpy(d))
    jM = jpbcg.JacobiPreconditioner(dinv_int=jnp.asarray(d))
    F = np.random.default_rng(6).standard_normal((op.bs * k, op.ns))
    got = M.apply_t(torch.from_numpy(F))
    assert np.array_equal(got.numpy(), np.asarray(jM.apply_t(jnp.asarray(F))))
    assert list(M._repeated) == ([k] if k > 1 else [])
    r = M._repeated.get(k)
    M.apply_t(torch.from_numpy(F))
    assert M._repeated.get(k) is r  # not rebuilt on the next apply
    flat = JacobiPreconditioner(torch.from_numpy(d[:1]))
    assert np.array_equal(flat.apply_t(torch.from_numpy(F)).numpy(), F * d[:1])


def test_jacobi_raises_where_reference_raises():
    no_diag = DIAOperator.from_numpy(np.ones((2, 8)), (-1, 1), device="cpu")
    with pytest.raises(ValueError, match="main diagonal"):
        jacobi_preconditioner(no_diag)
    hops = (((1.0, 0.5), (0.5, 1.0)), ((0.1, 0.0), (0.0, 0.1)))
    bad = ConstBlockDIAOperator(None, hops, (0, 1), (-1, -1), 8, device="cpu")
    with pytest.raises(ValueError, match="scalar multiple"):
        jacobi_preconditioner(bad)
    uneven = ConstBlockDIAOperator(None, (((2.0, 0.0), (0.0, 3.0)),), (0,), (-1,), 8,
                                   device="cpu")
    with pytest.raises(ValueError, match="scalar multiple"):
        jacobi_preconditioner(uneven)
    off = ConstBlockDIAOperator(None, hops[1:], (1,), (-1,), 8, device="cpu")
    with pytest.raises(ValueError, match="site-diagonal"):
        jacobi_preconditioner(off)
    with pytest.raises(TypeError, match="unsupported"):
        jacobi_preconditioner(dirac_bdia(4, device="cpu"))
    assert isinstance(dirac_bdia(4, device="cpu"), BlockDIAOperator)


def test_gram_takes_two_fields_on_the_merged_layout():
    """PSBCGrQ's M-CholQR Gram ``f_gram(Q, M Q)`` has U != V: the wrapper
    and the codec contraction take two different merged fields."""
    from blockcg_tpu_torch.solvers.common import f_gram

    op = dirac_cbdia(4, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(7)
    U, V = (rng.standard_normal((op.bs * 3, op.ns)) for _ in range(2))
    G = f_gram(torch.from_numpy(U), torch.from_numpy(V), codec=op)
    want = sum(U[a * 3:(a + 1) * 3] @ V[a * 3:(a + 1) * 3].T for a in range(op.bs))
    np.testing.assert_allclose(G.numpy(), want, rtol=1e-13)
    assert fused.gram(torch.from_numpy(U), torch.from_numpy(V)).shape == (12, 12)


# ------------------------------------------------------------------ solvers


@pytest.mark.parametrize("problem", ["dia", "dense_identity", "cbdia"])
@pytest.mark.parametrize("solver", ["pbcg", "psbcgrq"])
def test_f64_solve_matches_reference(problem, solver):
    op, jop, M, jM, n = _problem(problem)
    B = np.random.default_rng(11).standard_normal((n, 4))
    tol = 1e-10
    fn, jfn = ((solve_pbcg, jbc.solve_pbcg) if solver == "pbcg"
               else (solve_psbcgrq, jbc.solve_psbcgrq))
    X, info = fn(op, torch.from_numpy(B), M, tol=tol, max_iter=2000)
    Xj, infoj = jfn(jop, jnp.asarray(B), jM, tol=tol, max_iter=2000)
    assert bool(info.converged.all()) and bool(np.all(np.asarray(infoj.converged)))
    assert info.iterations == int(infoj.iterations)
    assert info.matvecs == int(infoj.matvecs)
    assert _relmax(X, Xj) <= 1e-9
    np.testing.assert_allclose(info.relres.numpy(), np.asarray(infoj.relres),
                               rtol=1e-6, atol=1e-13)


def test_psbcgrq_monitor_is_the_m_norm():
    """On the badly scaled system PSBCGrQ stops on the M-norm; the 2-norm
    true residual stays inside the reference test's bound, and Jacobi cuts
    the iterations of unpreconditioned SBCGrQ below 0.7x."""
    a = _scaled_spd_dia(1024, seed=11)
    op = DIAOperator.from_scipy(a, dtype=torch.float64, device="cpu")
    B = np.random.default_rng(12).standard_normal((1024, 6))
    X, info = solve_psbcgrq(op, torch.from_numpy(B), jacobi_preconditioner(op),
                            tol=1e-10, max_iter=2000)
    _, plain = solve_sbcgrq(op, torch.from_numpy(B), tol=1e-10, max_iter=2000)
    rel = (np.linalg.norm(a @ X.numpy() - B, axis=0) / np.linalg.norm(B, axis=0)).max()
    d = a.diagonal()
    assert rel < max(1e-10 * np.sqrt(d.max() / d.min()) * 10, 1e-7)
    assert info.iterations < 0.7 * plain.iterations


def test_pbcg_f32_on_the_merged_block_operator():
    """Jacobi on the const-hop operator in f32, as the reference's test
    runs it: true relres within 1e-4 at tol 1e-5."""
    op = dirac_cbdia(4, device="cpu")
    a = bdia_scipy(dirac_bdia(4, dtype=torch.float64, device="cpu"))
    B = np.random.default_rng(3).standard_normal((op.n, 4)).astype(np.float32)
    X, info = solve_pbcg(op, torch.from_numpy(B), jacobi_preconditioner(op), tol=1e-5,
                         max_iter=300)
    r = B.astype(np.float64) - a @ X.numpy().astype(np.float64)
    assert X.dtype == torch.float32 and bool(info.converged.all())
    assert (np.linalg.norm(r, axis=0) / np.linalg.norm(B, axis=0)).max() < 1e-4


def test_solvers_reject_bad_input():
    op = DIAOperator.from_scipy(_scaled_spd_dia(64), dtype=torch.float64, device="cpu")
    M = jacobi_preconditioner(op)
    with pytest.raises(ValueError):
        solve_pbcg(op, torch.zeros(64, dtype=torch.float64), M)
    with pytest.raises(ValueError):
        solve_psbcgrq(op, torch.zeros((64, 2), dtype=torch.float64), M, qr_passes=0)
