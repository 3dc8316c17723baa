"""The port's solvers against the reference package and the numpy oracles,
on CPU tensors (the wrappers run their plain versions there).

Tolerances: in f64 the port must take the reference's iteration count and
agree on X to 1e-9 relative (rounding differences amplified by the
recurrence); in f32 iterations within +-2 of the reference and a true
relative residual at most 10 x tol (the f32 recurrence understates it).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import blockcg_tpu as jbc
from blockcg_tpu.problems import laplacian_dia as jlaplacian_dia
from blockcg_tpu.solvers import common as jcommon
from blockcg_tpu.solvers.reference import ref_sbcgrq
from blockcg_tpu_torch import SolverOptions, solve_refined, solve_sbcgrq
from blockcg_tpu_torch.problems import laplacian_dia, laplacian_scipy
from blockcg_tpu_torch.solvers import common


def _rhs(n, k, seed):
    return np.random.default_rng(seed).standard_normal((n, k))


def _true_relres(a, X, B):
    X = np.asarray(X, np.float64)
    return (np.linalg.norm(a @ X - B, axis=0) / np.linalg.norm(B, axis=0)).max()


def _relerr(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("kw", [
    {"qr_passes": 1},
    {"qr_passes": 2},
    {"replace_every": 5, "replace_mode": "restart"},
    {"replace_every": 5, "replace_mode": "rebase"},
    {"record_history": True, "qr_passes": 2},
    {"tol": [1e-6, 1e-8, 1e-10, 1e-9], "active_floor": 1},
    {"iter_cap": 7, "replace_kappa": 1e3},
])
def test_sbcgrq_f64_matches_reference(kw):
    shape = (8, 8, 8)
    kw = {"tol": 1e-10, "max_iter": 200, **kw}
    B = _rhs(512, 4, 1)
    X, info = solve_sbcgrq(laplacian_dia(shape, dtype=torch.float64, device="cpu"),
                           torch.from_numpy(B), **kw)
    jkw = dict(kw, tol=jnp.asarray(kw["tol"]))
    Xj, infoj = jbc.solve_sbcgrq(jlaplacian_dia(shape, dtype=jnp.float64),
                                 jnp.asarray(B), **jkw)
    assert info.iterations == int(infoj.iterations)
    assert info.matvecs == int(infoj.matvecs)
    assert np.array_equal(info.per_rhs_iters.numpy(), np.asarray(infoj.per_rhs_iters))
    assert np.array_equal(info.converged.numpy(), np.asarray(infoj.converged))
    assert bool(info.breakdown) == bool(infoj.breakdown)
    assert _relerr(X, Xj) <= 1e-9
    # relres near 1e-11 carries rounding noise of ~1e-13 (absolute, in units
    # of ||B||): held to 1e-12, 100x below the tolerance.
    np.testing.assert_allclose(info.relres.numpy(), np.asarray(infoj.relres),
                               rtol=1e-6, atol=1e-12)
    if kw.get("record_history"):
        np.testing.assert_allclose(info.history.numpy(), np.asarray(infoj.history),
                                   rtol=1e-6, atol=1e-12, equal_nan=True)


def test_sbcgrq_f64_matches_numpy_oracle():
    shape = (8, 8, 8)
    a = laplacian_scipy(shape)
    B = _rhs(512, 6, 2)
    X, info = solve_sbcgrq(laplacian_dia(shape, dtype=torch.float64, device="cpu"),
                           torch.from_numpy(B), tol=1e-10, max_iter=300)
    Xr, it = ref_sbcgrq(a, B, tol=1e-10)
    assert abs(info.iterations - it) <= 1
    assert _relerr(X, Xr) <= 1e-8
    assert _true_relres(a, X, B) <= 1e-9


def test_sbcgrq_invariant_b_minus_ax_is_qs():
    """B - A X = Q S: the reported relres (column norms of S) equals the true
    residual after any number of iterations."""
    shape = (8, 8, 8)
    a = laplacian_scipy(shape)
    op = laplacian_dia(shape, dtype=torch.float64, device="cpu")
    B = _rhs(512, 4, 3)
    for j in (1, 3, 7):
        X, info = solve_sbcgrq(op, torch.from_numpy(B), tol=1e-13, max_iter=j)
        true = np.linalg.norm(a @ X.numpy() - B, axis=0) / np.linalg.norm(B, axis=0)
        np.testing.assert_allclose(info.relres.numpy(), true, rtol=1e-6, atol=1e-12)


def _ref_cholesky(G):
    return np.asarray(jcommon.safe_cholesky(jnp.asarray(G)))


@pytest.mark.parametrize("G", [
    np.array([[1.0, 2.0], [2.0, 1.0]]),                 # indefinite: both fail
    np.outer([1.0, 2.0, 3.0], [1.0, 2.0, 3.0]),         # singular PSD: jitter
    np.array([[4.0, 1.0, 0.5], [1.0, 3.0, 0.2], [0.5, 0.2, 2.0]]),  # SPD
])
def test_safe_cholesky_matches_reference(G):
    """``cholesky_ex`` returns a finite wrong factor on failure where JAX
    returns NaN; the port must pick the same factor as the reference."""
    L = common.safe_cholesky(torch.from_numpy(G)).numpy()
    Lj = _ref_cholesky(G)
    assert np.array_equal(np.isnan(L), np.isnan(Lj))
    np.testing.assert_allclose(np.nan_to_num(L), np.nan_to_num(Lj), rtol=1e-12, atol=1e-12)


def test_safe_cholesky_batched_matches_reference_vmap():
    """A (3, 3, 3) stack factors matrix by matrix, each with its own jitter,
    as the reference's ``jax.vmap(safe_cholesky)``."""
    import jax

    G = np.stack([
        np.outer([1.0, 2.0, 3.0], [1.0, 2.0, 3.0]),       # singular PSD: jitter
        np.array([[4.0, 1.0, 0.5], [1.0, 3.0, 0.2], [0.5, 0.2, 2.0]]),  # SPD
        np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]]),  # indefinite
    ]) * np.array([1.0, 1e3, 1.0])[:, None, None]
    L = common.safe_cholesky(torch.from_numpy(G)).numpy()
    Lj = np.asarray(jax.vmap(jcommon.safe_cholesky)(jnp.asarray(G)))
    assert np.array_equal(np.isnan(L), np.isnan(Lj))
    np.testing.assert_allclose(np.nan_to_num(L), np.nan_to_num(Lj), rtol=1e-12, atol=1e-12)
    for j in range(3):
        assert np.array_equal(np.nan_to_num(L[j]),
                              np.nan_to_num(common.safe_cholesky(torch.from_numpy(G[j])).numpy()))
    Ginv = common.chol_inverse_spd(torch.from_numpy(G[1:2])).numpy()
    np.testing.assert_allclose(Ginv[0] @ G[1], np.eye(3), atol=1e-12)


def test_sbcgrq_f32_matches_reference():
    shape = (16, 16, 16)
    a = laplacian_scipy(shape)
    B = _rhs(4096, 8, 4)
    tol = 1e-5
    X, info = solve_sbcgrq(laplacian_dia(shape, device="cpu"), torch.from_numpy(B).float(), tol=tol)
    Xj, infoj = jbc.solve_sbcgrq(jlaplacian_dia(shape, dtype=jnp.float32),
                                 jnp.asarray(B, jnp.float32), tol=tol)
    assert bool(info.converged.all())
    assert abs(info.iterations - int(infoj.iterations)) <= 2
    assert _true_relres(a, X, B) <= 10 * tol


def test_sbcgrq_breakdown_flag_matches_reference():
    """Near-parallel RHS columns: neither package converges, both say so."""
    shape = (16, 16)
    n = 256
    rng = np.random.default_rng(5)
    B = rng.standard_normal((n, 16))
    idx = np.arange(n)
    for j in range(8):
        B[:, j] = np.sin((idx + 1) * (j + 1) / 16 * 2 * np.pi / n)
    X, info = solve_sbcgrq(laplacian_dia(shape, device="cpu"), torch.from_numpy(B).float(),
                           tol=1e-6, max_iter=120)
    _, infoj = jbc.solve_sbcgrq(jlaplacian_dia(shape, dtype=jnp.float32),
                                jnp.asarray(B, jnp.float32), tol=1e-6, max_iter=120)
    assert not bool(info.converged.all()) and not bool(infoj.converged.all())
    assert bool(info.breakdown) and bool(infoj.breakdown)


def test_sbcgrq_repeat_is_bitwise_and_leaves_inputs():
    op = laplacian_dia((12, 12), device="cpu")
    B = torch.from_numpy(_rhs(144, 4, 6)).float()
    X0 = torch.full((144, 4), 0.1)
    B_in, X0_in = B.clone(), X0.clone()
    X1, i1 = solve_sbcgrq(op, B, X0, **SolverOptions(tol=1e-6).kwargs())
    X2, i2 = solve_sbcgrq(op, B, X0, tol=1e-6)
    assert torch.equal(X1, X2) and i1.iterations == i2.iterations
    assert torch.equal(B, B_in) and torch.equal(X0, X0_in)


def test_sbcgrq_rejects_tf32_and_bad_options():
    op = laplacian_dia((4, 4), device="cpu")
    B = torch.ones(16, 2)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            solve_sbcgrq(op, B)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    with pytest.raises(ValueError):
        solve_sbcgrq(op, torch.ones(16))
    with pytest.raises(ValueError):
        solve_sbcgrq(op, B, qr_passes=0)
    with pytest.raises(ValueError):
        solve_sbcgrq(op, B, replace_mode="other")


@pytest.mark.parametrize("qr_passes,inner_tol", [(2, 1e-5), (1, 3e-6)])
def test_refined_reaches_1e10_like_reference(qr_passes, inner_tol):
    shape = (10, 10, 10)
    a = laplacian_scipy(shape)
    B = _rhs(1000, 4, 7)
    X, info = solve_refined(laplacian_dia(shape, device="cpu"), torch.from_numpy(B),
                            tol=1e-10, inner_tol=inner_tol, qr_passes=qr_passes)
    assert X.dtype == torch.float64
    assert bool(info.converged.all()) and info.iterations <= 4
    assert _true_relres(a, X, B) <= 1e-10
    _, infoj = jbc.solve_refined(jlaplacian_dia(shape, dtype=jnp.float32),
                                 jnp.asarray(B), tol=1e-10, inner_tol=inner_tol,
                                 qr_passes=qr_passes)
    assert abs(info.iterations - int(infoj.iterations)) <= 1


def test_refined_checkpoint_resume(tmp_path):
    """Kill and resume: a fresh call with the same checkpoint path warm-starts
    from the saved X and needs fewer cycles."""
    shape = (10, 10, 10)
    op = laplacian_dia(shape, device="cpu")
    a = laplacian_scipy(shape)
    B = _rhs(1000, 4, 9)
    ck = str(tmp_path / "solve.npz")
    X1, info1 = solve_refined(op, torch.from_numpy(B), tol=1e-10, inner_tol=1e-4,
                              max_cycles=1, checkpoint_path=ck)
    assert not bool(info1.converged.all())
    X2, info2 = solve_refined(op, torch.from_numpy(B), tol=1e-10, inner_tol=1e-4,
                              checkpoint_path=ck)
    assert bool(info2.converged.all())
    assert _true_relres(a, X2, B) <= 1e-10
    X3, info3 = solve_refined(op, torch.from_numpy(B), tol=1e-10, inner_tol=1e-4)
    assert info2.iterations < info3.iterations
    assert op.dtype == torch.float32  # the outer f64 operator is a new one


def test_refined_outer_operator_and_dtype():
    """``op64`` replaces the default f64 copy of the operator; an f32
    ``outer_dtype`` floors the outer residual near the f32 epsilon."""
    shape = (8, 8, 8)
    a = laplacian_scipy(shape)
    B = _rhs(512, 4, 10)
    op = laplacian_dia(shape, device="cpu")
    X, info = solve_refined(op, torch.from_numpy(B), tol=1e-10,
                            op64=laplacian_dia(shape, dtype=torch.float64, device="cpu"))
    assert bool(info.converged.all()) and _true_relres(a, X, B) <= 1e-10
    X32, info32 = solve_refined(op, torch.from_numpy(B), tol=1e-10, max_cycles=3,
                                outer_dtype=torch.float32)
    assert X32.dtype == torch.float32 and not bool(info32.converged.all())
    assert 1e-10 < _true_relres(a, X32, B) <= 1e-5


def test_refined_inner_solver_choice():
    shape = (4, 4)
    op = laplacian_dia(shape, device="cpu")
    B = _rhs(16, 2, 11)
    X, info = solve_refined(op, torch.from_numpy(B), inner_solver="bcg")
    assert bool(info.converged.all())
    assert _true_relres(laplacian_scipy(shape), X, B) <= 1e-10
    with pytest.raises(ValueError):
        solve_refined(op, torch.ones(16, 2), inner_solver="cg")
