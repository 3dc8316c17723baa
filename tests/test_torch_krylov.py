"""The port's CG, BCG, BCGA and BCGdQ (configs 1 and 2) against the reference
package and the numpy oracles, on CPU tensors (the wrappers run their plain
versions there).

Operators: the DIA Laplacian, ``dirac_cbdia(4)`` in the const-hop container
(k = 1 for CG, k = 4 for the block solvers) and a dense ``random_spd(64)``.
Tolerances: in f64 the port takes the reference's iteration and matvec
counts and agrees on X to 1e-9 relative (rounding differences amplified by
the recurrence) and on the reported relres to 1e-6 relative or 1e-11
absolute, 10x below the tolerance of 1e-10 (the dense solve ends where its
Krylov space is exhausted, at a relres of ~1e-13 that is rounding noise of
~1e-12); in f32 the iterations are within +-2 of the reference's.

BCG, BCGA and BCGdQ report the recurrence's monitor ``sqrt(diag S)``, not the
true residual, as the reference does; the BCG tests hold the monitor and the
true residual to the numpy oracle separately.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import blockcg_tpu as jbc
from blockcg_tpu.operators import DenseOperator as JDenseOperator
from blockcg_tpu.problems import dirac as jdirac
from blockcg_tpu.problems import laplacian_dia as jlaplacian_dia
from blockcg_tpu.problems import presets as jpresets
from blockcg_tpu.problems.random_spd import random_block as jrandom_block
from blockcg_tpu.problems.random_spd import random_block_c as jrandom_block_c
from blockcg_tpu.problems.random_spd import random_hpd as jrandom_hpd
from blockcg_tpu.problems.random_spd import random_spd as jrandom_spd
from blockcg_tpu.problems import bdia_scipy
from blockcg_tpu.solvers.reference import ref_bcg, ref_cg
import blockcg_tpu_torch as bt
from blockcg_tpu_torch import DenseOperator
from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.problems import (
    PRESETS,
    config1_cg_2d_128,
    config2_bcg_2d_512,
    dirac_cbdia,
    laplacian_dia,
    laplacian_scipy,
    random_block,
    random_block_c,
    random_hpd,
    random_spd,
)

SOLVERS = {
    "cg": {},
    "bcg": {},
    "bcga": {},
    "bcgdq1": {"qr_passes": 1},
    "bcgdq2": {"qr_passes": 2},
}


def _np(t):
    return np.asarray(t, np.float64)


def _relerr(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _operators(name, dtype):
    """(port operator, reference operator, f64 scipy/numpy matrix)."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    if name == "laplacian":
        shape = (8, 8, 8)
        return (laplacian_dia(shape, dtype=dtype, device="cpu"), jlaplacian_dia(shape, dtype=jdt),
                laplacian_scipy(shape))
    if name == "dirac":
        jop = jdirac.dirac_cbdia(4, dtype=jdt)
        return dirac_cbdia(4, dtype=dtype, device="cpu"), jop, bdia_scipy(jop.to_block_dia())
    a = random_spd(64, seed=3)
    return DenseOperator.from_numpy(a, dtype=dtype, device="cpu"), JDenseOperator(A=jnp.asarray(a, jdt)), a


def _solve(solver, op, jop, B, **kw):
    """Run one solver in both packages on the same numpy B; CG takes its
    first column."""
    kw = {**SOLVERS[solver], **kw}
    name = "solve_" + solver.rstrip("12")
    if solver == "cg":
        B = B[:, 0]
    X, info = getattr(bt, name)(op, torch.from_numpy(B), **kw)
    Xj, infoj = getattr(jbc, name)(jop, jnp.asarray(B), **kw)
    return X, info, Xj, infoj


@pytest.mark.parametrize("opname", ["laplacian", "dirac", "dense"])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_f64_matches_reference(solver, opname):
    """On ``dirac_cbdia`` CG's k = 1 field is the merged (bs, ns) view, which
    the port sends through its merged const-hop kernel (m = 4); the reference
    routes the same field to its (k, bs, ns) kernels. Parity is in what is
    computed, not in which kernel runs."""
    op, jop, _ = _operators(opname, torch.float64)
    B = np.random.default_rng(1).standard_normal((op.n, 4))
    X, info, Xj, infoj = _solve(solver, op, jop, B, tol=1e-10, max_iter=300)
    assert bool(info.converged.all())
    assert info.iterations == int(infoj.iterations)
    assert info.matvecs == int(infoj.matvecs)
    assert _relerr(X, Xj) <= 1e-9
    np.testing.assert_allclose(info.relres.numpy(), np.asarray(infoj.relres),
                               rtol=1e-6, atol=1e-11)


@pytest.mark.parametrize("solver", list(SOLVERS))
def test_history_matches_reference(solver):
    op, jop, _ = _operators("laplacian", torch.float64)
    B = np.random.default_rng(2).standard_normal((op.n, 3))
    _, info, _, infoj = _solve(solver, op, jop, B, tol=1e-8, max_iter=60,
                               record_history=True)
    np.testing.assert_allclose(info.history.numpy(), np.asarray(infoj.history),
                               rtol=1e-6, atol=1e-12, equal_nan=True)


def test_cg_matches_numpy_oracle():
    shape = (16, 16)
    a = laplacian_scipy(shape)
    b = np.random.default_rng(3).standard_normal(256)
    x, info = bt.solve_cg(laplacian_dia(shape, dtype=torch.float64, device="cpu"),
                          torch.from_numpy(b), tol=1e-10)
    xr, it = ref_cg(a, b, tol=1e-10)
    assert info.iterations == it
    assert _relerr(x, xr) <= 1e-9
    true = np.linalg.norm(a @ x.numpy() - b) / np.linalg.norm(b)
    np.testing.assert_allclose(float(info.relres[0]), true, rtol=1e-6, atol=1e-13)


def test_bcg_monitor_and_true_residual_match_oracle():
    """The monitor (the reported relres, from the recurrence's S) and the
    true residual of X, each against ``ref_bcg``."""
    shape = (16, 16)
    a = laplacian_scipy(shape)
    B = np.random.default_rng(4).standard_normal((256, 4))
    X, info = bt.solve_bcg(laplacian_dia(shape, dtype=torch.float64, device="cpu"),
                           torch.from_numpy(B), tol=1e-10)
    Xr, it = ref_bcg(a, B, tol=1e-10)
    assert info.iterations == it
    assert _relerr(X, Xr) <= 1e-9
    bnorm = np.linalg.norm(B, axis=0)
    true = np.linalg.norm(a @ X.numpy() - B, axis=0) / bnorm
    true_ref = np.linalg.norm(a @ Xr - B, axis=0) / bnorm
    assert bool(info.converged.all()) and info.relres.max() <= 1e-10  # the monitor
    assert true.max() <= 1e-9 and true_ref.max() <= 1e-9  # the truth
    np.testing.assert_allclose(true, true_ref, rtol=1e-3, atol=1e-13)


@pytest.mark.parametrize("opname", ["laplacian2d", "dirac"])
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_f32_iterations_match_reference(solver, opname):
    if opname == "dirac":
        op, jop, a = _operators("dirac", torch.float32)
    else:
        shape = (16, 16)
        op, jop, a = (laplacian_dia(shape, device="cpu"), jlaplacian_dia(shape, dtype=jnp.float32),
                      laplacian_scipy(shape))
    tol = 1e-5
    B = np.random.default_rng(5).standard_normal((op.n, 4)).astype(np.float32)
    X, info, _, infoj = _solve(solver, op, jop, B, tol=tol, max_iter=500)
    assert bool(info.converged.all())
    assert abs(info.iterations - int(infoj.iterations)) <= 2
    Bc = B[:, :1] if solver == "cg" else B
    Xc = _np(X).reshape(Bc.shape)
    true = np.linalg.norm(a @ Xc - Bc, axis=0) / np.linalg.norm(Bc, axis=0)
    assert true.max() <= 10 * tol


def test_refined_bcg_reaches_1e10_like_reference():
    shape = (10, 10, 10)
    a = laplacian_scipy(shape)
    B = np.random.default_rng(7).standard_normal((1000, 4))
    X, info = bt.solve_refined(laplacian_dia(shape, device="cpu"), torch.from_numpy(B), tol=1e-10,
                               inner_solver="bcg")
    assert X.dtype == torch.float64 and bool(info.converged.all())
    true = np.linalg.norm(a @ X.numpy() - B, axis=0) / np.linalg.norm(B, axis=0)
    assert true.max() <= 1e-10
    _, infoj = jbc.solve_refined(jlaplacian_dia(shape, dtype=jnp.float32),
                                 jnp.asarray(B), tol=1e-10, inner_solver="bcg")
    assert abs(info.iterations - int(infoj.iterations)) <= 1


def test_solvers_leave_inputs_and_repeat_bitwise():
    op = laplacian_dia((12, 12), device="cpu")
    B = torch.from_numpy(np.random.default_rng(8).standard_normal((144, 3))).float()
    X0 = torch.full((144, 3), 0.1)
    B_in, X0_in = B.clone(), X0.clone()
    for name in ("solve_bcg", "solve_bcga", "solve_bcgdq"):
        X1, i1 = getattr(bt, name)(op, B, X0, tol=1e-6)
        X2, i2 = getattr(bt, name)(op, B, X0, tol=1e-6)
        assert torch.equal(X1, X2) and i1.iterations == i2.iterations
    x1, _ = bt.solve_cg(op, B[:, 1], X0[:, 1], tol=1e-6)  # a strided column
    x2, _ = bt.solve_cg(op, B[:, 1:2], X0[:, 1:2], tol=1e-6)
    assert torch.equal(x1, x2[:, 0])
    assert torch.equal(B, B_in) and torch.equal(X0, X0_in)
    assert sum(_native.launches.values()) == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("name", ["solve_bcg", "solve_bcga", "solve_bcgdq"])
def test_block_solvers_reject_bad_input(name):
    op = laplacian_dia((4, 4), device="cpu")
    with pytest.raises(ValueError):
        getattr(bt, name)(op, torch.ones(16))
    with pytest.raises(NotImplementedError, match="realify"):
        getattr(bt, name)(op, torch.ones(16, 2, dtype=torch.complex64))
    with pytest.raises(ValueError):
        getattr(jbc, name)(jlaplacian_dia((4, 4)), jnp.ones(16))  # as the reference


def test_cg_rejects_bad_input_and_options():
    op = laplacian_dia((4, 4), device="cpu")
    with pytest.raises(ValueError):
        bt.solve_cg(op, torch.ones(16, 2))
    with pytest.raises(NotImplementedError, match="realify"):
        bt.solve_cg(op, torch.ones(16, dtype=torch.complex64))
    with pytest.raises(ValueError):
        bt.solve_bcgdq(op, torch.ones(16, 2), qr_passes=0)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            bt.solve_cg(op, torch.ones(16))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert bt.solve_bcgrq is bt.solve_sbcgrq


# ------------------------------------------- problems and the dense operator


def test_random_spd_matches_reference_bitwise():
    assert np.array_equal(random_spd(40, delta=0.5, seed=3), jrandom_spd(40, 0.5, 3))
    assert np.array_equal(random_block(40, 3, seed=4), jrandom_block(40, 3, 4))
    assert np.array_equal(random_hpd(20, seed=5), jrandom_hpd(20, seed=5))
    assert np.array_equal(random_block_c(20, 2, seed=6), jrandom_block_c(20, 2, 6))


def test_dense_operator_applies_and_converts():
    a = random_spd(64, seed=9)
    op = DenseOperator.from_numpy(a, device="cpu")
    X = np.random.default_rng(10).standard_normal((64, 3))
    np.testing.assert_allclose(op.matmat(torch.from_numpy(X)).numpy(), a @ X, rtol=1e-12)
    np.testing.assert_allclose(op(torch.from_numpy(X[:, 0])).numpy(), a @ X[:, 0], rtol=1e-12)
    np.testing.assert_allclose(op.matmat_t(torch.from_numpy(X.T.copy())).numpy(), (a @ X).T,
                               rtol=1e-12)
    op32 = op.astype_op(torch.float32)
    assert op32.dtype == torch.float32 and op.dtype == torch.float64
    assert op.shape == (64, 64) and op.nnz == 64 * 64 and op.n == 64
    with pytest.raises(ValueError):
        DenseOperator(torch.ones(3, 4))


@pytest.mark.parametrize("preset,jpreset", [
    (config1_cg_2d_128, jpresets.config1_cg_2d_128),
    (config2_bcg_2d_512, jpresets.config2_bcg_2d_512),
])
def test_presets_of_configs_1_and_2_match_reference(preset, jpreset):
    op, B, meta = preset(device="cpu")
    jop, jB, jmeta = jpreset()
    assert meta == jmeta and PRESETS[meta["name"]] is preset
    assert op.offsets == jop.offsets and op.n == jop.n
    assert np.array_equal(op.diags.numpy(), np.asarray(jop.diags))
    assert B.dtype == torch.float32 and np.array_equal(B.numpy(), np.asarray(jB))
