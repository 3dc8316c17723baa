"""The port's multi-shift solvers against the reference package, on CPU
tensors (the wrappers run their plain versions there).

In f64 on a 2D Laplacian and ``dirac_cbdia(4)``, with the shift lists of the
reference's own tests, the port takes the reference's iteration count and
agrees on X to 1e-9 relative (rounding amplified by the recurrence) and on
the per-shift relres to 1e-6 relative or 1e-12 absolute (rounding noise near
convergence, in units of ||b||). Each shift's true residual is held to the
matrix ``A + sigma I`` in f64.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

from blockcg_tpu.problems import bdia_scipy
from blockcg_tpu.problems import dirac as jdirac
from blockcg_tpu.problems import laplacian_dia as jlaplacian_dia
from blockcg_tpu.solvers.shifted import solve_shifted_cg as jsolve_shifted_cg
from blockcg_tpu.solvers.shifted_block import solve_shifted_sbcgrq as jsolve_shifted_sbcgrq
from blockcg_tpu_torch import solve_sbcgrq, solve_shifted_cg, solve_shifted_sbcgrq
from blockcg_tpu_torch.problems import dirac_cbdia, laplacian_dia, laplacian_scipy

CG_SIGMAS = [0.0, 0.1, 1.0, 10.0]  # tests/test_shifted.py
BLOCK_SIGMAS = [0.0, 0.3, 1.7, 10.0]  # tests/test_shifted_block.py


def _np(t):
    return np.asarray(t, np.float64)


def _relerr(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _operators(name):
    """(port f64 operator, reference f64 operator, scipy matrix)."""
    if name == "laplacian":
        shape = (16, 16)
        return (laplacian_dia(shape, dtype=torch.float64, device="cpu"),
                jlaplacian_dia(shape, dtype=jnp.float64), laplacian_scipy(shape))
    jop = jdirac.dirac_cbdia(4, dtype=jnp.float64)
    return dirac_cbdia(4, dtype=torch.float64, device="cpu"), jop, bdia_scipy(jop.to_block_dia())


def _shifted_relres(a, X, B, sigma):
    R = B - (a + sigma * sp.eye(a.shape[0])) @ X
    return np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)


@pytest.mark.parametrize("opname", ["laplacian", "dirac"])
def test_shifted_cg_f64_matches_reference(opname):
    op, jop, a = _operators(opname)
    b = np.random.default_rng(1).standard_normal(op.n)
    X, info = solve_shifted_cg(op, torch.from_numpy(b), CG_SIGMAS, tol=1e-10, max_iter=500)
    Xj, infoj = jsolve_shifted_cg(jop, jnp.asarray(b), CG_SIGMAS, tol=1e-10, max_iter=500)
    assert X.shape == (op.n, len(CG_SIGMAS))
    assert bool(info.converged.all())
    assert info.iterations == int(infoj.iterations) == info.matvecs
    assert _relerr(X, Xj) <= 1e-9
    np.testing.assert_allclose(info.relres.numpy(), np.asarray(infoj.relres),
                               rtol=1e-6, atol=1e-12)
    for j, s in enumerate(CG_SIGMAS):
        assert _shifted_relres(a, X.numpy()[:, j], b, s) <= 1e-9


def test_shifted_cg_frozen_shift_reports_its_norm():
    """A large shift converges first and is frozen; it keeps reporting the
    norm at which it froze, which is its true residual, while the seed goes
    on converging."""
    op, jop, a = _operators("laplacian")
    b = np.random.default_rng(2).standard_normal(op.n)
    sig = [0.0, 10.0]
    X, info = solve_shifted_cg(op, torch.from_numpy(b), sig, tol=1e-8, max_iter=500,
                               record_history=True)
    _, infoj = jsolve_shifted_cg(jop, jnp.asarray(b), sig, tol=1e-8, max_iter=500)
    np.testing.assert_allclose(info.relres.numpy(), np.asarray(infoj.relres),
                               rtol=1e-6, atol=1e-12)
    frozen = float(info.relres[1])
    true = _shifted_relres(a, X.numpy()[:, 1], b, 10.0)
    np.testing.assert_allclose(frozen, true, rtol=1e-3)
    # Stopped halfway, the seed is still far from converged, but the shift
    # had frozen already and reports the same norm, to the bit.
    _, half = solve_shifted_cg(op, torch.from_numpy(b), sig, tol=1e-8,
                               max_iter=info.iterations // 2)
    assert float(half.relres[0]) > 1e3 * float(info.relres[0])
    assert float(half.relres[1]) == frozen
    assert np.isfinite(info.history.numpy()[: info.iterations]).all()


@pytest.mark.parametrize("opname,qr_passes", [("laplacian", 2), ("laplacian", 1),
                                              ("dirac", 2)])
def test_shifted_sbcgrq_f64_matches_reference(opname, qr_passes):
    op, jop, a = _operators(opname)
    B = np.random.default_rng(3).standard_normal((op.n, 4))
    Xs, info = solve_shifted_sbcgrq(op, torch.from_numpy(B), BLOCK_SIGMAS, tol=1e-9,
                                    max_iter=400, qr_passes=qr_passes)
    Xj, infoj = jsolve_shifted_sbcgrq(jop, jnp.asarray(B), BLOCK_SIGMAS, tol=1e-9,
                                      max_iter=400, qr_passes=qr_passes)
    assert Xs.shape == (len(BLOCK_SIGMAS), op.n, 4)
    assert bool(info.converged.all())
    assert info.iterations == int(infoj.iterations) == info.matvecs
    assert info.relres.shape == (len(BLOCK_SIGMAS), 4)
    assert _relerr(Xs, Xj) <= 1e-9
    np.testing.assert_allclose(info.relres.numpy(), np.asarray(infoj.relres),
                               rtol=1e-6, atol=1e-12)
    for j, s in enumerate(BLOCK_SIGMAS):
        assert _shifted_relres(a, Xs.numpy()[j], B, s).max() <= 1e-8


def test_shifted_seed_matches_sbcgrq():
    """sigma = 0 reproduces the plain SBCGrQ solution."""
    op = laplacian_dia((16, 16), dtype=torch.float64, device="cpu")
    B = torch.from_numpy(np.random.default_rng(4).standard_normal((op.n, 3)))
    Xs, _ = solve_shifted_sbcgrq(op, B, [0.0, 1.0], tol=1e-10, max_iter=600)
    X0, _ = solve_sbcgrq(op, B, tol=1e-10, max_iter=600)
    assert (Xs[0] - X0).abs().max() < 1e-7


def test_shifted_history_and_inputs():
    op, jop, _ = _operators("laplacian")
    B = np.random.default_rng(5).standard_normal((op.n, 2))
    Bt = torch.from_numpy(B)
    _, info = solve_shifted_sbcgrq(op, Bt, [0.0, 2.0], tol=1e-8, max_iter=80,
                                   record_history=True)
    _, infoj = jsolve_shifted_sbcgrq(jop, jnp.asarray(B), [0.0, 2.0], tol=1e-8,
                                     max_iter=80, record_history=True)
    np.testing.assert_allclose(info.history.numpy(), np.asarray(infoj.history),
                               rtol=1e-6, atol=1e-12, equal_nan=True)
    assert np.array_equal(Bt.numpy(), B)  # the block is not modified


def test_shifted_solvers_reject_bad_input():
    op = laplacian_dia((4, 4), device="cpu")
    with pytest.raises(ValueError):
        solve_shifted_cg(op, torch.zeros(16, 2), [0.0])
    with pytest.raises(ValueError):
        solve_shifted_sbcgrq(op, torch.zeros(16), [0.0])
    with pytest.raises(ValueError):
        solve_shifted_sbcgrq(op, torch.zeros(16, 2), [0.0], qr_passes=0)
    with pytest.raises(NotImplementedError, match="realify"):
        solve_shifted_sbcgrq(op, torch.zeros(16, 2, dtype=torch.complex128), [0.0])
