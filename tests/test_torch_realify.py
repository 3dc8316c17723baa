"""The port's realified complex operators (``operators/realify.py``, the
complex lattice builders) against the reference package, on CPU tensors.

A complex Hermitian operator runs on the card as its real symmetric form
``[[Re A, -Im A], [Im A, Re A]]`` on stacked (re, im) fields. These tests
hold the realified cores bitwise against the reference's, the complex
applies against the scipy oracle in complex128 (1e-12), the codec against
the reference's, and the f64 solves on realified operators against the
reference's realified solves (iteration counts equal, X to 1e-9); the f32
solves by their true residual. Inputs come from numpy seeds.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import blockcg_tpu as jbc
from blockcg_tpu.operators import DenseOperator as JDenseOperator
from blockcg_tpu.operators import realify as jrealify
from blockcg_tpu.operators.base import astype as jastype
from blockcg_tpu.problems import dirac as jdirac
from blockcg_tpu_torch import (
    ConstBlockDIAOperator,
    DenseOperator,
    RealifiedHermitianOperator,
    realify,
    solve_bcg,
    solve_cg,
    solve_refined,
    solve_sbcgrq,
    solve_shifted_cg,
    solve_shifted_sbcgrq,
)
from blockcg_tpu_torch.operators import astype
from blockcg_tpu_torch.problems import (
    bdia_scipy,
    dirac_bdia,
    dirac_cbdia,
    dirac_gauged,
    dirac_gauged_cbdia,
    dirac_gauged_matrix,
    random_hpd,
)

JDT = {torch.complex64: jnp.complex64, torch.complex128: jnp.complex128}


def _cfield(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _relres(a, X, B):
    R = B - a @ X
    return (np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)).max()


def _same_cbdia_core(core, jcore):
    assert core.hops == jcore.hops and core.offsets == jcore.offsets
    assert core.mask_slot == jcore.mask_slot and core.num_sites == jcore.num_sites
    assert core.slabs == jcore.slabs and core.nnz == jcore.nnz
    jm = np.asarray(jcore.masks)
    assert core.masks.numpy().dtype == jm.dtype and np.array_equal(core.masks.numpy(), jm)


def _same_wrapper(rop, jrop):
    assert isinstance(rop, RealifiedHermitianOperator)
    assert (rop.cbs, rop.num_sites, rop.n, rop.nnz) == (jrop.cbs, jrop.num_sites, jrop.n,
                                                        jrop.nnz)
    assert JDT[rop.dtype] == jrop.cdtype


# ------------------------------------------------------------ realified cores


@pytest.mark.parametrize("L,bc,dtype", [(3, "periodic", torch.complex128),
                                        (4, "open", torch.complex64),
                                        (16, "periodic", torch.complex64)])
def test_realify_cbdia_core_matches_reference(L, bc, dtype):
    """Doubled hops over the same masks; the slabs of the L = 16 z-wraps
    ride along."""
    cop = dirac_cbdia(L, bc=bc, dtype=dtype, device="cpu")
    jcop = jdirac.dirac_cbdia(L, bc=bc, dtype=JDT[dtype])
    assert cop.hops == jcop.hops and cop.dtype == dtype  # a complex container
    rop, jrop = realify(cop), jrealify(jcop)
    _same_wrapper(rop, jrop)
    _same_cbdia_core(rop.real_op, jrop.real_op)
    assert rop.real_op.bs == 8 and (len(rop.real_op.slabs) == 2) == (L == 16)


@pytest.mark.parametrize("name,L,dtype", [("dirac_gauged_matrix", 3, torch.complex64),
                                          ("dirac_gauged_matrix", 4, torch.complex128),
                                          ("dirac_gauged", 3, torch.complex128)])
def test_realify_bdia_core_matches_reference(name, L, dtype):
    op = {"dirac_gauged_matrix": dirac_gauged_matrix, "dirac_gauged": dirac_gauged}[name](
        L, dtype=dtype, device="cpu")
    rop, jrop = realify(op), jrealify(getattr(jdirac, name)(L, dtype=JDT[dtype]))
    _same_wrapper(rop, jrop)
    jb = np.asarray(jrop.real_op.blocks)
    core = rop.real_op
    assert core.blocks.numpy().dtype == jb.dtype and np.array_equal(core.blocks.numpy(), jb)
    assert core.offsets == jrop.real_op.offsets and core.nnz == jrop.real_op.nnz
    assert core.wrap_zero == jrop.real_op.wrap_zero


def test_realify_dense_core_matches_reference():
    A = random_hpd(24, seed=3)
    rop = realify(DenseOperator.from_numpy(A, device="cpu"))
    jrop = jrealify(JDenseOperator(A=jnp.asarray(A)))
    _same_wrapper(rop, jrop)
    assert np.array_equal(rop.real_op.A.numpy(), np.asarray(jrop.real_op.A))


@pytest.mark.parametrize("L,bc", [(3, "periodic"), (4, "open")])
def test_u1_gauged_cbdia_matches_reference(L, bc):
    """The complex dirac_gauged_cbdia is realified at build: 29 (periodic)
    value-masked diagonals of K1/K2 blocks over a bs = 8 core."""
    rop = dirac_gauged_cbdia(L, bc=bc, dtype=torch.complex128, device="cpu")
    jrop = jdirac.dirac_gauged_cbdia(L, bc=bc, dtype=jnp.complex128)
    _same_wrapper(rop, jrop)
    _same_cbdia_core(rop.real_op, jrop.real_op)
    assert rop.real_op.bs == 8 and rop.real_op.slabs == ()
    assert len(rop.real_op.offsets) == (29 if bc == "periodic" else 17)


# ------------------------------------------------------------ complex applies


@pytest.mark.parametrize("build", ["cbdia", "bdia", "gauged_cbdia", "matrix"])
def test_complex_apply_matches_scipy(build):
    """The realified operator's complex apply against the complex oracle in
    complex128."""
    L = 3
    if build == "cbdia":
        rop, a = (realify(dirac_cbdia(L, dtype=torch.complex128, device="cpu")),
                  bdia_scipy(dirac_bdia(L, dtype=torch.complex128, device="cpu")))
    elif build == "bdia":
        op = dirac_bdia(L, dtype=torch.complex128, device="cpu")
        rop, a = realify(op), bdia_scipy(op)
    elif build == "gauged_cbdia":
        rop = dirac_gauged_cbdia(L, dtype=torch.complex128, device="cpu")
        a = bdia_scipy(dirac_gauged(L, dtype=torch.complex128, device="cpu"))
    else:
        op = dirac_gauged_matrix(L, dtype=torch.complex128, device="cpu")
        rop, a = realify(op), bdia_scipy(op)
    X = _cfield((rop.n, 3), 1)
    want = a @ X
    got = rop.matmat(torch.from_numpy(X))
    assert got.dtype == torch.complex128
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-12
    assert np.abs(rop(torch.from_numpy(X[:, 0])).numpy() - want[:, 0]).max() < 1e-11


def test_complex_cbdia_container_applies_on_cpu():
    """Complex hops without realify: the plain apply on CPU tensors."""
    op = dirac_cbdia(3, dtype=torch.complex128, device="cpu")
    a = bdia_scipy(dirac_bdia(3, dtype=torch.complex128, device="cpu"))
    X = _cfield((op.n, 2), 2)
    got = op.matmat(torch.from_numpy(X)).numpy()
    assert np.abs(got - a @ X).max() / np.abs(a @ X).max() < 1e-12


@pytest.mark.parametrize("build", ["cbdia", "matrix", "dense"])
def test_codec_matches_reference(build):
    """to_internal equals the reference's bitwise (the real core's merged
    view of the stacked field); from_internal inverts it."""
    if build == "cbdia":
        rop = realify(dirac_cbdia(3, dtype=torch.complex64, device="cpu"))
        jrop = jrealify(jdirac.dirac_cbdia(3, dtype=jnp.complex64))
    elif build == "matrix":
        rop = realify(dirac_gauged_matrix(3, dtype=torch.complex128, device="cpu"))
        jrop = jrealify(jdirac.dirac_gauged_matrix(3, dtype=jnp.complex128))
    else:
        A = random_hpd(20, seed=4)
        rop = realify(DenseOperator.from_numpy(A, dtype=torch.complex64, device="cpu"))
        jrop = jrealify(JDenseOperator(A=jnp.asarray(A, jnp.complex64)))
    cdt = np.complex64 if rop.dtype == torch.complex64 else np.complex128
    X = _cfield((3, rop.n), 5).astype(cdt)
    Xf = rop.to_internal(torch.from_numpy(X))
    jXf = np.asarray(jrop.to_internal(jnp.asarray(X)))
    assert Xf.numpy().dtype == jXf.dtype and np.array_equal(Xf.numpy(), jXf)
    back = rop.from_internal(Xf)
    assert back.dtype == rop.dtype and np.array_equal(back.numpy(), X)
    assert np.array_equal(back.numpy(), np.asarray(jrop.from_internal(jnp.asarray(jXf))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.complex64,
                                   torch.complex128])
def test_astype_widths_match_reference(dtype):
    rop = realify(dirac_gauged_matrix(3, dtype=torch.complex64, device="cpu"))
    jrop = jrealify(jdirac.dirac_gauged_matrix(3, dtype=jnp.complex64))
    wide, jwide = astype(rop, dtype), jastype(jrop, {torch.float32: jnp.float32,
                                                     torch.float64: jnp.float64,
                                                     **JDT}[dtype])
    assert JDT[wide.dtype] == jwide.cdtype
    assert wide.real_op.dtype == wide.dtype.to_real() and wide.nnz == rop.nnz
    assert rop.dtype == torch.complex64  # the original is left as it was


# ---------------------------------------------------------------- solves


@pytest.mark.parametrize("build", ["matrix", "gauged_cbdia"])
def test_sbcgrq_f64_realified_matches_reference(build):
    """f64 SBCGrQ on realify(dirac_gauged_matrix(4)) and the U(1)
    dirac_gauged_cbdia(4): the reference's realified iteration counts."""
    if build == "matrix":
        rop = realify(dirac_gauged_matrix(4, dtype=torch.complex128, device="cpu"))
        jrop = jrealify(jdirac.dirac_gauged_matrix(4, dtype=jnp.complex128))
    else:
        rop = dirac_gauged_cbdia(4, dtype=torch.complex128, device="cpu")
        jrop = jdirac.dirac_gauged_cbdia(4, dtype=jnp.complex128)
    B = _cfield((rop.n, 3), 6)
    X, info = solve_sbcgrq(rop, torch.from_numpy(B), tol=1e-10, max_iter=300)
    Xj, infoj = jbc.solve_sbcgrq(jrop, jnp.asarray(B), tol=1e-10, max_iter=300)
    assert X.dtype == torch.complex128 and bool(info.converged.all())
    assert info.iterations == int(infoj.iterations) and info.matvecs == int(infoj.matvecs)
    Xj = np.asarray(Xj)
    assert np.abs(X.numpy() - Xj).max() / np.abs(Xj).max() <= 1e-9


def test_cg_and_refined_on_realified():
    """solve_cg (f64) and solve_refined (f32 inner, c128 outer) on the
    realified matrix-link operator at L = 3: true relres by the complex
    oracle."""
    op64 = dirac_gauged_matrix(3, dtype=torch.complex128, device="cpu")
    a = bdia_scipy(op64)
    b = _cfield((op64.n,), 7)
    x, info = solve_cg(realify(op64), torch.from_numpy(b), tol=1e-10, max_iter=500)
    assert x.dtype == torch.complex128 and bool(info.converged.all())
    assert _relres(a, x.numpy()[:, None], b[:, None]) <= 1e-9
    op32 = dirac_gauged_matrix(3, dtype=torch.complex64, device="cpu")
    a32 = bdia_scipy(op32)  # the matrix the c64 operator holds
    B = _cfield((op32.n, 3), 8).astype(np.complex64)
    X, rinfo = solve_refined(realify(op32), torch.from_numpy(B), tol=1e-10, inner_tol=3e-6,
                             qr_passes=1)
    assert X.dtype == torch.complex128 and bool(rinfo.converged.all())
    assert _relres(a32, X.numpy(), B.astype(np.complex128)) <= 1e-10


def test_shifted_solvers_on_realified():
    rop = dirac_gauged_cbdia(3, dtype=torch.complex128, device="cpu")
    a = bdia_scipy(dirac_gauged(3, dtype=torch.complex128, device="cpu"))
    sig = (0.0, 0.3, 2.0)
    b = _cfield((rop.n,), 9)
    X, info = solve_shifted_cg(rop, torch.from_numpy(b), sig, tol=1e-9, max_iter=500)
    assert X.dtype == torch.complex128 and bool(info.converged.all())
    for j, s in enumerate(sig):
        x = X[:, j].numpy()
        assert np.linalg.norm(a @ x + s * x - b) / np.linalg.norm(b) <= 1e-8
    B = _cfield((rop.n, 2), 10)
    Xs, info = solve_shifted_sbcgrq(rop, torch.from_numpy(B), sig, tol=1e-9, max_iter=500)
    assert Xs.shape == (3, rop.n, 2) and bool(info.converged.all())
    for j, s in enumerate(sig):
        x = Xs[j].numpy()
        assert _relres(a, x, B - s * x) <= 1e-8


def test_complex_rhs_needs_a_realified_operator():
    """A complex B on an operator without a complex codec still raises,
    naming realify; the complex containers are such operators too."""
    B = torch.from_numpy(_cfield((4 * 81, 2), 11))
    for op in (dirac_bdia(3, device="cpu"),
               dirac_cbdia(3, dtype=torch.complex128, device="cpu"),
               dirac_gauged_matrix(3, dtype=torch.complex128, device="cpu")):
        for solve in (lambda: solve_sbcgrq(op, B), lambda: solve_bcg(op, B),
                      lambda: solve_cg(op, B[:, 0]),
                      lambda: solve_shifted_sbcgrq(op, B, [0.0])):
            with pytest.raises(NotImplementedError, match="realify"):
                solve()
    assert isinstance(dirac_cbdia(3, dtype=torch.complex64, device="cpu"),
                      ConstBlockDIAOperator)
