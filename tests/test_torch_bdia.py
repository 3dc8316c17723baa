"""The port's per-site block lattice path (``BlockDIAOperator``, the
block-stencil wrappers, the matrix-link builders) against the reference
package, on CPU tensors.

On the CPU every wrapper runs its plain PyTorch version; these tests hold it
against the reference's windowed and ring Pallas kernels in interpret mode,
its XLA composition and the scipy oracle ``bdia_scipy``, with the same
inputs made from a numpy seed. Tolerances: builders bitwise; f32 fields to
a max relative error of 1e-5 and Grams to a relative Frobenius error of 1e-5
(summation order and FMA differ); f64 applies to 1e-12 relative; f64 solves
to the reference's iteration count with X to 1e-9. The CUDA kernel is
compared with these plain versions on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import blockcg_tpu as jbc
from blockcg_tpu.ops import block_stencil as jbs
from blockcg_tpu.ops import block_stencil_ring as jring
from blockcg_tpu.problems import dirac as jdirac
from blockcg_tpu_torch import BlockDIAOperator, solve_cg, solve_refined, solve_sbcgrq
from blockcg_tpu_torch.operators import astype
from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.ops import block_stencil as bsk
from blockcg_tpu_torch.problems import (
    bdia_scipy,
    dirac_bdia,
    dirac_cbdia,
    dirac_gauged,
    dirac_gauged_matrix,
)

RTOL = 1e-5
BUILDERS = {"dirac_bdia": dirac_bdia, "dirac_gauged": dirac_gauged,
            "dirac_gauged_matrix": dirac_gauged_matrix}
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64,
       torch.complex64: jnp.complex64, torch.complex128: jnp.complex128}


def _np(t):
    return np.asarray(t, np.float64)


def _relmax(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _relfro(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _field(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _same_bdia(op, jop):
    jb = np.asarray(jop.blocks)
    assert op.blocks.numpy().dtype == jb.dtype and np.array_equal(op.blocks.numpy(), jb)
    assert op.offsets == jop.offsets and op.wrap_zero == jop.wrap_zero
    assert op.nnz == jop.nnz and op.shape == jop.shape


# ------------------------------------------------------------------ builders


@pytest.mark.parametrize("L", [3, 4])
@pytest.mark.parametrize("name,bc,dtype", [
    ("dirac_bdia", "periodic", torch.float32), ("dirac_bdia", "open", torch.float32),
    ("dirac_bdia", "periodic", torch.complex128),
    ("dirac_gauged", "periodic", torch.float32), ("dirac_gauged", "periodic", torch.complex64),
    ("dirac_gauged", "open", torch.complex128),
    ("dirac_gauged_matrix", "periodic", torch.float32),
    ("dirac_gauged_matrix", "open", torch.float64),
    ("dirac_gauged_matrix", "periodic", torch.complex64),
    ("dirac_gauged_matrix", "open", torch.complex128),
])
def test_builders_match_reference_bitwise(name, bc, dtype, L):
    op = BUILDERS[name](L, bc=bc, dtype=dtype, device="cpu")
    jop = getattr(jdirac, name)(L, bc=bc, dtype=JDT[dtype])
    _same_bdia(op, jop)
    assert op.dtype == dtype and len(op.offsets) == (15 if bc == "periodic" else 9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128])
def test_bdia_scipy_matches_reference(dtype):
    op = dirac_gauged_matrix(3, dtype=dtype, device="cpu")
    a = bdia_scipy(op)
    ja = jdirac.bdia_scipy(jdirac.dirac_gauged_matrix(3, dtype=JDT[dtype]))
    assert a.dtype == ja.dtype and (a != ja).nnz == 0
    assert abs(a - a.conj().T).max() < 1e-6  # symmetric / Hermitian


# ---------------------------------------------------- kernels' plain versions


@pytest.mark.parametrize("kernel", ["windowed", "ring"])
def test_merged_plain_matches_pallas(kernel):
    """The merged plain version, with and without the Gram, against the
    windowed and the ring Pallas kernels in interpret mode (L = 8, k = 2:
    m = 8, both plans exist)."""
    jop = jdirac.dirac_gauged_matrix(8, dtype=jnp.float32)
    blocks = torch.from_numpy(np.array(jop.blocks))
    Xm = _field((8, jop.ns), 1)
    jfn = (jbs.block_stencil_spmm_m_gram_t if kernel == "windowed"
           else jring.ring_block_spmm_m_gram_t)
    Yj, Gj = jfn(jop.blocks, jop.offsets, jnp.asarray(Xm), interpret=True)
    Y, G = bsk.block_stencil_spmm_m_gram_t(blocks, jop.offsets, torch.from_numpy(Xm))
    assert Y.dtype == torch.float32 and _relmax(Y, Yj) <= RTOL
    assert G.shape == (8, 8) and _relfro(G, Gj) <= RTOL
    assert torch.equal(bsk.block_stencil_spmm_m_t(blocks, jop.offsets, torch.from_numpy(Xm)), Y)


def test_v_plain_matches_pallas():
    """The (k, bs, ns) plain version, and its flat form, against the Pallas
    kernel in interpret mode (L = 4, k = 2)."""
    jop = jdirac.dirac_gauged_matrix(4, dtype=jnp.float32)
    blocks = torch.from_numpy(np.array(jop.blocks))
    Xv = _field((2, 4, jop.ns), 2)
    Yj = jbs.block_stencil_spmm_t(jop.blocks, jop.offsets, jnp.asarray(Xv), interpret=True)
    Y = bsk.block_stencil_spmm_t(blocks, jop.offsets, torch.from_numpy(Xv))
    assert Y.shape == (2, 4, jop.ns) and _relmax(Y, Yj) <= RTOL
    Yf = bsk.block_stencil_spmm_t(blocks, jop.offsets, torch.from_numpy(Xv.reshape(2, -1)))
    assert torch.equal(Yf, Y.reshape(2, -1))


def test_wrapper_argument_checks():
    op = dirac_bdia(3, device="cpu")
    with pytest.raises(ValueError):  # m not a multiple of bs
        bsk.block_stencil_spmm_m_t(op.blocks, op.offsets, torch.zeros(6, op.ns))
    with pytest.raises(ValueError):  # offsets do not match the diagonals
        bsk.block_stencil_spmm_m_t(op.blocks, op.offsets[:-1], torch.zeros(8, op.ns))
    with pytest.raises(ValueError):  # wrong site count
        bsk.block_stencil_spmm_t(op.blocks, op.offsets, torch.zeros(2, 4, op.ns - 1))
    _native.reset_launches()
    bsk.block_stencil_spmm_m_gram_t(op.blocks, op.offsets, torch.zeros(8, op.ns))
    assert sum(_native.launches.values()) == 0  # CPU tensors: the plain version


# -------------------------------------------------------------- the operator


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_operator_views_match_reference(k, dtype):
    """Merged, flat and (k, bs, ns) views, odd m (4, 12), against the
    reference's XLA path and scipy; f64 to 1e-12."""
    op = dirac_gauged_matrix(4, dtype=dtype, device="cpu")
    jop = jdirac.dirac_gauged_matrix(4, dtype=JDT[dtype])
    npdt = np.float64 if dtype == torch.float64 else np.float32
    tol = 1e-12 if dtype == torch.float64 else RTOL
    X = _field((op.n, k), 6, npdt)
    want = bdia_scipy(op) @ _np(X)
    Xt = torch.from_numpy(X.T.copy())
    Yt = op.matmat_t(Xt)
    assert _relmax(Yt.T, want) <= tol
    assert _relmax(Yt, np.asarray(jop._matmat_t_xla(jnp.asarray(X.T)))) <= tol
    Xm = op.to_internal(Xt)
    assert Xm.shape == (4 * k, op.ns) and Xm.is_contiguous()
    assert np.array_equal(Xm.numpy(), np.asarray(jop.to_internal(jnp.asarray(X.T))))
    Ym = op.matmat_t(Xm)
    assert _relmax(Ym, np.asarray(jop._matmat_m_xla(jnp.asarray(Xm.numpy())))) <= tol
    assert _relmax(op.from_internal(Ym), Yt) <= tol
    X3 = Xt.reshape(k, 4, op.ns)
    assert torch.equal(op.matmat_t(X3), Yt.reshape(k, 4, op.ns))
    assert torch.equal(op.matmat(torch.from_numpy(X)), Yt.T)
    Y, G = op.matmat_gram_t(Xt)
    assert G.shape == (k, k) and _relmax(Y, Yt) <= tol
    assert _relfro(G, _np(X).T @ want) <= tol
    Ymg, Gm = op.matmat_gram_t(Xm)
    assert torch.equal(Ymg, Ym) and _relfro(Gm, G) <= tol


def test_codec_and_astype():
    op = dirac_gauged_matrix(3, dtype=torch.float64, device="cpu")
    jop = jdirac.dirac_gauged_matrix(3, dtype=jnp.float64)
    k = 3
    C = _field((k, k), 8, np.float64)
    G = _field((op.bs * k, op.bs * k), 9, np.float64)
    v = _field((op.bs * k,), 10, np.float64)
    assert np.array_equal(op.coeff_expand(torch.from_numpy(C).T).numpy(),
                          np.asarray(jop.coeff_expand(C.T)))
    np.testing.assert_allclose(op.gram_contract(torch.from_numpy(G)).numpy(),
                               np.asarray(jop.gram_contract(G)), rtol=1e-14)
    np.testing.assert_allclose(op.norms2_contract(torch.from_numpy(v)).numpy(),
                               np.asarray(jop.norms2_contract(v)), rtol=1e-14)
    Xt = torch.from_numpy(_field((op.n, k), 11, np.float64)).T  # non-contiguous
    assert torch.equal(op.from_internal(op.to_internal(Xt)), Xt)
    op32 = astype(op, torch.float32)
    assert op.dtype == torch.float64 and op32.dtype == torch.float32
    assert op32.offsets == op.offsets and op32.nnz == op.nnz
    back = BlockDIAOperator.from_numpy(np.asarray(jop.blocks), jop.offsets, jop.wrap_zero,
                                       jop.nnz, device="cpu")
    _same_bdia(back, jop)


@pytest.mark.parametrize("bc", ["periodic", "open"])
def test_same_matrix_in_two_containers(bc):
    """dirac_bdia and dirac_cbdia hold one matrix: the same apply in f64."""
    bop = dirac_bdia(4, bc=bc, dtype=torch.float64, device="cpu")
    cop = dirac_cbdia(4, bc=bc, dtype=torch.float64, device="cpu")
    Xt = torch.from_numpy(_field((3, bop.n), 12, np.float64))
    np.testing.assert_allclose(bop.matmat_t(Xt).numpy(), cop.matmat_t(Xt).numpy(),
                               rtol=1e-13, atol=1e-13)
    assert bop.nnz == cop.nnz


def test_complex_blocks_apply_on_cpu():
    """Complex blocks are a container: the plain apply on CPU tensors."""
    op = dirac_gauged_matrix(3, dtype=torch.complex128, device="cpu")
    X = _field((op.n, 2), 13, np.float64) + 1j * _field((op.n, 2), 14, np.float64)
    want = bdia_scipy(op) @ X
    got = op.matmat(torch.from_numpy(X)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-12


# ---------------------------------------------------------------- solvers


@pytest.mark.parametrize("build", ["matrix", "open"])
def test_sbcgrq_f64_matches_reference(build):
    """f64 iteration counts equal the reference's on dirac_gauged_matrix(4)
    (k = 4) and the open dirac_bdia(4), X to 1e-9."""
    if build == "matrix":
        op = dirac_gauged_matrix(4, dtype=torch.float64, device="cpu")
        jop = jdirac.dirac_gauged_matrix(4, dtype=jnp.float64)
    else:
        op = dirac_bdia(4, bc="open", dtype=torch.float64, device="cpu")
        jop = jdirac.dirac_bdia(4, bc="open", dtype=jnp.float64)
    B = np.random.default_rng(20).standard_normal((op.n, 4))
    X, info = solve_sbcgrq(op, torch.from_numpy(B), tol=1e-10, max_iter=200)
    Xj, infoj = jbc.solve_sbcgrq(jop, jnp.asarray(B), tol=1e-10, max_iter=200)
    assert bool(info.converged.all())
    assert info.iterations == int(infoj.iterations) and info.matvecs == int(infoj.matvecs)
    assert np.array_equal(info.per_rhs_iters.numpy(), np.asarray(infoj.per_rhs_iters))
    assert _relmax(X, Xj) <= 1e-9


def test_cg_f64_matches_reference():
    op = dirac_gauged_matrix(4, dtype=torch.float64, device="cpu")
    jop = jdirac.dirac_gauged_matrix(4, dtype=jnp.float64)
    b = np.random.default_rng(21).standard_normal(op.n)
    x, info = solve_cg(op, torch.from_numpy(b), tol=1e-10, max_iter=300)
    xj, infoj = jbc.solve_cg(jop, jnp.asarray(b), tol=1e-10, max_iter=300)
    assert info.iterations == int(infoj.iterations)
    assert _relmax(x, xj) <= 1e-9


def test_refined_matrix_link_reaches_1e10():
    """f32 inner SBCGrQ, f64 outer: a true relres of 1e-10 on the matrix the
    f32 operator holds."""
    op = dirac_gauged_matrix(4, device="cpu")
    a = bdia_scipy(op)
    B = np.random.default_rng(22).standard_normal((op.n, 4))
    X, info = solve_refined(op, torch.from_numpy(B), tol=1e-10, inner_tol=3e-6,
                            qr_passes=1)
    assert X.dtype == torch.float64 and bool(info.converged.all())
    res = np.linalg.norm(a @ X.numpy() - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-10
