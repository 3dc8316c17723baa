"""The port's const-hop lattice-Dirac path (config 4) against the reference
package, on CPU tensors.

On the CPU every wrapper runs its plain PyTorch version; these tests hold it
against the reference's Pallas kernels in interpret mode, its XLA
composition and the scipy oracle of ``to_block_dia``, with the same inputs
made from a numpy seed. Tolerances: builders bitwise; f32 fields to a max
relative error of 1e-5 and Grams to a relative Frobenius error of 1e-5
(summation order and FMA differ); f64 applies to 1e-12 relative; solvers as
in ``test_torch_solvers.py`` (f64: the reference's iteration count and X to
1e-9; f32: iterations within +-2 and a true relative residual at most
10 x tol). The CUDA kernels are compared with these plain versions on the
card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import blockcg_tpu as jbc
from blockcg_tpu.ops import const_block_stencil as jcbs
from blockcg_tpu.problems import bdia_scipy
from blockcg_tpu.problems import dirac as jdirac
from blockcg_tpu.problems import presets as jpresets
from blockcg_tpu_torch import (
    ConstBlockDIAOperator,
    RealifiedHermitianOperator,
    solve_refined,
    solve_sbcgrq,
)
from blockcg_tpu_torch.operators import astype, detect_slabs
from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.ops import const_block_stencil as cbs
from blockcg_tpu_torch.problems import (
    PRESETS,
    config4_dirac_32,
    dirac_cbdia,
    dirac_gauged_cbdia,
    hopping_matrices,
)

RTOL = 1e-5


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


def _jdt(dtype):
    return jnp.float64 if dtype == torch.float64 else jnp.float32


def _same_structure(op, jop):
    assert op.hops == jop.hops
    assert op.offsets == jop.offsets and op.mask_slot == jop.mask_slot
    assert op.num_sites == jop.num_sites and op.slabs == jop.slabs
    assert op.nnz == jop.nnz and op.shape == jop.shape
    if jop.masks is None:
        assert op.masks is None
    else:
        jm = np.asarray(jop.masks)
        assert op.masks.numpy().dtype == jm.dtype and np.array_equal(op.masks.numpy(), jm)


def _field(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# ------------------------------------------------------------------ builders


@pytest.mark.parametrize("L,bc,dtype", [
    (4, "periodic", torch.float32), (4, "open", torch.float32),
    (4, "periodic", torch.float64), (16, "periodic", torch.float32),
    (16, "open", torch.float32),
])
def test_dirac_cbdia_matches_reference_bitwise(L, bc, dtype):
    op = dirac_cbdia(L, bc=bc, dtype=dtype, device="cpu")
    jop = jdirac.dirac_cbdia(L, bc=bc, dtype=_jdt(dtype))
    _same_structure(op, jop)
    assert op.dtype == dtype
    assert (len(op.slabs) == 2) == (L == 16 and bc == "periodic")


@pytest.mark.parametrize("L,bc", [(4, "periodic"), (4, "open"), (16, "periodic")])
def test_dirac_gauged_cbdia_matches_reference_bitwise(L, bc):
    op = dirac_gauged_cbdia(L, bc=bc, device="cpu")
    jop = jdirac.dirac_gauged_cbdia(L, bc=bc, dtype=jnp.float32)
    _same_structure(op, jop)
    assert op.slabs == () and set(op.masks.unique().tolist()) == {-1.0, 0.0, 1.0}


def test_hopping_matrices_match_reference():
    for herm in (False, True):
        assert np.array_equal(hopping_matrices(7, herm), jdirac.hopping_matrices(7, herm))


def test_dirac_32_structure():
    """Config 4's operator: z-wraps slab-routed in 1024-site slabs, the
    builder's structural nnz, 10 of the 12 mask rows streamed by the main
    kernel."""
    op = dirac_cbdia(32, device="cpu")
    assert op.slabs == ((5, 1024, 32, 32, 31, -31), (6, 1024, 32, 32, 0, 31))
    assert (op.ns, op.n, op.nnz) == (1_048_576, 4_194_304, 138_412_032)
    assert len(op.offsets) == 15 and len(op.main_offsets) == 13
    assert op.masks.shape[0] == 12 and op.masks_main.shape[0] == 10


def test_config4_preset_matches_reference():
    op, B, meta = config4_dirac_32(L=4, device="cpu")
    jop, jB, jmeta = jpresets.config4_dirac_32(jnp.float32, L=4)
    _same_structure(op, jop)
    assert B.dtype == torch.float32 and np.array_equal(B.numpy(), np.asarray(jB))
    assert meta == jmeta and PRESETS["dirac_32"] is config4_dirac_32


def test_complex_and_bad_options_raise():
    """Complex dtypes build a complex-hop container (dirac_cbdia) or the
    realified U(1) operator (dirac_gauged_cbdia); bad options raise."""
    op = dirac_cbdia(4, dtype=torch.complex64, device="cpu")
    assert isinstance(op, ConstBlockDIAOperator) and op.dtype == torch.complex64
    assert op.masks.dtype == torch.float32 and isinstance(op.hops[1][0][0], complex)
    rop = dirac_gauged_cbdia(4, dtype=torch.complex128, device="cpu")
    assert isinstance(rop, RealifiedHermitianOperator) and rop.dtype == torch.complex128
    assert rop.real_op.bs == 8 and rop.real_op.dtype == torch.float64
    with pytest.raises(ValueError):
        dirac_cbdia(4, bc="twisted", device="cpu")
    with pytest.raises(TypeError):
        dirac_cbdia(4, dtype=torch.int32, device="cpu")
    hand = ConstBlockDIAOperator(None, (((1j, 0.0), (0.0, 1.0)),), (0,), (-1,), 8)
    assert hand.dtype == torch.complex64 and hand.hops == (((1j, 0j), (0j, 1 + 0j)),)


def test_from_numpy_applies_like_the_port_build():
    jop = jdirac.dirac_cbdia(16, dtype=jnp.float64)
    op = ConstBlockDIAOperator.from_numpy(
        np.asarray(jop.masks), jop.hops, jop.offsets, jop.mask_slot,
        jop.num_sites, jop.slabs, jop.nnz, dtype=torch.float64, device="cpu")
    built = dirac_cbdia(16, dtype=torch.float64, device="cpu")
    _same_structure(op, jop)
    Xt = torch.from_numpy(_field((2, op.n), 0, np.float64))
    assert torch.equal(op.matmat_t(Xt), built.matmat_t(Xt))
    Y, G = op.matmat_gram_t(Xt)
    Yb, Gb = built.matmat_gram_t(Xt)
    assert torch.equal(Y, Yb) and torch.equal(G, Gb)


def test_detect_slabs_and_astype():
    op = dirac_cbdia(16, device="cpu")
    plain = ConstBlockDIAOperator(op.masks, op.hops, op.offsets, op.mask_slot, op.ns,
                                  nnz=op.nnz)
    assert plain.slabs == () and len(plain.main_offsets) == 15
    assert detect_slabs(op.masks.numpy(), op.offsets, op.mask_slot, op.ns) == op.slabs
    gop = dirac_gauged_cbdia(16, device="cpu")  # value masks: never slab-routed
    assert detect_slabs(gop.masks.numpy(), gop.offsets, gop.mask_slot, gop.ns) == ()
    assert detect_slabs(None, (0,), (-1,), 256) == ()
    op64 = astype(op, torch.float64)
    assert op.dtype == torch.float32 and op64.dtype == torch.float64
    assert op64.slabs == op.slabs and op64.nnz == op.nnz
    # hop tables rebuilt from the Python floats of ``hops``
    assert torch.equal(op64.hops_all, torch.tensor(op.hops, dtype=torch.float64))
    assert torch.equal(op64.masks, op.masks.double())


# ---------------------------------------------------- kernels' plain versions


def _main_args(jop):
    hm, om, sm, used = jop._main_statics()
    return hm, om, sm, jop._main_masks(used)


@pytest.mark.parametrize("build", ["periodic", "open", "gauged"])
@pytest.mark.parametrize("with_gram", [False, True])
def test_main_plain_matches_pallas(build, with_gram):
    """The main kernel's plain version against the merged Pallas kernel in
    interpret mode (L = 8, k = 2: m = 8, a Pallas plan exists)."""
    jop = (jdirac.dirac_gauged_cbdia(8, dtype=jnp.float32) if build == "gauged"
           else jdirac.dirac_cbdia(8, bc=build, dtype=jnp.float32))
    hm, om, sm, jmasks = _main_args(jop)
    Xm = _field((8, jop.ns), 1)
    masks = None if jmasks is None else torch.from_numpy(np.array(jmasks))
    if with_gram:
        Y, G = cbs.const_block_stencil_spmm_m_gram_t(hm, om, sm, masks, torch.from_numpy(Xm))
        Yj, Gj = jcbs.const_block_stencil_spmm_m_gram_t(hm, om, sm, jmasks, jnp.asarray(Xm),
                                                        interpret=True)
        assert G.shape == (8, 8) and _relfro(G, Gj) <= RTOL
    else:
        Y = cbs.const_block_stencil_spmm_m_t(hm, om, sm, masks, torch.from_numpy(Xm))
        Yj = jcbs.const_block_stencil_spmm_m_t(hm, om, sm, jmasks, jnp.asarray(Xm),
                                               interpret=True)
    assert Y.dtype == torch.float32 and _relmax(Y, Yj) <= RTOL


@pytest.mark.parametrize("build", ["periodic", "gauged"])
def test_main_plain_odd_m_matches_xla(build):
    """k = 3 (m = 12): the reference has no Pallas plan (m % 8 != 0) and
    applies by XLA; the port's plain version and fused Gram take any m."""
    jop = (jdirac.dirac_gauged_cbdia(8, dtype=jnp.float32) if build == "gauged"
           else jdirac.dirac_cbdia(8, dtype=jnp.float32))
    Xm = _field((12, jop.ns), 2)
    want = np.asarray(jop._matmat_m_xla(jnp.asarray(Xm)))
    masks = torch.from_numpy(np.array(jop.masks))
    Y, G = cbs.const_block_stencil_spmm_m_gram_t(jop.hops, jop.offsets, jop.mask_slot,
                                                 masks, torch.from_numpy(Xm))
    assert _relmax(Y, want) <= RTOL
    assert _relfro(G, _np(Xm) @ _np(want).T) <= RTOL


@pytest.mark.parametrize("with_gram", [False, True])
def test_slab_plain_matches_pallas(with_gram):
    """Each z-wrap slab of the L = 16 operator (k = 2) against the Pallas
    slab kernel in interpret mode; the port adds into Y in place."""
    jop = jdirac.dirac_cbdia(16, dtype=jnp.float32)
    assert len(jop.slabs) == 2
    Xm, Ym, Gm = _field((8, jop.ns), 3), _field((8, jop.ns), 4), _field((8, 8), 5)
    for e, (d, g, nblocks, mul, off, shift) in enumerate(jop.slabs):
        Yt = torch.from_numpy(Ym.copy())
        args = (jop.hops[d], g, nblocks, mul, off, shift)
        out = cbs.slab_m_accumulate(*args, torch.from_numpy(Xm), Yt,
                                    torch.from_numpy(Gm), with_gram=with_gram)
        jout = jcbs.slab_m_accumulate(*args, jnp.asarray(Xm), jnp.asarray(Ym),
                                      jnp.asarray(Gm), with_gram=with_gram, interpret=True)
        if with_gram:
            (Y, G), (Yj, Gj) = out, jout
            assert _relfro(G, Gj) <= RTOL
        else:
            Y, Yj = out, jout
        assert Y.data_ptr() == Yt.data_ptr()  # in place
        assert _relmax(Y, Yj) <= RTOL
        dst, _ = cbs.slab_columns(g, nblocks, mul, off, shift, jop.ns)
        keep = np.ones(jop.ns, bool)
        keep[dst.numpy()] = False
        assert np.array_equal(Y.numpy()[:, keep], Ym[:, keep])  # only slab sites move
        if e == 0:
            assert dst.numel() == nblocks * g == jop.ns // 16


def test_wrapper_argument_checks():
    op = dirac_cbdia(4, device="cpu")
    Xm = torch.zeros(8, op.ns)
    with pytest.raises(ValueError):  # m not a multiple of bs
        cbs.const_block_stencil_spmm_m_t(op.hops_main, op.main_offsets, op.main_slots,
                                         op.masks_main, torch.zeros(6, op.ns))
    with pytest.raises(ValueError):  # a slot but no masks
        cbs.const_block_stencil_spmm_m_t(op.hops_main, op.main_offsets, op.main_slots,
                                         None, Xm)
    with pytest.raises(ValueError):  # slabs repeating a destination block
        cbs.slab_m_accumulate(op.hops[1], 64, 3, 2, 0, 1, Xm, Xm.clone())
    with pytest.raises(ValueError):  # g does not divide ns
        cbs.slab_m_accumulate(op.hops[1], 100, 1, 1, 0, 1, Xm, Xm.clone())
    _native.reset_launches()
    cbs.slab_m_accumulate(op.hops[1], 64, 2, 2, 1, -1, Xm, Xm.clone(), with_gram=True)
    assert sum(_native.launches.values()) == 0


# -------------------------------------------------------------- the operator


@pytest.mark.parametrize("L,k", [(8, 2), (16, 2)])
def test_operator_views_match_reference(L, k):
    op = dirac_cbdia(L, device="cpu")
    jop = jdirac.dirac_cbdia(L, dtype=jnp.float32)
    a = bdia_scipy(jop.to_block_dia())
    X = _field((op.n, k), 6)
    want = a @ _np(X)
    Xt = torch.from_numpy(X.T.copy())
    jY = np.asarray(jop.matmat_t(jnp.asarray(X.T), interpret=True))
    Yt = op.matmat_t(Xt)
    assert _relmax(Yt.T, want) <= RTOL and _relmax(Yt, jY) <= RTOL
    Xm = op.to_internal(Xt)
    assert Xm.shape == (op.bs * k, op.ns) and Xm.is_contiguous()
    assert np.array_equal(Xm.numpy(), np.asarray(jop.to_internal(jnp.asarray(X.T))))
    assert torch.equal(op.from_internal(op.matmat_t(Xm)), Yt)
    X3 = Xt.reshape(k, op.bs, op.ns)
    assert torch.equal(op.matmat_t(X3), Yt.reshape(k, op.bs, op.ns))
    assert torch.equal(op.matmat(torch.from_numpy(X)), Yt.T)
    Y, G = op.matmat_gram_t(Xt)
    jYg, jG = jop.matmat_gram_t(jnp.asarray(X.T), interpret=True)
    assert jG is not None and G.shape == (k, k)
    assert _relmax(Y, Yt) <= RTOL and _relfro(G, jG) <= RTOL
    assert _relfro(G, _np(X).T @ want) <= RTOL
    Ym, Gk = op.matmat_gram_t(Xm)  # merged view in, merged out, k x k Gram
    assert torch.equal(op.from_internal(Ym), Y) and torch.equal(Gk, G)


def test_operator_f64_matches_scipy_and_full_plain():
    op = dirac_cbdia(16, dtype=torch.float64, device="cpu")
    jop = jdirac.dirac_cbdia(16, dtype=jnp.float64)
    a = bdia_scipy(jop.to_block_dia())
    X = _field((op.n, 3), 7, np.float64)
    Xt = torch.from_numpy(X.T.copy())
    np.testing.assert_allclose(op.matmat_t(Xt).numpy().T, a @ X, rtol=1e-12, atol=1e-12)
    Xm = op.to_internal(Xt)
    np.testing.assert_allclose(op._matmat_m_plain(Xm).numpy(), op.matmat_t(Xm).numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op._matmat_m_plain(Xm).numpy(),
                               np.asarray(jop._matmat_m_xla(jnp.asarray(Xm.numpy()))),
                               rtol=1e-12, atol=1e-12)


def test_codec_matches_reference():
    op = dirac_cbdia(4, dtype=torch.float64, device="cpu")
    jop = jdirac.dirac_cbdia(4, dtype=jnp.float64)
    k = 3
    C = _field((k, k), 8, np.float64)
    G = _field((op.bs * k, op.bs * k), 9, np.float64)
    v = _field((op.bs * k,), 10, np.float64)
    Ct = torch.from_numpy(C).T  # a transposed view, as the solvers pass
    assert np.array_equal(op.coeff_expand(Ct).numpy(), np.asarray(jop.coeff_expand(C.T)))
    np.testing.assert_allclose(op.gram_contract(torch.from_numpy(G)).numpy(),
                               np.asarray(jop.gram_contract(G)), rtol=1e-14)
    np.testing.assert_allclose(op.norms2_contract(torch.from_numpy(v)).numpy(),
                               np.asarray(jop.norms2_contract(v)), rtol=1e-14)
    Xt = torch.from_numpy(_field((op.n, k), 11, np.float64)).T  # non-contiguous
    Xm = op.to_internal(Xt)
    assert Xm.is_contiguous() and op.from_internal(Xm).is_contiguous()
    assert torch.equal(op.from_internal(Xm), Xt)


# ---------------------------------------------------------------- solvers


@pytest.mark.parametrize("L,k", [(4, 4), (8, 12)])
def test_sbcgrq_f64_dirac_matches_reference(L, k):
    B = np.random.default_rng(20 + L).standard_normal((4 * L ** 4, k))
    X, info = solve_sbcgrq(dirac_cbdia(L, dtype=torch.float64, device="cpu"), torch.from_numpy(B),
                           tol=1e-10, max_iter=200)
    Xj, infoj = jbc.solve_sbcgrq(jdirac.dirac_cbdia(L, dtype=jnp.float64), jnp.asarray(B),
                                 tol=1e-10, max_iter=200)
    assert bool(info.converged.all())
    assert info.iterations == int(infoj.iterations)
    assert info.matvecs == int(infoj.matvecs)
    assert np.array_equal(info.per_rhs_iters.numpy(), np.asarray(infoj.per_rhs_iters))
    assert _relmax(X, Xj) <= 1e-9


def test_sbcgrq_f32_dirac_matches_reference():
    L, k, tol = 8, 12, 1e-5
    jop = jdirac.dirac_cbdia(L, dtype=jnp.float32)
    a = bdia_scipy(jop.to_block_dia())
    B = np.random.default_rng(30).standard_normal((4 * L ** 4, k))
    X, info = solve_sbcgrq(dirac_cbdia(L, device="cpu"), torch.from_numpy(B).float(), tol=tol)
    _, infoj = jbc.solve_sbcgrq(jop, jnp.asarray(B, jnp.float32), tol=tol)
    assert bool(info.converged.all())
    assert abs(info.iterations - int(infoj.iterations)) <= 2
    res = np.linalg.norm(a @ _np(X) - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 10 * tol


def test_refined_dirac_reaches_1e10():
    """To 1e-10 on the matrix the f32 operator holds (hops rounded to f32),
    which is the one its f64 outer copy applies, as in the reference."""
    op = dirac_cbdia(4, device="cpu")
    a = bdia_scipy(jdirac.dirac_cbdia(4, dtype=jnp.float32).to_block_dia())
    B = np.random.default_rng(40).standard_normal((op.n, 4))
    X, info = solve_refined(op, torch.from_numpy(B), tol=1e-10, inner_tol=3e-6,
                            qr_passes=1)
    assert X.dtype == torch.float64 and bool(info.converged.all())
    res = np.linalg.norm(a @ X.numpy() - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-10
    assert op.dtype == torch.float32  # the f64 outer operator is a new one
