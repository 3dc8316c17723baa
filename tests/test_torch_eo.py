"""The port's even-odd Schur path (``problems/dirac_eo.py``,
``operators/schur.py``) and the const-hop (k, bs, ns) kernels it runs at
k = 1, against the reference package on CPU tensors.

The same inputs, made from numpy seeds, go through both packages.
Tolerances: builders bitwise (hops, masks, offsets, slabs, blocks); split and
assemble exact; the kernels' plain versions against the reference's Pallas
kernels in interpret mode to 1e-5 (f32 fields: max relative error; Grams:
relative Frobenius error); f64 parity hops to 1e-12; f64 solves with the
reference's iteration count and X to 1e-9, and a true residual of the full
operator under 1e-9.
"""

import importlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from blockcg_tpu.ops import const_block_stencil as jcbs
from blockcg_tpu.problems import dirac as jdirac
from blockcg_tpu_torch import solve_cg
from blockcg_tpu_torch.operators import BlockDIAOperator, ConstBlockDIAOperator
from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.ops import const_block_stencil as cbs
from blockcg_tpu_torch.problems import (
    bdia_scipy,
    dirac_bdia,
    dirac_cbdia,
    dirac_eo,
    dirac_gauged,
    dirac_gauged_eo,
    dirac_gauged_matrix,
    dirac_gauged_matrix_eo,
    eo_assemble,
    eo_split,
    solve_dirac_eo,
    solve_dirac_eo_shifted,
)
from blockcg_tpu_torch.problems.dirac_eo import _site_rows

jeo = importlib.import_module("blockcg_tpu.problems.dirac_eo")

RTOL = 1e-5
_JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64,
        torch.complex64: jnp.complex64, torch.complex128: jnp.complex128}
_BUILDERS = {"plain": (dirac_eo, jeo.dirac_eo),
             "gauged": (dirac_gauged_eo, jeo.dirac_gauged_eo),
             "matrix": (dirac_gauged_matrix_eo, jeo.dirac_gauged_matrix_eo)}


def _np(t):
    return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)


def _relmax(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _relfro(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _build(kind, L, bc="periodic", dtype=torch.float64):
    fn, jfn = _BUILDERS[kind]
    return fn(L, bc=bc, dtype=dtype, device="cpu"), jfn(L, bc=bc, dtype=_JDT[dtype])


def _same_hop(op, jop):
    if isinstance(op, ConstBlockDIAOperator):
        assert op.hops == jop.hops and op.offsets == jop.offsets
        assert op.mask_slot == jop.mask_slot and op.slabs == jop.slabs
        assert op.num_sites == jop.num_sites and op.nnz == jop.nnz
        if jop.masks is None:
            assert op.masks is None
        else:
            jm = np.asarray(jop.masks)
            assert op.masks.numpy().dtype == jm.dtype and np.array_equal(op.masks.numpy(), jm)
    else:
        assert isinstance(op, BlockDIAOperator)
        jb = np.asarray(jop.blocks)
        assert op.blocks.numpy().dtype == jb.dtype and np.array_equal(op.blocks.numpy(), jb)
        assert op.offsets == jop.offsets and op.wrap_zero == jop.wrap_zero
        assert op.nnz == jop.nnz


def _full_matrix(kind, L, bc, dtype):
    build = {"plain": dirac_bdia, "gauged": dirac_gauged, "matrix": dirac_gauged_matrix}[kind]
    return bdia_scipy(build(L, bc=bc, dtype=dtype, device="cpu"))


# ------------------------------------------------------------------- builders


@pytest.mark.parametrize("kind,L,bc,dtype", [
    ("plain", 4, "periodic", torch.float32), ("plain", 4, "open", torch.float64),
    ("plain", 8, "periodic", torch.float32), ("plain", 4, "periodic", torch.complex128),
    ("gauged", 4, "periodic", torch.float64), ("gauged", 4, "open", torch.float32),
    ("gauged", 8, "periodic", torch.float32), ("gauged", 4, "periodic", torch.complex128),
    ("gauged", 8, "periodic", torch.complex64),
    ("matrix", 4, "periodic", torch.float64), ("matrix", 4, "open", torch.float32),
    ("matrix", 8, "periodic", torch.float32),
])
def test_builders_match_reference_bitwise(kind, L, bc, dtype):
    eo, jeo_ = _build(kind, L, bc, dtype)
    for hop, jhop in ((eo.hop_eo, jeo_.hop_eo), (eo.hop_oe, jeo_.hop_oe)):
        _same_hop(hop, jhop)
    assert eo.schur.hop_eo is eo.hop_eo and eo.schur.hop_oe is eo.hop_oe
    assert (eo.c, eo.ns, eo.bs, eo.n) == (jeo_.c, jeo_.ns, jeo_.bs, jeo_.n)
    assert eo.schur.c == jeo_.schur.c and eo.schur.nnz == jeo_.schur.nnz
    assert np.array_equal(eo.even_sites, jeo_.even_sites)
    assert np.array_equal(eo.odd_sites, jeo_.odd_sites)
    jcd = None if jeo_.cdtype is None else jnp.dtype(jeo_.cdtype).name
    assert (None if eo.cdtype is None else str(eo.cdtype).split(".")[1]) == jcd


def test_slab_routing_on_the_half_lattice():
    """The half-lattice z-wraps at L = 32: g = 512 slabs, 32 per routed
    diagonal (``detect_slabs`` as the reference's); none at L = 8."""
    eo = dirac_eo(32, device="cpu")
    jeo32 = jeo.dirac_eo(32)
    want = ((1, 512, 32, 32, 31, -31), (13, 512, 32, 32, 0, 31))
    for hop, jhop in ((eo.hop_eo, jeo32.hop_eo), (eo.hop_oe, jeo32.hop_oe)):
        assert hop.slabs == jhop.slabs == want
        assert hop.ns == 2 ** 19 and len(hop.main_offsets) == 13
    assert dirac_eo(8, device="cpu").hop_oe.slabs == ()


def test_bad_lattices_raise():
    for L, bc in ((6, "twisted"), (5, "periodic"), (2, "periodic")):
        with pytest.raises(ValueError):
            dirac_eo(L, bc=bc, device="cpu")
        with pytest.raises(ValueError):
            dirac_gauged_matrix_eo(L, bc=bc, device="cpu")


# ------------------------------------------------------ split, assemble, hops


@pytest.mark.parametrize("kind,dtype", [("plain", torch.float64), ("gauged", torch.complex128)])
def test_split_assemble_round_trip(kind, dtype):
    eo, _ = _build(kind, 4, dtype=dtype)
    B = torch.from_numpy(np.random.default_rng(0).standard_normal((eo.n, 3)))
    be, bo = eo_split(eo, B)
    er, orr = _site_rows(eo.even_sites, eo.ns, eo.bs), _site_rows(eo.odd_sites, eo.ns, eo.bs)
    assert torch.equal(be, B[er]) and torch.equal(bo, B[orr])
    assert torch.equal(eo_assemble(eo, be, bo), B)
    if eo.cdtype is not None:
        Bc = torch.complex(B[: eo.n // 2], B[eo.n // 2:])
        Br = eo.complex_to_real(Bc)
        assert torch.equal(Br, B) and torch.equal(eo.real_to_complex(Br), Bc)
        assert eo.real_to_complex(Br).dtype == torch.complex128


@pytest.mark.parametrize("kind,bc", [("plain", "periodic"), ("plain", "open"),
                                     ("gauged", "periodic"), ("matrix", "periodic")])
@pytest.mark.parametrize("k", [1, 3])
def test_parity_hops_match_the_full_matrix(kind, bc, k):
    """A = c I - H in even/odd order: the hops are minus its off-diagonal
    blocks, and the Schur operator applies as the reference's."""
    eo, jeo_ = _build(kind, 4, bc)
    A = _full_matrix(kind, 4, bc, torch.float64).toarray()
    er, orr = _site_rows(eo.even_sites, eo.ns, eo.bs), _site_rows(eo.odd_sites, eo.ns, eo.bs)
    rng = np.random.default_rng(1)
    Xo, Xe = rng.standard_normal((len(orr), k)), rng.standard_normal((len(er), k))
    got_eo = eo.hop_eo.matmat_t(torch.from_numpy(Xo.T.copy())).numpy().T
    got_oe = eo.hop_oe.matmat_t(torch.from_numpy(Xe.T.copy())).numpy().T
    np.testing.assert_allclose(got_eo, -A[np.ix_(er, orr)] @ Xo, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_oe, -A[np.ix_(orr, er)] @ Xe, rtol=1e-12, atol=1e-12)
    S = eo.schur.matmat_t(torch.from_numpy(Xe.T.copy()))
    jS = jeo_.schur.matmat_t(jnp.asarray(Xe.T))
    assert _relmax(S, jS) <= 1e-12


def test_single_rhs_apply_runs_the_view_kernels(monkeypatch):
    """At m = bs the const-hop apply takes the (k, bs, ns) view's wrappers
    (main, then one slab add per routed diagonal); the fused Gram and wider
    blocks keep the merged ones. The result equals the merged route's."""
    calls = []
    for name in ("const_block_stencil_spmm_t", "slab_block_accumulate",
                 "const_block_stencil_spmm_m_t", "const_block_stencil_spmm_m_gram_t",
                 "slab_m_accumulate"):
        fn = getattr(cbs, name)
        monkeypatch.setattr(cbs, name, lambda *a, _f=fn, _n=name, **kw: (calls.append(_n), _f(*a, **kw))[1])
    op = dirac_cbdia(16, dtype=torch.float64, device="cpu")
    assert len(op.slabs) == 2
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((op.bs, op.ns)))
    y = op.matmat_t(x)
    assert calls == ["const_block_stencil_spmm_t"] + ["slab_block_accumulate"] * 2
    np.testing.assert_allclose(y.numpy(), op._apply_m(x, False)[0].numpy(), rtol=1e-13,
                               atol=1e-13)
    calls.clear()
    op.matmat_t(op.from_internal(x))  # the flat (1, n) field too
    assert calls[0] == "const_block_stencil_spmm_t"
    calls.clear()
    op.matmat_gram_t(x)
    assert calls == ["const_block_stencil_spmm_m_gram_t"] + ["slab_m_accumulate"] * 2


# ------------------------------------- the (k, bs, ns) kernels' plain versions


def _view_main_args(jop):
    hm, om, sm, used = jop._main_statics()
    jm = jop._main_masks(used)
    return hm, om, sm, jm, (None if jm is None else torch.from_numpy(np.array(jm)))


@pytest.mark.parametrize("build", ["plain", "gauged", "cbdia_open"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("with_gram", [False, True])
def test_view_main_plain_matches_pallas(build, k, with_gram):
    """Rows 14 and 15 on the half-lattice hop of dirac_eo(8) (gates),
    dirac_gauged_eo(8) (Z2 values) and the open dirac_cbdia(8), f32."""
    jop = (jdirac.dirac_cbdia(8, bc="open", dtype=jnp.float32) if build == "cbdia_open"
           else _BUILDERS[build][1](8, dtype=jnp.float32).hop_oe)
    hm, om, sm, jm, masks = _view_main_args(jop)
    Xv = np.random.default_rng(3 + k).standard_normal((k, jop.bs, jop.ns)).astype(np.float32)
    if with_gram:
        Y, G = cbs.const_block_stencil_spmm_gram_t(hm, om, sm, masks, torch.from_numpy(Xv))
        Yj, Gj = jcbs.const_block_stencil_spmm_gram_t(hm, om, sm, jm, jnp.asarray(Xv),
                                                      interpret=True)
        # The Gram against the f64 one of its own X and Y, to RTOL. The
        # reference's interpret-mode Gram is itself 1.1e-5 off that oracle on
        # the plain k = 3 case (f32 sums of 8192 terms per entry), so the two
        # f32 Grams are held to each other at twice RTOL.
        X64 = Xv.reshape(k, -1).astype(np.float64)
        assert G.shape == (k, k)
        assert _relfro(G, X64 @ _np(Y).reshape(k, -1).astype(np.float64).T) <= RTOL
        assert _relfro(G, Gj) <= 2 * RTOL
    else:
        Y = cbs.const_block_stencil_spmm_t(hm, om, sm, masks, torch.from_numpy(Xv))
        Yj = jcbs.const_block_stencil_spmm_t(hm, om, sm, jm, jnp.asarray(Xv), interpret=True)
    assert Y.shape == Xv.shape and Y.dtype == torch.float32 and _relmax(Y, Yj) <= RTOL
    flat = cbs.const_block_stencil_spmm_t(hm, om, sm, masks,
                                          torch.from_numpy(Xv.reshape(k, -1)))
    assert torch.equal(flat, Y.reshape(k, -1))


@pytest.mark.parametrize("k", [1, 3])
def test_view_slab_plain_matches_pallas(k):
    """Row 18 on each z-wrap slab of dirac_cbdia(16), in place on Y."""
    jop = jdirac.dirac_cbdia(16, dtype=jnp.float32)
    rng = np.random.default_rng(10 + k)
    Xv, Yv = (rng.standard_normal((k, 4, jop.ns)).astype(np.float32) for _ in range(2))
    for d, g, nblocks, mul, off, shift in jop.slabs:
        args = (jop.hops[d], g, nblocks, mul, off, shift)
        Yt = torch.from_numpy(Yv.copy())
        _native.reset_launches()
        Y = cbs.slab_block_accumulate(*args, torch.from_numpy(Xv), Yt)
        assert Y.data_ptr() == Yt.data_ptr() and sum(_native.launches.values()) == 0
        Yj = jcbs.slab_block_accumulate(*args, jnp.asarray(Xv), jnp.asarray(Yv),
                                        interpret=True)
        assert _relmax(Y, Yj) <= RTOL
        dst, _ = cbs.slab_columns(g, nblocks, mul, off, shift, jop.ns)
        keep = np.ones(jop.ns, bool)
        keep[dst.numpy()] = False
        assert np.array_equal(Y.numpy()[:, :, keep], Yv[:, :, keep])


def test_view_wrappers_check_their_arguments():
    op = dirac_cbdia(4, device="cpu")
    args = (op.hops_main, op.main_offsets, op.main_slots, op.masks_main)
    with pytest.raises(ValueError, match="field"):
        cbs.const_block_stencil_spmm_t(*args, torch.zeros((2, 3, op.ns)))
    with pytest.raises(ValueError, match="field"):
        cbs.const_block_stencil_spmm_t(*args, torch.zeros((2, 4 * op.ns + 1)))
    X = torch.zeros((2, 4, op.ns))
    with pytest.raises(ValueError, match="fields X and Y"):
        cbs.slab_block_accumulate(op.hops[1], 64, 2, 2, 1, -1, X, torch.zeros((1, 4, op.ns)))
    with pytest.raises(ValueError, match="repeat"):
        cbs.slab_block_accumulate(op.hops[1], 64, 3, 2, 0, 1, X, X.clone())


# ------------------------------------------------------------------ solvers


def _ref_solve(jfn, jeo_, B, **kw):
    X, info = jfn(jeo_, jnp.asarray(B), **kw)
    return np.asarray(X), info


@pytest.mark.parametrize("kind,bc,dtype", [
    ("plain", "periodic", torch.float64), ("plain", "open", torch.float64),
    ("gauged", "periodic", torch.float64), ("gauged", "periodic", torch.complex128),
    ("matrix", "periodic", torch.float64),
])
def test_f64_eo_solve_matches_reference(kind, bc, dtype):
    eo, jeo_ = _build(kind, 4, bc, dtype)
    rng = np.random.default_rng(20)
    nfull = eo.n // 2 if eo.cdtype is not None else eo.n
    B = rng.standard_normal((nfull, 3))
    if dtype.is_complex:
        B = B + 1j * rng.standard_normal((nfull, 3))
    X, info = solve_dirac_eo(eo, torch.from_numpy(B), tol=1e-11, max_iter=500)
    Xj, infoj = _ref_solve(jeo.solve_dirac_eo, jeo_, B, tol=1e-11, max_iter=500)
    assert X.dtype == (torch.complex128 if dtype.is_complex else torch.float64)
    assert bool(info.converged.all()) and info.iterations == int(infoj.iterations)
    assert _relmax(X, Xj) <= 1e-9
    a = _full_matrix(kind, 4, bc, dtype)
    R = a @ X.numpy() - B
    assert (np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)).max() < 1e-9


_CONTEXTS = [("plain", torch.float64), ("gauged", torch.float64),
             ("gauged", torch.complex128), ("matrix", torch.float64)]


@pytest.mark.parametrize("kind,dtype", _CONTEXTS)
def test_f64_eo_cg_matches_reference(kind, dtype):
    """``solver=solve_cg`` on one column: k = 1 through the (k, bs, ns)
    route on the const-hop hops."""
    eo, jeo_ = _build(kind, 4, dtype=dtype)
    from blockcg_tpu.solvers.cg import solve_cg as jsolve_cg

    rng = np.random.default_rng(21)
    nfull = eo.n // 2 if eo.cdtype is not None else eo.n
    b = rng.standard_normal((nfull, 1))
    if dtype.is_complex:
        b = b + 1j * rng.standard_normal((nfull, 1))
    x, info = solve_dirac_eo(eo, torch.from_numpy(b), solver=solve_cg, tol=1e-11,
                             max_iter=500)
    xj, infoj = _ref_solve(jeo.solve_dirac_eo, jeo_, b, solver=jsolve_cg, tol=1e-11,
                           max_iter=500)
    assert x.shape == (nfull, 1) and bool(info.converged.all())
    assert info.iterations == int(infoj.iterations) and _relmax(x, xj) <= 1e-9
    R = _full_matrix(kind, 4, "periodic", dtype) @ x.numpy() - b
    assert np.linalg.norm(R) / np.linalg.norm(b) < 1e-9


@pytest.mark.parametrize("kind,dtype", _CONTEXTS)
def test_f64_eo_shifted_matches_reference(kind, dtype):
    eo, jeo_ = _build(kind, 4, dtype=dtype)
    rng = np.random.default_rng(22)
    nfull = eo.n // 2 if eo.cdtype is not None else eo.n
    B = rng.standard_normal((nfull, 2))
    if dtype.is_complex:
        B = B + 1j * rng.standard_normal((nfull, 2))
    sigmas = [0.0, 0.7, 2.5]
    Xs, info = solve_dirac_eo_shifted(eo, torch.from_numpy(B), sigmas, tol=1e-11,
                                      max_iter=800)
    Xsj, infoj = _ref_solve(jeo.solve_dirac_eo_shifted, jeo_, B, sigmas=sigmas, tol=1e-11,
                            max_iter=800)
    assert Xs.shape == (3, nfull, 2) and info.iterations == int(infoj.iterations)
    assert _relmax(Xs, Xsj) <= 1e-9
    a = _full_matrix(kind, 4, "periodic", dtype)
    for j, sg in enumerate(sigmas):
        R = a @ Xs[j].numpy() + sg * Xs[j].numpy() - B
        assert (np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)).max() < 1e-9
    with pytest.raises(ValueError, match="non-negative"):
        solve_dirac_eo_shifted(eo, torch.from_numpy(B), [-1.0])


def test_f32_eo_solve():
    """f32 end to end through the kernels' plain versions, as the
    reference's interpret-mode test: true relres under 1e-4 at tol 1e-5, and
    fewer iterations than the full operator's solve."""
    from blockcg_tpu_torch import solve_sbcgrq

    eo = dirac_eo(4, device="cpu")
    B = torch.as_tensor(np.random.default_rng(4).standard_normal((eo.n, 4)),
                        dtype=torch.float32)
    X, info = solve_dirac_eo(eo, B, tol=1e-5, max_iter=300)
    a = _full_matrix("plain", 4, "periodic", torch.float64)
    Bn = B.double().numpy()
    rel = (np.linalg.norm(Bn - a @ X.double().numpy(), axis=0) / np.linalg.norm(Bn, axis=0))
    assert X.dtype == torch.float32 and rel.max() < 1e-4
    _, full = solve_sbcgrq(dirac_cbdia(4, device="cpu"), B, tol=1e-5, max_iter=300)
    assert info.iterations < full.iterations
