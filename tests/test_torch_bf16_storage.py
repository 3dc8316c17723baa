"""bf16 block storage, folded periodic wraps and the mixed-dtype DIA stencil
on CPU tensors, against the reference package.

The same inputs, made from numpy seeds, go through the reference and the
port. Tolerances: builders, folded fields and the operators' bf16-field
routes bitwise (the port repeats the reference's XLA rounding step by
step); the plain versions of the bf16-block and folded kernels to a max
relative error of 1e-5 (f32 sums of the same exact products in another
order, and a folded wrap term added where its bulk partner's was); the
mixed stencil pairs' Y bitwise and their Gram to a max relative error of
1e-5; f64 solves to the reference's iteration count. On the card the
kernels are held against these plain versions
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import blockcg_tpu as jbc
from blockcg_tpu.operators import cheb as jcheb
from blockcg_tpu.operators.base import astype as jastype
from blockcg_tpu.operators.tiled import TiledOperator as JTiled
from blockcg_tpu.ops import block_stencil as jbs
from blockcg_tpu.ops import block_stencil_ring as jring
from blockcg_tpu.ops import stencil as jstencil
from blockcg_tpu.problems import dirac as jdirac
from blockcg_tpu.problems.dirac_eo import dirac_gauged_matrix_eo as jdirac_gauged_matrix_eo
from blockcg_tpu.problems import laplacian_dia as jlaplacian_dia
from blockcg_tpu_torch import solve_sbcgrq
from blockcg_tpu_torch.operators import ChebyshevOperator, TiledOperator, astype
from blockcg_tpu_torch.ops import _native, fused, spmm_tiled, stencil
from blockcg_tpu_torch.ops import block_stencil as bsk
from blockcg_tpu_torch.problems import (
    dirac_bdia,
    dirac_gauged,
    dirac_gauged_matrix,
    dirac_gauged_matrix_eo,
    laplacian_dia,
)

BF = torch.bfloat16
RTOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float64) if x.dtype == jnp.bfloat16 else x,
                      np.float64)


def _relmax(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


def _bits(got: torch.Tensor, want) -> bool:
    """Same dtype and the same values (bf16 compared through its exact f32)."""
    w = np.asarray(jnp.asarray(want).astype(jnp.float32) if want.dtype == jnp.bfloat16
                   else want)
    wdt = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}
    want_dt = BF if want.dtype == jnp.bfloat16 else wdt[w.dtype]
    return got.dtype == want_dt and np.array_equal(got.float().numpy() if got.dtype == BF
                                                   else got.numpy(), w)


def _torch(x, dtype=None) -> torch.Tensor:
    """A jax or numpy array as a torch tensor of its dtype (bf16 exactly)."""
    a = jnp.asarray(x)
    t = torch.from_numpy(np.array(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a))
    return t.to(BF if a.dtype == jnp.bfloat16 else (dtype or t.dtype))


def _field(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------- the builders


@pytest.mark.parametrize("bc", ["periodic", "open"])
@pytest.mark.parametrize("name", ["dirac_bdia", "dirac_gauged"])
def test_bf16_builders_match_reference_bitwise(name, bc):
    """``dirac_bdia`` and ``dirac_gauged`` build in bf16 (they raised
    ``TypeError``), their blocks bitwise the reference's bf16 build."""
    op = {"dirac_bdia": dirac_bdia, "dirac_gauged": dirac_gauged}[name](
        4, bc=bc, dtype=BF, device="cpu")
    jop = getattr(jdirac, name)(4, bc=bc, dtype=jnp.bfloat16)
    assert op.dtype == BF and op.offsets == jop.offsets and op.nnz == jop.nnz
    assert _bits(op.blocks, jop.blocks)


def test_gauged_matrix_bf16_raises_like_reference():
    """The reference's bf16 matrix-link build raises; the port's does too and
    names ``astype``, which stores a built operator in bf16."""
    with pytest.raises(TypeError):
        jdirac.dirac_gauged_matrix(3, dtype=jnp.bfloat16)
    with pytest.raises(TypeError, match="astype"):
        dirac_gauged_matrix(3, dtype=BF, device="cpu")
    op16 = astype(dirac_gauged_matrix(3, device="cpu"), BF)
    jop16 = jastype(jdirac.dirac_gauged_matrix(3, dtype=jnp.float32), jnp.bfloat16)
    assert _bits(op16.blocks, jop16.blocks)


@pytest.mark.parametrize("case", ["dirac_bdia", "dirac_gauged", "dirac_gauged_matrix",
                                  "dirac_bdia_bf16", "eo_hops"])
def test_folded_fields_match_reference_bitwise(case, monkeypatch):
    """Under ``BLOCKCG_FOLD`` the periodic builders carry the reference's
    folded fields bitwise (15 diagonals streamed as 9 at L = 8; the even-odd
    matrix-link hops 15 as 11), and without it none."""
    monkeypatch.setenv("BLOCKCG_FOLD", "1")
    if case == "eo_hops":
        eo = dirac_gauged_matrix_eo(8, device="cpu")
        jeo = jdirac_gauged_matrix_eo(8)
        pairs = [(eo.hop_eo, jeo.hop_eo), (eo.hop_oe, jeo.hop_oe)]
    else:
        name, dt, jdt = case, torch.float32, jnp.float32
        if case == "dirac_bdia_bf16":
            name, dt, jdt = "dirac_bdia", BF, jnp.bfloat16
        pairs = [({"dirac_bdia": dirac_bdia, "dirac_gauged": dirac_gauged,
                   "dirac_gauged_matrix": dirac_gauged_matrix}[name](8, dtype=dt, device="cpu"),
                  getattr(jdirac, name)(8, dtype=jdt))]
    for op, jop in pairs:
        assert op.fold == jop.fold and op.fold_offsets == jop.fold_offsets and op.fold
        assert _bits(op.blocks_folded, jop.blocks_folded)
        assert len(op.fold_offsets) == (11 if case == "eo_hops" else 9)
    monkeypatch.delenv("BLOCKCG_FOLD")
    op = dirac_gauged_matrix(8, device="cpu")
    assert op.fold == () and op.blocks_folded is None


# --------------------------------------- the operators' bf16-field routes


def _ops(blocks_dtype):
    """(port, reference) matrix-link operators at L = 4 with blocks of
    ``blocks_dtype`` ("bf16" or "f32")."""
    jop = jdirac.dirac_gauged_matrix(4, dtype=jnp.float32)
    op = dirac_gauged_matrix(4, device="cpu")
    if blocks_dtype == "bf16":
        jop, op = jastype(jop, jnp.bfloat16), astype(op, BF)
    return op, jop


@pytest.mark.parametrize("view", ["merged", "flat", "spin"])
@pytest.mark.parametrize("blocks_dtype", ["bf16", "f32"])
def test_bdia_bf16_field_route_matches_reference_bitwise(blocks_dtype, view):
    """A bf16 field, whatever the blocks, takes the reference's XLA route
    bitwise, dtype included (``_matmat_m_xla`` on the merged view,
    ``_matmat_v_xla``, whose f32 blocks promote Y to f32, on the others),
    and ``matmat_gram_t`` gives no Gram there."""
    op, jop = _ops(blocks_dtype)
    k = 3
    jX = jnp.asarray(_field((k, jop.n), 11), jnp.bfloat16)
    if view == "merged":
        jX = jop.to_internal(jX)
    elif view == "spin":
        jX = jX.reshape(k, jop.bs, jop.ns)
    X = _torch(jX)
    want = jop.matmat_t(jX)
    assert _bits(op.matmat_t(X), want)
    Y, G = op.matmat_gram_t(X)
    assert G is None and _bits(Y, want)


def test_bdia_gram_fused_only_for_f32_blocks_and_fields():
    """bf16 blocks with f32 fields: the plain version of the kernels'
    contract (f32 sums) and no fused Gram, as the reference fuses it only
    for f32 blocks with f32 fields; f32 with f32 fuses."""
    op16, _ = _ops("bf16")
    Xm = torch.from_numpy(_field((op16.bs * 2, op16.ns), 12))
    Y, G = op16.matmat_gram_t(Xm)
    assert G is None and Y.dtype == torch.float32
    assert torch.equal(Y, bsk.block_stencil_plain(op16.blocks, op16.offsets, Xm)[0])
    op32, _ = _ops("f32")
    assert op32.matmat_gram_t(Xm)[1].shape == (2, 2)


def test_bdia_bf16_field_takes_no_kernel_wrapper(monkeypatch):
    """The operator decides the bf16 route before any wrapper: with the
    wrappers made to raise, a bf16 field still applies."""
    op, _ = _ops("f32")

    def refuse(*a, **kw):
        raise AssertionError("a kernel wrapper was called on a bf16 field")

    for fn in ("block_stencil_spmm_m_t", "block_stencil_spmm_m_gram_t",
               "block_stencil_spmm_t"):
        monkeypatch.setattr(bsk, fn, refuse)
    Xm = torch.from_numpy(_field((op.bs * 2, op.ns), 13)).to(BF)
    assert op.matmat_t(Xm).dtype == BF
    assert op.matmat_gram_t(op.from_internal(Xm))[1] is None


def test_cheb_bf16_matches_reference_bitwise():
    """The Chebyshev operator on a bf16 DIA operator and bf16 fields: the
    reference sends ``cheb_step`` to XLA there and runs its recurrence in
    bf16; the port's coefficients round in bf16 too, and the step runs its
    plain version, bitwise."""
    jop = jlaplacian_dia((8, 8, 8), dtype=jnp.float32)
    jop16 = jastype(jop, jnp.bfloat16)
    op16 = astype(laplacian_dia((8, 8, 8), device="cpu"), BF)
    lo, hi = np.float32(0.1), np.float32(12.0)
    jpop = jcheb.ChebyshevOperator(jop16, jnp.asarray(lo), jnp.asarray(hi), 4)
    pop = ChebyshevOperator(op16, lo, hi, 4)
    jX = jnp.asarray(_field((4, jop.n), 14), jnp.bfloat16)
    assert _bits(pop.matmat_t(_torch(jX)), jpop.matmat_t(jX))
    assert _bits(pop.apply_m_t(_torch(jX)), jpop.apply_m_t(jX))
    theta, steps = pop.coefficients(BF)
    for v in (theta, *(c for st in steps for c in st)):
        assert float(torch.tensor(v).to(BF).float()) == v  # bf16 values


def test_cheb_step_bf16_dispatch_on_meta():
    """All-bf16 operands run the plain step on any device (the meta device
    shows it without a card; bf16 beside f32 raises on the card,
    ``tests/test_torch_kernels_cuda.py``)."""
    f = torch.empty((4, 512), dtype=BF, device="meta")
    _native.reset_launches()
    Z, D = fused.cheb_step(f, f, torch.empty_like(f), f, 0.5, 0.25)
    assert Z.dtype == BF and Z.device.type == "meta"
    assert sum(_native.launches.values()) == 0


def test_tiled_bf16_field_matches_reference_bitwise(monkeypatch):
    """A bf16 X takes the reference's XLA route (tiles cast to X's dtype) on
    any device, without the kernel wrapper, bitwise the reference's."""
    import scipy.sparse as sp

    n = 700
    a = sp.random(n, n, density=0.02, random_state=1, format="csr")
    a = (a + a.T + 5 * sp.eye(n)).tocsr()
    X = _field((5, 768), 15)

    def refuse(*args, **kw):
        raise AssertionError("tiled_spmm_t called on a bf16 field")

    monkeypatch.setattr(spmm_tiled, "tiled_spmm_t", refuse)
    for tdt, jtdt in ((None, None), (BF, jnp.bfloat16)):
        jop = JTiled.from_scipy(a, dtype=jnp.float32, tile_dtype=jtdt)
        op = TiledOperator.from_scipy(a, tile_dtype=tdt, device="cpu")
        jX = jnp.asarray(X, jnp.bfloat16)
        assert _bits(op.matmat_t(_torch(jX)), jop.matmat_t(jX))


# ---------------------------------------------------------- the kernels


@pytest.mark.parametrize("gram", [False, True])
@pytest.mark.parametrize("blocks_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["dirac_bdia", "dirac_gauged_matrix"])
def test_folded_plain_matches_ring_kernel(name, blocks_dtype, gram, monkeypatch):
    """The folded plain version against the reference's ring kernel with
    ``fold=`` in interpret mode (L = 8, m = 8), f32 and bf16 blocks, with and
    without the Gram; and against the unfolded plain version."""
    monkeypatch.setenv("BLOCKCG_FOLD", "1")
    jop = getattr(jdirac, name)(8, dtype=jnp.float32)
    op = {"dirac_bdia": dirac_bdia, "dirac_gauged_matrix": dirac_gauged_matrix}[name](
        8, device="cpu")
    if blocks_dtype == "bf16":
        jop, op = jastype(jop, jnp.bfloat16), astype(op, BF)
    Xm = _field((8, jop.ns), 16)
    jfn = jring.ring_block_spmm_m_gram_t if gram else jring.ring_block_spmm_m_t
    want = jfn(jop.blocks_folded, jop.fold_offsets, jnp.asarray(Xm), interpret=True,
               fold=jop.fold)
    tfn = bsk.block_stencil_spmm_m_gram_t if gram else bsk.block_stencil_spmm_m_t
    got = tfn(op.blocks_folded, op.fold_offsets, torch.from_numpy(Xm), op.fold)
    Y, Yj = (got[0], want[0]) if gram else (got, want)
    assert Y.dtype == torch.float32 and _relmax(Y, Yj) <= RTOL
    assert _relmax(Y, bsk.block_stencil_plain(op.blocks, op.offsets,
                                              torch.from_numpy(Xm))[0]) <= RTOL
    if gram:
        assert _relmax(got[1], want[1]) <= RTOL


def test_bf16_blocks_plain_matches_windowed_kernel():
    """bf16 blocks with f32 X: the plain versions (merged and (k, bs, ns))
    against the reference's windowed kernels in interpret mode."""
    jop = jastype(jdirac.dirac_gauged_matrix(8, dtype=jnp.float32), jnp.bfloat16)
    blocks = _torch(jop.blocks)
    Xm = _field((8, jop.ns), 17)
    want = jbs.block_stencil_spmm_m_t(jop.blocks, jop.offsets, jnp.asarray(Xm), interpret=True)
    assert _relmax(bsk.block_stencil_spmm_m_t(blocks, jop.offsets, torch.from_numpy(Xm)),
                   want) <= RTOL
    Xv = _field((2, 4, jop.ns), 18)
    want = jbs.block_stencil_spmm_t(jop.blocks, jop.offsets, jnp.asarray(Xv), interpret=True)
    assert _relmax(bsk.block_stencil_spmm_t(blocks, jop.offsets, torch.from_numpy(Xv)),
                   want) <= RTOL


@pytest.mark.parametrize("gram", [False, True])
@pytest.mark.parametrize("pair", ["bf16 diags", "bf16 field"])
def test_mixed_stencil_pairs_match_pallas(pair, gram):
    """Both mixed pairs against the reference's stencil kernel in interpret
    mode (16^3, k = 8): Y bitwise (f32 sums in the same order, exact
    products), the Gram on the f32 sums to 1e-5."""
    jop = jlaplacian_dia((16, 16, 16), dtype=jnp.float32)
    jd = jop.diags.astype(jnp.bfloat16) if pair == "bf16 diags" else jop.diags
    jx = jnp.asarray(_field((8, jop.n), 19),
                     jnp.bfloat16 if pair == "bf16 field" else jnp.float32)
    d, x = _torch(jd), _torch(jx)
    if gram:
        Yj, Gj = jstencil.stencil_spmm_gram_t(jd, jop.offsets, jx, interpret=True)
        Y, G = stencil.stencil_spmm_gram_t(d, jop.offsets, x)
        assert G.dtype == torch.float32 and _relmax(G, Gj) <= RTOL
    else:
        Yj = jstencil.stencil_spmm_t(jd, jop.offsets, jx, interpret=True)
        Y = stencil.stencil_spmm_t(d, jop.offsets, x)
    assert _bits(Y, Yj)


def test_bf16_gram_above_64_rows_matches_pallas():
    """The bf16 stencil's Gram at k = 72 (past one CUDA launch) against the
    reference's kernel, which takes every row in one kernel: G on the f32
    sums, to 1e-5."""
    jop = jlaplacian_dia((16, 16, 16), dtype=jnp.float32)
    jd = jop.diags.astype(jnp.bfloat16)
    jx = jnp.asarray(_field((72, jop.n), 20), jnp.bfloat16)
    Yj, Gj = jstencil.stencil_spmm_gram_t(jd, jop.offsets, jx, interpret=True)
    Y, G = stencil.stencil_spmm_gram_t(_torch(jd), jop.offsets, _torch(jx))
    assert _bits(Y, Yj) and G.shape == (72, 72) and _relmax(G, Gj) <= RTOL


def test_dispatch_pairs_on_meta():
    """The pair rule, read before the device type: the stencil takes each of
    its four f32/bf16 pairs, the block stencil f32 fields with f32 or bf16
    blocks; a bf16 field there, and f64 beside bf16, raise ``TypeError``."""
    f32 = torch.empty((8, 512), device="meta")
    b16 = f32.to(BF)
    for x, d in ((f32, f32), (f32, b16), (b16, f32), (b16, b16)):
        with pytest.raises(ValueError, match="unsupported device"):
            _native.pair_kernel(x, d, stencil.PAIRS)
    for blocks in (f32, b16):
        with pytest.raises(ValueError, match="unsupported device"):
            _native.pair_kernel(f32, blocks, bsk.PAIRS)
    for x, d, pairs in ((b16, b16, bsk.PAIRS), (b16, f32, bsk.PAIRS),
                        (b16, f32.double(), stencil.PAIRS)):
        with pytest.raises(TypeError):
            _native.pair_kernel(x, d, pairs)
    assert _native.pair_variant("stencil_spmm_t", "bcg_stencil_spmm", (BF, torch.float32)) == (
        "stencil_spmm_t[bf16 field]", "bcg_stencil_spmm_bf16x")
    assert bsk.label("block_stencil_spmm_m_t", b16, ((1, 8),)) == (
        "block_stencil_spmm_m_t[fold, bf16 coeffs]")


def test_block_stencil_plan_folded_and_bf16():
    """A folded diagonal is near when its bulk and its wrap offsets both lie
    within the halo (the plan widens the halo for it), and bf16 blocks halve
    the ring's coefficient planes."""
    offs = (0, 1, 4095, 512, 3584)  # +-1 and +-512 on a 4096-site lattice, L = 8
    p = bsk.block_stencil_plan(offs, 4096, 4, 12, False, 232448, 132, h=4)
    near = bsk.block_stencil_plan(offs, 4096, 4, 12, False, 232448, 132, h=8,
                                  wraps=((1, -7), (2, 7)))
    far = bsk.block_stencil_plan(offs, 4096, 4, 12, False, 232448, 132, h=4,
                                 wraps=((1, -7), (2, 7)))
    assert p.near[1:3] == (True, True) and near.near[1:3] == (True, True)
    assert far.near[1:3] == (False, False)
    assert bsk.smem_bytes(4, 12, 128, 8, 4, True, False, 2) == (
        bsk.smem_bytes(4, 12, 128, 8, 4, True, False) - 4 * 2 * 16 * 128)
    with pytest.raises(ValueError, match="does not tile"):
        bsk.fold_terms((0, 3), ((1, 8),), 100)


# ---------------------------------------------------------- the solves


@pytest.mark.parametrize("form", ["folded", "bf16_stored"])
def test_sbcgrq_f64_matches_reference(form, monkeypatch):
    """f64 SBCGrQ on the folded operator (applied through its folded form)
    and on bf16-stored blocks lifted to f64: the reference's iteration
    count, X to 1e-9."""
    monkeypatch.setenv("BLOCKCG_FOLD", "1")
    jop = jdirac.dirac_gauged_matrix(4, dtype=jnp.float32)
    op = dirac_gauged_matrix(4, device="cpu")
    if form == "bf16_stored":
        jop, op = jastype(jop, jnp.bfloat16), astype(op, BF)
    jop, op = jastype(jop, jnp.float64), astype(op, torch.float64)
    assert op.fold and op.blocks_folded.dtype == torch.float64
    B = np.random.default_rng(21).standard_normal((op.n, 4))
    jX, jinfo = jbc.solve_sbcgrq(jop, jnp.asarray(B), tol=1e-8, max_iter=200)
    X, info = solve_sbcgrq(op, torch.from_numpy(B), tol=1e-8, max_iter=200)
    assert bool(info.converged.all()) and int(info.iterations) == int(jinfo.iterations)
    assert _relmax(X, jX) <= 1e-9
