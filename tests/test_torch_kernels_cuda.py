"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test needs a CUDA device and skips without one. On a machine with the
card and without JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` skips the reference suite's JAX set-up). Inputs come from a
numpy seed. Tolerances: field outputs to a max relative error of 1e-5 (f32,
FMA and summation order differ from the plain version's), Grams to a relative
Frobenius error of 1e-5 (blocked two-stage summation).
"""

import ctypes

import numpy as np
import pytest
import torch

from blockcg_tpu_torch.ops import _native, fused, spmm_tiled, stencil
from blockcg_tpu_torch.ops import block_stencil as bsk
from blockcg_tpu_torch.ops import const_block_stencil as cbs
from blockcg_tpu_torch.problems import (
    bdia_scipy,
    dirac_bdia,
    dirac_cbdia,
    dirac_eo,
    dirac_gauged_cbdia,
    dirac_gauged_eo,
    dirac_gauged_matrix,
    laplacian_dia,
    laplacian_scipy,
    rgg_laplacian,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)


def _field(k, n, seed, dev):
    return _t(np.random.default_rng(seed).standard_normal((k, n)), dev)


def _relmax(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _relfro(got, want):
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


@pytest.mark.parametrize("n,k,offsets", [
    (1000, 4, (-130, -7, -1, 0, 2, 64, 257)),      # ragged n, populated wraps
    (4096, 32, (-256, -16, -1, 0, 1, 16, 256)),
    (777, 40, (0, 700, -700, 3)),                   # |o| near n
    (300, 64, (-1, 0, 1, 600)),                     # |o| >= n reduces mod n
])
def test_stencil_kernel_matches_plain(dev, n, k, offsets):
    rng = np.random.default_rng(0)
    diags = _t(rng.standard_normal((len(offsets), n)), dev)
    Xt = _field(k, n, 1, dev)
    Y, G = stencil.stencil_spmm_gram_t(diags, offsets, Xt)
    Yp, Gp = stencil.stencil_spmm_plain(diags, offsets, Xt, with_gram=True)
    torch.cuda.synchronize()
    assert _relmax(Y, Yp) < 1e-5
    assert _relfro(G, Gp) < 1e-5
    assert _relmax(stencil.stencil_spmm_t(diags, offsets, Xt), Yp) < 1e-5


def test_stencil_laplacian_matches_scipy(dev):
    shape = (12, 10, 9)
    op = laplacian_dia(shape, device=dev)
    X = np.random.default_rng(2).standard_normal((op.n, 8))
    Y = op.matmat_t(_t(X.T, dev))
    want = laplacian_scipy(shape) @ X
    assert np.abs(Y.cpu().numpy().T - want).max() / np.abs(want).max() < 1e-5


@pytest.mark.parametrize("k,n", [(3, 1000), (16, 5000), (32, 4099), (64, 700)])
def test_fused_kernels_match_plain(dev, k, n):
    rng = np.random.default_rng(k)
    M1, M2, M3 = (_t(rng.standard_normal((k, k)), dev) for _ in range(3))
    B1, B2, A = (_field(k, n, s, dev) for s in (3, 4, 5))

    G = fused.gram(B1, B2)
    assert _relfro(G, fused.gram_plain(B1, B2)) < 1e-5
    for a in (None, A):
        Y = fused.mm_update(M1, B1, a)
        assert _relmax(Y, fused.mm_update_plain(M1, B1, a)) < 1e-5
        Y, G = fused.mm_update_gram(M1, B1, a)
        Yp, Gp = fused.mm_update_gram_plain(M1, B1, a)
        assert _relmax(Y, Yp) < 1e-5 and _relfro(G, Gp) < 1e-5
    Y, G = fused.mm2_update_gram(M1, B1, M2, B2)
    Yp, Gp = fused.mm2_update_gram_plain(M1, B1, M2, B2)
    assert _relmax(Y, Yp) < 1e-5 and _relfro(G, Gp) < 1e-5
    Pn, Xn = fused.px_update(M1, B1, M2, B2, M3, A)
    Pp, Xp = fused.px_update_plain(M1, B1, M2, B2, M3, A)
    assert _relmax(Pn, Pp) < 1e-5 and _relmax(Xn, Xp) < 1e-5


def test_donated_updates_match_fresh(dev):
    k, n = 32, 3000
    rng = np.random.default_rng(9)
    M1, M2, M3 = (_t(rng.standard_normal((k, k)), dev) for _ in range(3))
    W, P, X = (_field(k, n, s, dev) for s in (10, 11, 12))
    want = fused.mm2_update_gram(M1, W, M2, P)
    Wd = W.clone()
    got = fused.mm2_update_gram(M1, Wd, M2, P, donate=True)
    assert got[0].data_ptr() == Wd.data_ptr()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    want = fused.px_update(M1, W, M2, P, M3, X)
    Pd, Xd = P.clone(), X.clone()
    got = fused.px_update(M1, W, M2, Pd, M3, Xd, donate=True)
    assert got[0].data_ptr() == Pd.data_ptr() and got[1].data_ptr() == Xd.data_ptr()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_gram_repeat_is_bitwise_identical(dev):
    U, V = _field(32, 300_000, 13, dev), _field(32, 300_000, 14, dev)
    assert torch.equal(fused.gram(U, V), fused.gram(U, V))


def test_dispatch_rule_on_card(dev):
    M = torch.eye(4, device=dev)
    B = _field(4, 256, 15, dev)
    _native.reset_launches()
    fused.mm_update(M, B)
    assert _native.launches["mm_update"] == 1
    fused.mm_update(M.double(), B.double())  # f64 runs the plain version
    assert _native.launches["mm_update"] == 1
    fused.mm_update(M, B.bfloat16())  # bf16 fields, f32 M: the bf16 variant
    assert _native.launches["mm_update[bf16]"] == 1 and _native.launches["mm_update"] == 1
    with pytest.raises(TypeError):  # a bf16 coefficient is not the contract
        fused.mm_update(M.bfloat16(), B.bfloat16())
    with pytest.raises(ValueError):
        fused.gram(B[:, ::2], B[:, ::2])


def test_sbcgrq_on_card_matches_cpu(dev):
    from blockcg_tpu_torch import solve_sbcgrq

    op = laplacian_dia((16, 16, 16), device="cpu")
    B = torch.as_tensor(np.random.default_rng(16).standard_normal((op.n, 8)),
                        dtype=torch.float32)
    Xc, ic = solve_sbcgrq(op, B, tol=1e-5)
    Xg, ig = solve_sbcgrq(laplacian_dia((16, 16, 16), device=dev), B.to(dev), tol=1e-5)
    assert bool(ig.converged.all())
    assert abs(ig.iterations - ic.iterations) <= 2
    a = laplacian_scipy((16, 16, 16))
    Bn = B.double().numpy()
    res = np.linalg.norm(a @ Xg.double().cpu().numpy() - Bn, axis=0)
    assert (res / np.linalg.norm(Bn, axis=0)).max() <= 1e-4


# ------------------------------------------- const-hop block stencil, slabs


def _cbs_operands(ns, bs, k, masks, dev, seed=0):
    """Random hops on offsets that wrap, two with |o| >= ns; every fourth
    diagonal unmasked, the others on one of three mask rows."""
    rng = np.random.default_rng(seed)
    offsets = (0, 1, -1, 17, -150, ns - 1, ns + 150, -ns - 1)
    hops = _t(rng.standard_normal((len(offsets), bs, bs)), dev)
    if masks == "none":
        rows, slots = None, (-1,) * len(offsets)
    else:
        vals = [0.0, 1.0] if masks == "gates" else [-1.5, -1.0, 0.0, 1.0, 2.0]
        rows = _t(rng.choice(vals, size=(3, ns)), dev)
        slots = tuple(d % 4 - 1 for d in range(len(offsets)))
    return hops, offsets, slots, rows, _field(bs * k, ns, seed + 1, dev)


@pytest.mark.parametrize("bs,k", [(4, 1), (4, 3), (4, 12), (4, 16), (2, 6), (8, 8),
                                  (3, 5), (1, 64)])
@pytest.mark.parametrize("masks", ["none", "gates", "values"])
def test_const_block_stencil_kernel_matches_plain(dev, bs, k, masks):
    """ns = 300 (not a multiple of 128), m = bs * k in {4, 12, 48, 64, 15}."""
    hops, offsets, slots, rows, Xm = _cbs_operands(300, bs, k, masks, dev)
    Y, G = cbs.const_block_stencil_spmm_m_gram_t(hops, offsets, slots, rows, Xm)
    Yp, Gp = cbs.const_block_stencil_plain(hops, offsets, slots, rows, Xm, True)
    torch.cuda.synchronize()
    assert _relmax(Y, Yp) < 1e-5 and _relfro(G, Gp) < 1e-5
    Y1 = cbs.const_block_stencil_spmm_m_t(hops, offsets, slots, rows, Xm)
    assert _relmax(Y1, Yp) < 1e-5


@pytest.mark.parametrize("masks", ["none", "values"])
def test_hand_built_cbdia_operator_on_card(dev, masks):
    """An operator on 300 sites with random hops, one slab-free path, through
    its public applies on the card against the full plain apply."""
    from blockcg_tpu_torch import ConstBlockDIAOperator

    hops, offsets, slots, rows, Xm = _cbs_operands(300, 4, 12, masks, dev, seed=5)
    op = ConstBlockDIAOperator(rows, hops.tolist(), offsets, slots, 300, device=dev)
    want = op._matmat_m_plain(Xm)
    Y, G = op.matmat_gram_t(Xm)
    torch.cuda.synchronize()
    assert _relmax(op.matmat_t(Xm), want) < 1e-5 and _relmax(Y, want) < 1e-5
    assert _relfro(G, op.gram_contract(Xm @ want.T)) < 1e-5
    Xt = op.from_internal(Xm)
    assert _relmax(op.matmat_t(Xt), op.from_internal(want)) < 1e-5


def test_const_block_stencil_kernel_bounds(dev):
    """A merged launch takes any k (its blocks take groups of right-hand
    sides): m = 64 and 68, m = 60 at bs = 3 and m = 100 are one launch each;
    the Gram is one ``gram`` launch beside it; more than 32 diagonals and
    strided fields raise."""
    hops, offsets, slots, rows, Xm = _cbs_operands(300, 4, 16, "gates", dev)
    _native.reset_launches()
    cbs.const_block_stencil_spmm_m_gram_t(hops, offsets, slots, rows, Xm)
    assert _native.launches["const_block_stencil_spmm_m_gram_t"] == 1
    assert _native.launches["gram"] == 1
    for bs, k in ((4, 17), (3, 20), (4, 25)):
        h, o, s, r, X = _cbs_operands(300, bs, k, "gates", dev)
        Y = cbs.const_block_stencil_spmm_m_t(h, o, s, r, X)
        assert _relmax(Y, cbs.const_block_stencil_plain(h, o, s, r, X)[0]) < 1e-5
    assert _native.launches["const_block_stencil_spmm_m_t"] == 3
    many = torch.zeros((33, 4, 4), device=dev)
    with pytest.raises(ValueError, match="at most 32"):
        cbs.const_block_stencil_spmm_m_t(many, (0,) * 33, (-1,) * 33, None, Xm)
    with pytest.raises(ValueError, match="contiguous"):
        cbs.const_block_stencil_spmm_m_t(hops, offsets, slots, rows[:, :150],
                                         Xm[:, ::2])
    assert _native.launches["const_block_stencil_spmm_m_t"] == 3


@pytest.mark.parametrize("k", [2, 12, 24])
def test_slab_kernel_matches_plain(dev, k):
    """Row 19 (``csrc/slab_stream.cu``) on ``dirac_cbdia(16)``'s slabs at k
    = 2, 12 and 24 (m = 96): one 16-byte-route launch a slab add, with and
    without the Gram, against its plain version; a repeat's G bitwise."""
    op = dirac_cbdia(16, device=dev)
    m, ns = op.bs * k, op.ns
    Xm, Ym = _field(m, ns, 20, dev), _field(m, ns, 21, dev)
    Gm = _t(np.random.default_rng(22).standard_normal((m, m)), dev)
    for d, g, nblocks, mul, off, shift in op.slabs:
        args = (op.hops_all[d], g, nblocks, mul, off, shift, Xm)
        Yk, Yp = Ym.clone(), Ym.clone()
        _native.reset_launches()
        out = cbs.slab_m_accumulate(*args, Yk)
        cbs.slab_plain(*args, Yp)
        assert out.data_ptr() == Yk.data_ptr() and _relmax(Yk, Yp) < 1e-5
        Yk, Yp = Ym.clone(), Ym.clone()
        Yk, G = cbs.slab_m_accumulate(*args, Yk, Gm, with_gram=True)
        assert _native.functions == {"bcg_slab_stream": 2}
        Yp, Gp = cbs.slab_plain(*args, Yp, Gm, with_gram=True)
        assert _relmax(Yk, Yp) < 1e-5 and _relfro(G, Gp) < 1e-5
        G2 = cbs.slab_m_accumulate(*args, Ym.clone(), Gm, with_gram=True)[1]
        assert torch.equal(G, G2)  # a repeat gives the same bits
    with pytest.raises(ValueError):
        cbs.slab_m_accumulate(op.hops_all[5], 256, 16, 16, 15, -15, Xm, Xm)


@pytest.mark.parametrize("gauged", [False, True])
def test_cbdia_operator_on_card_matches_plain(dev, gauged):
    op = dirac_gauged_cbdia(16, device=dev) if gauged else dirac_cbdia(16, device=dev)
    Xm = _field(op.bs * 12, op.ns, 23, dev)
    want = op._matmat_m_plain(Xm)
    _native.reset_launches()
    Y, G = op.matmat_gram_t(Xm)
    G1 = op.matmat_gram_t(Xm)[1]
    assert _native.launches["const_block_stencil_spmm_m_gram_t"] == 2
    assert _native.launches["slab_m_accumulate"] == (0 if gauged else 4)
    torch.cuda.synchronize()
    assert _relmax(Y, want) < 1e-5 and _relmax(op.matmat_t(Xm), want) < 1e-5
    assert _relfro(G, op.gram_contract(Xm @ want.T)) < 1e-5
    assert torch.equal(G, G1)


def test_sbcgrq_dirac_on_card_matches_cpu(dev):
    from blockcg_tpu_torch import solve_sbcgrq

    op = dirac_cbdia(8, device="cpu")
    B = torch.as_tensor(np.random.default_rng(24).standard_normal((op.n, 12)),
                        dtype=torch.float32)
    Xc, ic = solve_sbcgrq(op, B, tol=1e-5)
    opg = dirac_cbdia(8, device=dev)
    Xg, ig = solve_sbcgrq(opg, B.to(dev), tol=1e-5)
    assert bool(ig.converged.all()) and abs(ig.iterations - ic.iterations) <= 2
    R = B.double().to(dev) - opg.astype_op(torch.float64).matmat(Xg.double())
    res = torch.linalg.vector_norm(R, dim=0) / torch.linalg.vector_norm(B.double().to(dev), dim=0)
    assert float(res.max()) <= 1e-4


# ------------------------------------------ xr_update_gram and qr_p_update


@pytest.mark.parametrize("k", [1, 3, 12, 16, 48])
@pytest.mark.parametrize("donate", [False, True])
def test_xr_update_gram_kernel_matches_plain(dev, k, donate):
    n = 3001  # not a multiple of 128
    rng = np.random.default_rng(40 + k)
    alpha = _t(rng.standard_normal((k, k)), dev)
    P, X, Z, R = (_field(k, n, s, dev) for s in (41, 42, 43, 44))
    Xp, Rp, Gp = fused.xr_update_gram_plain(alpha, P, X, Z, R)
    Xa, Ra = X.clone(), R.clone()
    _native.reset_launches()
    Xn, Rn, G = fused.xr_update_gram(alpha, P, Xa, Z, Ra, donate=donate)
    torch.cuda.synchronize()
    assert _native.launches["xr_update_gram"] == 1
    assert (Xn.data_ptr() == Xa.data_ptr()) is donate
    assert (Rn.data_ptr() == Ra.data_ptr()) is donate
    assert _relmax(Xn, Xp) < 1e-5 and _relmax(Rn, Rp) < 1e-5 and _relfro(G, Gp) < 1e-5
    # A repeat on the same inputs gives the same bits (fixed-order reduction).
    Xr, Rr, Gr = fused.xr_update_gram(alpha, P, X, Z, R)
    assert torch.equal(Gr, G) and torch.equal(Xr, Xn) and torch.equal(Rr, Rn)


@pytest.mark.parametrize("k", [1, 3, 12, 16, 48])
@pytest.mark.parametrize("donate", [False, True])
def test_qr_p_update_kernel_matches_plain(dev, k, donate):
    n = 3001
    rng = np.random.default_rng(50 + k)
    M2, rho = (_t(rng.standard_normal((k, k)), dev) for _ in range(2))
    Q1, P = _field(k, n, 51, dev), _field(k, n, 52, dev)
    Qp, Pp = fused.qr_p_update_plain(M2, Q1, rho, P)
    Qa, Pa = Q1.clone(), P.clone()
    _native.reset_launches()
    Q, Pn = fused.qr_p_update(M2, Qa, rho, Pa, donate=donate)
    torch.cuda.synchronize()
    assert _native.launches["qr_p_update"] == 1
    assert (Q.data_ptr() == Qa.data_ptr()) is donate
    assert (Pn.data_ptr() == Pa.data_ptr()) is donate
    assert _relmax(Q, Qp) < 1e-5 and _relmax(Pn, Pp) < 1e-5
    Qr, Pr = fused.qr_p_update(M2, Q1, rho, P)
    assert torch.equal(Qr, Q) and torch.equal(Pr, Pn)


def test_new_fused_kernels_merged_width_on_coeff_kron(dev):
    """Config 4's merged width: m = 4 * 12 rows on I_4 ⊗ C coefficients."""
    k, bs, ns = 12, 4, 5000
    rng = np.random.default_rng(60)
    eye = torch.eye(bs, device=dev)
    A, B = (torch.kron(eye, _t(rng.standard_normal((k, k)), dev)) for _ in range(2))
    F1, F2, F3, F4 = (_field(bs * k, ns, s, dev) for s in (61, 62, 63, 64))
    Xn, Rn, G = fused.xr_update_gram(A, F1, F2, F3, F4)
    Xp, Rp, Gp = fused.xr_update_gram_plain(A, F1, F2, F3, F4)
    assert _relmax(Xn, Xp) < 1e-5 and _relmax(Rn, Rp) < 1e-5 and _relfro(G, Gp) < 1e-5
    Q, Pn = fused.qr_p_update(A, F1, B, F2)
    Qp, Pp = fused.qr_p_update_plain(A, F1, B, F2)
    assert _relmax(Q, Qp) < 1e-5 and _relmax(Pn, Pp) < 1e-5


def test_new_fused_kernels_refuse_bad_operands(dev):
    k, n = 8, 512
    a = _t(np.eye(k), dev)
    F = [_field(k, n, s, dev) for s in (70, 71, 72, 73)]
    wide = _field(k, 2 * n, 74, dev)[:, ::2]  # (k, n), not contiguous
    _native.reset_launches()
    with pytest.raises(TypeError):
        fused.xr_update_gram(a.bfloat16(), *(f.bfloat16() for f in F))
    with pytest.raises(TypeError):
        fused.qr_p_update(a.bfloat16(), F[0].bfloat16(), a.bfloat16(), F[1].bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        fused.xr_update_gram(a, wide, F[1], F[2], F[3])
    with pytest.raises(ValueError, match="contiguous"):
        fused.qr_p_update(a, F[0], a, wide)
    assert sum(_native.launches.values()) == 0
    big_a = _t(np.random.default_rng(79).standard_normal((65, 65)), dev)
    big = [_field(65, 256, s, dev) for s in (75, 76, 77, 78)]
    for got, want in ((fused.xr_update_gram(big_a, *big), fused.xr_update_gram_plain(big_a, *big)),
                      (fused.qr_p_update(big_a, big[0], big_a, big[1]),
                       fused.qr_p_update_plain(big_a, big[0], big_a, big[1]))):
        for g, w in zip(got, want):
            assert (_relfro if g.shape == (65, 65) else _relmax)(g, w) < 1e-5
    assert _native.launches["xr_update_gram"] == 2 and _native.launches["qr_p_update"] == 1


@pytest.mark.parametrize("solver", ["cg", "bcg", "bcga", "bcgdq", "shifted_cg",
                                    "shifted_sbcgrq"])
def test_krylov_on_card_matches_cpu(dev, solver):
    """Each new solver on the card against the same solve on CPU tensors:
    iterations within +-2 and a true relative residual below 10 x tol."""
    import blockcg_tpu_torch as bt

    shape, tol, sig = (16, 16, 16), 1e-5, (0.0, 0.5)
    B = torch.as_tensor(np.random.default_rng(80).standard_normal((4096, 4)),
                        dtype=torch.float32)
    run = {
        "cg": lambda o, b: bt.solve_cg(o, b[:, 0], tol=tol),
        "bcg": lambda o, b: bt.solve_bcg(o, b, tol=tol),
        "bcga": lambda o, b: bt.solve_bcga(o, b, tol=tol),
        "bcgdq": lambda o, b: bt.solve_bcgdq(o, b, tol=tol),
        "shifted_cg": lambda o, b: bt.solve_shifted_cg(o, b[:, 0], sig, tol=tol),
        "shifted_sbcgrq": lambda o, b: bt.solve_shifted_sbcgrq(o, b, sig, tol=tol),
    }[solver]
    _, ic = run(laplacian_dia(shape, device="cpu"), B)
    _native.reset_launches()
    Xg, ig = run(laplacian_dia(shape, device=dev), B.to(dev))
    assert sum(_native.launches.values()) > 0
    assert bool(ig.converged.all()) and abs(ig.iterations - ic.iterations) <= 2
    a = laplacian_scipy(shape)
    Bn = B.double().numpy()
    Xs = Xg.double().cpu().numpy()
    if solver.startswith("shifted"):
        cols = [Xs[:, j] for j in range(len(sig))] if solver == "shifted_cg" else list(Xs)
        pairs = [(x, s, Bn[:, 0] if solver == "shifted_cg" else Bn) for x, s in zip(cols, sig)]
    else:
        pairs = [(Xs, 0.0, Bn[:, 0] if solver == "cg" else Bn)]
    for x, s, b in pairs:
        res = np.linalg.norm(a @ x + s * x - b, axis=0) / np.linalg.norm(b, axis=0)
        assert res.max() <= 10 * tol


# ------------------------------------------------ per-site block stencil


def _bs_operands(ns, bs, k, dev, seed=0):
    """Random per-site blocks on offsets that wrap, two with |o| >= ns."""
    rng = np.random.default_rng(seed)
    offsets = (0, 1, -1, 17, -150, ns - 1, ns + 150, -ns - 1)
    blocks = _t(rng.standard_normal((len(offsets), bs, bs, ns)), dev)
    return blocks, offsets, _field(bs * k, ns, seed + 1, dev)


@pytest.mark.parametrize("bs,k", [(4, 1), (4, 3), (4, 12), (4, 16), (3, 5), (8, 6),
                                  (8, 8), (2, 2)])
def test_block_stencil_kernel_matches_plain(dev, bs, k):
    """ns = 300 (not a multiple of 128): merged with and without the Gram,
    the (k, bs, ns) view and its flat form; a repeat gives the same bits."""
    ns = 300
    blocks, offsets, Xm = _bs_operands(ns, bs, k, dev)
    _native.reset_launches()
    Y, G = bsk.block_stencil_spmm_m_gram_t(blocks, offsets, Xm)
    Yp, Gp = bsk.block_stencil_plain(blocks, offsets, Xm, True)
    torch.cuda.synchronize()
    assert _relmax(Y, Yp) < 1e-5 and _relfro(G, Gp) < 1e-5
    assert _relmax(bsk.block_stencil_spmm_m_t(blocks, offsets, Xm), Yp) < 1e-5
    assert torch.equal(bsk.block_stencil_spmm_m_gram_t(blocks, offsets, Xm)[1], G)
    Xv = _field(k, bs * ns, 7, dev)
    Yvp = bsk.block_stencil_v_plain(blocks, offsets, Xv.reshape(k, bs, ns))
    Yv = bsk.block_stencil_spmm_t(blocks, offsets, Xv.reshape(k, bs, ns))
    assert Yv.shape == (k, bs, ns) and _relmax(Yv, Yvp) < 1e-5
    assert torch.equal(bsk.block_stencil_spmm_t(blocks, offsets, Xv), Yv.reshape(k, -1))
    assert _native.launches["block_stencil_spmm_m_gram_t"] == 2
    assert _native.launches["block_stencil_spmm_m_t"] == 1
    assert _native.launches["block_stencil_spmm_t"] == 2


def test_block_stencil_kernel_bounds(dev):
    blocks, offsets, Xm = _bs_operands(300, 4, 16, dev)
    _native.reset_launches()
    with pytest.raises(ValueError, match="bs <= 8"):
        bsk.block_stencil_spmm_m_t(*_bs_operands(300, 9, 2, dev))
    many = torch.zeros((33, 4, 4, 300), device=dev)
    with pytest.raises(ValueError, match="at most 32"):
        bsk.block_stencil_spmm_m_t(many, (0,) * 33, Xm)
    with pytest.raises(ValueError, match="contiguous"):
        bsk.block_stencil_spmm_m_t(blocks[..., :150], offsets, Xm[:, ::2])
    with pytest.raises(TypeError):
        bsk.block_stencil_spmm_m_t(blocks.to(torch.complex64), offsets,
                                   Xm.to(torch.complex64))
    assert sum(_native.launches.values()) == 0


def test_bdia_operator_on_card_matches_plain(dev):
    op = dirac_gauged_matrix(8, device=dev)
    Xm = _field(op.bs * 12, op.ns, 30, dev)
    want = bsk.block_stencil_plain(op.blocks, op.offsets, Xm)[0]
    _native.reset_launches()
    Y, G = op.matmat_gram_t(Xm)
    assert _native.launches["block_stencil_spmm_m_gram_t"] == 1
    torch.cuda.synchronize()
    assert _relmax(Y, want) < 1e-5 and _relmax(op.matmat_t(Xm), want) < 1e-5
    assert _relfro(G, op.gram_contract(Xm @ want.T)) < 1e-5
    Xt = op.from_internal(Xm)
    assert _relmax(op.matmat_t(Xt), op.from_internal(want)) < 1e-5
    cop = dirac_gauged_matrix(3, dtype=torch.complex64, device=dev)
    with pytest.raises(NotImplementedError, match="realify"):
        cop.matmat_t(torch.zeros((1, cop.n), dtype=torch.complex64, device=dev))
    ccb = dirac_cbdia(3, dtype=torch.complex64, device=dev)
    with pytest.raises(NotImplementedError, match="realify"):
        ccb.matmat_t(torch.zeros((1, ccb.n), dtype=torch.complex64, device=dev))


@pytest.mark.parametrize("build", ["matrix", "realified", "gauged_cbdia"])
def test_lattice_solves_on_card_match_cpu(dev, build):
    """SBCGrQ on the card against the same solve on CPU tensors (iterations
    within +-2) on the matrix-link operator, its realified complex flavour
    and the U(1) const-hop core at bs = 8; true relres below 10 x tol."""
    from blockcg_tpu_torch import realify, solve_sbcgrq
    from blockcg_tpu_torch.problems import dirac_gauged

    tol = 1e-5
    if build == "matrix":
        make = lambda d: dirac_gauged_matrix(4, device=d)  # noqa: E731
    elif build == "realified":
        make = lambda d: realify(dirac_gauged_matrix(4, dtype=torch.complex64, device=d))  # noqa: E731
    else:
        make = lambda d: dirac_gauged_cbdia(4, dtype=torch.complex64, device=d)  # noqa: E731
    rng = np.random.default_rng(31)
    B = rng.standard_normal((4 * 256, 6))
    if build != "matrix":
        B = (B + 1j * rng.standard_normal(B.shape)).astype(np.complex64)
    Bt = torch.as_tensor(B if build != "matrix" else B.astype(np.float32))
    _, ic = solve_sbcgrq(make("cpu"), Bt, tol=tol)
    _native.reset_launches()
    Xg, ig = solve_sbcgrq(make(dev), Bt.to(dev), tol=tol)
    assert sum(_native.launches.values()) > 0
    assert bool(ig.converged.all()) and abs(ig.iterations - ic.iterations) <= 2
    if build == "gauged_cbdia":
        a = bdia_scipy(dirac_gauged(4, dtype=torch.complex64, device="cpu"))
    else:
        a = bdia_scipy(dirac_gauged_matrix(4, dtype=torch.complex64 if build == "realified"
                                           else torch.float32, device="cpu"))
    Xn = Xg.cpu().numpy().astype(np.complex128)
    res = np.linalg.norm(B - a @ Xn, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 10 * tol


# ----------------------------------------------- cheb_step, the (k, bs, ns) view


@pytest.mark.parametrize("shape,offset", [((32, 4099), 0), ((48, 300), 0), ((3, 1001), 1),
                                          ((1, 7), 0)])
@pytest.mark.parametrize("donate", [False, True])
def test_cheb_step_kernel_matches_plain(dev, shape, offset, donate):
    """Flat and merged widths, a numel that is not a multiple of 4 (the
    scalar tail) and fields one element off 16-byte alignment (the scalar
    route); in place against fresh buffers."""
    n = int(np.prod(shape))
    rng = np.random.default_rng(90)

    def field():
        return _t(rng.standard_normal(n + offset), dev)[offset:].reshape(shape)
    R, Z, D, AZ = field(), field(), field(), field()
    c1, c2 = 0.6180339, -1.2345678
    Zp, Dp = fused.cheb_step_plain(R, Z, D, AZ, c1, c2)
    Za, Da = Z.clone(), D.clone()
    _native.reset_launches()
    Zo, Do = fused.cheb_step(R, Za, Da, AZ, c1, c2, donate=donate)
    torch.cuda.synchronize()
    assert _native.launches["cheb_step"] == 1
    assert (Zo.data_ptr() == Za.data_ptr()) is donate and (Do.data_ptr() == Da.data_ptr()) is donate
    assert _relmax(Zo, Zp) <= 1e-6 and _relmax(Do, Dp) <= 1e-6
    Zs, Ds = fused.cheb_step(R, Z, Z, AZ, c1, c2)  # Z and D one buffer, fresh outputs
    Zsp, Dsp = fused.cheb_step_plain(R, Z, Z, AZ, c1, c2)
    assert _relmax(Zs, Zsp) <= 1e-6 and _relmax(Ds, Dsp) <= 1e-6
    with pytest.raises(ValueError, match="share storage"):
        fused.cheb_step(R, Z, Z, AZ, c1, c2, donate=True)


@pytest.mark.parametrize("bs,k", [(4, 1), (4, 3), (4, 12), (2, 6), (8, 1), (8, 6), (3, 5),
                                  (1, 64)])
@pytest.mark.parametrize("masks", ["none", "gates", "values"])
def test_const_block_stencil_view_kernel_matches_plain(dev, bs, k, masks):
    """Rows 14 and 15 on the (k, bs, ns) view and its flat form, ns = 300,
    offsets with |o| >= ns; the view's Gram is (k, k)."""
    hops, offsets, slots, rows, Xm = _cbs_operands(300, bs, k, masks, dev, seed=7)
    Xv = Xm.reshape(k, bs, 300)
    Yp, Gp = cbs.const_block_stencil_v_plain(hops, offsets, slots, rows, Xv, True)
    _native.reset_launches()
    Y, G = cbs.const_block_stencil_spmm_gram_t(hops, offsets, slots, rows, Xv)
    Y1 = cbs.const_block_stencil_spmm_t(hops, offsets, slots, rows, Xv)
    Yf = cbs.const_block_stencil_spmm_t(hops, offsets, slots, rows, Xv.reshape(k, -1))
    torch.cuda.synchronize()
    assert _native.launches["const_block_stencil_spmm_gram_t"] == 1
    assert _native.launches["const_block_stencil_spmm_t"] == 2
    assert G.shape == (k, k) and _relfro(G, Gp) < 1e-5
    assert _relmax(Y, Yp) < 1e-5 and torch.equal(Y1, Y) and torch.equal(Yf, Y.reshape(k, -1))
    G2 = cbs.const_block_stencil_spmm_gram_t(hops, offsets, slots, rows, Xv)[1]
    assert torch.equal(G, G2)  # a repeat gives the same bits


@pytest.mark.parametrize("k", [1, 3, 12])
def test_slab_view_kernel_matches_plain(dev, k):
    op = dirac_cbdia(16, device=dev)
    Xv, Yv = (_field(k, op.bs * op.ns, s, dev).reshape(k, op.bs, op.ns) for s in (91, 92))
    for d, g, nblocks, mul, off, shift in op.slabs:
        args = (op.hops_all[d], g, nblocks, mul, off, shift, Xv)
        Yk, Yp = Yv.clone(), Yv.clone()
        out = cbs.slab_block_accumulate(*args, Yk)
        cbs.slab_v_plain(*args, Yp)
        torch.cuda.synchronize()
        assert out.data_ptr() == Yk.data_ptr() and _relmax(Yk, Yp) < 1e-5
    with pytest.raises(ValueError, match="storage"):
        cbs.slab_block_accumulate(*args, Xv)


@pytest.mark.parametrize("build", ["cbdia16", "eo16", "gauged_eo8", "u1_eo8"])
def test_single_rhs_route_is_bitwise_the_merged_kernels(dev, build):
    """At k = 1 the (k, bs, ns) route (rows 14 and 18) and the merged one
    (rows 16 and 19) are the same memory and the same arithmetic: the same
    bits."""
    if build == "cbdia16":
        op = dirac_cbdia(16, device=dev)
    elif build == "eo16":
        op = dirac_eo(16, device=dev).hop_oe
    elif build == "gauged_eo8":
        op = dirac_gauged_eo(8, device=dev).hop_eo
    else:
        op = dirac_gauged_eo(8, dtype=torch.complex64, device=dev).hop_oe
    x = _field(op.bs, op.ns, 93, dev)
    _native.reset_launches()
    y = op.matmat_t(x)
    assert _native.launches["const_block_stencil_spmm_t"] == 1
    assert _native.launches["slab_block_accumulate"] == len(op.slabs)
    ym = op._apply_m(x, False)[0]
    torch.cuda.synchronize()
    assert torch.equal(y, ym)
    assert _relmax(y, op._matmat_m_plain(x)) < 1e-5


def test_gram_kernel_takes_two_merged_fields(dev):
    """PSBCGrQ's M-CholQR Gram f_gram(Q, M Q) with U != V on the merged
    layout (m = 48)."""
    from blockcg_tpu_torch.solvers.common import f_gram

    op = dirac_cbdia(8, device=dev)
    U, V = _field(48, op.ns, 94, dev), _field(48, op.ns, 95, dev)
    G = f_gram(U, V, codec=op)
    assert _relfro(G, op.gram_contract(U @ V.T)) < 1e-5


@pytest.mark.parametrize("solve", ["eo_sbcgrq", "eo_cg", "eo_shifted", "pbcg", "psbcgrq",
                                   "cheb"])
def test_new_solves_on_card_match_cpu(dev, solve):
    """The slice's solves on the card against the same solve on CPU tensors:
    iterations within +-2 and a true relative residual below 10 x tol."""
    import blockcg_tpu_torch as bt
    from blockcg_tpu_torch.problems import solve_dirac_eo, solve_dirac_eo_shifted

    tol = 1e-5
    B = torch.as_tensor(np.random.default_rng(96).standard_normal((4 * 8 ** 4, 4)),
                        dtype=torch.float32)
    if solve.startswith("eo"):
        def run(d, b):
            eo = dirac_eo(8, device=d)
            if solve == "eo_sbcgrq":
                return solve_dirac_eo(eo, b, tol=tol)
            if solve == "eo_cg":
                return solve_dirac_eo(eo, b[:, :1], solver=bt.solve_cg, tol=tol)
            return solve_dirac_eo_shifted(eo, b, (0.0, 0.5), tol=tol)
    else:
        def run(d, b):
            op = dirac_cbdia(8, device=d)
            if solve == "cheb":
                return bt.solve_sbcgrq_cheb(op, b, degree=4, tol=tol)
            fn = bt.solve_pbcg if solve == "pbcg" else bt.solve_psbcgrq
            return fn(op, b, bt.jacobi_preconditioner(op), tol=tol)
    _, ic = run("cpu", B)
    _native.reset_launches()
    Xg, ig = run(dev, B.to(dev))
    assert sum(_native.launches.values()) > 0
    if solve == "eo_cg":
        assert _native.launches["const_block_stencil_spmm_t"] > 0
    if solve == "cheb":
        assert _native.launches["cheb_step"] > 0
    assert bool(ig.converged.all()) and abs(ig.iterations - ic.iterations) <= 2
    a = bdia_scipy(dirac_bdia(8, dtype=torch.float64, device="cpu"))
    Bn = B.double().numpy()
    if solve == "eo_shifted":
        pairs = [(Xg[j].double().cpu().numpy(), s, Bn) for j, s in enumerate((0.0, 0.5))]
    else:
        b = Bn[:, :1] if solve == "eo_cg" else Bn
        pairs = [(Xg.double().cpu().numpy(), 0.0, b)]
    for x, s, b in pairs:
        res = np.linalg.norm(a @ x + s * x - b, axis=0) / np.linalg.norm(b, axis=0)
        assert res.max() <= 10 * tol


# ------------------------------------ fields wider than one launch (m = 96)


WIDE = 96


def _check_all(got, want):
    for g, w in zip(got, want):
        if w is not None:
            square = w.dim() == 2 and w.shape[0] == w.shape[1] and w.shape[0] > 1
            assert (_relfro if square else _relmax)(g, w) < 1e-5


@pytest.mark.parametrize("donate", [False, True])
def test_fused_kernels_at_m96_match_plain(dev, donate):
    """Every fused update at m = 96 (two 48-row launches), fresh and donated,
    against its plain version; a donated output lands in its operand."""
    _fused_kernels_match_plain(dev, WIDE, 3001, donate)


@pytest.mark.parametrize("k", [400, 800])
@pytest.mark.parametrize("donate", [False, True])
def test_fused_kernels_in_narrow_chunks_match_plain(dev, k, donate):
    """Fields so wide that the staged coefficients leave room for 32- or
    16-row launches only: every fused update and its Gram, laid out by those
    chunks, against the plain versions."""
    _fused_kernels_match_plain(dev, k, 300, donate)


def _fused_kernels_match_plain(dev, k, n, donate):
    rng = np.random.default_rng(100)
    M1, M2, M3 = (_t(rng.standard_normal((k, k)) / k ** 0.5, dev) for _ in range(3))
    F = [_field(k, n, s, dev) for s in (101, 102, 103, 104)]
    _check_all((None, fused.gram(F[0], F[1])), (None, fused.gram_plain(F[0], F[1])))
    _check_all((None, fused.gram(F[0], F[0])), (None, fused.gram_plain(F[0], F[0])))
    cases = [
        (lambda a, d: (fused.mm_update(M1, a[0], a[1], donate="a" if d else None),),
         lambda a: (fused.mm_update_plain(M1, a[0], a[1]),), (1,)),
        (lambda a, d: (fused.mm_update(M1, a[0], donate="b" if d else None),),
         lambda a: (fused.mm_update_plain(M1, a[0]),), (0,)),
        (lambda a, d: fused.mm_update_gram(M1, a[0], a[1], donate=d),
         lambda a: fused.mm_update_gram_plain(M1, a[0], a[1]), (0,)),
        (lambda a, d: fused.mm2_update_gram(M1, a[0], M2, a[1], donate=d),
         lambda a: fused.mm2_update_gram_plain(M1, a[0], M2, a[1]), (0,)),
        (lambda a, d: fused.px_update(M1, a[0], M2, a[1], M3, a[2], donate=d),
         lambda a: fused.px_update_plain(M1, a[0], M2, a[1], M3, a[2]), (1, 2)),
        (lambda a, d: fused.xr_update_gram(M1, a[0], a[1], a[2], a[3], donate=d),
         lambda a: fused.xr_update_gram_plain(M1, a[0], a[1], a[2], a[3]), (1, 3)),
        (lambda a, d: fused.qr_p_update(M1, a[0], M2, a[1], donate=d),
         lambda a: fused.qr_p_update_plain(M1, a[0], M2, a[1]), (0, 1)),
        (lambda a, d: fused.qr_px_update(M1, a[0], M2, a[1], M3, a[2], donate=d),
         lambda a: fused.qr_px_update_plain(M1, a[0], M2, a[1], M3, a[2]), (0, 1, 2)),
    ]
    for kern, plain, donated in cases:
        want = plain(F)
        args = [f.clone() for f in F]
        got = kern(args, donate)
        torch.cuda.synchronize()
        _check_all(got, want)
        if donate:
            assert [g.data_ptr() for g in got[:len(donated)]] == [
                args[i].data_ptr() for i in donated]


def test_stencil_at_m96_matches_plain(dev):
    offsets = (-130, -7, -1, 0, 2, 64, 257)
    diags = _t(np.random.default_rng(105).standard_normal((len(offsets), 1000)), dev)
    Xt = _field(WIDE, 1000, 106, dev)
    _native.reset_launches()
    _check_all(stencil.stencil_spmm_gram_t(diags, offsets, Xt),
               stencil.stencil_spmm_plain(diags, offsets, Xt, with_gram=True))
    _check_all((stencil.stencil_spmm_t(diags, offsets, Xt),),
               stencil.stencil_spmm_plain(diags, offsets, Xt)[:1])
    assert _native.launches["stencil_spmm_gram_t"] == len(_native.row_chunks(WIDE))
    assert _native.functions["bcg_stencil_vec_gram"] == 2  # two chunks of 48 rows
    assert _native.launches["stencil_spmm_t"] == 2


@pytest.mark.parametrize("bs", [4, 8])
def test_lattice_kernels_at_m96_match_plain(dev, bs):
    """The const-hop kernels (merged, the (k, bs, ns) view, both slab adds)
    and the block stencil at m = 96 (k = 24 at bs = 4, 12 at bs = 8)."""
    k = WIDE // bs
    hops, offsets, slots, rows, Xm = _cbs_operands(300, bs, k, "values", dev, seed=110)
    main = (hops, offsets, slots, rows)
    _check_all(cbs.const_block_stencil_spmm_m_gram_t(*main, Xm),
               cbs.const_block_stencil_plain(*main, Xm, True))
    _check_all((cbs.const_block_stencil_spmm_m_t(*main, Xm),),
               cbs.const_block_stencil_plain(*main, Xm)[:1])
    Xv = Xm.reshape(k, bs, 300)
    _check_all(cbs.const_block_stencil_spmm_gram_t(*main, Xv),
               cbs.const_block_stencil_v_plain(*main, Xv, True))
    _check_all((cbs.const_block_stencil_spmm_t(*main, Xv),),
               cbs.const_block_stencil_v_plain(*main, Xv)[:1])
    Ym = _field(bs * k, 300, 111, dev)
    Gm = _t(np.random.default_rng(112).standard_normal((WIDE, WIDE)), dev)
    slab = (hops[1], 20, 5, 3, 1, 2, Xm)  # 15 blocks of 20 sites, stride 3
    Yk, Yp = Ym.clone(), Ym.clone()
    _check_all((cbs.slab_m_accumulate(*slab, Yk),), (cbs.slab_plain(*slab, Yp),))
    Yk, Yp = Ym.clone(), Ym.clone()
    _check_all(cbs.slab_m_accumulate(*slab, Yk, Gm, with_gram=True),
               cbs.slab_plain(*slab, Yp, Gm, with_gram=True))
    vslab = (hops[1], 20, 5, 3, 1, 2, Xv)
    Yk, Yp = Ym.clone().reshape(k, bs, 300), Ym.clone().reshape(k, bs, 300)
    _check_all((cbs.slab_block_accumulate(*vslab, Yk),), (cbs.slab_v_plain(*vslab, Yp),))
    blocks, boffs, Xb = _bs_operands(300, bs, k, dev, seed=113)
    _check_all(bsk.block_stencil_spmm_m_gram_t(blocks, boffs, Xb),
               bsk.block_stencil_plain(blocks, boffs, Xb, True))
    _check_all((bsk.block_stencil_spmm_m_t(blocks, boffs, Xb),),
               bsk.block_stencil_plain(blocks, boffs, Xb)[:1])
    Xbv = Xb.reshape(k, bs, 300)
    _check_all((bsk.block_stencil_spmm_t(blocks, boffs, Xbv),),
               (bsk.block_stencil_v_plain(blocks, boffs, Xbv),))


def test_wide_config4_solve_on_card(dev):
    """Config 4's operator with 24 RHS (m = 96) through SBCGrQ on the card,
    against the same solve on CPU tensors."""
    from blockcg_tpu_torch import solve_sbcgrq

    B = torch.as_tensor(np.random.default_rng(114).standard_normal((4 * 8 ** 4, 24)),
                        dtype=torch.float32)
    _, ic = solve_sbcgrq(dirac_cbdia(8, device="cpu"), B, tol=1e-5)
    op = dirac_cbdia(8, device=dev)
    Xg, ig = solve_sbcgrq(op, B.to(dev), tol=1e-5)
    assert bool(ig.converged.all()) and abs(ig.iterations - ic.iterations) <= 2
    R = B.double().to(dev) - op.astype_op(torch.float64).matmat(Xg.double())
    res = torch.linalg.vector_norm(R, dim=0) / torch.linalg.vector_norm(B.double().to(dev), dim=0)
    assert float(res.max()) <= 1e-4


# ----------------------------------------------- qr_px_update, tiled_spmm_t


@pytest.mark.parametrize("k", [3, 32, 48])
@pytest.mark.parametrize("donate", [False, True])
def test_qr_px_update_kernel_matches_plain(dev, k, donate):
    n = 3001
    rng = np.random.default_rng(120 + k)
    M2, rho, C = (_t(rng.standard_normal((k, k)), dev) for _ in range(3))
    Q1, P, X = (_field(k, n, s, dev) for s in (121, 122, 123))
    want = fused.qr_px_update_plain(M2, Q1, rho, P, C, X)
    args = [Q1.clone(), P.clone(), X.clone()]
    _native.reset_launches()
    got = fused.qr_px_update(M2, args[0], rho, args[1], C, args[2], donate=donate)
    torch.cuda.synchronize()
    assert _native.launches["qr_px_update"] == 1
    assert [g.data_ptr() == a.data_ptr() for g, a in zip(got, args)] == [donate] * 3
    _check_all(got, want)
    # Q and Pn are the bits of qr_p_update, which computes them the same way.
    Q, Pn = fused.qr_p_update(M2, Q1, rho, P)
    assert torch.equal(got[0], Q) and torch.equal(got[1], Pn)


@pytest.fixture(scope="module")
def rgg_tiles():
    a = rgg_laplacian(6000, degree=12.0, seed=3)
    from blockcg_tpu_torch.operators import TiledOperator

    return a, TiledOperator.from_scipy(a, torch.float32, reorder="rcm", device="cpu")


@pytest.mark.parametrize("tile_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 32, 96])
def test_tiled_spmm_kernel_matches_plain(dev, rgg_tiles, tile_dtype, k):
    """tiled_spmm_t on an RCM-ordered RGG Laplacian (n = 6000 padded to 6016),
    f32 and bf16 tiles, against its plain version; a repeat gives the same
    bits."""
    _, op = rgg_tiles
    tiles = op.tiles.to(dev, tile_dtype)
    rt, ct, first = op.rt.to(dev), op.ct.to(dev), op.first.to(dev)
    Xt = _field(k, op.n, 130 + k, dev)
    _native.reset_launches()
    Y = spmm_tiled.tiled_spmm_t(tiles, rt, ct, first, Xt)
    Yp = spmm_tiled.tiled_spmm_plain(tiles, rt, ct, Xt)
    torch.cuda.synchronize()
    assert _native.launches["tiled_spmm_t"] == 1
    assert _relmax(Y, Yp) < 1e-5
    assert torch.equal(spmm_tiled.tiled_spmm_t(tiles, rt, ct, first, Xt), Y)
    with pytest.raises(TypeError):
        spmm_tiled.tiled_spmm_t(tiles, rt, ct, first, Xt.bfloat16())
    if tile_dtype == torch.float32:
        X64 = Xt.double()
        Y64 = spmm_tiled.tiled_spmm_t(tiles.double(), rt, ct, first, X64)
        assert _native.launches["tiled_spmm_t"] == 2  # f64 runs the plain version
        assert _relmax(Y64, spmm_tiled.tiled_spmm_plain(tiles.double(), rt, ct, X64)) < 1e-12


def test_tiled_operator_solve_on_card(dev, rgg_tiles):
    """SBCGrQ through the RCM-ordered TiledOperator on the card, with the
    solver-order hooks, against scipy's matrix in f64."""
    from blockcg_tpu_torch import solve_sbcgrq
    from blockcg_tpu_torch.operators import TiledOperator

    a, _ = rgg_tiles
    op = TiledOperator.from_scipy(a, torch.float32, reorder="rcm", device=dev)
    B = np.random.default_rng(140).standard_normal((a.shape[0], 8))
    Bt = torch.as_tensor(B, dtype=torch.float32, device=dev)
    X, info = solve_sbcgrq(op, op.to_solver_order(Bt), tol=1e-6)
    X = op.from_solver_order(X).double().cpu().numpy()
    assert bool(info.converged.all())
    assert (np.linalg.norm(a @ X - B, axis=0) / np.linalg.norm(B, axis=0)).max() <= 1e-5


# ------------------- the distributed layer: halo slab adds (rows 20, 21), views


@pytest.mark.parametrize("m", [48, 96])
@pytest.mark.parametrize("gram", [False, True])
@pytest.mark.parametrize("vals", [False, True])
def test_halo_slab_kernel_matches_plain(dev, m, gram, vals):
    """Row 20: 3 slabs of g = 256 from block 1 of a 4-block halo into blocks
    5..7 of an 8-block field (a dirac_cbdia hop, +-1 link values), in place,
    one launch at m = 48 and at 96; a repeat gives the same bits."""
    g, nb = 256, 3
    hop = dirac_cbdia(4, device=dev).hops_all[1]
    Src, Y0, X = _field(m, 4 * g, 150, dev), _field(m, 8 * g, 151, dev), _field(m, 8 * g, 152, dev)
    v = (_t(np.random.default_rng(153).choice([-1.0, 1.0], (1, nb * g)), dev)
         if vals else None)
    args = (hop, g, nb, 5, 1, Src)
    Yk, Yp = Y0.clone(), Y0.clone()
    _native.reset_launches()
    got = cbs.slab_m_accumulate_from(*args, Yk, X, v, with_gram=gram)
    want = cbs.slab_from_plain(*args, Yp, X, v, gram)
    torch.cuda.synchronize()
    assert _native.launches["slab_m_accumulate_from"] == 1
    got, want = (got, want) if gram else ((got, None), (want, None))
    assert got[0].data_ptr() == Yk.data_ptr()
    _check_all(got, want)
    again = cbs.slab_m_accumulate_from(*args, Y0.clone(), X, v, with_gram=gram)
    assert torch.equal((again if gram else (again,))[0], got[0])
    if gram:
        assert torch.equal(again[1], got[1])


@pytest.mark.parametrize("k", [1, 12, 24])
def test_halo_slab_view_kernel_matches_plain(dev, k):
    """Row 21 on the (k, bs, ns) view against its plain version, one
    ``csrc/slab_stream.cu`` launch at any k; at k = 1 the bits of row 20 on
    the same memory."""
    g, nb = 256, 2
    hop = dirac_cbdia(4, device=dev).hops_all[3]
    Src = _field(k, 4 * 2 * g, 154, dev).reshape(k, 4, 2 * g)
    Y0 = _field(k, 4 * 8 * g, 155, dev).reshape(k, 4, 8 * g)
    args = (hop, g, nb, 6, 0, Src)
    Yk, Yp = Y0.clone(), Y0.clone()
    _native.reset_launches()
    got = cbs.slab_block_accumulate_from(*args, Yk)
    cbs.slab_v_from_plain(*args, Yp)
    torch.cuda.synchronize()
    assert got.data_ptr() == Yk.data_ptr() and _relmax(Yk, Yp) < 1e-5
    assert dict(_native.functions) == {"bcg_slab_stream": 1}
    if k == 1:
        Ym = Y0.clone().reshape(4, -1)
        cbs.slab_m_accumulate_from(hop, g, nb, 6, 0, Src.reshape(4, -1), Ym)
        assert torch.equal(Ym, Yk.reshape(4, -1))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("gauged", [False, True])
def test_dist_cbdia_shard_on_card_matches_operator(dev, k, gauged):
    """The one-rank shard of a const-hop operator (no process group at
    D = 1: its halos are its own edges) against the operator on the card:
    the t-hop crossings through row 20 (row 21 for unit crossings at k = 1),
    with and without the Gram."""
    from blockcg_tpu_torch import parallel as par

    op = (dirac_gauged_cbdia if gauged else dirac_cbdia)(8, device=dev)
    dop = par.partition_cbdia(op, 1).shard(0, None, dev)
    Xm = _field(op.bs * k, op.ns, 156, dev)
    want = op._matmat_m_plain(Xm)
    _native.reset_launches()
    Y = dop.matmat_t(Xm)
    Yg, G = dop.matmat_gram_t(Xm)
    torch.cuda.synchronize()
    view = k == 1 and not gauged
    assert _native.launches["slab_block_accumulate_from"] == (2 if view else 0)
    assert _native.launches["slab_m_accumulate_from"] == (2 if view else 4)
    assert _relmax(Y, want) < 1e-5 and _relmax(Yg, want) < 1e-5
    assert _relfro(G, op.gram_contract(Xm @ want.T)) < 1e-5


@pytest.mark.parametrize("donate", [False, True])
def test_fused_kernels_on_the_view_match_plain(dev, donate):
    """Rows 5-9 (and 10, 12) on (k, bs, ns) fields: launched on the flat
    form, outputs in the input's shape, donated ones in their operands."""
    k, bs, ns = 12, 4, 1501
    rng = np.random.default_rng(157)
    M1, M2, M3 = (_t(rng.standard_normal((k, k)) / k ** 0.5, dev) for _ in range(3))
    F = [_field(k, bs * ns, s, dev).reshape(k, bs, ns) for s in (158, 159, 160, 161)]
    _native.reset_launches()
    _check_all((None, fused.gram(F[0], F[1])), (None, fused.gram_plain(F[0], F[1])))
    cases = [
        (lambda a, d: (fused.mm_update(M1, a[0], a[1], donate="a" if d else None),),
         lambda a: (fused.mm_update_plain(M1, a[0], a[1]),), (1,)),
        (lambda a, d: fused.mm_update_gram(M1, a[0], donate=d),
         lambda a: fused.mm_update_gram_plain(M1, a[0]), (0,)),
        (lambda a, d: fused.mm2_update_gram(M1, a[0], M2, a[1], donate=d),
         lambda a: fused.mm2_update_gram_plain(M1, a[0], M2, a[1]), (0,)),
        (lambda a, d: fused.px_update(M1, a[0], M2, a[1], M3, a[2], donate=d),
         lambda a: fused.px_update_plain(M1, a[0], M2, a[1], M3, a[2]), (1, 2)),
        (lambda a, d: fused.xr_update_gram(M1, a[0], a[1], a[2], a[3], donate=d),
         lambda a: fused.xr_update_gram_plain(M1, a[0], a[1], a[2], a[3]), (1, 3)),
        (lambda a, d: fused.qr_p_update(M1, a[0], M2, a[1], donate=d),
         lambda a: fused.qr_p_update_plain(M1, a[0], M2, a[1]), (0, 1)),
    ]
    for kern, plain, donated in cases:
        want = plain(F)
        args = [f.clone() for f in F]
        got = kern(args, donate)
        torch.cuda.synchronize()
        assert all(g.shape == (k, bs, ns) for g in got if g.dim() == 3)
        _check_all(got, want)
        if donate:
            assert [g.data_ptr() for g in got[:len(donated)]] == [
                args[i].data_ptr() for i in donated]
    assert sum(_native.launches.values()) == 7


# ------------------------- the windowed DIA stencil and the mm_update tiles


_WINDOW_CASES = {
    # name: (n, offsets); random coefficients on every diagonal, wraps populated
    "ragged_mixed": (1000, (-130, -7, -1, 0, 2, 64, 257)),       # n not a multiple of T
    "all_near_scalar": (4099, (-5, -1, 0, 1, 3)),                 # n % 4 != 0: 4-byte copies
    "all_far": (65536, (3000, -3000, 7777)),                      # no diagonal in the window
    "wrap_both_ends": (4096, (4095, 1, -4, 4092, 2048)),          # windows cross 0 and n
    "laplacian_16": (16 ** 3, (0, 1, -1, 16, -16, 256, -256)),
}


@pytest.mark.parametrize("k", [1, 5, 32, 48, 64, 96])
@pytest.mark.parametrize("case", sorted(_WINDOW_CASES))
def test_stencil_window_kernel_matches_plain(dev, case, k):
    """The windowed stencil with and without its Gram against the plain
    version: near, far and mixed diagonals, ragged n, windows that wrap at 0
    and at n, k from 1 to 96 (two 48-row launches)."""
    n, offsets = _WINDOW_CASES[case]
    plan = stencil.stencil_mma_f32_plan(offsets, n, min(k, 32), _native.max_smem(dev.index or 0),
                                        _native.sm_count(dev.index or 0))
    if case == "all_far":
        assert not any(plan.near)
    if case == "all_near_scalar":
        assert all(plan.near)
    rng = np.random.default_rng(k)
    diags = _t(rng.standard_normal((len(offsets), n)), dev)
    Xt = _field(k, n, 200 + k, dev)
    Y, G = stencil.stencil_spmm_gram_t(diags, offsets, Xt)
    Yp, Gp = stencil.stencil_spmm_plain(diags, offsets, Xt, with_gram=True)
    torch.cuda.synchronize()
    assert _relmax(Y, Yp) < 1e-5
    assert _relfro(G, Gp) < 1e-5
    assert _relmax(stencil.stencil_spmm_t(diags, offsets, Xt), Yp) < 1e-5


def test_stencil_gram_repeat_is_bitwise_identical(dev):
    op = laplacian_dia((64, 64, 64), device=dev)
    Xt = _field(32, op.n, 210, dev)
    Y1, G1 = stencil.stencil_spmm_gram_t(op.diags, op.offsets, Xt)
    Y2, G2 = stencil.stencil_spmm_gram_t(op.diags, op.offsets, Xt)
    assert torch.equal(Y1, Y2) and torch.equal(G1, G2)
    assert torch.equal(stencil.stencil_spmm_t(op.diags, op.offsets, Xt), Y1)


@pytest.mark.parametrize("k", [1, 5, 32, 48, 64, 96, 128])
@pytest.mark.parametrize("n", [4096, 3001])
@pytest.mark.parametrize("donate", [None, "a", "b"])
def test_mm_update_kernel_matches_plain(dev, k, n, donate):
    """Y = M B (+ A) in one launch up to 128 rows, 16-byte and 4-byte
    tiles, fresh and written in place onto B or A."""
    rng = np.random.default_rng(300 + k)
    M = _t(rng.standard_normal((k, k)) / k ** 0.5, dev)
    B, A = _field(k, n, 301, dev), _field(k, n, 302, dev)
    for a in ((None, A) if donate != "a" else (A,)):
        want = fused.mm_update_plain(M, B, a)
        Bd, Ad = B.clone(), None if a is None else a.clone()
        _native.reset_launches()
        Y = fused.mm_update(M, Bd, Ad, donate=donate)
        torch.cuda.synchronize()
        assert _native.launches["mm_update"] == 1
        assert _relmax(Y, want) < 1e-5
        if donate is not None:
            assert Y.data_ptr() == {"a": Ad, "b": Bd}[donate].data_ptr()


def test_mm_update_repeat_is_bitwise_identical(dev):
    M = _t(np.random.default_rng(310).standard_normal((96, 96)) / 96 ** 0.5, dev)
    B, A = _field(96, 1 << 16, 311, dev), _field(96, 1 << 16, 312, dev)
    assert torch.equal(fused.mm_update(M, B, A), fused.mm_update(M, B, A))
    assert torch.equal(fused.mm_update(M, B), fused.mm_update(M, B))


# ------------------- the streaming mm2_update_gram and px_update (rows 8, 9)


def _row89(k, n, seed, dev, offset=0, shape=None):
    """Coefficients and fields of rows 8 and 9; ``offset`` > 0 makes each
    field a contiguous view that starts ``offset`` floats into its buffer
    (not 16-byte aligned), ``shape`` reshapes the fields (the (k, bs, ns)
    view)."""
    rng = np.random.default_rng(seed)
    M1, M2, M3 = (_t(rng.standard_normal((k, k)) / k ** 0.5, dev) for _ in range(3))
    fields = []
    for _ in range(3):
        buf = _t(rng.standard_normal(k * n + offset), dev)
        F = buf[offset:].view(k, n)
        fields.append(F if shape is None else F.view(shape))
    return (M1, M2, M3), fields


def _rows89_match_plain(dev, coeffs, fields, donate, launches):
    M1, M2, M3 = coeffs
    W, P, X = fields
    want = fused.mm2_update_gram_plain(M1, W, M2, P)
    Wd = W.clone() if donate else W
    _native.reset_launches()
    Y, G = fused.mm2_update_gram(M1, Wd, M2, P, donate=donate)
    torch.cuda.synchronize()
    assert _native.launches["mm2_update_gram"] == launches
    assert Y.shape == W.shape and _relmax(Y, want[0]) < 1e-5 and _relfro(G, want[1]) < 1e-5
    assert (Y.data_ptr() == Wd.data_ptr()) is donate
    want = fused.px_update_plain(M1, W, M2, P, M3, X)
    Pd, Xd = (P.clone(), X.clone()) if donate else (P, X)
    got = fused.px_update(M1, W, M2, Pd, M3, Xd, donate=donate)
    torch.cuda.synchronize()
    assert _native.launches["px_update"] == launches
    _check_all(got, want)
    assert [g.data_ptr() == d.data_ptr() for g, d in zip(got, (Pd, Xd))] == [donate] * 2


@pytest.mark.parametrize("k", [1, 8, 32, 48, 64, 96])
@pytest.mark.parametrize("n,offset", [
    (4096, 0),   # whole 16-byte tiles
    (3001, 0),   # n % 4 != 0: 4-byte copies, a ragged last tile
    (100, 0),    # a field smaller than one tile
    (4096, 1),   # an offset view: 4-byte copies on an n % 4 == 0 field
])
@pytest.mark.parametrize("donate", [False, True])
def test_rows89_streaming_kernels_match_plain(dev, k, n, offset, donate):
    """Rows 8 and 9 in one launch up to 96 rows (the Gram of a launch over
    64 rows from ``gram``), fresh and written in place, against the plain
    versions."""
    coeffs, fields = _row89(k, n, 400 + k, dev, offset)
    _rows89_match_plain(dev, coeffs, fields, donate, 1)


@pytest.mark.parametrize("donate", [False, True])
def test_rows89_on_the_view_match_plain(dev, donate):
    k, bs, ns = 32, 4, 1501
    coeffs, fields = _row89(k, bs * ns, 410, dev, shape=(k, bs, ns))
    _rows89_match_plain(dev, coeffs, fields, donate, 1)


@pytest.mark.parametrize("k", [400, 800])
@pytest.mark.parametrize("donate", [False, True])
def test_rows89_wide_fields_run_their_plans(dev, k, donate):
    """Fields too wide for one launch: the plan's row chunks, each
    contracting over all rows in several stages, the Gram laid out by the
    chunks."""
    coeffs, fields = _row89(k, 700, 420, dev)
    M1, M2, M3 = coeffs
    W, P, X = fields
    plan = fused.mm2_update_gram_plan(k, W.device)
    want = fused.mm2_update_gram_plain(M1, W, M2, P)
    _native.reset_launches()
    got = fused.mm2_update_gram(M1, W.clone() if donate else W, M2, P, donate=donate)
    torch.cuda.synchronize()
    assert _native.launches["mm2_update_gram"] == len(plan.chunks) > 1
    _check_all(got, want)
    want = fused.px_update_plain(M1, W, M2, P, M3, X)
    got = fused.px_update(M1, W, M2, P.clone(), M3, X.clone(), donate=donate)
    torch.cuda.synchronize()
    assert _native.launches["px_update"] == len(fused.px_update_plan(k, W.device).chunks)
    _check_all(got, want)


@pytest.mark.parametrize("k", [32, 48, 96])
def test_rows89_repeat_is_bitwise_identical(dev, k):
    coeffs, (W, P, X) = _row89(k, (1 << 16) + 12, 430, dev)
    M1, M2, M3 = coeffs
    Y1, G1 = fused.mm2_update_gram(M1, W, M2, P)
    Y2, G2 = fused.mm2_update_gram(M1, W, M2, P)
    assert torch.equal(Y1, Y2) and torch.equal(G1, G2)
    a, b = fused.px_update(M1, W, M2, P, M3, X), fused.px_update(M1, W, M2, P, M3, X)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("case", ["config3", "config4_16", "config4_16_m96"])
def test_sbcgrq_on_rows89_repeats_bitwise(dev, case):
    """SBCGrQ on config 3 (64^3, 32 RHS) and on config 4's operator at 16^4
    sites (12 RHS: m = 48; 24 RHS: m = 96) twice: the same iterations and
    the same bits."""
    from blockcg_tpu_torch import solve_sbcgrq
    from blockcg_tpu_torch.problems import config3_sbcgrq_3d_64, config4_dirac_32

    if case == "config3":
        op, k = config3_sbcgrq_3d_64(device=dev)[0], 32
    else:
        op, k = config4_dirac_32(L=16, device=dev)[0], 24 if case.endswith("m96") else 12
    B = _t(np.random.default_rng(440).standard_normal((op.n, k)), dev)
    _native.reset_launches()
    X1, i1 = solve_sbcgrq(op, B, tol=1e-6)
    assert _native.launches["mm2_update_gram"] > 0 and _native.launches["px_update"] > 0
    X2, i2 = solve_sbcgrq(op, B, tol=1e-6)
    assert bool(i1.converged.all()) and i1.iterations == i2.iterations
    assert torch.equal(X1, X2)


# ---------------------- the streaming mm_update_gram (row 7), update_gram.cuh


def _row7(k, n, seed, dev, offset=0, shape=None):
    """M and the fields B and A of row 7, as ``_row89`` makes them."""
    rng = np.random.default_rng(seed)
    M = _t(rng.standard_normal((k, k)) / k ** 0.5, dev)
    fields = []
    for _ in range(2):
        buf = _t(rng.standard_normal(k * n + offset), dev)
        F = buf[offset:].view(k, n)
        fields.append(F if shape is None else F.view(shape))
    return M, fields


def _row7_matches_plain(dev, M, B, A, donate, launches):
    want = fused.mm_update_gram_plain(M, B, A)
    Bd = B.clone() if donate else B
    _native.reset_launches()
    Y, G = fused.mm_update_gram(M, Bd, A, donate=donate)
    torch.cuda.synchronize()
    assert _native.launches["mm_update_gram"] == launches
    assert Y.shape == B.shape and _relmax(Y, want[0]) < 1e-5 and _relfro(G, want[1]) < 1e-5
    assert (Y.data_ptr() == Bd.data_ptr()) is donate


@pytest.mark.parametrize("k", [1, 8, 16, 32, 48, 64, 96, 100, 128])
@pytest.mark.parametrize("n,offset", [(4096, 0), (3001, 0), (100, 0), (4096, 1)])
@pytest.mark.parametrize("with_a", [False, True])
@pytest.mark.parametrize("donate", [False, True])
def test_row7_streaming_kernel_matches_plain(dev, k, n, offset, with_a, donate):
    """Row 7 in one launch up to 128 rows (the Gram fused up to 96 rows,
    above that from ``gram``), with and without A, fresh and in place, on
    whole 16-byte tiles, n % 4 != 0, a field smaller than one tile and an
    offset view."""
    M, (B, A) = _row7(k, n, 500 + k, dev, offset)
    _row7_matches_plain(dev, M, B, A if with_a else None, donate, 1)


@pytest.mark.parametrize("donate", [False, True])
def test_row7_on_the_view_matches_plain(dev, donate):
    k, bs, ns = 32, 4, 1501
    M, (B, A) = _row7(k, bs * ns, 510, dev, shape=(k, bs, ns))
    for a in (None, A):
        _row7_matches_plain(dev, M, B, a, donate, 1)


@pytest.mark.parametrize("k", [400, 800])
@pytest.mark.parametrize("donate", [False, True])
def test_row7_wide_fields_run_their_plan(dev, k, donate):
    """Fields too wide for one launch: the plan's row chunks, each reading
    all of B, the Gram from ``gram`` on 64-row blocks; a donated B takes Y
    after the last chunk."""
    M, (B, A) = _row7(k, 700, 520, dev)
    plan = fused.mm_update_gram_plan(k, B.device)
    assert len(plan.chunks) > 1 and not plan.fused_gram
    _row7_matches_plain(dev, M, B, A, donate, len(plan.chunks))


@pytest.mark.parametrize("k", [32, 48, 96])
def test_row7_repeat_is_bitwise_identical(dev, k):
    M, (B, A) = _row7(k, (1 << 16) + 12, 530, dev)
    Y1, G1 = fused.mm_update_gram(M, B, A)
    Y2, G2 = fused.mm_update_gram(M, B, A)
    assert torch.equal(Y1, Y2) and torch.equal(G1, G2)


# ---------------------------------- the pipelined tiled_spmm_t (row 25)


def _synthetic_tiles(dev, tile_dtype, seed):
    """A tile set with a row tile of one tile, an empty row tile and a
    ``first`` reset inside a row tile's run; the tiles the reset drops are
    left out of the expected product."""
    rng = np.random.default_rng(seed)
    nrt = 40
    counts = rng.integers(2, 9, size=nrt)
    counts[5], counts[9], counts[17] = 1, 0, 6
    rt = np.repeat(np.arange(nrt), counts).astype(np.int32)
    ct = np.concatenate([np.sort(rng.choice(nrt, c, replace=False)) for c in counts])
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    first = np.zeros(len(rt), np.int32)
    first[row_ptr[:-1][counts > 0]] = 1
    first[row_ptr[17] + 3] = 1
    keep = np.ones(len(rt), bool)
    keep[row_ptr[17]:row_ptr[17] + 3] = False
    tiles = torch.as_tensor(rng.standard_normal((len(rt), 128, 128)), dtype=torch.float32,
                            device=dev).to(tile_dtype)
    i32 = [torch.as_tensor(a.astype(np.int32), device=dev) for a in (rt, ct, first)]
    return tiles, *i32, torch.as_tensor(keep, device=dev)


@pytest.mark.parametrize("tile_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 8, 32, 64, 96, 128])
def test_tiled_spmm_contract_on_card(dev, tile_dtype, k):
    """The kernel on the synthetic tile set: a one-tile row tile, an empty
    one (zeros), a reset inside a run; a repeat gives the same bits."""
    tiles, rt, ct, first, keep = _synthetic_tiles(dev, tile_dtype, 600 + k)
    Xt = _field(k, 40 * 128, 610 + k, dev)
    _native.reset_launches()
    Y = spmm_tiled.tiled_spmm_t(tiles, rt, ct, first, Xt)
    want = spmm_tiled.tiled_spmm_plain(tiles[keep], rt[keep], ct[keep], Xt)
    torch.cuda.synchronize()
    assert _native.launches["tiled_spmm_t"] == 1
    assert _relmax(Y, want) < 1e-5 and bool((Y[:, 9 * 128:10 * 128] == 0).all())
    assert torch.equal(spmm_tiled.tiled_spmm_t(tiles, rt, ct, first, Xt), Y)


@pytest.mark.parametrize("J,stages,R,sms", [(16, 2, None, None), (32, 4, None, None),
                                            (32, 3, 4, None), (32, 2, None, 4)])
def test_tiled_spmm_plan_variants_match_plain(dev, rgg_tiles, J, stages, R, sms):
    """The kernel on other slice widths, ring depths, register tiles and
    grids (the timing tool's variants; 4 SMs' worth of blocks, each summing
    many row tiles) gives the default plan's bits: the summation order per
    output does not depend on them."""
    _, op = rgg_tiles
    tiles, rt, ct, first = (t.to(dev) for t in (op.tiles, op.rt, op.ct, op.first))
    row_ptr = spmm_tiled.row_pointers(rt, op.n // 128)
    Xt = _field(32, op.n, 620, dev)
    Y = spmm_tiled.tiled_spmm_t(tiles, rt, ct, first, Xt, row_ptr)

    def plan(kk):
        return spmm_tiled.tiled_plan(row_ptr, kk, dev, tiles.dtype, J=J, stages=stages, R=R,
                                     sms=sms)
    assert torch.equal(spmm_tiled.tiled_spmm_t(tiles, rt, ct, first, Xt, row_ptr, plan), Y)


@pytest.mark.parametrize("case", ["config2_bcgdq", "rgg_sbcgrq"])
def test_rows7_25_solves_repeat_bitwise(dev, case):
    """Config 2's BCGdQ (row 7 every iteration) and SBCGrQ on an RCM-ordered
    RGG tile operator (row 25 every apply) twice: the same iterations and
    the same bits."""
    import blockcg_tpu_torch as bt
    from blockcg_tpu_torch.operators import TiledOperator

    if case == "config2_bcgdq":
        from blockcg_tpu_torch.problems import config2_bcg_2d_512

        op, k, solve, name = config2_bcg_2d_512(device=dev)[0], 16, bt.solve_bcgdq, \
            "mm_update_gram"
    else:
        op = TiledOperator.from_scipy(rgg_laplacian(40000, degree=20.0, seed=5),
                                      torch.float32, reorder="rcm", device=dev)
        k, solve, name = 32, bt.solve_sbcgrq, "tiled_spmm_t"
    B = _t(np.random.default_rng(640).standard_normal((op.n, k)), dev)
    _native.reset_launches()
    X1, i1 = solve(op, B, tol=1e-5)
    assert _native.launches[name] > 0
    X2, i2 = solve(op, B, tol=1e-5)
    assert i1.iterations == i2.iterations and torch.equal(X1, X2)


# -------------------- the streamed gram (row 5) and block stencil (rows 22-24)


def _gram_fields(k, layout, seed, dev):
    """Two (k, n) fields: whole 16-byte rows (n = 4096), n % 4 != 0 (n =
    1001), or views one float into their storage (n = 1024: 4-byte copies)."""
    n = {"vec": 4096, "ragged": 1001, "offset": 1024}[layout]
    out = []
    for s in (seed, seed + 1):
        a = np.random.default_rng(s).standard_normal(k * n + 1)
        buf = _t(a, dev)
        out.append(buf[1:].view(k, n) if layout == "offset" else buf[:k * n].view(k, n))
    return out


@pytest.mark.parametrize("k", [1, 7, 32, 48, 64, 65, 96, 97, 128])
@pytest.mark.parametrize("case", ["same", "distinct", "rect"])
@pytest.mark.parametrize("layout", ["vec", "ragged", "offset"])
def test_gram_kernel_matches_plain(dev, k, case, layout):
    """G = U V^T with U is V (the symmetric kernel: G exactly symmetric),
    U != V, and a rectangular block ku != kv of one launch, on whole 16-byte
    rows, n % 4 != 0 and an offset view; one launch up to 96 rows, the
    blocks of ``fused.gram_blocks`` above; a repeat gives the same bits."""
    U, V = _gram_fields(k, layout, 700 + k, dev)
    if case == "same":
        V = U
    _native.reset_launches()
    if case == "rect":
        ku = min(k, fused.GRAM_MAX_K)
        U, V = U[:ku], V[:max(1, (ku + 1) // 2)]

        def run():
            return fused._launch_gram(U, V)
        launches = 1
    else:
        def run():
            return fused.gram(U, V)
        launches = 1 if k <= fused.GRAM_MAX_K else sum(
            b[0] == "launch" for b in fused.gram_blocks(k, None, case == "same"))
    G = run()
    torch.cuda.synchronize()
    assert _native.launches["gram"] == launches
    want = U @ V.T if case == "rect" else fused.gram_plain(U, V)  # gram_t takes ku == kv
    assert G.shape == want.shape and _relfro(G, want) < 1e-5
    if case == "same":
        assert torch.equal(G, G.T)
    assert torch.equal(run(), G)


def test_gram_symmetric_and_general_kernels_agree(dev):
    """The same field as one storage (SymGram) and as a copy (VecGram): both
    hold the plain Gram; only the first is exactly symmetric by
    construction."""
    U = _field(96, 1 << 16, 720, dev)
    Gs, Gv = fused.gram(U, U), fused.gram(U, U.clone())
    want = fused.gram_plain(U, U)
    assert _relfro(Gs, want) < 1e-5 and _relfro(Gv, want) < 1e-5
    assert torch.equal(Gs, Gs.T)


def _bs_redesign_operands(ns, bs, k, dev, seed):
    """Per-site blocks on near (0, +-1, 17), far (-150, a 16-byte-aligned
    64) and wrap (ns - 1, ns + 152, -ns - 4) offsets."""
    rng = np.random.default_rng(seed)
    offsets = (0, 1, -1, 17, -150, 64, ns - 1, ns + 152, -ns - 4)
    blocks = _t(rng.standard_normal((len(offsets), bs, bs, ns)), dev)
    return blocks, offsets, _field(bs * k, ns, seed + 1, dev)


@pytest.mark.parametrize("bs", [1, 3, 4, 5, 8])
@pytest.mark.parametrize("width", ["one", "several"])
@pytest.mark.parametrize("ns", [300, 1000, 40_000])
def test_block_stencil_redesign_matches_plain(dev, bs, width, ns):
    """Both row maps, with and without the Gram, on a field of one launch
    (m = 48 or less) and of several (96 rows a launch, and 3 RHS more), at
    ns = 300 (4-byte copies), 1000 (16-byte copies) and 40,000 (several
    tiles a block, on an even grid), none a multiple of a tile; Y has the
    same bits with and without the Gram (each output's
    fmaf order does not depend on the plan), and a repeat gives the same
    bits."""
    k = max(1, 48 // bs) if width == "one" else bsk.MAX_ROWS // bs + 3
    blocks, offsets, Xm = _bs_redesign_operands(ns, bs, k, dev, 730 + bs)
    launches = len(bsk.launch_plans(blocks, offsets, k, False, Xm.device))
    assert (launches == 1) is (width == "one")
    _native.reset_launches()
    Y, G = bsk.block_stencil_spmm_m_gram_t(blocks, offsets, Xm)
    Y1 = bsk.block_stencil_spmm_m_t(blocks, offsets, Xm)
    Yp, Gp = bsk.block_stencil_plain(blocks, offsets, Xm, True)
    torch.cuda.synchronize()
    assert _relmax(Y, Yp) < 1e-5 and _relfro(G, Gp) < 1e-5 and torch.equal(Y, Y1)
    Y2, G2 = bsk.block_stencil_spmm_m_gram_t(blocks, offsets, Xm)
    assert torch.equal(Y2, Y) and torch.equal(G2, G)
    assert _native.launches["block_stencil_spmm_m_t"] == launches
    Xv = Xm.reshape(k, bs, ns)
    Yv = bsk.block_stencil_spmm_t(blocks, offsets, Xv)
    assert _relmax(Yv, bsk.block_stencil_v_plain(blocks, offsets, Xv)) < 1e-5
    assert torch.equal(bsk.block_stencil_spmm_t(blocks, offsets, Xv.reshape(k, -1)),
                       Yv.reshape(k, -1))


@pytest.mark.parametrize("h,groups,stages", [(0, None, None), (4, None, 2), (20, None, 3),
                                             (0, 1, 2), (152, 4, 4), (None, 8, 2),
                                             (None, 2, 4)])
def test_block_stencil_plan_variants_give_the_same_bits(dev, h, groups, stages):
    """The kernel on pinned plans (the timing tool's variants: no window, a
    near-only window, a window over every offset; one to eight groups; two
    to four stages) gives the default plan's bits, and its Gram holds the
    plain one."""
    bs, k, ns = 4, 12, 40_000  # several tiles a block
    blocks, offsets, Xm = _bs_redesign_operands(ns, bs, k, dev, 740)
    Y = bsk.block_stencil_spmm_m_t(blocks, offsets, Xm)
    Yp, Gp = bsk.block_stencil_plain(blocks, offsets, Xm, True)
    offs = tuple(o % ns for o in offsets)
    dev = Xm.device  # with its index
    cap, sms = _native.max_smem(dev.index), _native.sm_count(dev.index)
    for gram in (False, True):
        plan = bsk.block_stencil_plan(offs, ns, bs, k, gram, cap, sms, h=h, groups=groups,
                                      stages=stages)
        Yk = torch.empty_like(Xm)
        part = Gk = None
        if plan.fused_gram:
            part = torch.empty((plan.blocks, bs * k, bs * k), device=dev)
            Gk = torch.empty((bs * k, bs * k), device=dev)
        p = _native.ptr
        _native.launch("test", "bcg_block_stencil_spmm", dev, p(blocks), 4,
                       (ctypes.c_int * len(offs))(*offs), None, len(offs), bs, p(Xm),
                       p(Yk), p(part), p(Gk), k, k, ns, 1, plan.h, plan.groups, plan.ki,
                       plan.stages, plan.blocks)
        torch.cuda.synchronize()
        assert torch.equal(Yk, Y), plan.describe()
        if plan.fused_gram:
            assert _relfro(Gk, Gp) < 1e-5


def test_block_stencil_at_m96_is_one_launch(dev):
    """Config 4's width on ``dirac_bdia``'s bs = 4 (k = 24, m = 96) is one
    launch; its Gram comes from one 96-row ``gram`` launch."""
    op = dirac_bdia(8, device=dev)
    Xm = _field(96, op.ns, 750, dev)
    _native.reset_launches()
    Y, G = bsk.block_stencil_spmm_m_gram_t(op.blocks, op.offsets, Xm)
    Yp, Gp = bsk.block_stencil_plain(op.blocks, op.offsets, Xm, True)
    torch.cuda.synchronize()
    assert _native.launches["block_stencil_spmm_m_gram_t"] == 1
    assert _native.launches["gram"] == 1
    assert _relmax(Y, Yp) < 1e-5 and _relfro(G, Gp) < 1e-5


# ------------------- the merged const-hop kernel (csrc/cbs_merged.cu) and
# qr_p_update on px_update's schedule


def _grouped_operands(ns, bs, k, dev, seed):
    """Offsets in +- pairs that share a hop (as the Dirac operators' do),
    near and far ones, value masks: the plan groups and spans them."""
    rng = np.random.default_rng(seed)
    offsets = (0, 1, -1, 40, -40, 44, -44, ns // 3, -(ns // 3), 2 * ns + 7)
    base = rng.standard_normal((6, bs, bs))
    hops = _t(base[[0, 1, 1, 2, 2, 3, 3, 4, 4, 5]], dev)
    rows = _t(rng.choice([-1.0, 0.0, 1.0, 2.0], size=(4, ns)), dev)
    slots = (-1, 0, 1, 2, 3, -1, 0, 1, -1, 2)
    return hops, offsets, slots, rows, _field(bs * k, ns, seed + 1, dev)


def _config4_main(gauged, dev):
    op = (dirac_gauged_cbdia if gauged else dirac_cbdia)(32, device=dev)
    return op.hops_main, op.main_offsets, op.main_slots, op.masks_main, op.ns


@pytest.mark.parametrize("m", [4, 12, 48, 60, 96])
@pytest.mark.parametrize("which", ["random 300", "grouped 300", "config4", "gauged"])
def test_merged_kernel_matches_plain(dev, m, which):
    """Rows 16 and 17 against the plain version at ns = 300 (random and
    grouped hops, value masks) and at 32^4 on config 4's operator and its
    Z2-gauged form: one launch (groups of ``launch_plan``'s kb right-hand
    sides a block, the last one partial at m = 60), the Gram from one
    ``gram`` launch, and a repeat gives the same bits."""
    k = m // 4
    if which.endswith("300"):
        make = _cbs_operands if which.startswith("random") else _grouped_operands
        args = (300, 4, k, "values", dev, 40 + m) if make is _cbs_operands else (300, 4, k,
                                                                                  dev, 40 + m)
        hops, offsets, slots, rows, Xm = make(*args)
    else:
        hops, offsets, slots, rows, ns = _config4_main(which == "gauged", dev)
        Xm = _field(m, ns, 50 + m, dev)
    main = (hops, offsets, slots, rows)
    plan = cbs.launch_plan(cbs.hop_table_key(hops.tolist()), offsets, rows.shape[0], k,
                           Xm.shape[1], Xm.device)
    assert plan.kb == min(k, cbs.CM_KB)
    _native.reset_launches()
    Y, G = cbs.const_block_stencil_spmm_m_gram_t(*main, Xm)
    Y1 = cbs.const_block_stencil_spmm_m_t(*main, Xm)
    assert _native.launches["const_block_stencil_spmm_m_gram_t"] == 1
    assert _native.launches["const_block_stencil_spmm_m_t"] == 1
    assert _native.launches["gram"] == 1
    Yp, Gp = cbs.const_block_stencil_plain(*main, Xm, True)
    torch.cuda.synchronize()
    assert _relmax(Y, Yp) < 1e-5 and _relfro(G, Gp) < 1e-5
    assert torch.equal(Y1, Y)
    Y2, G2 = cbs.const_block_stencil_spmm_m_gram_t(*main, Xm)
    assert torch.equal(Y2, Y) and torch.equal(G2, G)


@pytest.mark.parametrize("pin", [{"h": 0}, {"h": 4}, {"sw": 1}, {"kb": 12, "sw": 1},
                                 {"kb": 5, "sw": 2}, {"grouped": False}])
def test_merged_plan_pins(dev, pin):
    """A pinned ``const_block_stencil_plan`` (no window, a 4-site halo,
    128-site tiles, other groups of right-hand sides a block, a partial one
    at kb = 5, no hop groups) agrees with the plain version within the
    tolerance, and gives the default plan's Y bits where it keeps the plan's
    order and groups (the tile and the blocks' right-hand sides alone do not
    move a sum)."""
    ns = 32 ** 4
    op = dirac_cbdia(32, device=dev)
    main = (op.hops_main, op.main_offsets, op.main_slots, op.masks_main)
    Xm = _field(48, ns, 61, dev)
    idx = Xm.device.index
    cap, sms = _native.max_smem(idx), _native.sm_count(idx)
    args = (tuple(o % ns for o in op.main_offsets), op.main_plans.hop_key,
            op.masks_main.shape[0], 4, 12, ns, cap, sms)
    plan0 = cbs.const_block_stencil_plan(*args)
    plan = cbs.const_block_stencil_plan(*args, **pin)
    Y0 = cbs.launch_planned(*main, Xm, plan0)
    Y = cbs.launch_planned(*main, Xm, plan)
    Yp = cbs.const_block_stencil_plain(*main, Xm)[0]
    torch.cuda.synchronize()
    assert _relmax(Y, Yp) < 1e-5
    if (plan.order, plan.gid) == (plan0.order, plan0.gid):
        assert torch.equal(Y, Y0)


@pytest.mark.parametrize("k", [8, 48, 96, 100])
@pytest.mark.parametrize("donate", [False, True])
def test_qr_p_update_on_px_schedule(dev, k, donate):
    """Row 12 on px_update.cu: one launch up to 128 rows, in place when
    donated; Q has mm_update's bits (the fmaf chain over M2's columns from
    0) and Pn px_update's (the same chain on over rho's), the order of the
    one-thread-a-column kernel it replaced."""
    n = 5000
    rng = np.random.default_rng(k)
    M2, rho = (_t(rng.standard_normal((k, k)) / k ** 0.5, dev) for _ in range(2))
    Q1, P = _field(k, n, 70, dev), _field(k, n, 71, dev)
    Qa, Pa = Q1.clone(), P.clone()
    _native.reset_launches()
    Q, Pn = fused.qr_p_update(M2, Qa, rho, Pa, donate=donate)
    assert _native.launches["qr_p_update"] == 1
    assert fused.qr_p_update_plan(k, Q1.device).in_place
    if donate:
        assert Q.data_ptr() == Qa.data_ptr() and Pn.data_ptr() == Pa.data_ptr()
    want_q = fused.mm_update(M2, Q1)
    want_p = fused.px_update(M2, Q1, rho, P, rho, P)[0]
    Qp, Pp = fused.qr_p_update_plain(M2, Q1, rho, P)
    torch.cuda.synchronize()
    assert torch.equal(Q, want_q) and torch.equal(Pn, want_p)
    assert _relmax(Q, Qp) < 1e-5 and _relmax(Pn, Pp) < 1e-5


# ---- bf16 fields (rows 1-2, 5-9): each bf16 variant against its plain
# version. Tolerances: a stored bf16 element within one bf16 ulp of the plain
# version's (products are exact in f32; the two differ in f32 summation
# order alone, which can flip a rounding), an element below 2^-8 of the
# field's largest held to the ulp at that floor (where a sum cancels, its f32
# rounding error is a fraction of the terms', not of the sum's: 2 ulps of a
# small sum at k = 96 on an H100); Grams to a relative Frobenius error of 1e-5.


def _bf(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev).bfloat16()


def _bf_field(k, n, seed, dev):
    return _bf(np.random.default_rng(seed).standard_normal((k, n)), dev)


def _ulps(got, want):
    """Largest |got - want| in bf16 ulps of the larger of the two, at least of
    2^-8 of the largest |want|."""
    g, w = got.double(), want.double()
    m = torch.maximum(torch.maximum(g.abs(), w.abs()), w.abs().max() * 2.0 ** -8)
    ulp = torch.exp2(torch.floor(torch.log2(torch.where(m > 0, m, torch.ones_like(m)))) - 7)
    return float(((g - w).abs() / ulp).max())


@pytest.mark.parametrize("n,k,offsets", [
    (1000, 4, (-130, -7, -1, 0, 2, 64, 257)),      # n % 8 == 0, populated wraps
    (4096, 32, (-256, -16, -1, 0, 1, 16, 256)),
    (777, 40, (0, 700, -700, 3)),                   # ragged n: element copies
    (300, 64, (-1, 0, 1, 600)),                     # |o| >= n reduces mod n
    # the tensor-core Gram's edges: Gram widths 16, 48 and 64, ragged n,
    # far diagonals of odd offset, windows across 0 and n on every tile
    (4099, 12, (-5, -1, 0, 1, 3)),
    (8192, 48, (-1, 0, 1, 601, -600)),
    (2048, 64, (0, 1, -1, 2047, 1, 2041)),
])
def test_stencil_bf16_matches_plain(dev, n, k, offsets):
    """The bf16 stencil with and without its Gram against the plain
    version: Y within one bf16 ulp, and the Gram's Y (on the tensor cores)
    bitwise the SpMM's (both sum each element with fmaf in the diagonals'
    order); G within 1e-5 of the plain version and of the f64 Gram of the
    f32 sums (the f32 kernel on the lifted values)."""
    rng = np.random.default_rng(100)
    diags = _bf(rng.standard_normal((len(offsets), n)), dev)
    Xt = _bf_field(k, n, 101, dev)
    _native.reset_launches()
    Y, G = stencil.stencil_spmm_gram_t(diags, offsets, Xt)
    Y1 = stencil.stencil_spmm_t(diags, offsets, Xt)
    assert _native.launches["stencil_spmm_gram_t[bf16]"] == 1
    assert _native.launches["stencil_spmm_t[bf16]"] == 1
    Yp, Gp = stencil.stencil_spmm_plain(diags, offsets, Xt, with_gram=True)
    assert Y.dtype == torch.bfloat16 and G.dtype == torch.float32
    assert _ulps(Y, Yp) <= 1 and _ulps(Y1, Yp) <= 1 and _relfro(G, Gp) < 1e-5
    assert torch.equal(Y, Y1)
    S = stencil.stencil_spmm_t(diags.float(), offsets, Xt.float())
    assert _relfro(G.double(), Xt.double() @ S.double().T) < 1e-5
    assert torch.equal(stencil.stencil_spmm_gram_t(diags, offsets, Xt)[1], G)


def test_stencil_bf16_laplacian_256(dev):
    """Config 5's operator in bf16 at a 64^3 cut: the Gram's plan serves
    +-1 and +-64 from the window, +-4096 are far. Y bitwise the SpMM's, the
    Gram within 1e-5 of the f64 Gram of the f32 sums, a repeat bitwise."""
    op = laplacian_dia((64, 64, 64), dtype=torch.bfloat16, device=dev)
    Xt = _bf_field(32, op.n, 102, dev)
    Y, G = op.matmat_gram_t(Xt)
    Yp, Gp = stencil.stencil_spmm_plain(op.diags, op.offsets, Xt, with_gram=True)
    assert _ulps(Y, Yp) <= 1 and _relfro(G, Gp) < 1e-5
    assert torch.equal(Y, stencil.stencil_spmm_t(op.diags, op.offsets, Xt))
    S = stencil.stencil_spmm_t(op.diags.float(), op.offsets, Xt.float())
    assert _relfro(G.double(), Xt.double() @ S.double().T) < 1e-5
    Y2, G2 = op.matmat_gram_t(Xt)
    assert torch.equal(Y2, Y) and torch.equal(G2, G)


# sha256 (16 hex digits) of the bits of the bf16 stencil's Y with its Gram,
# as the one-thread-a-column kernel gave them before the Gram moved to the
# tensor cores (H100), on the inputs of _pinned_stencil_case.
_STENCIL_Y_PINS = {
    (4096, 32, (-256, -16, -1, 0, 1, 16, 256)): "624bf8f6cfe55d96",
    (4099, 12, (-5, -1, 0, 1, 3)): "a38a5d108d69a081",
    (777, 40, (0, 700, -700, 3)): "fdd949baf5f645f4",
    (8192, 64, (-1, 0, 1, 600, -600)): "7aa424e552079d7c",
    (1000, 48, (-130, -7, -1, 0, 2, 64, 257)): "def1728d0725fca4",
    "laplacian 64^3": "1b7b9bfc9f673d45",
}


def _sha16(t):
    import hashlib

    return hashlib.sha256(t.contiguous().cpu().view(torch.int16).numpy().tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("case", list(_STENCIL_Y_PINS), ids=str)
def test_stencil_bf16_gram_y_keeps_its_bits(dev, case):
    """The stored Y of ``stencil_spmm_gram_t[bf16]`` is bitwise what the
    kernel gave before its Gram moved to the tensor cores (pinned checksums
    of the bits), and its Gram within 1e-5 of the f64 Gram of the f32 sums."""
    if case == "laplacian 64^3":
        op = laplacian_dia((64, 64, 64), dtype=torch.bfloat16, device=dev)
        diags, offsets = op.diags, op.offsets
        Xt = _bf(np.random.default_rng(532).standard_normal((32, op.n)), dev)
    else:
        n, k, offsets = case
        rng = np.random.default_rng(500 + k)
        diags = _bf(rng.standard_normal((len(offsets), n)), dev)
        Xt = _bf(rng.standard_normal((k, n)), dev)
    Y, G = stencil.stencil_spmm_gram_t(diags, offsets, Xt)
    assert _sha16(Y) == _STENCIL_Y_PINS[case]
    S = stencil.stencil_spmm_t(diags.float(), offsets, Xt.float())
    assert _relfro(G.double(), Xt.double() @ S.double().T) < 1e-5


@pytest.mark.parametrize("pair", ["bf16", "bf16 field"])
def test_stencil_bf16_gram_keeps_every_bit_of_the_sums(dev, pair):
    """The Gram X Y^T of the f32 sums, whose bits past bf16's 16 a
    two-piece split would drop: offsets (0, 1, 2) with diagonals 1, 2^-10 and
    2^-20 on X = b_r on three columns of every 512 (0 elsewhere) give sums
    b (1 + 2^-10 + 2^-20), b (1 + 2^-10), b and G = 8 b_r b_s (3 + 2^-9 +
    2^-20), every partial sum exact in f32: G equals it bitwise, which the
    sums in two pieces (8 b_r b_s (3 + 2^-9)) do not."""
    k, n = 16, 4096
    b = np.random.default_rng(390).choice([-2.0, -1.0, -0.5, 0.5, 1.0, 2.0], k)
    X = np.zeros((k, n))
    for m in range(0, n, 512):
        X[:, m:m + 3] = b[:, None]
    d = np.stack([np.full(n, 1.0), np.full(n, 2.0 ** -10), np.full(n, 2.0 ** -20)])
    Yf = sum(d[j] * np.roll(X, -j, axis=1) for j in range(3))
    want = X @ Yf.T
    f = torch.from_numpy(Yf.astype(np.float32))
    hi = f.bfloat16().float()
    two = (hi + (f - hi).bfloat16().float()).double().numpy()
    assert not np.array_equal(want, X @ two.T)
    Xt = _bf(X, dev)
    diags = _bf(d, dev) if pair == "bf16" else _t(d, dev)
    _native.reset_launches()
    Y, G = stencil.stencil_spmm_gram_t(diags, (0, 1, 2), Xt)
    assert _native.launches[f"stencil_spmm_gram_t[{pair}]"] == 1
    assert torch.equal(G.double().cpu(), torch.from_numpy(want))


@pytest.mark.parametrize("k,n", [(16, 4096), (40, 1000), (33, 4104)])
def test_stencil_bf16_unaligned_field(dev, k, n):
    """A field one element off 4-byte alignment (element copies of the
    window, element reads of the far diagonals, element stores of Y): Y
    within one bf16 ulp of the plain version and bitwise the SpMM's, the
    Gram within 1e-5."""
    rng = np.random.default_rng(395 + k)
    offsets = (-2049, -1, 0, 1, 2, 700)
    diags = _bf(rng.standard_normal((len(offsets), n)), dev)
    raw = _bf(rng.standard_normal(k * n + 1), dev)
    Xt = raw[1:].view(k, n)
    assert Xt.data_ptr() % 4 != 0
    Y, G = stencil.stencil_spmm_gram_t(diags, offsets, Xt)
    Yp, Gp = stencil.stencil_spmm_plain(diags, offsets, Xt, with_gram=True)
    assert _ulps(Y, Yp) <= 1 and _relfro(G, Gp) < 1e-5
    assert torch.equal(Y, stencil.stencil_spmm_t(diags, offsets, Xt))


@pytest.mark.parametrize("k,n", [(3, 1000), (16, 5000), (32, 4099), (32, 8192), (64, 700),
                                 (96, 2048), (128, 1024), (200, 512),
                                 # the tensor cores' edges: rows not a multiple of 16
                                 # (of 8 for 12), ragged n
                                 (12, 4099), (40, 777), (48, 8192), (64, 8192)])
def test_fused_bf16_kernels_match_plain(dev, k, n):
    rng = np.random.default_rng(200 + k)
    M1, M2, M3 = (_t(rng.standard_normal((k, k)) / np.sqrt(k), dev) for _ in range(3))
    B1, B2, A = (_bf_field(k, n, s, dev) for s in (203, 204, 205))
    _native.reset_launches()
    G = fused.gram(B1, B2)
    assert G.dtype == torch.float32 and _relfro(G, fused.gram_plain(B1, B2)) < 1e-5
    Gs = fused.gram(B1, B1)
    assert torch.equal(Gs, Gs.T) and _relfro(Gs, fused.gram_plain(B1, B1)) < 1e-5
    for a in (None, A):
        Y = fused.mm_update(M1, B1, a)
        assert Y.dtype == torch.bfloat16 and _ulps(Y, fused.mm_update_plain(M1, B1, a)) <= 1
        # The Gram is of the stored, rounded Y: held against the Gram of the
        # kernel's own Y (a flipped element of Y moves the plain version's G
        # by more than the f32 summation order does).
        Y, G = fused.mm_update_gram(M1, B1, a)
        Yp, _ = fused.mm_update_gram_plain(M1, B1, a)
        assert _ulps(Y, Yp) <= 1 and _relfro(G, fused.gram_plain(Y, Y)) < 1e-5
        assert _relfro(G.double(), Y.double() @ Y.double().T) < 1e-5
        if k <= fused.UPDATE_GRAM_MMA_MAX_K:  # the tensor cores' Gram: exactly symmetric
            assert torch.equal(G, G.T)
    Y, G = fused.mm2_update_gram(M1, B1, M2, B2)
    Yp, _ = fused.mm2_update_gram_plain(M1, B1, M2, B2)
    assert _ulps(Y, Yp) <= 1 and _relfro(G, fused.gram_plain(Y, Y)) < 1e-5
    assert _relfro(G.double(), Y.double() @ Y.double().T) < 1e-5
    if k <= fused.UPDATE_GRAM_MMA_MAX_K:
        assert torch.equal(G, G.T)
    Pn, Xn = fused.px_update(M1, B1, M2, B2, M3, A)
    Pp, Xp = fused.px_update_plain(M1, B1, M2, B2, M3, A)
    assert _ulps(Pn, Pp) <= 1 and _ulps(Xn, Xp) <= 1
    for w in ("gram", "mm_update", "mm_update_gram", "mm2_update_gram", "px_update"):
        assert _native.launches[f"{w}[bf16]"] >= 1 and _native.launches[w] == 0


@pytest.mark.parametrize("k,n", [(32, 3000), (12, 4099), (48, 8192), (64, 777)])
def test_fused_bf16_donated_match_fresh(dev, k, n):
    """In place (the solvers donate) gives the fresh call's bits: rows 7
    and 8 on the tensor cores up to 64 rows (aligned, ragged), row 9."""
    rng = np.random.default_rng(210)
    M1, M2, M3 = (_t(rng.standard_normal((k, k)) / np.sqrt(k), dev) for _ in range(3))
    W, P, X = (_bf_field(k, n, s, dev) for s in (211, 212, 213))
    want = fused.mm2_update_gram(M1, W, M2, P)
    Wd = W.clone()
    got = fused.mm2_update_gram(M1, Wd, M2, P, donate=True)
    assert got[0].data_ptr() == Wd.data_ptr()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    want = fused.mm_update_gram(M1, W, X)
    Wd = W.clone()
    got = fused.mm_update_gram(M1, Wd, X, donate=True)
    assert got[0].data_ptr() == Wd.data_ptr()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    want = fused.px_update(M1, W, M2, P, M3, X)
    Pd, Xd = P.clone(), X.clone()
    got = fused.px_update(M1, W, M2, Pd, M3, Xd, donate=True)
    assert got[0].data_ptr() == Pd.data_ptr() and got[1].data_ptr() == Xd.data_ptr()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_bf16_dispatch_refusals(dev):
    """A stencil pair no rule names, bf16 coefficients and mixed field sets
    raise; nothing launches and nothing falls back to a plain version. (The
    mixed f32/bf16 stencil pairs launch their variants and an all-bf16
    ``cheb_step`` runs its plain version, as the reference's gates take
    them: ``test_mixed_stencil_pairs_match_plain``,
    ``test_cheb_step_bf16_runs_plain``.)"""
    op32 = laplacian_dia((8, 8, 8), device=dev)
    X32 = _field(4, op32.n, 220, dev)
    _native.reset_launches()
    with pytest.raises(TypeError):
        stencil.stencil_spmm_t(op32.diags.double(), op32.offsets, X32.bfloat16())
    with pytest.raises(TypeError):
        stencil.stencil_spmm_gram_t(op32.diags.double(), op32.offsets, X32)
    a = _t(np.eye(4), dev)
    with pytest.raises(TypeError):  # a bf16 coefficient is not the contract
        fused.xr_update_gram(a.bfloat16(), *(X32.bfloat16() for _ in range(4)))
    with pytest.raises(TypeError):  # bf16 and f32 fields in one call
        fused.qr_p_update(a, X32.bfloat16(), a, X32)
    with pytest.raises(TypeError):
        fused.qr_px_update(a, X32.bfloat16(), a, X32.bfloat16(), a, X32)
    with pytest.raises(TypeError):
        fused.cheb_step(*(X32.bfloat16() for _ in range(3)), X32, 0.5, 0.5)
    with pytest.raises(TypeError):  # bf16 and f32 fields in one call
        fused.mm2_update_gram(a, X32.bfloat16(), a, X32)
    assert sum(_native.launches.values()) == 0


# Each staging site of a bf16 variant's coefficients, on Y = (1 + 2^-10) b - b:
# the f32 coefficient gives exactly 2^-10 b; rounded to bf16 it would be 1 and
# give 0. (name, call on (M, B, zero coefficients, zero field)) -> the stored
# output whose first row is Y.
_F32_COEFF_CASES = {
    "mm_update": lambda M, B, O, Z: fused.mm_update(M, B),
    "mm_update_gram": lambda M, B, O, Z: fused.mm_update_gram(M, B)[0],
    "mm2_update_gram": lambda M, B, O, Z: fused.mm2_update_gram(M, B, O, B)[0],
    # the cancelling pair across the stacked coefficient [M1 M2]: c from M1,
    # -c' from M2, both on b
    "mm2_update_gram M1 M2": lambda M, B, O, Z: fused.mm2_update_gram(
        torch.diag(torch.diag(M)), B, M - torch.diag(torch.diag(M)), B.flip(0))[0],
    "px_update": lambda M, B, O, Z: fused.px_update(M, B, O, B, O, B)[0],
    "xr_update_gram": lambda M, B, O, Z: fused.xr_update_gram(M, B, Z, B, B)[0],
    "qr_p_update": lambda M, B, O, Z: fused.qr_p_update(M, B, O, B)[0],
    "qr_px_update": lambda M, B, O, Z: fused.qr_px_update(M, B, O, B, M, Z)[2],
}


@pytest.mark.parametrize("name", sorted(_F32_COEFF_CASES))
def test_bf16_coefficients_stay_f32(dev, name):
    """The bf16 variants multiply by the f32 coefficient, as the plain
    versions do (the reference's f32 coefficient route), never by its bf16
    rounding; and by all 24 of its bits, which a split of the coefficient
    into two bf16 pieces (16 bits) would not hold: Y = c b - c' b with c = 1
    + 2^-10 + 2^-20 and c' = 1 + 2^-10 is 2^-20 b (0 from two pieces), on b
    of two significant bits, so every product and sum is exact in f32."""
    b = _bf_field(1, 4096, 350, dev)
    B = torch.cat([b, b])
    M = _t([[1 + 2.0 ** -10, -1.0], [0.0, 1.0]], dev)
    _native.reset_launches()
    Y = _F32_COEFF_CASES[name](M, B, torch.zeros_like(M), torch.zeros_like(B))
    assert torch.equal(Y[0], b[0] * 2.0 ** -10)
    assert _native.launches[f"{name.split()[0]}[bf16]"] == 1
    rng = np.random.default_rng(351)
    b = _bf(rng.choice([-3.0, -1.5, -1.0, -0.75, 0.75, 1.0, 1.5, 3.0], (1, 4096)), dev)
    B = torch.cat([b, b])
    c, c2 = 1 + 2.0 ** -10 + 2.0 ** -20, 1 + 2.0 ** -10
    M = _t([[c, -c2], [0.0, 1.0]], dev)
    Y = _F32_COEFF_CASES[name](M, B, torch.zeros_like(M), torch.zeros_like(B))
    want = b[0].double() * (c - c2)
    assert float(((Y[0].double() - want).abs() / want.abs()).max()) <= 2.0 ** -12
    assert torch.equal(Y[0], (b[0].float() * 2.0 ** -20).bfloat16())
    assert _native.launches[f"{name.split()[0]}[bf16]"] == 2


def _wraps(tiles, blocks, stages):
    """Times the busiest block of a persistent grid goes round its ring."""
    return -(-tiles // blocks) / stages


# n = 40,000: about one column tile a block; n = 2^22: every block goes
# round its TMA ring several times, so stages are refilled and their
# barriers change phase.
@pytest.mark.parametrize("n", [40000, 1 << 22])
def test_bf16_tensor_core_rows_repeat_and_donate(dev, n):
    """``gram[bf16]`` (U V^T and U U^T) and ``mm_update[bf16]`` (with and
    without A) at k = 32 (tensor cores): Grams within 1e-5 (relative
    Frobenius) of the plain version and of the f64 Gram, U U^T exactly
    symmetric, Y within 1 bf16 ulp of the plain version; a repeated call
    gives the same bits, and a donated B or A takes the fresh Y's bits in
    place."""
    k = 32
    if n > 1 << 20:
        idx = torch.cuda.current_device()
        smem, sms = _native.max_smem(idx), _native.sm_count(idx)
        for same in (False, True):
            plan = fused.gram_plan(k, k, same, n, smem, sms, 2)
            assert _wraps(-(-n // plan.T), plan.blocks, plan.stages) >= 4
        for has_a in (False, True):
            plan = fused.mm_update_mma_plan(k, n, has_a, smem, sms)
            blocks = min(-(-n // plan.T), sms * fused.mm_mma_blocks_per_sm(k))
            assert _wraps(-(-n // plan.T), blocks, plan.stages) >= 4
    gen = torch.Generator(device=dev).manual_seed(360)
    U, V, A = (torch.randn((k, n), generator=gen, device=dev).bfloat16() for _ in range(3))
    M = torch.randn((k, k), generator=gen, device=dev) / k ** 0.5
    _native.reset_launches()
    for X in (V, U):
        G = fused.gram(U, X)
        assert torch.equal(G, fused.gram(U, X))
        assert _relfro(G, fused.gram_plain(U, X)) < 1e-5
        assert _relfro(G.double(), U.double() @ X.double().T) < 1e-5
    assert torch.equal(G, G.T)
    del G
    for a in (None, A):
        want = fused.mm_update(M, U, a)
        assert torch.equal(want, fused.mm_update(M, U, a))
        assert _ulps(want, fused.mm_update_plain(M, U, a)) <= 1
        for donate in ("b",) + (("a",) if a is not None else ()):
            Ud, Ad = U.clone(), None if a is None else a.clone()
            got = fused.mm_update(M, Ud, Ad, donate=donate)
            assert got.data_ptr() == (Ud if donate == "b" else Ad).data_ptr()
            assert torch.equal(got, want)
            del Ud, Ad, got
    assert _native.launches["gram[bf16]"] == 4 and _native.launches["mm_update[bf16]"] == 7
    # Rows 7 and 8 with their Gram (update_gram_mma's ring) and the stencil
    # with its Gram on a 64 x 256 x 256 (n = 2^22) or 40,000-column torus:
    # Y within 1 bf16 ulp, G within 1e-5 of the f64 Gram its contract names
    # (exactly symmetric for rows 7 and 8), a repeat bitwise, a donated B1
    # (B) the fresh Y's bits.
    if n > 1 << 20:
        for nf, has_a in ((2, False), (1, False), (1, True)):
            plan = fused.update_gram_mma_plan(k, n, nf, has_a, smem, sms)
            assert _wraps(-(-n // plan.T), min(-(-n // plan.T), sms), plan.stages) >= 4
    M2 = torch.randn((k, k), generator=gen, device=dev) / k ** 0.5
    _native.reset_launches()
    want = fused.mm2_update_gram(M, U, M2, V)
    assert all(torch.equal(a, b) for a, b in zip(want, fused.mm2_update_gram(M, U, M2, V)))
    assert _ulps(want[0], fused.mm2_update_gram_plain(M, U, M2, V)[0]) <= 1
    assert torch.equal(want[1], want[1].T)
    assert _relfro(want[1].double(), want[0].double() @ want[0].double().T) < 1e-5
    Ud = U.clone()
    got = fused.mm2_update_gram(M, Ud, M2, V, donate=True)
    assert got[0].data_ptr() == Ud.data_ptr()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    del want, got, Ud
    for a in (None, A):
        want = fused.mm_update_gram(M, U, a)
        assert all(torch.equal(x, y) for x, y in zip(want, fused.mm_update_gram(M, U, a)))
        assert _ulps(want[0], fused.mm_update_gram_plain(M, U, a)[0]) <= 1
        assert torch.equal(want[1], want[1].T)
        Ud = U.clone()
        got = fused.mm_update_gram(M, Ud, a, donate=True)
        assert got[0].data_ptr() == Ud.data_ptr()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        del want, got, Ud
    assert _native.launches["mm2_update_gram[bf16]"] == 3
    assert _native.launches["mm_update_gram[bf16]"] == 6
    offsets = (0, 1, -1, 256, -256, 65536, -65536) if n > 1 << 20 else (0, 1, -1, 200, -200,
                                                                         20000, -20001)
    diags = torch.randn((len(offsets), n), generator=gen, device=dev).bfloat16()
    Y, G = stencil.stencil_spmm_gram_t(diags, offsets, U)
    Y2, G2 = stencil.stencil_spmm_gram_t(diags, offsets, U)
    assert torch.equal(Y, Y2) and torch.equal(G, G2)
    assert torch.equal(Y, stencil.stencil_spmm_t(diags, offsets, U))
    S = stencil.stencil_spmm_t(diags.float(), offsets, U.float())
    assert _relfro(G.double(), U.double() @ S.double().T) < 1e-5
    assert _ulps(Y, S) <= 1


@pytest.mark.parametrize("k,n", [(16, 4096), (40, 1000), (33, 4104)])
def test_bf16_tensor_core_rows_unaligned_fields(dev, k, n):
    """Fields one element off 16-byte alignment take the element copies into
    the same stages (no TMA): Gram within 1e-5 (relative Frobenius), Y
    within 1 bf16 ulp of the plain versions."""
    rng = np.random.default_rng(370 + k)
    raw = _bf(rng.standard_normal(3 * k * n + 1), dev)
    U, V, A = (raw[1 + i * k * n:1 + (i + 1) * k * n].view(k, n) for i in range(3))
    assert U.data_ptr() % 16 != 0
    M = _t(rng.standard_normal((k, k)) / np.sqrt(k), dev)
    _native.reset_launches()
    assert _relfro(fused.gram(U, V), fused.gram_plain(U, V)) < 1e-5
    Gs = fused.gram(U, U)
    assert torch.equal(Gs, Gs.T) and _relfro(Gs, fused.gram_plain(U, U)) < 1e-5
    for a in (None, A):
        assert _ulps(fused.mm_update(M, U, a), fused.mm_update_plain(M, U, a)) <= 1
        Y, G = fused.mm_update_gram(M, U, a)
        assert _ulps(Y, fused.mm_update_gram_plain(M, U, a)[0]) <= 1
        assert torch.equal(G, G.T) and _relfro(G, fused.gram_plain(Y, Y)) < 1e-5
    Y, G = fused.mm2_update_gram(M, U, M, V)
    assert _ulps(Y, fused.mm2_update_gram_plain(M, U, M, V)[0]) <= 1
    assert torch.equal(G, G.T) and _relfro(G, fused.gram_plain(Y, Y)) < 1e-5
    assert _native.launches["gram[bf16]"] == 2 and _native.launches["mm_update[bf16]"] == 2
    assert _native.launches["mm_update_gram[bf16]"] == 2
    assert _native.launches["mm2_update_gram[bf16]"] == 1


@pytest.mark.parametrize("ku,kv", [(16, 40), (40, 16), (8, 96), (96, 12)])
def test_gram_bf16_rectangular_launch(dev, ku, kv):
    """One launch of U V^T with ku != kv (rows padded to 16 and 8 inside
    the launch) against the f32 product of the same values."""
    U, V = _bf_field(ku, 5000, 380, dev), _bf_field(kv, 5000, 381, dev)
    _native.reset_launches()
    G = fused._launch_gram(U, V)
    assert G.shape == (ku, kv) and _native.launches["gram[bf16]"] == 1
    assert _relfro(G, U.float() @ V.float().T) < 1e-5


def test_bf16_sbcgrq_and_lean_on_card(dev):
    """The bf16 inner solve launches the bf16 variants and agrees with the
    CPU run of the same inputs in iterations; the lean refinement reaches 1e-6."""
    from blockcg_tpu_torch import solve_refined_lean
    from blockcg_tpu_torch.solvers import refine
    from blockcg_tpu_torch.solvers.sbcgrq import _sbcgrq_impl

    op = laplacian_dia((32, 32, 32), dtype=torch.bfloat16, device=dev)
    opc = laplacian_dia((32, 32, 32), dtype=torch.bfloat16, device="cpu")
    Bt = refine.lean_rhs(5, 16, op.n, torch.bfloat16, "cpu")
    _native.reset_launches()
    X, info = _sbcgrq_impl(op, Bt.to(dev), torch.zeros_like(Bt, device=dev), 5e-3, 400, 1, 0,
                           False)
    Xc, infoc = _sbcgrq_impl(opc, Bt, torch.zeros_like(Bt), 5e-3, 400, 1, 0, False)
    assert X.dtype == torch.bfloat16 and bool(info.converged.all())
    assert abs(info.iterations - infoc.iterations) <= 2
    for w in ("stencil_spmm_t", "stencil_spmm_gram_t", "gram", "mm_update", "mm2_update_gram",
              "px_update"):
        assert _native.launches[f"{w}[bf16]"] >= 1, w
    Xl, infol = solve_refined_lean(op, 3, 16, tol=1e-6, inner_block=8)
    assert bool(infol.converged.all()) and Xl.dtype == torch.float32
    B = refine.lean_rhs(3, 16, op.n, torch.bfloat16, dev).double().T
    op64 = laplacian_dia((32, 32, 32), dtype=torch.float64, device=dev)
    res = torch.linalg.vector_norm(B - op64.matmat(Xl.double()), dim=0)
    assert float((res / torch.linalg.vector_norm(B, dim=0)).max()) <= 1e-6


# ---- bf16 fields on rows 10, 12 and 13 (xr_update_gram, qr_p_update,
# qr_px_update): tolerances as for rows 5-9 above.


def _xr_qr_bf16(k, n, seed, dev):
    rng = np.random.default_rng(seed)
    M1, M2, M3 = (_t(rng.standard_normal((k, k)) / np.sqrt(k), dev) for _ in range(3))
    F = [_bf_field(k, n, seed + s, dev) for s in range(4)]
    return (M1, M2, M3), F


@pytest.mark.parametrize("k,n", [(3, 1000), (16, 5000), (32, 4099), (48, 8192), (64, 700),
                                 (96, 2048), (128, 1024)])
def test_xr_qr_bf16_kernels_match_plain(dev, k, n):
    """Each bf16 variant against its plain version: 4099 columns take element
    copies, 96 and 128 rows the row-chunked launches (``xr_update_gram``'s
    Gram then from ``wide_gram`` on ``gram[bf16]``)."""
    (M1, M2, M3), (P, X, Z, R) = _xr_qr_bf16(k, n, 300 + k, dev)
    _native.reset_launches()
    Xn, Rn, G = fused.xr_update_gram(M1, P, X, Z, R)
    Xp, Rp, _ = fused.xr_update_gram_plain(M1, P, X, Z, R)
    assert Xn.dtype == Rn.dtype == torch.bfloat16 and G.dtype == torch.float32
    # The Gram is of the stored Rn (see the rows 5-9 test above).
    assert _ulps(Xn, Xp) <= 1 and _ulps(Rn, Rp) <= 1
    assert _relfro(G, fused.gram_plain(Rn, Rn)) < 1e-5
    Q, Pn = fused.qr_p_update(M1, P, M2, X)
    Qp, Pp = fused.qr_p_update_plain(M1, P, M2, X)
    assert _ulps(Q, Qp) <= 1 and _ulps(Pn, Pp) <= 1
    got = fused.qr_px_update(M1, P, M2, X, M3, Z)
    for g, w in zip(got, fused.qr_px_update_plain(M1, P, M2, X, M3, Z)):
        assert g.dtype == torch.bfloat16 and _ulps(g, w) <= 1
    torch.cuda.synchronize()
    for w in ("xr_update_gram", "qr_p_update", "qr_px_update"):
        assert _native.launches[f"{w}[bf16]"] >= 1 and _native.launches[w] == 0


def test_xr_qr_bf16_donated_match_fresh(dev):
    """In place (the solvers donate) gives the fresh call's bits, and a
    repeat gives the same bits."""
    k, n = 48, 3000
    (M1, M2, M3), (P, X, Z, R) = _xr_qr_bf16(k, n, 320, dev)
    want = fused.xr_update_gram(M1, P, X, Z, R)
    Xd, Rd = X.clone(), R.clone()
    got = fused.xr_update_gram(M1, P, Xd, Z, Rd, donate=True)
    assert got[0].data_ptr() == Xd.data_ptr() and got[1].data_ptr() == Rd.data_ptr()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(torch.equal(g, w) for g, w in zip(fused.xr_update_gram(M1, P, X, Z, R), want))
    want = fused.qr_p_update(M1, P, M2, X)
    Pd, Xd = P.clone(), X.clone()
    got = fused.qr_p_update(M1, Pd, M2, Xd, donate=True)
    assert got[0].data_ptr() == Pd.data_ptr() and got[1].data_ptr() == Xd.data_ptr()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    want = fused.qr_px_update(M1, P, M2, X, M3, Z)
    args = [P.clone(), X.clone(), Z.clone()]
    got = fused.qr_px_update(M1, args[0], M2, args[1], M3, args[2], donate=True)
    assert [g.data_ptr() for g in got] == [a.data_ptr() for a in args]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_qr_bf16_rounds_q_after_pn(dev):
    """Pn adds rho P to the unrounded f32 Q, and Q and Pn are each rounded
    once: with rho = 0 the stored Pn is the stored Q, and with rho P the
    kernel's Pn disagrees with the plain version far less often than with
    bf16(bf16(Q) + rho P), the order that rounds Q first."""
    k, n = 16, 4096
    (M1, M2, _), (P, X, _, _) = _xr_qr_bf16(k, n, 330, dev)
    zero = torch.zeros_like(M1)
    for Q, Pn in (fused.qr_p_update(M1, P, zero, X),
                  fused.qr_px_update(M1, P, zero, X, zero, X)[:2]):
        assert torch.equal(Q, Pn)
    Qp, Pp = fused.qr_p_update_plain(M1, P, M2, X)
    q_first = (Qp.float() + fused.mm_update_plain(M2, X).float()).bfloat16()
    for Q, Pn in (fused.qr_p_update(M1, P, M2, X), fused.qr_px_update(M1, P, M2, X, M1, X)[:2]):
        assert _ulps(Pn, Pp) <= 1
        assert int((Pn != q_first).sum()) > 2 * int((Pn != Pp).sum())


@pytest.mark.parametrize("k", [1, 12])
def test_const_hop_bf16_runs_plain_on_card(dev, k):
    """The dtype rule of the const-hop wrappers: bf16 operands on the card run
    the plain version (the reference's gate takes float32 alone), with no
    launch; an f32 field beside bf16 hops raises."""
    op = dirac_cbdia(8, dtype=torch.bfloat16, device=dev)
    Xm = _bf_field(op.bs * k, op.ns, 340 + k, dev)
    _native.reset_launches()
    Ym = cbs.const_block_stencil_spmm_m_t(op.hops_main, op.main_offsets, op.main_slots,
                                          op.masks_main, Xm)
    Ym2, Gm = cbs.const_block_stencil_spmm_m_gram_t(op.hops_main, op.main_offsets,
                                                    op.main_slots, op.masks_main, Xm)
    Yp, Gp = cbs.const_block_stencil_plain(op.hops_main, op.main_offsets, op.main_slots,
                                           op.masks_main, Xm, True)
    assert Ym.dtype == torch.bfloat16 and torch.equal(Ym, Yp) and torch.equal(Ym2, Yp)
    assert torch.equal(Gm, Gp)
    Yv = op.matmat_t(op.from_internal(Xm))
    assert torch.equal(op.to_internal(Yv), op._matmat_m_plain(Xm))
    assert op.matmat_gram_t(Xm)[1] is None  # the solvers take the Gram from gram[bf16]
    assert sum(_native.launches.values()) == 0
    with pytest.raises(TypeError):
        cbs.const_block_stencil_spmm_m_t(op.hops_main, op.main_offsets, op.main_slots,
                                         op.masks_main, Xm.float())


# ------------------- mixed-dtype stencil, bf16 block storage, folded wraps
# The mixed pairs and bf16 blocks are lifted to f32 exactly and summed in
# the f32 kernels' order: on values exact in both types they give the f32
# kernel's bits. A folded wrap term is added where its bulk partner's was:
# against the unfolded kernel to 1e-5.


@pytest.mark.parametrize("n,k,offsets", [
    (1000, 4, (-130, -7, -1, 0, 2, 64, 257)),      # n % 8 == 0, populated wraps
    (4096, 32, (-256, -16, -1, 0, 1, 16, 256)),
    (777, 40, (0, 700, -700, 3)),                   # ragged n: element copies
    (300, 64, (-1, 0, 1, 600)),                     # |o| >= n reduces mod n
    # the bf16 field's tensor-core Gram: width 16, ragged n; width 64 with
    # windows across 0 and n on every tile
    (4099, 12, (-5, -1, 0, 1, 3)),
    (2048, 64, (0, 1, -1, 2047, 1, 2041)),
])
@pytest.mark.parametrize("pair", ["bf16 coeffs", "bf16 field"])
def test_mixed_stencil_pairs_match_plain(dev, pair, n, k, offsets):
    """Each mixed pair against its plain version, with and without the Gram
    (a bf16 Y within one ulp, f32 Y and the Gram to 1e-5), and bitwise the
    unmixed kernel on values exact in both types (diagonals of small
    integers); each counts under its own name."""
    rng = np.random.default_rng(3)
    d32 = _t(rng.integers(-3, 4, (len(offsets), n)), dev)
    X32 = _bf_field(k, n, 4, dev).float()  # exact in bf16
    d, X = (d32.bfloat16(), X32) if pair == "bf16 coeffs" else (d32, X32.bfloat16())
    _native.reset_launches()
    Y, G = stencil.stencil_spmm_gram_t(d, offsets, X)
    Y1 = stencil.stencil_spmm_t(d, offsets, X)
    Yp, Gp = stencil.stencil_spmm_plain(d, offsets, X, with_gram=True)
    ref = (stencil.stencil_spmm_gram_t(d32, offsets, X32) if pair == "bf16 coeffs" else
           stencil.stencil_spmm_gram_t(d32.bfloat16(), offsets, X))
    torch.cuda.synchronize()
    chunks = len(_native.row_chunks(k))
    assert _native.launches[f"stencil_spmm_t[{pair}]"] == chunks
    # an f32 field's Gram runs the chunks of stencil.launch_plans
    assert _native.launches[f"stencil_spmm_gram_t[{pair}]"] == len(
        stencil.launch_plans(d, offsets, X, True))
    assert Y.dtype == X.dtype and torch.equal(Y, Y1)
    if X.dtype == torch.bfloat16:
        assert _ulps(Y, Yp) <= 1.0
    else:
        assert _relmax(Y, Yp) < 1e-5
    assert _relfro(G, Gp) < 1e-5
    assert torch.equal(Y, ref[0]) and (chunks > 1 or torch.equal(G, ref[1]))


@pytest.mark.parametrize("k", [65, 72, 96, 130])
@pytest.mark.parametrize("pair", ["bf16", "bf16 field"])
def test_bf16_wide_gram_matches_plain(dev, pair, k):
    """A bf16 field's Gram above one launch's 64 rows, on the f32 sums: each
    launch (counted as ``[..., wide]``) takes a column block of G from the
    sums it has just computed (``stencil.wide_gram_launches``); G within
    1e-5 of the plain version's, nearer the f64 Gram of X and the sums than
    that of the stored Y."""
    op = laplacian_dia((16, 16, 16), device=dev)
    d = op.diags.bfloat16() if pair == "bf16" else op.diags
    X = _bf_field(k, op.n, 5, dev)
    _native.reset_launches()
    Y, G = stencil.stencil_spmm_gram_t(d, op.offsets, X)
    Yp, Gp = stencil.stencil_spmm_plain(d, op.offsets, X, with_gram=True)
    torch.cuda.synchronize()
    assert (_native.launches[f"stencil_spmm_gram_t[{pair}, wide]"]
            == len(stencil.wide_gram_launches(k)))
    assert _ulps(Y, Yp) <= 1.0 and _relfro(G, Gp) < 1e-5
    S = stencil.stencil_spmm_t(op.diags.float(), op.offsets, X.float())
    G64 = X.double() @ S.double().T
    Gy = X.double() @ Y.double().T
    assert _relfro(G.double(), G64) < _relfro(Gy, G64)


def test_cheb_step_bf16_runs_plain(dev):
    """All-bf16 ``cheb_step`` runs its plain version on the card (the
    reference sends every dtype but f32 to XLA); nothing launches."""
    R, Z, D, AZ = (_bf_field(4, 1000, s, dev) for s in (80, 81, 82, 83))
    _native.reset_launches()
    Zn, Dn = fused.cheb_step(R, Z, D, AZ, 0.5, 0.25)
    Zp, Dp = fused.cheb_step_plain(R, Z, D, AZ, 0.5, 0.25)
    torch.cuda.synchronize()
    assert sum(_native.launches.values()) == 0
    assert Zn.dtype == torch.bfloat16 and torch.equal(Zn, Zp) and torch.equal(Dn, Dp)


@pytest.mark.parametrize("ns", [300, 1000, 40_000])
@pytest.mark.parametrize("bs,k", [(4, 12), (3, 5), (8, 6), (4, 30)])
def test_block_stencil_bf16_blocks_match_plain(dev, bs, k, ns):
    """bf16 blocks with an f32 field (16-byte copies at ns % 8 == 0, 4-byte
    at 300): merged with and without the Gram and the (k, bs, ns) view
    against the plain versions, and bitwise the f32 kernel on the lifted
    blocks; an odd ns raises."""
    blocks, offsets, Xm = _bs_redesign_operands(ns, bs, k, dev, 900)
    b16 = blocks.bfloat16()
    lifted = b16.float()
    Xv = _field(k, bs * ns, 901, dev).reshape(k, bs, ns)
    _native.reset_launches()
    Y = bsk.block_stencil_spmm_m_t(b16, offsets, Xm)
    Yg, G = bsk.block_stencil_spmm_m_gram_t(b16, offsets, Xm)
    Yv = bsk.block_stencil_spmm_t(b16, offsets, Xv)
    Yp, Gp = bsk.block_stencil_plain(b16, offsets, Xm, True)
    Yvp = bsk.block_stencil_v_plain(b16, offsets, Xv)
    torch.cuda.synchronize()
    assert _native.launches["block_stencil_spmm_m_t[bf16 coeffs]"] >= 1
    assert _native.launches["block_stencil_spmm_t[bf16 coeffs]"] >= 1
    assert _relmax(Y, Yp) < 1e-5 and _relmax(Yv, Yvp) < 1e-5 and _relfro(G, Gp) < 1e-5
    assert torch.equal(Y, Yg)
    assert torch.equal(Y, bsk.block_stencil_spmm_m_t(lifted, offsets, Xm))
    assert torch.equal(Yv, bsk.block_stencil_spmm_t(lifted, offsets, Xv))
    odd = torch.zeros((1, bs, bs, 301), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="even number of sites"):
        bsk.block_stencil_spmm_m_t(odd, (0,), _field(bs * k, 301, 902, dev))
    with pytest.raises(TypeError):  # a bf16 field: the operator's plain route, not a kernel
        bsk.block_stencil_spmm_m_t(blocks, offsets, Xm.bfloat16())


def _folded_ops(dev):
    import os

    os.environ["BLOCKCG_FOLD"] = "1"
    try:
        ops = [("dirac_gauged_matrix(8)", dirac_gauged_matrix(8, device=dev)),
               ("dirac_bdia(8)", dirac_bdia(8, device=dev))]
        eo = _dirac_gauged_matrix_eo(8, device=dev)
        ops += [("dirac_gauged_matrix_eo(8) hop", eo.hop_eo)]
    finally:
        os.environ.pop("BLOCKCG_FOLD", None)
    return ops


def _dirac_gauged_matrix_eo(L, device):
    from blockcg_tpu_torch.problems import dirac_gauged_matrix_eo

    return dirac_gauged_matrix_eo(L, device=device)


@pytest.mark.parametrize("k", [1, 3, 12, 30])
def test_block_stencil_folded_matches_plain(dev, k):
    """Folded wraps (x-axis pairs of st = 1 copied a site at a time, the
    others 16 bytes at a time) with and without the Gram, f32 and bf16
    folded blocks, against the folded plain version and the unfolded kernel;
    the bf16 folded kernel bitwise the f32 one on the lift."""
    for label, op in _folded_ops(dev):
        assert op.fold, label
        fb, foffs, fold = op.blocks_folded, op.fold_offsets, op.fold
        Xm = _field(op.bs * k, op.ns, 903, dev)
        _native.reset_launches()
        Y = bsk.block_stencil_spmm_m_t(fb, foffs, Xm, fold)
        Yg, G = bsk.block_stencil_spmm_m_gram_t(fb, foffs, Xm, fold)
        Yp, Gp = bsk.block_stencil_plain(fb, foffs, Xm, True, fold)
        Yu = bsk.block_stencil_spmm_m_t(op.blocks, op.offsets, Xm)
        f16 = fb.bfloat16()
        Yh = bsk.block_stencil_spmm_m_t(f16, foffs, Xm, fold)
        Yhl = bsk.block_stencil_spmm_m_t(f16.float(), foffs, Xm, fold)
        torch.cuda.synchronize()
        assert _native.launches["block_stencil_spmm_m_t[fold]"] >= 2, label
        assert _native.launches["block_stencil_spmm_m_t[fold, bf16 coeffs]"] >= 1, label
        assert _relmax(Y, Yp) < 1e-5 and _relmax(Y, Yu) < 1e-5, label
        assert _relfro(G, Gp) < 1e-5 and torch.equal(Y, Yg), label
        assert torch.equal(Yh, Yhl), label


def test_bdia_operator_dtype_routes_on_card(dev, monkeypatch):
    """The operator's one dtype decision on the card: a bf16 field takes the
    plain route with no launch; bf16 blocks with f32 fields launch the
    ``[bf16 coeffs]`` kernels and fuse no Gram; under ``BLOCKCG_FOLD`` a
    folded operator launches the folded kernels."""
    from blockcg_tpu_torch.operators import astype

    monkeypatch.setenv("BLOCKCG_FOLD", "1")
    op = dirac_gauged_matrix(8, device=dev)
    Xm = _field(op.bs * 3, op.ns, 904, dev)
    _native.reset_launches()
    Y16 = op.matmat_t(Xm.bfloat16())
    assert sum(_native.launches.values()) == 0
    assert torch.equal(Y16, op._matmat_m_plain(Xm.bfloat16()))
    op16 = astype(op, torch.bfloat16)
    monkeypatch.delenv("BLOCKCG_FOLD")
    Y, G = op16.matmat_gram_t(Xm)
    assert G is None and _native.launches["block_stencil_spmm_m_t[bf16 coeffs]"] == 1
    monkeypatch.setenv("BLOCKCG_FOLD", "1")
    Yf, Gf = op.matmat_gram_t(Xm)
    Yu, Gu = bsk.block_stencil_spmm_m_gram_t(op.blocks, op.offsets, Xm)
    torch.cuda.synchronize()
    assert _native.launches["block_stencil_spmm_m_gram_t[fold]"] == 1
    assert _relmax(Yf, Yu) < 1e-5 and _relfro(Gf, op.gram_contract(Gu)) < 1e-5


def test_tiled_operator_bf16_field_runs_plain(dev):
    """A bf16 X on ``TiledOperator`` takes the plain route on the card (the
    reference's kernel gate takes f32 X alone); the wrapper itself still
    raises on it."""
    from blockcg_tpu_torch.operators import TiledOperator

    a = laplacian_scipy((24, 24))
    op = TiledOperator.from_scipy(a, device=dev)
    X = _bf_field(5, op.n, 905, dev)
    _native.reset_launches()
    Y = op.matmat_t(X)
    torch.cuda.synchronize()
    assert sum(_native.launches.values()) == 0 and Y.dtype == torch.bfloat16
    assert torch.equal(Y, spmm_tiled.tiled_spmm_plain(op.tiles, op.rt, op.ct, X))


# ------------- bf16 row 9 on the tensor cores, row 2w in column blocks


@pytest.mark.parametrize("k", [16, 32, 48, 64])
def test_px_update_mma_matches_plain(dev, k):
    """Row 9b (``px_update[bf16]`` up to 64 rows, on the tensor cores): Pn
    and Xn within one bf16 ulp of the plain version on fields whose width is
    no multiple of the tile (5,000 columns by TMA, the last tile ragged;
    4,099 by element copies), one launch a call; donated P and X take the
    fresh call's bits in place."""
    rng = np.random.default_rng(400 + k)
    M1, M2, M3 = (_t(rng.standard_normal((k, k)) / np.sqrt(k), dev) for _ in range(3))
    for n in (5000, 4099):
        assert n % 512 != 0
        W, P, X = (_bf_field(k, n, s, dev) for s in (401, 402, 403))
        _native.reset_launches()
        Pn, Xn = fused.px_update(M1, W, M2, P, M3, X)
        Pp, Xp = fused.px_update_plain(M1, W, M2, P, M3, X)
        assert Pn.dtype == Xn.dtype == torch.bfloat16
        assert _ulps(Pn, Pp) <= 1 and _ulps(Xn, Xp) <= 1
        assert _native.launches["px_update[bf16]"] == 1 and _native.launches["px_update"] == 0
        Pd, Xd = P.clone(), X.clone()
        got = fused.px_update(M1, W, M2, Pd, M3, Xd, donate=True)
        assert got[0].data_ptr() == Pd.data_ptr() and got[1].data_ptr() == Xd.data_ptr()
        assert torch.equal(got[0], Pn) and torch.equal(got[1], Xn)
        assert torch.equal(fused.px_update(M1, W, M2, P, M3, X)[0], Pn)


def _sha32(t):
    import hashlib

    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


# sha256 (16 hex digits) of the bits of the outputs of the kernels that stay
# on their schedules (the f32 px_update, row 9, at 32 and 96 rows; bf16
# qr_p_update, row 12b), as they were before bf16 px_update moved to the
# tensor cores (H100), on the inputs test_px_schedule_rows_keep_their_bits
# makes; and of qr_px_update's Q, Pn and Xn (row 13 in f32, 13b above 64
# rows) as the one-thread-a-column kernel (csrc/qr_p_update.cu, before
# px_update.cu's QR-with-X mode replaced it) gave them on an H100.
_UPDATE_PINS = {
    "px_update f32 (32, 40000)": ["e8a968f765721032", "7de7231c757117a3"],
    "px_update f32 (96, 8192)": ["17d98e5ad1c77ffd", "6dcf8a0514fa403d"],
    "qr_p_update[bf16] (48, 40000)": ["e81d35effb7d0883", "7fe86ef2e1d2c783"],
    "qr_px_update f32 (32, 40000)": ["324de7211cc8e781", "e8a968f765721032", "7de7231c757117a3"],
    "qr_px_update f32 (96, 8192)": ["afea4bfe4fb06867", "17d98e5ad1c77ffd", "6dcf8a0514fa403d"],
    "qr_px_update[bf16] (96, 8192)": ["f9d7e066cc1c5e54", "280e2ac4048452ab", "b3ffa023626b9b96"],
}


def _update_pin_sums(case, dev):
    """The checksums ``_UPDATE_PINS`` holds for ``case``, of this checkout's
    kernels, on the case's inputs from a numpy seed."""
    name, shape = case.split(" (")
    k, n = (int(v) for v in shape.rstrip(")").split(", "))
    rng = np.random.default_rng(700 + k)
    M1, M2, M3 = (_t(rng.standard_normal((k, k)) / np.sqrt(k), dev) for _ in range(3))
    W, P, X = (rng.standard_normal((k, n)) for _ in range(3))
    if name == "px_update f32":
        got = fused.px_update(M1, _t(W, dev), M2, _t(P, dev), M3, _t(X, dev))
    elif name == "qr_p_update[bf16]":
        got = fused.qr_p_update(M1, _bf(W, dev), M2, _bf(P, dev))
    else:
        field = _bf if name.endswith("[bf16]") else _t
        got = fused.qr_px_update(M1, field(W, dev), M2, field(P, dev), M3, field(X, dev))
    return [_sha16(t) if t.dtype == torch.bfloat16 else _sha32(t) for t in got]


@pytest.mark.parametrize("case", list(_UPDATE_PINS))
def test_px_schedule_rows_keep_their_bits(dev, case):
    """The f32 row 9, the bf16 QR mode of ``px_update.cu`` (row 12b) and
    ``qr_px_update`` on its streaming QR-with-X mode (row 13 in f32, 13b at
    96 rows) keep their bits (pinned checksums of the kernels before row
    9b's redesign, and before row 13 moved off ``qr_p_update.cu``)."""
    assert _update_pin_sums(case, dev) == _UPDATE_PINS[case]


@pytest.mark.parametrize("k", [16, 32, 48, 64, 96])
def test_qr_px_update_bf16_matches_plain(dev, k):
    """Row 13b: up to 64 rows one ``bcg_qr_px_update_mma`` launch (tensor
    cores, Q stored from its fragments, Pn from the unrounded f32 Q), at 96 one
    ``bcg_qr_px_update_bf16`` launch (the streaming QR-with-X mode): Q, Pn
    and Xn within one bf16 ulp of the plain version (the tolerance row 9b
    is held to) on 5,000 columns (TMA, the last tile ragged) and 4,099
    (element copies); donated Q1, P and X take the fresh call's bits in
    place; a repeat gives the same bits."""
    rng = np.random.default_rng(2500 + k)
    M2, rho, C = (_t(rng.standard_normal((k, k)) / np.sqrt(k), dev) for _ in range(3))
    fn = "bcg_qr_px_update_mma" if k <= 64 else "bcg_qr_px_update_bf16"
    for n in (5000, 4099):
        Q1, P, X = (_bf_field(k, n, s, dev) for s in (2501, 2502, 2503))
        _native.reset_launches()
        got = fused.qr_px_update(M2, Q1, rho, P, C, X)
        torch.cuda.synchronize()
        assert dict(_native.functions) == {fn: 1}
        for g, w in zip(got, fused.qr_px_update_plain(M2, Q1, rho, P, C, X)):
            assert g.dtype == torch.bfloat16 and _ulps(g, w) <= 1
        args = [Q1.clone(), P.clone(), X.clone()]
        don = fused.qr_px_update(M2, args[0], rho, args[1], C, args[2], donate=True)
        assert [d.data_ptr() for d in don] == [a.data_ptr() for a in args]
        assert all(torch.equal(d, g) for d, g in zip(don, got))
        assert all(torch.equal(r, g) for r, g in zip(fused.qr_px_update(M2, Q1, rho, P, C, X),
                                                    got))


# Row 2w before its column blocks (sums to an f32 scratch, X lifted to f32,
# cross blocks from gram.cu; H100), on the X that
# test_bf16_wide_gram_columns_keep_y_and_near_the_contract makes: the sha256
# (16 hex digits) of the bits of Y on the 32^3 Laplacian, and G's relative
# Frobenius distance from the f64 Gram of X and the f32 sums on the 128^3
# one, the [storage] solve's field. (On fields of a few tiles a block the
# old route's f32 chains are short, and its Gram nearer the contract than
# the column blocks': tools/torch_kernel_times.py --bf16 prints both.)
_WIDE_PINS = {
    ("bf16", 96): ("5515a3f48d850e21", 4.562215619815542e-08),
    ("bf16 field", 96): ("5515a3f48d850e21", 4.562215619815542e-08),
    ("bf16", 128): ("be2865c89c775b2a", 4.021463128049386e-08),
    ("bf16 field", 128): ("be2865c89c775b2a", 4.021463128049386e-08),
}


@pytest.mark.parametrize("pair,k", list(_WIDE_PINS), ids=str)
def test_bf16_wide_gram_columns_keep_y_and_near_the_contract(dev, pair, k):
    """Row 2w in column blocks (``stencil_mma_cols``), on both bf16-field
    pairs at k = 96 and 128: one launch per block of
    ``stencil.wide_gram_launches``; Y bitwise the route's before it (pinned
    checksums) and the SpMM's; on the 128^3 Laplacian G at or nearer the
    f64 Gram of X and the f32 sums, its contract, than the route before."""
    pin, before = _WIDE_PINS[(pair, k)]
    for edge in (32, 128):
        op = laplacian_dia((edge,) * 3, device=dev)
        d = op.diags.bfloat16() if pair == "bf16" else op.diags
        X = _bf(np.random.default_rng(600 + k).standard_normal((k, op.n)), dev)
        _native.reset_launches()
        Y, G = stencil.stencil_spmm_gram_t(d, op.offsets, X)
        assert (_native.launches[f"stencil_spmm_gram_t[{pair}, wide]"]
                == len(stencil.wide_gram_launches(k)) == 2)
        assert torch.equal(Y, stencil.stencil_spmm_t(d, op.offsets, X))
        if edge == 32:
            assert _sha16(Y) == pin
            continue
        S = stencil.stencil_spmm_t(op.diags.float(), op.offsets, X.float())
        G64 = X.double() @ S.double().T
        assert _relfro(G.double(), G64) <= before


# ---- row 10 (xr_update_gram, f32 and bf16) on the streaming schedule

# sha256 (16 hex digits) of the bits of Xn and Rn of xr_update_gram at config
# 2's (16, 512^2), as the one-thread-a-column kernel gave them before the
# streaming schedule (H100), on the inputs that
# tools/torch_kernel_times.py --short makes for rows 10 and 10b.
_XR_PINS = {
    "f32": ["a000af05f20e4cef", "5295d8b111a29bb8"],
    "bf16": ["798b5c53b283e4a3", "b090e818c1b8fe79"],
}


def _short_xr_inputs(dev):
    """Rows 10 and 10b's inputs of ``tools/torch_kernel_times.py --short``:
    alpha (16, 16) and P, X, Z, R (16, 512^2) from one CUDA generator seeded
    0, f32 first, then bf16."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for what, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        alpha = torch.randn((16, 16), generator=gen, device=dev) / 16 ** 0.5
        out[what] = alpha, [torch.randn((16, 512 ** 2), generator=gen, device=dev).to(dt)
                            for _ in range(4)]
    return out


@pytest.mark.parametrize("what", list(_XR_PINS))
def test_xr_update_gram_keeps_its_bits(dev, what):
    """Row 10 (10b) on the streaming schedule at config 2's width: Xn and Rn
    bitwise what the kernel before it gave (pinned checksums), G within
    1e-5 (relative Frobenius) of the plain version's and exactly symmetric;
    donated gives the fresh call's bits."""
    alpha, F = _short_xr_inputs(dev)[what]
    _native.reset_launches()
    Xn, Rn, G = fused.xr_update_gram(alpha, *F)
    assert _native.launches[_native.variant("xr_update_gram", "", F[0].dtype)[0]] == 1
    sha = _sha16 if what == "bf16" else _sha32
    assert [sha(Xn), sha(Rn)] == _XR_PINS[what]
    assert _relfro(G, fused.xr_update_gram_plain(alpha, *F)[2]) < 1e-5
    assert torch.equal(G, G.T)
    X, R = F[1].clone(), F[3].clone()
    got = fused.xr_update_gram(alpha, F[0], X, F[2], R, donate=True)
    assert got[0].data_ptr() == X.data_ptr() and got[1].data_ptr() == R.data_ptr()
    assert all(torch.equal(g, w) for g, w in zip(got, (Xn, Rn, G)))


def _placed(a, dt, offset, dev):
    """The numpy field a as a contiguous (k, n) tensor of dtype dt that
    starts ``offset`` elements into its storage (1: not 16-byte aligned)."""
    k, n = a.shape
    buf = torch.empty(k * n + offset, dtype=dt, device=dev)
    f = buf[offset:].view(k, n)
    f.copy_(torch.as_tensor(a, dtype=torch.float32, device=dev))
    return f


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k,n,offset", [
    (8, 4096, 0), (16, 3001, 0), (16, 4096, 1), (48, 8192, 0), (48, 2051, 0), (64, 5000, 0),
    (64, 1000, 1), (96, 2048, 0), (128, 1024, 0)])
def test_xr_update_gram_streaming_schedule(dev, dt, k, n, offset):
    """Row 10 (10b) at 8, 16, 48 and 64 rows (one launch with its Gram), on
    ragged n and one-element offset fields (element copies and scalar loads
    and stores on the same schedule), and at 96 and 128 rows (row chunks,
    ``wide_gram``'s cross blocks): Xn and Rn within 1e-5 (f32) or one bf16
    ulp of the plain version, G within 1e-5 of the Gram of the stored Rn
    and exactly symmetric; a repeat, and a donated call on fields placed
    alike, give the same bits."""
    rng = np.random.default_rng(900 + k + offset)
    alpha = _t(rng.standard_normal((k, k)) / np.sqrt(k), dev)
    arrays = [rng.standard_normal((k, n)) for _ in range(4)]
    P, X, Z, R = (_placed(a, dt, offset, dev) for a in arrays)
    plan = fused.xr_update_gram_plan(k, P.device, P.element_size())
    name = _native.variant("xr_update_gram", "", dt)[0]
    _native.reset_launches()
    Xn, Rn, G = fused.xr_update_gram(alpha, P, X, Z, R)
    assert _native.launches[name] == len(plan.chunks) == (1 if k <= 64 else 2)
    Xp, Rp, _ = fused.xr_update_gram_plain(alpha, P, X, Z, R)
    if dt == torch.float32:
        assert _relmax(Xn, Xp) < 1e-5 and _relmax(Rn, Rp) < 1e-5
    else:
        assert _ulps(Xn, Xp) <= 1 and _ulps(Rn, Rp) <= 1
    assert _relfro(G, fused.gram_plain(Rn, Rn)) < 1e-5 and torch.equal(G, G.T)
    assert all(torch.equal(g, w) for g, w in zip(fused.xr_update_gram(alpha, P, X, Z, R),
                                                  (Xn, Rn, G)))
    Xd, Rd = _placed(arrays[1], dt, offset, dev), _placed(arrays[3], dt, offset, dev)
    got = fused.xr_update_gram(alpha, P, Xd, Z, Rd, donate=True)
    assert got[0].data_ptr() == Xd.data_ptr() and got[1].data_ptr() == Rd.data_ptr()
    assert all(torch.equal(g, w) for g, w in zip(got, (Xn, Rn, G)))


# ---- rows 2 and 2m (an f32 field with its Gram) on the tensor cores, and
# rows 23h and 24h (bf16 blocks on the merged view) on TMA tensor boxes

_F32_MMA_CASES = {
    # name: (n, offsets); random coefficients on every diagonal, wraps populated
    "ragged": (4099, (-5, -1, 0, 1, 3, 1030, -2049)),          # n % 4 != 0: element copies
    "wrap_both_ends": (4096, (4095, 1, -4, 4092, 2048, 1024)),  # windows cross 0 and n
    # far offsets that are not multiples of 4 (element reads), three far
    # diagonals (the third read at its use)
    "misaligned_far": (8192, (0, 1, -1, 1027, -3001, 4098)),
    "laplacian_16": (16 ** 3, (0, 1, -1, 16, -16, 256, -256)),
}


@pytest.mark.parametrize("dd", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 8, 12, 32, 48, 64, 96])
@pytest.mark.parametrize("case", sorted(_F32_MMA_CASES))
def test_stencil_f32_gram_on_tensor_cores_matches_plain(dev, case, k, dd):
    """``stencil_spmm_gram_t`` on an f32 field with f32 or bf16 diagonals
    (one launch per chunk of ``launch_plans``: ``stencil_mma_f32`` up to 32
    rows, ``stencil_vec_gram`` from 33 to 64 where ``vec_gram_takes``,
    chunks of at most 64 rows above with the cross blocks of G from
    ``gram``): ragged n,
    windows across 0 and n, far offsets that
    are not multiples of 4, more far diagonals than are loaded a step ahead.
    Y within 1e-5 of the plain version and bitwise the SpMM's (the fmaf
    chain it keeps); G within 1e-5 of the plain version and of the f64 Gram
    of X and the f32 sums; a repeat bitwise."""
    n, offsets = _F32_MMA_CASES[case]
    rng = np.random.default_rng(40 + k)
    d = _t(rng.standard_normal((len(offsets), n)), dev)
    d = d.bfloat16() if dd == "bf16" else d
    X = _field(k, n, 41 + k, dev)
    plan = stencil.stencil_mma_f32_plan(offsets, n, min(k, 32), _native.max_smem(dev.index or 0),
                                        _native.sm_count(dev.index or 0), d.element_size())
    assert plan.blocks_per_sm == 1
    name = "stencil_spmm_gram_t" + ("[bf16 coeffs]" if dd == "bf16" else "")
    _native.reset_launches()
    Y, G = stencil.stencil_spmm_gram_t(d, offsets, X)
    plans = stencil.launch_plans(d, offsets, X, True)
    assert _native.launches[name] == len(plans) == len(_native.row_chunks(k))
    assert _native.functions["bcg_stencil_vec_gram" + ("_bf16d" if dd == "bf16" else "")] == sum(
        stencil.vec_gram_takes(r1 - r0) for (r0, r1), _ in plans)
    Yp, Gp = stencil.stencil_spmm_plain(d, offsets, X, with_gram=True)
    torch.cuda.synchronize()
    assert _relmax(Y, Yp) < 1e-5 and _relfro(G, Gp) < 1e-5
    assert torch.equal(Y, stencil.stencil_spmm_t(d, offsets, X))
    assert _relfro(G.double(), X.double() @ Y.double().T) < 1e-5
    Y2, G2 = stencil.stencil_spmm_gram_t(d, offsets, X)
    assert torch.equal(Y2, Y) and torch.equal(G2, G)


def test_stencil_f32_gram_unaligned_field(dev):
    """An f32 field one element off 16-byte alignment: the window's 4-byte
    copies, the far diagonals' element reads and Y's element stores on the
    same schedule; Y bitwise the SpMM's, G within 1e-5."""
    k, n = 32, 4096
    rng = np.random.default_rng(47)
    offsets = (-1025, -1, 0, 1, 2, 700)
    d = _t(rng.standard_normal((len(offsets), n)), dev)
    raw = _t(rng.standard_normal(k * n + 1), dev)
    X = raw[1:].view(k, n)
    assert X.data_ptr() % 16 != 0
    Y, G = stencil.stencil_spmm_gram_t(d, offsets, X)
    Yp, Gp = stencil.stencil_spmm_plain(d, offsets, X, with_gram=True)
    assert _relmax(Y, Yp) < 1e-5 and _relfro(G, Gp) < 1e-5
    assert torch.equal(Y, stencil.stencil_spmm_t(d, offsets, X))


# Rows 2 and 2m before their Gram moved to the tensor cores (stencil_spmm<ED,
# float, KMAX, true>: VecGram in f32 FMAs; H100), on the X that
# test_stencil_f32_gram_keeps_y_and_nears_its_contract makes on the 7-point
# Laplacian: the sha256 (16 hex digits) of the bytes of Y, and G's relative
# Frobenius distance from the f64 Gram of X and the f32 sums.
_F32_GRAM_PINS = {
    ("f32", 64): ("8286defddbda8d2a", 2.5496330756127053e-08),
    ("bf16", 64): ("8286defddbda8d2a", 2.5496330756127053e-08),
    ("f32", 128): ("1c03aafad7df1f6f", 2.372139523325416e-08),
    ("bf16", 128): ("1c03aafad7df1f6f", 2.372139523325416e-08),
}


@pytest.mark.parametrize("dd,edge", list(_F32_GRAM_PINS), ids=str)
def test_stencil_f32_gram_keeps_y_and_nears_its_contract(dev, dd, edge):
    """Rows 2 and 2m at k = 32 on the 64^3 and 128^3 (the north star's)
    Laplacians: Y bitwise the kernel's before (pinned checksums), and G no
    farther than twice the kernel before from the f64 Gram of X and the f32
    sums, its contract."""
    pin, before = _F32_GRAM_PINS[(dd, edge)]
    op = laplacian_dia((edge,) * 3, device=dev)
    d = op.diags.bfloat16() if dd == "bf16" else op.diags
    X = _t(np.random.default_rng(620 + edge).standard_normal((32, op.n)), dev)
    Y, G = stencil.stencil_spmm_gram_t(d, op.offsets, X)
    assert _sha32(Y) == pin
    assert _relfro(G.double(), X.double() @ Y.double().T) <= 2 * before


def _bs_tma_operands(ns, bs, k, dev, seed):
    """Per-site blocks on near (0, +-1, 17, -60, 64, wraps ns - 1 and -ns -
    4) and far (450 and ns + 401 off a 16-byte boundary, -412 on one)
    offsets: far beyond any halo either schedule fits, so bs_tma's plan has
    bs_spmm's traffic and takes the boxes (tests/test_torch_redesign.py
    holds the plans)."""
    rng = np.random.default_rng(seed)
    offsets = (0, 1, -1, 17, -60, 64, ns - 1, -ns - 4, 450, -412, ns + 401)
    blocks = _t(rng.standard_normal((len(offsets), bs, bs, ns)), dev)
    return blocks, offsets, _field(bs * k, ns, seed + 1, dev)


@pytest.mark.parametrize("ns", [1000, 4096, 40_000])
@pytest.mark.parametrize("bs,k", [(4, 12), (3, 8), (8, 6), (4, 30), (2, 7)])
def test_block_stencil_tma_boxes_match_plain(dev, bs, k, ns):
    """Merged launches on bf16 blocks without the Gram (``bs_tma``): windows
    and far slabs that cross ns (copied by the producer warp's lanes), far
    offsets that are not multiples of 4, a ragged last tile (40,000 sites),
    chunked launches (k = 30 at bs = 4: two of 15 RHS, tiles of 64 sites), bs
    = 2, 3, 4 and 8. Every launch's plan is the TMA schedule; Y within 1e-5
    of the plain version, bitwise the f32 kernel on the blocks lifted to f32
    (``bs_spmm``), a repeat bitwise."""
    blocks, offsets, Xm = _bs_tma_operands(ns, bs, k, dev, 950)
    b16 = blocks.bfloat16()
    plans = bsk.launch_plans(b16, offsets, k, False, Xm.device, tma=True)
    assert all(plan.tma for _, plan in plans)
    _native.reset_launches()
    Y = bsk.block_stencil_spmm_m_t(b16, offsets, Xm)
    assert _native.launches["block_stencil_spmm_m_t[bf16 coeffs]"] == len(plans)
    Yp = bsk.block_stencil_plain(b16, offsets, Xm)[0]
    torch.cuda.synchronize()
    assert _relmax(Y, Yp) < 1e-5
    assert torch.equal(Y, bsk.block_stencil_spmm_m_t(b16.float(), offsets, Xm))
    assert torch.equal(Y, bsk.block_stencil_spmm_m_t(b16, offsets, Xm))


def test_block_stencil_tma_on_the_matrix_link_8(dev):
    """``dirac_gauged_matrix(8)``'s 15 diagonals in bf16 at k = 12 (m = 48;
    4,096 sites, 32 tiles of 128): every far offset's slab, the crossing ones
    by the producer's lanes; Y bitwise the f32 kernel on the lifted blocks
    and within 1e-5 of the plain version."""
    op = dirac_gauged_matrix(8, device=dev)
    b16 = op.blocks.bfloat16()
    Xm = _field(48, op.blocks.shape[-1], 960, dev)
    plans = bsk.launch_plans(b16, op.offsets, 12, False, Xm.device, tma=True)
    assert len(plans) == 1 and plans[0][1].tma
    Y = bsk.block_stencil_spmm_m_t(b16, op.offsets, Xm)
    assert _relmax(Y, bsk.block_stencil_plain(b16, op.offsets, Xm)[0]) < 1e-5
    assert torch.equal(Y, bsk.block_stencil_spmm_m_t(b16.float(), op.offsets, Xm))


def test_block_stencil_tma_copied_stages_land_before_use(dev):
    """At 1,000 sites (8 tiles of 128, one a block) the first and last
    tiles' windows cross 0 and ns, and on every tile the producer warp's
    lanes copy the far slabs of 450 and ns + 401 (off a 16-byte boundary):
    300 calls, each bitwise the f32 kernel on the lifted blocks. A stage
    posted before its lanes' copies land shows as a wrong bit on some call."""
    blocks, offsets, Xm = _bs_tma_operands(1000, 4, 12, dev, 970)
    b16 = blocks.bfloat16()
    assert all(plan.tma for _, plan in bsk.launch_plans(b16, offsets, 12, False, Xm.device,
                                                        tma=True))
    want = bsk.block_stencil_spmm_m_t(b16.float(), offsets, Xm)
    bad = [i for i in range(300)
           if not torch.equal(bsk.block_stencil_spmm_m_t(b16, offsets, Xm), want)]
    assert bad == []


# -------- the bf16 field's ring of planes; the folded block stencil on bs_tma


def _window_route(monkeypatch):
    """Send the bf16 stencil's launches to the window kernel (the parent's
    route for a bf16 field without the Gram)."""
    monkeypatch.setattr(stencil, "_ring_ok", lambda *a: False)


_RING_CASES = {  # n, offsets: the 64^3 Laplacian; banded of reach 2 with odd and even residues
    "lap_64^3": (64 ** 3, (0, 4096, -4096, 64, -64, 1, -1)),
    "reach_2": (128 * 2048, (0, 2048, -2047, 4094, -4093, 5, -3)),
}


@pytest.mark.parametrize("case", sorted(_RING_CASES))
@pytest.mark.parametrize("k", [8, 16, 32, 64, 96])
@pytest.mark.parametrize("dd", ["bf16", "f32"])
def test_stencil_ring_matches_the_window_kernel(dev, case, k, dd, monkeypatch):
    """A bf16 field without the Gram on the ring (``stencil_ring``): bf16
    or f32 diagonals, 8 to 64 rows a launch and 96 in two chunks, odd and
    even shifts (h + r mod 4 of 0 to 3), a reach of two planes, windows
    across 0 and n. Every launch takes the ring (``_native.functions``); Y
    within one bf16 ulp of the plain version and bitwise the window kernel's
    (the parent route: the same fmaf chain over the diagonals); a repeat
    bitwise."""
    n, offsets = _RING_CASES[case]
    rng = np.random.default_rng(980 + k)
    diags = _t(rng.standard_normal((len(offsets), n)), dev)
    diags = diags.bfloat16() if dd == "bf16" else diags
    Xt = _bf_field(k, n, 981, dev)
    plans = stencil.launch_plans(diags, offsets, Xt, False)
    assert all(isinstance(p, stencil.RingPlan) for _, p in plans)
    fn = "bcg_stencil_ring_bf16" + ("" if dd == "bf16" else "x")
    _native.reset_launches()
    Y = stencil.stencil_spmm_t(diags, offsets, Xt)
    assert _native.functions[fn] == len(plans) == len(_native.row_chunks(k))
    Yp = stencil.stencil_spmm_plain(diags, offsets, Xt)[0]
    assert torch.equal(Y, stencil.stencil_spmm_t(diags, offsets, Xt))
    _window_route(monkeypatch)
    Yw = stencil.stencil_spmm_t(diags, offsets, Xt)
    torch.cuda.synchronize()
    assert _ulps(Y, Yp) <= 1
    assert torch.equal(Y, Yw)


@pytest.mark.parametrize("n,offsets", [
    (1000 * 1024 + 8, (0, 1, -1, 1024, -1024)),   # no stride divides n
    (4096, (-256, -16, -1, 0, 1, 16, 256)),       # planes narrower than a patch
    (64 ** 3, (0, 4096, -4096, 64, -64, 1, -1)),  # an unaligned field
])
def test_stencil_ring_plan_keeps_the_window_kernel(dev, n, offsets):
    """Where no stride fits (or the field is not 16-byte aligned) the plan
    keeps the window kernel (``bcg_stencil_spmm_bf16``), within one bf16 ulp
    of the plain version."""
    diags = _bf(np.random.default_rng(990).standard_normal((len(offsets), n)), dev)
    if n == 64 ** 3:  # one element past an aligned base
        Xt = torch.empty(17 * n + 1, dtype=torch.bfloat16, device=dev)[1:].view(17, n)
        Xt.copy_(_bf_field(17, n, 991, dev))
        assert Xt.data_ptr() % 16 != 0 and Xt.is_contiguous()
    else:
        Xt = _bf_field(17, n, 991, dev)
    plans = stencil.launch_plans(diags, offsets, Xt, False)
    assert not any(isinstance(p, stencil.RingPlan) for _, p in plans)
    _native.reset_launches()
    Y = stencil.stencil_spmm_t(diags, offsets, Xt)
    torch.cuda.synchronize()
    assert _native.functions == {"bcg_stencil_spmm_bf16": 1}
    assert _ulps(Y, stencil.stencil_spmm_plain(diags, offsets, Xt)[0]) <= 1


def test_stencil_ring_repeats_its_bits(dev, monkeypatch):
    """300 calls of the 64^3 Laplacian's ring at k = 32 (items of four
    planes, so each block restarts its ring about every six steps; the
    first and last patches' windows copied by the producer's lanes), each
    bitwise the window kernel's: a stage posted before its copies land, or
    a slot refilled while a step still reads it, shows as a wrong bit on
    some call."""
    op = laplacian_dia((64, 64, 64), dtype=torch.bfloat16, device=dev)
    Xt = _bf_field(32, op.n, 992, dev)
    plan = stencil.launch_plans(op.diags, op.offsets, Xt, False)[0][1]
    assert isinstance(plan, stencil.RingPlan) and plan.len == 4
    _window_route(monkeypatch)
    want = stencil.stencil_spmm_t(op.diags, op.offsets, Xt)
    monkeypatch.undo()
    bad = [i for i in range(300)
           if not torch.equal(stencil.stencil_spmm_t(op.diags, op.offsets, Xt), want)]
    assert bad == []


# ---------------------------------- an f32 field on the ring (rows 1m and 1)


@pytest.mark.parametrize("case", sorted(_RING_CASES))
@pytest.mark.parametrize("k", [4, 8, 32, 64, 96])
@pytest.mark.parametrize("dd", ["bf16", "f32"])
def test_stencil_ring_f32_field_matches_the_window_kernel(dev, case, k, dd, monkeypatch):
    """An f32 field without the Gram on the ring (``stencil_ring`` with f32
    slots, 4 or 8 rows a work item): bf16 diagonals (row 1m) or f32 ones
    (row 1), 4 to 64 rows a launch and 96 in two chunks, odd and even shifts,
    a reach of two planes, windows across 0 and n. Every launch takes the
    ring its plan gives (``_native.functions``); Y within ``FIELD_RTOL`` of
    the plain version and bitwise the window kernel's (the parent route: the
    same fmaf chain over the diagonals); a repeat bitwise."""
    n, offsets = _RING_CASES[case]
    rng = np.random.default_rng(2600 + k)
    diags = _t(rng.standard_normal((len(offsets), n)), dev)
    diags = diags.bfloat16() if dd == "bf16" else diags
    Xt = _field(k, n, 2601, dev)
    plans = stencil.launch_plans(diags, offsets, Xt, False)
    assert all(isinstance(p, stencil.RingPlan) and p.rows in (4, 8) for _, p in plans)
    fn = "bcg_stencil_ring" + ("_bf16d" if dd == "bf16" else "")
    _native.reset_launches()
    Y = stencil.stencil_spmm_t(diags, offsets, Xt)
    assert _native.functions[fn] == len(plans) == len(_native.row_chunks(k))
    assert torch.equal(Y, stencil.stencil_spmm_t(diags, offsets, Xt))
    _window_route(monkeypatch)
    Yw = stencil.stencil_spmm_t(diags, offsets, Xt)
    torch.cuda.synchronize()
    assert _relmax(Y, stencil.stencil_spmm_plain(diags, offsets, Xt)[0]) < 1e-5
    assert torch.equal(Y, Yw)


def test_stencil_ring_1m_keeps_the_laplacians_bits(dev, monkeypatch):
    """Row 1m at the north star's (32, 128^3): the Laplacian's entries are
    exact in bf16, so the ring on bf16 diagonals gives the bits of the window
    kernel on them and of the f32 diagonals' route; one
    ``bcg_stencil_ring_bf16d`` launch of 8-row items."""
    op = laplacian_dia((128, 128, 128), device=dev)
    d16 = op.diags.bfloat16()
    Xt = _field(32, op.n, 2602, dev)
    (_, plan), = stencil.launch_plans(d16, op.offsets, Xt, False)
    assert isinstance(plan, stencil.RingPlan) and (plan.S, plan.h, plan.rows) == (16384, 128, 8)
    _native.reset_launches()
    Y = stencil.stencil_spmm_t(d16, op.offsets, Xt)
    assert dict(_native.functions) == {"bcg_stencil_ring_bf16d": 1}
    assert torch.equal(Y, stencil.stencil_spmm_t(op.diags, op.offsets, Xt))
    _window_route(monkeypatch)
    assert torch.equal(Y, stencil.stencil_spmm_t(d16, op.offsets, Xt))


@pytest.mark.parametrize("n,offsets", [
    (1000 * 1024 + 8, (0, 1, -1, 1024, -1024)),   # n % 1,024 != 0: no plane of whole patches
    (4096, (-256, -16, -1, 0, 1, 16, 256)),       # planes narrower than a patch
    (64 ** 3, (0, 4096, -4096, 64, -64, 1, -1)),  # an unaligned field
])
def test_stencil_ring_plan_keeps_the_window_kernel_on_f32_fields(dev, n, offsets):
    """An f32 field on bf16 diagonals where no stride fits (or the field is
    not 16-byte aligned) keeps the window kernel
    (``bcg_stencil_spmm_bf16d``), within ``FIELD_RTOL`` of the plain
    version."""
    diags = _bf(np.random.default_rng(2603).standard_normal((len(offsets), n)), dev)
    if n == 64 ** 3:  # one element past an aligned base
        Xt = torch.empty(17 * n + 1, dtype=torch.float32, device=dev)[1:].view(17, n)
        Xt.copy_(_field(17, n, 2604, dev))
        assert Xt.data_ptr() % 16 != 0 and Xt.is_contiguous()
    else:
        Xt = _field(17, n, 2604, dev)
    plans = stencil.launch_plans(diags, offsets, Xt, False)
    assert not any(isinstance(p, stencil.RingPlan) for _, p in plans)
    _native.reset_launches()
    Y = stencil.stencil_spmm_t(diags, offsets, Xt)
    torch.cuda.synchronize()
    assert _native.functions == {"bcg_stencil_spmm_bf16d": 1}
    assert _relmax(Y, stencil.stencil_spmm_plain(diags, offsets, Xt)[0]) < 1e-5


def test_stencil_ring_f32_field_repeats_its_bits(dev, monkeypatch):
    """300 calls of the 64^3 Laplacian's ring on bf16 diagonals and an f32
    field at k = 32, each bitwise the window kernel's: a stage posted before
    its copies land, or a slot refilled while a step still reads it, shows
    as a wrong bit on some call."""
    op = laplacian_dia((64, 64, 64), device=dev)
    d16 = op.diags.bfloat16()
    Xt = _field(32, op.n, 2605, dev)
    plan = stencil.launch_plans(d16, op.offsets, Xt, False)[0][1]
    assert isinstance(plan, stencil.RingPlan)
    _window_route(monkeypatch)
    want = stencil.stencil_spmm_t(d16, op.offsets, Xt)
    monkeypatch.undo()
    bad = [i for i in range(300)
           if not torch.equal(stencil.stencil_spmm_t(d16, op.offsets, Xt), want)]
    assert bad == []


def _cp_route(monkeypatch):
    """Send the block stencil's launches to ``bs_spmm`` (the parent's route
    of a folded launch)."""
    monkeypatch.setattr(bsk, "_tma_ok", lambda *a: False)


@pytest.mark.parametrize("L", [8, 16])
@pytest.mark.parametrize("k", [12, 24])
def test_block_stencil_tma_folded_matches_plain(dev, L, k, monkeypatch):
    """Folded launches on ``bs_tma``, f32 and bf16 blocks, with and without
    the Gram (then from ``gram``), on ``dirac_gauged_matrix(L)``'s folded
    fields at 12 and 24 right-hand sides (tiles of 128 and 64 sites: the y
    pair's runs of L sites as granule boxes, the z pair's as whole slabs or
    granules; the x pair from the window): every launch takes the TMA
    route; Y within 1e-5 of the plain version and of the unfolded kernel on
    the same blocks, the Gram's Y bitwise the SpMM's and its G within 1e-5
    of the plain version's, bf16 bitwise the f32 kernel on the lifted
    blocks, and Y bitwise ``bs_spmm``'s folded apply (the parent route)."""
    monkeypatch.setenv("BLOCKCG_FOLD", "1")
    op = dirac_gauged_matrix(L, device=dev)
    fb, foffs, fold = op.blocks_folded, op.fold_offsets, op.fold
    Xm = _field(op.bs * k, op.ns, 1000 + k, dev)
    for B in (fb, fb.bfloat16()):
        for gram in (False, True):
            plans = bsk.launch_plans(B, foffs, k, gram, Xm.device, fold=fold,
                                     tma=bsk._tma_ok(B, Xm))
            assert all(p.tma for _, p in plans)
        _native.reset_launches()
        Y = bsk.block_stencil_spmm_m_t(B, foffs, Xm, fold)
        Yg, G = bsk.block_stencil_spmm_m_gram_t(B, foffs, Xm, fold)
        assert _native.functions == {"bcg_block_stencil_tma": 2, "bcg_gram": 1}, \
            dict(_native.functions)
        Yp, Gp = bsk.block_stencil_plain(B, foffs, Xm, True, fold)
        # the unfolded kernel on the same blocks: folding and rounding to
        # bf16 commute
        Yu = bsk.block_stencil_spmm_m_t(op.blocks.to(B.dtype), op.offsets, Xm)
        torch.cuda.synchronize()
        assert _relmax(Y, Yp) < 1e-5 and _relmax(Y, Yu) < 1e-5
        assert torch.equal(Y, Yg) and _relfro(G, Gp) < 1e-5
        if B.dtype == torch.bfloat16:
            assert torch.equal(Y, bsk.block_stencil_spmm_m_t(B.float(), foffs, Xm, fold))
        with monkeypatch.context() as mp:
            _cp_route(mp)
            _native.reset_launches()
            Yc = bsk.block_stencil_spmm_m_t(B, foffs, Xm, fold)
            assert _native.functions == {"bcg_block_stencil_spmm": 1}
        assert torch.equal(Y, Yc)


def test_block_stencil_tma_folded_copied_granules_land_before_use(dev, monkeypatch):
    """``dirac_gauged_matrix(8)`` folded (4,096 sites, 32 tiles of 128) at k
    = 12 on plans pinned to h = 0, so every diagonal but the first is far:
    the x pair's runs of one site copied by the producer's lanes, the y
    pair's as 16 granule boxes of 8 sites, the z pair's as two of 64, the t
    pair's as whole slabs, the windows across 0 and ns copied. 300 calls,
    each bitwise ``bs_spmm``'s folded apply on the same pin and within 1e-5
    of the plain version."""
    monkeypatch.setenv("BLOCKCG_FOLD", "1")
    op = dirac_gauged_matrix(8, device=dev)
    fb, foffs, fold = op.blocks_folded, op.fold_offsets, op.fold
    ns, k = op.ns, 12
    Xm = _field(op.bs * k, ns, 1010, dev)
    offs = tuple(int(o) % ns for o in foffs)
    wraps = tuple((d, t[0]) for d, t in sorted(bsk.fold_terms(foffs, fold, ns).items()))
    cap, sms = _native.max_smem(Xm.device.index), _native.sm_count(Xm.device.index)
    pins = {tma: bsk.block_stencil_plan(offs, ns, op.bs, k, False, cap, sms, wraps=wraps, h=0,
                                        tma=tma) for tma in (False, True)}
    assert pins[True].tma and not pins[False].tma and sum(pins[True].near) == 1

    def apply(tma):
        with monkeypatch.context() as mp:
            mp.setattr(bsk, "launch_plans", lambda *a, **kw: [((0, k), pins[tma])])
            return bsk.block_stencil_spmm_m_t(fb, foffs, Xm, fold)
    want = apply(False)
    assert _relmax(want, bsk.block_stencil_plain(fb, foffs, Xm, False, fold)[0]) < 1e-5
    bad = [i for i in range(300) if not torch.equal(apply(True), want)]
    assert bad == []


# ---- the (k, bs, ns) view on the redesigned kernels: row 22h on bs_tma,
# row 14 on cm_spmm; row 2 at 64 rows a launch


def _view_functions(fn, *args):
    """The library functions one call of fn launches, and its output."""
    _native.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    return dict(_native.functions), out


@pytest.mark.parametrize("k", [1, 12, 24, 30])
@pytest.mark.parametrize("L", [8, 32])
def test_block_stencil_tma_view_matches_bs_spmm(dev, L, k, monkeypatch):
    """Row 22h: ``block_stencil_spmm_t`` on bf16 blocks on the (k, bs, ns)
    view (its flat form too) at 4,096 and 32^4 sites on
    ``dirac_gauged_matrix(L)``'s 15 offsets (random blocks), k = 1, 12, 24
    and 30 (two chunks of 15): each launch takes the route its plan names
    (``bs_tma`` where the boxes move no more than ``bs_spmm``, from k = 12
    on), Y bitwise ``bs_spmm``'s on the same blocks (the parent's route)
    and the f32 kernel's on the blocks lifted to f32, within 1e-5 of the
    plain version, a repeat bitwise."""
    offsets = [0, L ** 3, -L ** 3]
    for st in (L ** 2, L, 1):
        offsets += [st, -st, -(L - 1) * st, (L - 1) * st]
    ns, bs = L ** 4, 4
    rng = np.random.default_rng(2200 + L + k)
    b16 = _t(rng.standard_normal((len(offsets), bs, bs, ns)), dev).bfloat16()
    Xv = _field(k, bs * ns, 2201 + k, dev).reshape(k, bs, ns)
    plans = bsk.launch_plans(b16, offsets, k, False, Xv.device, tma=bsk._tma_ok(b16, Xv))
    assert len(plans) == len(_native.row_chunks(k, bsk.MAX_ROWS // bs))
    if k >= 12:
        assert all(p.tma for _, p in plans)
    ntma = sum(p.tma for _, p in plans)
    fns, Y = _view_functions(bsk.block_stencil_spmm_t, b16, offsets, Xv)
    assert fns.get("bcg_block_stencil_tma", 0) == ntma
    assert fns.get("bcg_block_stencil_spmm", 0) == len(plans) - ntma
    with monkeypatch.context() as mp:
        _cp_route(mp)
        fns, Yc = _view_functions(bsk.block_stencil_spmm_t, b16, offsets, Xv)
        assert fns == {"bcg_block_stencil_spmm": len(plans)}
    assert torch.equal(Y, Yc)
    assert torch.equal(Y, bsk.block_stencil_spmm_t(b16.float(), offsets, Xv))
    assert torch.equal(bsk.block_stencil_spmm_t(b16, offsets, Xv.reshape(k, -1)),
                       Y.reshape(k, -1))
    assert torch.equal(bsk.block_stencil_spmm_t(b16, offsets, Xv), Y)
    assert _relmax(Y, bsk.block_stencil_v_plain(b16, offsets, Xv)) < 1e-5


def test_block_stencil_tma_view_copied_stages_land_before_use(dev):
    """The view on ``bs_tma`` at 1,000 sites (the first and last tiles'
    windows across 0 and ns, the far slabs of 450 and ns + 401 copied by the
    producer warp's lanes on every tile), k = 12: 300 calls, each bitwise
    the f32 kernel on the lifted blocks. A stage posted before its lanes'
    copies land shows as a wrong bit on some call."""
    blocks, offsets, Xm = _bs_tma_operands(1000, 4, 12, dev, 2210)
    b16 = blocks.bfloat16()
    Xv = Xm.reshape(12, 4, 1000)
    assert all(p.tma for _, p in bsk.launch_plans(b16, offsets, 12, False, Xv.device,
                                                  tma=bsk._tma_ok(b16, Xv)))
    want = bsk.block_stencil_spmm_t(b16.float(), offsets, Xv)
    bad = [i for i in range(300) if not torch.equal(bsk.block_stencil_spmm_t(b16, offsets, Xv),
                                                    want)]
    assert bad == []


def _cbs_spmm_view(hops, offsets, slots, masks, Xv):
    """``csrc/const_block_stencil.cu``'s view kernel without the Gram (row
    14's route before ``cm_spmm``), one launch per chunk of right-hand sides
    as its wrapper made them."""
    nd, bs, _ = hops.shape
    k, ns = Xv.shape[0], Xv.shape[-1]
    offs = (ctypes.c_int * nd)(*(int(o) % ns for o in offsets))
    cslots = (ctypes.c_int * nd)(*slots)
    Y = torch.empty_like(Xv)
    row = ns * 4 * bs
    p = _native.ptr
    for j0, j1 in _native.row_chunks(k, cbs.rhs_width(bs)):
        _native.launch("cbs_spmm", "bcg_cbs_spmm", Xv.device, p(hops), offs, cslots, nd, bs,
                       p(masks), p(Xv) + j0 * row, p(Y) + j0 * row, None, None, j1 - j0, ns,
                       _native.nblocks(ns))
    return Y


@pytest.mark.parametrize("k", [1, 12])
@pytest.mark.parametrize("which", ["random 300 none", "random 300 gates", "random 300 values",
                                   "eo16 hop_oe", "config4", "gauged config4"])
def test_const_hop_view_on_cm_spmm_keeps_cbs_spmm_bits(dev, which, k):
    """Row 14 on ``cm_spmm`` with the view's row map (the ungrouped plan):
    one ``bcg_cbs_merged_spmm`` launch, Y bitwise ``cbs_spmm``'s (the
    parent's route) at k = 1 and 12, without masks, with gates and with
    value masks (random hops on 300 sites), on ``dirac_eo(16)``'s hop and on
    config 4's operator and its Z2-gauged form at 32^4; within 1e-5 of the
    plain version, its flat form and a repeat bitwise."""
    if which.startswith("random"):
        hops, offsets, slots, rows, Xm = _cbs_operands(300, 4, k, which.split()[-1], dev,
                                                       seed=2220 + k)
        op = None
        Xv = Xm.reshape(k, 4, 300)
    else:
        op = (dirac_eo(16, device=dev).hop_oe if which.startswith("eo")
              else (dirac_gauged_cbdia if which.startswith("gauged") else dirac_cbdia)(
                  32, device=dev))
        hops, offsets, slots, rows = op.hops_main, op.main_offsets, op.main_slots, op.masks_main
        Xv = _field(k, op.bs * op.ns, 2230 + k, dev).reshape(k, op.bs, op.ns)
    main = (hops, offsets, slots, rows)
    extra = () if op is None else (op.main_plans,)
    fns, Y = _view_functions(cbs.const_block_stencil_spmm_t, *main, Xv, *extra)
    assert fns == {"bcg_cbs_merged_spmm": 1}
    assert torch.equal(Y, _cbs_spmm_view(*main, Xv))
    assert _relmax(Y, cbs.const_block_stencil_v_plain(*main, Xv)[0]) < 1e-5
    assert torch.equal(cbs.const_block_stencil_spmm_t(*main, Xv.reshape(k, -1)),
                       Y.reshape(k, -1))
    assert torch.equal(cbs.const_block_stencil_spmm_t(*main, Xv, *extra), Y)


# Row 2 at 64 rows a launch (H100 80GB HBM3, 700 W), on the X that
# test_stencil_f32_gram_at_64_rows_keeps_y_and_nears_its_contract makes on
# the 7-point Laplacian: the sha256 (16 hex digits) of the bytes of Y, the
# same on every route (the SpMM's fmaf chain), and G's relative
# Frobenius distance from the f64 Gram of X and the f32 sums on the route
# before stencil_vec_gram (two 32-row stencil_mma_f32 launches and gram.cu's
# cross blocks, 4.1445e-08 / 3.5907e-08; PERF.md section 6).
_F32_GRAM_64_PINS = {
    64: ("580dda9ab7fc46bc", 4.1445e-08),
    128: ("9521abcca95bed05", 3.5907e-08),
}


@pytest.mark.parametrize("edge", list(_F32_GRAM_64_PINS))
def test_stencil_f32_gram_at_64_rows_keeps_y_and_nears_its_contract(dev, edge):
    """Row 2 at k = 64 (config 5's f32 width) on the 64^3 and 128^3
    Laplacians on ``stencil_vec_gram`` (one launch): Y bitwise the route
    before (pinned checksums) and the SpMM's, G no farther than 1.1 times
    the route before from the f64 Gram of X and the f32 sums, its contract
    (4.559e-08 and 3.950e-08); a repeat bitwise."""
    pin, before = _F32_GRAM_64_PINS[edge]
    op = laplacian_dia((edge,) * 3, device=dev)
    X = _t(np.random.default_rng(2240 + edge).standard_normal((64, op.n)), dev)
    _native.reset_launches()
    Y, G = stencil.stencil_spmm_gram_t(op.diags, op.offsets, X)
    assert _native.functions == {"bcg_stencil_vec_gram": 1}
    assert _sha32(Y) == pin and torch.equal(Y, stencil.stencil_spmm_t(op.diags, op.offsets, X))
    G64 = X.double() @ Y.double().T
    assert _relfro(G.double(), G64) <= 1.1 * before
    Y2, G2 = stencil.stencil_spmm_gram_t(op.diags, op.offsets, X)
    assert torch.equal(Y2, Y) and torch.equal(G2, G)


@pytest.mark.parametrize("fn,k", [("bcg_stencil_spmm", 33), ("bcg_stencil_spmm", 64),
                                  ("bcg_stencil_vec_gram", 32), ("bcg_stencil_vec_gram", 65)])
def test_stencil_f32_gram_entries_refuse_the_others_rows(dev, fn, k):
    """An f32 field's Gram runs ``stencil_mma_f32`` (``bcg_stencil_spmm``)
    up to 32 rows a launch and ``stencil_vec_gram`` from 33 to 64: each C
    entry refuses the other's rows (and above 64) with an error, and writes
    nothing."""
    op = laplacian_dia((16,) * 3, device=dev)
    n, nd = op.n, len(op.offsets)
    X = _field(k, n, 2400 + k, dev)
    Y = torch.zeros_like(X)
    G = torch.zeros((k, k), device=dev)
    part = torch.zeros((8, k, k), dtype=torch.float64 if "vec" in fn else torch.float32,
                       device=dev)
    offs = (ctypes.c_int * nd)(*(int(o) % n for o in op.offsets))
    with pytest.raises(RuntimeError, match="launch failed"):
        _native.launch("refusal", fn, X.device, op.diags.data_ptr(), offs, nd, X.data_ptr(),
                       Y.data_ptr(), part.data_ptr(), G.data_ptr(), k, n, 4, 256, 8)
    torch.cuda.synchronize()
    assert not Y.any() and not G.any()


@pytest.mark.parametrize("k,dtype", [(64, torch.float32), (48, torch.float32),
                                     (64, torch.bfloat16), (40, torch.float32),
                                     (33, torch.float32)])
def test_stencil_f32_gram_at_64_rows_matches_plain(dev, k, dtype):
    """Rows 2 and 2m above 32 rows on the 64^3 Laplacian (config 5's f32
    route at 64 rows) against the plain version: one launch, of
    ``stencil_vec_gram`` (``vec_gram_takes``; 33 to 64 rows),
    Y within 1e-5 and bitwise the SpMM's, G within 1e-5 (the sums in another
    order); at 64 rows on a field one element off a 16-byte boundary the
    same."""
    op = laplacian_dia((64,) * 3, device=dev)
    D = op.diags.to(dtype)
    X = _field(k, op.n, 2300 + k, dev)
    _native.reset_launches()
    Y, G = stencil.stencil_spmm_gram_t(D, op.offsets, X)
    suffix = "_bf16d" if dtype == torch.bfloat16 else ""
    fn = ("bcg_stencil_vec_gram" if stencil.vec_gram_takes(k) else "bcg_stencil_spmm") + suffix
    assert dict(_native.functions) == {fn: 1}
    Yp, Gp = stencil.stencil_spmm_plain(D, op.offsets, X, with_gram=True)
    assert _relmax(Y, Yp) < 1e-5 and _relfro(G, Gp) < 1e-5
    assert torch.equal(Y, stencil.stencil_spmm_t(D, op.offsets, X))
    if k == 64 and dtype == torch.float32:
        Xo = torch.empty(k * op.n + 1, device=dev)[1:].view(k, op.n)
        Xo.copy_(X)
        Yo, Go = stencil.stencil_spmm_gram_t(D, op.offsets, Xo)
        assert torch.equal(Yo, Y) and _relfro(Go, Gp) < 1e-5


# ------------------- rows 19 and 20 on csrc/slab_stream.cu


@pytest.mark.parametrize("k", [1, 3, 12])
@pytest.mark.parametrize("route", ["16-byte", "4-byte"])
def test_view_slab_adds_on_slab_stream_match_plain(dev, k, route):
    """Rows 18 and 21 on ``csrc/slab_stream.cu`` (the (k, bs, ns) view's row
    map) against their plain versions within 1e-5: row 18 on config 4's
    first wrap slab (``dirac_cbdia(32)``: g = 1024 x 32) and row 21 on a halo
    of 8 blocks of 4,096 sites into the last 8 of 32^4; the 4-byte route on
    fields one element off a 16-byte boundary. One launch each at any k; Y
    in place; a repeat gives its bits; at k = 1 the bits of rows 19 and 20
    on the same memory."""
    op = dirac_cbdia(32, device=dev)
    ns, bs = op.ns, op.bs
    d, g, nb, mul, off, shift = op.slabs[0]
    bw, gh = 32 ** 3, 4096

    def placed(F):
        if route == "16-byte":
            return F
        O = torch.empty(F.numel() + 1, device=dev)[1:].view(F.shape)
        return O.copy_(F)

    Xv = placed(_field(k, bs * ns, 2450, dev).reshape(k, bs, ns))
    Y0 = placed(_field(k, bs * ns, 2451, dev).reshape(k, bs, ns))
    Src = placed(_field(k, bs * bw, 2452, dev).reshape(k, bs, bw))
    wrap = (op.hops_all[d], g, nb, mul, off, shift, Xv)
    halo = (op.hops_all[1], gh, bw // gh, (ns - bw) // gh, 0, Src)
    fn = "bcg_slab_stream" if route == "16-byte" else "bcg_slab_stream_scalar"
    for name, kern, plain, merged in (
            ("slab_block_accumulate", lambda Y: cbs.slab_block_accumulate(*wrap, Y),
             lambda Y: cbs.slab_v_plain(*wrap, Y),
             lambda Y: cbs.slab_m_accumulate(*wrap[:-1], Xv.reshape(bs, ns), Y)),
            ("slab_block_accumulate_from", lambda Y: cbs.slab_block_accumulate_from(*halo, Y),
             lambda Y: cbs.slab_v_from_plain(*halo, Y),
             lambda Y: cbs.slab_m_accumulate_from(*halo[:-1], Src.reshape(bs, bw), Y))):
        Yk, Yp = placed(Y0.clone()), Y0.clone()
        _native.reset_launches()
        assert kern(Yk).data_ptr() == Yk.data_ptr()
        assert dict(_native.launches) == {name: 1} and dict(_native.functions) == {fn: 1}
        plain(Yp)
        torch.cuda.synchronize()
        assert _relmax(Yk, Yp) < 1e-5
        again = placed(Y0.clone())
        kern(again)
        assert torch.equal(again, Yk)
        if k == 1:
            Ym = placed(Y0.clone()).reshape(bs, ns)
            merged(Ym)
            assert torch.equal(Ym, Yk.reshape(bs, ns))


def test_view_slab_add_on_the_even_odd_hop_is_row_19s(dev):
    """Row 18 at one right-hand side on ``dirac_eo(32)``'s parity hop (the
    even-odd CG's path, (1, 4, 2^19)): each slab add one 16-byte
    ``slab_stream`` launch, bitwise row 19 on the same memory and within
    1e-5 of its plain version."""
    hop = dirac_eo(32, device=dev).hop_oe
    X = _field(hop.bs, hop.ns, 2460, dev)
    Y0 = _field(hop.bs, hop.ns, 2461, dev)
    for d, g, nb, mul, off, shift in hop.slabs:
        args = (hop.hops_all[d], g, nb, mul, off, shift)
        Yv, Ym, Yp = (Y0.clone() for _ in range(3))
        _native.reset_launches()
        cbs.slab_block_accumulate(*args, X.view(1, hop.bs, hop.ns), Yv.view(1, hop.bs, hop.ns))
        assert dict(_native.functions) == {"bcg_slab_stream": 1}
        cbs.slab_m_accumulate(*args, X, Ym)
        cbs.slab_plain(*args, X, Yp)
        torch.cuda.synchronize()
        assert torch.equal(Yv, Ym) and _relmax(Yv, Yp) < 1e-5


def _config4_slab(dev, k, seed):
    """Config 4's first wrap slab (``dirac_cbdia(32)``: g = 1024 x 32) and
    merged fields X, Y of k right-hand sides, with a Gin."""
    op = dirac_cbdia(32, device=dev)
    m, ns = op.bs * k, op.ns
    d, g, nb, mul, off, shift = op.slabs[0]
    X, Y = _field(m, ns, seed, dev), _field(m, ns, seed + 1, dev)
    Gin = _t(np.random.default_rng(seed + 2).standard_normal((m, m)), dev)
    return (op.hops_all[d], g, nb, mul, off, shift, X), Y, Gin


@pytest.mark.parametrize("k", [12, 24])
def test_slab_stream_repeats_its_bits(dev, k):
    """Rows 19 and 20 at config 4's shapes (m = 48 and 96): a repeat gives
    the same Y and G bits, with and without ``vals``; the 16-byte route;
    within 1e-5 of the plain version (its hop product is a library GEMM)."""
    args, Y0, Gin = _config4_slab(dev, k, 2500)
    outs = []
    for _ in range(2):
        outs.append(cbs.slab_m_accumulate(*args, Y0.clone(), Gin, with_gram=True))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    Yp, Gp = cbs.slab_plain(*args, Y0.clone(), Gin, with_gram=True)
    assert _relmax(outs[0][0], Yp) < 1e-5 and _relfro(outs[0][1], Gp) < 1e-5
    m, ns = Y0.shape
    bw, g = 32 ** 3, 4096
    hop, X = args[0], args[-1]
    Src = _field(m, bw, 2503, dev)
    v = _t(np.random.default_rng(2504).choice([-1.0, 1.0], (1, bw)), dev)
    _native.reset_launches()
    got = [cbs.slab_m_accumulate_from(hop, g, 8, (ns - bw) // g, 0, Src, Y0.clone(), X, v,
                                      with_gram=True) for _ in range(2)]
    assert _native.functions == {"bcg_slab_stream": 2}
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])
    want = cbs.slab_from_plain(hop, g, 8, (ns - bw) // g, 0, Src, Y0.clone(), X, v, True)
    assert _relmax(got[0][0], want[0]) < 1e-5 and _relfro(got[0][1], want[1]) < 1e-5


@pytest.mark.parametrize("case", ["g2", "offset source", "offset field"])
@pytest.mark.parametrize("gram", [False, True])
def test_slab_stream_scalar_route_matches_plain(dev, case, gram):
    """The 4-byte route of ``csrc/slab_stream.cu`` (``bcg_slab_stream_scalar``):
    slabs of g = 2 sites (on a 4 x 300-site field), a halo source that starts
    one element off a 16-byte boundary, or such a field; against the plain
    version within 1e-5, and where the operands have aligned copies Y
    bitwise the 16-byte route's (the same arithmetic) and G within 1e-6."""
    hop = dirac_cbdia(4, device=dev).hops_all[1]
    k = 12
    m = 4 * k

    def off(F):  # the same values one element past a 16-byte boundary
        O = torch.empty(F.numel() + 1, device=dev)[1:].view(F.shape)
        return O.copy_(F)

    _native.reset_launches()
    if case == "g2":
        X, Y0 = _field(m, 1200, 2600, dev), _field(m, 1200, 2601, dev)
        args = (hop, 2, 150, 3, 1, 7, X)
        got = cbs.slab_m_accumulate(*args, Y0.clone(), with_gram=gram)
        want = cbs.slab_plain(*args, Y0.clone(), with_gram=gram)
    else:
        Src, Y0, X = (_field(m, 4 * 256, 2602, dev), _field(m, 8 * 256, 2603, dev),
                      _field(m, 8 * 256, 2604, dev))
        v = _t(np.random.default_rng(2605).choice([-1.0, 1.0], (1, 3 * 256)), dev)
        if case == "offset source":
            Src = off(Src)
        else:
            X = off(X)
        args = (hop, 256, 3, 5, 1, Src)
        got = cbs.slab_m_accumulate_from(*args, Y0.clone(), X, v, with_gram=gram)
        want = cbs.slab_from_plain(*args, Y0.clone(), X, v, gram)
        vec = cbs.slab_m_accumulate_from(hop, 256, 3, 5, 1, Src.clone(), Y0.clone(), X.clone(), v,
                                         with_gram=gram)
    # Without the Gram the field X is not read: an offset X leaves the 16-byte route.
    scalar = 0 if case == "offset field" and not gram else 1
    assert _native.functions["bcg_slab_stream_scalar"] == scalar
    got, want = (got, want) if gram else ((got,), (want,))
    assert _relmax(got[0], want[0]) < 1e-5
    if gram:
        assert _relfro(got[1], want[1]) < 1e-5
    if case != "g2":
        assert _native.functions["bcg_slab_stream"] == 2 - scalar
        vec = vec if gram else (vec,)
        assert torch.equal(got[0], vec[0])
        if gram:
            assert _relfro(got[1], vec[1]) < 1e-6


def test_slab_stream_gram_in_passes_matches_plain(dev):
    """Row 19 at m = 160 (k = 40), above the Gram's widest tile of 128 rows:
    one launch, the Gram in four passes of (128, 128) blocks; within 1e-5
    of the plain version, Y bitwise the add's without the Gram, a repeat's
    G bitwise."""
    op = dirac_cbdia(16, device=dev)
    k = 40
    m, ns = op.bs * k, op.ns
    X, Y0 = _field(m, ns, 2700, dev), _field(m, ns, 2701, dev)
    Gin = _t(np.random.default_rng(2702).standard_normal((m, m)), dev)
    d, g, nb, mul, off, shift = op.slabs[0]
    args = (op.hops_all[d], g, nb, mul, off, shift, X)
    assert cbs.slab_plan(m, op.bs, g, nb, True, g % 4 == 0, 132, 232448).passes == 4
    _native.reset_launches()
    Yk, G = cbs.slab_m_accumulate(*args, Y0.clone(), Gin, with_gram=True)
    assert _native.launches["slab_m_accumulate"] == 1
    Yp, Gp = cbs.slab_plain(*args, Y0.clone(), Gin, with_gram=True)
    assert _relmax(Yk, Yp) < 1e-5 and _relfro(G, Gp) < 1e-5
    assert torch.equal(cbs.slab_m_accumulate(*args, Y0.clone()), Yk)
    assert torch.equal(cbs.slab_m_accumulate(*args, Y0.clone(), Gin, with_gram=True)[1], G)
