"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test needs a CUDA device and skips without one. On a machine with the
card and without JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` skips the reference suite's JAX set-up). Inputs come from a
numpy seed. Tolerances: field outputs to a max relative error of 1e-5 (f32,
FMA and summation order differ from the plain version's), Grams to a relative
Frobenius error of 1e-5 (blocked two-stage summation).
"""

import numpy as np
import pytest
import torch

from blockcg_tpu_torch.ops import _native, fused, stencil
from blockcg_tpu_torch.problems import laplacian_dia, laplacian_scipy

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
    with pytest.raises(TypeError):
        fused.mm_update(M.bfloat16(), B.bfloat16())
    with pytest.raises(ValueError):
        fused.gram(B[:, ::2], B[:, ::2])


def test_sbcgrq_on_card_matches_cpu(dev):
    from blockcg_tpu_torch import solve_sbcgrq

    op = laplacian_dia((16, 16, 16))
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
