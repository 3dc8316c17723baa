"""The port's kernel wrappers (blockcg_tpu_torch/ops) against the reference's
Pallas kernels in interpret mode, on CPU tensors.

On the CPU every wrapper runs its plain PyTorch version, which is what
these tests hold against the Pallas kernels (and, for the stencil, an f64
numpy oracle). The same inputs, made from a numpy seed, go to both packages.
Tolerance: f32, max relative error 1e-5 (different summation order and FMA).
The CUDA kernels themselves are compared with these plain versions on the
card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from blockcg_tpu.ops import fused as jfused
from blockcg_tpu.ops import stencil as jstencil
from blockcg_tpu.ops import stencil_ring as jring
from blockcg_tpu.problems import laplacian_dia as jlaplacian_dia
from blockcg_tpu_torch.ops import _native, fused, stencil

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < rtol, err


def _oracle(diags, offsets, Xt):
    """f64 toroidal apply: Y[:, i] = sum_d diags[d, i] X[:, (i + o_d) mod n]."""
    n = diags.shape[1]
    X = np.asarray(Xt, np.float64)
    Y = np.zeros_like(X)
    for d, o in enumerate(offsets):
        Y += np.asarray(diags[d], np.float64)[None, :] * X[:, (np.arange(n) + o) % n]
    return Y


def _banded(n, offsets, seed):
    """Random banded matrix with EVERY entry of every diagonal populated, the
    wrap-crossing ones included, so a wrong mod-n index shows."""
    return np.random.default_rng(seed).standard_normal((len(offsets), n)).astype(np.float32)


def _laplacian(shape):
    op = jlaplacian_dia(shape, dtype=jnp.float32)
    return np.array(op.diags), op.offsets


_LAP8 = ((8, 8, 8), 4)
_LAP16 = ((16, 16, 16), 8)
_BAND = (1024, (-130, -7, -1, 0, 2, 64, 257))
_BAND_RING = (4096, (-1100, -130, -1, 0, 3, 257, 1024))


def _case(name):
    if name == "lap8":
        d, o = _laplacian(_LAP8[0])
        return d, o, _LAP8[1]
    if name == "lap16":
        d, o = _laplacian(_LAP16[0])
        return d, o, _LAP16[1]
    n, o = _BAND if name == "band" else _BAND_RING
    return _banded(n, o, 3), o, 5


@pytest.mark.parametrize("case,kernel", [
    ("lap8", "stencil"), ("band", "stencil"),
    ("lap16", "ring"), ("band_ring", "ring"),
])
def test_stencil_plain_matches_pallas(case, kernel):
    diags, offsets, k = _case(case)
    Xt = np.random.default_rng(1).standard_normal((k, diags.shape[1])).astype(np.float32)
    jfn = jstencil.stencil_spmm_gram_t if kernel == "stencil" else jring.ring_spmm_gram_t
    Yj, Gj = jfn(jnp.asarray(diags), offsets, jnp.asarray(Xt), interpret=True)
    Y, G = stencil.stencil_spmm_gram_t(torch.from_numpy(diags), offsets, torch.from_numpy(Xt))
    _close(Y, Yj)
    _close(G, Gj)
    Y_oracle = _oracle(diags, offsets, Xt)
    _close(Y, Y_oracle)
    _close(G, np.asarray(Xt, np.float64) @ Y_oracle.T)
    _close(stencil.stencil_spmm_t(torch.from_numpy(diags), offsets, torch.from_numpy(Xt)),
           Y_oracle)


def _fields(k, n, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((k, n)).astype(np.float32) for _ in range(count)]


def _kks(k, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((k, k)).astype(np.float32) for _ in range(count)]


def _both(arrs):
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a.copy()) for a in arrs]


@pytest.mark.parametrize("k,n", [(4, 512), (8, 1024)])
def test_fused_plain_matches_pallas(k, n):
    (Mj1, Mj2, Mj3), (M1, M2, M3) = _both(_kks(k, 3, 10 + k))
    (Bj1, Bj2, Aj), (B1, B2, A) = _both(_fields(k, n, 3, 20 + k))

    _close(fused.gram(B1, B2), jfused.gram(Bj1, Bj2, interpret=True))
    for a, aj in ((None, None), (A, Aj)):
        _close(fused.mm_update(M1, B1, a), jfused.mm_update(Mj1, Bj1, aj, interpret=True))
        Y, G = fused.mm_update_gram(M1, B1, a)
        Yj, Gj = jfused.mm_update_gram(Mj1, Bj1, aj, interpret=True)
        _close(Y, Yj)
        _close(G, Gj)
    Y, G = fused.mm2_update_gram(M1, B1, M2, B2)
    Yj, Gj = jfused.mm2_update_gram(Mj1, Bj1, Mj2, Bj2, interpret=True)
    _close(Y, Yj)
    _close(G, Gj)
    Pn, Xn = fused.px_update(M1, B1, M2, B2, M3, A)
    Pj, Xj = jfused.px_update(Mj1, Bj1, Mj2, Bj2, Mj3, Aj, interpret=True)
    _close(Pn, Pj)
    _close(Xn, Xj)


def _kron4(C):
    return np.kron(np.eye(4, dtype=np.float32), C)


@pytest.mark.parametrize("k,n,merged", [(4, 512, False), (16, 1024, False), (16, 512, True)])
def test_xr_and_qr_p_plain_match_pallas(k, n, merged):
    """``xr_update_gram`` and ``qr_p_update`` at k in {4, 16}, and on the
    merged view of the const-hop operator: m = 4 * 4 rows with ``I_4 ⊗ C``
    coefficients, as the codec expands them."""
    kk = _kks(k // 4 if merged else k, 3, 40 + k)
    (Aj, Mj, Rj), (A, M, R) = _both([_kron4(c) for c in kk] if merged else kk)
    (Pj, Xj, Zj, Rfj), (P, X, Z, Rf) = _both(_fields(k, n, 4, 50 + k))
    got = fused.xr_update_gram(A, P, X, Z, Rf)
    want = jfused.xr_update_gram(Aj, Pj, Xj, Zj, Rfj, interpret=True)
    for g, w in zip(got, want):
        _close(g, w)
    got = fused.qr_p_update(M, P, R, Z)
    want = jfused.qr_p_update(Mj, Pj, Rj, Zj, interpret=True)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("k,n,merged", [(4, 512, False), (16, 512, True)])
def test_qr_px_update_plain_matches_pallas(k, n, merged):
    """``qr_px_update`` and its codec dispatcher ``f_qr_px_update`` against
    the Pallas kernel in interpret mode, flat and on ``I_4 ⊗ C``; donated
    outputs land in Q1, P and X."""
    from blockcg_tpu_torch.solvers.common import f_qr_px_update

    kk = _kks(k // 4 if merged else k, 3, 60 + k)
    (Mj, Rj, Cj), (M, R, C) = _both([_kron4(c) for c in kk] if merged else kk)
    (Qj, Pj, Xj), (Q1, P, X) = _both(_fields(k, n, 3, 70 + k))
    want = jfused.qr_px_update(Mj, Qj, Rj, Pj, Cj, Xj, interpret=True)
    for g, w in zip(fused.qr_px_update(M, Q1, R, P, C, X), want):
        _close(g, w)
    bufs = [t.clone() for t in (Q1, P, X)]
    got = fused.qr_px_update(M, bufs[0], R, bufs[1], C, bufs[2], donate=True)
    assert [g.data_ptr() for g in got] == [b.data_ptr() for b in bufs]
    for g, w in zip(got, want):
        _close(g, w)
    if not merged:
        for g, w in zip(f_qr_px_update(M, Q1, R, P, C, X), want):
            _close(g, w)


def test_row_chunks_cover_the_field_in_balanced_launches():
    assert _native.row_chunks(64) == [(0, 64)]
    assert _native.row_chunks(96) == [(0, 48), (48, 96)]
    assert _native.row_chunks(65) == [(0, 33), (33, 65)]
    assert _native.row_chunks(24, 16) == [(0, 12), (12, 24)]
    for k in (1, 7, 64, 100, 129, 300):
        for w in (8, 16, 64, 128):
            chunks = _native.row_chunks(k, w)
            assert chunks[0][0] == 0 and chunks[-1][1] == k
            assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
            assert all(0 < r1 - r0 <= w for r0, r1 in chunks)
            assert len(chunks) == -(-k // w)
    with pytest.raises(ValueError):
        _native.row_chunks(0)


@pytest.mark.parametrize("k, plan, width", [
    (200, "mm2_update_gram_plan", 64), (400, "qr_px_update_plan", 32),
    (800, "mm_update_gram_plan", 32), (800, "px_update_plan", 16)])
def test_wide_gram_lays_out_the_chunks_that_made_its_blocks(monkeypatch, k, plan, width):
    """A fused update too wide for one launch runs row chunks, narrower
    where its k-column coefficients would pass the shared-memory cap beside
    64 rows (the plan's chunks are ``_native.row_chunks(k, width)``), and the
    Gram is assembled by those same chunks: the diagonal blocks as the
    chunks' launches give them, the rest as ``gram`` blocks (both stood in
    for by plain products on the CPU)."""
    monkeypatch.setattr(_native, "max_smem", lambda index: 232448)  # an H100's cap
    monkeypatch.setattr(fused, "_launch_gram", lambda U, V: U @ V.T)
    chunks = getattr(fused, plan)(k, torch.device("cpu")).chunks
    assert chunks == _native.row_chunks(k, width)
    Y = torch.from_numpy(_fields(k, 130, 1, 40)[0])
    diag = [fused.gram_plain(Y[r0:r1], Y[r0:r1]) for r0, r1 in chunks]
    G = fused.wide_gram(Y, Y, diag, chunks)
    _close(G, fused.gram_plain(Y, Y))
    with pytest.raises(ValueError, match="diagonal blocks"):
        fused.wide_gram(Y, Y, diag[:-1], chunks)


def test_donate_writes_into_the_operand_on_cpu():
    """``donate`` has the kernel's in-place meaning on the plain route too."""
    (M1, M2, M3) = [torch.from_numpy(m) for m in _kks(4, 3, 30)]
    W, P, X = [torch.from_numpy(f) for f in _fields(4, 256, 3, 31)]
    Y, G = fused.mm2_update_gram(M1, W.clone(), M2, P)
    Wd = W.clone()
    Yd, Gd = fused.mm2_update_gram(M1, Wd, M2, P, donate=True)
    assert Yd.data_ptr() == Wd.data_ptr() and torch.equal(Yd, Y) and torch.equal(Gd, G)
    Bd = W.clone()
    Yd, _ = fused.mm_update_gram(M1, Bd, donate=True)
    assert Yd.data_ptr() == Bd.data_ptr()
    torch.testing.assert_close(Yd, fused.mm_update(M1, W), rtol=0, atol=0)
    Pn, Xn = fused.px_update(M1, W, M2, P, M3, X)
    Pd, Xd = P.clone(), X.clone()
    Pnd, Xnd = fused.px_update(M1, W, M2, Pd, M3, Xd, donate=True)
    assert Pnd.data_ptr() == Pd.data_ptr() and Xnd.data_ptr() == Xd.data_ptr()
    assert torch.equal(Pnd, Pn) and torch.equal(Xnd, Xn)


def test_donate_of_the_new_updates_on_cpu():
    """``xr_update_gram`` writes onto X and R and leaves P and Z;
    ``qr_p_update`` writes onto Q1 and P; ``mm_update`` onto B or A."""
    M1, M2 = [torch.from_numpy(m) for m in _kks(4, 2, 32)]
    P, X, Z, R = [torch.from_numpy(f) for f in _fields(4, 256, 4, 33)]
    want = fused.xr_update_gram(M1, P, X, Z, R)
    P_in, Z_in, Xd, Rd = P.clone(), Z.clone(), X.clone(), R.clone()
    got = fused.xr_update_gram(M1, P, Xd, Z, Rd, donate=True)
    assert got[0].data_ptr() == Xd.data_ptr() and got[1].data_ptr() == Rd.data_ptr()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(P, P_in) and torch.equal(Z, Z_in)
    want = fused.qr_p_update(M1, X, M2, P)
    Qd, Pd = X.clone(), P.clone()
    got = fused.qr_p_update(M1, Qd, M2, Pd, donate=True)
    assert got[0].data_ptr() == Qd.data_ptr() and got[1].data_ptr() == Pd.data_ptr()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for donate, dst in (("b", X.clone()), ("a", R.clone())):
        B, A = (dst, R) if donate == "b" else (X, dst)
        Y = fused.mm_update(M1, B, A, donate=donate)
        assert Y.data_ptr() == dst.data_ptr()
        assert torch.equal(Y, fused.mm_update(M1, X, R))
    with pytest.raises(ValueError):
        fused.mm_update(M1, X, donate="a")  # no A to write onto


def test_cpu_route_launches_nothing_and_loads_no_library():
    _native.reset_launches()
    M = torch.eye(4)
    B = torch.ones(4, 256)
    fused.mm_update(M, B)
    fused.gram(B, B)
    stencil.stencil_spmm_gram_t(torch.ones(3, 256), (-1, 0, 1), B)
    assert sum(_native.launches.values()) == 0
    assert _native.library.cache_info().currsize == 0


@pytest.mark.parametrize("tensors,exc", [
    ((torch.ones(2, device="meta"),), ValueError),            # not CPU, not CUDA
    ((torch.ones(2), torch.ones(2, device="meta")), ValueError),  # mixed devices
])
def test_dispatch_rejects_other_devices(tensors, exc):
    with pytest.raises(exc):
        _native.use_kernel(*tensors)


def test_dispatch_cpu_is_plain_for_any_dtype():
    assert _native.use_kernel(torch.ones(2), torch.ones(2)) is False
    assert _native.use_kernel(torch.ones(2, dtype=torch.float64)) is False
    assert _native.use_kernel(torch.ones(2, dtype=torch.bfloat16), torch.ones(2)) is False


def test_nblocks_depends_on_n_only():
    assert _native.nblocks(1) == 1
    assert _native.nblocks(128) == 1 and _native.nblocks(129) == 2
    assert _native.nblocks(2 ** 21) == _native.MAX_BLOCKS


def test_native_build_command_and_sources(monkeypatch, tmp_path):
    """The library is built from the kernel sources of the checkout for
    sm_90a, one compile per source and one link, and a missing nvcc raises
    (there is no fallback)."""
    cus = {"stencil.cu", "gram.cu", "mm_update_gram.cu", "px_update.cu",
           "const_block_stencil.cu", "xr_update.cu", "spmm_tiled.cu"}
    assert cus <= {p.name for p in _native.sources()}
    assert "arch=compute_90a,code=sm_90a" in _native.NVCC_FLAGS
    root = Path(__file__).resolve().parents[1]
    assert _native.library_path().parent == root / "build" / "blockcg_tpu_torch"
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.touch()
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    compiles, link = _native.build_commands(tmp_path / "lib.so")
    assert {Path(c[c.index("-c") + 1]).name for c in compiles} == {
        p.name for p in _native.sources() if p.suffix == ".cu"}
    assert link[-len(compiles):] == [c[-1] for c in compiles]
    assert "-shared" in link and link[link.index("-o") + 1] == str(tmp_path / "lib.so")
    fake.unlink()
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.build_commands(tmp_path / "lib.so")


@pytest.mark.parametrize("xdg", [True, False])
def test_native_build_dir_of_installed_package(monkeypatch, tmp_path, xdg):
    """Installed (no pyproject.toml beside the package), the library goes to
    the user's cache directory, not next to site-packages."""
    pkg = tmp_path / "lib" / "site-packages" / "blockcg_tpu_torch"
    pkg.mkdir(parents=True)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if xdg:
        monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
        want = tmp_path / "cache" / "blockcg_tpu_torch"
    else:
        monkeypatch.delenv("XDG_CACHE_HOME", raising=False)
        want = tmp_path / "home" / ".cache" / "blockcg_tpu_torch"
    assert _native.build_dir(pkg) == want
    (pkg.parent / "pyproject.toml").touch()  # a source checkout instead
    assert _native.build_dir(pkg) == pkg.parent / "build" / "blockcg_tpu_torch"


def test_import_leaves_jax_out():
    """The port never imports JAX (nor the reference package)."""
    code = ("import sys, blockcg_tpu_torch, blockcg_tpu_torch.problems; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'blockcg_tpu')]; "
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout
