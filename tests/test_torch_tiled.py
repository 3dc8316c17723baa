"""The port's sparse-tile path (``blockcg_tpu_torch/native.py``,
``operators/tiled.py``, ``ops/spmm_tiled.py``) against the reference's, on
CPU tensors.

The tilizer's arrays and the RCM permutation must be bitwise the
reference's on the same scipy matrix, by the native and by the numpy route.
The apply is held against the Pallas ``tiled_spmm_t`` in interpret mode
(f32 and bf16 tiles, max relative error 1e-5: the summation order differs)
and against scipy in f64 (1e-12). On the CPU the wrapper runs its plain
version; the CUDA kernel is held against that on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py). The kernel's host
schedule (``spmm_tiled.tiled_plan``) is held to its rules here, and a numpy
walk of that schedule (blocks, their row tiles, slices of J columns, the
resets) against the plain version in f64.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp
import torch

from blockcg_tpu import native as jnative
from blockcg_tpu import solve_sbcgrq as jsolve_sbcgrq
from blockcg_tpu.operators import TiledOperator as JTiledOperator
from blockcg_tpu.ops.spmm_tiled import tiled_spmm_t as jtiled_spmm_t
from blockcg_tpu.problems import delaunay_laplacian as jdelaunay_laplacian
from blockcg_tpu_torch import native, solve_refined, solve_sbcgrq
from blockcg_tpu_torch.operators import CSROperator, TiledOperator
from blockcg_tpu_torch.ops import spmm_tiled
from blockcg_tpu_torch.problems import delaunay_laplacian, rgg_laplacian


def _random_sparse_spd(n, density, seed):
    a = sp.random(n, n, density=density, random_state=seed, format="csr")
    a = a + a.T + sp.eye(n) * (abs(a).sum(axis=1).max() + 1.0)
    return sp.csr_matrix(a)


def _block(n, k, seed):
    return np.random.default_rng(seed).standard_normal((n, k))


@pytest.fixture(scope="module")
def mesh():
    """A Delaunay mesh Laplacian (n = 2000, padded to 2048 under RCM)."""
    return delaunay_laplacian(2000, seed=1)


def test_unstructured_generators_are_the_references():
    from blockcg_tpu.problems import (
        random_regular_spd as jrr,
        rgg_laplacian as jrgg,
        uniform_random_spd as jur,
    )
    from blockcg_tpu_torch.problems import random_regular_spd, uniform_random_spd

    for mine, ref in ((delaunay_laplacian(700, seed=3), jdelaunay_laplacian(700, seed=3)),
                      (rgg_laplacian(900, 12.0, seed=4), jrgg(900, 12.0, seed=4)),
                      (uniform_random_spd(800, 6.0, seed=5), jur(800, 6.0, seed=5)),
                      (random_regular_spd(600, 8, seed=6), jrr(600, 8, seed=6))):
        assert (mine != ref).nnz == 0 and mine.shape == ref.shape


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_tilizer_is_bitwise_the_references(route):
    a = _random_sparse_spd(700, 0.01, 0)
    force = route == "numpy"
    if not force and not (native.have_native() and jnative.have_native()):
        pytest.skip("no g++ on this host")
    for got, want in zip(native.tilize_csr(a, 128, force_numpy=force),
                         jnative.tilize_csr(a, 128, force_numpy=force)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_native_tilizer_builds_into_the_ports_build_dir():
    if not native.have_native():
        pytest.skip("no g++ on this host")
    path = native.library_path()
    assert path.is_file() and path.parent.name == "blockcg_tpu_torch"
    assert path.parent.parent.name == "build"


@pytest.mark.parametrize("force_numpy", [False, True])
def test_rcm_operator_is_bitwise_the_references(mesh, force_numpy):
    """Tiles, rt, ct, first and the RCM perm of ``from_scipy(reorder="rcm")``
    equal the reference's; n0, n and the logical nnz too."""
    op = TiledOperator.from_scipy(mesh, torch.float32, reorder="rcm",
                                  force_numpy=force_numpy, device="cpu")
    ref = JTiledOperator.from_scipy(mesh, dtype=jnp.float32, reorder="rcm",
                                    force_numpy=force_numpy)
    for name in ("tiles", "rt", "ct", "first", "perm"):
        assert np.array_equal(getattr(op, name).numpy(), np.asarray(getattr(ref, name))), name
    assert (op.n, op.n0, op.nnz, op.ntiles) == (ref.n, ref.n0, ref.nnz, ref.ntiles)
    assert op.fill == pytest.approx(ref.fill, rel=1e-15)


@pytest.mark.parametrize("tile_dtype", [torch.float32, torch.bfloat16])
def test_matmat_t_matches_pallas_interpret(mesh, tile_dtype):
    """f32 and bf16 tile storage against the Pallas kernel in interpret mode,
    on the same stored tiles (the bf16 ones bitwise equal), max relative
    error 1e-5; then the public matmat with the order hooks."""
    jdt = jnp.float32 if tile_dtype == torch.float32 else jnp.bfloat16
    op = TiledOperator.from_scipy(mesh, torch.float32, reorder="rcm", tile_dtype=tile_dtype,
                                  device="cpu")
    ref = JTiledOperator.from_scipy(mesh, dtype=jnp.float32, reorder="rcm", tile_dtype=jdt)
    got_tiles = op.tiles.float().numpy()
    assert op.tiles.dtype == tile_dtype and op.dtype == torch.float32
    assert np.array_equal(got_tiles, np.asarray(ref.tiles, np.float32))
    X = _block(op.n, 5, 2).astype(np.float32)
    Y = op.matmat_t(torch.from_numpy(X.T.copy())).numpy()
    want = np.asarray(jtiled_spmm_t(ref.tiles, ref.rt, ref.ct, ref.first, jnp.asarray(X.T),
                                    interpret=True))
    assert np.abs(Y - want).max() / np.abs(want).max() < 1e-5
    B = torch.from_numpy(_block(2000, 3, 3).astype(np.float32))
    out = op.from_solver_order(op.matmat(op.to_solver_order(B)))
    exact = mesh @ B.double().numpy()
    tol = 1e-5 if tile_dtype == torch.float32 else 1e-2  # bf16 rounds the entries
    assert np.abs(out.double().numpy() - exact).max() / np.abs(exact).max() < tol


def test_f64_apply_matches_scipy():
    for a in (_random_sparse_spd(384, 0.03, 5), _random_sparse_spd(640, 0.01, 6)):
        op = TiledOperator.from_scipy(a, torch.float64, device="cpu")
        X = _block(op.n, 4, 7)
        want = sp.block_diag([a, sp.eye(op.n - a.shape[0])]) @ X if op.n != a.shape[0] else a @ X
        got = op.matmat(torch.from_numpy(X)).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
        op32 = op.astype_op(torch.float32)
        assert op32.tiles.dtype == torch.float32 and op32.perm is None


def test_plain_spmm_honours_the_tile_contract():
    """The plain version on hand-made tiles: two row tiles, the second with
    two tiles, against a dense product."""
    rng = np.random.default_rng(8)
    tiles = torch.from_numpy(rng.standard_normal((3, 128, 128)))
    rt = torch.tensor([0, 1, 1], dtype=torch.int32)
    ct = torch.tensor([1, 0, 1], dtype=torch.int32)
    X = torch.from_numpy(rng.standard_normal((2, 256)))
    A = torch.zeros((256, 256), dtype=torch.float64)
    A[:128, 128:] = tiles[0]
    A[128:, :128] = tiles[1]
    A[128:, 128:] = tiles[2]
    Y = spmm_tiled.tiled_spmm_t(tiles, rt, ct, torch.tensor([1, 1, 0], dtype=torch.int32), X)
    torch.testing.assert_close(Y, X @ A.T, rtol=1e-12, atol=1e-12)
    assert spmm_tiled.row_pointers(rt, 2).tolist() == [0, 1, 3]


def test_f64_sbcgrq_through_rcm_tiles_matches_the_reference(mesh):
    """solve_sbcgrq in f64 on the RCM tile operator: the reference's
    iteration count, X within 1e-9."""
    op = TiledOperator.from_scipy(mesh, torch.float64, reorder="rcm", device="cpu")
    ref = JTiledOperator.from_scipy(mesh, dtype=jnp.float64, reorder="rcm")
    B = _block(2000, 4, 9)
    X, info = solve_sbcgrq(op, op.to_solver_order(torch.from_numpy(B)), tol=1e-10,
                           max_iter=2000)
    Xr, ir = jsolve_sbcgrq(ref, ref.to_solver_order(jnp.asarray(B)), tol=1e-10, max_iter=2000)
    assert bool(info.converged.all()) and info.iterations == int(ir.iterations)
    Xo = op.from_solver_order(X).numpy()
    Xro = np.asarray(ref.from_solver_order(Xr))
    assert np.abs(Xo - Xro).max() <= 1e-9 * np.abs(Xro).max()
    res = np.linalg.norm(mesh @ Xo - B, axis=0) / np.linalg.norm(B, axis=0)
    assert res.max() <= 1e-9


def test_bf16_tiles_refined_to_1e10(mesh):
    """RCM and bf16 tiles with the f64 CSR outer operator in internal order:
    solve_refined reaches a true 1e-10."""
    op = TiledOperator.from_scipy(mesh, torch.float32, reorder="rcm",
                                  tile_dtype=torch.bfloat16, device="cpu")
    op64 = CSROperator.from_scipy(op.reordered_scipy(mesh), torch.float64, device="cpu")
    B = _block(2000, 4, 10).astype(np.float32)
    X, info = solve_refined(op, op.to_solver_order(torch.from_numpy(B)), tol=1e-10,
                            op64=op64)
    Xo = op.from_solver_order(X).double().numpy()
    res = np.linalg.norm(mesh @ Xo - B, axis=0) / np.linalg.norm(B, axis=0)
    assert bool(info.converged.all()) and res.max() <= 1e-10


def _skewed_row_ptr(nrt, seed):
    """Row pointers of a skewed synthetic tile set: most row tiles hold 1-20
    tiles, a few hold 60-200, some none."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 21, size=nrt)
    counts[rng.choice(nrt, nrt // 50, replace=False)] = rng.integers(60, 201, size=nrt // 50)
    counts[rng.choice(nrt, nrt // 100, replace=False)] = 0
    return torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32)


H100_SMS = 132
H100_SMEM = 232448  # bytes of shared memory one block may opt into on an H100


@pytest.mark.parametrize("k", [1, 3, 8, 16, 32, 64, 96, 128])
@pytest.mark.parametrize("tile_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sms", [H100_SMS, 8])
def test_tiled_plan_follows_its_rules(k, tile_dtype, sms):
    """The row tiles cut into one contiguous range a block, in storage
    order, covering them all; the busiest block the least busiest of any
    contiguous cut, within one row tile of the mean; k = 96 runs 12 warps
    of 8 rows, not 16; the shared bytes fit the H100's cap at the blocks an
    SM claimed; the grid fills ``sms`` SMs (an H100's, and a small card)."""
    rp = _skewed_row_ptr(4096, k)
    plan = spmm_tiled.tiled_plan(rp, k, "cpu", tile_dtype, sms=sms, cap=H100_SMEM)
    nrt = len(rp) - 1
    bptr = plan.bptr.numpy()
    assert bptr[0] == 0 and bptr[-1] == nrt
    assert len(bptr) == plan.grid + 1 and np.all(np.diff(bptr) >= 0)
    counts = np.diff(rp.numpy())
    per = [int(counts[a:b].sum()) for a, b in zip(bptr[:-1], bptr[1:])]
    assert max(per) == plan.busiest and plan.mean == pytest.approx(counts.sum() / plan.grid)
    assert plan.busiest < plan.mean + counts.max()
    assert spmm_tiled._cuts(rp.numpy().astype(np.int64), plan.grid, plan.busiest - 1) is None
    assert plan.R == spmm_tiled.rows_per_warp(k) and (plan.R, plan.J) in spmm_tiled.BUILT
    assert plan.threads == 32 * -(-k // plan.R) <= spmm_tiled.MAX_THREADS
    if k == 96:
        assert plan.threads == 384
    nbytes = torch.finfo(tile_dtype).bits // 8
    assert plan.smem_bytes == plan.stages * spmm_tiled.stage_bytes(plan.J, plan.threads // 32 *
                                                                   plan.R, nbytes)
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= H100_SMEM + 1024
    assert plan.grid == min(sms * plan.blocks_per_sm, nrt)


def test_tiled_plan_off_the_card_needs_the_cards_numbers():
    rp = _skewed_row_ptr(64, 0)
    with pytest.raises(ValueError, match="sms and cap"):
        spmm_tiled.tiled_plan(rp, 32, "cpu")
    with pytest.raises(ValueError, match="sms and cap"):
        spmm_tiled.tiled_plan(rp, 32, "cpu", sms=H100_SMS)


def _walk(plan, row_ptr, first, ct, tiles, X):
    """The kernel's schedule in numpy: each block's row tiles in order, each
    tile's slices of J columns in order, the sum reset at a row tile's first
    tile and wherever ``first`` is set, Y written at the row tile's end."""
    k, n = X.shape
    Y = np.full((k, n), np.nan)
    bptr = plan.bptr.numpy()
    for b in range(plan.grid):
        for rt in range(bptr[b], bptr[b + 1]):
            t0, t1 = row_ptr[rt], row_ptr[rt + 1]
            acc = np.zeros((k, 128))
            for t in range(t0, t1):
                for j0 in range(0, 128, plan.J):
                    if j0 == 0 and (t == t0 or first[t]):
                        acc[:] = 0
                    c0 = ct[t] * 128 + j0
                    acc += X[:, c0:c0 + plan.J] @ tiles[t][:, j0:j0 + plan.J].T
            Y[:, rt * 128:(rt + 1) * 128] = acc
    return Y


@pytest.mark.parametrize("J,R,k", [(32, None, 32), (16, None, 5), (16, None, 9), (32, 4, 1),
                                   (32, 4, 12)])
def test_tiled_schedule_walk_matches_plain(J, R, k):
    """A numpy walk of the plan's schedule (a small grid: 4 SMs) on a tile
    set with an empty row tile, a row tile of one tile and a ``first`` reset
    inside a row tile's run, against ``tiled_spmm_plain`` in f64 on the
    tiles the resets keep: max relative error 1e-6."""
    rng = np.random.default_rng(J + k)
    nrt = 24
    counts = rng.integers(1, 7, size=nrt)
    counts[3], counts[7], counts[11] = 0, 1, 5
    rt = np.repeat(np.arange(nrt), counts).astype(np.int32)
    ct = np.concatenate([np.sort(rng.choice(nrt, c, replace=False)) for c in counts])
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    first = np.zeros(len(rt), np.int32)
    first[row_ptr[:-1][counts > 0]] = 1
    first[row_ptr[11] + 2] = 1  # restart row tile 11's sum at its third tile
    tiles = rng.standard_normal((len(rt), 128, 128))
    X = rng.standard_normal((k, nrt * 128))
    plan = spmm_tiled.tiled_plan(torch.from_numpy(row_ptr.astype(np.int32)), k, "cpu",
                                 J=J, R=R, sms=4, cap=H100_SMEM)
    assert plan.grid == min(4 * plan.blocks_per_sm, nrt)
    got = _walk(plan, row_ptr, first, ct, tiles, X)
    keep = np.ones(len(rt), bool)
    keep[row_ptr[11]:row_ptr[11] + 2] = False  # the tiles the reset drops
    want = spmm_tiled.tiled_spmm_plain(torch.from_numpy(tiles[keep]),
                                       torch.from_numpy(rt[keep]),
                                       torch.from_numpy(ct[keep].astype(np.int32)),
                                       torch.from_numpy(X)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6
    assert np.all(got[:, 3 * 128:4 * 128] == 0)
