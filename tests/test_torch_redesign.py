"""Host-side plans of the redesigned kernels, on the CPU.

``csrc/stencil.cu`` stages a window of X in shared memory and reads the
diagonals near the tile from it; ``ops/stencil.py`` ``stencil_plan`` picks the
window's halo h and the tile width T from the offsets, the launch's rows and
the card's shared-memory cap. ``csrc/mm_update.cu`` is one launch up to 128
rows; ``ops/fused.py`` ``mm_update_plan`` says when a field runs it and when
it is written in place. The kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py); here the plans are held to their rules,
and a numpy emulation of the kernel's windowed schedule is held against the
f64 oracle. ``csrc/update_gram.cuh`` (rows 7 and 8: ``mm_update_gram``,
``mm2_update_gram``) and ``csrc/px_update.cu`` stream stages of their
stacked inputs; ``mm_update_gram_plan``, ``mm2_update_gram_plan`` and
``px_update_plan`` pick the row chunks and stage depth under the card's
shared-memory cap. The plain routes of ``mm_update``, ``mm_update_gram``,
``mm2_update_gram`` and ``px_update`` at m = 96 are held against the
reference's Pallas kernels in interpret mode (max relative error 1e-5,
f32).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockcg_tpu.ops import fused as jfused
from blockcg_tpu_torch.ops import _native, fused, spmm_tiled, stencil

H100_SMEM = 232448  # bytes of shared memory one block may opt into on an H100
H100_SMS = 132
CSRC = Path(__file__).resolve().parents[1] / "blockcg_tpu_torch" / "csrc"


def _lap_offsets(shape):
    """The 7- or 5-point Laplacian's offsets on a row-major grid."""
    strides = [int(np.prod(shape[i + 1:])) for i in range(len(shape))]
    return (0,) + tuple(o for s in strides for o in (s, -s))


_PRESETS = {
    "lap_128^3": (128 ** 3, _lap_offsets((128, 128, 128))),
    "lap_64^3": (64 ** 3, _lap_offsets((64, 64, 64))),
    "lap_512^2": (512 ** 2, _lap_offsets((512, 512))),
    "lap_128^2": (128 ** 2, _lap_offsets((128, 128))),
    "near_n": (5000, (0, 4999, -4998, 2500, 1, 4990)),
}


def _far_count(offsets, n, h):
    return sum(min(o % n, n - o % n) > h for o in offsets)


@pytest.mark.parametrize("k", [1, 8, 32, 48, 64, 96])
@pytest.mark.parametrize("preset", sorted(_PRESETS))
@pytest.mark.parametrize("with_gram", [False, True])
def test_stencil_plan_fits_and_splits_the_offsets(preset, k, with_gram):
    """Every launch of the field (48-row chunks at k = 96) gets a halo that
    is a multiple of 4, a tile of one column a thread, shared memory within
    the cap (as the kernel counts it) and blocks an SM that it holds, the
    near/far split of the kernel's rule, and less L2 traffic than one read
    of X per diagonal."""
    n, offsets = _PRESETS[preset]
    for r0, r1 in _native.row_chunks(k):
        kc = r1 - r0
        plan = stencil.stencil_plan(offsets, n, kc, with_gram, H100_SMEM, H100_SMS)
        assert plan.h % 4 == 0 and plan.T in stencil.TILES
        assert plan.smem_bytes == stencil.smem_bytes(kc, len(offsets), plan.h, plan.T, with_gram)
        assert plan.smem_bytes <= H100_SMEM
        assert 1 <= plan.blocks_per_sm <= (2 if kc <= 32 and not with_gram else 1)
        assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= H100_SMEM + 1024
        assert plan.near == tuple(min(o % n, n - o % n) <= plan.h for o in offsets)
        assert plan.traffic == pytest.approx(
            (plan.T + 2 * plan.h) / plan.T + _far_count(offsets, n, plan.h))
        assert plan.traffic < len(offsets)
        assert plan.T <= max(128, n // H100_SMS)


@pytest.mark.parametrize("k,with_gram,h,T,near,blocks", [
    (32, False, 4, 256, 3, 2),   # 0, +-1 from the window, two blocks an SM
    (32, True, 128, 256, 5, 1),  # one block an SM with the Gram: the widest halo
    (1, False, 128, 256, 5, 2),  # small rows: +-128 fits beside two blocks
    (48, False, 128, 256, 5, 1), # one block an SM at KMAX = 64: the widest halo
    (64, True, 4, 256, 3, 1),    # no room for a 128-column halo beside 64 rows and Y
])
def test_stencil_plan_of_the_north_star(k, with_gram, h, T, near, blocks):
    plan = stencil.stencil_plan(_PRESETS["lap_128^3"][1], 128 ** 3, k, with_gram,
                                H100_SMEM, H100_SMS)
    assert (plan.h, plan.T, sum(plan.near), plan.blocks_per_sm) == (h, T, near, blocks)


def test_stencil_plan_at_64_cubed_and_small_fields():
    plan = stencil.stencil_plan(_PRESETS["lap_64^3"][1], 64 ** 3, 32, False, H100_SMEM, H100_SMS)
    assert plan.h == 64 and sum(plan.near) == 5 and plan.blocks_per_sm == 2
    # A field of 1000 columns still makes tiles of at least 128.
    plan = stencil.stencil_plan((0, 1, -1), 1000, 5, True, H100_SMEM, H100_SMS)
    assert plan.T == 128 and all(plan.near)
    # All offsets far from the tile: no halo at all.
    plan = stencil.stencil_plan((3000, -3000, 7777), 65536, 8, False, H100_SMEM, H100_SMS)
    assert plan.h == 0 and not any(plan.near)


def test_stencil_plan_refuses_a_cap_with_no_room():
    with pytest.raises(ValueError, match="no tile"):
        stencil.stencil_plan((0, 1, -1), 4096, 64, True, 16 * 1024, H100_SMS)
    with pytest.raises(ValueError, match="no tile"):
        stencil.stencil_plan((0, 1, -1), 4096, 64, False, 128 * 64 * 4, H100_SMS)


def _windowed_apply(diags, offsets, X, plan):
    """The kernel's schedule in numpy (f64): per tile of T columns, a window
    X[:, (i0 - h + v) mod n], v < T + 2h; near diagonals read it at h + s +
    c (s the signed offset), far ones read X at (i + o) mod n."""
    k, n = X.shape
    Y = np.zeros((k, n))
    for i0 in range(0, n, plan.T):
        cols = np.arange(i0, min(i0 + plan.T, n))
        window = X[:, (i0 - plan.h + np.arange(plan.T + 2 * plan.h)) % n]
        for d, o in enumerate(offsets):
            o %= n
            if plan.near[d]:
                s = o if o <= plan.h else o - n
                src = window[:, plan.h + s + (cols - i0)]
            else:
                src = X[:, (cols + o) % n]
            Y[:, cols] += diags[d, cols] * src
    return Y


@pytest.mark.parametrize("n,offsets,cap,sms", [
    (1000, (-130, -7, -1, 0, 2, 64, 257), H100_SMEM, 4),       # ragged last tile
    (4099, (-5, -1, 0, 1, 3), H100_SMEM, 8),                   # all near
    (4096, (4095, 1, -4, 4092, 2048), 64 * 1024, 2),           # windows wrap at 0 and n
    (300, (0, 149, -150, 1), H100_SMEM, 1),                    # window wider than n
])
def test_windowed_schedule_matches_the_oracle(n, offsets, cap, sms):
    k = 3
    plan = stencil.stencil_plan(offsets, n, k, True, cap, sms)
    rng = np.random.default_rng(n)
    diags, X = rng.standard_normal((len(offsets), n)), rng.standard_normal((k, n))
    want = np.zeros((k, n))
    for d, o in enumerate(offsets):
        want += diags[d] * X[:, (np.arange(n) + o) % n]
    np.testing.assert_allclose(_windowed_apply(diags, offsets, X, plan), want, rtol=0,
                               atol=1e-12)
    Y = stencil.stencil_spmm_t(torch.from_numpy(diags), offsets, torch.from_numpy(X))
    np.testing.assert_allclose(Y.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("k", [1, 32, 64, 96, 128])
@pytest.mark.parametrize("donate", [None, "a", "b"])
def test_mm_update_is_one_launch_in_place_up_to_128_rows(k, donate):
    assert fused.mm_update_plan(k, donate, torch.device("cpu")) == ([(0, k)], True)


@pytest.mark.parametrize("k", [129, 400, 800])
def test_mm_update_wider_than_128_rows_runs_the_chunks(monkeypatch, k):
    """Above 128 rows ``mm_update`` runs the row chunks of
    ``mm_update_gram_plan`` (its kernel without the Gram); a donated B then
    waits for the last chunk, a donated A does not."""
    monkeypatch.setattr(_native, "max_smem", lambda index: H100_SMEM)
    chunks = fused.mm_update_gram_plan(k, torch.device("cpu")).chunks
    assert len(chunks) > 1
    assert fused.mm_update_plan(k, "b", torch.device("cpu")) == (chunks, False)
    assert fused.mm_update_plan(k, "a", torch.device("cpu")) == (chunks, True)


@pytest.mark.parametrize("with_a", [False, True])
@pytest.mark.parametrize("donate", [False, True])
def test_mm_update_gram_at_m96_matches_pallas(with_a, donate):
    """Row 7 on the plain route at m = 96 (one launch of Y on the card, its
    Gram from ``gram``) against the Pallas kernel in interpret mode."""
    k, n = 96, 512
    rng = np.random.default_rng(97)
    M = (rng.standard_normal((k, k)) / k ** 0.5).astype(np.float32)
    B, A = (rng.standard_normal((k, n)).astype(np.float32) for _ in range(2))
    want = [np.asarray(a) for a in jfused.mm_update_gram(
        jnp.asarray(M), jnp.asarray(B), jnp.asarray(A) if with_a else None, interpret=True)]
    Bt = torch.from_numpy(B.copy())
    Y, G = fused.mm_update_gram(torch.from_numpy(M), Bt,
                                torch.from_numpy(A) if with_a else None, donate=donate)
    assert (Y.data_ptr() == Bt.data_ptr()) is donate
    for got, w in zip((Y, G), want):
        err = np.abs(got.numpy().astype(np.float64) - w).max() / np.abs(w).max()
        assert err < 1e-5, err


@pytest.mark.parametrize("with_a", [False, True])
@pytest.mark.parametrize("donate", [None, "b"])
def test_mm_update_at_m96_matches_pallas(with_a, donate):
    k, n = 96, 512
    rng = np.random.default_rng(96)
    M = (rng.standard_normal((k, k)) / k ** 0.5).astype(np.float32)
    B, A = (rng.standard_normal((k, n)).astype(np.float32) for _ in range(2))
    want = np.asarray(jfused.mm_update(jnp.asarray(M), jnp.asarray(B),
                                       jnp.asarray(A) if with_a else None, interpret=True))
    Bt = torch.from_numpy(B.copy())
    Y = fused.mm_update(torch.from_numpy(M), Bt, torch.from_numpy(A) if with_a else None,
                        donate=donate)
    assert (Y.data_ptr() == Bt.data_ptr()) is (donate == "b")
    err = np.abs(Y.numpy().astype(np.float64) - want).max() / np.abs(want).max()
    assert err < 1e-5, err


# name -> (plan, stacked input fields, coefficient tables, rows of a fused Gram)
_PLANS = {"mm_update_gram": (fused.mm_update_gram_plan, 1, 1, fused.UPDATE_GRAM_MAX_K_ONE),
          "mm2_update_gram": (fused.mm2_update_gram_plan, 2, 2, fused.UPDATE_GRAM_MAX_K),
          "px_update": (fused.px_update_plan, 2, 3, 0)}


@pytest.mark.parametrize("k", [1, 32, 48, 96, 400, 800])
@pytest.mark.parametrize("name", sorted(_PLANS))
def test_update_plans_follow_their_rules(monkeypatch, name, k):
    """Up to 96 rows one launch (written in place); wider, row chunks of at
    most 64 rows that cover the field, each contracting over all of it; the
    stages split the stacked rows (k a field) evenly, at least 32 rows deep
    (or all of them); the shared memory (as the kernel counts it) fits the
    H100's cap for the blocks an SM the plan claims; the fused Gram on a
    field of up to 64 rows (96 on row 7's one input field)."""
    monkeypatch.setattr(_native, "max_smem", lambda index: H100_SMEM)
    make, nfield, nmat, gram_rows = _PLANS[name]
    plan = make(k, torch.device("cpu"))
    assert plan.T == fused.UPDATE_TILE == 128
    assert plan.chunks[0][0] == 0 and plan.chunks[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(plan.chunks, plan.chunks[1:]))
    kout = max(r1 - r0 for r0, r1 in plan.chunks)
    assert (len(plan.chunks) == 1) is (k <= 96) and plan.in_place is (k <= 96)
    assert kout <= (fused.UPDATE_MAX_K if k <= 96 else 64)
    assert plan.fused_gram is (k <= gram_rows)
    nin = nfield * k
    assert min(nin, fused.UPDATE_MIN_KC) <= plan.kc <= nin
    stages = -(-nin // plan.kc)
    assert plan.kc == -(-nin // stages)
    assert plan.smem_bytes == fused.update_smem_bytes(kout, k, plan.kc, nmat, plan.fused_gram)
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= H100_SMEM + 1024
    assert plan.blocks_per_sm <= fused._blocks_per_sm(kout, nmat, plan.fused_gram)


@pytest.mark.parametrize("name,k,kc,blocks,smem", [
    ("mm2_update_gram", 32, 64, 2, 91136),   # one stage a tile, two blocks an SM
    ("px_update", 32, 64, 2, 77824),
    ("mm2_update_gram", 48, 96, 1, 142848),  # 64-row Gram tiles: one block an SM
    ("px_update", 48, 48, 2, 76800),         # two stages a tile leave room for two blocks
    ("mm2_update_gram", 96, 96, 1, 172032),  # Y alone, its Gram from gram.cu
    ("px_update", 96, 96, 1, 208896),        # M1, rho and C take 108 KB
    ("mm_update_gram", 32, 32, 2, 54272),    # row 7: one input, one stage a tile
    ("mm_update_gram", 48, 48, 1, 84480),    # 64-row Gram tiles: one block an SM
    ("mm_update_gram", 96, 96, 1, 187392),   # one launch with the Gram: SymGram at 96 rows
    ("mm_update_gram", 128, 128, 1, 196608),  # Y alone, its Gram from gram.cu
])
def test_update_plans_of_the_main_paths(monkeypatch, name, k, kc, blocks, smem):
    monkeypatch.setattr(_native, "max_smem", lambda index: H100_SMEM)
    plan = _PLANS[name][0](k, torch.device("cpu"))
    assert (plan.chunks, plan.kc, plan.blocks_per_sm, plan.smem_bytes) == ([(0, k)], kc, blocks,
                                                                           smem)


@pytest.mark.parametrize("name,widest", [("mm_update_gram", 7232), ("mm2_update_gram", 3616),
                                          ("px_update", 2410)])
def test_update_plans_refuse_a_cap_with_no_room(monkeypatch, name, widest):
    """The widest field runs 8-row chunks on whatever stage depth fits; one
    row more, or a small cap, leaves no room and raises."""
    monkeypatch.setattr(_native, "max_smem", lambda index: H100_SMEM)
    plan = _PLANS[name][0](widest, torch.device("cpu"))
    assert max(r1 - r0 for r0, r1 in plan.chunks) <= 8 and plan.kc >= 1
    with pytest.raises(ValueError, match="no room"):
        _PLANS[name][0](widest + 1, torch.device("cpu"))
    monkeypatch.setattr(_native, "max_smem", lambda index: 16 * 1024)
    with pytest.raises(ValueError, match="no room"):  # row 7's one table: 8-row chunks fit at 400
        _PLANS[name][0](800 if name == "mm_update_gram" else 400, torch.device("cpu"))


@pytest.mark.parametrize("S", [2, 4, 8])
def test_symmetric_gram_tiles_cover_every_entry(S):
    """``SymGram`` (csrc/common.cuh) in numpy: thread pairs p = 0..S(S+1)/2-1
    decode to tile positions rb <= cb; tile (rb, cb) holds rows rb + S a by
    columns cb + S b; store() reads entry (r, s) from its own tile or, below
    the diagonal, from the mirror tile. Every entry of G = Y Y^T comes out
    right, and G is exactly symmetric."""
    TS = 4
    k = S * TS - 1  # one padded row: clamped to k - 1, never stored
    Y = np.random.default_rng(S).standard_normal((k, 24))
    tiles = {}
    for pair in range(S * (S + 1) // 2):
        p, r = pair, 0
        while p >= S - r:
            p -= S - r
            r += 1
        rb, cb = r, r + p
        rows = [min(rb + S * a, k - 1) for a in range(TS)]
        cols = [min(cb + S * b, k - 1) for b in range(TS)]
        tiles[pair] = Y[rows] @ Y[cols].T
    G = np.empty((k, k))
    for r in range(k):
        for s_ in range(k):
            pr, ps, a, b = r % S, s_ % S, r // S, s_ // S
            if pr > ps:
                pr, ps, a, b = ps, pr, b, a
            G[r, s_] = tiles[pr * S - pr * (pr - 1) // 2 + ps - pr][a, b]
    np.testing.assert_allclose(G, Y @ Y.T, rtol=1e-12, atol=1e-12)
    assert np.array_equal(G, G.T)


@pytest.mark.parametrize("donate", [False, True])
def test_rows89_at_m96_match_pallas(donate):
    """``mm2_update_gram`` and ``px_update`` on the plain route at m = 96
    against the reference's Pallas kernels in interpret mode."""
    k, n = 96, 512
    rng = np.random.default_rng(960)
    M1, M2, M3 = ((rng.standard_normal((k, k)) / k ** 0.5).astype(np.float32) for _ in range(3))
    W, P, X = (rng.standard_normal((k, n)).astype(np.float32) for _ in range(3))
    j = [jnp.asarray(a) for a in (M1, W, M2, P, M3, X)]
    want = [np.asarray(a) for a in (*jfused.mm2_update_gram(*j[:4], interpret=True),
                                    *jfused.px_update(*j, interpret=True))]
    t = [torch.from_numpy(a.copy()) for a in (M1, W, M2, P, M3, X)]
    Y, G = fused.mm2_update_gram(t[0], t[1], t[2], t[3], donate=donate)
    assert (Y.data_ptr() == t[1].data_ptr()) is donate
    W2, P2, X2 = (torch.from_numpy(a.copy()) for a in (W, P, X))
    Pn, Xn = fused.px_update(t[0], W2, t[2], P2, t[4], X2, donate=donate)
    assert (Pn.data_ptr() == P2.data_ptr()) is donate and (Xn.data_ptr() == X2.data_ptr()) is donate
    for got, w in zip((Y, G, Pn, Xn), want):
        err = np.abs(got.numpy().astype(np.float64) - w).max() / np.abs(w).max()
        assert err < 1e-5, err


def test_host_constants_mirror_the_sources():
    """The wrappers' widths and budget formula are the kernels' own."""
    mm = (CSRC / "mm_update.cu").read_text()
    assert int(re.search(r"kMmMaxK = (\d+)", mm).group(1)) == fused.MM_UPDATE_MAX_K
    common = (CSRC / "common.cuh").read_text()
    assert int(re.search(r"kUpTile = (\d+)", common).group(1)) == fused.UPDATE_TILE
    assert int(re.search(r"kUpStages = (\d+)", common).group(1)) == fused.UPDATE_STAGES
    assert "kUpLd = kUpTile + 8;" in common and fused.UPDATE_LD == fused.UPDATE_TILE + 8
    assert "widths[] = {1, 2, 4, 6, 8, 12, 16};" in common
    assert fused._UPDATE_WIDTHS == (1, 2, 4, 6, 8, 12, 16)
    assert ("nmat * kin * rp + 1LL * kUpStages * kc * kUpTile + (gram ? 1LL * k * kUpLd : 0)"
            in common)
    assert "1LL * kUpThreads * (k > 32 ? 64 : 16)" in common
    ug = (CSRC / "update_gram.cuh").read_text()
    assert "kUgBlocksPerSm = GK > 0 && GK <= 32 ? 2 : 1;" in ug
    assert "update_smem_floats(k, kin, kc, NF, GK > 0)" in ug
    assert "return dispatch<2, false>(" in (CSRC / "mm2_update_gram.cu").read_text()
    mm1 = (CSRC / "mm_update_gram.cu").read_text()
    assert "dispatch<1, true>(" in mm1 and "dispatch<1, false>(" in mm1
    assert "if constexpr (NF == 1) BCG_UG(12, 96);" in ug and fused.UPDATE_GRAM_MAX_K_ONE == 96
    assert "BCG_UG(16, 128)" not in ug
    assert "      case 8: BCG_UG(8, 64);" in ug and fused.UPDATE_GRAM_MAX_K == 64
    px = (CSRC / "px_update.cu").read_text()
    assert "kPxBlocksPerSm = R <= 8 ? 2 : 1;" in px
    assert "update_smem_floats(k, kin, kc, 3, false)" in px
    st = (CSRC / "stencil.cu").read_text()
    assert int(re.search(r"kMaxDiags = (\d+)", st).group(1)) == stencil.MAX_DIAGS
    assert "return T + 2 * h + (k <= 32 ? 4 : 0);" in st
    assert "256LL * (k > 16 ? 64 : 16)" in st
    assert "kStBlocksPerSm = !WITH_GRAM && KMAX <= 32 ? 2 : 1" in st
    assert int(re.search(r"kStThreads = (\d+)", st).group(1)) == stencil.THREADS
    ts = (CSRC / "spmm_tiled.cu").read_text()
    assert int(re.search(r"kMaxThreads = (\d+)", ts).group(1)) == spmm_tiled.MAX_THREADS
    assert int(re.search(r"kCols = (\d+)", ts).group(1)) == spmm_tiled.COLS
    assert int(re.search(r"kT = (\d+)", ts).group(1)) == spmm_tiled.T
    assert "a_pitch(int J, int tb) { return J + 16 / tb; }" in ts
    assert "return kT * a_pitch(J, tb) * tb + kp * J * 4;" in ts
    built = tuple((int(r), int(j)) for r, j in re.findall(r"BCG_TS\((\d+), (\d+)\);", ts))
    assert built == spmm_tiled.BUILT
    assert "stages < 2 || stages > 4" in ts


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["dia_csr", "cbdia_merged", "cbdia_view", "bdia_view"])
def test_smoke_library_calls_compute_the_kernels_function(case):
    """``chip_smoke.py``'s library yardsticks (a torch CSR or BSR tensor of
    the operator times the dense field) compute the wrapper's function: the
    check inside them passes on the plain route's output."""
    from blockcg_tpu_torch.ops import block_stencil as bsk
    from blockcg_tpu_torch.ops import const_block_stencil as cbs
    from blockcg_tpu_torch.problems import dirac_cbdia, laplacian_dia

    smoke = _smoke()
    torch.manual_seed(0)
    if case == "dia_csr":
        op = laplacian_dia((8, 8, 8), device="cpu")
        X = torch.randn(5, op.n)
        call, why = smoke._dia_csr_library(torch, op.diags, op.offsets, X,
                                           stencil.stencil_spmm_t(op.diags, op.offsets, X))
    else:
        op = dirac_cbdia(4, device="cpu")
        main = (op.hops_main, op.main_offsets, op.main_slots, op.masks_main)
        blocks = smoke._const_hop_blocks(torch, *main[:1], op.main_slots, op.masks_main, op.ns)
        X = torch.randn(3, op.bs, op.ns) if case != "cbdia_merged" else torch.randn(
            3 * op.bs, op.ns)
        Y = {"cbdia_merged": lambda: cbs.const_block_stencil_spmm_m_t(*main, X),
             "cbdia_view": lambda: cbs.const_block_stencil_spmm_t(*main, X),
             "bdia_view": lambda: bsk.block_stencil_spmm_t(blocks, op.main_offsets, X)}[case]()
        call, why = smoke._site_bsr_library(torch, blocks, op.main_offsets, X, Y)
    assert why is None and call is not None
