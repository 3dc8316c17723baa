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
f32). ``csrc/gram.cu`` streams tiles of [U; V] on ``gram_plan``'s column
tile, one launch up to 96 rows, wider Grams laid out by ``gram_blocks``;
``csrc/block_stencil.cu`` runs ``block_stencil_plan``'s schedule (a window
of X around a tile of sites, the split of a site's outputs over threads, a
ring of per-diagonal stages), held here in a numpy emulation against the
f64 oracle.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockcg_tpu.ops import fused as jfused
from blockcg_tpu_torch.ops import _native, fused, spmm_tiled, stencil
from blockcg_tpu_torch.ops import block_stencil as bsk

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
    is a multiple of 4, a tile of one column a thread (with the Gram, up to
    32 rows a tile of the tensor-core kernel that takes it,
    ``stencil_mma_f32_plan``, and from 33 to 64 the window kernel's Gram
    form's, ``stencil_vec_gram_plan``), shared memory within the cap (as the
    kernel counts it) and blocks an SM that it holds, the near/far split of
    the kernel's rule, and less L2 traffic than one read of X per
    diagonal."""
    n, offsets = _PRESETS[preset]
    for r0, r1 in _native.row_chunks(k):
        kc = r1 - r0
        if with_gram and stencil.vec_gram_takes(kc):
            plan = stencil.stencil_vec_gram_plan(offsets, n, kc, H100_SMEM, H100_SMS)
            assert plan.T in stencil.TILES
            assert plan.smem_bytes == stencil.vec_gram_smem_bytes(kc, len(offsets), plan.h,
                                                                  plan.T)
        elif with_gram:
            plan = stencil.stencil_mma_f32_plan(offsets, n, kc, H100_SMEM, H100_SMS)
            assert plan.T in stencil.MMA_F32_TILES
            assert plan.smem_bytes == stencil.mma_f32_smem_bytes(kc, len(offsets), plan.h, plan.T)
            assert plan.smem_bytes + stencil.MMA_STATIC_BYTES <= H100_SMEM
        else:
            plan = stencil.stencil_plan(offsets, n, kc, H100_SMEM, H100_SMS)
            assert plan.T in stencil.TILES
            assert plan.smem_bytes == stencil.smem_bytes(kc, len(offsets), plan.h, plan.T)
        assert plan.h % 4 == 0 and plan.smem_bytes <= H100_SMEM
        assert 1 <= plan.blocks_per_sm <= (2 if kc <= 32 and not with_gram else 1)
        assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= H100_SMEM + 1024
        assert plan.near == tuple(min(o % n, n - o % n) <= plan.h for o in offsets)
        assert plan.traffic == pytest.approx(
            (plan.T + 2 * plan.h) / plan.T + _far_count(offsets, n, plan.h))
        assert plan.traffic < len(offsets)
        assert plan.T <= max(128, n // H100_SMS)


@pytest.mark.parametrize("k,with_gram,h,T,near,blocks", [
    (32, False, 4, 256, 3, 2),   # 0, +-1 from the window, two blocks an SM
    (32, True, 128, 256, 5, 1),  # the Gram's tensor-core kernel: the widest halo
    (1, False, 128, 256, 5, 2),  # small rows: +-128 fits beside two blocks
    (48, False, 128, 256, 5, 1), # one block an SM at KMAX = 64: the widest halo
    (64, True, 4, 256, 3, 1),    # the window kernel's Gram form: the (64, 64) tile's room
])
def test_stencil_plan_of_the_north_star(k, with_gram, h, T, near, blocks):
    """The SpMM's plan, and with the Gram the tensor-core kernel's up to 32
    rows (``stencil_mma_f32_plan``) and the window kernel's Gram form's
    above (``stencil_vec_gram_plan``), at (k, 128^3)."""
    offsets = _PRESETS["lap_128^3"][1]
    if with_gram and stencil.vec_gram_takes(k):
        plan = stencil.stencil_vec_gram_plan(offsets, 128 ** 3, k, H100_SMEM, H100_SMS)
    elif with_gram:
        plan = stencil.stencil_mma_f32_plan(offsets, 128 ** 3, k, H100_SMEM, H100_SMS)
    else:
        plan = stencil.stencil_plan(offsets, 128 ** 3, k, H100_SMEM, H100_SMS)
    assert (plan.h, plan.T, sum(plan.near), plan.blocks_per_sm) == (h, T, near, blocks)


def test_stencil_plan_at_64_cubed_and_small_fields():
    plan = stencil.stencil_plan(_PRESETS["lap_64^3"][1], 64 ** 3, 32, H100_SMEM, H100_SMS)
    assert plan.h == 64 and sum(plan.near) == 5 and plan.blocks_per_sm == 2
    # A field of 1000 columns still makes tiles of at least 128.
    plan = stencil.stencil_plan((0, 1, -1), 1000, 5, H100_SMEM, H100_SMS)
    assert plan.T == 128 and all(plan.near)
    # All offsets far from the tile: no halo at all.
    plan = stencil.stencil_plan((3000, -3000, 7777), 65536, 8, H100_SMEM, H100_SMS)
    assert plan.h == 0 and not any(plan.near)


def test_stencil_plan_refuses_a_cap_with_no_room():
    with pytest.raises(ValueError, match="no tile"):
        stencil.stencil_plan((0, 1, -1), 4096, 64, 16 * 1024, H100_SMS)
    with pytest.raises(ValueError, match="no tile"):
        stencil.stencil_plan((0, 1, -1), 4096, 64, 128 * 64 * 4, H100_SMS)


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
    plan = stencil.stencil_plan(offsets, n, k, cap, sms)
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


# name -> (plan, stacked input fields, coefficient tables, rows of a fused Gram,
# whether the kernel is px_update.cu's)
_PLANS = {"mm_update_gram": (fused.mm_update_gram_plan, 1, 1, fused.UPDATE_GRAM_MAX_K_ONE,
                             False),
          "mm2_update_gram": (fused.mm2_update_gram_plan, 2, 2, fused.UPDATE_GRAM_MAX_K, False),
          "px_update": (fused.px_update_plan, 2, 3, 0, True)}


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
    make, nfield, nmat, gram_rows, px = _PLANS[name]
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
    assert plan.blocks_per_sm <= fused._blocks_per_sm(kout, plan.fused_gram, px)


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
    assert ("4 * (nmat * kin * rp + (gram ? 1LL * k * kUpLd : 0)) +\n"
            "                1LL * esize * kUpStages * kc * kUpTile;" in common)
    assert "4LL * kUpThreads * (k > 32 ? 64 : 16)" in common
    ug = (CSRC / "update_gram.cuh").read_text()
    assert "kUgBlocksPerSm = GK > 0 && GK <= 32 ? 2 : 1;" in ug
    assert "update_smem_bytes(k, kin, kc, NF, GK > 0, sizeof(E))" in ug
    mm2 = (CSRC / "mm2_update_gram.cu").read_text()
    assert "return dispatch<float, 2, false>(" in mm2 and "return dispatch<bf16, 2, false>(" in mm2
    mm1 = (CSRC / "mm_update_gram.cu").read_text()
    assert "dispatch<E, 1, true>(" in mm1 and "dispatch<E, 1, false>(" in mm1
    assert "if constexpr (NF == 1) BCG_UG(12, 96);" in ug and fused.UPDATE_GRAM_MAX_K_ONE == 96
    assert "BCG_UG(16, 128)" not in ug
    assert "      case 8: BCG_UG(8, 64);" in ug and fused.UPDATE_GRAM_MAX_K == 64
    px = (CSRC / "px_update.cu").read_text()
    assert "kPxBlocksPerSm = R <= 8 ? 2 : 1;" in px
    assert "update_smem_bytes(k, kin, kc, XN ? 3 : 2, false, sizeof(E))" in px
    st = (CSRC / "stencil.cu").read_text()
    assert int(re.search(r"kMaxDiags = (\d+)", st).group(1)) == stencil.MAX_DIAGS
    assert "return T + 2 * h + (esize == 4 && k <= 32 ? 4 : 0);" in st
    assert ("return 2LL * (esize * k * static_cast<long long>(window_ld(k, h, T, esize)) +\n"
            "                dsize * static_cast<long long>(ndiag) * T);" in st)
    assert "kStBlocksPerSm = !WITH_GRAM && KMAX <= 32 ? 2 : 1" in st
    assert ("  return smem_bytes(k, ndiag, h, T, 4, dsize) +\n"
            "         4 * (ly > StGram::kScratch ? ly : StGram::kScratch);" in st)
    assert "const long long ly = 1LL * k * (T + 4);" in st
    assert "using StGram = VecGram<64, kStThreads>;" in st and stencil.VEC_GRAM_SCRATCH == 16384
    assert int(re.search(r"kVecGramFlush = (\d+);", st).group(1)) == stencil.VEC_GRAM_FLUSH
    assert int(re.search(r"kStMmaF32MaxK = (\d+);", st).group(1)) == stencil.MMA_F32_MAX_K
    assert stencil.VEC_GRAM_ROWS == (stencil.MMA_F32_MAX_K + 1, 64)
    assert "k <= kStMmaF32MaxK || k > 64 || part == nullptr" in st
    assert "else if (k > kStMmaF32MaxK)  // an f32 field's 33 to 64 rows" in st
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
    gr = (CSRC / "gram.cu").read_text()
    assert int(re.search(r"kGrThreads = (\d+)", gr).group(1)) == fused.GRAM_THREADS
    assert int(re.search(r"kGrScratch = (\d+)", gr).group(1)) == fused.GRAM_SCRATCH
    assert "return T + (sym ? 8 : 4);" in gr
    assert "const long long b = 4LL * stages * rows * gram_ld(T, sym);" in gr
    assert int(re.search(r"kGrStages = (\d+)", gr).group(1)) == fused.GRAM_STAGES
    listed = re.search(r"widths\[\] = \{([\d, ]+)\};", gr).group(1)
    widths = tuple(int(w) for w in listed.split(","))
    assert widths == fused.GRAM_WIDTHS and widths[-1] == fused.GRAM_MAX_K
    assert "T < 128 || T > 1024 || T % 128 != 0" in gr
    assert set(fused.GRAM_TILES) == {128, 256, 512, 1024}
    # The tensor-core kernels of bf16 rows 5 and 6 and their TMA rings.
    mma = (CSRC / "mma.cuh").read_text()
    assert int(re.search(r"kRingMaxStages = (\d+)", mma).group(1)) == fused.RING_MAX_STAGES
    assert int(re.search(r"kBoxCols = (\d+)", mma).group(1)) == 64
    assert "return (r + 7) / 8 * 8;" in mma and fused.round8(12) == 16 == fused.round8(16)
    assert ("return (c >> 6) * r8 * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + "
            "(c & 7) * 2;" in mma)
    assert "((1024 - (smem_u32(p) & 1023)) & 1023)" in mma and fused.RING_ALIGN == 1024
    for src in (gr, mm):
        assert "__shared__ unsigned long long full[kRingMaxStages];" in src
        assert "stages < 2" in src and "stages > kRingMaxStages" in src
    assert fused.RING_BARRIER_BYTES == 8 * fused.RING_MAX_STAGES
    assert ("const long long b = 2LL * stages * T * (round8(ku) + (sym ? 0 : round8(kv)));\n"
            "  return (b > 4LL * kGrScratch ? b : 4LL * kGrScratch) + 1024;" in gr)
    assert "static_assert(MmaGram<W>::kScratch <= kGrScratch" in gr
    assert "return 2LL * T * (stages * (W + (has_a ? round8(k) : 0)) + round8(k)) + 1024;" in mm
    listed = re.search(r"mm_mma_width\(int k\) \{\n  static const int widths\[\] = \{([\d, ]+)\};",
                       mm).group(1)
    assert tuple(int(w) for w in listed.split(",")) == fused.MM_MMA_WIDTHS
    assert "kMmMmaBlocks = W <= 64 ? 2 : 1;" in mm
    assert [fused.mm_mma_blocks_per_sm(k) for k in (16, 32, 64, 65, 128)] == [2, 2, 2, 1, 1]
    assert "T < 128 || T > 256 || T % 128 != 0" in mm and set(fused.MM_MMA_TILES) == {128, 256}
    # The bf16 stencil with its Gram (row 2b) and rows 7-8 with theirs on
    # the tensor cores.
    assert int(re.search(r"kStMmaScratch = (\d+)", st).group(1)) == stencil.MMA_SCRATCH
    assert "return T + 2 * h + ((16 - T - 2 * h) & 63);" in st
    assert ("const int b = 2 * nst * T * round8(k) + 2 * k * mma_window_ld(h, T) + "
            "dsize * ndiag * T;\n  return (b + 1023) / 1024 * 1024;" in st)
    assert ("const long long b = 2LL * mma_stage_bytes(k, ndiag, nst, h, T, dsize) +\n"
            "                      2LL * k * mma_tile_ld(T);\n"
            "  return (b > 4LL * kStMmaScratch ? b : 4LL * kStMmaScratch) + 1024;" in st)
    assert "if (k > 64) return cudaErrorInvalidValue;" in st and stencil.MMA_MAX_K == 64
    # A bf16 field's Gram above 64 rows in column blocks (stencil_mma_cols)
    # and bf16 px_update on the tensor cores.
    assert int(re.search(r"kStColsFw = (\d+)", st).group(1)) == stencil.MMA_COLS_FW
    assert "(ga + 15) / 16 > kStColsFw * (16 / ((k + 7) / 8))" in st
    assert "MG = nw / RG, TM = (MT + MG - 1) / MG;" in st
    assert "inline int mma_sums_ld(int T) { return T + ((16 - T) & 31); }" in st
    assert ("return 2LL * (2LL * nst * T * round8(k) + 2LL * k * mma_window_ld(h, T) +\n"
            "                1LL * dsize * ndiag * T) +\n"
            "         4LL * k * mma_sums_ld(T) + 2LL * others * mma_tile_ld(T) + 1024;" in st)
    assert "__launch_bounds__(kStMmaThreads, 1)\n    stencil_mma_cols(" in st
    assert ("return 2LL * T * (stages * (2 * W + round8(k)) + round8(k)) +\n"
            "         (W == 64 ? 3LL * 64 * 128 : 0) + 1024;" in px)
    assert fused.PX_MMA_C_BYTES == 3 * 64 * 128 and fused.PX_MMA_MAX_K == 64
    assert "__launch_bounds__(kUpThreads, 1)\n    px_update_mma(" in px
    assert ("k > 64 || T < 128 || T > 512 || T % 128 != 0 || stages < 2 ||\n"
            "      stages > kRingMaxStages" in px)
    assert ("if (k <= 16)\n    return launch_px_mma<16, QR>(" in px
            and "if (k <= 32)\n    return launch_px_mma<32, QR>(" in px
            and "  return launch_px_mma<64, QR>(" in px)
    assert "__launch_bounds__(kStMmaThreads, 1)\n    stencil_mma(" in st
    assert "constexpr int kStMmaThreads = 512;" in st
    assert "__shared__ Diags dg;" in st and "__shared__ unsigned long long full[2];" in st
    assert stencil.MMA_STATIC_BYTES == 4 * (4 * 32 + 1) + 16
    assert ("int stage[kMaxDiags];" in st and "int far[kMaxDiags];" in st
            and "int nst;" in st)
    assert int(re.search(r"kStMaxStaged = (\d+)", st).group(1)) == stencil.MMA_MAX_STAGED
    assert "inline int mma_tile_ld(int T) { return T + ((16 - T) & 63); }" in st
    assert "QN = W == 8 ? 1 : W >= 64 ? 4 : 2;" in st and "P = 16 / (QM * QN);" in st
    assert "return k <= 8 ? 8 : k <= 16 ? 16 : k <= 32 ? 32 : 64; }" in st
    assert ("const long long b = 2LL * T * (stages * (nf * W + (has_a ? round8(k) : 0)) + "
            "round8(k));" in ug)
    assert ("const long long scratch = 4LL * 9216;" in ug and "kScratch <= 9216" in ug
            and fused.UPDATE_MMA_SCRATCH == 9216)
    built = re.findall(r"if \(k <= (\d+)\) BCG_UM\((\d+), (\d+)\);", ug)
    assert [(int(a), int(b), int(c)) for a, b, c in built] == [
        (8, 16, 8), (16, 16, 16), (32, 32, 32), (48, 64, 48)]
    assert "  BCG_UM(64, 64);" in ug and fused.UPDATE_MMA_WIDTHS == (16, 32, 64)
    assert ("k > 64 || T < 128 || T > 512 || T % 128 != 0 || stages < 2 ||\n"
            "      stages > kRingMaxStages" in ug)
    assert fused.UPDATE_GRAM_MMA_MAX_K == 64
    assert set(fused.UPDATE_MMA_TILES) <= {128, 256, 384, 512}
    assert "__launch_bounds__(kUpThreads, 1)\n    update_gram_mma(" in ug
    assert "return dispatch_mma<2>(" in mm2 and "return dispatch_mma<1>(" in mm1
    bs = (CSRC / "block_stencil.cu").read_text()
    for name, value in (("kMaxDiags", bsk.MAX_DIAGS), ("kMaxBs", bsk.MAX_BS),
                        ("kBsThreads", bsk.THREADS), ("kBsMaxRows", bsk.MAX_ROWS),
                        ("kBsMaxStages", max(bsk.STAGES)), ("kBsScratch", bsk.SCRATCH)):
        assert int(re.search(rf"{name} = (\d+)", bs).group(1)) == value, name
    assert "return T + 2 * h + 4;" in bs
    assert ("return 1LL * csize * bs * bs * T + (far ? 4LL * m * T : 0);" in bs
            and "8LL * m * window_ld(T, h) + stages * bs_slot_bytes(bs, m, T, far, csize) +"
            in bs and "(gram ? 4LL * m * (T + 4) : 0);" in bs)
    assert ("__shared__ unsigned long long full[kBsMaxStages], empty[kBsMaxStages], wfree[2];"
            in bs and bsk.BARRIER_BYTES == 8 * (2 * max(bsk.STAGES) + 2))
    built = {w: tuple(int(ki) for ki in re.findall(rf"BCG_BS\({w}, (\d+)\);", bs)) for w in (4, 8)}
    assert built == bsk.KI_BUILT
    assert "kBsThreads / groups" in bs
    # Rows 2 and 2m on the tensor cores (stencil_mma_f32) and rows 23h, 24h on
    # TMA tensor boxes (bs_tma).
    assert int(re.search(r"kStF32Prefetch = (\d+)", st).group(1)) == stencil.MMA_F32_PREFETCH
    assert "return T + 2 * h + ((16 - T - 2 * h) & 31);" in st
    assert ("const long long b = 2LL * (4LL * k * mma_f32_window_ld(h, T) + 1LL * dsize * ndiag * T);"
            "\n  return b > 4LL * kStMmaScratch ? b : 4LL * kStMmaScratch;" in st)
    assert "__launch_bounds__(kStMmaThreads, 1)\n    stencil_mma_f32(" in st
    assert "return dispatch_mma_f32(diags, dg, ndiag, X, Y, part, G, k, n, h, T, max_blocks" in st
    assert int(re.search(r"kBtMaxStages = (\d+)", bs).group(1)) == max(bsk.TMA_STAGES)
    assert ("return round128(1LL * csize * bs * bs * T) + (far ? 4LL * m * T : 0);" in bs
            and "return 2 * round128(4LL * m * (T + 2 * h)) + stages * "
            "bt_slot_bytes(bs, m, T, far, csize) +\n         128;" in bs)
    assert "p->T + 2 * p->h <= 256" in bs and bsk.TMA_MAX_BOX == 256
    assert "__shared__ unsigned long long full[kBtMaxStages], empty[kBtMaxStages], wfree[2];" in bs
    assert bsk.TMA_BARRIER_BYTES == 8 * (2 * max(bsk.TMA_STAGES) + 2)
    assert "__launch_bounds__(kBsThreads + 32, 1)\n    bs_tma(" in bs
    assert ("return (j & 3) == 0 && gl >= 2 && ((p.bs * p.k) << gl) % 32 == 0 && "
            "j + (1 << gl) <= p.ns;" in bs)
    assert ("if (st > 0 && p->offs.s[d] == kFar) gf = min(gf, st & -st);" in bs
            and "const int g = st > 0 && p->offs.s[d] == kFar && (st & -st) < p->T ? gf : p->T;"
            in bs)
    # The bf16 field's ring (stencil_ring).
    for name, value in (("kRingCols", "4 * kRingThreads"), ("kRingThreads", "256"),
                        ("kRingMaxSlots", "8"), ("kRingBox", "256")):
        assert re.search(rf"constexpr int {name} = ([^;]+);", st).group(1) == value, name
    assert (stencil.RING_COLS, stencil.RING_MAX_SLOTS, stencil.RING_BOX) == (4 * 256, 8, 256)
    assert ("return slots * ring_slot_bytes(R, h, esize) + 2 * ring_coef_bytes(ndiag, dsize) + 256;"
            in st and "return ring_round128(1LL * esize * R * ring_span(h));" in st
            and "return ring_round128(1LL * dsize * ndiag * kRingCols);" in st)
    assert "__shared__ unsigned long long full[2], empty[2];" in st
    assert stencil.RING_STATIC_BYTES == 4 * 8
    assert ("constexpr int lo = sizeof(EX) == 2 ? 8 : 4;" in st and "(R != lo && R != 2 * lo)" in st
            and stencil.RING_ROWS == {2: (8, 16), 4: (4, 8)})


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", ["dia_csr", "cbdia_merged", "cbdia_view", "bdia_view",
                                  "dia_csr_bf16_diagonals", "bdia_merged_bf16_blocks",
                                  "bdia_view_bf16_blocks", "bdia_folded_bf16_blocks",
                                  "dia_csr_bf16_field", "slab_m", "slab_from", "slab_view",
                                  "slab_view_from"])
def test_smoke_library_calls_compute_the_kernels_function(case, monkeypatch):
    """``chip_smoke.py``'s library yardsticks (a torch CSR or BSR tensor of
    the operator times the dense field) compute the wrapper's function: the
    check inside them passes on the plain route's output. Rows 1m, 22h, 23h
    and 24f on bf16 coefficients take the product of the coefficients lifted
    to f32 (24f's of the unfolded matrix: folding and rounding to bf16
    commute); row 1x's (a bf16 field) takes X lifted to f32 and rounds its
    product to bf16, within one bf16 ulp of the wrapper's Y. Rows 19 and 20
    (the merged slab adds, without the Gram or ``vals``): ``baddbmm_`` of
    ``H ⊗ I_k`` on strided views of a wrap slab's blocks of
    ``dirac_cbdia(16)``, and ``addmm_`` on a halo slab's columns. Rows 18
    and 21 (the (k, bs, ns) view's): at one RHS row 19's ``baddbmm_`` on the
    same memory (W = H), and ``baddbmm_`` of H over the right-hand sides on
    the view's halo columns."""
    from blockcg_tpu_torch.operators import astype
    from blockcg_tpu_torch.ops import block_stencil as bsk
    from blockcg_tpu_torch.ops import const_block_stencil as cbs
    from blockcg_tpu_torch.problems import dirac_cbdia, dirac_gauged_matrix, laplacian_dia

    smoke = _smoke()
    torch.manual_seed(0)
    if case.startswith("slab"):
        op = dirac_cbdia(16, device="cpu")
        k = 3
        X, Y0 = torch.randn(op.bs * k, op.ns), torch.randn(op.bs * k, op.ns)
        if case == "slab_m":
            for d, g, nblocks, mul, off, shift in op.slabs:
                slab = (op.hops_all[d], g, nblocks, mul, off, shift, X)
                call, why = smoke._slab_library(torch, *slab[:6], X, Y0,
                                                cbs.slab_m_accumulate(*slab, Y0.clone()))
                assert why is None and call is not None
        elif case == "slab_view":
            Xv, Yv = X[:op.bs].reshape(1, op.bs, op.ns), Y0[:op.bs].reshape(1, op.bs, op.ns)
            for d, g, nblocks, mul, off, shift in op.slabs:
                slab = (op.hops_all[d], g, nblocks, mul, off, shift)
                want = cbs.slab_block_accumulate(*slab, Xv, Yv.clone())
                call, why = smoke._slab_library(torch, *slab, Xv.view(op.bs, op.ns),
                                                Yv.view(op.bs, op.ns), want.view(op.bs, op.ns))
                assert why is None and call is not None
        elif case == "slab_view_from":
            Srcv = torch.randn(k, op.bs, 4 * 256)
            Yv = Y0.reshape(k, op.bs, op.ns)
            want = cbs.slab_block_accumulate_from(op.hops_all[1], 256, 3, 5, 1, Srcv, Yv.clone())
            call, why = smoke._view_halo_library(torch, op.hops_all[1], 256, 3, 5, 1, Srcv, Yv,
                                                 want)
        else:
            Src = torch.randn(op.bs * k, 4 * 256)
            want = cbs.slab_m_accumulate_from(op.hops_all[1], 256, 3, 5, 1, Src, Y0.clone())
            call, why = smoke._halo_library(torch, op.hops_all[1], 256, 3, 5, 1, Src, Y0, want)
    elif case == "dia_csr_bf16_field":
        op = laplacian_dia((8, 8, 8), device="cpu")
        X = torch.randn(5, op.n).bfloat16()
        errs = []

        def ulps(got, want):
            errs.append(smoke.bf16_ulps(torch, got.to(torch.bfloat16), want))
            return errs[-1]
        call, why = smoke._dia_csr_library(torch, op.diags, op.offsets, X.float(),
                                           stencil.stencil_spmm_t(op.diags, op.offsets, X), ulps)
        assert errs and errs[-1] <= 1
    elif case.startswith("dia_csr"):
        op = laplacian_dia((8, 8, 8), device="cpu")
        X = torch.randn(5, op.n)
        d = op.diags if case == "dia_csr" else op.diags.bfloat16()
        call, why = smoke._dia_csr_library(torch, d.float(), op.offsets, X,
                                           stencil.stencil_spmm_t(d, op.offsets, X))
    elif case.endswith("bf16_blocks"):
        monkeypatch.setenv("BLOCKCG_FOLD", "1")
        op = astype(dirac_gauged_matrix(4, device="cpu"), torch.bfloat16)
        lifted = op.blocks.float()
        if case == "bdia_view_bf16_blocks":
            X = torch.randn(3, op.bs, op.ns)
            Y = bsk.block_stencil_spmm_t(op.blocks, op.offsets, X)
        else:
            X = torch.randn(3 * op.bs, op.ns)
            Y = (bsk.block_stencil_spmm_m_t(op.blocks, op.offsets, X)
                 if case == "bdia_merged_bf16_blocks" else
                 bsk.block_stencil_spmm_m_t(op.blocks_folded, op.fold_offsets, X, op.fold))
            assert op.fold or case == "bdia_merged_bf16_blocks"
        call, why = smoke._site_bsr_library(torch, lifted, op.offsets, X, Y)
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


# ------------------------------------------------ gram (row 5): plan and layout


@pytest.mark.parametrize("ku,kv,same,n,T", [
    (32, 32, False, 2 ** 21, 256),   # the main shape: two 65 KB stages of 64 rows
    (32, 32, True, 2 ** 21, 512),    # U alone: twice the columns
    (96, 96, False, 2 ** 20, 128),   # [wide]: 192 stacked rows, two stages in 198 KB
    (96, 96, True, 2 ** 20, 256),
    (48, 48, False, 2 ** 20, 256),   # config 4's width
    (48, 48, True, 2 ** 20, 512),
    (64, 32, False, 2 ** 16, 256),   # a rectangular block
    (8, 8, True, 300, 128),          # a small field: one tile an SM at most
])
def test_gram_plan_of_the_main_paths(ku, kv, same, n, T):
    plan = fused.gram_plan(ku, kv, same, n, H100_SMEM, H100_SMS)
    rows = ku if same else ku + kv
    assert plan.T == T and plan.smem_bytes == fused.gram_smem_bytes(rows, T, same)
    assert plan.smem_bytes <= H100_SMEM and plan.blocks == min(-(-n // T), H100_SMS)
    assert T == 128 or T <= n // H100_SMS
    wider = [t for t in fused.GRAM_TILES if t > T and t <= max(128, n // H100_SMS)]
    assert all(fused.gram_smem_bytes(rows, t, same) > H100_SMEM for t in wider)


@pytest.mark.parametrize("ku,kv,same,n,T,stages", [
    (32, 32, False, 256 ** 3, 512, 3),   # config 5's inner shape: a box of 32 rows a field
    (32, 32, True, 256 ** 3, 1024, 3),
    (16, 16, False, 512 ** 2, 1024, 3),  # config 2's
    (48, 48, False, 32 ** 4, 512, 2),    # config 4's
    (48, 48, True, 32 ** 4, 1024, 2),
    (96, 96, False, 32 ** 4, 256, 2),    # the widest launch
    (96, 96, True, 32 ** 4, 512, 2),
    (12, 40, False, 777, 128, 8),        # a small ragged field: 128 columns, the deepest ring
])
def test_gram_plan_of_the_bf16_paths(ku, kv, same, n, T, stages):
    """bf16 fields: the widest tile that leaves every SM a tile and whose
    TMA ring holds two stages, as deep as the card's shared memory allows."""
    plan = fused.gram_plan(ku, kv, same, n, H100_SMEM, H100_SMS, 2)
    assert (plan.T, plan.stages) == (T, stages)
    assert plan.smem_bytes == fused.gram_mma_smem_bytes(ku, kv, same, T, stages)
    assert plan.smem_bytes + fused.RING_BARRIER_BYTES <= H100_SMEM
    assert plan.blocks == min(-(-n // T), H100_SMS)
    deeper = fused.gram_mma_smem_bytes(ku, kv, same, T, stages + 1)
    assert stages == fused.RING_MAX_STAGES or deeper + fused.RING_BARRIER_BYTES > H100_SMEM
    wider = [t for t in fused.GRAM_TILES if t > T and t <= max(128, n // H100_SMS)]
    assert all(fused.gram_mma_smem_bytes(ku, kv, same, t, 2) + fused.RING_BARRIER_BYTES
               > H100_SMEM for t in wider)


@pytest.mark.parametrize("k,n,has_a,T,stages", [
    (32, 256 ** 3, False, 256, 4),  # config 5's inner shape, two blocks an SM
    (32, 256 ** 3, True, 256, 2),
    (16, 512 ** 2, False, 256, 4),
    (48, 32 ** 4, False, 256, 2),
    (48, 32 ** 4, True, 128, 3),
    (96, 32 ** 4, False, 256, 2),   # one block an SM above 64 rows
    (128, 2 ** 20, True, 128, 3),
    (12, 777, False, 128, 4),
])
def test_mm_update_mma_plan_of_the_bf16_paths(k, n, has_a, T, stages):
    """The bf16 ``mm_update`` ring: the widest tile whose two stages fit the
    shared memory of the blocks an SM the kernel is built for."""
    plan = fused.mm_update_mma_plan(k, n, has_a, H100_SMEM, H100_SMS)
    assert (plan.T, plan.stages) == (T, stages)
    assert plan.smem_bytes == fused.mm_update_mma_smem_bytes(k, T, stages, has_a)
    blocks = fused.mm_mma_blocks_per_sm(k)
    share = (H100_SMEM + 1024) // blocks - 1024
    assert plan.smem_bytes + fused.RING_BARRIER_BYTES <= share
    deeper = fused.mm_update_mma_smem_bytes(k, T, stages + 1, has_a)
    assert stages == fused.MM_MMA_MAX_STAGES or deeper + fused.RING_BARRIER_BYTES > share
    with pytest.raises(ValueError, match="1 to 128 rows"):
        fused.mm_update_mma_plan(129, n, has_a, H100_SMEM, H100_SMS)


def _bf16_round(x):
    """Round-to-nearest-even to bf16 of f32 values, back in f32."""
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()


def test_three_piece_split_holds_the_f32_coefficient():
    """``csrc/mma.cuh`` split3, modelled: hi = bf16(M), mid = bf16(M - hi),
    lo = bf16(M - hi - mid), each difference taken in f32; hi + mid + lo is
    M exactly on seeded matrices with large, small and negative entries,
    where hi + mid (two pieces, 16 bits) misses most of them."""
    rng = np.random.default_rng(16)
    M = np.concatenate([
        rng.standard_normal(4096),
        rng.standard_normal(1024) * 10.0 ** rng.integers(-30, 30, 1024),  # 2^-100 .. 2^100
        np.array([1 + 2.0 ** -10 + 2.0 ** -20, -(1 + 2.0 ** -23), 3.0e38, -3.0e38, 1e-30,
                  2.0 ** -103, 0.0, -0.0, 1.0, -65504.0]),
    ]).astype(np.float32)
    hi = _bf16_round(M)
    r1 = (M - hi).astype(np.float32)
    mid = _bf16_round(r1)
    r2 = (r1 - mid).astype(np.float32)
    lo = _bf16_round(r2)
    assert np.array_equal(lo, r2)  # the last piece is exact in bf16
    whole = hi.astype(np.float64) + mid.astype(np.float64) + lo.astype(np.float64)
    assert np.array_equal(whole, M.astype(np.float64))
    two = hi.astype(np.float64) + mid.astype(np.float64)
    assert np.mean(two != M.astype(np.float64)) > 0.5


def _swz(r, c, r8):
    """``csrc/mma.cuh`` swz: byte offset of element (r, c) of a staged tile."""
    return (c >> 6) * r8 * 128 + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2


@pytest.mark.parametrize("rows", [12, 32, 40, 96])
def test_swizzled_boxes_are_a_conflict_free_bijection(rows):
    """The staged tile's layout: every element of a (rows, 256) tile has its
    own 2 bytes inside the boxes of round8(rows) rows; the 8 rows an
    ldmatrix reads at one 16-byte chunk (rows 8i .. 8i + 7) fall in 8
    distinct bank groups; a box starts every round8(rows) * 128 bytes."""
    r8, T = fused.round8(rows), 256
    offs = np.array([[_swz(r, c, r8) for c in range(T)] for r in range(rows)])
    assert len(np.unique(offs)) == rows * T and offs.max() < 2 * T * r8
    assert (offs % 2 == 0).all()
    for r0 in range(0, rows - 7, 8):
        for c in range(0, T, 8):
            groups = {(_swz(r, c, r8) % 128) // 16 for r in range(r0, r0 + 8)}
            assert len(groups) == 8
    assert [_swz(0, 64 * b, r8) for b in range(4)] == [b * r8 * 128 for b in range(4)]


def test_gram_plan_refuses_what_one_launch_cannot_take():
    with pytest.raises(ValueError, match="at most 96"):
        fused.gram_plan(97, 8, False, 4096, H100_SMEM, H100_SMS)
    with pytest.raises(ValueError, match="no tile"):
        fused.gram_plan(96, 96, False, 4096, 64 * 1024, H100_SMS)


@pytest.mark.parametrize("k,chunks", [
    (97, None), (128, None), (800, None),
    (96, [(0, 48), (48, 96)]),                                   # the stencil's two launches
    (800, _native.row_chunks(800, 32)),                          # xr_update_gram's chunks
    (400, _native.row_chunks(400, 16)),
    (200, [(0, 70), (70, 140), (140, 200)]),
])
@pytest.mark.parametrize("same", [False, True])
def test_gram_blocks_cover_every_entry_once(k, chunks, same):
    """``wide_gram``'s layout: every entry of G from exactly one block; a
    launch takes at most 96 rows of each field; a mirror copies a block made
    before it; the fused diagonal blocks are the chunks' own. On the CPU,
    with a plain product standing in for each launch, it gives U V^T."""
    blocks = fused.gram_blocks(k, chunks, same)
    cover = np.zeros((k, k), int)
    made = set()
    for what, r0, r1, s0, s1, a in blocks:
        cover[r0:r1, s0:s1] += 1
        if what == "launch":
            assert r1 - r0 <= fused.GRAM_MAX_K and s1 - s0 <= fused.GRAM_MAX_K
        elif what == "mirror":
            assert same and (s0, s1, r0, r1) in made
        else:
            assert chunks is not None and (r0, r1) == tuple(chunks[a]) == (s0, s1)
        made.add((r0, r1, s0, s1))
    assert (cover == 1).all()
    if chunks is None:
        assert sum(b[0] == "launch" for b in blocks) == (
            lambda c: c * (c + 1) // 2 if same else c * c)(-(-k // fused.GRAM_MAX_K))
    rng = np.random.default_rng(k)
    U = torch.from_numpy(rng.standard_normal((k, 40)))
    V = U if same else torch.from_numpy(rng.standard_normal((k, 40)))
    diag = None if chunks is None else [U[r0:r1] @ V[r0:r1].T for r0, r1 in chunks]
    orig = fused._launch_gram
    fused._launch_gram = lambda A, B: A @ B.T
    try:
        G = fused.wide_gram(U, V, diag, chunks)
    finally:
        fused._launch_gram = orig
    np.testing.assert_allclose(G.numpy(), (U @ V.T).numpy(), rtol=1e-6, atol=1e-6)


# ------------------------------- the per-site block stencil (rows 22-24)


def _dirac_offsets(L):
    """``dirac_gauged_matrix(L)``'s 15 offsets (problems/dirac.py)."""
    offs = [0, L ** 3, -L ** 3]
    for st in (L ** 2, L, 1):
        offs += [st, -st, -(L - 1) * st, (L - 1) * st]
    return tuple(offs)


_BS_PRESETS = {
    "matrix_32^4": (32 ** 4, _dirac_offsets(32)),
    "small_wraps": (300, (0, 1, -1, 17, -150, 64, 299, 452, -304)),
    "aligned": (1000, (0, 4, -4, 40, -400, 996)),
}


@pytest.mark.parametrize("preset", sorted(_BS_PRESETS))
@pytest.mark.parametrize("bs,k", [(1, 1), (1, 96), (2, 48), (3, 32), (4, 1), (4, 12),
                                  (4, 24), (5, 19), (8, 6), (8, 12)])
@pytest.mark.parametrize("with_gram", [False, True])
def test_block_stencil_plan_fits_and_covers(preset, bs, k, with_gram):
    """Every plan fits the cap (as the kernel counts its shared memory),
    covers the launch's right-hand sides (groups x ki >= k, a built ki) and
    sites (T = 256 / groups, a tile a block at most), splits the offsets by
    the kernel's near rule, and fuses
    the Gram only where the Gram's register width 2 BS ki covers m."""
    ns, offsets = _BS_PRESETS[preset]
    offs = tuple(o % ns for o in offsets)
    plan = bsk.block_stencil_plan(offs, ns, bs, k, with_gram, H100_SMEM, H100_SMS)
    w = 4 if bs <= 4 else 8
    assert plan.groups in bsk.GROUPS and plan.ki in bsk.KI_BUILT[w]
    assert plan.groups * plan.ki >= k and plan.T * plan.groups == bsk.THREADS
    assert plan.h % 4 == 0 and plan.stages in bsk.STAGES
    assert plan.near == tuple(min(o, ns - o) <= plan.h for o in offs)
    assert plan.smem_bytes == bsk.smem_bytes(bs, k, plan.T, plan.h, plan.stages,
                                             not all(plan.near), bool(plan.fused_gram))
    assert plan.smem_bytes + bsk.BARRIER_BYTES <= H100_SMEM
    assert plan.blocks == min(-(-ns // plan.T), H100_SMS)
    assert plan.fused_gram is (None if not with_gram else plan.fused_gram)
    if plan.fused_gram:
        assert plan.groups <= 2 and 2 * w * plan.ki >= bs * k


@pytest.mark.parametrize("bs,k,with_gram,want", [
    # m = 48 on dirac_gauged_matrix(32): two groups of 6 RHS, 128 sites, the
    # +-1, +-31, +-32 and 0 diagonals from a 32-site halo, four stages
    (4, 12, False, (32, 128, 2, 6, 4, 7, None)),
    (4, 12, True, (32, 128, 2, 6, 4, 7, True)),
    # the realified core: 64 coefficient planes fill two stages
    (8, 6, True, (32, 128, 2, 3, 2, 7, True)),
    # config 4's 24 RHS (m = 96): four groups of 6 over 64 sites, the Gram
    # from gram.cu
    (4, 24, True, (32, 64, 4, 6, 4, 7, False)),
    (4, 1, False, (32, 256, 1, 1, 4, 7, None)),
])
def test_block_stencil_plan_of_the_main_paths(bs, k, with_gram, want):
    ns, offsets = _BS_PRESETS["matrix_32^4"]
    plan = bsk.block_stencil_plan(tuple(o % ns for o in offsets), ns, bs, k, with_gram,
                                  H100_SMEM, H100_SMS)
    assert (plan.h, plan.T, plan.groups, plan.ki, plan.stages, sum(plan.near),
            plan.fused_gram) == want


def test_block_stencil_plan_pins_and_refusals():
    ns, offsets = _BS_PRESETS["aligned"]
    offs = tuple(o % ns for o in offsets)
    plan = bsk.block_stencil_plan(offs, ns, 4, 12, False, H100_SMEM, H100_SMS, h=0, groups=8,
                                  stages=2)
    assert (plan.h, plan.groups, plan.T, plan.ki, plan.stages) == (0, 8, 32, 2, 2)
    assert sum(plan.near) == 1
    with pytest.raises(ValueError, match="96 rows"):
        bsk.block_stencil_plan(offs, ns, 4, 25, False, H100_SMEM, H100_SMS)
    with pytest.raises(ValueError, match="no schedule"):
        bsk.block_stencil_plan(offs, ns, 8, 12, False, 16 * 1024, H100_SMS)
    with pytest.raises(ValueError, match="no schedule"):  # no room for one tile of 256 sites
        bsk.block_stencil_plan(offs, ns, 4, 12, False, H100_SMEM, H100_SMS, groups=1, h=400)


def _bs_schedule_apply(blocks, offsets, X, k, merged, plan):
    """The kernel's schedule in numpy (f64): per tile of T sites, the
    window of staged rows b * k + i at sites (i0 - h + v) mod ns, one stage a
    diagonal (its coefficients zero past ns, a far diagonal's X at (i0 + c +
    o) mod ns); thread (c, g) sums RHS g ki .. g ki + ki - 1, reading row k - 1
    past k; Y stored through the field's row map."""
    nd, bs, _, ns = blocks.shape
    m = bs * k
    row = (lambda b, i: b * k + i) if merged else (lambda b, i: i * bs + b)
    Xr = X.reshape(m, ns)
    staged = np.stack([Xr[row(b, i)] for b in range(bs) for i in range(k)])  # (m, ns)
    Y = np.zeros((m, ns))
    T, h = plan.T, plan.h
    for i0 in range(0, ns, T):
        window = staged[:, (i0 - h + np.arange(T + 2 * h)) % ns]
        acc = np.zeros((plan.groups, bs, plan.ki, T))
        for d, o in enumerate(offsets):
            o %= ns
            cols = np.arange(T)
            coef = np.zeros((bs, bs, T))
            live = i0 + cols < ns
            coef[:, :, live] = blocks[d][:, :, i0 + cols[live]]
            if plan.near[d]:
                s = o if o <= h else o - ns
                xs = window[:, h + s + cols]
            else:
                xs = staged[:, (i0 + cols + o) % ns]
            for g in range(plan.groups):
                rhs = [min(g * plan.ki + ii, k - 1) for ii in range(plan.ki)]
                for b in range(bs):
                    x = xs[[b * k + i for i in rhs]]  # (ki, T)
                    acc[g] += coef[:, b, None, :] * x[None]
        for g in range(plan.groups):
            for ii in range(plan.ki):
                i = g * plan.ki + ii
                if i >= k:
                    continue
                for a in range(bs):
                    live = i0 + np.arange(T) < ns
                    Y[row(a, i), i0 + np.arange(T)[live]] = acc[g, a, ii, live]
    return Y.reshape(X.shape)


@pytest.mark.parametrize("preset", ["small_wraps", "aligned"])
@pytest.mark.parametrize("bs,k,merged,pins", [
    (4, 3, True, {}), (3, 5, False, {}), (2, 7, True, {"groups": 4, "h": 0}),
    (8, 2, False, {"groups": 2, "h": 152}), (1, 9, True, {"groups": 8, "stages": 2}),
])
def test_block_stencil_schedule_matches_the_oracle(preset, bs, k, merged, pins):
    ns, offsets = _BS_PRESETS[preset]
    offs = tuple(o % ns for o in offsets)
    pins = {key: v for key, v in pins.items() if key != "h" or ns == 300 or v == 0}
    plan = bsk.block_stencil_plan(offs, ns, bs, k, False, H100_SMEM, 4, **pins)
    rng = np.random.default_rng(ns + bs)
    blocks = rng.standard_normal((len(offs), bs, bs, ns))
    X = rng.standard_normal((bs * k, ns) if merged else (k, bs, ns))
    want = bsk.block_stencil_plain(torch.from_numpy(blocks), offs,
                                   torch.from_numpy(X if merged else
                                                    X.transpose(1, 0, 2).reshape(bs * k, ns)))[0]
    want = want.numpy() if merged else want.numpy().reshape(bs, k, ns).transpose(1, 0, 2)
    got = _bs_schedule_apply(blocks, offs, X, k, merged, plan)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_timing_tool_bounds_of_the_new_cases():
    """``tools/torch_kernel_times.py``'s bound of a row 5 case: the fields
    read once (U alone when U is V) over 3.35 TB/s against U V^T's FLOPs
    (the upper triangle when U is V) over 67 TFLOP/s."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "tools" / "torch_kernel_times.py"
    spec = importlib.util.spec_from_file_location("torch_kernel_times", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    n = 32 ** 4
    assert tool.bound_us("row 5 gram (96, 32^4)") == pytest.approx(
        max(4 * (192 * n + 96 * 96) / 3.35e12, 2 * 96 * 96 * n / 67e12) * 1e6)
    assert tool.bound_us("row 5 gram U is V (96, 32^4)") == pytest.approx(
        max(4 * (96 * n + 96 * 96) / 3.35e12, 96 * 97 * n / 67e12) * 1e6)
    assert tool.bound_us("row 5 gram 64 x 32 (96, 32^4)") == pytest.approx(
        max(4 * (96 * n + 64 * 32) / 3.35e12, 2 * 64 * 32 * n / 67e12) * 1e6)
    assert tool.bound_us("row 23 block_stencil_spmm_m_t x") is None


# ------------- bf16 rows 2 and 7-8 on the tensor cores: plans and schedules


_LAP = {  # config 5's inner shape, config 3's, config 2's, config 4's lattice
    "256^3": (256 ** 3, _lap_offsets((256, 256, 256))),
    "64^3": (64 ** 3, _lap_offsets((64, 64, 64))),
    "512^2": (512 ** 2, _lap_offsets((512, 512))),
    "32^4": (32 ** 4, _lap_offsets((32, 32, 32, 32))),
}


@pytest.mark.parametrize("shape,k,h,T,nfar", [
    ("256^3", 32, 256, 256, 2),    # +-1, +-256 from the window, +-65536 staged: traffic 5.0
    ("64^3", 32, 64, 256, 2),
    ("512^2", 16, 512, 1024, 0),   # every diagonal from the window
    ("32^4", 48, 32, 128, 4),
])
def test_stencil_mma_plan_of_the_main_shapes(shape, k, h, T, nfar):
    """The bf16 stencil with its Gram on the tensor cores: the plan fits the
    card's shared memory at one block an SM with its far slabs staged, its
    halo is a multiple of the window's 8-column copy chunk, its tile a
    multiple of the 16-column steps of every warp, and no wider tile fits at
    its halo."""
    n, offsets = _LAP[shape]
    plan = stencil.stencil_mma_plan(offsets, n, k, H100_SMEM, H100_SMS)
    assert (plan.h, plan.T, plan.near.count(False), plan.blocks_per_sm) == (h, T, nfar, 1)
    assert plan.h % 8 == 0 and plan.T % 128 == 0 and plan.T in stencil.MMA_TILES
    nst = min(nfar, stencil.MMA_MAX_STAGED)
    assert plan.smem_bytes == stencil.mma_smem_bytes(k, len(offsets), nst, h, T)
    assert plan.smem_bytes + stencil.MMA_STATIC_BYTES <= H100_SMEM
    assert plan.traffic == pytest.approx((T + 2 * h) / T + nfar)
    assert plan.near == tuple(min(o % n, n - o % n) <= h for o in offsets)
    L, Lf = stencil.mma_window_ld(h, T), stencil.mma_tile_ld(T)
    assert L >= T + 2 * h and L % 64 == 16 and L - (T + 2 * h) < 64
    assert Lf >= T and Lf % 64 == 16
    for t in stencil.MMA_TILES:
        if t > T and t <= n // H100_SMS and (stencil.mma_smem_bytes(k, len(offsets), nst, h, t)
                                            + stencil.MMA_STATIC_BYTES <= H100_SMEM):
            raise AssertionError(f"a wider tile {t} fits at h = {h}")
    with pytest.raises(ValueError, match="1 to 64 rows"):
        stencil.stencil_mma_plan(offsets, n, 65, H100_SMEM, H100_SMS)


@pytest.mark.parametrize("k,n,nf,has_a,T,stages", [
    (32, 256 ** 3, 2, False, 512, 3),  # row 8 at config 5's inner shape
    (32, 256 ** 3, 1, True, 512, 3),   # row 7 there, with A
    (32, 64 ** 3, 2, False, 512, 3),
    (16, 512 ** 2, 2, False, 512, 4),
    (48, 32 ** 4, 2, False, 256, 3),   # 64-row boxes: no room for 512 columns
    (64, 2 ** 20, 2, False, 256, 3),
    (12, 777, 1, False, 128, 4),       # a small field: 128 columns
])
def test_update_gram_mma_plan_of_the_main_shapes(k, n, nf, has_a, T, stages):
    """Rows 7 and 8 in bf16 with the fused Gram: the widest tile whose ring
    holds two stages beside the tile of Y at one block an SM, as deep as
    fits up to ``UPDATE_MMA_MAX_STAGES``."""
    plan = fused.update_gram_mma_plan(k, n, nf, has_a, H100_SMEM, H100_SMS)
    assert (plan.T, plan.stages) == (T, stages)
    assert plan.smem_bytes == fused.update_gram_mma_smem_bytes(k, T, stages, nf, has_a)
    assert plan.smem_bytes + fused.RING_BARRIER_BYTES <= H100_SMEM
    deeper = fused.update_gram_mma_smem_bytes(k, T, stages + 1, nf, has_a)
    assert (stages == fused.UPDATE_MMA_MAX_STAGES
            or deeper + fused.RING_BARRIER_BYTES > H100_SMEM)
    with pytest.raises(ValueError, match="1 to 64 rows"):
        fused.update_gram_mma_plan(65, n, nf, has_a, H100_SMEM, H100_SMS)


def _mma_gram_split(W):
    """``csrc/mma.cuh`` MmaGram<W>: (MT, NT, QM, QN, P, TM, TN)."""
    MT, NT = (W + 15) // 16, W // 8
    QM = 2 if W >= 64 else 1
    QN = 4 if W == 96 else 2 if W >= 48 else 1
    P = 8 // (QM * QN)
    return MT, NT, QM, QN, P, MT // QM, NT // QN


def _gram_width(k):
    return next(w for w in fused.GRAM_WIDTHS if k <= w)


def _st_mma_split(k):
    """``csrc/stencil.cu`` StMma<W> for a launch of k rows (W 8, 16, 32 or
    64, 48 rows taking 64's): (MT, NT, QM, QN, P, TM, TN) of its 16 warps."""
    W = 8 if k <= 8 else 16 if k <= 16 else 32 if k <= 32 else 64
    MT, NT = (W + 15) // 16, W // 8
    QM = 2 if W >= 64 else 1
    QN = 1 if W == 8 else 4 if W >= 64 else 2
    P = 16 // (QM * QN)
    return MT, NT, QM, QN, P, MT // QM, NT // QN


@pytest.mark.parametrize("k,n,T", [(32, 3000, 1024), (12, 777, 256), (40, 1000, 768),
                                   (48, 2048, 512), (64, 1100, 256), (5, 300, 128)])
def test_stencil_mma_schedule_covers_x_and_y_once(k, n, T):
    """``csrc/stencil.cu`` stencil_mma's schedule in numpy: warp (p, q) of
    the 16 takes the 16-column steps p, p + P, ... of each tile; lane (g, t)
    computes Y rows 8 (nt0 + j) + g (clamped to k - 1) at the tile's columns
    c0 + 4t .. c0 + 4t + 3 and stores those of the first row group below k and
    n; the warp's mma fragments (mt0 + a, nt0 + b) take X rows 16 (mt0 + a)
    .. + 15 over the step's 16 columns. Every Y entry is stored exactly
    once; every product X[r, c] Y[s, c] (r, s < k, c < n) enters G exactly
    once; and the Gram of the f32 sums in three bf16 pieces is X Y^T
    exactly (in f64), which two pieces are not."""
    MT, NT, QM, QN, P, TM, TN = _st_mma_split(k)
    assert P * QM * QN == 16 and QM * TM == MT and QN * TN == NT
    stored = np.zeros((k, n), dtype=int)
    products = np.zeros((k, k, n), dtype=int)
    for i0 in range(0, n, T):
        for warp in range(16):
            p, q = warp % P, warp // P
            mt0, nt0 = q // QN * TM, q % QN * TN
            for c0 in range(16 * p, T, 16 * P):
                for g in range(8):
                    for t in range(4):
                        for j in range(TN):
                            r = 8 * (nt0 + j) + g
                            for dc in range(4):
                                col = i0 + c0 + 4 * t + dc
                                if r < k and q // QN == 0 and col < n:
                                    stored[r, col] += 1
                cols = np.arange(i0 + c0, min(i0 + c0 + 16, n))
                xr = [r for m in range(TM) for r in range(16 * (mt0 + m), 16 * (mt0 + m) + 16)
                      if r < k]
                yr = [s for j in range(TN) for s in range(8 * (nt0 + j), 8 * (nt0 + j) + 8)
                      if s < k]
                if len(cols):
                    products[np.ix_(xr, yr, cols)] += 1
    assert (stored == 1).all()
    assert (products == 1).all()
    rng = np.random.default_rng(k)
    X = _bf16_round(rng.standard_normal((k, n))).astype(np.float64)
    Yf = (rng.standard_normal((k, n)) * 10.0 ** rng.integers(-3, 3, (k, n))).astype(np.float32)
    hi = _bf16_round(Yf)
    mid = _bf16_round((Yf - hi).astype(np.float32))
    lo = _bf16_round((Yf - hi - mid).astype(np.float32))
    want = X @ Yf.astype(np.float64).T
    three = X @ (hi.astype(np.float64) + mid + lo).T
    two = X @ (hi.astype(np.float64) + mid).T
    assert np.array_equal(three, want) and not np.array_equal(two, want)


@pytest.mark.parametrize("k", [8, 12, 32, 40, 64])
def test_update_gram_mma_schedule_covers_y_once(k):
    """``csrc/update_gram.cuh`` update_gram_mma in numpy: warp w owns the
    16-row tile w / CG of Y (CG = 8 / (W / 16)) and every CG-th 16-column
    pair of a tile, so every Y entry of a tile is written once; the
    symmetric Gram (MmaGram<gram_width(k)>, fragments with nt >= 2 mt, the
    rest mirrored) holds every entry r <= s of the padded Gram exactly once
    a column step, so each G entry of the stored Y is one sum, exactly
    symmetric."""
    W = next(w for w in fused.UPDATE_MMA_WIDTHS if k <= w)
    MT = W // 16
    CG = 8 // MT
    T = 256
    written = np.zeros((k, T), dtype=int)
    for warp in range(8):
        rg, cg = warp // CG, warp % CG
        for pair in range(cg, T // 16, CG):
            for r in range(16 * rg, 16 * rg + 16):
                if r < k:
                    written[r, 16 * pair:16 * pair + 16] += 1
    assert (written == 1).all()
    MTg, NTg, QM, QN, P, TM, TN = _mma_gram_split(_gram_width(k))
    held = np.zeros((16 * MTg, 8 * NTg, T // 16), dtype=int)
    for warp in range(8):
        p, q = warp % P, warp // P
        mt0, nt0 = q // QN * TM, q % QN * TN
        for step in range(p, T // 16, P):
            for i in range(TM):
                for j in range(TN):
                    if nt0 + j >= 2 * (mt0 + i):
                        held[16 * (mt0 + i):16 * (mt0 + i) + 16,
                             8 * (nt0 + j):8 * (nt0 + j) + 8, step] += 1
    upper = np.triu(np.ones((k, k), dtype=bool))
    assert (held[:k, :k][upper] == 1).all()


# ------------- bf16 row 9 on the tensor cores, row 2w in column blocks


@pytest.mark.parametrize("k,n,T,stages", [
    (32, 256 ** 3, 512, 2),  # config 5's inner shape: the lean path
    (48, 32 ** 4, 256, 2),   # 64-row boxes and C's pieces in shared memory
    (64, 2 ** 20, 128, 3),
    (16, 512 ** 2, 512, 4),
    (12, 777, 128, 4),       # a small field: 128 columns
])
def test_px_update_mma_plan_of_the_main_shapes(k, n, T, stages):
    """bf16 ``px_update`` on the tensor cores: the widest tile whose ring of
    W, P and X holds two stages beside the tile of Pn (and C's three pieces
    at the 64-row width) at one block an SM, as deep as fits up to
    ``UPDATE_MMA_MAX_STAGES``, within the H100's 232,448 bytes; more than 64
    rows are refused (the f32-FMA kernel's chunks take them)."""
    plan = fused.px_update_mma_plan(k, n, H100_SMEM, H100_SMS)
    assert (plan.T, plan.stages) == (T, stages)
    assert plan.smem_bytes == fused.px_update_mma_smem_bytes(k, T, stages)
    assert plan.smem_bytes + fused.RING_BARRIER_BYTES <= H100_SMEM
    w = next(w for w in fused.UPDATE_MMA_WIDTHS if k <= w)
    assert plan.smem_bytes == (2 * T * (stages * (2 * w + fused.round8(k)) + fused.round8(k))
                               + (3 * 64 * 128 if w == 64 else 0) + 1024)
    deeper = fused.px_update_mma_smem_bytes(k, T, stages + 1)
    assert (stages == fused.UPDATE_MMA_MAX_STAGES
            or deeper + fused.RING_BARRIER_BYTES > H100_SMEM)
    for t in fused.UPDATE_MMA_TILES:  # no wider tile holds two stages
        if T < t <= max(128, n // H100_SMS):
            assert fused.px_update_mma_smem_bytes(k, t, 2) + fused.RING_BARRIER_BYTES > H100_SMEM
    for bad in (0, 65, 96):
        with pytest.raises(ValueError, match="1 to 64 rows"):
            fused.px_update_mma_plan(bad, n, H100_SMEM, H100_SMS)


@pytest.mark.parametrize("k", [96, 128])
@pytest.mark.parametrize("dsize", [2, 4])  # bf16 diagonals, or f32 ones with a bf16 field
def test_stencil_mma_plan_takes_the_gram_rows(k, dsize):
    """The column-block launches of a bf16 field's Gram on the 128^3
    Laplacian at k = 96 and 128: every launch's plan, with the Gram's rows
    (the centre of the other chunks' X staged beside it), fits the H100 at
    one block an SM; its bytes are ``mma_cols_smem_bytes``'s; and a Gram
    beyond ``MMA_COLS_FRAGS`` fragments of 16 x 8 is refused."""
    shape = (128, 128, 128)
    n, offsets = int(np.prod(shape)), _lap_offsets(shape)
    launches = stencil.wide_gram_launches(k)
    runs = [(0, k)]  # the Gram's rows of each launch: all of them
    assert launches == [(r0, r1, a0, a1) for r0, r1 in _native.row_chunks(k) for a0, a1 in runs]
    for r0, r1, a0, a1 in launches:
        kc, own = r1 - r0, a0 <= r0 < a1
        others = a1 - a0 - (kc if own else 0)
        plan = stencil.stencil_mma_plan(offsets, n, kc, H100_SMEM, H100_SMS, dsize, a1 - a0,
                                        own)
        assert (plan.h, plan.T, plan.near.count(False)) == (128, 128, 2)
        assert plan.smem_bytes == stencil.mma_cols_smem_bytes(kc, 7, 2, 128, 128, others, dsize)
        assert plan.smem_bytes + stencil.MMA_STATIC_BYTES <= H100_SMEM
        r8, L = -(-kc // 8) * 8, stencil.mma_window_ld(128, 128)
        stage = 2 * 2 * 128 * r8 + 2 * kc * L + dsize * 7 * 128
        assert plan.smem_bytes == (2 * stage + 4 * kc * stencil.mma_sums_ld(128)
                                   + 2 * others * stencil.mma_tile_ld(128) + 1024)
    assert stencil.mma_sums_ld(128) % 32 == 16 and stencil.mma_sums_ld(128) >= 128
    assert [stencil.mma_cols_gram_rows(kc) for kc in (64, 48, 41, 40, 32)] == [
        128, 128, 128, 192, 256]
    with pytest.raises(ValueError, match="at most 128 rows"):
        stencil.stencil_mma_plan(offsets, n, 64, H100_SMEM, H100_SMS, 2, 144)


@pytest.mark.parametrize("k", [65, 72, 96, 128, 130, 200])
def test_wide_gram_column_blocks_cover_every_entry_once(k):
    """``csrc/stencil.cu`` stencil_mma_cols's schedule in numpy, over the
    launches of ``wide_gram_launches``: in a launch of Y's rows r0:r1 whose
    Gram takes X's rows a0:a1 (RG = ceil(kc / 8) column tiles, MT =
    ceil(ga / 16) m-tiles in MG = 16 // RG groups of TM), warp w < MG RG
    owns the column tile nt = w % RG and the m-tiles (w // RG) TM + i, i <
    tm, over all of a tile's 16-column steps, lane (g, t) holding entries
    (16 mt + g + 8 (e / 2), 8 nt + 2 t + e % 2), at most ``MMA_COLS_FW``
    m-tiles a warp. Every entry of G is held by exactly one lane of one
    launch, so each is one running sum and nothing is reduced inside a
    block; every product X[a, c] Y[s, c] enters it once a column; each
    launch's SpMM units cover its rows of Y once a tile, and each row of Y
    is stored by one launch; and every row of X the Gram takes comes from
    the window (the launch's own rows) or from the centre copy, whose rows
    are exactly the others, once each."""
    T = 128
    launches = stencil.wide_gram_launches(k)
    assert sorted({(r0, r1) for r0, r1, _, _ in launches}) == _native.row_chunks(k)
    held = np.zeros((k, k), dtype=int)
    stored = np.zeros(k, dtype=int)
    for r0, r1, a0, a1 in launches:
        kc, ga = r1 - r0, a1 - a0
        own = r0 - a0 if a0 <= r0 < a1 else -1
        RG, MT = -(-kc // 8), -(-ga // 16)
        MG = 16 // RG
        TM = -(-MT // MG)
        assert TM <= stencil.MMA_COLS_FW and ga <= stencil.mma_cols_gram_rows(kc)
        block = np.zeros((ga, kc), dtype=int)
        products = np.zeros((ga, kc), dtype=int)
        for warp in range(16):
            nt, mg = warp % RG, warp // RG
            tm = max(0, min(TM, MT - mg * TM)) if warp < MG * RG else 0
            for i in range(tm):
                mt = mg * TM + i
                for g in range(8):
                    for t in range(4):
                        for e in range(4):
                            r, s = 16 * mt + g + 8 * (e // 2), 8 * nt + 2 * t + e % 2
                            if r < ga and s < kc:
                                block[r, s] += 1
                products[16 * mt:16 * mt + 16, 8 * nt:8 * nt + 8] += 1  # each column step once
        assert (block == 1).all() and (products[:ga, :kc] == 1).all()
        held[a0:a1, r0:r1] += block
        units = np.zeros((kc, T), dtype=int)
        nunits = RG * (T // 16)
        for warp in range(16):
            for u0 in range(warp, nunits, 2 * 16):
                for b in range(2):
                    u = min(u0 + 16 * b, nunits - 1)
                    if u0 + 16 * b >= nunits:
                        continue  # a repeat of the last unit, not kept
                    for g in range(8):
                        r = 8 * (u % RG) + g
                        if r < kc:
                            units[r, 16 * (u // RG):16 * (u // RG) + 16] += 1
        assert (units == 1).all()
        if own >= 0:
            stored[r0:r1] += 1
        others = ga - (kc if own >= 0 else 0)
        centre = [j + kc if own >= 0 and j >= own else j for j in range(others)]
        from_window = [a for a in range(ga) if own >= 0 and own <= a < own + kc]
        slab = [a - kc if own >= 0 and a >= own + kc else a for a in range(ga)
                if a not in from_window]
        assert sorted(centre + from_window) == list(range(ga))
        assert [centre[j] for j in slab] == [a for a in range(ga) if a not in from_window]
    assert (held == 1).all() and (stored == 1).all()


# ------------- row 10 (xr_update_gram) on the streaming schedule


def _h100(monkeypatch, sms=H100_SMS):
    monkeypatch.setattr(_native, "max_smem", lambda index: H100_SMEM)
    monkeypatch.setattr(_native, "sm_count", lambda index: sms)


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("k", [8, 16, 32, 48, 64])
def test_xr_update_gram_plan_is_one_launch_with_its_gram(monkeypatch, k, esize):
    """Up to 64 rows ``xr_update_gram`` is one launch of ``csrc/xr_update.cu``
    with the fused Gram, reading P and Z once in one stage a tile (kc = 2k
    stacked rows), at two blocks an SM up to 32 rows and one above; its
    shared bytes, as the kernel counts them (one alpha table, two stages of
    [P; Z] and on bf16 fields of [X; R], the Rn tile and the Gram's scratch
    floor), fit the H100's cap at the blocks an SM the plan claims. On f32
    fields the stages are those of rows 7-9's plans."""
    _h100(monkeypatch)
    plan = fused.xr_update_gram_plan(k, torch.device("cpu"), esize)
    assert plan.chunks == [(0, k)] and plan.kc == 2 * k
    assert plan.blocks_per_sm == (2 if k <= 32 else 1)
    assert plan.smem_bytes == fused.xr_smem_bytes(k, k, plan.kc, esize)
    rp = 8 * fused.rows_per_warp(k)
    rows = plan.kc + (2 * k if esize == 2 else 0)
    assert plan.smem_bytes == max(4 * (k * rp + k * fused.UPDATE_LD)
                                  + esize * 2 * rows * fused.UPDATE_TILE,
                                  4 * 256 * (64 if k > 32 else 16))
    if esize == 4:
        assert plan.smem_bytes == fused.update_smem_bytes(k, k, plan.kc, 1, True)
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= H100_SMEM + 1024
    assert plan.grid == plan.blocks_per_sm * H100_SMS


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("k,chunk", [(96, 48), (128, 64)])
def test_xr_update_gram_plan_chunks_wider_fields(monkeypatch, k, chunk, esize):
    """Above 64 rows the plan runs row chunks of at most 64 rows that cover
    the field, each launch with the Gram of its own rows (``wide_gram``
    adds the cross blocks) and contracting over all k rows of P and Z, in
    shared memory that fits at one block an SM."""
    _h100(monkeypatch)
    plan = fused.xr_update_gram_plan(k, torch.device("cpu"), esize)
    assert plan.chunks == _native.row_chunks(k, 64) == [(0, chunk), (chunk, k)]
    assert plan.blocks_per_sm == 1 and 1 <= plan.kc <= 2 * k
    assert plan.smem_bytes == fused.xr_smem_bytes(chunk, k, plan.kc, esize)
    assert plan.smem_bytes <= H100_SMEM
    gram = fused.gram_blocks(k, plan.chunks, True)
    assert [b[0] for b in gram].count("diag") == len(plan.chunks)


@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_xr_update_gram_grid_follows_the_card_not_n(monkeypatch, sms):
    """The wrapper launches every chunk on the plan's grid (blocks an SM
    times the card's SMs) and sizes its Gram partials by it, whatever n:
    the launch arguments on the kernel route, recorded on the CPU."""
    _h100(monkeypatch, sms)
    monkeypatch.setattr(_native, "field_kernel", lambda fields, coeffs=(): torch.float32)
    calls, parts = [], []
    monkeypatch.setattr(_native, "launch", lambda name, fn, device, *a: calls.append((name, a)))
    real = fused._gram_buffers

    def buffers(k, n, device, blocks=None):
        part, G = real(k, n, device, blocks)
        parts.append(part.shape[0])
        return part, G
    monkeypatch.setattr(fused, "_gram_buffers", buffers)
    for k, n in ((16, 3001), (16, 512 ** 2), (48, 700), (96, 40000)):
        calls.clear()
        parts.clear()
        alpha = torch.zeros((k, k))
        fields = [torch.zeros((k, n)) for _ in range(4)]
        fused.xr_update_gram(alpha, *fields)
        plan = fused.xr_update_gram_plan(k, torch.device("cpu"))
        xr = [a for name, a in calls if name == "xr_update_gram"]
        assert [a[9:] for a in xr] == [(r1 - r0, k, n, plan.kc, plan.grid)
                                       for r0, r1 in plan.chunks]
        assert parts == [plan.grid] * len(plan.chunks)
        assert plan.grid == (2 if k <= 32 else 1) * sms


def test_xr_update_gram_source_mirrors_its_plan():
    """``csrc/xr_update.cu`` builds what ``xr_update_gram_plan`` and the
    library's argument types assume: the blocks an SM of rows 7 and 8, the
    shared bytes of ``xr_smem_bytes`` (one coefficient table, the stages,
    on bf16 fields with X and R, the Gram), the register widths of
    ``rows_per_warp`` up to 64 rows, and a kc and a grid after n; the
    one-thread-a-column kernel is gone."""
    xr = (CSRC / "xr_update.cu").read_text()
    assert "kXrBlocksPerSm = GK <= 32 ? 2 : 1;" in xr
    assert "const size_t smem = xr_smem_bytes(k, kin, kc, sizeof(E));" in xr
    assert "constexpr bool kStageXR = sizeof(E) == 2;" in xr
    assert ("const long long rows = kc + (esize == 2 ? 2LL * k : 0);\n"
            "  const long long b = 4 * (8LL * rows_per_warp(k) * kin + 1LL * k * kUpLd) +\n"
            "                      esize * kUpStages * rows * kUpTile;" in xr)
    assert "const long long scratch = 4LL * kUpThreads * (k > 32 ? 64 : 16);" in xr
    built = re.findall(r"case (\d+): BCG_XR\((\d+), (\d+)\);", xr)
    assert [(int(a), int(b), int(c)) for a, b, c in built] == [
        (1, 1, 8), (2, 2, 16), (4, 4, 32), (6, 6, 48), (8, 8, 64)]
    assert [fused.rows_per_warp(k) for k in (8, 16, 32, 48, 64)] == [1, 2, 4, 6, 8]
    assert "SymGram<GK, kUpThreads, (GK > 32 ? 8 : 4)>" in xr
    assert "int kc, int max_blocks, int device, cudaStream_t stream)" in xr
    assert "GramTile<" not in xr and "kmax_for(" not in xr and "kThreads)" not in xr
    native = (Path(_native.__file__)).read_text()
    assert ("lib.bcg_xr_update_gram.argtypes = [P, P, P, P, P, P, P, P, P, I, I, L, I, I, I, P]"
            in native)


# ------- rows 2 and 2m (an f32 field with its Gram) on the tensor cores, rows
# 23h and 24h (bf16 blocks) on TMA tensor boxes: plans and schedules


@pytest.mark.parametrize("k,h,T", [(8, 128, 256), (16, 128, 256), (32, 128, 256)])
@pytest.mark.parametrize("dsize", [4, 2])  # f32 (row 2) or bf16 (row 2m) diagonals
def test_stencil_mma_f32_plan_of_the_north_star(k, h, T, dsize):
    """``stencil_mma_f32_plan`` at the north star's 128^3 (the [storage]
    shape of rows 2 and 2m): 0, +-1 and +-128 from the window, +-16384 from
    L2; the shared memory as the source counts it fits the H100's 227 KB at
    one block an SM; no tile of ``MMA_F32_TILES`` with less traffic fits;
    33 rows and more are refused (``stencil_vec_gram_plan``'s)."""
    n, offsets = _PRESETS["lap_128^3"]
    plan = stencil.stencil_mma_f32_plan(offsets, n, k, H100_SMEM, H100_SMS, dsize)
    assert (plan.h, plan.T, sum(plan.near), plan.blocks_per_sm) == (h, T, 5, 1)
    assert plan.smem_bytes == stencil.mma_f32_smem_bytes(k, 7, h, T, dsize)
    assert plan.smem_bytes + stencil.MMA_STATIC_BYTES <= H100_SMEM
    assert plan.traffic == pytest.approx((T + 2 * h) / T + 2)
    L = stencil.mma_f32_window_ld(h, T)
    assert L >= T + 2 * h and L % 32 == 16 and L - (T + 2 * h) < 32
    for t in stencil.MMA_F32_TILES:
        for hh in (0, 4, 128):
            traffic = (t + 2 * hh) / t + sum(min(o % n, n - o % n) > hh for o in offsets)
            if traffic < plan.traffic:
                assert (stencil.mma_f32_smem_bytes(k, 7, hh, t, dsize) + stencil.MMA_STATIC_BYTES
                        > H100_SMEM)
    with pytest.raises(ValueError, match="1 to 32 rows"):
        stencil.stencil_mma_f32_plan(offsets, n, 33, H100_SMEM, H100_SMS, dsize)


@pytest.mark.parametrize("k,h,near", [(33, 128, 5), (48, 4, 3), (64, 4, 3)])
@pytest.mark.parametrize("dsize", [4, 2])  # f32 (row 2) or bf16 (row 2m) diagonals
def test_stencil_vec_gram_plan_of_the_north_star(k, h, near, dsize):
    """``stencil_vec_gram_plan`` at the north star's 128^3 (rows 2 and 2m
    at 33 to 64 rows): one block an SM on ``vec_gram_smem_bytes`` (the
    window kernel's f32 windows and coefficient tiles, then the tile of Y,
    at least the four VecGram copies' tiles), within the H100's 227 KB; T =
    256 and at 33 rows h = 128 (0, +-1 and +-128 from the window), from 48
    rows h = 4 (0 and +-1: a halo of 128 no longer fits beside the tile of
    Y); no (h, T) of ``TILES`` with less traffic per busy thread fits; 32
    rows and fewer, and more than 64, are refused."""
    n, offsets = _PRESETS["lap_128^3"]
    plan = stencil.stencil_vec_gram_plan(offsets, n, k, H100_SMEM, H100_SMS, dsize)
    assert (plan.h, plan.T, sum(plan.near), plan.blocks_per_sm) == (h, 256, near, 1)
    assert plan.smem_bytes == stencil.vec_gram_smem_bytes(k, 7, h, 256, dsize) <= H100_SMEM
    assert plan.smem_bytes == (stencil.smem_bytes(k, 7, h, 256, 4, dsize)
                               + 4 * max(k * 260, stencil.VEC_GRAM_SCRATCH))
    assert plan.traffic == pytest.approx((256 + 2 * h) / 256 + 7 - near)
    for t in stencil.TILES:
        for hh in (0, 4, 128, 16384):
            traffic = (t + 2 * hh) / t + sum(min(o % n, n - o % n) > hh for o in offsets)
            if traffic / (t / stencil.THREADS) < plan.traffic:
                assert stencil.vec_gram_smem_bytes(k, 7, hh, t, dsize) > H100_SMEM
    for bad in (32, 65):
        with pytest.raises(ValueError, match="33 to 64 rows"):
            stencil.stencil_vec_gram_plan(offsets, n, bad, H100_SMEM, H100_SMS, dsize)


@pytest.mark.parametrize("k,n,T,offsets", [
    (32, 3000, 256, (0, 1, -1, 128, -128, 1300, -1301)),  # ragged n, misaligned far offsets
    (12, 777, 128, (-5, -1, 0, 1, 3)),
    (24, 2048, 256, (0, 2, -2, 3, -3, 64, -64)),
    (32, 1100, 256, (0, 1, -1, 600)),
    (5, 300, 128, (0, 1, 299)),
])
def test_stencil_mma_f32_schedule_covers_y_and_g_once(k, n, T, offsets):
    """``csrc/stencil.cu`` stencil_mma_f32's schedule in numpy: warp (p, q)
    of the 16 takes the 16-column steps p, p + P, ... of each tile (StMma);
    lane (g, t) computes the Y rows 8 (nt0 + j) + g at columns c0 + 4t .. +
    3 and stores those of the first row group below k and n; the warp's
    fragments take X rows 16 (mt0 + m) + g and + 8 of the window's centre.
    Every Y entry is stored exactly once, every product X[r, c] Y[s, c]
    enters G exactly once; each near diagonal's quad read (``window_quads``:
    one, or two aligned, 16-byte reads, or two 8-byte reads) stays within
    its row's T + 2h columns and covers columns h + s + c .. + 3 of the
    window, and the window holds X[:, (i + s) mod n] there."""
    MT, NT, QM, QN, P, TM, TN = _st_mma_split(k)
    plan = stencil.stencil_mma_f32_plan(offsets, n, k, H100_SMEM, 4)
    assert plan.T == T
    h = plan.h
    stored = np.zeros((k, n), dtype=int)
    products = np.zeros((k, k, n), dtype=int)
    for i0 in range(0, n, T):
        window_cols = (i0 - h + np.arange(T + 2 * h)) % n
        for warp in range(16):
            p, q = warp % P, warp // P
            mt0, nt0 = q // QN * TM, q % QN * TN
            for c0 in range(16 * p, T, 16 * P):
                for t in range(4):
                    c = c0 + 4 * t
                    for o in offsets:
                        o %= n
                        if min(o, n - o) > h:
                            continue
                        s = o if o <= h else o - n
                        reads = {0: [s], 2: [s, s + 2], 1: [s - 1, s + 3], 3: [s - 3, s + 1]}[s & 3]
                        width = 4 if s & 3 != 2 else 2
                        got = set()
                        for r0 in reads:
                            lo, hi_ = h + c + r0, h + c + r0 + width
                            assert (h + c + r0) % width == 0 and 0 <= lo and hi_ <= T + 2 * h
                            got |= set(range(lo, hi_))
                        assert set(range(h + c + s, h + c + s + 4)) <= got
                        cols = np.arange(i0 + c, i0 + c + 4)
                        assert (window_cols[h + c + s:h + c + s + 4] == (cols + o) % n).all()
                    for g in range(8):
                        for j in range(TN):
                            r = 8 * (nt0 + j) + g
                            for dc in range(4):
                                col = i0 + c + dc
                                if r < k and q // QN == 0 and col < n:
                                    stored[r, col] += 1
                cols = np.arange(i0 + c0, min(i0 + c0 + 16, n))
                xr = [r for m in range(TM) for r in range(16 * (mt0 + m), 16 * (mt0 + m) + 16)
                      if r < k]
                yr = [s_ for j in range(TN) for s_ in range(8 * (nt0 + j), 8 * (nt0 + j) + 8)
                      if s_ < k]
                if len(cols):
                    products[np.ix_(xr, yr, cols)] += 1
    assert (stored == 1).all()
    assert (products == 1).all()


def _split3(v):
    """``csrc/mma.cuh`` split3 of f32 values: hi, mid, lo (f32 arrays of
    bf16 values), each difference taken in f32."""
    v = np.asarray(v, np.float32)
    hi = _bf16_round(v)
    r1 = (v - hi).astype(np.float32)
    mid = _bf16_round(r1)
    lo = _bf16_round((r1 - mid).astype(np.float32))
    return hi.astype(np.float64), mid.astype(np.float64), lo.astype(np.float64)


def test_six_products_of_the_split_hold_an_f32_product():
    """stencil_mma_f32's Gram of an f32 X and the f32 sums Y: both split into
    three exact bf16 pieces, the six products of weight at least 2^-24 of hi
    x hi (hi hi, hi mid, mid hi, hi lo, lo hi, mid mid), each exact in f32,
    give x y within 2^-22 |x y| on random and extreme values (2^-100 ..
    2^100, negative, zero); without mid x mid (five products) they do not.
    Summed in f64 over 4,096 columns the six give a dot product within f32
    rounding (2^-24) of the exact one, as VecGram's f32 FMAs do not."""
    rng = np.random.default_rng(20)
    x = np.concatenate([rng.standard_normal(8192),
                        rng.standard_normal(2048) * 2.0 ** rng.integers(-100, 100, 2048),
                        np.array([1 + 2.0 ** -10 + 2.0 ** -20, -(1 + 2.0 ** -23), 0.0, -0.0,
                                  3.0e30, 2.0 ** -100])]).astype(np.float32)
    y = rng.permutation(x).astype(np.float32)
    xh, xm, xl = _split3(x)
    yh, ym, yl = _split3(y)
    exact = x.astype(np.float64) * y.astype(np.float64)
    five = xh * yh + xh * ym + xm * yh + xh * yl + xl * yh
    six = five + xm * ym
    bound = 2.0 ** -22 * np.abs(exact)
    assert (np.abs(six - exact) <= bound).all()
    assert (np.abs(five - exact) > bound).any()
    X = rng.standard_normal((4, 4096)).astype(np.float32)
    Y = rng.standard_normal((4, 4096)).astype(np.float32)
    Xs, Ys = _split3(X), _split3(Y)
    G = sum(a @ b.T for a, b in ((Xs[0], Ys[0]), (Xs[0], Ys[1]), (Xs[1], Ys[0]),
                                  (Xs[0], Ys[2]), (Xs[2], Ys[0]), (Xs[1], Ys[1])))
    G64 = X.astype(np.float64) @ Y.astype(np.float64).T
    scale = np.abs(X).astype(np.float64) @ np.abs(Y).astype(np.float64).T
    assert (np.abs(G - G64) <= 2.0 ** -24 * scale).all()


def _tma_stages(plan, ns, offsets):
    """``csrc/block_stencil.cu`` bs_tma's producer in numpy: for each tile
    of T sites, the window (a box of T + 2h sites from (i0 - h) mod ns, unless
    it crosses ns) and each far diagonal's slab (a box of T sites from (i0 +
    o) mod ns, where o % 4 == 0 and the box stays within ns); a box's site
    coordinate and the sites it holds, or the copied sites (mod ns) where
    the producer's lanes copy it. Returns {(i0, d or 'w'): (route, sites)}."""
    T, h = plan.T, plan.h
    out = {}
    for i0 in range(0, ns, T):
        c0 = (i0 - h) % ns
        W = T + 2 * h
        sites = (c0 + np.arange(W)) % ns
        out[(i0, "w")] = ("box" if c0 + W <= ns else "copy", c0, sites)
        for d, o in enumerate(offsets):
            o %= ns
            if min(o, ns - o) <= h:
                continue
            c0 = (i0 + o) % ns
            box = o % 4 == 0 and c0 + T <= ns
            out[(i0, d)] = ("box" if box else "copy", c0, (c0 + np.arange(T)) % ns)
    return out


@pytest.mark.parametrize("k", [12, 24])
def test_block_stencil_tma_boxes_cover_each_source_once(k):
    """bs_tma's stages on ``dirac_gauged_matrix(8)``'s 15 offsets (4,096
    sites, k = 12 and 24), the plan's h and T: every box starts on a 16-byte
    boundary (a site coordinate that is a multiple of 4) and lies within
    [0, ns); the window of tile i0 holds the sources (i0 + c + s) mod ns of
    every near diagonal's sites c at h + s + c, and each far diagonal's slab
    (box or copy) the source (i0 + c + o) mod ns of site c, exactly once a
    site; the tiles' centre sites cover every site once; the 3-D box of the
    merged field lays staged row b * k + i from merged row b * ks + i."""
    bs, L = 4, 8
    ns, offsets = L ** 4, _dirac_offsets(L)
    offs = tuple(o % ns for o in offsets)
    plan = bsk.block_stencil_plan(offs, ns, bs, k, False, H100_SMEM, H100_SMS, csize=2, tma=True)
    assert plan.tma and plan.T + 2 * plan.h <= bsk.TMA_MAX_BOX
    stages = _tma_stages(plan, ns, offs)
    T, h = plan.T, plan.h
    centre = np.zeros(ns, dtype=int)
    routes = set()
    for (i0, d), (route, c0, sites) in stages.items():
        routes.add((d == "w", route))
        if route == "box":
            assert c0 % 4 == 0 and 0 <= c0 and c0 + len(sites) <= ns
        if d == "w":
            live = np.arange(T)[i0 + np.arange(T) < ns]
            centre[i0 + live] += 1
            for o in offs:
                if min(o, ns - o) <= h:
                    s = o if o <= h else o - ns
                    assert (sites[h + s + live] == (i0 + live + o) % ns).all()
        else:
            assert (sites == (i0 + np.arange(T) + offs[d]) % ns).all()
            assert len(set(sites.tolist())) == T
    assert (centre == 1).all()
    # both routes run: boxes, and copies of the windows across ns and (h = 64
    # at k = 12 on tiles of 128 sites) of the far slabs whose boxes would
    # cross ns ((i0 + 448) mod ns + 128 > ns)
    assert {(True, "box"), (True, "copy"), (False, "box")} <= routes
    assert ((False, "copy") in routes) is (plan.T == 128)
    # The 3-D map (ns, k, bs) with strides (ns, ks ns) elements: box element
    # (c, i, b) at staged row b * k + i holds merged row b * ks + i.
    ks = k + 3  # a chunk of k right-hand sides of a wider field
    staged = [b * ks + i for b in range(bs) for i in range(k)]
    assert staged == [(r // k) * ks + r % k for r in range(bs * k)]



def _bs_tma_offsets(ns):
    """tests/test_torch_kernels_cuda.py ``_bs_tma_operands``' offsets: near
    (0, +-1, 17, -60, 64, wraps ns - 1 and -ns - 4) and far (450 and ns +
    401 off a 16-byte boundary, -412 on one)."""
    return (0, 1, -1, 17, -60, 64, ns - 1, -ns - 4, 450, -412, ns + 401)


def test_block_stencil_tma_plan_of_the_matrix_link():
    """Rows 23h and 24h: the merged (48, 32^4) launch on bf16 blocks takes
    ``bs_tma``'s schedule (h = 32, two groups of 6 over 128 sites, the 0,
    +-1, +-31 and +-32 diagonals from the window) with the deepest ring that
    fits 227 KB as the source counts it (5 stages), the same traffic as
    ``bs_spmm``'s; a launch whose boxes would move more than ``bs_spmm``
    keeps ``bs_spmm``: a tile of 256 sites that leaves the boxes no halo (T +
    2h <= 256; one RHS at 32^4: 15 against 9.25, six RHS on
    ``dirac_gauged_matrix(8)``: 15 against 5.5), a halo ``bs_spmm``'s wider
    window makes near (4.0 against 3.375); a pin of the depth holds."""
    ns, offsets = _BS_PRESETS["matrix_32^4"]
    offs = tuple(o % ns for o in offsets)
    plan = bsk.block_stencil_plan(offs, ns, 4, 12, False, H100_SMEM, H100_SMS, csize=2, tma=True)
    assert plan.tma and (plan.h, plan.T, plan.groups, plan.ki, plan.stages, sum(plan.near)) == (
        32, 128, 2, 6, 5, 7)
    assert plan.smem_bytes == bsk.tma_smem_bytes(4, 12, 128, 32, 5, True)
    assert plan.smem_bytes + bsk.TMA_BARRIER_BYTES <= H100_SMEM
    assert bsk.tma_smem_bytes(4, 12, 128, 32, 6, True) + bsk.TMA_BARRIER_BYTES > H100_SMEM
    cp = bsk.block_stencil_plan(offs, ns, 4, 12, False, H100_SMEM, H100_SMS, csize=2)
    assert not cp.tma and cp.traffic == plan.traffic and cp.stages == 4
    one = bsk.block_stencil_plan(offs, ns, 4, 1, False, H100_SMEM, H100_SMS, csize=2, tma=True)
    cp1 = bsk.block_stencil_plan(offs, ns, 4, 1, False, H100_SMEM, H100_SMS, csize=2)
    assert one == cp1 and not one.tma and (one.h, one.T, one.traffic) == (32, 256, 9.25)
    assert bsk.block_stencil_plan(offs, ns, 4, 1, False, H100_SMEM, H100_SMS, csize=2,
                                  tma=True, h=0).tma  # 15 against 15: a pinned halo ties
    small = tuple(o % 8 ** 4 for o in _dirac_offsets(8))
    six = bsk.block_stencil_plan(small, 8 ** 4, 4, 6, False, H100_SMEM, H100_SMS, csize=2,
                                 tma=True)
    assert not six.tma and (six.h, six.T, six.traffic) == (64, 256, 5.5)
    # _bs_redesign_operands' offsets at 1,000 sites (tests/test_torch_kernels_cuda.py):
    # bs_spmm's h = 152 (traffic 3.375) against the boxes' h = 64 (4.0)
    wide = (0, 1, 999, 17, 850, 64, 999, 152, 996)
    tplan = bsk.block_stencil_plan(wide, 1000, 4, 12, False, H100_SMEM, H100_SMS, csize=2,
                                   tma=True)
    assert not tplan.tma and (tplan.h, tplan.traffic) == (152, 3.375)
    # _bs_tma_operands' offsets (the far ones beyond any halo either fits):
    # the same traffic, so the boxes
    for ns_ in (1000, 4096, 40_000):
        tofs = tuple(o % ns_ for o in _bs_tma_offsets(ns_))
        for bs_, k_ in ((4, 12), (3, 8), (8, 6), (4, 15), (2, 7), (4, 24)):
            t = bsk.block_stencil_plan(tofs, ns_, bs_, k_, False, H100_SMEM, H100_SMS, csize=2,
                                       tma=True)
            c = bsk.block_stencil_plan(tofs, ns_, bs_, k_, False, H100_SMEM, H100_SMS, csize=2)
            assert t.tma and t.traffic == c.traffic
    pinned = bsk.block_stencil_plan(offs, ns, 4, 12, False, H100_SMEM, H100_SMS, csize=2,
                                    tma=True, stages=3)
    assert pinned.tma and pinned.stages == 3


# ------------------------------------------- the bf16 field's ring of planes


def _ring_presets():
    """(n, offsets) of the ring's cases: the 7-point Laplacians, a 2-D grid of
    1,024-column rows, and banded offsets of reach M = 2 with odd residues."""
    return {
        "lap_256^3": (256 ** 3, _lap_offsets((256, 256, 256))),
        "lap_128^3": (128 ** 3, _lap_offsets((128, 128, 128))),
        "lap_64^3": (64 ** 3, _lap_offsets((64, 64, 64))),
        "grid_2048x1024": (2048 * 1024, _lap_offsets((2048, 1024))),
        "reach_2": (128 * 2048, (0, 2048, -2047, 4094, -4093, 5, -3)),
    }


@pytest.mark.parametrize("preset", sorted(_ring_presets()))
@pytest.mark.parametrize("k", [1, 8, 12, 32, 48, 64])
@pytest.mark.parametrize("dsize", [2, 4])
def test_stencil_ring_plan_fits_and_serves_every_offset(preset, k, dsize):
    """``stencil_ring_plan``: the launch fits 227 KB with its static bytes
    (as the kernel counts them); every offset is m S + r (mod n) with |r| <=
    h and |m| <= M, so a term reads slot j + m of a ring of 2M + 2; the
    boxes' granule divides h and the patch and P + 2h is at most 256
    granules; the items cover the row groups, patches and runs of planes,
    one block an SM at most; the traffic is the model's."""
    n, offsets = _ring_presets()[preset]
    plan = stencil.stencil_ring_plan(offsets, n, k, H100_SMEM, H100_SMS, dsize)
    assert plan is not None
    P, S, h, M = stencil.RING_COLS, plan.S, plan.h, plan.M
    assert plan.smem_bytes == stencil.ring_smem_bytes(plan.rows, h, plan.slots, len(offsets),
                                                      dsize)
    assert plan.smem_bytes + stencil.RING_STATIC_BYTES <= H100_SMEM
    assert n % S == 0 and S % P == 0 and h % 8 == 0 and 2 * h < S
    assert plan.slots == 2 * M + 2 <= stencil.RING_MAX_SLOTS and M >= 1
    for o, (m, r) in zip(offsets, stencil.ring_decompose(offsets, n, S)):
        assert (m * S + r - o) % n == 0 and abs(r) <= h and abs(m) <= M
    assert h % plan.granule == 0 and P % plan.granule == 0 and plan.granule >= 8
    assert (P + 2 * h) // plan.granule <= stencil.RING_BOX
    assert plan.rows in stencil.RING_ROWS[2] and (plan.rows == 8 or k > 8)
    npl, ngrp = n // S, -(-k // plan.rows)
    assert (plan.segs - 1) * plan.len < npl <= plan.segs * plan.len
    assert plan.items == S // P * ngrp * plan.segs and plan.grid == min(plan.items, H100_SMS)
    assert plan.traffic == pytest.approx((P + 2 * h) / P * (plan.len + 2 * M) / plan.len
                                         + len(offsets) * dsize * (ngrp - 1) / (2 * k))


def test_stencil_ring_plan_of_the_main_shapes():
    """Row 1b at (32, 256^3) on bf16 diagonals: planes of 65,536 columns,
    0, +-1 and +-256 near (h = 256), +-65,536 one slot away, a ring of four
    48 KB slots of 16 rows, 128 items of one run of 256 planes (traffic 1.73
    against the window's 5.0); row 1x at (32, 128^3) on f32 diagonals:
    16,384-column planes, h = 128, 16 rows, runs of 32 planes (128 items;
    1.77 against 4.0). Where no stride fits, None, and the launch keeps
    ``stencil_spmm``: planes narrower than a patch (512^2, 128^2), an n that
    is not a multiple of the patch, offsets that no stride dividing n takes
    (the banded ``near_n``), a reach past a ring of 8 slots."""
    big = stencil.stencil_ring_plan(_lap_offsets((256,) * 3), 256 ** 3, 32, H100_SMEM,
                                    H100_SMS, 2)
    assert (big.S, big.h, big.M, big.rows, big.slots, big.segs, big.len, big.items, big.grid,
            big.granule, big.smem_bytes) == (65536, 256, 1, 16, 4, 1, 256, 128, 128, 256, 225536)
    assert big.traffic == pytest.approx(1.5 * 258 / 256 + 7 * 2 / 64)
    window = stencil.stencil_plan(_lap_offsets((256,) * 3), 256 ** 3, 32, H100_SMEM, H100_SMS, 2, 2)
    assert window.traffic == 5.0 and big.traffic < window.traffic
    x = stencil.stencil_ring_plan(_lap_offsets((128,) * 3), 128 ** 3, 32, H100_SMEM, H100_SMS, 4)
    assert (x.S, x.h, x.M, x.rows, x.segs, x.len, x.items, x.grid, x.granule) == (
        16384, 128, 1, 16, 4, 32, 128, 128, 128)
    assert x.traffic == pytest.approx(1.25 * 34 / 32 + 7 * 4 / 64)
    assert stencil.stencil_plan(_lap_offsets((128,) * 3), 128 ** 3, 32, H100_SMEM, H100_SMS, 2,
                                4).traffic == 4.0
    assert "ring S=65536 h=256 P=1024 M=1 rows=16 depth=4 planes=256" in big.describe()
    for n, offsets in (_PRESETS["lap_512^2"], _PRESETS["lap_128^2"], _PRESETS["near_n"],
                       (1000 * 1024 + 8, (0, 1, -1, 1024, -1024)),
                       (16 * 4096, (0, 4096, 4 * 4096 + 1))):
        assert stencil.stencil_ring_plan(offsets, n, 32, H100_SMEM, H100_SMS, 2) is None


def _ring_schedule(n, offsets, k, plan):
    """The ring's schedule in numpy (``csrc/stencil.cu`` stencil_ring): each
    item's stages load windows into slots, each step reads them. Returns
    (times each Y entry is stored, whether each refill hit a slot the step
    before it reads, the windows that cross 0 or n) and raises where a read
    finds another column than its term's source."""
    P, S, h, M, R = stencil.RING_COLS, plan.S, plan.h, plan.M, plan.rows
    npl, npatch, ngrp = n // S, S // P, -(-k // R)
    span = P + 2 * h
    dec = stencil.ring_decompose(offsets, n, S)
    stored = np.zeros((k, n), dtype=int)
    cols = 4 * np.arange(P // 4)[:, None] + np.arange(4)[None, :]  # thread t's columns
    races, wrapped = [], 0
    for b in range(plan.grid):
        slots = [None] * plan.slots
        reads_before = set()
        for it in range(b, plan.items, plan.grid):
            patch, rest = it % npatch, it // npatch
            c0, r0, j0 = patch * P, (rest % ngrp) * R, (rest // ngrp) * plan.len
            ln = min(plan.len, npl - j0)

            def window(v):
                w0 = c0 + ((j0 + v) % npl) * S - h
                return w0, (w0 + np.arange(span)) % n
            for s in range(ln):
                for v in (range(-M, M + 1) if s == 0 else (s + M,)):
                    w0, held = window(v)
                    sl = (v + M) % plan.slots
                    races.append((sl in reads_before) and s > 0)
                    if 0 <= w0 and w0 + span <= n:  # a box starts on a granule
                        assert w0 % plan.granule == 0
                    else:
                        wrapped += 1
                    slots[sl] = held
                j = (j0 + s) % npl
                read = set()
                for (m, r), o in zip(dec, offsets):
                    sl = (s + m + M) % plan.slots
                    read.add(sl)
                    got = slots[sl][h + r + cols]
                    assert np.array_equal(got, (c0 + j * S + cols + o) % n)
                reads_before = read  # what step s reads while stage s + 1 lands
                rows = np.arange(r0, min(r0 + R, k))
                stored[np.ix_(rows, (c0 + j * S + cols).ravel())] += 1
    return stored, races, wrapped


@pytest.mark.parametrize("preset,k", [("lap_64^3", 20), ("grid_2048x1024", 8),
                                      ("reach_2", 33), ("lap_64^3", 64)])
def test_stencil_ring_schedule_covers_y_once_and_reads_its_slots(preset, k):
    """A pure-Python oracle of the ring's schedule on the plan's S, h, M,
    rows and runs: every Y entry is stored exactly once; every column a term
    reads lies in the slot it reads from, at its column + h + r, also across
    the wrap at 0 and n (the first patch's first plane, the last patch's
    last, each run's first and last planes' neighbours taken mod the
    planes); the windows that come as boxes start on a granule; and the slot
    a stage refills is none that the step before it reads (a stage goes out
    once step s - 2 is done, while step s - 1 may still run)."""
    n, offsets = _ring_presets()[preset]
    plan = stencil.stencil_ring_plan(offsets, n, k, H100_SMEM, H100_SMS, 2)
    stored, races, wrapped = _ring_schedule(n, offsets, k, plan)
    assert (stored == 1).all()
    assert not any(races)
    assert wrapped > 0  # the windows that cross 0 and n were among them


def _folded_matrix_link(L):
    """``dirac_gauged_matrix(L)``'s folded offsets and ``fold``
    (problems/dirac.py under BLOCKCG_FOLD): 0, the t pair (its wrap is its own
    offset mod ns: not folded) and the z, y and x pairs, each folded on L."""
    offsets = (0, L ** 3, -L ** 3, L * L, -L * L, L, -L, 1, -1)
    return L ** 4, offsets, tuple((d, L) for d in range(3, 9))


@pytest.mark.parametrize("csize,with_gram,stages,fused", [(4, False, 4, None), (2, False, 5, None),
                                                          (4, True, 4, False), (2, True, 5, False)])
def test_block_stencil_tma_plan_of_the_folded_matrix_link(csize, with_gram, stages, fused):
    """Rows 24f (f32 and bf16 blocks) and 24fg: the folded (48, 32^4) launch
    takes ``bs_tma``: h = 32 (0 and the x pair, +-1 with -+31, from the
    window), two groups of 6 over 128 sites, the y pair's (st = 32) slabs as
    four boxes of 32 sites, the z (st = 1,024) and t pairs' as one, so 22
    requests a tile with the window and nine coefficient boxes; the deepest
    ring that fits (4 stages of f32 planes, 5 of bf16); with the Gram the
    same apply, the Gram from ``gram`` (not fused); bs_spmm's traffic,
    7.5."""
    ns, offsets, fold = _folded_matrix_link(32)
    offs = tuple(o % ns for o in offsets)
    wraps = tuple((d, t[0]) for d, t in sorted(bsk.fold_terms(offsets, fold, ns).items()))
    plan = bsk.block_stencil_plan(offs, ns, 4, 12, with_gram, H100_SMEM, H100_SMS, csize=csize,
                                  wraps=wraps, tma=True)
    cp = bsk.block_stencil_plan(offs, ns, 4, 12, with_gram, H100_SMEM, H100_SMS, csize=csize,
                                wraps=wraps)
    assert plan.tma and not cp.tma
    assert (plan.h, plan.T, plan.groups, plan.ki, plan.stages, sum(plan.near), plan.boxes,
            plan.fused_gram) == (32, 128, 2, 6, stages, 3, 22, fused)
    assert plan.traffic == cp.traffic == 7.5
    assert plan.smem_bytes == bsk.tma_smem_bytes(4, 12, 128, 32, stages, True, csize)
    assert plan.smem_bytes + bsk.TMA_BARRIER_BYTES <= H100_SMEM
    assert (bsk.tma_smem_bytes(4, 12, 128, 32, stages + 1, True, csize)
            + bsk.TMA_BARRIER_BYTES > H100_SMEM)
    assert bsk.tma_far_granules(128, [None, 32, 1024, 32]) == [128, 32, 128, 32]
    assert bsk.tma_far_granules(128, [64, 32, 1, None]) == [1, 1, 1, 128]
    assert [bsk.tma_far_boxes(48, 128, g) for g in (128, 1, 32, 4)] == [1, 0, 4, 32]
    assert bsk.tma_far_boxes(12, 128, 4) == 0  # 192-byte granules: not 128-byte aligned
    # unfolded f32 blocks keep bs_spmm, with or without the Gram (rows 22, 23, 23b)
    uoffs = tuple(o % ns for o in _dirac_offsets(32))
    assert not bsk.block_stencil_plan(uoffs, ns, 4, 12, with_gram, H100_SMEM, H100_SMS,
                                      csize=4, tma=True).tma


@pytest.mark.parametrize("st", [1, 32, 1024, 32768])
@pytest.mark.parametrize("sign", [1, -1])
def test_block_stencil_tma_folded_boxes_cover_each_source_once(st, sign):
    """A far folded diagonal's slab in ``bs_tma`` (``csrc/block_stencil.cu``
    produce_tma) at 32^4 sites, tiles of 128, m = 48, on both phases (o =
    +st reads its wrap on phase L - 1, o = -st on phase 0): the slab is laid
    granule by granule (``tma_far_granules``: 1, 32, 128, 128 sites), each
    granule from the source of its first site, and the consumer's read of
    site c, granule c // g at c % g, finds the site's own source, (s + w) mod
    ns on its phase, (s + o) mod ns elsewhere, exactly once a site; granules
    whose source is a whole box within ns go as boxes (16-byte aligned, at
    most ``tma_far_boxes`` a tile), the rest are copied (st = 1: every one;
    else only those whose source crosses ns)."""
    L, T, m = 32, 128, 48
    ns = L ** 4
    o = sign * st
    (w, st_, L_, phase), = bsk.fold_terms((0, o), ((1, L),), ns).values()
    assert st_ == st
    g, = bsk.tma_far_granules(T, [st])
    assert g == min(T, st)
    s = np.arange(ns)
    want = (s + np.where((s // st) % L == phase, w, o)) % ns
    first = s - s % g  # the granule's first site
    src = (first + np.where((first // st) % L == phase, w, o)) % ns
    got = (src + s % g) % ns
    assert np.array_equal(got, want)
    boxed = (src % 4 == 0) & (g % 4 == 0) & (m * g % 32 == 0) & (src + g <= ns)
    per_tile = boxed[::g].reshape(-1, T // g).sum(axis=1)
    assert per_tile.max() <= bsk.tma_far_boxes(m, T, g)
    if st == 1:
        assert not boxed.any()
    else:
        assert per_tile.max() == T // g and (~boxed[::g]).sum() <= 2 * ns // st
        assert (src[~boxed] + g > ns).all()


# ---------------- row 2 above 32 rows: the window kernel's Gram form


@pytest.mark.parametrize("shape,k,chunks,hT", [
    ((256, 256, 256), 64, ((0, 64),), (4, 256)),            # config 5's f32 route
    ((128, 128, 128), 64, ((0, 64),), (4, 256)),
    ((64, 64, 64), 32, ((0, 32),), None),                    # config 3
    ((128, 128, 128), 32, ((0, 32),), (128, 256)),           # the north star
    ((128, 128, 128), 33, ((0, 33),), None),
    ((128, 128, 128), 65, ((0, 33), (33, 65)), None),
    ((128, 128, 128), 96, ((0, 48), (48, 96)), None),
    ((128, 128, 128), 128, ((0, 64), (64, 128)), (4, 256)),
    ((128, 128, 128), 12, ((0, 12),), None),
])
def test_f32_gram_chunks_follow_their_reads(monkeypatch, shape, k, chunks, hT):
    """An f32 field's Gram (rows 2, 2m) runs ``_native.row_chunks``, chunks
    of at most 64 rows: a chunk of 33 to 64 rows as one launch of the window
    kernel's Gram form (``stencil_vec_gram_plan``, its f32 tiles flushed
    every ``VEC_GRAM_FLUSH`` tiles; at 64 rows h = 4, T = 256, one block an
    SM), 32 rows and fewer on ``stencil_mma_f32_plan``; above 64 rows the
    cross blocks come from ``gram``; bf16 diagonals (row 2m) the same. A
    bf16 field's Gram keeps ``row_chunks`` on ``stencil_mma_plan``."""
    monkeypatch.setattr(_native, "max_smem", lambda index: H100_SMEM)
    monkeypatch.setattr(_native, "sm_count", lambda index: H100_SMS)
    offsets = _lap_offsets(shape)
    n = int(np.prod(shape))
    X = torch.empty((k, n), device="meta")
    for dt in (torch.float32, torch.bfloat16):
        D = torch.empty((len(offsets), n), dtype=dt, device="meta")
        plans = stencil.launch_plans(D, offsets, X, True)
        assert tuple(rows for rows, _ in plans) == chunks == tuple(_native.row_chunks(k))
        for (r0, r1), plan in plans:
            kc, dsize = r1 - r0, D.element_size()
            if 33 <= kc <= 64:
                assert stencil.vec_gram_takes(kc)
                assert plan == stencil.stencil_vec_gram_plan(tuple(offsets), n, kc, H100_SMEM,
                                                              H100_SMS, dsize)
                assert plan.blocks_per_sm == 1
                assert plan.smem_bytes == stencil.vec_gram_smem_bytes(kc, len(offsets), plan.h,
                                                                      plan.T, dsize)
                if hT is not None:
                    assert (plan.h, plan.T) == hT
            else:
                assert not stencil.vec_gram_takes(kc)
                assert plan == stencil.stencil_mma_f32_plan(tuple(offsets), n, kc, H100_SMEM,
                                                            H100_SMS, dsize)
                if hT is not None and dt == torch.float32:
                    assert (plan.h, plan.T) == hT
    X16 = torch.empty((k, n), dtype=torch.bfloat16, device="meta")
    D16 = torch.empty((len(offsets), n), dtype=torch.bfloat16, device="meta")
    assert [rows for rows, _ in stencil.launch_plans(D16, offsets, X16, True)] == \
        _native.row_chunks(k)


def test_f32_gram_launches_its_chunks_and_the_cross_blocks(monkeypatch):
    """``stencil._launch`` on an f32 field with the Gram: at 64 rows one
    ``bcg_stencil_vec_gram`` launch (X, Y, a (grid, 64, 64) float64 partial
    of one block an SM, G, the plan's h and T) and no cross blocks;
    at 96 rows two launches of 48 rows (X, Y offset by 48 rows), then
    ``fused.wide_gram`` on X, Y, their diagonal blocks and the chunks; at 32
    rows one ``bcg_stencil_spmm`` launch (``stencil_mma_f32``) with a float32
    partial."""
    monkeypatch.setattr(_native, "max_smem", lambda index: H100_SMEM)
    monkeypatch.setattr(_native, "sm_count", lambda index: H100_SMS)
    n, offsets = _PRESETS["lap_64^3"]
    D = torch.ones((len(offsets), n))
    calls, wide = [], []
    monkeypatch.setattr(_native, "launch", lambda name, fn, dev, *a: calls.append((fn, a)))
    monkeypatch.setattr(fused, "wide_gram",
                        lambda U, V, diag, chunks: wide.append((U, V, diag, chunks)) or "G")
    f32 = (torch.float32,) * 2
    X = torch.zeros((64, n))
    Y, G = stencil._launch(D, offsets, X, True, "stencil_spmm_gram_t", f32)
    plan = stencil.stencil_vec_gram_plan(tuple(offsets), n, 64, H100_SMEM, H100_SMS)
    assert [fn for fn, _ in calls] == ["bcg_stencil_vec_gram"] and not wide
    a = calls[0][1]
    assert a[3] == X.data_ptr() and a[4] == Y.data_ptr() and a[7:] == (
        64, n, plan.h, plan.T, min(-(-n // plan.T), H100_SMS))
    assert a[6] == G.data_ptr() and G.shape == (64, 64) and G.dtype == torch.float32
    calls.clear()
    X = torch.zeros((96, n))
    Y, G = stencil._launch(D, offsets, X, True, "stencil_spmm_gram_t", f32)
    assert G == "G" and [fn for fn, _ in calls] == ["bcg_stencil_vec_gram"] * 2
    for (fn, a), r0 in zip(calls, (0, 48)):
        assert a[3] == X[r0:].data_ptr() and a[4] == Y[r0:].data_ptr() and a[7] == 48
    U, V, diag, chunks = wide[0]
    assert U is X and V is Y and len(diag) == 2 and chunks == [(0, 48), (48, 96)]
    calls.clear()
    X = torch.zeros((32, n))
    stencil._launch(D, offsets, X, True, "stencil_spmm_gram_t", f32)
    assert [fn for fn, _ in calls] == ["bcg_stencil_spmm"] and calls[0][1][7] == 32


def test_vec_gram_flush_slots_cover_the_tile_once():
    """``csrc/stencil.cu`` flush_gram and the partial's store in numpy: the
    four VecGram<64> copies of a 256-thread block write thread t's entry
    (a, b), row (t mod 64) / 8 + 8a and column t mod 8 + 8b, to slot (t mod
    64) + 64 (8a + b) of copy t / 64; thread u sums slots u + 256 j of the
    four copies in copy order and stores slot e at row (e mod 64) / 8 + 8
    (e / 64 / 8), column e mod 8 + 8 (e / 64 mod 8). Every entry of the
    (64, 64) tile is one slot of one thread; each copy's entries land where
    its own tile holds them; the sum of the copies' tiles comes back."""
    rng = np.random.default_rng(2400)
    tiles = rng.standard_normal((4, 64, 64))  # each copy's f32 tile of G
    scratch = np.zeros(4 * 4096)
    for t in range(256):
        grp, rt, st = t // 64, (t % 64) // 8, t % 8
        for a in range(8):
            for b in range(8):
                scratch[grp * 4096 + t % 64 + 64 * (8 * a + b)] = tiles[grp, rt + 8 * a,
                                                                        st + 8 * b]
    got = np.zeros((64, 64))
    seen = np.zeros((64, 64), dtype=int)
    for u in range(256):
        for j in range(16):
            e = u + 256 * j
            v = 0.0
            for c in range(4):
                v += scratch[4096 * c + e]
            s, ab = e % 64, e // 64
            r, col = s // 8 + 8 * (ab // 8), s % 8 + 8 * (ab % 8)
            got[r, col] = v
            seen[r, col] += 1
    assert (seen == 1).all()
    np.testing.assert_allclose(got, tiles.sum(axis=0), rtol=1e-13, atol=1e-13)
    src = (CSRC / "stencil.cu").read_text()
    assert "float* mine = scratch + g.grp * 4096 + threadIdx.x % 64;" in src
    assert "mine[64 * (8 * a + b)] = g.acc[a][b];" in src
    assert "const float* e = scratch + threadIdx.x + kStThreads * j;" in src
    assert "const int r = s / 8 + 8 * (ab / 8), c = s % 8 + 8 * (ab % 8);" in src
