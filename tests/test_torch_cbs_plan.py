"""Host plans of the merged const-hop kernel (rows 16 and 17) and of
``qr_p_update`` (row 12), on the CPU.

``csrc/cbs_merged.cu`` double-buffers a window of X around each tile of
sites in shared memory (a group of right-hand sides a block, four sites a
lane), reads the far diagonals from L2, and applies each group of diagonals
that share a hop once, on the masked sum of their windows;
``ops/const_block_stencil.py`` ``const_block_stencil_plan`` picks the halo,
the tile, the group of right-hand sides and the diagonals' order (each hop
group's far diagonals first). The kernel runs only on the card
(tests/test_torch_kernels_cuda.py); here the plan is held to its rules, its
hop groups to the reference's ``_group_offsets``, and a numpy emulation of
the planned schedule to the plain version (f64, max relative error 1e-12:
the emulation reorders the sums). ``qr_p_update`` runs
``csrc/px_update.cu``'s streaming schedule on ``qr_p_update_plan``; its
plain route at m = 96 is held against the reference's Pallas kernel in
interpret mode (max relative error 1e-5, f32).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockcg_tpu.ops import const_block_stencil as jcbs
from blockcg_tpu.ops import fused as jfused
from blockcg_tpu.problems import dirac as jdirac
from blockcg_tpu.problems import dirac_eo as jdirac_eo  # the builder
from blockcg_tpu_torch.ops import _native, fused
from blockcg_tpu_torch.ops import const_block_stencil as cbs
from blockcg_tpu_torch.problems import dirac_cbdia

H100_SMEM = 232448  # bytes of shared memory one block may opt into on an H100
H100_SMS = 132
CSRC = Path(__file__).resolve().parents[1] / "blockcg_tpu_torch" / "csrc"
L4 = 32 ** 4
# Config 4's main diagonals (dirac_cbdia(32) without its slab-routed wraps)
# and the direction of each: its hop is the direction's.
CONFIG4 = (0, 32768, -32768, 1024, -1024, 32, -32, -992, 992, 1, -1, -31, 31)
CONFIG4_DIRS = (0, 1, 1, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4)


def _paired_hops(bs, seed):
    """Nested-tuple hops of config 4's diagonals, one a direction (as the
    Dirac operator's: five distinct hops on 13 diagonals)."""
    rng = np.random.default_rng(seed)
    table = [tuple(tuple(float(v) for v in row) for row in rng.standard_normal((bs, bs)))
             for _ in range(5)]
    return tuple(table[d] for d in CONFIG4_DIRS)


def _check_plan(plan, offsets, hops, nmask, bs, k, ns):
    nd = len(offsets)
    offs = [o % ns for o in offsets]
    assert sorted(plan.order) == list(range(nd))
    # Groups are consecutive and share one hop; a group's far diagonals come
    # first.
    starts = [i for i in range(nd) if i == 0 or plan.gid[i] != plan.gid[i - 1]]
    assert len(starts) == len(set(plan.gid))
    for i in range(1, nd):
        if plan.gid[i] == plan.gid[i - 1]:
            assert hops[plan.order[i]] == hops[plan.order[i - 1]]
            assert plan.near[i] or not plan.near[i - 1]
    # Near diagonals read the window: within h of site 0 (mod ns).
    for i, d in enumerate(plan.order):
        assert plan.near[i] is (min(offs[d], ns - offs[d]) <= plan.h)
    assert plan.h % 4 == 0 and plan.T == 128 * plan.sw and plan.sw in cbs.CM_SW
    assert plan.kb == min(k, cbs.CM_KB) and plan.kb * plan.sw <= cbs.CM_WARPS
    assert plan.smem_bytes == cbs.cm_smem_bytes(bs, plan.kb, plan.T, plan.h, nmask, nd)
    assert plan.smem_bytes <= H100_SMEM
    fit = (H100_SMEM + 1024) // (plan.smem_bytes + 1024)
    items = -(-ns // plan.T) * -(-k // plan.kb)
    assert plan.blocks == min(items, fit * H100_SMS, _native.MAX_BLOCKS)
    assert plan.traffic == (plan.T + 2 * plan.h) / plan.T + nd - sum(plan.near)


@pytest.mark.parametrize("bs", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [1, 12, 24])
def test_plan_fits_and_covers_every_offset(bs, k):
    """Config 4's offsets at 32^4 sites with a hop a direction, k right-hand
    sides in one launch: the plan fits the H100's shared memory with two
    blocks an SM or more, and every diagonal reads the window or L2, in
    groups of equal hops (none at one RHS)."""
    hops = _paired_hops(bs, seed=bs)
    plan = cbs.const_block_stencil_plan(CONFIG4, hops, 10, bs, k, L4, H100_SMEM, H100_SMS)
    _check_plan(plan, CONFIG4, hops, 10, bs, k, L4)
    assert (H100_SMEM + 1024) // (plan.smem_bytes + 1024) >= 2
    assert len(set(plan.gid)) == (5 if k > 1 else 13)


@pytest.mark.parametrize("k,want", [
    (12, "h=32 T=256 sw=2 kb=4 groups=5/13 near=7/13 smem=62784 traffic=7.25 blocks=396"),
    (24, "h=32 T=256 sw=2 kb=4 groups=5/13 near=7/13 smem=62784 traffic=7.25 blocks=396"),
    (1, "h=32 T=512 sw=4 kb=1 groups=13/13 near=7/13 smem=60352 traffic=7.125 blocks=396"),
])
def test_plan_of_config4(k, want):
    """Config 4 at m = 48 and 96 (one launch each) and at one RHS: a 32-site
    halo holds 0, +-1, +-31 and +-32; groups of 4 right-hand sides on
    256-site tiles; five hop groups, none at one RHS; three blocks an SM of
    shared memory."""
    hops = _paired_hops(4, seed=0)
    plan = cbs.const_block_stencil_plan(CONFIG4, hops, 10, 4, k, L4, H100_SMEM, H100_SMS)
    assert plan.describe() == want


def test_plan_pins_and_refusals():
    hops = _paired_hops(4, seed=1)
    args = (CONFIG4, hops, 10, 4, 12, L4, H100_SMEM, H100_SMS)
    assert cbs.const_block_stencil_plan(*args, h=0).near == (True,) + (False,) * 12
    assert len(set(cbs.const_block_stencil_plan(*args, grouped=False).gid)) == 13
    assert cbs.const_block_stencil_plan(*args, sw=1).T == 128
    assert cbs.const_block_stencil_plan(*args, kb=12, sw=1).kb == 12
    assert cbs.const_block_stencil_plan(*args, kb=2).sw == 4
    with pytest.raises(ValueError, match="96"):
        cbs.const_block_stencil_plan(*args, kb=25)
    with pytest.raises(ValueError, match="warps"):
        cbs.const_block_stencil_plan(*args, kb=12, sw=2)
    with pytest.raises(ValueError, match="no schedule"):
        cbs.const_block_stencil_plan(*args[:6], 8 * 1024, H100_SMS)


def _reference_ops():
    return {"dirac_cbdia": jdirac.dirac_cbdia(8),
            "dirac_gauged_cbdia": jdirac.dirac_gauged_cbdia(8),
            "dirac_eo hop_oe": jdirac_eo(8).hop_oe,
            "dirac_eo hop_eo": jdirac_eo(8).hop_eo}


@pytest.mark.parametrize("name", ["dirac_cbdia", "dirac_gauged_cbdia", "dirac_eo hop_oe",
                                  "dirac_eo hop_eo"])
def test_hop_groups_are_the_references(name):
    """``hop_groups`` on the operators' hops is the reference's
    ``_group_offsets`` (members in diagonal order, groups by first
    appearance), and the plan's order walks them, each group's far
    diagonals first."""
    jop = _reference_ops()[name]
    hops = tuple(tuple(tuple(float(v) for v in row) for row in np.asarray(h)) for h in jop.hops)
    want = tuple(tuple(d for d, _ in mem) for _, mem in jcbs._group_offsets(jop.hops,
                                                                          jop.mask_slot))
    assert cbs.hop_groups(hops) == want
    plan = cbs.const_block_stencil_plan(tuple(jop.offsets), hops, 16, len(hops[0]), 12,
                                        jop.num_sites, H100_SMEM, H100_SMS)
    near = dict(zip(plan.order, plan.near))
    assert plan.order == tuple(d for g in want for d in sorted(g, key=lambda d: near[d]))
    assert len(set(plan.gid)) == len(want)


def _emulate(plan, hops, offsets, slots, masks, X):
    """The planned schedule in numpy (f64): per item (a tile and a group of
    kb right-hand sides), near diagonals from the window, far ones from X
    itself, masked sums per hop group, then the group's hop; a group of one
    takes its mask into the hop."""
    bs = hops.shape[-1]
    m, ns = X.shape
    k = m // bs
    Xall = X.reshape(bs, k, ns)
    Y = np.zeros_like(Xall)
    T, h, kb = plan.T, plan.h, plan.kb
    offs = [o % ns for o in offsets]
    nd = len(plan.order)
    for t, j0 in ((t, j0) for t in range(-(-ns // T)) for j0 in range(0, k, kb)):
        rhs = slice(j0, min(j0 + kb, k))
        Xv = Xall[:, rhs]
        sites = t * T + np.arange(T)
        valid = sites < ns
        win = Xv[:, :, (t * T - h + np.arange(T + 2 * h)) % ns]
        acc = np.zeros((bs, Xv.shape[1], T))
        u = None
        for i, d in enumerate(plan.order):
            first = i == 0 or plan.gid[i - 1] != plan.gid[i]
            last = i == nd - 1 or plan.gid[i + 1] != plan.gid[i]
            o = offs[d]
            w = np.where(valid, masks[slots[d], sites % ns], 0.0) if slots[d] >= 0 else 1.0
            if plan.near[i]:
                x = win[:, :, h + (o if o <= h else o - ns) + np.arange(T)]
            else:
                x = Xv[:, :, (sites + o) % ns]
            single = first and last
            u = (0.0 if first else u) + (1.0 if single else w) * x
            if last:
                acc += np.einsum("ab,bkt->akt", hops[d], u) * (w if single else 1.0)
        Y[:, rhs, sites[valid]] = acc[:, :, valid]
    return Y.reshape(m, ns)


@pytest.mark.parametrize("case,pins", [
    ("random 300", {}), ("paired 300", {}), ("paired 300", {"h": 0}), ("paired 300", {"h": 4}),
    ("paired 300", {"kb": 12, "sw": 1}), ("paired 300", {"grouped": False}), ("config4 8^4", {}),
    ("config4 8^4", {"kb": 3, "sw": 4, "grouped": True}), ("config4 8^4 k=1", {}),
])
def test_planned_schedule_matches_the_plain_version(case, pins):
    """The emulated schedule of the plan equals ``const_block_stencil_plain``
    in f64: the window, the spans and the grouped hops read and sum the
    contract's terms."""
    rng = np.random.default_rng(len(case) + len(pins))
    if case.startswith("config4"):
        op = dirac_cbdia(8, device="cpu")
        offsets, slots = op.main_offsets, op.main_slots
        hops = op.hops_main.double().numpy()
        masks = op.masks_main.double().numpy()
        bs, k, ns = 4, 1 if case.endswith("k=1") else 12, op.ns
    else:
        ns, bs, k = 300, 4, 12
        offsets = (0, 1, -1, 40, -40, 44, -44, 100, -100, 2 * ns + 7, -ns - 3)
        base = rng.standard_normal((7, bs, bs))
        pick = [0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 6] if case.startswith("paired") else range(11)
        hops = base[list(pick)] if case.startswith("paired") else rng.standard_normal((11, bs,
                                                                                      bs))
        masks = rng.choice([-1.5, -1.0, 0.0, 1.0, 2.0], size=(4, ns))
        slots = (-1, 0, 1, 2, 3, -1, 0, 1, -1, 2, 3)
    X = rng.standard_normal((bs * k, ns))
    key = tuple(tuple(map(tuple, h)) for h in hops.tolist())
    plan = cbs.const_block_stencil_plan(tuple(o % ns for o in offsets), key, masks.shape[0], bs,
                                        k, ns, H100_SMEM, H100_SMS, **pins)
    got = _emulate(plan, hops, offsets, slots, masks, X)
    want = cbs.const_block_stencil_plain(torch.from_numpy(hops), offsets, slots,
                                         torch.from_numpy(masks), torch.from_numpy(X))[0]
    want = want.numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_host_constants_mirror_the_merged_kernel():
    cm = (CSRC / "cbs_merged.cu").read_text()
    for name, value in (("kCmMaxDiags", cbs.MAX_DIAGS), ("kCmMaxBs", cbs.MAX_BS),
                        ("kCmMaxRows", cbs.CM_MAX_ROWS),
                        ("kCmMaxThreads", 32 * cbs.CM_MAX_WARPS)):
        assert int(re.search(rf"{name} = (\d+)", cm).group(1)) == value, name
    assert "int cm_window_ld(int T, int h) { return T + 2 * h + 4; }" in cm
    assert "int cm_spins(int bs) { return bs <= 4 ? 4 : 8; }" in cm
    assert ("return 2LL * (1LL * m * cm_window_ld(T, h) + 1LL * nmask * T) + 1LL * nhop * BS * BS;"
            in cm)
    assert "cm_smem_floats(p.bs, p.bs * p.kb, p.T, p.h, p.nmask, p.nhop)" in cm
    assert "128 * sw, kb, max_blocks" in cm and "kb * sw * 32 > kCmMaxThreads" in cm
    assert "const int threads = p.kb * (p.T / 128) * 32;" in cm
    assert "(p.ns + p.T - 1) / p.T * p.ng" in cm


@pytest.mark.parametrize("k,chunks,kc,blocks", [(8, 1, 16, 2), (48, 1, 48, 2), (96, 1, 96, 1),
                                                (100, 1, 100, 1), (128, 1, 86, 1),
                                                (200, 4, 100, 1)])
def test_qr_p_update_plan(monkeypatch, k, chunks, kc, blocks):
    """One launch up to 128 rows (read Q1 and P once: in place when donated),
    two blocks an SM up to 64 rows; wider, row chunks of Q and Pn."""
    monkeypatch.setattr(_native, "max_smem", lambda index: H100_SMEM)
    plan = fused.qr_p_update_plan(k, torch.device("cpu"))
    assert (len(plan.chunks), plan.kc, plan.blocks_per_sm) == (chunks, kc, blocks)
    assert plan.in_place is (chunks == 1) and plan.fused_gram is False
    assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= H100_SMEM + 1024
    assert plan.smem_bytes == fused.update_smem_bytes(max(r1 - r0 for r0, r1 in plan.chunks),
                                                      k, plan.kc, 2, False)


@pytest.mark.parametrize("donate", [False, True])
def test_qr_p_update_at_m96_matches_pallas(donate):
    """Row 12's plain route at m = 96 (one launch on the card) against the
    Pallas kernel in interpret mode."""
    k, n = 96, 512
    rng = np.random.default_rng(12)
    M2, rho = ((rng.standard_normal((k, k)) / k ** 0.5).astype(np.float32) for _ in range(2))
    Q1, P = (rng.standard_normal((k, n)).astype(np.float32) for _ in range(2))
    want = [np.asarray(a) for a in jfused.qr_p_update(jnp.asarray(M2), jnp.asarray(Q1),
                                                      jnp.asarray(rho), jnp.asarray(P),
                                                      interpret=True)]
    Qt, Pt = torch.from_numpy(Q1.copy()), torch.from_numpy(P.copy())
    Q, Pn = fused.qr_p_update(torch.from_numpy(M2), Qt, torch.from_numpy(rho), Pt,
                              donate=donate)
    assert (Q.data_ptr() == Qt.data_ptr()) is donate and (Pn.data_ptr() == Pt.data_ptr()) is donate
    for got, w in zip((Q, Pn), want):
        err = np.abs(got.numpy().astype(np.float64) - w).max() / np.abs(w).max()
        assert err < 1e-5, err


# ---------------- rows 19 and 20: the merged slab adds (csrc/slab_stream.cu)

# Config 4's slab adds: a wrap slab of dirac_cbdia(32) (32 slabs of 1,024
# sites) and the one-rank +t crossing (8 of 4,096), both 32,768 sites.
CONFIG4_SLAB = (1024, 32)


@pytest.mark.parametrize("m,gram,want", [
    (48, False, (0, 0, 0, 4, 384)),       # config 4: (48 / 4) x 32,768 / 4 items
    (96, False, (0, 0, 0, 4, 528)),       # [wide]: four blocks an SM
    (48, True, (48, 1, 128, 1, 132)),     # a block an SM, 256 tiles of 128 sites
    (96, True, (96, 1, 128, 1, 132)),
    (8, True, (32, 1, 128, 1, 132)),
    (128, True, (128, 1, 128, 1, 132)),
    (160, True, (128, 4, 128, 1, 132)),   # above 128 rows: the Gram in passes
])
def test_slab_plan_one_launch_at_any_width(m, gram, want):
    """``slab_plan`` gives one ``csrc/slab_stream.cu`` launch a slab add at
    any width: without the Gram a grid of the items' blocks up to four
    blocks an SM (bs <= 4); with it the Gram tile's rows, its passes, one
    block an SM (every block resident for the grid barrier) on the widest
    tile of sites that fits and leaves a tile an SM; shared bytes within the
    cap."""
    g, nb = CONFIG4_SLAB
    plan = cbs.slab_plan(m, 4, g, nb, gram, True, H100_SMS, H100_SMEM)
    assert (plan.kmax, plan.passes, plan.tc, plan.blocks_per_sm, plan.grid) == want
    assert plan.vec and plan.grid <= plan.blocks_per_sm * H100_SMS
    if gram:
        assert plan.kmax == cbs.slab_kmax(m) and plan.passes == (-(-m // plan.kmax)) ** 2
        assert plan.smem_bytes == cbs.slab_smem_bytes(plan.kmax, plan.tc)
        assert plan.smem_bytes + cbs.SLAB_STATIC_BYTES <= H100_SMEM
        assert plan.blocks_per_sm == cbs.slab_blocks(4, plan.kmax) == 1
        assert -(-g * nb // plan.tc) >= H100_SMS
        assert plan.grid == min(-(-g * nb // plan.tc), H100_SMS)


def test_slab_plan_grid_depends_on_shapes_and_sms_alone():
    """The grid (which orders the Gram's partial sums) is a function of the
    shapes and the card: equal arguments give equal plans, another SM count
    another grid and tile; bs = 8 takes two blocks an SM without the Gram."""
    g, nb = CONFIG4_SLAB
    a = cbs.slab_plan(48, 4, g, nb, True, True, H100_SMS, H100_SMEM)
    cbs.slab_plan.cache_clear()
    assert cbs.slab_plan(48, 4, g, nb, True, True, H100_SMS, H100_SMEM) == a
    assert cbs.slab_plan(48, 4, g, nb, True, True, 66, H100_SMEM)[3:] == (256, 1, 66, 99840)
    assert cbs.slab_plan(96, 8, g, nb, False, True, H100_SMS, H100_SMEM).blocks_per_sm == 2
    scalar = cbs.slab_plan(48, 4, 2, 100, False, False, H100_SMS, H100_SMEM)
    assert not scalar.vec and scalar.grid == -(-12 * 200 // cbs.SLAB_THREADS)


@pytest.mark.parametrize("args,match", [
    ((48, 9, 1024, 32, True, True), "bs <= 8"),
    ((50, 4, 1024, 32, True, True), "rows of bs"),
    ((48, 4, 0, 32, False, True), "slabs of"),
    ((48, 4, 1024, 0, False, True), "slabs of"),
    ((48, 4, 6, 32, False, True), "g % 4 == 0"),
])
def test_slab_plan_refusals(args, match):
    with pytest.raises(ValueError, match=match):
        cbs.slab_plan(*args, H100_SMS, H100_SMEM)


def test_slab_16_byte_route_conditions():
    """``_slab_vec``: the 16-byte route needs g % 4 == 0 and every field it
    reads or writes on a 16-byte boundary (None skipped)."""
    F = torch.zeros(48, 4096)
    off = torch.zeros(48 * 4096 + 1)[1:].view(48, 4096)
    assert F.data_ptr() % 16 == 0 and off.data_ptr() % 16 == 4
    assert cbs._slab_vec(1024, F, F, None, F)
    assert not cbs._slab_vec(2, F, F, None, F) and not cbs._slab_vec(6, F, F)
    assert not cbs._slab_vec(1024, F, off, None) and not cbs._slab_vec(1024, off, F)
    assert not cbs._slab_vec(1024, F, F, off[:1, :1024].reshape(1, 1024))


@pytest.mark.parametrize("gram,vals,g,offset,fn", [
    (True, True, 256, False, "bcg_slab_stream"),
    (False, False, 256, False, "bcg_slab_stream"),
    (True, False, 256, True, "bcg_slab_stream_scalar"),
    (True, True, 2, False, "bcg_slab_stream_scalar"),
])
def test_slab_stream_launch_arguments(monkeypatch, gram, vals, g, offset, fn):
    """``_launch_stream`` at m = 96 issues one launch on its plan: the 16-byte
    route or the 4-byte one by ``_slab_vec``, the merged row map (sa, si) =
    (k, 1), the plan's kmax, tile and grid, the Gram's partials (grid, m, m)
    with the barrier's counter past them."""
    monkeypatch.setattr(_native, "max_smem", lambda index: H100_SMEM)
    monkeypatch.setattr(_native, "sm_count", lambda index: H100_SMS)
    calls = []
    monkeypatch.setattr(_native, "launch", lambda name, f, dev, *a: calls.append((name, f, a)))
    hop = torch.ones(4, 4)
    m, nb = 96, 3
    Src = torch.zeros(m * 4 * g + 1)[1:].view(m, 4 * g) if offset else torch.zeros(m, 4 * g)
    Y, X = torch.zeros(m, 8 * g), torch.zeros(m, 8 * g)
    v = torch.ones(1, nb * g) if vals else None
    G = cbs._launch_stream("slab_m_accumulate_from", hop, g, nb, (1, 5), (1, 1), Src, 4 * g,
                           v, X if gram else None, Y, None, gram)
    assert len(calls) == 1 and calls[0][:2] == ("slab_m_accumulate_from", fn)
    plan = cbs.slab_plan(m, 4, g, nb, gram, fn == "bcg_slab_stream", H100_SMS, H100_SMEM)
    a = calls[0][2]
    assert a[:8] == (hop.data_ptr(), 4, g, nb, 1, 5, 1, 1)
    assert a[8:10] == (Src.data_ptr(), 4 * g) and a[12] == Y.data_ptr()
    assert a[17:] == (24, 8 * g, 24, 1, plan.kmax, plan.tc, plan.grid)
    if gram:
        assert G.shape == (m, m) and a[15] == G.data_ptr() and a[11] == X.data_ptr()
        assert a[16] == a[14] + 4 * plan.grid * m * m
    else:
        assert G is None and a[14:17] == (None, None, None)


def test_host_constants_mirror_the_slab_kernel():
    """``ops/const_block_stencil.py``'s slab plan mirrors ``csrc/slab_stream.cu``."""
    ss = (CSRC / "slab_stream.cu").read_text()
    cm = (CSRC / "common.cuh").read_text()
    for name, value in (("kSlabThreads", cbs.SLAB_THREADS), ("kSlabMaxBs", cbs.MAX_BS),
                        ("kSlabGramRows", cbs.SLAB_GRAM_ROWS)):
        assert int(re.search(rf"{name} = (\d+)", ss).group(1)) == value, name
    assert "kSlabBlocksPerSm = BS <= 4 ? 4 : 2;" in ss
    assert "__launch_bounds__(kSlabThreads, 1)" in ss
    assert [cbs.slab_blocks(bs, w) for bs, w in ((4, 0), (8, 0), (4, 48), (8, 64), (4, 96),
                                                  (4, 128))] == [4, 2, 1, 1, 1, 1]
    assert ("return m <= 32 ? 32 : m <= 48 ? 48 : m <= 64 ? 64 : m <= 96 ? 96 : kSlabGramRows;"
            in ss and cbs.SLAB_KMAX == (32, 48, 64, 96, 128))
    assert [cbs.slab_kmax(m) for m in (1, 32, 33, 48, 64, 65, 96, 97, 200)] == \
        [32, 32, 48, 48, 64, 96, 96, 128, 128]
    assert "const long long tiles = 2LL * KMAX * (tc + 4);" in ss
    assert "constexpr long long scratch = SlabGram<KMAX>::kScratch;" in ss
    assert "kSlabTS = KMAX == 128 ? 8 : (KMAX == 48 || KMAX == 96) ? 6 : 4;" in ss
    assert [cbs.slab_ts(w) for w in cbs.SLAB_KMAX] == [4, 6, 4, 6, 8]
    assert "const size_t smem = 4 * slab_smem_floats<KMAX>(a.tc);" in ss
    assert "__shared__ float hs[kSlabMaxBs * kSlabMaxBs];" in ss
    assert "__shared__ double red[kSlabThreads];" in ss
    assert cbs.SLAB_STATIC_BYTES == 4 * 8 * 8 + 8 * 256
    assert "static constexpr int kGroups = THREADS / kCopy;" in cm
    assert [cbs.vecgram_scratch(w) for w in (32, 48, 64, 96, 128)] == \
        [4 * 1024, 4 * 2304, 4096, 9216, 16384]


@pytest.mark.parametrize("with_vals", [False, True])
def test_slab_adds_at_m96_match_pallas(with_vals):
    """Rows 19 and 20 at k = 24 (m = 96, one launch on the card) with the
    Gram on the plain route against the Pallas kernels in interpret mode:
    a wrap slab of ``dirac_cbdia(16)`` (with ``Gin``), and a halo of 3 blocks
    of g = 256 into blocks 5..7 of 8 with ``vals`` (or without). Max
    relative error 1e-5 on Y, relative Frobenius 1e-5 on G (f32)."""
    rng = np.random.default_rng(2300)
    k = 24
    jop = jdirac.dirac_cbdia(16, dtype=jnp.float32)
    m = jop.bs * k
    d, g, nblocks, mul, off, shift = jop.slabs[0]
    Xm, Ym = (rng.standard_normal((m, jop.ns)).astype(np.float32) for _ in range(2))
    Gm = rng.standard_normal((m, m)).astype(np.float32)
    args = (jop.hops[d], g, nblocks, mul, off, shift)
    Y, G = cbs.slab_m_accumulate(*args, torch.from_numpy(Xm), torch.from_numpy(Ym.copy()),
                                 torch.from_numpy(Gm), with_gram=True)
    Yj, Gj = jcbs.slab_m_accumulate(*args, jnp.asarray(Xm), jnp.asarray(Ym), jnp.asarray(Gm),
                                    with_gram=True, interpret=True)
    assert _relmax(Y, Yj) <= 1e-5 and _relfro(G, Gj) <= 1e-5
    hop = jop.hops[1]
    g, nb, dst, src = 256, 3, 5, 1
    Src = rng.standard_normal((m, 4 * g)).astype(np.float32)
    Yh, Xh = (rng.standard_normal((m, 8 * g)).astype(np.float32) for _ in range(2))
    v = rng.choice([-1.0, 1.0], (1, nb * g)).astype(np.float32) if with_vals else None
    Y, G = cbs.slab_m_accumulate_from(hop, g, nb, dst, src, torch.from_numpy(Src),
                                      torch.from_numpy(Yh.copy()), torch.from_numpy(Xh),
                                      None if v is None else torch.from_numpy(v),
                                      with_gram=True)
    Yj, Gj = jcbs.slab_m_accumulate_from(hop, g, nb, dst, src, jnp.asarray(Src),
                                         jnp.asarray(Yh), jnp.asarray(Xh),
                                         None if v is None else jnp.asarray(v),
                                         with_gram=True, interpret=True)
    assert _relmax(Y, Yj) <= 1e-5 and _relfro(G, Gj) <= 1e-5


def _relmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _relfro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)
