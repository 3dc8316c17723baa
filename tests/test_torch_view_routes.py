"""The (k, bs, ns) view's launches on the redesigned kernels, on the CPU.

Row 22h (``block_stencil_spmm_t`` on bf16 blocks) runs ``csrc/block_stencil.cu``
``bs_tma``: the field's 3-D tensor map takes the view's strides, so a box
lays the staged rows in the merged launch's order b * k + i. Row 14
(``const_block_stencil_spmm_t`` without its Gram) runs ``csrc/cbs_merged.cu``
``cm_spmm`` with the view's row map, on the ungrouped plan, so Y keeps the
bits of ``csrc/const_block_stencil.cu``'s view kernel. The kernels run only
on the card (``tests/test_torch_kernels_cuda.py``); here the routes, the
arguments the wrappers pass, and numpy mirrors of the boxes and of the
persistent grid's items are held to their rules, and the view's plain
versions to the reference's.
"""

import numpy as np
import pytest
import torch

from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.ops import block_stencil as bsk
from blockcg_tpu_torch.ops import const_block_stencil as cbs

H100_SMEM = 232448  # bytes of shared memory one block may opt into on an H100
H100_SMS = 132


def _dirac_offsets(L):
    """``dirac_gauged_matrix(L)``'s 15 offsets (problems/dirac.py)."""
    offs = [0, L ** 3, -L ** 3]
    for st in (L ** 2, L, 1):
        offs += [st, -st, -(L - 1) * st, (L - 1) * st]
    return tuple(offs)


@pytest.fixture
def h100(monkeypatch):
    """The plans' card: an H100's shared-memory cap and SM count."""
    monkeypatch.setattr(_native, "max_smem", lambda index: H100_SMEM)
    monkeypatch.setattr(_native, "sm_count", lambda index: H100_SMS)


def _record_launches(monkeypatch):
    """Replace ``_native.launch`` by a recorder of (name, function, args)."""
    calls = []
    monkeypatch.setattr(_native, "launch",
                        lambda name, fn, device, *args: calls.append((name, fn, args)))
    return calls


# ------------------------------------------------------------- row 22h


@pytest.mark.parametrize("k,chunks", [(1, 1), (12, 1), (24, 1), (30, 2)])
def test_block_stencil_view_takes_bs_tma_on_bf16_blocks(h100, monkeypatch, k, chunks):
    """A (k, bs, ns) view on bf16 blocks takes ``bs_tma`` in every chunk
    where its plan does (the merged launch's rule: no more L2->SM traffic
    than ``bs_spmm``'s), the launch passing merged = 0, the chunk's own
    right-hand sides as ks and X, Y offset by j0 * bs rows; f32 blocks keep
    ``bs_spmm`` (row 22)."""
    L, bs = 8, 4
    ns, offsets = L ** 4, _dirac_offsets(L)
    gen = torch.Generator().manual_seed(k)
    blocks = torch.randn((len(offsets), bs, bs, ns), generator=gen)
    Xv = torch.randn((k, bs, ns), generator=gen)
    for B, want in ((blocks.bfloat16(), True), (blocks, False)):
        assert bsk._tma_ok(B, Xv)
        plans = bsk.launch_plans(B, offsets, k, False, torch.device("cpu"),
                                 tma=bsk._tma_ok(B, Xv))
        assert len(plans) == chunks
        for (j0, j1), plan in plans:
            merged = bsk.block_stencil_plan(tuple(o % ns for o in offsets), ns, bs, j1 - j0,
                                            False, H100_SMEM, H100_SMS, csize=B.element_size(),
                                            tma=True)
            assert plan == merged and plan.tma is (want and merged.tma)
        calls = _record_launches(monkeypatch)
        bsk._launch(B, offsets, Xv, k, False, False, "block_stencil_spmm_t")
        row = ns * 4 * bs
        for ((j0, j1), plan), (name, fn, args) in zip(plans, calls, strict=True):
            assert fn == ("bcg_block_stencil_tma" if plan.tma else "bcg_block_stencil_spmm")
            assert name == ("block_stencil_spmm_t[bf16 coeffs]" if B.dtype == torch.bfloat16
                            else "block_stencil_spmm_t")
            assert args[6] == Xv.data_ptr() + j0 * row
            if plan.tma:  # (..., X, Y, k, ks, ns, merged, h, groups, ki, stages, blocks)
                assert args[8:] == (j1 - j0, j1 - j0, ns, 0, plan.h, plan.groups, plan.ki,
                                    plan.stages, plan.blocks)
            else:  # (..., X, Y, part, G, k, ks, ns, merged, h, ...)
                assert args[10:14] == (j1 - j0, j1 - j0, ns, 0)
        monkeypatch.undo()
        monkeypatch.setattr(_native, "max_smem", lambda index: H100_SMEM)
        monkeypatch.setattr(_native, "sm_count", lambda index: H100_SMS)
    # At 8^4 sites the boxes tie bs_spmm's traffic from k = 12 on: the view takes them.
    if k >= 12:
        assert all(p.tma for _, p in bsk.launch_plans(blocks.bfloat16(), offsets, k, False,
                                                      torch.device("cpu"), tma=True))


def _box(flat, strides, coords, box):
    """A TMA tiled box in numpy: the 3-D map over ``flat`` (dims innermost
    first, ``strides`` in elements of dims 1 and 2, dim 0 contiguous), the
    box of ``box`` = (b0, b1, b2) elements at ``coords``, laid in shared
    memory with dim 0 fastest: returns (b2 * b1, b0), row r2 * b1 + r1."""
    c0, c1, c2 = coords
    b0, b1, b2 = box
    idx = (c0 + np.arange(b0)[None, None, :] + (c1 + np.arange(b1))[None, :, None] * strides[0]
           + (c2 + np.arange(b2))[:, None, None] * strides[1])
    return flat[idx].reshape(b2 * b1, b0), idx.reshape(b2 * b1, b0)


@pytest.mark.parametrize("k", [1, 12, 24, 30])
def test_block_stencil_tma_view_boxes_stage_each_source_once(k):
    """``bs_tma``'s boxes on the (k, bs, ns) view in numpy: the field's map
    over (ns, k, bs) with the row map's strides (RHS i at si = bs rows, spin
    b at sa = 1 row: ``launch_tma``'s {4 ns si, 4 ns sa} bytes, each a
    multiple of 16 at ns % 8 == 0) lays staged row b * k + i from view row i
    * bs + b, for each chunk of right-hand sides (X offset by j0 * bs rows):
    the window box of every tile holds each source (view row, site) of its
    T + 2h sites exactly once, and the sites the consumers read at h + s + c
    are (i0 + c + o) mod ns; a far slab's box the sites (i0 + c + o) mod ns of
    the same rows. The merged view's map (si = 1, sa = ks) stages the same
    values from the same field transposed."""
    L, bs = 8, 4
    ns, offsets = L ** 4, _dirac_offsets(L)
    offs = tuple(o % ns for o in offsets)
    rng = np.random.default_rng(k)
    Xv = rng.standard_normal((k, bs, ns)).astype(np.float32)
    Xm = np.ascontiguousarray(Xv.transpose(1, 0, 2)).reshape(bs * k, ns)
    for j0, j1 in _native.row_chunks(k, bsk.MAX_ROWS // bs):
        kc = j1 - j0
        plan = bsk.block_stencil_plan(offs, ns, bs, kc, False, H100_SMEM, H100_SMS, csize=2,
                                      tma=True)
        T, h = plan.T, plan.h
        W = T + 2 * h
        assert (4 * ns * bs) % 16 == 0 and (4 * ns) % 16 == 0
        view = Xv.reshape(-1)[j0 * bs * ns:]  # the chunk's base pointer
        for i0 in range(0, ns - W + 1, 256):  # windows that do not cross ns go by a box
            c0 = i0  # a box of T + 2h sites from site c0 (the window of tile c0 + h)
            got, idx = _box(view, (bs * ns, ns), (c0, 0, 0), (W, kc, bs))
            assert len(np.unique(idx)) == idx.size  # each source once
            for r in range(bs * kc):
                b, i = divmod(r, kc)
                assert (got[r] == Xv[j0 + i, b, c0:c0 + W]).all()
            # the merged map of the same chunk (RHS stride 1 row, spin stride k rows)
            mflat = Xm.reshape(-1)[j0 * ns:]
            mgot, _ = _box(mflat, (ns, k * ns), (c0, 0, 0), (W, kc, bs))
            assert (mgot == got).all()
            # the consumers' near reads: site c of the tile at i0 + h, shift s
            for o in offs:
                if min(o, ns - o) > h:
                    continue
                s = o if o <= h else o - ns
                c = np.arange(T)
                assert (got[:, h + s + c] == view_rows(Xv, j0, kc)[:, (c0 + h + c + o) % ns]).all()
        for d, o in enumerate(offs):
            if min(o, ns - o) <= h or o % 4:
                continue
            i0 = 0
            src = (i0 + o) % ns
            if src + T > ns:
                continue
            got, idx = _box(view, (bs * ns, ns), (src, 0, 0), (T, kc, bs))
            assert len(np.unique(idx)) == idx.size
            assert (got == view_rows(Xv, j0, kc)[:, (i0 + np.arange(T) + o) % ns]).all()


def view_rows(Xv, j0, kc):
    """The staged rows b * kc + i of a chunk of the view: view row (j0 + i) *
    bs + b."""
    return np.ascontiguousarray(Xv[j0:j0 + kc].transpose(1, 0, 2)).reshape(-1, Xv.shape[2])


def test_view_sources_mirror_the_routes():
    """The sources the mirrors above stand for: ``launch_tma`` maps the
    field with the row map's strides (RHS, then spin), ``bcg_block_stencil_tma``
    takes the view flag (folds only merged), and ``cm_spmm`` copies and
    stores through the launch's row map."""
    from pathlib import Path

    csrc = Path(_native.CSRC)
    bs_src = (csrc / "block_stencil.cu").read_text()
    assert "fstrides[2] = {4ULL * p.ns * p.row.si, 4ULL * p.ns * p.row.sa};" in bs_src
    assert "(fold != nullptr && merged == 0)" in bs_src
    cm = (csrc / "cbs_merged.cu").read_text()
    assert "p.X + static_cast<long long>(p.row(b, i)) * p.ns" in cm
    assert "const RowStrides rs = p.row.times(p.ns);" in cm
    assert "row_map(merged != 0, bs, k)" in cm and "RowMap{p.k, 1}" not in cm.split(
        "cm_spmm(const CmLaunch p)")[1].split("cm_launch")[0]


# ------------------------------------------------------------- row 14


def _eo_hop(L=8):
    from blockcg_tpu_torch.problems import dirac_eo

    return dirac_eo(L, device="cpu").hop_oe


@pytest.mark.parametrize("k", [1, 3, 12])
@pytest.mark.parametrize("masked", [True, False])
def test_const_hop_view_launches_cm_spmm_ungrouped(h100, monkeypatch, k, masked):
    """Row 14 (the view without its Gram) is one ``bcg_cbs_merged_spmm``
    launch with merged = 0 on the view's plan from the operator's
    ``MergedPlans``: ungrouped (a hop group a diagonal, in diagonal order),
    so Y keeps ``cbs_spmm``'s bits; the merged view's plan at k > 1 stays
    grouped. Row 15 (with the Gram) stays on ``bcg_cbs_spmm``."""
    hop = _eo_hop()
    ns, nd = hop.ns, len(hop.main_offsets)
    masks = hop.masks_main if masked else None
    slots = hop.main_slots if masked else tuple(-1 for _ in hop.main_slots)
    nmask = 0 if masks is None else masks.shape[0]
    Xv = torch.randn((k, hop.bs, ns), generator=torch.Generator().manual_seed(k))
    plan = hop.main_plans.get(hop.main_offsets, nmask, k, ns, torch.device("cpu"), view=True)
    assert plan.order == tuple(range(nd)) and plan.gid == tuple(range(nd))
    assert plan == cbs.const_block_stencil_plan(tuple(hop.main_offsets), hop.main_plans.hop_key,
                                                nmask, hop.bs, k, ns, H100_SMEM, H100_SMS,
                                                grouped=False)
    merged = hop.main_plans.get(hop.main_offsets, nmask, k, ns, torch.device("cpu"))
    assert (len(set(merged.gid)) < nd) is (k > 1)
    calls = _record_launches(monkeypatch)
    Y, G = cbs._launch_view(hop.hops_main, hop.main_offsets, slots, masks, Xv, k, False,
                            "const_block_stencil_spmm_t", hop.main_plans)
    assert G is None and Y.shape == Xv.shape and len(calls) == 1
    name, fn, args = calls[0]
    assert (name, fn) == ("const_block_stencil_spmm_t", "bcg_cbs_merged_spmm")
    # (hops, nd, offsets, slots, order, gid, bs, masks, nmask, X, Y, k, ns, merged, h, sw, kb,
    #  blocks)
    assert list(args[4]) == list(plan.order) and list(args[5]) == list(plan.gid)
    assert args[6:] == (hop.bs, None if masks is None else masks.data_ptr(), nmask,
                        Xv.data_ptr(), Y.data_ptr(), k, ns, 0, plan.h, plan.sw, plan.kb,
                        plan.blocks)
    calls.clear()
    cbs._launch_view(hop.hops_main, hop.main_offsets, slots, masks, Xv, k, True,
                     "const_block_stencil_spmm_gram_t")
    assert {fn for _, fn, _ in calls} == {"bcg_cbs_spmm"}


def _cm_cover(plan, bs, k, ns, merged):
    """``csrc/cbs_merged.cu`` cm_spmm's walk in numpy: block b of the grid
    takes items b, b + grid, ... (group w // ntiles, tile w % ntiles); warp
    of the kb * sw takes RHS group * kb + warp // sw, its lanes the site
    quads c = 4 ((warp % sw) 32 + lane); a thread stores spin a of its RHS
    at sites s .. s + 3 below ns and k, in row row(a, i). The window copy's
    row r of a group (b = r // kb, i = min(j0 + r - b kb, k - 1)) comes from
    row(b, i), and the consumer of RHS j0 + ii reads rows b * kb + ii. Returns
    the stores' counts per (row, site) and checks every read."""
    T, sw, kb = plan.T, plan.sw, plan.kb
    row = (lambda a, i: a * k + i) if merged else (lambda a, i: i * bs + a)
    ntiles = -(-ns // T)
    ngroups = -(-k // kb)
    stored = np.zeros((bs * k, ns), dtype=int)
    for w in range(ntiles * ngroups):  # the items, whichever block takes them
        grp, tile = divmod(w, ntiles)
        j0 = grp * kb
        window = [row(r // kb, min(j0 + r - (r // kb) * kb, k - 1)) for r in range(bs * kb)]
        for warp in range(kb * sw):
            ii = warp // sw
            i = j0 + ii
            for b in range(bs):  # the consumer's reads of spin b
                assert window[b * kb + ii] == row(b, min(i, k - 1))
            for lane in range(32):
                c = 4 * ((warp % sw) * 32 + lane)
                s = tile * T + c
                for a in range(bs):
                    for e in range(4):
                        if s + e < ns and i < k:
                            stored[row(a, i), s + e] += 1
    return stored


@pytest.mark.parametrize("k", [1, 3, 12])
def test_cm_spmm_items_cover_the_view_once(k):
    """cm_spmm's items under the view's row map (``_cm_cover``) store every
    (spin, RHS, site) of Y exactly once at k = 1, 3 and 12, on the view's
    plan for the even-odd hop (its tiles of 512 sites at k = 1) and on each
    tile width a pin takes; the merged row map covers the same entries."""
    hop = _eo_hop()
    ns, nmask = hop.ns, hop.masks_main.shape[0]
    offs = tuple(o % ns for o in hop.main_offsets)
    plans = [cbs.const_block_stencil_plan(offs, hop.main_plans.hop_key, nmask, hop.bs, k, ns,
                                          H100_SMEM, H100_SMS, grouped=False)]
    for sw in cbs.CM_SW:
        try:
            plans.append(cbs.const_block_stencil_plan(offs, hop.main_plans.hop_key, nmask,
                                                      hop.bs, k, ns, H100_SMEM, H100_SMS,
                                                      sw=sw, grouped=False))
        except ValueError:
            assert plans[0].kb * sw > cbs.CM_MAX_WARPS
    for plan in plans:
        for merged in (False, True):
            assert (_cm_cover(plan, hop.bs, k, ns, merged) == 1).all()


def test_const_hop_view_plan_at_one_rhs():
    """The view's plan at one RHS on ``dirac_eo(32)``'s hop (2^19 sites, 13
    main diagonals, 11 mask rows): one right-hand side a block (kb = 1),
    tiles of 512 sites (sw = 4) and the 16-site halo (0, +-1, +-15, +-16
    from the window), whose three blocks an SM (12 warps, ``CM_SM_WARPS``)
    beat the 512-site halo's two (traffic 5 against 7.0625: the first key is
    two blocks an SM, the second the warps); the merged plans at k = 12
    keep their choice (8-warp blocks, two an SM)."""
    L = 32
    ns = L ** 4 // 2
    # the hop's main offsets (problems/dirac_eo.py) mod ns: +-16,384, +-512,
    # +-496, +-16, +-15, +-1 and 0
    dist = (16384, 512, 496, 16, 15, 1)
    offs = tuple(sorted({d % ns for d in dist} | {-d % ns for d in dist} | {0}))
    key = tuple(((float(d),) * 4,) * 4 for d in range(len(offs)))  # distinct hops
    plan = cbs.const_block_stencil_plan(offs, key, 11, 4, 1, ns, H100_SMEM, H100_SMS,
                                        grouped=False)
    assert (plan.kb, plan.sw, plan.T, plan.h, plan.traffic) == (1, 4, 512, 16, 7.0625)
    assert plan.blocks == 3 * H100_SMS and sum(plan.near) == 7
    fit = (H100_SMEM + 1024) // (plan.smem_bytes + 1024)
    assert fit * plan.kb * plan.sw >= cbs.CM_SM_WARPS
    wide = cbs.const_block_stencil_plan(offs, key, 11, 4, 1, ns, H100_SMEM, H100_SMS, h=512,
                                        grouped=False)
    assert wide.traffic == 5.0 and (H100_SMEM + 1024) // (wide.smem_bytes + 1024) == 2
    merged = cbs.const_block_stencil_plan(offs, key, 11, 4, 12, ns, H100_SMEM, H100_SMS)
    assert (merged.kb, merged.sw) == (4, 2)


# ------------------------------------------- the view's plain versions


def test_view_plain_versions_match_the_reference():
    """The (k, bs, ns) view's plain versions (the CPU route of rows 14 and
    22h) against the reference's ``const_block_stencil_spmm_t`` and
    ``block_stencil_spmm_t`` (Pallas, interpret mode) on small fields, at
    the f32 tolerance of the parity tests (relative 1e-5)."""
    import jax.numpy as jnp

    from blockcg_tpu.ops import block_stencil as jbs
    from blockcg_tpu.ops import const_block_stencil as jcbs

    rng = np.random.default_rng(14)
    bs, ns, k = 4, 512, 3
    offsets = (0, 1, -1, 16, -16, 128, -128)
    hops = rng.standard_normal((len(offsets), bs, bs)).astype(np.float32)
    slots = (-1, 0, 1, -1, 0, 1, -1)
    masks = (rng.random((2, ns)) < 0.5).astype(np.float32)
    X = rng.standard_normal((k, bs, ns)).astype(np.float32)
    want = np.asarray(jcbs.const_block_stencil_spmm_t(
        tuple(tuple(tuple(float(v) for v in r) for r in h) for h in hops), offsets, slots,
        jnp.asarray(masks), jnp.asarray(X), interpret=True))
    got = cbs.const_block_stencil_spmm_t(torch.from_numpy(hops), offsets, slots,
                                         torch.from_numpy(masks), torch.from_numpy(X)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    blocks = rng.standard_normal((len(offsets), bs, bs, ns)).astype(np.float32)
    want = np.asarray(jbs.block_stencil_spmm_t(jnp.asarray(blocks), offsets, jnp.asarray(X),
                                               interpret=True))
    for B in (torch.from_numpy(blocks), torch.from_numpy(blocks).bfloat16()):
        got = bsk.block_stencil_spmm_t(B, offsets, torch.from_numpy(X)).float().numpy()
        ref = want if B.dtype == torch.float32 else np.asarray(jbs.block_stencil_spmm_t(
            jnp.asarray(B.float().numpy()), offsets, jnp.asarray(X), interpret=True))
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
