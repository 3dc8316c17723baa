"""Row 1m (the DIA stencil on bf16 diagonals and an f32 field) on the ring of
planes and row 13 (``qr_px_update``) on ``csrc/px_update.cu``'s QR-with-X
mode, on the CPU.

The kernels run only on the card (tests/test_torch_kernels_cuda.py). Here
the host side is held to its rules: ``stencil_ring_plan`` for an f32 field
(the slots' bytes by the field's element), ``ring_smem_bytes`` against the
source's formula, ``launch_plans`` and ``stencil._launch`` sending 1m to the
ring (``bcg_stencil_ring_bf16d``), the plans of ``qr_px_update``
(``qr_px_update_plan``, and ``px_update_mma_plan``, which it shares with
``px_update``) and the routes
its wrapper launches (launches recorded by a stand-in for
``_native.launch``; the library is never loaded). The plain version of
``qr_px_update`` on 48 bf16 rows is held against the reference's Pallas
kernel in interpret mode on its f32 coefficient route, to one bf16 ulp
(floored at 2^-8 of the field's largest), as ``tests/test_torch_bf16.py``
holds the other rows.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blockcg_tpu.ops import fused as jfused
from blockcg_tpu_torch.ops import _native, fused, stencil

H100_SMEM = 232448  # bytes of shared memory one block may opt into on an H100
H100_SMS = 132
CSRC = Path(__file__).resolve().parents[1] / "blockcg_tpu_torch" / "csrc"
BF, F32 = torch.bfloat16, torch.float32


def _lap_offsets(edge):
    """The 7-point Laplacian's offsets on an edge^3 grid."""
    return (0, 1, -1, edge, -edge, edge * edge, -edge * edge)


@pytest.fixture
def h100(monkeypatch):
    monkeypatch.setattr(_native, "max_smem", lambda index: H100_SMEM)
    monkeypatch.setattr(_native, "sm_count", lambda index: H100_SMS)


@pytest.fixture
def launches(monkeypatch, h100):
    """The launches the wrappers make, as (count name, library function,
    arguments), with every CPU tensor sent to the kernel route."""
    calls = []
    monkeypatch.setattr(_native, "launch",
                        lambda name, fn, dev, *a: calls.append((name, fn, a)))
    monkeypatch.setattr(_native, "field_kernel",
                        lambda fields, coeffs=(): next(f for f in fields if f is not None).dtype)
    return calls


# --------------------------------------------- row 1m on the ring of planes


@pytest.mark.parametrize("edge,dsize,S,h,rows,segs", [
    (128, 2, 16384, 128, 8, 2),  # row 1m at the north star's shape
    (128, 4, 16384, 128, 8, 2),  # row 1 (f32 diagonals)
    (256, 2, 65536, 256, 8, 1),  # 4 slots of 48 KB and 28 KB of coefficients
    (256, 4, 65536, 256, 4, 1),  # f32 diagonals leave room for 4 rows only
])
def test_stencil_ring_plan_of_an_f32_field(edge, dsize, S, h, rows, segs):
    """An f32 field of 32 rows: planes of S columns, every offset m S + r
    (mod n) with |r| <= h and |m| <= M = 1, rows of ``RING_ROWS[4]`` (8 where
    four 8-row slots fit beside the coefficients, else 4), a launch that
    fits 232,448 bytes with its static bytes, the model's traffic below the
    window kernel's."""
    n, offsets = edge ** 3, _lap_offsets(edge)
    plan = stencil.stencil_ring_plan(offsets, n, 32, H100_SMEM, H100_SMS, dsize, 4)
    assert (plan.S, plan.h, plan.M, plan.rows, plan.slots, plan.segs) == (S, h, 1, rows, 4,
                                                                          segs)
    assert plan.rows in stencil.RING_ROWS[4]
    assert plan.smem_bytes == stencil.ring_smem_bytes(rows, h, 4, len(offsets), dsize, 4)
    assert plan.smem_bytes + stencil.RING_STATIC_BYTES <= H100_SMEM
    wider = stencil.ring_smem_bytes(2 * rows, h, 4, len(offsets), dsize, 4)
    assert rows == 8 or wider + stencil.RING_STATIC_BYTES > H100_SMEM
    for o, (m, r) in zip(offsets, stencil.ring_decompose(offsets, n, S)):
        assert (m * S + r - o) % n == 0 and abs(r) <= h and abs(m) <= 1
    ngrp = -(-32 // rows)
    P = stencil.RING_COLS
    assert plan.items == S // P * ngrp * segs and plan.grid == min(plan.items, H100_SMS)
    assert plan.traffic == pytest.approx((P + 2 * h) / P * (plan.len + 2) / plan.len
                                         + len(offsets) * dsize * (ngrp - 1) / (4 * 32))
    window = stencil.stencil_plan(offsets, n, 32, H100_SMEM, H100_SMS, 4, dsize)
    assert plan.traffic < window.traffic


@pytest.mark.parametrize("rows,h,slots,ndiag,dsize,esize", [
    (8, 128, 4, 7, 2, 4), (4, 256, 4, 7, 4, 4), (16, 256, 4, 7, 2, 2), (8, 8, 8, 9, 4, 2)])
def test_ring_smem_bytes_mirrors_the_source(rows, h, slots, ndiag, dsize, esize):
    """``ring_smem_bytes`` is ``csrc/stencil.cu``'s: ``slots`` slots of
    ``rows`` rows of P + 2h elements of ``esize`` bytes and two coefficient
    buffers, each rounded up to 128 bytes, and 256 bytes besides."""
    st = (CSRC / "stencil.cu").read_text()
    assert "return ring_round128(1LL * esize * R * ring_span(h));" in st
    assert "inline int ring_span(int h) { return kRingCols + 2 * h; }" in st
    assert "ring_smem_bytes(R, rg.h, rg.slots, rg.ndiag, sizeof(ED), sizeof(EX))" in st
    def r128(b):
        return -(-b // 128) * 128
    want = (slots * r128(esize * rows * (stencil.RING_COLS + 2 * h))
            + 2 * r128(dsize * ndiag * stencil.RING_COLS) + 256)
    assert stencil.ring_smem_bytes(rows, h, slots, ndiag, dsize, esize) == want


@pytest.mark.parametrize("k", [32, 96])
def test_launch_plans_send_1m_to_the_ring(h100, k):
    """bf16 diagonals with an f32 field (row 1m): without the Gram every
    chunk runs the ring on ``stencil_ring_plan``'s f32 plan; with the Gram
    none does (the f32 field's Gram kernels)."""
    n, offsets = 128 ** 3, _lap_offsets(128)
    D = torch.empty((len(offsets), n), dtype=BF, device="meta")
    X = torch.empty((k, n), dtype=F32, device="meta")
    plans = stencil.launch_plans(D, offsets, X, False)
    assert [rows for rows, _ in plans] == _native.row_chunks(k)
    for (r0, r1), plan in plans:
        assert plan == stencil.stencil_ring_plan(offsets, n, r1 - r0, H100_SMEM, H100_SMS, 2, 4)
        assert stencil.describe(plan).startswith("ring S=16384 h=128 P=1024 M=1 rows=8")
    assert not any(isinstance(p, stencil.RingPlan)
                   for _, p in stencil.launch_plans(D, offsets, X, True))


def test_launch_plans_keep_the_window_kernel_on_a_ragged_field(h100):
    """n % 1,024 != 0 leaves no plane of whole patches: the window kernel."""
    n, offsets = 1000 * 1024 + 8, (0, 1, -1, 1024, -1024)
    D = torch.empty((len(offsets), n), dtype=BF, device="meta")
    X = torch.empty((32, n), dtype=F32, device="meta")
    assert not any(isinstance(p, stencil.RingPlan)
                   for _, p in stencil.launch_plans(D, offsets, X, False))


def test_stencil_launch_runs_1m_on_bcg_stencil_ring_bf16d(launches):
    """``stencil._launch`` on bf16 diagonals and an f32 field: one
    ``bcg_stencil_ring_bf16d`` launch a chunk, counted as
    ``stencil_spmm_t[bf16 coeffs]``, with the plan's S, h, M, rows, runs and
    grid; X and Y of the chunk's rows."""
    n, offsets = 64 ** 3, _lap_offsets(64)
    D = torch.ones((len(offsets), n), dtype=BF)
    X = torch.zeros((40, n))
    Y, G = stencil._launch(D, offsets, X, False, "stencil_spmm_t", (F32, BF))
    plan = stencil.stencil_ring_plan(offsets, n, 40, H100_SMEM, H100_SMS, 2, 4)
    assert G is None and len(launches) == 1
    name, fn, a = launches[0]
    assert (name, fn) == ("stencil_spmm_t[bf16 coeffs]", "bcg_stencil_ring_bf16d")
    assert a[0] == D.data_ptr() and a[3] == X.data_ptr() and a[4] == Y.data_ptr()
    assert list(a[1]) == [o % n for o in offsets] and a[2] == len(offsets)
    assert a[5:] == (40, n, plan.S, plan.h, plan.M, plan.rows, plan.segs, plan.grid)


# --------------------------------------- row 13 on px_update.cu's QR with X


@pytest.mark.parametrize("k", [16, 48, 64, 96])
def test_qr_px_update_plans(h100, k):
    """The streaming plan (f32 fields, bf16 above 64 rows): one launch up to
    128 rows, in place, three coefficient tables beside its stages; the
    tensor-core plan (bf16 up to 64 rows): ``px_update_mma_plan``, whose
    kernel stores Q from its fragments and stages nothing more than px
    mode, within the H100's cap: 256 columns in two stages at 48 rows (a
    tile of Q would have left it 128); more than 64 rows refused."""
    for esize in (4, 2):
        plan = fused.qr_px_update_plan(k, torch.device("cpu"), esize)
        assert plan.chunks == [(0, k)] and plan.in_place and not plan.fused_gram
        assert plan.smem_bytes == fused.update_smem_bytes(k, k, plan.kc, 3, False, esize)
        assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= H100_SMEM + 1024
        assert plan == fused.px_update_plan(k, torch.device("cpu"), esize)
    n = 32 ** 4
    if k > fused.PX_MMA_MAX_K:
        with pytest.raises(ValueError, match="1 to 64 rows"):
            fused.px_update_mma_plan(k, n, H100_SMEM, H100_SMS)
        return
    mma = fused.px_update_mma_plan(k, n, H100_SMEM, H100_SMS)
    assert mma.smem_bytes == fused.px_update_mma_smem_bytes(k, mma.T, mma.stages)
    assert mma.smem_bytes + fused.RING_BARRIER_BYTES <= H100_SMEM and mma.stages >= 2
    assert (mma.T, mma.stages) == {16: (512, 4), 48: (256, 2), 64: (128, 3)}[k]


@pytest.mark.parametrize("k,dt,fn", [
    (16, BF, "bcg_qr_px_update_mma"), (48, BF, "bcg_qr_px_update_mma"),
    (64, BF, "bcg_qr_px_update_mma"), (96, BF, "bcg_qr_px_update_bf16"),
    (32, F32, "bcg_qr_px_update"), (96, F32, "bcg_qr_px_update"),
    (200, F32, "bcg_qr_px_update")])
@pytest.mark.parametrize("donate", [False, True])
def test_qr_px_update_routes(launches, k, dt, fn, donate):
    """bf16 up to 64 rows: one ``bcg_qr_px_update_mma`` launch on
    ``px_update_mma_plan``; f32, and bf16 above 64 rows: ``bcg_qr_px_update`` on
    ``qr_px_update_plan``'s chunks, one launch up to 128 rows; donated
    outputs land in Q1, P and X (above 128 rows Q and Pn through fresh
    buffers, since every chunk reads all of Q1 and P)."""
    n = 4096
    M2, rho, C = (torch.eye(k) for _ in range(3))
    Q1, P, X = (torch.zeros((k, n), dtype=dt) for _ in range(3))
    Q, Pn, Xn = fused.qr_px_update(M2, Q1, rho, P, C, X, donate=donate)
    names = {name for name, _, _ in launches}
    assert names == {"qr_px_update[bf16]" if dt == BF else "qr_px_update"}
    assert {f for _, f, _ in launches} == {fn}
    if fn == "bcg_qr_px_update_mma":
        mma = fused.px_update_mma_plan(k, n, H100_SMEM, H100_SMS)
        (_, _, a), = launches
        assert a[-4:] == (k, n, mma.T, mma.stages)
        assert a[6:9] == (Q.data_ptr(), Pn.data_ptr(), Xn.data_ptr())
    else:
        plan = fused.qr_px_update_plan(k, torch.device("cpu"), Q1.element_size())
        assert [a[-4] for _, _, a in launches] == [r1 - r0 for r0, r1 in plan.chunks]
        assert all(a[-3:] == (k, n, plan.kc) for _, _, a in launches)
        assert (len(plan.chunks) == 1) is (k <= 128)
    if donate:
        assert [t.data_ptr() for t in (Q, Pn, Xn)] == [t.data_ptr() for t in (Q1, P, X)]
    else:
        assert not {t.data_ptr() for t in (Q, Pn, Xn)} & {t.data_ptr() for t in (Q1, P, X)}


@pytest.fixture
def f32_coeff_route(monkeypatch):
    """The reference's Pallas kernels in interpret mode on their f32
    coefficient route (``BLOCKCG_NO_BF16_MXU=1``), the port's bf16 contract;
    JAX's traces are dropped on the way in and out, since the reference
    reads the switch when it traces."""
    monkeypatch.setenv("BLOCKCG_FUSED_INTERPRET", "1")
    monkeypatch.setenv("BLOCKCG_NO_BF16_MXU", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _ulps(got, want) -> float:
    """Largest |got - want| in bf16 ulps of the larger of the two, at least of
    2^-8 of the largest |want|."""
    g = got.double().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    assert g.shape == w.shape
    m = np.maximum(np.maximum(np.abs(g), np.abs(w)), np.abs(w).max() * 2.0 ** -8)
    ulp = np.exp2(np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7)
    return float((np.abs(g - w) / ulp).max())


@pytest.mark.parametrize("donate", [False, True])
def test_qr_px_update_bf16_at_48_rows_matches_pallas(f32_coeff_route, donate):
    """Row 13b's shape of rows, 48, on bf16 fields: the plain version (what
    the card's kernel is held to) against the Pallas kernel in interpret
    mode, Q, Pn and Xn each within one bf16 ulp; donated, the outputs land
    in Q1, P and X with the same values."""
    k, n = 48, 512
    rng = np.random.default_rng(2500)
    jf = [jnp.asarray(rng.standard_normal((k, n)), jnp.bfloat16) for _ in range(3)]
    jc = [jnp.asarray(rng.standard_normal((k, k)) / np.sqrt(k), jnp.float32) for _ in range(3)]
    tf = [torch.from_numpy(np.array(f.astype(jnp.float32))).to(BF) for f in jf]
    tc = [torch.from_numpy(np.array(c)) for c in jc]
    want = jfused.qr_px_update(jc[0], jf[0], jc[1], jf[1], jc[2], jf[2])
    bufs = [f.clone() for f in tf]
    got = fused.qr_px_update(tc[0], bufs[0], tc[1], bufs[1], tc[2], bufs[2], donate=donate)
    assert ([g.data_ptr() for g in got] == [b.data_ptr() for b in bufs]) is donate
    for g, w in zip(got, want):
        assert g.dtype == BF and _ulps(g, w) <= 1.0


def test_qr_p_update_source_is_gone():
    """``qr_px_update`` runs ``px_update.cu``: the one-thread-a-column kernel's
    source and the chunking it needed are gone, and its entries are the QR
    with X mode's."""
    assert not (CSRC / "qr_p_update.cu").exists() and not hasattr(fused, "_chunks")
    px = (CSRC / "px_update.cu").read_text()
    assert re.search(r'extern "C" int bcg_qr_px_update\(', px)
    assert "return update_entry<float, true, true>(" in px
    assert "return update_entry<bf16, true, true>(" in px
    assert "return px_update_mma_entry<true>(" in px
