"""The port's bf16 capacity tier on CPU tensors: the plain versions of the
bf16 kernels against the reference's Pallas kernels in interpret mode on
their f32 coefficient route, the dispatch rule, the lean refinement
against the reference's, and the plans sized by element bytes.

The same inputs, made from a numpy seed and rounded to bf16, go to both
packages. Tolerances: a stored bf16 element within one bf16 ulp of the
reference's (``_ulps``; a bf16 x bf16 product is exact in f32, so the two
differ in f32 summation order alone, which can flip a rounding), an element
below 2^-8 of the field's largest held to the ulp at that floor (where a sum
cancels, its f32 rounding error is a fraction of the terms', not of the
sum's); a Gram to a max relative error of ``GRAM_RTOL`` (f32 sums of the same
exact products in another order). The CUDA bf16 kernels are held against these plain versions
on the card (tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from blockcg_tpu.ops import fused as jfused
from blockcg_tpu.ops import stencil as jstencil
from blockcg_tpu.problems import laplacian_dia as jlaplacian_dia
from blockcg_tpu_torch.ops import _native, fused, stencil
from blockcg_tpu_torch.problems import laplacian_dia, laplacian_scipy
from blockcg_tpu_torch.solvers import refine

BF = torch.bfloat16
GRAM_RTOL = 1e-5
K, N = 8, 512  # a field of 8 rows on the 8^3 grid (the Pallas tiles take n % 128 == 0)


def _ulps(got, want) -> float:
    """Largest |got - want| in bf16 ulps of the larger of the two, at least of
    2^-8 of the largest |want|."""
    g = np.asarray(got.double() if isinstance(got, torch.Tensor) else
                   np.asarray(jnp.asarray(got).astype(jnp.float32)), np.float64)
    w = np.asarray(np.asarray(jnp.asarray(want).astype(jnp.float32)), np.float64)
    assert g.shape == w.shape
    m = np.maximum(np.maximum(np.abs(g), np.abs(w)), np.abs(w).max() * 2.0 ** -8)
    ulp = np.exp2(np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7)
    return float((np.abs(g - w) / ulp).max())


def _gram_err(got, want) -> float:
    g = got.double().numpy()
    w = np.asarray(want, np.float64)
    return float(np.abs(g - w).max() / np.abs(w).max())


def _inputs(seed):
    """Three bf16 fields and three f32 coefficients, as both packages'
    tensors: (torch fields, torch coeffs, jax fields, jax coeffs)."""
    rng = np.random.default_rng(seed)
    fields = [jnp.asarray(rng.standard_normal((K, N)), jnp.bfloat16) for _ in range(3)]
    coeffs = [jnp.asarray(rng.standard_normal((K, K)) / np.sqrt(K), jnp.float32)
              for _ in range(3)]
    tfields = [torch.from_numpy(np.array(f.astype(jnp.float32))).to(BF) for f in fields]
    tcoeffs = [torch.from_numpy(np.array(c)) for c in coeffs]
    return tfields, tcoeffs, fields, coeffs


# (case, port's plain call, reference kernel call) on (fields, coeffs).
_FUSED = {
    "gram": (lambda F, C: (fused.gram(F[0], F[1]),),
             lambda F, C: (jfused.gram(F[0], F[1]),)),
    "mm_update": (lambda F, C: (fused.mm_update(C[0], F[0]),),
                  lambda F, C: (jfused.mm_update(C[0], F[0]),)),
    "mm_update_a": (lambda F, C: (fused.mm_update(C[0], F[0], F[1]),),
                    lambda F, C: (jfused.mm_update(C[0], F[0], F[1]),)),
    "mm_update_gram": (lambda F, C: fused.mm_update_gram(C[0], F[0]),
                       lambda F, C: jfused.mm_update_gram(C[0], F[0])),
    "mm_update_gram_a": (lambda F, C: fused.mm_update_gram(C[0], F[0], F[1]),
                         lambda F, C: jfused.mm_update_gram(C[0], F[0], F[1])),
    "mm2_update_gram": (lambda F, C: fused.mm2_update_gram(C[0], F[0], C[1], F[1]),
                        lambda F, C: jfused.mm2_update_gram(C[0], F[0], C[1], F[1])),
    "px_update": (lambda F, C: fused.px_update(C[0], F[0], C[1], F[1], C[2], F[2]),
                  lambda F, C: jfused.px_update(C[0], F[0], C[1], F[1], C[2], F[2])),
    "xr_update_gram": (lambda F, C: fused.xr_update_gram(C[0], F[0], F[1], F[2], F[1]),
                       lambda F, C: jfused.xr_update_gram(C[0], F[0], F[1], F[2], F[1])),
    "qr_p_update": (lambda F, C: fused.qr_p_update(C[0], F[0], C[1], F[1]),
                    lambda F, C: jfused.qr_p_update(C[0], F[0], C[1], F[1])),
    "qr_px_update": (lambda F, C: fused.qr_px_update(C[0], F[0], C[1], F[1], C[2], F[2]),
                     lambda F, C: jfused.qr_px_update(C[0], F[0], C[1], F[1], C[2], F[2])),
}


def _check_outputs(got, want):
    for g, w in zip(got, want):
        if tuple(g.shape) == (K, K):
            assert g.dtype == torch.float32 and w.dtype == jnp.float32
            assert _gram_err(g, w) < GRAM_RTOL
        else:
            assert g.dtype == BF and w.dtype == jnp.bfloat16
            assert _ulps(g, w) <= 1.0


@pytest.fixture
def f32_coeff_route(monkeypatch):
    """The reference's Pallas kernels in interpret mode on their f32
    coefficient route (``BLOCKCG_NO_BF16_MXU=1``: a k x k coefficient stays
    f32 for the multiply of a bf16 field), the port's bf16 contract. The
    reference reads the switch when it traces, so the traces are dropped on
    the way in and on the way out."""
    monkeypatch.setenv("BLOCKCG_FUSED_INTERPRET", "1")
    monkeypatch.setenv("BLOCKCG_NO_BF16_MXU", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("case", sorted(_FUSED))
def test_fused_bf16_plain_matches_pallas(case, f32_coeff_route):
    """Rows 5-10, 12 and 13 on bf16 fields: the plain version (what the CPU
    runs and the card's smoke compares with) against the Pallas kernel in
    interpret mode on its f32 coefficient route."""
    F, C, JF, JC = _inputs(sorted(_FUSED).index(case))
    port, ref = _FUSED[case]
    _check_outputs(port(F, C), ref(JF, JC))


@pytest.mark.parametrize("gram", [False, True])
@pytest.mark.parametrize("banded", [False, True])
def test_stencil_bf16_plain_matches_pallas(gram, banded):
    """Rows 1-2 on bf16 X and bf16 diagonals (the Laplacian, and a banded
    matrix with every diagonal entry populated): Y within one ulp, the Gram
    from the f32 accumulator, as the reference kernel takes it."""
    op = jlaplacian_dia((8, 8, 8), dtype=jnp.float32)
    rng = np.random.default_rng(5 + banded)
    diags = (rng.standard_normal(op.diags.shape) if banded else np.array(op.diags))
    jd = jnp.asarray(diags, jnp.bfloat16)
    jx = jnp.asarray(rng.standard_normal((K, op.n)), jnp.bfloat16)
    td = torch.from_numpy(np.array(jd.astype(jnp.float32))).to(BF)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(BF)
    if gram:
        got = stencil.stencil_spmm_gram_t(td, op.offsets, tx)
        want = jstencil.stencil_spmm_gram_t(jd, op.offsets, jx, interpret=True)
    else:
        got = (stencil.stencil_spmm_t(td, op.offsets, tx),)
        want = (jstencil.stencil_spmm_t(jd, op.offsets, jx, interpret=True),)
    _check_outputs(got, want)
    if gram:  # the Gram is of the unrounded sums, not of the stored Y
        Y32 = stencil.stencil_spmm_plain(td.float(), op.offsets, tx.float())[0]
        exact = tx.double() @ Y32.double().T
        assert _gram_err(got[1], exact.numpy()) < GRAM_RTOL


_ROUNDED = ("mm_update", "mm_update_a", "mm_update_gram", "mm2_update_gram", "px_update",
            "xr_update_gram", "qr_p_update", "qr_px_update")


@pytest.mark.parametrize("case", _ROUNDED)
def test_coefficient_rounding_repair(case, monkeypatch):
    """The coefficient route decides the bits. The port's plain version (f32
    coefficients) is within one ulp of the Pallas kernel on the reference's
    f32 coefficient route and many ulps from its default bf16 MXU route,
    which rounds each coefficient to bf16 (``_mxu_pair``); given the
    coefficients rounded to bf16, the plain version is within one ulp of
    that route instead. The port keeps the coefficients f32: the rounding
    stalls bf16 BCG and breaks BCGA down (ROADMAP.md, "The bf16 coefficient
    rule")."""
    monkeypatch.setenv("BLOCKCG_FUSED_INTERPRET", "1")
    F, C, JF, JC = _inputs(40 + _ROUNDED.index(case))
    port, ref = _FUSED[case]
    got = port(F, C)
    jax.clear_caches()
    rounded_route = ref(JF, JC)
    monkeypatch.setenv("BLOCKCG_NO_BF16_MXU", "1")
    jax.clear_caches()
    try:
        f32_route = ref(JF, JC)
    finally:
        jax.clear_caches()  # no later test may reuse a trace of this route
    _check_outputs(got, f32_route)
    assert _ulps(got[0], rounded_route[0]) > 4.0
    _check_outputs(port(F, [c.to(BF).float() for c in C]), rounded_route)


def test_coefficient_rounding_cancellation(monkeypatch):
    """A case the coefficient route decides outright: Y = (1 + 2^-10) B - B.
    With the f32 coefficient (the port's plain version, and the reference's
    kernel on its f32 coefficient route) Y is exactly 2^-10 B; the
    reference's bf16 MXU route rounds 1 + 2^-10 to 1 and stores exactly 0."""
    B = torch.from_numpy(np.random.default_rng(9).standard_normal((1, N)).astype(np.float32))
    B = B.to(BF).repeat(2, 1)
    M = torch.tensor([[1 + 2.0 ** -10, -1.0], [0.0, 1.0]])
    Y = fused.mm_update_plain(M, B)
    assert torch.equal(Y[0], B[0] * 2.0 ** -10)
    assert torch.equal(Y[1], B[1])
    jM = jnp.asarray(M.numpy())
    jB = jnp.asarray(B.float().numpy(), jnp.bfloat16)
    jax.clear_caches()
    rounded_route = jfused.mm_update(jM, jB, interpret=True)
    assert not np.asarray(rounded_route[0].astype(jnp.float32)).any()
    monkeypatch.setenv("BLOCKCG_NO_BF16_MXU", "1")
    jax.clear_caches()
    try:
        f32_route = jfused.mm_update(jM, jB, interpret=True)
    finally:
        jax.clear_caches()
    assert np.array_equal(np.asarray(f32_route.astype(jnp.float32)), Y.float().numpy())


def test_dispatch_rule_cpu():
    """On CPU tensors every bf16 wrapper runs its plain version and counts no
    launch; the dtype rule itself (checked before the device type, so meta
    tensors show it without a card) sends bf16 fields with f32 coefficients
    to the bf16 variant and refuses other mixes; the stencil's pair rule
    sends each of its four f32/bf16 pairs to its variant and refuses any
    other."""
    F, C, _, _ = _inputs(3)
    _native.reset_launches()
    fused.mm_update(C[0], F[0])
    fused.px_update(C[0], F[0], C[1], F[1], C[2], F[2])
    op = laplacian_dia((8, 8, 8), dtype=BF, device="cpu")
    op.matmat_gram_t(F[0])
    assert sum(_native.launches.values()) == 0
    assert _native.field_kernel((F[0],), (C[0],)) is None
    meta = [t.to("meta") for t in (F[0], C[0], op.diags)]
    f, c, d = meta
    with pytest.raises(ValueError, match="unsupported device"):
        _native.field_kernel((f, f), (c,))  # bf16 fields, f32 coefficients: the bf16 kernel
    for fields, coeffs in (((f,), (c.to(BF),)),  # bf16 coefficients
                           ((f, f.float()), (c,))):  # a mixed field set
        with pytest.raises(TypeError):
            _native.field_kernel(fields, coeffs)
    for x, dg in ((f, d), (f, d.float()), (f.float(), d), (f.float(), d.float())):
        with pytest.raises(ValueError, match="unsupported device"):
            _native.pair_kernel(x, dg, stencil.PAIRS)  # past the dtype rule
    with pytest.raises(TypeError):
        _native.pair_kernel(f, d.double(), stencil.PAIRS)  # f64 diagonals, bf16 field
    assert _native.variant("px_update", "bcg_px_update", BF) == (
        "px_update[bf16]", "bcg_px_update_bf16")
    assert _native.variant("gram", "bcg_gram", torch.float32) == ("gram", "bcg_gram")


def test_dispatch_rule_rows_10_to_21():
    """The dtype rule on meta tensors (no card needed: the rule is read
    before the device type). ``xr_update_gram``, ``qr_p_update`` and
    ``qr_px_update`` send bf16 fields with f32 coefficients on to their bf16
    variants (which refuse the meta device) and raise ``TypeError`` on a bf16
    coefficient or a mixed field set; the const-hop wrappers run their plain
    version on bf16 operands (a meta result, nothing launched) and send f32
    on to their kernels. (On the card a mix raises there, and ``cheb_step``
    refuses bf16: ``tests/test_torch_kernels_cuda.py``.)"""
    from blockcg_tpu_torch.ops import const_block_stencil as cbs
    from blockcg_tpu_torch.problems import dirac_cbdia

    f = torch.empty((8, 512), dtype=BF, device="meta")
    c = torch.empty((8, 8), dtype=torch.float32, device="meta")
    calls = {
        "xr_update_gram": lambda f, g, c: fused.xr_update_gram(c, f, f, g, f),
        "qr_p_update": lambda f, g, c: fused.qr_p_update(c, f, c, g),
        "qr_px_update": lambda f, g, c: fused.qr_px_update(c, f, c, f, c, g),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="unsupported device"):
            call(f, f, c)  # past the dtype rule: the bf16 variant
        with pytest.raises(TypeError):
            call(f, f, c.to(BF))  # a bf16 coefficient
        with pytest.raises(TypeError):
            call(f, f.float(), c)  # bf16 and f32 fields
    op = dirac_cbdia(4, dtype=BF, device="cpu")
    h, m = op.hops_main.to("meta"), op.masks_main.to("meta")
    X = torch.empty((op.bs * 3, op.ns), dtype=BF, device="meta")
    _native.reset_launches()
    Y = cbs.const_block_stencil_spmm_m_t(h, op.main_offsets, op.main_slots, m, X)
    Yv = cbs.const_block_stencil_spmm_t(h, op.main_offsets, op.main_slots, m,
                                        X.reshape(3, op.bs, op.ns))
    assert Y.device.type == "meta" and Y.dtype == BF and Yv.shape == (3, op.bs, op.ns)
    assert sum(_native.launches.values()) == 0
    assert not _native.f32_kernel(h, m, X)
    with pytest.raises(ValueError, match="unsupported device"):
        _native.f32_kernel(h.float(), m.float(), X.float())  # f32: the kernel
    # The operator reads the same rule and sends a bf16 field whole to the
    # plain roll-and-einsum: no const-hop wrapper is called.
    assert _native.f32_gate_refuses(op.hops_all, X)
    assert not _native.f32_gate_refuses(op.hops_all.float(), X)
    Xc = torch.ones((op.bs * 3, op.ns), dtype=BF)
    want = cbs.const_block_stencil_plain(op.hops_all, op.offsets, op.mask_slot, op.masks, Xc)[0]
    with pytest.MonkeyPatch.context() as patch:
        for name in ("const_block_stencil_spmm_m_t", "const_block_stencil_spmm_m_gram_t",
                     "const_block_stencil_spmm_t", "slab_m_accumulate",
                     "slab_block_accumulate"):
            patch.setattr(cbs, name, None)  # calling a wrapper would raise
        assert torch.equal(op.matmat_t(Xc), want)
        Y, G = op.matmat_gram_t(Xc)
        assert torch.equal(Y, want) and G is None


def test_dirac_cbdia_bf16_matches_reference():
    """``dirac_cbdia(4, bfloat16)`` builds (it raised ``TypeError`` before):
    hops, masks, offsets, slots, slabs and nnz bitwise the reference's bf16
    operator (both round each hop entry to nearest even), and its apply, on
    the reference's route for bf16 (every diagonal by the plain
    roll-and-einsum, each term and each add rounded to bf16), within one
    bf16 ulp of the reference's ``_matmat_m_xla`` (the two sum a term's four
    exact products in f32, perhaps in other orders) at k = 3 and k = 1; no
    fused Gram, as the reference returns none for bf16. An f64 copy
    (``astype``) applies the bf16 matrix exactly."""
    from blockcg_tpu.problems import dirac_cbdia as jdirac_cbdia
    from blockcg_tpu_torch.operators import astype
    from blockcg_tpu_torch.problems import dirac_cbdia

    op = dirac_cbdia(4, dtype=BF, device="cpu")
    jop = jdirac_cbdia(4, dtype=jnp.bfloat16)
    assert op.dtype == BF and op.masks.dtype == BF
    assert (op.hops, op.offsets, op.mask_slot, op.slabs, op.nnz) == (
        jop.hops, jop.offsets, jop.mask_slot, jop.slabs, jop.nnz)
    assert np.array_equal(op.masks.float().numpy(), np.asarray(jop.masks.astype(jnp.float32)))
    assert torch.equal(op.hops_all.double(), torch.tensor(jop.hops, dtype=torch.float64))
    rng = np.random.default_rng(12)
    for k in (3, 1):
        jX = jnp.asarray(rng.standard_normal((k, op.n)), jnp.bfloat16)
        X = torch.from_numpy(np.array(jX.astype(jnp.float32))).to(BF)
        Y = op.matmat_t(X)
        assert Y.dtype == BF and _ulps(Y, jop.matmat_t(jX)) <= 1.0
        Z, G = op.matmat_gram_t(X)
        assert G is None and torch.equal(Z, Y)
    op64 = astype(op, torch.float64)
    assert torch.equal(op64.hops_all, op.hops_all.double())


def test_plans_sized_by_element_bytes():
    """bf16 stages take half the shared bytes of f32 ones; the bf16 stencil's
    halo is a multiple of 8 (a 16-byte copy carries 8 bf16)."""
    cap, sms = 232448, 132
    for k, nmat in ((32, 2), (64, 3)):
        assert (fused.update_smem_bytes(k, k, 64, nmat, False, 2)
                == fused.update_smem_bytes(k, k, 64, nmat, False, 4) - 2 * 2 * 64 * 128)
    f32 = fused._update_plan("px_update", 32, 2, 3, 0, cap, True, 4)
    b16 = fused._update_plan("px_update", 32, 2, 3, 0, cap, True, 2)
    assert b16.smem_bytes <= cap and b16.kc >= f32.kc
    assert fused.gram_mma_smem_bytes(32, 32, False, 256, 3) == 3 * 2 * 64 * 256 + 1024
    offs = (-65536, -256, -1, 0, 1, 256, 65536)
    p2 = stencil.stencil_plan(offs, 256 ** 3, 32, cap, sms, 2)
    p4 = stencil.stencil_plan(offs, 256 ** 3, 32, cap, sms, 4)
    assert p2.h % 8 == 0 and p4.h % 4 == 0
    assert p2.smem_bytes == stencil.smem_bytes(32, 7, p2.h, p2.T, 2) <= cap
    assert p2.near[2] and p2.near[4]  # +-1 from the window


def test_bf16_sbcgrq_keeps_bf16_fields():
    """The inner solver on bf16 fields: X stays bf16 and the k x k algebra
    and monitors f32 (reference ``blockcg_tpu/solvers/sbcgrq.py:100``)."""
    from blockcg_tpu_torch.solvers.sbcgrq import _sbcgrq_impl

    op = laplacian_dia((16, 16), dtype=BF, device="cpu")
    Bt = refine.lean_rhs(3, 4, op.n, BF, "cpu")
    X, info = _sbcgrq_impl(op, Bt, torch.zeros_like(Bt), 5e-3, 400, 1, 0, False)
    assert X.dtype == BF and info.relres.dtype == torch.float32
    assert bool(info.converged.all())


def test_lean_rhs_is_deterministic():
    a = refine.lean_rhs(11, 4, 300, BF, "cpu")
    b = refine.lean_rhs(11, 4, 300, BF, "cpu")
    assert a.dtype == BF and a.shape == (4, 300) and torch.equal(a, b)
    f = refine.lean_rhs(11, 4, 300, torch.float32, "cpu")
    assert torch.equal(f.to(BF), a)  # drawn in f32, then rounded


def test_refined_lean_matches_reference(monkeypatch):
    """``solve_refined_lean`` against the reference's on a bf16 16x16
    Laplacian, k = 8 in slices of 4 (``tests/test_bf16.py``'s run), both on
    JAX's B: both reach a true relres <= 2e-6, in cycle counts within 1.
    (The reference's CPU route is its XLA fallback, which does not round
    the coefficients; the port follows the kernels' contract.)"""
    from blockcg_tpu.solvers.refine import solve_refined_lean as jlean

    shape, k, key = (16, 16), 8, jax.random.PRNGKey(7)
    Bj = jax.random.normal(key, (k, 256), jnp.float32).astype(jnp.bfloat16)
    Bnp = np.asarray(Bj.astype(jnp.float32))

    def jax_b(seed, k_, n, bdtype, device):
        assert (k_, n) == (k, 256) and bdtype == BF
        return torch.from_numpy(Bnp.copy()).to(device=device, dtype=bdtype)

    monkeypatch.setattr(refine, "lean_rhs", jax_b)
    kw = dict(tol=1e-6, inner_tol=5e-3, inner_max_iter=400, max_cycles=12, inner_block=4)
    X, info = refine.solve_refined_lean(laplacian_dia(shape, dtype=BF, device="cpu"), 7, k, **kw)
    Xj, infoj = jlean(jlaplacian_dia(shape, dtype=jnp.bfloat16), key, k, **kw)
    assert X.dtype == torch.float32 and X.shape == (256, k)
    a = laplacian_scipy(shape)
    B = Bnp.T.astype(np.float64)
    for sol in (X.double().numpy(), np.asarray(Xj, np.float64)):
        res = np.linalg.norm(a @ sol - B, axis=0) / np.linalg.norm(B, axis=0)
        assert res.max() <= 2e-6
    assert bool(info.converged.all()) and bool(infoj.converged.all())
    assert abs(int(info.iterations) - int(infoj.iterations)) <= 1


def test_refined_lean_options():
    op = laplacian_dia((16, 16), dtype=BF, device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        refine.solve_refined_lean(op, 0, 8, deflate=True)
    with pytest.raises(ValueError, match="must divide"):
        refine.solve_refined_lean(op, 0, 8, inner_block=3)
    X, info = refine.solve_refined_lean(op, 1, 4, max_cycles=0)  # cycle 0: the residual of X = 0
    assert info.iterations == 0 and torch.equal(X, torch.zeros_like(X))
    assert torch.allclose(info.relres, torch.ones(4))


def test_config5_preset_bf16():
    """The config-5 preset builds the bf16 operator (cut here to 8^3), and
    its exact f32 widening is the lean refinement's outer operator."""
    from blockcg_tpu_torch.operators import astype
    from blockcg_tpu_torch.problems.presets import config5_sbcgrq_3d_256

    op, B, meta = config5_sbcgrq_3d_256(dtype=BF, shape=(8, 8, 8), device="cpu")
    assert op.dtype == BF and B.dtype == BF and B.shape == (512, 64)
    op32 = astype(op, torch.float32)
    assert op32.dtype == torch.float32 and op.dtype == BF
    assert torch.equal(op32.diags, op.diags.float())
    ref = laplacian_dia((8, 8, 8), dtype=torch.float32, device="cpu")
    assert torch.equal(op32.diags, ref.diags) and op32.offsets == ref.offsets
