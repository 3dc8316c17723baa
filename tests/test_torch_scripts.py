"""The GPU scripts of the repo (chip_smoke.py, chip_profile.py, tools/torch_slab_times.py):
their refusal to run without a card, and the profile's device-time sums."""

import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 1000)], 1.0),
    ([(0, 1000), (500, 1500)], 1.5),        # overlap counts once
    ([(2000, 3000), (0, 1000)], 2.0),       # unsorted, with a gap
    ([(0, 3000), (1000, 2000)], 3.0),       # nested
])
def test_profile_union_ms(intervals, want):
    assert _load("chip_profile").union_ms(intervals) == pytest.approx(want)


def test_profile_summary_of_trace_events():
    events = [
        {"cat": "kernel", "name": "void stencil_spmm<32, true>(float const*)", "ts": 0, "dur": 400},
        {"cat": "kernel", "name": "void px_update<32>(float const*)", "ts": 500, "dur": 300},
        {"cat": "kernel", "name": "void at::native::elementwise_kernel<128>", "ts": 700, "dur": 200},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1500, "dur": 500},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 5000},  # host side, ignored
    ]
    s = _load("chip_profile").summarize(events, iterations=2)
    assert s["kernels_per_iteration"] == 1.5
    assert s["span_ms"] == pytest.approx(2.0)
    assert s["busy_ms"] == pytest.approx(1.3)  # 0-400, 500-900, 1500-2000
    assert s["port_ms"] == pytest.approx(0.7)
    assert s["idle_share"] == pytest.approx(0.35)
    assert s["top"][0][0].startswith("void stencil_spmm")


@pytest.mark.parametrize("name,port", [
    ("void (anonymous namespace)::cbs_spmm<4, 64, true>(float const*, Diags)", True),
    ("void (anonymous namespace)::stencil_spmm<float, float, 64, true>(float const*, Diags)",
     True),
    ("void (anonymous namespace)::reduce_partials_f64(double const*, float*, int, int)", True),
    ("void (anonymous namespace)::slab_stream<4, 4, 48>(float const*, int)", True),
    ("void (anonymous namespace)::reduce_partials(float const*)", True),
    ("void (anonymous namespace)::xr_update_gram<16>(float const*, float const*)", True),
    ("void (anonymous namespace)::qr_p_update<64>(float const*, float const*)", True),
    ("void (anonymous namespace)::bs_spmm<8, 64, true, false>(float const*, Offsets)", True),
    ("void (anonymous namespace)::cbs_spmm<4, 8, false, true>(float const*, Diags)", True),
    ("void (anonymous namespace)::cm_spmm<4, 6, 0>((anonymous namespace)::CmLaunch)", True),
    ("void (anonymous namespace)::px_update_kernel<6, true>(float const*, float const*)", True),
    ("void (anonymous namespace)::qr_px_update<64>(float const*, float const*)", True),
    ("void (anonymous namespace)::reduce_spin_contract(float const*, float*)", True),
    ("void (anonymous namespace)::cheb_step_vec(float4 const*, float4 const*)", True),
    ("void (anonymous namespace)::cheb_step_scalar(float const*, float const*)", True),
    ("void (anonymous namespace)::mm_update_kernel<4, false>(float const*, float const*)", True),
    ("void (anonymous namespace)::mm2_update_gram_kernel<4, 32, 2>(float const*)", True),
    ("void (anonymous namespace)::px_update_kernel<4>(float const*, float const*)", True),
    ("void (anonymous namespace)::update_gram_kernel<1, true, 4, 32, 2>(float const*)", True),
    ("void (anonymous namespace)::tiled_spmm<8, 32, float>(float const*, int const*)", True),
    ("void (anonymous namespace)::coeff_update<64, true>(float const*, float const*)", True),
    ("void (anonymous namespace)::xr_update_gram_kernel<float, 2, 16>(float const*)", True),
    ("void (anonymous namespace)::xr_update_gram_kernel<__nv_bfloat16, 6, 48>(float const*)",
     True),
    ("void at::native::vectorized_elementwise_kernel<4>", False),
])
def test_profile_port_kernel_names(name, port):
    assert bool(_load("chip_profile").PORT_KERNEL.search(name)) is port


@pytest.mark.parametrize("nbytes,flops,want", [
    (3.35e9, 0, (1.0, "bytes")),            # 3.35 GB at 3.35 TB/s
    (0, 67e9, (1.0, "operations")),         # 67 GFLOP at 67 TFLOP/s
    (3.35e9, 2 * 67e9, (2.0, "operations")),
])
def test_smoke_bound_ms(nbytes, flops, want):
    ms, by = _load("chip_smoke").bound_ms(nbytes, flops)
    assert ms == pytest.approx(want[0]) and by == want[1]


@pytest.mark.parametrize("nbytes,flops,want", [
    (0, 989e9, (1.0, "operations")),        # 989 GFLOP at the bf16 tensor-core rate
    # mm2_update_gram[bf16] at (32, 256^3): 3.22 GB and 86.4 GFLOP, bytes-bound
    (3 * 2 * 32 * 2 ** 24 + 2 * 4 * 32 * 32 + 4 * 32 * 32,
     4 * 32 * 32 * 2 ** 24 + 32 * 33 * 2 ** 24, (0.9616, "bytes")),
])
def test_smoke_bound_ms_bf16(nbytes, flops, want):
    smoke = _load("chip_smoke")
    ms, by = smoke.bound_ms(nbytes, flops, smoke.BF16_FLOPS)
    assert ms == pytest.approx(want[0], rel=1e-4) and by == want[1]


def test_smoke_library_check_measures_a_less_accurate_call(capsys):
    """Given a measure, a library call that disagrees with the kernel is kept
    and its error printed; without one it is refused."""
    import torch

    smoke = _load("chip_smoke")
    want = torch.ones(4)

    def call():
        return want + 1e-2

    assert smoke._library_check(torch, call, want, "sum")[0] is None
    kept, why = smoke._library_check(torch, call, want, "sum",
                                     lambda g, w: float((g - w).abs().max()))
    assert kept is call and why is None
    assert "[library] sum: error 1.000e-02" in capsys.readouterr().out


def _gram_contract_case(smoke, torch):
    from blockcg_tpu_torch.problems import laplacian_dia

    op = laplacian_dia((8, 8, 8), dtype=torch.bfloat16, device="cpu")
    gen = torch.Generator().manual_seed(0)
    M1, M2 = (torch.randn((4, 4), generator=gen) / 2 for _ in range(2))
    B1, B2 = (torch.randn((4, op.n), generator=gen).bfloat16() for _ in range(2))
    return op, M1, M2, B1, B2


def test_smoke_gram_contract_holds_the_plain_versions(capsys):
    """[config5]'s Gram check on the plain versions (the CPU route): each
    Gram is nearer the f64 Gram its contract names (rows 7-8 the stored bf16
    Y, row 2 the f32 sums) by the margin of the 64^3 cut; row 5 as U V^T
    and as U U^T."""
    import torch

    smoke = _load("chip_smoke")
    smoke.gram_contract(torch, *_gram_contract_case(smoke, torch), smoke.GRAM_MARGIN, "8^3")
    assert capsys.readouterr().out.count("[config5] gram contract") == 5


@pytest.mark.parametrize("row", ["stencil_spmm_gram_t", "mm_update_gram"])
def test_smoke_gram_contract_refuses_the_other_candidate(monkeypatch, row):
    """A Gram taken on the other candidate (row 7 on the unrounded f32 sums,
    row 2 on the stored bf16 Y) fails the nearer check, with the f64 bound
    out of the way."""
    import torch

    from blockcg_tpu_torch.ops import fused, stencil

    smoke = _load("chip_smoke")
    monkeypatch.setattr(smoke, "GRAM_RTOL", 1.0)
    if row == "mm_update_gram":
        update = fused.mm_update

        def wrong(M, B):
            Y32 = update(M, B.float())  # the f32 sums, f32 coefficients
            return Y32.bfloat16(), Y32 @ Y32.T

        monkeypatch.setattr(fused, "mm_update_gram", wrong)
    else:
        spmm = stencil.stencil_spmm_t

        def wrong(diags, offsets, X):
            Y = spmm(diags, offsets, X)
            return Y, X.float() @ Y.float().T

        monkeypatch.setattr(stencil, "stencil_spmm_gram_t", wrong)
    with pytest.raises(AssertionError, match=f"{row}.*other candidate"):
        smoke.gram_contract(torch, *_gram_contract_case(smoke, torch), 1.0, "8^3")


def test_smoke_work_counts():
    import torch

    smoke = _load("chip_smoke")
    a, b = torch.zeros((3, 4)), torch.eye(5, dtype=torch.float64)
    assert smoke.nbytes(a, b, 7) == 3 * 4 * 4 + 25 * 8 + 7
    assert smoke.nnz(a, b) == 5


@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_profile.py",
                                    "tools/torch_slab_times.py"])
@pytest.mark.parametrize("alone", [False, True])
def test_gpu_script_fails_without_card(tmp_path, script, alone):
    """With no CUDA device, or copied away from the package, the script exits
    non-zero and prints no result."""
    path = ROOT / script
    if alone:
        path = Path(shutil.copy(path, tmp_path / path.name))
    res = subprocess.run([sys.executable, str(path)], capture_output=True, text=True,
                         cwd=path.parent, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_smoke_scaled_laplacian_is_d_a_d(monkeypatch):
    """The [precond] system: D A D with D = diag(exp(0.5 g)) on the
    Dirichlet Laplacian, as DIA diagonals."""
    import numpy as np
    import torch

    from blockcg_tpu_torch.problems import laplacian_scipy

    smoke = _load("chip_smoke")
    monkeypatch.setattr(smoke, "PRECOND_SHAPE", (5, 6, 7))
    op = smoke._scaled_laplacian(torch, torch.device("cpu"), seed=3)
    a = laplacian_scipy((5, 6, 7)).toarray()
    s = np.exp(0.5 * np.random.default_rng(3).standard_normal(a.shape[0]))
    X = np.random.default_rng(4).standard_normal((a.shape[0], 2))
    got = op.astype_op(torch.float64).matmat(torch.from_numpy(X)).numpy()
    want = (s[:, None] * a * s[None, :]) @ X
    # The operator holds f32 diagonals: entries rounded to f32.
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-6


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_smoke_eo_true_relres_is_the_full_operators(dtype):
    """[eo]'s residual through the parity hops equals the full matrix's."""
    import numpy as np
    import torch

    from blockcg_tpu_torch.problems import (
        bdia_scipy,
        dirac_bdia,
        dirac_eo,
        dirac_gauged,
        dirac_gauged_eo,
    )

    smoke = _load("chip_smoke")
    rng = np.random.default_rng(5)
    if dtype == "float64":
        eo = dirac_eo(4, dtype=torch.float64, device="cpu")
        a = bdia_scipy(dirac_bdia(4, dtype=torch.float64, device="cpu"))
        B, X = rng.standard_normal((eo.n, 3)), rng.standard_normal((eo.n, 3))
    else:
        eo = dirac_gauged_eo(4, dtype=torch.complex128, device="cpu")
        a = bdia_scipy(dirac_gauged(4, dtype=torch.complex128, device="cpu"))
        B, X = (rng.standard_normal((a.shape[0], 3)) + 1j * rng.standard_normal((a.shape[0], 3))
                for _ in range(2))
    sigma = 0.5
    want = (np.linalg.norm(B - a @ X - sigma * X, axis=0) / np.linalg.norm(B, axis=0)).max()
    got = smoke.eo_true_relres(torch, eo, torch.from_numpy(X), torch.from_numpy(B), sigma)
    assert got == pytest.approx(want, rel=1e-12)


def test_smoke_storage_variants_are_required_on_their_path():
    """[storage]'s launch check fails when any of its variants was not
    launched on its path, and every one of them is a row of the kernels
    line with its TPU kernel."""
    smoke = _load("chip_smoke")
    counts = {w: 3 for w in smoke.STORAGE_KERNELS}
    smoke.require_launches("[storage]", counts, smoke.STORAGE_KERNELS)
    for w in smoke.STORAGE_KERNELS:
        with pytest.raises(AssertionError, match=r"\[storage\] never launched"):
            smoke.require_launches("[storage]", {**counts, w: 0}, smoke.STORAGE_KERNELS)
    assert len(smoke.STORAGE_KERNELS) == 10
    for src, rep in smoke.STORAGE_KERNELS.values():
        assert (ROOT / src).is_file() and (ROOT / rep.split(":")[0]).is_file()
    assert not set(smoke.STORAGE_KERNELS) & (set(smoke.KERNELS) | set(smoke.BF16_KERNELS))
