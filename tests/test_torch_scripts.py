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
    ("void (anonymous namespace)::slab_accumulate<4, 64>(float const*)", True),
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
