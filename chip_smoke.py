#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``blockcg_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card and
nvcc:

    python3 chip_smoke.py

It builds the kernels from ``blockcg_tpu_torch/csrc``, holds each kernel
against its plain PyTorch version at the main path's shapes, then drives the
main path: SBCGrQ on config 3 (64^3 Laplacian, 32 RHS) and the north-star
``solve_refined`` to 1e-10 on the 128^3 Laplacian with 32 RHS. Each phase
prints one line; any failure raises, and the process exits non-zero. The
last two lines are the kernels' JSON record, whose launch counts are those of
the north-star solves alone, and the run's JSON result. It
imports neither JAX nor the reference package, and fails without a card.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

FIELD_RTOL = 1e-5  # max |kernel - plain| / max |plain| for field outputs
GRAM_RTOL = 1e-5  # relative Frobenius error of Grams (summation order differs)
K = 32
SHAPES = ((128, 128, 128), (64, 64, 64))  # north star, config 3
REPS = 20

# Wrapper name -> (CUDA source, the TPU kernel it replaces). At >= 1M rows the
# reference dispatches the ring schedule (blockcg_tpu/ops/stencil_ring.py:288,
# :304) with the same contract as the windowed stencil listed here.
KERNELS = {
    "stencil_spmm_t": ("blockcg_tpu_torch/csrc/stencil.cu", "blockcg_tpu/ops/stencil.py:264"),
    "stencil_spmm_gram_t": ("blockcg_tpu_torch/csrc/stencil.cu", "blockcg_tpu/ops/stencil.py:282"),
    "gram": ("blockcg_tpu_torch/csrc/gram.cu", "blockcg_tpu/ops/fused.py:203"),
    "mm_update": ("blockcg_tpu_torch/csrc/fused_update.cu", "blockcg_tpu/ops/fused.py:265"),
    "mm_update_gram": ("blockcg_tpu_torch/csrc/fused_update.cu", "blockcg_tpu/ops/fused.py:332"),
    "mm2_update_gram": ("blockcg_tpu_torch/csrc/fused_update.cu", "blockcg_tpu/ops/fused.py:405"),
    "px_update": ("blockcg_tpu_torch/csrc/px_update.cu", "blockcg_tpu/ops/fused.py:588"),
}
CONFIG3_WRAPPERS = ("stencil_spmm_t", "stencil_spmm_gram_t", "gram", "mm_update",
                    "mm2_update_gram", "px_update")


def median_ms(torch, fn) -> float:
    """Median device time of one call, from CUDA events around each call."""
    fn()
    fn()
    pairs = []
    for _ in range(REPS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        pairs.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def relmax(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def relfro(a, b) -> float:
    import torch

    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if any(flags):
        raise RuntimeError(f"TF32 flags must be False, got {flags}")
    print(f"[device] {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"tf32 matmul={flags[0]} cudnn={flags[1]}")
    return smi


def phase_build() -> None:
    from blockcg_tpu_torch.ops import _native

    t0 = time.perf_counter()
    _native.library()
    print(f"[build] {_native.library_path()} from {len(_native.sources())} "
          f"sources in {time.perf_counter() - t0:.1f} s")


def _check(name, what, err, tol):
    if not err <= tol:  # also catches NaN
        raise AssertionError(f"{name}: {what} error {err:.3e} exceeds {tol:.0e}")


def phase_kernels(torch, dev) -> dict:
    """Each kernel against its plain version at the main path's shapes, and
    both timed. Returns {wrapper: record} for the north-star shape."""
    from blockcg_tpu_torch.ops import fused, stencil
    from blockcg_tpu_torch.problems import laplacian_dia

    records = {}
    gen = torch.Generator(device=dev).manual_seed(0)

    def field(k, n):
        return torch.randn((k, n), generator=gen, device=dev)

    for shape in SHAPES:
        op = laplacian_dia(shape, device=dev)
        n = op.n
        M1, M2, M3 = (torch.randn((K, K), generator=gen, device=dev) / K ** 0.5
                      for _ in range(3))
        B1, B2, B3 = field(K, n), field(K, n), field(K, n)
        banded = torch.randn(op.diags.shape, generator=gen, device=dev)  # wraps populated
        cases = {
            "stencil_spmm_t": (
                lambda: (stencil.stencil_spmm_t(op.diags, op.offsets, B1), None),
                lambda: stencil.stencil_spmm_plain(op.diags, op.offsets, B1)),
            "stencil_spmm_gram_t": (
                lambda: stencil.stencil_spmm_gram_t(op.diags, op.offsets, B1),
                lambda: stencil.stencil_spmm_plain(op.diags, op.offsets, B1, True)),
            "stencil_spmm_gram_t (random banded)": (
                lambda: stencil.stencil_spmm_gram_t(banded, op.offsets, B1),
                lambda: stencil.stencil_spmm_plain(banded, op.offsets, B1, True)),
            "gram": (lambda: (None, fused.gram(B1, B2)),
                     lambda: (None, fused.gram_plain(B1, B2))),
            "mm_update": (lambda: (fused.mm_update(M1, B1), None),
                          lambda: (fused.mm_update_plain(M1, B1), None)),
            "mm_update_gram": (lambda: fused.mm_update_gram(M1, B1),
                               lambda: fused.mm_update_gram_plain(M1, B1)),
            "mm2_update_gram": (lambda: fused.mm2_update_gram(M1, B1, M2, B2),
                                lambda: fused.mm2_update_gram_plain(M1, B1, M2, B2)),
            "px_update": (lambda: fused.px_update(M1, B1, M2, B2, M3, B3),
                          lambda: fused.px_update_plain(M1, B1, M2, B2, M3, B3)),
        }
        for name, (kern, plain) in cases.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            errs, abs_err = [], 0.0
            for i, (g, w) in enumerate(zip(got, want)):
                if w is None:
                    continue
                is_gram = w.shape == (K, K)
                err = relfro(g, w) if is_gram else relmax(g, w)
                _check(name, "Gram" if is_gram else f"output {i}", err,
                       GRAM_RTOL if is_gram else FIELD_RTOL)
                errs.append(err)
                abs_err = max(abs_err, float((g - w).abs().max()))
            ms, plain_ms = median_ms(torch, kern), median_ms(torch, plain)
            rate = (f", {op.nnz / ms / 1e6:.2f} Gnnz/s"
                    if name == "stencil_spmm_t" else "")
            print(f"[kernel] {name} n={n} k={K}: rel err {max(errs):.2e} "
                  f"(max abs {abs_err:.2e}), kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms{rate}")
            if shape == SHAPES[0] and name in KERNELS:
                records[name] = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms}
            elif name in records:
                records[name]["max_abs_err"] = max(records[name]["max_abs_err"], abs_err)
        del op, B1, B2, B3, banded
        torch.cuda.empty_cache()
    return records


def true_relres(torch, op, X, B) -> float:
    """max_j ||B e_j - A X e_j|| / ||B e_j||, in f64 on the card."""
    from blockcg_tpu_torch.operators import astype

    B64 = B.double()
    R = B64 - astype(op, torch.float64).matmat(X.double())
    return float((torch.linalg.vector_norm(R, dim=0)
                  / torch.linalg.vector_norm(B64, dim=0)).max())


def phase_config3(torch, dev) -> None:
    from blockcg_tpu_torch import solve_sbcgrq
    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.problems import config3_sbcgrq_3d_64

    op, B, meta = config3_sbcgrq_3d_64(device=dev)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        X, info = solve_sbcgrq(op, B, tol=1e-6, qr_passes=1)
        torch.cuda.synchronize()
        runs.append((X, info, time.perf_counter() - t0))
        if _ == 0:
            missing = [w for w in CONFIG3_WRAPPERS if _native.launches[w] == 0]
            if missing:
                raise AssertionError(f"config 3 did not launch the kernels of {missing}")
    (X1, info, s1), (X2, info2, s2) = runs
    if not bool(info.converged.all()):
        raise AssertionError(f"config 3 did not converge: {info}")
    rel = true_relres(torch, op, X1, B)
    if not rel <= 1e-5:
        raise AssertionError(f"config 3 true relres {rel:.3e} > 1e-5")
    if not torch.equal(X1, X2):
        raise AssertionError("config 3 repeat solve is not bitwise identical")
    counts = {w: _native.launches[w] for w in CONFIG3_WRAPPERS}
    print(f"[config3] {meta['name']} n={op.n} k={B.shape[1]}: {info.iterations} iterations, "
          f"{s1:.3f} s (repeat {s2:.3f} s, {info2.iterations} iterations, bitwise identical), "
          f"true relres {rel:.3e}, launches after first solve {counts}")


def phase_north_star(torch, dev) -> None:
    from blockcg_tpu_torch import solve_refined, solve_sbcgrq
    from blockcg_tpu_torch.problems import laplacian_dia
    from blockcg_tpu_torch.problems.presets import _rhs

    op = laplacian_dia(SHAPES[0], device=dev)
    B = _rhs(op.n, K, torch.float32, device=dev)
    for qr_passes in (1, 2):
        inner = []

        def solve_fn(o, r, t):
            X, info = solve_sbcgrq(o, r, tol=t, max_iter=2000, qr_passes=qr_passes)
            inner.append(info.iterations)
            return X, info

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        X, info = solve_refined(op, B, tol=1e-10, inner_tol=3e-6, solve_fn=solve_fn)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rel = true_relres(torch, op, X, B)
        if not (bool(info.converged.all()) and rel <= 1e-10):
            raise AssertionError(f"north star (qr_passes={qr_passes}) reached "
                                 f"true relres {rel:.3e}, not 1e-10: {info}")
        print(f"[northstar] 128^3 n={op.n} k={K} tol=1e-10 inner_tol=3e-6 "
              f"qr_passes={qr_passes}: {info.iterations} cycles, {sum(inner)} inner "
              f"iterations {inner}, {secs:.3f} s, true relres {rel:.3e}, "
              f"peak {peak:.2f} GiB")
        del X


def main() -> None:
    root = Path(__file__).resolve().parent
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)")
    if not (root / "blockcg_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke.py: no blockcg_tpu_torch/ beside {__file__}; "
                         "run it from a checkout of the repository")
    sys.path.insert(0, str(root))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase_device(torch)
    phase_build()
    records = phase_kernels(torch, dev)

    from blockcg_tpu_torch.ops import _native

    _native.reset_launches()
    phase_config3(torch, dev)  # checks its own six wrappers' counts
    # The kernels' record counts the main path alone: the north-star chain
    # (its qr_passes=2 solve launches mm_update_gram).
    _native.reset_launches()
    phase_north_star(torch, dev)
    counts = dict(_native.launches)
    print(f"[launches] north star: {counts}")
    missing = [w for w in KERNELS if counts.get(w, 0) == 0]
    if missing:
        raise AssertionError(f"the north star never launched the kernels of {missing}")

    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[name], **records[name]}
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
