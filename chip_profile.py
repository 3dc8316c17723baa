#!/usr/bin/env python3
"""Where the device time goes in the port's block solves, on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card and
nvcc:

    python3 chip_profile.py

Thirteen single-device solves: config 3 (64^3 Laplacian, k = 32, tol 1e-6, qr_passes=1), the
first inner solve of the north star (128^3 Laplacian, k = 32, the
right-hand sides scaled to unit columns as ``solve_refined`` hands them to
its inner solver, tol 3e-6) at qr_passes 1 and 2, config 4 (the 32^4
lattice-Dirac operator in the const-hop container, k = 12, tol 1e-6,
qr_passes=1), config 2's BCG (512^2 Laplacian, k = 16, tol 1e-6) and the
shifted-block SBCGrQ on config 4 with four shifts (tol 1e-6), and the
matrix-link lattice operator ``dirac_gauged_matrix(32)`` in the per-site
block container (k = 12 from ``default_rng(1234)``, tol 1e-6,
qr_passes=1); the even-odd Schur solve ``solve_dirac_eo`` on ``dirac_eo(32)``
with config 4's 12 RHS (tol 1e-6), ``solve_sbcgrq_cheb`` on config 3 at
degree 6 (tol 1e-6, its spectrum estimated in the warm-up run) and the
general-sparsity SBCGrQ of ``chip_smoke.py``'s [sparse] phase
(``rgg_laplacian(524288, 40)`` through ``from_scipy_auto``, RCM tiles, 32
RHS from ``default_rng(0)``, tol 1e-6, qr_passes=1), and the two solves of
``chip_smoke.py``'s [wide] phase on fields of m = 96 rows: config 4's
SBCGrQ with 24 RHS (tol 1e-6, qr_passes=1) and ``solve_dirac_eo_shifted``
on ``dirac_eo(32)`` with config 4's 12 RHS and four shifts; one inner solve
of config 5's lean route at full size (the 256^3 Laplacian in bf16, the
first 32-column slice of the first cycle's right-hand sides: B from
``lean_rhs(0, 64, ...)`` scaled to unit columns, bf16 SBCGrQ to tol 5e-3,
qr_passes=1, as ``solve_refined_lean`` runs it); then the
distributed layer on one rank (NCCL, a group of one): config 3, the
north-star inner solve, config 4 and the even-odd solve through
``parallel``, and CG on config 3's column 0 beside the single-device CG,
with a line of the layer's primitives (host wall time of one k x k
``all_reduce``, alone and behind queued device work, and of one halo
exchange at config 4's shape; device time of the one-rank config-4 apply
with its Gram beside the operator's) and one of the Dist solves' bare ms
with the all-reduce replaced by the identity. Each solve
runs once to warm up, once bare (wall clock ending
in ``torch.cuda.synchronize()``: "bare ms"), and once under
``torch.profiler`` with CUDA activity only. From the trace's device events
it reports:

- ``kernels_per_iteration``: CUDA kernels launched / iterations;
- ``busy_ms``: the union of the intervals of every kernel, memcpy and memset;
  ``port_ms``: the same union over the port's own kernels (``csrc/*.cu``);
- ``idle_share``: 1 - busy / span, the span running from the first device
  event's start to the last one's end. The profiler stretches the host side,
  so this bounds the bare run's idle share from above;
- ``top``: device ms and calls of the busiest kernels, by name.

It prints the card's name and power limit, then one JSON line per solve and
one of the primitives. It imports neither JAX nor the reference package, and
fails without a card.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

K = 32
SHIFTS = (0.0, 0.05, 0.5, 2.0)
TOP = 12
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PORT_KERNEL = re.compile(r"\b(stencil_spmm|mm_update_kernel|coeff_update|px_update|gram_kernel"
                         r"|mm2_update_gram_kernel|update_gram_kernel|px_update_kernel|tiled_spmm"
                         r"|reduce_partials|reduce_partials_f64|cbs_spmm|cm_spmm|slab_stream"
                         r"|xr_update_gram|qr_p_update|qr_px_update|bs_spmm|xr_update_gram_kernel"
                         r"|cheb_step_vec|cheb_step_scalar|reduce_spin_contract)\b")


def union_ms(intervals) -> float:
    """Length in ms of the union of (start, end) intervals given in us."""
    total, reach = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > reach:
            total += e - max(s, reach)
            reach = e
    return total / 1e3


def summarize(events, iterations: int) -> dict:
    """Device-time summary of a Chrome trace's events (see the docstring)."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not dev:
        raise RuntimeError("the profiler recorded no device events")
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    per_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        per_name[e["name"]][0] += float(e["dur"]) / 1e3
        per_name[e["name"]][1] += 1
    span = (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3
    busy = union_ms(spans)
    port = union_ms([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in kernels if PORT_KERNEL.search(e["name"])])
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {"iterations": iterations,
            "kernels_per_iteration": len(kernels) / max(iterations, 1),
            "busy_ms": busy, "port_ms": port, "span_ms": span,
            "idle_share": 1.0 - busy / span if span > 0 else 0.0,
            "top": [[name[:100], ms, calls] for name, (ms, calls) in top]}


def profile_solve(torch, name, run, tmp: Path) -> dict:
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, info = run()
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, info_p = run()
        torch.cuda.synchronize()
    trace = tmp / f"{name}.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    if info_p.iterations != info.iterations:
        raise AssertionError(f"{name}: profiled solve took {info_p.iterations} "
                             f"iterations, the bare one {info.iterations}")
    if not bool(info.converged.all()):
        raise AssertionError(f"{name} did not converge: {info}")
    return {"solve": name, "bare_ms": bare_ms, **summarize(events, info.iterations)}


def nccl_group(torch):
    """A process group of one rank on cuda:0 over NCCL, at a free local
    port."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    return dist.group.WORLD


def dist_primitives(torch, group, op4, dop4, B4, reps: int = 200) -> dict:
    """Host wall time (us) of one k x k all_reduce and one halo exchange at
    config 4's merged (48, 32^4) field, and the device time (ms, CUDA
    events) of the one-rank apply with its Gram beside the operator's."""
    from blockcg_tpu_torch.parallel import start_ring_halos
    from blockcg_tpu_torch.solvers.common import allreduce_if

    def host_us(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6

    def device_ms(fn):
        fn()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(20):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / 20

    def behind_work_us():
        """Host time of one all_reduce issued right behind ~10 ms of queued
        device work: about that work's time if the call waits for it."""
        A = torch.randn((6144, 6144), device=B4.device)
        torch.cuda.synchronize()
        A @ A
        t0 = time.perf_counter()
        allreduce_if(G, group)
        t = (time.perf_counter() - t0) * 1e6
        torch.cuda.synchronize()
        return t

    G = torch.randn((12, 12), device=B4.device)
    Xm = dop4.shard_field(B4.T)
    return {"dist_primitives": {
        "allreduce_12x12_us": host_us(lambda: allreduce_if(G, group)),
        "allreduce_behind_device_work_us": behind_work_us(),
        "halo_exchange_us": host_us(lambda: start_ring_halos(Xm, dop4.bw, group).wait()),
        "config4_apply_gram_ms": device_ms(lambda: op4.matmat_gram_t(Xm)),
        "dist_config4_apply_gram_ms": device_ms(lambda: dop4.matmat_gram_t(Xm)),
        "config4_apply_gram_host_us": host_us(lambda: op4.matmat_gram_t(Xm)),
        "dist_config4_apply_gram_host_us": host_us(lambda: dop4.matmat_gram_t(Xm))}}


def bare_without_allreduce(torch, run) -> float:
    """Bare ms of a one-rank Dist solve with the solvers' k x k all_reduce
    replaced by the identity (on one rank the sum has one term): what the
    collectives cost, against its bare ms with them."""
    from blockcg_tpu_torch.solvers import common

    kept = common.allreduce_if
    common.allreduce_if = lambda x, group: x
    try:
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3
    finally:
        common.allreduce_if = kept


def main() -> None:
    root = Path(__file__).resolve().parent
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_profile.py: no CUDA device (torch.cuda.is_available() is False)")
    if not (root / "blockcg_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_profile.py: no blockcg_tpu_torch/ beside {__file__}; "
                         "run it from a checkout of the repository")
    sys.path.insert(0, str(root))
    from blockcg_tpu_torch import parallel as par
    from blockcg_tpu_torch import (
        solve_bcg,
        solve_cg,
        solve_sbcgrq,
        solve_sbcgrq_cheb,
        solve_shifted_sbcgrq,
    )
    from blockcg_tpu_torch.problems import (
        config2_bcg_2d_512,
        config3_sbcgrq_3d_64,
        config4_dirac_32,
        dirac_eo,
        dirac_gauged_matrix,
        laplacian_dia,
        rgg_laplacian,
        solve_dirac_eo,
        solve_dirac_eo_dist,
        solve_dirac_eo_shifted,
    )
    from blockcg_tpu_torch.operators import from_scipy_auto
    from blockcg_tpu_torch.problems.presets import _rhs
    from blockcg_tpu_torch.solvers.refine import lean_rhs

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    print(f"torch={torch.__version__} cuda={torch.version.cuda}")

    op3, B3, _ = config3_sbcgrq_3d_64(device=dev)
    op = laplacian_dia((128, 128, 128), device=dev)
    B = _rhs(op.n, K, torch.float64, device=dev)
    R = (B / torch.linalg.vector_norm(B, dim=0)).float()
    del B
    op4, B4, _ = config4_dirac_32(device=dev)
    B24 = _rhs(op4.n, 24, torch.float32, device=dev)  # [wide]: m = 96
    op2, B2, _ = config2_bcg_2d_512(device=dev)
    opm = dirac_gauged_matrix(32, m=0.5, device=dev)
    Bm = torch.as_tensor(np.random.default_rng(1234).standard_normal((12, opm.n)),
                         dtype=torch.float32, device=dev).T.contiguous()
    eo = dirac_eo(32, device=dev)
    ops = from_scipy_auto(rgg_laplacian(524288, degree=40, seed=0), torch.float32, device=dev)
    Bs = ops.to_solver_order(torch.as_tensor(
        np.random.default_rng(0).standard_normal((524288, K)), dtype=torch.float32, device=dev))
    op5 = laplacian_dia((256, 256, 256), dtype=torch.bfloat16, device=dev)
    B5 = lean_rhs(0, 64, op5.n, torch.bfloat16, dev)[:K].float()
    R5 = (B5 / torch.linalg.vector_norm(B5, dim=1, keepdim=True)).bfloat16().T
    del B5
    solves = [
        ("config3 qr_passes=1", lambda: solve_sbcgrq(op3, B3, tol=1e-6, qr_passes=1)),
        ("north-star inner 128^3 qr_passes=1",
         lambda: solve_sbcgrq(op, R, tol=3e-6, max_iter=2000, qr_passes=1)),
        ("north-star inner 128^3 qr_passes=2",
         lambda: solve_sbcgrq(op, R, tol=3e-6, max_iter=2000, qr_passes=2)),
        ("config4 dirac_32 qr_passes=1", lambda: solve_sbcgrq(op4, B4, tol=1e-6, qr_passes=1)),
        ("config2 bcg_2d_512 solve_bcg", lambda: solve_bcg(op2, B2, tol=1e-6, max_iter=5000)),
        (f"config4 dirac_32 solve_shifted_sbcgrq shifts {SHIFTS}",
         lambda: solve_shifted_sbcgrq(op4, B4, SHIFTS, tol=1e-6)),
        ("matrix link dirac_gauged_matrix(32) k=12 qr_passes=1",
         lambda: solve_sbcgrq(opm, Bm, tol=1e-6, qr_passes=1)),
        ("even-odd dirac_eo(32) k=12 solve_dirac_eo", lambda: solve_dirac_eo(eo, B4, tol=1e-6)),
        ("config3 solve_sbcgrq_cheb degree 6",
         lambda: solve_sbcgrq_cheb(op3, B3, degree=6, tol=1e-6)),
        ("sparse rgg_laplacian(524288, 40) RCM tiles k=32 qr_passes=1",
         lambda: solve_sbcgrq(ops, Bs, tol=1e-6, qr_passes=1)),
        ("[wide] config4 dirac_32 k=24 qr_passes=1",
         lambda: solve_sbcgrq(op4, B24, tol=1e-6, qr_passes=1)),
        (f"[wide] even-odd dirac_eo(32) k=12 solve_dirac_eo_shifted shifts {SHIFTS}",
         lambda: solve_dirac_eo_shifted(eo, B4, SHIFTS, tol=1e-6)),
        ("config5 lean inner 256^3 bf16 k=32 tol 5e-3 qr_passes=1",
         lambda: solve_sbcgrq(op5, R5, tol=5e-3, max_iter=2000, qr_passes=1)),
    ]
    group = nccl_group(torch)
    dop3, dop, dop4 = (par.partition_dia(op3, 1).shard(0, group, dev),
                       par.partition_dia(op, 1).shard(0, group, dev),
                       par.partition_cbdia(op4, 1).shard(0, group, dev))
    b3 = B3[:, 0].contiguous()
    solves += [
        ("dist config3 qr_passes=1",
         lambda: par.solve_sbcgrq_dist(dop3, B3, group, tol=1e-6)),
        ("dist north-star inner 128^3 qr_passes=1",
         lambda: par.solve_sbcgrq_dist(dop, R, group, tol=3e-6, max_iter=2000)),
        ("dist config4 dirac_32 qr_passes=1",
         lambda: par.solve_sbcgrq_dist(dop4, B4, group, tol=1e-6)),
        ("dist even-odd dirac_eo(32) k=12 solve_dirac_eo_dist",
         lambda: solve_dirac_eo_dist(eo, B4, group, tol=1e-6)),
        ("config3 solve_cg column 0", lambda: solve_cg(op3, b3, tol=1e-6)),
        ("dist config3 solve_cg_dist column 0",
         lambda: par.solve_cg_dist(dop3, b3, group, tol=1e-6)),
    ]
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, run in solves:
                print(json.dumps(profile_solve(torch, name, run, Path(tmp))), flush=True)
        print(json.dumps(dist_primitives(torch, group, op4, dop4, B4)), flush=True)
        print(json.dumps({"bare_ms_without_allreduce": {
            name: bare_without_allreduce(torch, run)
            for name, run in solves if name.startswith("dist")}}), flush=True)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
