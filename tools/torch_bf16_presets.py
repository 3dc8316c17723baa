#!/usr/bin/env python3
"""Config 2's bf16 presets on the card: plain BCG, BCGA and BCGdQ on the
bf16 512^2 Laplacian with 16 right-hand sides (tol 1e-6, 2,000 iterations,
as ``bench_cli.py --dtype bf16`` runs them), then ``solve_refined`` with
inner BCG (inner_tol 5e-3, the f64 outer loop, the f32 B). For each plain
solve: iterations, convergence, the monitor every ``--every`` iterations,
the true f64 relres, whether X is finite, and the seconds; for the refined
solve: cycles, matvecs, the true f64 relres and the seconds. One JSON line
per solve.

Run on a machine with a card, from the root of a checkout:

    python3 tools/torch_bf16_presets.py [--root DIR] [--every 200]

``--root`` imports ``blockcg_tpu_torch`` from another checkout (its kernels
build into that checkout's ``build/``), so two versions of the bf16 kernels'
arithmetic compare in one call: run the parent's checkout and this one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

TOL = 1e-6
MAX_ITER = 2000
INNER_TOL = 5e-3


def relres(torch, op, X, B) -> float:
    """max_j ||B e_j - A X e_j|| / ||B e_j|| in f64, or nan for a
    non-finite X."""
    from blockcg_tpu_torch.operators import astype

    if not bool(torch.isfinite(X).all()):
        return float("nan")
    B64 = B.double()
    R = B64 - astype(op, torch.float64).matmat(X.double())
    return float((torch.linalg.vector_norm(R, dim=0)
                  / torch.linalg.vector_norm(B64, dim=0)).max())


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose blockcg_tpu_torch to run")
    ap.add_argument("--every", type=int, default=200,
                    help="print the monitor every this many iterations")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_bf16_presets.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(Path(args.root).resolve()))
    import blockcg_tpu_torch as bt
    from blockcg_tpu_torch.problems import presets

    op, B, meta = presets.config2_bcg_2d_512(dtype=torch.bfloat16, device="cuda")
    for name in ("bcg", "bcga", "bcgdq"):
        solve = getattr(bt, f"solve_{name}")
        (X, info), secs = timed(torch, lambda: solve(op, B, tol=TOL, max_iter=MAX_ITER,
                                                     record_history=True))
        hist = info.history[:int(info.iterations)].tolist()
        print(json.dumps({
            "root": args.root, "config": meta["name"], "solver": name,
            "iterations": int(info.iterations), "converged": bool(info.converged.all()),
            "monitor": float(info.relres.max()), "true_relres": relres(torch, op, X, B.float()),
            "x_finite": bool(torch.isfinite(X).all()), "seconds": secs,
            "monitor_every": {i: hist[i] for i in range(0, len(hist), args.every)}}),
            flush=True)
        del X
    B32 = B.float()
    (X, info), secs = timed(torch, lambda: bt.solve_refined(
        op, B32, tol=TOL, inner_tol=INNER_TOL, inner_solver="bcg"))
    print(json.dumps({
        "root": args.root, "config": meta["name"], "solver": "refined bcg",
        "cycles": int(info.iterations), "matvecs": int(info.matvecs),
        "converged": bool(info.converged.all()), "true_relres": relres(torch, op, X, B32),
        "seconds": secs}), flush=True)


if __name__ == "__main__":
    main()
