#!/usr/bin/env python3
"""Device time of the DIA stencil (rows 1 and 2 of PERF.md's kernel table),
the Gram (row 5) and ``mm_update`` (row 6) from torch.profiler's kernel
records, at the shapes of the north star (32, 128^3) and config 3 (32,
64^3), and ``mm_update`` at config 4's (48, 32^4) and at (96, 32^4).
Beside them, the one PyTorch call that computes the same function, where
there is one (``U @ V.T``, ``M @ B``).

Run on a machine with a card, from the root of a checkout:

    python3 tools/torch_kernel_times.py [--root DIR] [--reps 50] [--library | --sweep]

``--root`` imports ``blockcg_tpu_torch`` from another checkout (its kernels
build there), so two commits compare in one call: parent, change, change,
parent. ``--sweep`` times the stencil of this checkout at each window halo
and tile width that fits in shared memory, marking the one its plan picks.
One JSON line per case: device us per call (all of the call's
kernels, the Gram's second stage included) and host us per call (wall time
of the timed calls over their count, ending in a synchronize). The inputs
come from a fixed seed; L2 is not flushed between calls (the fields are
268-805 MB, far above the 50 MB L2).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path


def device_us(torch, fn, reps: int, tmp: Path) -> float:
    """Device us of all kernels per call of fn."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    trace = tmp / "trace.json"
    prof.export_chrome_trace(str(trace))
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "kernel" and "dur" in e]
    trace.unlink()
    return sum(float(e["dur"]) for e in events) / reps


def host_us(torch, fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / reps


def cases(torch, dev, library: bool):
    """(name, fn) of each timed call; the library calls when ``library``."""
    from blockcg_tpu_torch.ops import fused, stencil
    from blockcg_tpu_torch.problems import laplacian_dia

    gen = torch.Generator(device=dev).manual_seed(0)
    for edge in (128, 64):
        op = laplacian_dia((edge,) * 3, device=dev)
        n = op.n
        X, V = (torch.randn((32, n), generator=gen, device=dev) for _ in range(2))
        M = torch.randn((32, 32), generator=gen, device=dev) / 32 ** 0.5
        what = f"(32, {edge}^3)"
        if library:
            yield f"library U @ V.T {what}", lambda X=X, V=V: X @ V.T
            yield f"library M @ B {what}", lambda M=M, X=X: M @ X
            continue
        yield (f"row 1 stencil_spmm_t {what}",
               lambda op=op, X=X: stencil.stencil_spmm_t(op.diags, op.offsets, X))
        yield (f"row 2 stencil_spmm_gram_t {what}",
               lambda op=op, X=X: stencil.stencil_spmm_gram_t(op.diags, op.offsets, X))
        yield f"row 5 gram {what}", lambda X=X, V=V: fused.gram(X, V)
        yield f"row 6 mm_update {what}", lambda M=M, X=X: fused.mm_update(M, X)
        del op, X, V
    ns = 32 ** 4
    for m in (48, 96):
        B = torch.randn((m, ns), generator=gen, device=dev)
        M = torch.randn((m, m), generator=gen, device=dev) / m ** 0.5
        what = f"({m}, 32^4)"
        if library:
            yield f"library M @ B {what}", lambda M=M, B=B: M @ B
        else:
            yield f"row 6 mm_update {what}", lambda M=M, B=B: fused.mm_update(M, B)
        del B


def sweep_cases(torch, dev):
    """The stencil at (32, 128^3) and (32, 64^3), with and without its Gram,
    launched directly at each (h, T) whose shared memory fits, beside the
    one ``stencil_plan`` picks: how the window's halo and tile width trade
    L2 traffic against blocks per SM."""
    import ctypes

    from blockcg_tpu_torch.ops import _native, stencil
    from blockcg_tpu_torch.problems import laplacian_dia

    cap, sms = _native.max_smem(dev.index), _native.sm_count(dev.index)
    gen = torch.Generator(device=dev).manual_seed(0)
    for edge in (128, 64):
        op = laplacian_dia((edge,) * 3, device=dev)
        n, nd, k = op.n, len(op.offsets), 32
        X = torch.randn((k, n), generator=gen, device=dev)
        Y = torch.empty_like(X)
        offs = (ctypes.c_int * nd)(*(o % n for o in op.offsets))
        for gram in (False, True):
            plan = stencil.stencil_plan(op.offsets, n, k, gram, cap, sms)
            for h in (0, 4, edge):
                for T in (128, 256, 512):
                    nbytes = stencil.smem_bytes(k, nd, h, T, gram)
                    if nbytes > cap:
                        continue
                    mb = min(-(-n // T), _native.MAX_BLOCKS)
                    part = torch.empty((mb, k, k), device=dev) if gram else None
                    G = torch.empty((k, k), device=dev) if gram else None
                    p = _native.ptr
                    mark = " (plan)" if (h, T) == (plan.h, plan.T) else ""
                    yield (f"sweep stencil (32, {edge}^3) gram={gram} h={h} T={T} "
                           f"smem={nbytes}{mark}",
                           lambda op=op, X=X, Y=Y, offs=offs, part=part, G=G, h=h, T=T, mb=mb:
                           _native.launch("sweep", "bcg_stencil_spmm", dev, p(op.diags), offs,
                                          nd, p(X), p(Y), p(part), p(G), k, n, h, T, mb))
        del op, X, Y


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose blockcg_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--library", action="store_true",
                    help="time the PyTorch library calls instead of the port's kernels")
    ap.add_argument("--sweep", action="store_true",
                    help="time the stencil at each halo and tile width that fits")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(Path(args.root).resolve()))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in (sweep_cases(torch, dev) if args.sweep
                         else cases(torch, dev, args.library)):
            for _ in range(3):
                fn()
            print(json.dumps({"root": args.root, "case": name,
                              "device_us": device_us(torch, fn, args.reps, Path(tmp)),
                              "host_us": host_us(torch, fn, args.reps)}), flush=True)


if __name__ == "__main__":
    main()
