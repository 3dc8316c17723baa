#!/usr/bin/env python3
"""Device time of the const-hop slab adds (rows 18-21 of PERF.md's kernel
table) at the shapes ``chip_smoke.py`` times them, from torch.profiler's
kernel records: the time the card spends in a wrapper's launches, free of
the host's launch rate, which the CUDA-event medians of ``chip_smoke.py``
include for kernels this short.

Run on a machine with a card, from the root of a checkout:

    python3 tools/torch_slab_times.py [--root DIR] [--reps 200]

``--root`` imports ``blockcg_tpu_torch`` from another checkout (its kernels
build there), so two commits compare in one call: parent, change, change,
parent. Rows 20 and 21 are timed where the checkout has them. One JSON line
per case: device us per call (all of the call's kernels), the slab kernel's
share, and host us per call (wall time of the timed calls over their
count, ending in a synchronize).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

L, K = 32, 12  # config 4: dirac_cbdia(32), 12 right-hand sides


def device_us(torch, fn, reps: int, tmp: Path) -> tuple[float, float]:
    """(device us of all kernels, of the slab kernel) per call of fn."""
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
    total = sum(float(e["dur"]) for e in events)
    slab = sum(float(e["dur"]) for e in events if "slab_accumulate" in e["name"])
    return total / reps, slab / reps


def host_us(torch, fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / reps


def cases(torch, dev):
    """(name, fn) of each slab add, in place on its own buffer."""
    from blockcg_tpu_torch.ops import const_block_stencil as cbs
    from blockcg_tpu_torch.problems import dirac_cbdia, dirac_eo

    gen = torch.Generator(device=dev).manual_seed(1)
    op = dirac_cbdia(L, device=dev)
    m, ns = op.bs * K, op.ns
    Xm = torch.randn((m, ns), generator=gen, device=dev)
    Ym = torch.randn((m, ns), generator=gen, device=dev)
    Gm = torch.randn((m, m), generator=gen, device=dev)
    d, g, nb, mul, off, shift = op.slabs[0]
    slab = (op.hops_all[d], g, nb, mul, off, shift, Xm)
    yield (f"row 19 slab_m_accumulate ({m}, {ns}) g={g} x {nb}",
           lambda: cbs.slab_m_accumulate(*slab, Ym))
    yield (f"row 19 slab_m_accumulate ({m}, {ns}) g={g} x {nb} with Gram",
           lambda: cbs.slab_m_accumulate(*slab, Ym, Gm, with_gram=True))
    eo = dirac_eo(L, device=dev)
    hop = eo.hop_oe
    Xv = torch.randn((1, hop.bs, hop.ns), generator=gen, device=dev)
    Yv = torch.randn((1, hop.bs, hop.ns), generator=gen, device=dev)
    for d, g, nb, mul, off, shift in hop.slabs[:1]:  # dirac_eo(L) has slabs from L = 32
        vslab = (hop.hops_all[d], g, nb, mul, off, shift, Xv)
        yield (f"row 18 slab_block_accumulate (1, {hop.bs}, {hop.ns}) g={g} x {nb}",
               lambda: cbs.slab_block_accumulate(*vslab, Yv))
    if not hasattr(cbs, "slab_m_accumulate_from"):
        return
    # Config 4's +t crossing at one rank: 8 blocks of 4096 sites from the
    # (m, 32^3) halo into the field's last 8 blocks.
    bw = L ** 3
    g = min(4096, bw)
    nb = bw // g
    Src = torch.randn((m, bw), generator=gen, device=dev)
    hop4 = op.hops_all[1]
    dst = (ns - bw) // g
    yield (f"row 20 slab_m_accumulate_from ({m}, {bw}) into ({m}, {ns}) g={g} x {nb}",
           lambda: cbs.slab_m_accumulate_from(hop4, g, nb, dst, 0, Src, Ym))
    yield (f"row 20 slab_m_accumulate_from ({m}, {bw}) into ({m}, {ns}) g={g} x {nb} "
           "with Gram",
           lambda: cbs.slab_m_accumulate_from(hop4, g, nb, dst, 0, Src, Ym, Xm, with_gram=True))
    Srcv = torch.randn((K, op.bs, bw), generator=gen, device=dev)
    Yv4 = Ym.view(K, op.bs, ns)
    yield (f"row 21 slab_block_accumulate_from ({K}, {op.bs}, {bw}) into ({K}, {op.bs}, {ns}) "
           f"g={g} x {nb}",
           lambda: cbs.slab_block_accumulate_from(hop4, g, nb, dst, 0, Srcv, Yv4))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose blockcg_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_slab_times.py: no CUDA device")
    sys.path.insert(0, str(Path(args.root).resolve()))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn in cases(torch, dev):
            for _ in range(5):
                fn()
            dev_all, dev_slab = device_us(torch, fn, args.reps, Path(tmp))
            print(json.dumps({"root": args.root, "case": name, "device_us": dev_all,
                              "slab_kernel_us": dev_slab,
                              "host_us": host_us(torch, fn, args.reps)}), flush=True)


if __name__ == "__main__":
    main()
