#!/usr/bin/env python3
"""Device time of the const-hop slab adds (rows 18-21 of PERF.md's kernel
table) at the shapes ``chip_smoke.py`` times them, from torch.profiler's
kernel records: the time the card spends in a wrapper's launches, free of
the host's launch rate, which the CUDA-event medians of ``chip_smoke.py``
include for kernels this short. Rows 19 and 20 also at m = 96 (config 4
with 24 right-hand sides, ``[wide]``); row 21 also at one right-hand side on
the one-rank crossing of ``dirac_eo(32)``'s parity hop (the even-odd
solve's, ``chip_smoke.py``'s ``[dist]``).

Run on a machine with a card, from the root of a checkout:

    python3 tools/torch_slab_times.py [--root DIR] [--reps 200] [--cold] [--only REGEX]
        [--library]

``--root`` imports ``blockcg_tpu_torch`` from another checkout (its kernels
build there), so two commits compare in one call: parent, change, change,
parent. Rows 20 and 21 are timed where the checkout has them. ``--cold``
writes and reads back a 256 MB scratch before each timed call, outside the
timed kernels (``tools/torch_kernel_times.py`` ``l2_flush``), so the call
finds L2 cold, as a solver's apply does, and counts only the kernels the
call launches (``device_us_cold``, null where the profiler dropped a
record). One JSON line per case: device us per call (all of the call's
kernels), the slab kernel's share, each kernel's records, host us per call
(wall time of the timed calls over their count, ending in a synchronize),
and the sha256 (16 hex digits) of the outputs of one call on fresh copies of
its inputs (Y, and G with the Gram), which a parent and a change share
where their bits agree. ``--library`` times instead the one PyTorch call
that computes rows 18-21 without the Gram or ``vals`` (``chip_smoke.py``'s
yardsticks for rows 19 and 20): ``baddbmm_`` of ``W = H ⊗ I_k`` on strided
views of the wrap slab's blocks (row 18 at one right-hand side: ``W = H``),
``addmm_`` on the halo slab's columns, and for row 21 ``baddbmm_`` of H over
the right-hand sides on the (k, bs, ns) view's halo columns.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_kernel_times import (checksums, cold_us, kernel_events, l2_flush,  # noqa: E402
                                record_counts)

L, K, K_WIDE = 32, 12, 24  # config 4: dirac_cbdia(32), 12 right-hand sides; [wide]: 24
SLAB_KERNELS = ("slab_",)  # the slab kernels of every checkout (a name with "slab_")


def device_us(torch, fn, reps: int, tmp: Path) -> tuple[float, float, dict[str, int]]:
    """(device us of all kernels, of the slab kernel, records of each
    kernel) per call of fn, L2 warm."""
    events = kernel_events(torch, fn, reps, tmp)
    total = sum(d for _, d in events)
    slab = sum(d for name, d in events if any(s in name for s in SLAB_KERNELS))
    return total / reps, slab / reps, record_counts(events)


def host_us(torch, fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / reps


def eo_crossing(torch, dev):
    """(hop, g, nblocks, dst_base, halo width, ns) of the +t crossing of the
    one-rank plan of ``dirac_eo(32)``'s parity hop ``hop_oe``
    (``parallel.partition_cbdia``), as ``chip_smoke.py``'s ``[dist]`` takes
    it."""
    from blockcg_tpu_torch import parallel as par
    from blockcg_tpu_torch.problems import dirac_eo

    eplan = par.partition_cbdia(dirac_eo(L, device=dev).hop_oe, 1)
    ns = L ** 4 // 2
    d, o, g, nb = next(c for c in eplan.crossings if c[1] > 0)
    return torch.tensor(eplan.hops[d], device=dev), g, nb, (ns - o) // g, o, ns


def cases(torch, dev):
    """(name, fn, once) of each slab add: fn in place on its own buffer (the
    timed call), once on a fresh copy of that buffer's first values."""
    from blockcg_tpu_torch.ops import const_block_stencil as cbs
    from blockcg_tpu_torch.problems import dirac_cbdia, dirac_eo

    gen = torch.Generator(device=dev).manual_seed(1)
    op = dirac_cbdia(L, device=dev)
    ns = op.ns
    d, g, nb, mul, off, shift = op.slabs[0]
    bw = L ** 3  # config 4's +t crossing at one rank: 8 blocks of 4096 sites
    gh = min(4096, bw)
    nbh = bw // gh
    dst = (ns - bw) // gh
    hop4 = op.hops_all[1]
    for k in (K, K_WIDE):
        m = op.bs * k
        Xm = torch.randn((m, ns), generator=gen, device=dev)
        Ym = torch.randn((m, ns), generator=gen, device=dev)
        Gm = torch.randn((m, m), generator=gen, device=dev)
        Y0 = Ym.clone()
        slab = (op.hops_all[d], g, nb, mul, off, shift, Xm)
        yield (f"row 19 slab_m_accumulate ({m}, {ns}) g={g} x {nb}",
               lambda slab=slab, Ym=Ym: cbs.slab_m_accumulate(*slab, Ym),
               lambda slab=slab, Y0=Y0: cbs.slab_m_accumulate(*slab, Y0.clone()))
        yield (f"row 19 slab_m_accumulate ({m}, {ns}) g={g} x {nb} with Gram",
               lambda slab=slab, Ym=Ym, Gm=Gm: cbs.slab_m_accumulate(*slab, Ym, Gm,
                                                                      with_gram=True),
               lambda slab=slab, Y0=Y0, Gm=Gm: cbs.slab_m_accumulate(*slab, Y0.clone(), Gm,
                                                                      with_gram=True))
        if k == K:
            eo = dirac_eo(L, device=dev)
            hop = eo.hop_oe
            Xv = torch.randn((1, hop.bs, hop.ns), generator=gen, device=dev)
            Yv = torch.randn((1, hop.bs, hop.ns), generator=gen, device=dev)
            Yv0 = Yv.clone()
            for dv, gv, nbv, mulv, offv, shiftv in hop.slabs[:1]:  # slabs from L = 32
                vslab = (hop.hops_all[dv], gv, nbv, mulv, offv, shiftv, Xv)
                yield (f"row 18 slab_block_accumulate (1, {hop.bs}, {hop.ns}) g={gv} x {nbv}",
                       lambda vslab=vslab: cbs.slab_block_accumulate(*vslab, Yv),
                       lambda vslab=vslab: cbs.slab_block_accumulate(*vslab, Yv0.clone()))
            del eo
        if not hasattr(cbs, "slab_m_accumulate_from"):
            continue
        Src = torch.randn((m, bw), generator=gen, device=dev)
        halo = (hop4, gh, nbh, dst, 0, Src)
        yield (f"row 20 slab_m_accumulate_from ({m}, {bw}) into ({m}, {ns}) g={gh} x {nbh}",
               lambda halo=halo, Ym=Ym: cbs.slab_m_accumulate_from(*halo, Ym),
               lambda halo=halo, Y0=Y0: cbs.slab_m_accumulate_from(*halo, Y0.clone()))
        yield (f"row 20 slab_m_accumulate_from ({m}, {bw}) into ({m}, {ns}) g={gh} x {nbh} "
               "with Gram",
               lambda halo=halo, Ym=Ym, Xm=Xm: cbs.slab_m_accumulate_from(*halo, Ym, Xm,
                                                                           with_gram=True),
               lambda halo=halo, Y0=Y0, Xm=Xm: cbs.slab_m_accumulate_from(
                   *halo, Y0.clone(), Xm, with_gram=True))
        if k == K:
            Srcv = torch.randn((K, op.bs, bw), generator=gen, device=dev)
            Yv4 = Ym.view(K, op.bs, ns)
            yield (f"row 21 slab_block_accumulate_from ({K}, {op.bs}, {bw}) into "
                   f"({K}, {op.bs}, {ns}) g={gh} x {nbh}",
                   lambda Srcv=Srcv, Yv4=Yv4: cbs.slab_block_accumulate_from(
                       hop4, gh, nbh, dst, 0, Srcv, Yv4),
                   lambda Srcv=Srcv: cbs.slab_block_accumulate_from(
                       hop4, gh, nbh, dst, 0, Srcv, Y0.view(K, op.bs, ns).clone()))
            hop1, g1, nb1, dst1, bw1, ns1 = eo_crossing(torch, dev)
            Src1 = torch.randn((1, op.bs, bw1), generator=gen, device=dev)
            Y1 = torch.randn((1, op.bs, ns1), generator=gen, device=dev)
            Y10 = Y1.clone()
            yield (f"row 21 slab_block_accumulate_from (1, {op.bs}, {bw1}) into "
                   f"(1, {op.bs}, {ns1}) g={g1} x {nb1}",
                   lambda: cbs.slab_block_accumulate_from(hop1, g1, nb1, dst1, 0, Src1, Y1),
                   lambda: cbs.slab_block_accumulate_from(hop1, g1, nb1, dst1, 0, Src1,
                                                          Y10.clone()))


def library_cases(torch, dev):
    """(name, fn, once) of the one-call PyTorch equivalents of rows 19 and
    20 without the Gram or ``vals``, at m = 48 and 96, then of rows 18 and
    21 at the shapes ``cases`` times them, in place on their own buffers."""
    from blockcg_tpu_torch.problems import dirac_cbdia, dirac_eo

    gen = torch.Generator(device=dev).manual_seed(1)
    op = dirac_cbdia(L, device=dev)
    ns = op.ns
    d, g, nb, mul, off, shift = op.slabs[0]
    nbk, span = ns // g, mul * (nb - 1)
    src_off = (off + shift) % nbk
    bw, gh = L ** 3, 4096
    cols, d0 = bw, ns - bw
    for k in (K, K_WIDE):
        m = op.bs * k
        X = torch.randn((m, ns), generator=gen, device=dev)
        Y = torch.randn((m, ns), generator=gen, device=dev)
        Src = torch.randn((m, bw), generator=gen, device=dev)
        W = torch.kron(op.hops_all[d], torch.eye(k, device=dev)).expand(nb, m, m)
        W1 = torch.kron(op.hops_all[1], torch.eye(k, device=dev))

        def blocks(F, o, m=m):
            return F.view(m, nbk, g)[:, o:o + span + 1:mul].permute(1, 0, 2)

        yield (f"library row 19 baddbmm_ ({m}, {ns}) g={g} x {nb}",
               lambda Y=Y, X=X, W=W: blocks(Y, off).baddbmm_(W, blocks(X, src_off)),
               lambda Y=Y: Y)
        yield (f"library row 20 addmm_ ({m}, {bw}) into ({m}, {ns}) g={gh} x {bw // gh}",
               lambda Y=Y, Src=Src, W1=W1: Y[:, d0:d0 + cols].addmm_(W1, Src),
               lambda Y=Y: Y)
    # Row 18 at one right-hand side (the even-odd CG's parity hop, its first
    # slab): the merged and the (1, bs, ns) view are one memory, W = H.
    hop = dirac_eo(L, device=dev).hop_oe
    d, g, nb, mul, off, shift = hop.slabs[0]
    nbk, span = hop.ns // g, mul * (nb - 1)
    src_off = (off + shift) % nbk
    X = torch.randn((hop.bs, hop.ns), generator=gen, device=dev)
    Y = torch.randn((hop.bs, hop.ns), generator=gen, device=dev)
    H = hop.hops_all[d].expand(nb, hop.bs, hop.bs)

    def vblocks(F, o, bs=hop.bs):
        return F.view(bs, nbk, g)[:, o:o + span + 1:mul].permute(1, 0, 2)

    yield (f"library row 18 baddbmm_ (1, {hop.bs}, {hop.ns}) g={g} x {nb}",
           lambda: vblocks(Y, off).baddbmm_(H, vblocks(X, src_off)), lambda: Y)
    # Row 21: H over the right-hand sides on the view's halo columns.
    Srcv = torch.randn((K, op.bs, bw), generator=gen, device=dev)
    Yv = torch.randn((K, op.bs, ns), generator=gen, device=dev)
    H4 = op.hops_all[1].expand(K, op.bs, op.bs)
    yield (f"library row 21 baddbmm_ ({K}, {op.bs}, {bw}) into ({K}, {op.bs}, {ns}) "
           f"g={gh} x {bw // gh}",
           lambda: Yv[:, :, d0:d0 + cols].baddbmm_(H4, Srcv), lambda: Yv)
    hop1, g1, nb1, dst1, bw1, ns1 = eo_crossing(torch, dev)
    Src1 = torch.randn((1, op.bs, bw1), generator=gen, device=dev)
    Y1 = torch.randn((1, op.bs, ns1), generator=gen, device=dev)
    e0 = dst1 * g1
    yield (f"library row 21 baddbmm_ (1, {op.bs}, {bw1}) into (1, {op.bs}, {ns1}) "
           f"g={g1} x {nb1}",
           lambda: Y1[:, :, e0:e0 + nb1 * g1].baddbmm_(hop1.expand(1, op.bs, op.bs), Src1),
           lambda: Y1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose blockcg_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--cold", action="store_true",
                    help="also time each call with L2 flushed before it")
    ap.add_argument("--only", default=None,
                    help="time only the cases whose name matches this regular expression")
    ap.add_argument("--library", action="store_true",
                    help="time the one-call PyTorch equivalents of rows 19 and 20 instead")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_slab_times.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(Path(args.root).resolve()))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    flush = l2_flush(torch, dev) if args.cold else None
    with tempfile.TemporaryDirectory() as tmp:
        for name, fn, once in (library_cases if args.library else cases)(torch, dev):
            if args.only and not re.search(args.only, name):
                continue
            sums = checksums(torch, once())
            for _ in range(5):
                fn()
            cold = {}
            if flush is not None:
                us, shares, got, want = cold_us(torch, fn, args.reps, Path(tmp), flush)
                cold = {"device_us_cold": us, "kernels_us_cold": shares, "records_cold": got,
                        "records_expected": want}
            dev_all, dev_slab, records = device_us(torch, fn, args.reps, Path(tmp))
            print(json.dumps({"root": args.root, "case": name, "device_us": dev_all,
                              "slab_kernel_us": dev_slab, "records": records, **cold,
                              "host_us": host_us(torch, fn, args.reps), "checksums": sums}),
                  flush=True)


if __name__ == "__main__":
    main()
