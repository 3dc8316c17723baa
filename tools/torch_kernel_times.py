#!/usr/bin/env python3
"""Device time of the DIA stencil (rows 1 and 2 of PERF.md's kernel table),
the Gram (row 5), ``mm_update`` (row 6), ``mm_update_gram`` (row 7, with and
without A), ``mm2_update_gram`` (row 8) and ``px_update`` (row 9) from
torch.profiler's kernel records, at the shapes of the north star (32, 128^3)
and config 3 (32, 64^3), rows 5-9 at config 4's (48, 32^4) and at (96,
32^4) (row 5 also with U is V, and a rectangular 64 x 32 block of one
launch), rows 6 and 7 (with and without A) at (400, 2^16) and (800, 2^16),
rows 8 and 9 at (800, 2^16); then the per-site block stencil (rows 22, 23,
23b) on ``dirac_gauged_matrix(32)`` at k = 12 (the (12, 4, 32^4) view, the
merged (48, 32^4) field, with its Gram) and on the realified complex core
(bs = 8, k = 6; about 40 s of host build for the two operators); then
``tiled_spmm_t`` (row 25) on the [sparse] tiles (``rgg_laplacian(524288,
40)`` through ``from_scipy_auto``, about 10 s of host build) at k = 32 with
f32 and bf16 tiles and at k = 96. Beside them, the one PyTorch call that
computes the same function, where there is one (``U @ V.T``, ``M @ B``,
torch's BSR product).

Run on a machine with a card, from the root of a checkout:

    python3 tools/torch_kernel_times.py [--root DIR] [--reps 50] [--only REGEX]
        [--const-hop | --bf16 | --short | --storage | --updates]
        [--library | --sweep | --variants]

``--bf16`` times the bf16 variants of rows 1, 2 and 5-9 (config 5's
capacity route) at its inner shape, (32, 256^3), on the bf16 7-point
operator, each beside its f32 kernel on the same values in f32, with the
bound of each (bf16 fields 2 bytes an element, their FLOPs at the bf16
tensor-core rate, 989 TFLOP/s; the stencil's Gram X Y^T counted as 2 k^2
FLOPs a column, it is not symmetric). With ``--variants`` it times the
tensor-core kernels of rows 5 and 6 (``gram`` with U != V and U is V,
``mm_update`` without and with A) at that shape on each column tile and
ring depth that fits, marking the ones their plans (``gram_plan``,
``mm_update_mma_plan``) pick; then the tensor-core kernels of rows 2, 7, 8
and 9: the stencil on each window halo (8 or 256) and tile that fits, rows
7, 8 and 9 on each column tile and ring depth (``stencil_mma_plan``,
``update_gram_mma_plan``, ``px_update_mma_plan`` marked), the stencil's
probe builds with parts switched off (far X, the Gram, the stores of Y,
the window's refills), and those of row 2w, the bf16 stencil's Gram above
64 rows in column blocks at (96, 128^3) (the Gram, the SpMM, the centre
copy or its wait, the refills). ``--bf16`` also times row 2w at (96,
128^3) on bf16 and on f32 diagonals. ``--short`` times rows 10 and 10b
(``xr_update_gram`` at (16, 512^2) in f32 and bf16, and in bf16 at (48,
32^4)) and row 14 (``const_block_stencil_spmm_t`` on ``dirac_eo(32)``'s
parity hop at one RHS, and on config 4's (12, 4, 32^4) view beside row 16,
the merged launch on the same field): the rows whose event medians in
``chip_smoke.py`` time the host; with ``--variants``, row 14 on pins of its
plan (tiles, halos, grids) and in probe builds that load one, two or four
far diagonals together. Their fields (67 MB in f32 and 34 MB in bf16 at (16,
512^2), 40 MB at row 14's) fit in the H100's 50 MB L2 or come near it, so
``--short`` also times each call with L2 flushed: before each call it
writes a 256 MB scratch buffer and reads it back (the read writes back the
scratch's dirty lines there, not during the call), outside the timed
kernels, and counts only the kernels whose names the call launches
(``device_us_cold``, beside the warm ``device_us``, with each kernel's
share in ``kernels_us_cold``). ``--storage`` times rows 1m, 2m and 2 (the
DIA stencil on bf16 or f32 diagonals and an f32 field, without and with its
Gram) at (32, 128^3) and rows 22h, 23h and 23 (the per-site block stencil,
bf16 blocks on either view and f32 blocks merged) on
``dirac_gauged_matrix(32)`` at k = 12, the ``[storage]`` shapes of
``chip_smoke.py``, the same way, beside rows 1x (f32 diagonals, a bf16
field, (32, 128^3)), 1b (bf16, (32, 256^3)), row 2 at (32, 64^3), (64,
256^3), (64, 128^3) and (64, 64^3) and row 2m at (64, 256^3) (first a line
each of row 2's Gram distance from its f64 contract and Y's checksum at
(64, 64^3) and (64, 128^3) on the on-card test's X), and the folded rows
24f (f32 and bf16 blocks) and 24fg (the fused Gram, and the apply followed
by ``gram``), each line with its launches' plans; with ``--variants``, row
2 at 64 rows on ``stencil_vec_gram`` built with each flush interval
(``VEC_GRAM_FLUSHES``, probe builds, with the same distances), row 2 at
(32, 256^3) on each (h, T) of ``stencil_mma_f32`` and the routes its plan
could take at 32 rows (one fused launch, the SpMM and ``gram``), the
plans' tiles, halos and ring depths of
``stencil_mma_f32`` and ``bs_tma`` and their probe builds with parts
switched off. Every case prints the profiler's records of
each kernel over its calls (``records``; ``records_cold`` beside
``records_expected``, reps times one call's): where the cold count is not
the expected one, ``device_us_cold`` is null.

``--updates`` times ``csrc/px_update.cu``'s rows with L2 flushed, as
``--short`` does: row 13 (``qr_px_update``, f32) at (32, 2^21) and (96,
32^4), row 13b (bf16) at (48, 32^4) and at 16, 32, 64 and 96 rows of 32^4,
beside rows 9 (f32, (32, 2^21)), 9b (bf16, (32, 256^3)), 12 and 12b
(``qr_p_update``, (48, 32^4)), which share its templates; with
``--variants``, rows 13b and 9b at 32, 48 and 64 rows of 32^4 on every
column tile and ring depth of ``px_update_mma`` that fits. ``--storage``
also times rows 1 (f32 diagonals and field) and 1m on their routes at the
main path's other widths and operators (1, 4, 8, 32 and 64 rows of 128^3,
(32, 64^3), (4, 128^2), (16, 512^2)) and at (32, 256^3), and, where the
route is the ring, on the window kernel too (``variant row 1 window``:
``bcg_stencil_spmm`` launched on ``stencil_plan``'s plan), each line with
its plan.

``--const-hop`` times rows 12, 16 and 17 alone: ``qr_p_update`` at (48,
32^4) and (96, 32^4), fresh and donated, and the merged const-hop stencil
without and with its Gram on ``dirac_cbdia(32)``'s main diagonals at k = 12
and 24, each with its bound, checksums and plan (its ``--only 'row 12'``
also runs on checkouts back to the first port of ``qr_p_update``); with
``--variants`` it times ``const_block_stencil_plan``'s pins and tiles,
probe builds with the window copies or the far loads off or other counts of
far loads in flight together, the z-plane ring (a probe: a slice of
1,024-site planes a block, only +-32,768 from L2; alone and with ``gram``),
and row 12 at twice its plan's stage depth.

``--root`` imports ``blockcg_tpu_torch`` from another checkout (its kernels
build there), so two commits compare in one call: parent, change, change,
parent. ``--sweep`` times the stencil of this checkout at each window halo
and tile width that fits in shared memory, marking the one its plan picks.
``--variants`` times row 8 beside other builds of its kernel (without the
Gram; one or three blocks an SM; other stage depths), row 9 at other stage
depths, row 7 on fields wider than 128 rows beside other row chunks, row 5
at (32, 128^3) and (96, 32^4) on other column tiles and in probe builds (4x4
register tiles at two blocks an SM; a ring of three tiles), rows 23 and 23b
on ``dirac_gauged_matrix(32)`` at k = 12 on other schedules of
``block_stencil_plan`` (no window or the plan's; one, two, four or eight
groups of right-hand sides, which set the tile of 256 / groups sites; two,
three or four stages), each named by its plan, and row 23 in probe builds
with parts of the kernel switched off or other counts of producer warps, and
row 25 on the [sparse] tiles at other slice widths, ring depths and register
tiles (``tiled_plan``'s keywords).
``--only REGEX`` keeps the cases whose name matches. One JSON line per
case: device us per call (all of the call's kernels, the Gram's second
stage included), host us per call (wall time of the timed calls over their
count, ending in a synchronize), the least time the work could take
(``bound_us``: rows 5-9, 12, 16, 17, 22-23b; max of the bytes over 3.35 TB/s and the
FLOPs over 67 TFLOP/s, a symmetric Gram counted as its upper triangle) and a
checksum of the bytes of each of the call's outputs, so two checkouts show
whether a kernel kept its bits. The inputs come from a fixed seed. L2 is
flushed before each call only with ``--short`` and ``--storage``; the other
cases' fields are 268-805 MB, far above the 50 MB L2, but for the rows 5-9
cases at (32, 64^3) (34-42 MB) and (400 or 800, 2^16) (105-210 MB), which
are partly warm.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import inspect
import os
from itertools import chain
import json
import re
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SENTINEL = "spin_kernel"  # the kernel of torch.cuda._sleep


def kernel_events(torch, fn, reps: int, tmp: Path, flush=None) -> list[tuple[str, float]]:
    """(name, device us) of every kernel record of reps calls of fn, with
    flush() before each call when given. The profiler has returned sessions
    without the record of their first kernel (on an H100, every session of
    the block stencil's calls at 32^4), so a sentinel launch goes first,
    ``torch.cuda._sleep``, whose records are left out."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    trace = tmp / "trace.json"
    prof.export_chrome_trace(str(trace))
    events = [(e["name"], float(e["dur"])) for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "kernel" and "dur" in e and SENTINEL not in e["name"]]
    trace.unlink()
    return events


def record_counts(events) -> dict[str, int]:
    """Records of each kernel (``kernel_label`` of its name) among events."""
    counts: dict[str, int] = {}
    for name, _ in events:
        counts[kernel_label(name)] = counts.get(kernel_label(name), 0) + 1
    return counts


def device_us(torch, fn, reps: int, tmp: Path) -> tuple[float, dict[str, int]]:
    """(device us of all kernels per call of fn, records of each kernel over
    the reps calls)."""
    events = kernel_events(torch, fn, reps, tmp)
    return sum(d for _, d in events) / reps, record_counts(events)


FLUSH_BYTES = 256 * 2 ** 20  # the scratch written (and read back) before a cold call


def l2_flush(torch, dev):
    """A function that evicts a call's data from L2: it writes a 256 MB
    scratch buffer, then reads it back, so the scratch's dirty lines are
    written back then and not during the timed call."""
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def flush():
        scratch.fill_(1.0)
        scratch.sum()
    return flush


def kernel_label(name: str) -> str:
    """A profiler kernel name without its arguments and namespaces."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    head = name.split("(")[0]
    return name[:name.index(">") + 1] if "<" in head else head


def cold_us(torch, fn, reps: int, tmp: Path, flush):
    """(device us per call of fn with L2 flushed before each call, us per
    call of each of its kernels, records of each kernel, records expected).
    Only kernels named in one call without the flush count, and reps times
    that call's records are expected: where the profiler returned another
    number (a record dropped, or an extra launch), the time is None and the
    counts tell which kernel."""
    alone = kernel_events(torch, fn, 1, tmp)
    own = {name for name, _ in alone}
    want = {n: c * reps for n, c in record_counts(alone).items()}
    events = [(n, d) for n, d in kernel_events(torch, fn, reps, tmp, flush) if n in own]
    got = record_counts(events)
    shares: dict[str, float] = {}
    for n, d in events:
        shares[kernel_label(n)] = shares.get(kernel_label(n), 0.0) + d / reps
    us = sum(d for _, d in events) / reps if want and got == want else None
    return us, shares, got, want


def host_us(torch, fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / reps


def checksums(torch, out) -> list[str]:
    """sha256 (first 16 hex digits) of the bytes of each of a call's output
    tensors, in order."""
    def raw(t):  # numpy has no bf16: hash its bits as int16
        t = t.detach().contiguous().cpu()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()

    return [hashlib.sha256(raw(t)).hexdigest()[:16]
            for t in (out if isinstance(out, tuple) else (out,)) if isinstance(t, torch.Tensor)]


def cases(torch, dev, library: bool):
    """(name, fn) of each timed call; the library calls when ``library``."""
    from blockcg_tpu_torch.ops import fused, stencil
    from blockcg_tpu_torch.problems import laplacian_dia

    gen = torch.Generator(device=dev).manual_seed(0)
    for edge in (128, 64):
        op = laplacian_dia((edge,) * 3, device=dev)
        n = op.n
        X, V, Z = (torch.randn((32, n), generator=gen, device=dev) for _ in range(3))
        M, M2, M3 = (torch.randn((32, 32), generator=gen, device=dev) / 32 ** 0.5
                     for _ in range(3))
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
        yield from row7(fused, what, M, X, V)
        yield from rows89(fused, what, M, M2, M3, X, V, Z)
        del op, X, V, Z
    ns = 32 ** 4
    for m in (48, 96):
        B, V, Z = (torch.randn((m, ns), generator=gen, device=dev) for _ in range(3))
        M, M2, M3 = (torch.randn((m, m), generator=gen, device=dev) / m ** 0.5
                     for _ in range(3))
        what = f"({m}, 32^4)"
        if library:
            yield f"library M @ B {what}", lambda M=M, B=B: M @ B
            yield f"library U @ V.T {what}", lambda B=B, V=V: B @ V.T
            if m == 96:
                yield f"library U @ U.T {what}", lambda B=B: B @ B.T
                yield f"library U @ V.T 64 x 32 {what}", lambda B=B, V=V: B[:64] @ V[:32].T
        else:
            yield f"row 5 gram {what}", lambda B=B, V=V: fused.gram(B, V)
            if m == 96:
                yield f"row 5 gram U is V {what}", lambda B=B: fused.gram(B, B)
                yield (f"row 5 gram 64 x 32 {what}",
                       lambda B=B, V=V: fused._launch_gram(B[:64], V[:32]))
            yield f"row 6 mm_update {what}", lambda M=M, B=B: fused.mm_update(M, B)
            yield from row7(fused, what, M, B, V)
            yield from rows89(fused, what, M, M2, M3, B, V, Z)
        del B, V, Z
    if not library:  # fields too wide for one launch: row chunks, the Gram from gram
        n = 1 << 16
        for k in (400, 800):
            W, P, X = (torch.randn((k, n), generator=gen, device=dev) for _ in range(3))
            M, M2, M3 = (torch.randn((k, k), generator=gen, device=dev) / k ** 0.5
                         for _ in range(3))
            what = f"({k}, 2^16)"
            yield f"row 6 mm_update {what}", lambda M=M, W=W: fused.mm_update(M, W)
            yield f"row 6 mm_update +A {what}", lambda M=M, W=W, X=X: fused.mm_update(M, W, X)
            yield from row7(fused, what, M, W, P)
            if k == 800:
                yield from rows89(fused, what, M, M2, M3, W, P, X)
            del W, P, X
    yield from block_stencil_cases(torch, dev, library)
    yield from row25(torch, dev, library)


def cbs_work(op, k: int, gram: bool) -> float:
    """bound_us of a merged const-hop apply of k right-hand sides (rows 16,
    17) on the operator's main diagonals: the hops and the mask rows read
    once, X read and Y written once (and G written); 2 k FLOPs per
    structural nonzero of the main diagonals (a hop's nonzeros times the
    sites its mask keeps), plus 2 m^2 a site for G = X Y^T (not symmetric)."""
    import torch

    m, ns = op.bs * k, op.ns
    nbytes = 4 * (op.hops_main.numel() + (0 if op.masks_main is None else op.masks_main.numel())
                  + 2 * m * ns + gram * m * m)
    nnz = 0
    for d, slot in enumerate(op.main_slots):
        sites = ns if slot < 0 else int(torch.count_nonzero(op.masks_main[slot]))
        nnz += int(torch.count_nonzero(op.hops_main[d])) * sites
    flops = 2 * k * nnz + gram * 2 * m * m * ns
    return max(nbytes / 3.35e12, flops / 67e12) * 1e6


def const_hop_cases(torch, dev, only: str | None):
    """Row 12 (``qr_p_update``) at (48, 32^4) and (96, 32^4), fresh and
    donated (M2 orthogonal, rho small, so the donated calls' repeated updates
    stay bounded), then rows 16 and 17 (the merged const-hop stencil without
    and with its Gram) on ``dirac_cbdia(32)``'s main diagonals at k = 12 and
    24 (m = 48 and 96). The operator is built only when a row 16/17 case is
    wanted, so ``--only 'row 12'`` also times checkouts older than its
    attributes (the slowdown bisect)."""
    from blockcg_tpu_torch.ops import fused

    def wanted(name):
        return not only or re.search(only, name)

    gen = torch.Generator(device=dev).manual_seed(12)
    ns = 32 ** 4
    for m in (48, 96):
        names = [f"row 12 qr_p_update{d} ({m}, 32^4)" for d in ("", " donated")]
        if not any(map(wanted, names)):
            continue
        M2 = torch.linalg.qr(torch.randn((m, m), generator=gen, device=dev))[0].contiguous()
        rho = 0.1 * torch.randn((m, m), generator=gen, device=dev) / m ** 0.5
        Q1, P = (torch.randn((m, ns), generator=gen, device=dev) for _ in range(2))
        Qd, Pd = Q1.clone(), P.clone()
        nbytes = 4 * (4 * m * ns + 2 * m * m)
        bound = max(nbytes / 3.35e12, 4 * m * m * ns / 67e12) * 1e6
        planner = getattr(fused, "qr_p_update_plan", None)
        desc = None if planner is None else str(planner(m, dev))
        yield (names[0], lambda M2=M2, Q1=Q1, rho=rho, P=P: fused.qr_p_update(M2, Q1, rho, P),
               bound, desc)
        yield (names[1], lambda M2=M2, Qd=Qd, rho=rho, Pd=Pd:
               fused.qr_p_update(M2, Qd, rho, Pd, donate=True), bound, desc)
        del Q1, P, Qd, Pd
    if not any(wanted(f"row {r} (k={k})") for r in ("16", "17") for k in (12, 24)) and \
            only and not re.search(only, "row 1[67]"):
        return
    from blockcg_tpu_torch.ops import const_block_stencil as cbs
    from blockcg_tpu_torch.problems import dirac_cbdia

    op = dirac_cbdia(32, device=dev)
    # The operator's own plans where the checkout has them (as its applies
    # pass them); an older checkout's wrappers take none.
    plans = getattr(op, "main_plans", None)
    main = (op.hops_main, op.main_offsets, op.main_slots, op.masks_main)
    extra = () if plans is None else (plans,)
    for k in (12, 24):
        Xm = torch.randn((op.bs * k, ns), generator=gen, device=dev)
        what = f"dirac_cbdia(32) merged (k={k}, m={op.bs * k})"
        desc = None if plans is None else plans.get(op.main_offsets, op.masks_main.shape[0], k,
                                                    ns, dev).describe()
        yield (f"row 16 const_block_stencil_spmm_m_t {what}",
               lambda Xm=Xm: cbs.const_block_stencil_spmm_m_t(*main, Xm, *extra),
               cbs_work(op, k, False), desc)
        yield (f"row 17 const_block_stencil_spmm_m_gram_t {what}",
               lambda Xm=Xm: cbs.const_block_stencil_spmm_m_gram_t(*main, Xm, *extra),
               cbs_work(op, k, True), desc)
        del Xm


# Probe builds of the merged const-hop kernel (csrc/cbs_merged.cu, included
# by a source that exports them) at k = 12 on config 4: cm_spmm<4, PROBE,
# NFB> with its copies or its far loads switched off (PROBE) or another count
# of far diagonals' loads in flight together (NFB); and the z-plane ring.
# The ring: block b takes right-hand side b % k and a slice of L planes of
# 1,024 sites; a ring of four plane buffers (its bs rows) holds planes j - 1,
# j, j + 1 while j + 2 is copied, so every offset within +-1,024 reads shared
# memory and only +-32,768 goes through L2. Its sums are cm_spmm's
# (cm_sums), so Y has its bits; its Gram cannot be fused (a block holds one
# right-hand side).
CM_PROBE = r"""#include "{src}"
namespace {{
template <int BS>
__global__ void __launch_bounds__(256) cr_spmm(const CmLaunch p, int L) {{
  extern __shared__ __align__(16) float smem[];
  constexpr int P = 1024;
  const int rows = p.bs, i = blockIdx.x % p.k;
  const long long nplanes = p.ns / P, first = static_cast<long long>(blockIdx.x / p.k) * L;
  float* sh = smem + 4 * rows * P;
  cm_stage_hops<BS>(p, sh);
  const RowStrides rs = RowMap{{p.k, 1}}.times(p.ns);
  const int c = 4 * threadIdx.x;
  auto copy = [&](int j) {{  // plane first + j into slot (j + 1) & 3
    long long pl = (first + j) % nplanes;
    if (pl < 0) pl += nplanes;
    float* buf = smem + ((j + 1) & 3) * rows * P;
    for (int e = threadIdx.x; e < rows * (P / 4); e += blockDim.x) {{
      const int b = e / (P / 4), q = 4 * (e % (P / 4));
      cp_async16(buf + b * P + q, p.X + (b * static_cast<long long>(p.k) + i) * p.ns + pl * P + q,
                 true);
    }}
  }};
  copy(-1);
  cp_async_commit();
  copy(0);
  cp_async_commit();
  copy(1);
  cp_async_commit();
  float acc[BS][4];
  for (int j = 0; j < L; ++j) {{
    if (j + 2 <= L) copy(j + 2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const long long s = ((first + j) % nplanes) * P + c;
    cm_sums<BS, 0, 2>(
        p, sh, s, i, rs,
        [&](int shd, int b) {{
          const int a0 = (c + shd) & ~3;
          auto at = [&](int a) {{  // the aligned quad at a, in plane j + floor(a / P)
            const int pl = (a + P) / P - 1;
            return smem + ((j + pl + 1) & 3) * rows * P + b * P + (a - pl * P);
          }};
          return CmQuads{{at(a0), at(a0 + 4)}};
        }},
        [&](int slot) {{
          return __ldg(reinterpret_cast<const float4*>(p.masks + slot * p.ns + s));
        }},
        acc);
    cm_store(p, s, i, rs, acc);
    __syncthreads();
  }}
  cp_async_wait<0>();
}}
}}  // namespace

// cm_spmm<4, PROBE, NFB> (probe = 10 * PROBE + NFB) on a plan's tile and group.
extern "C" int cm_probe(const float* hops, int nhop, const int* offsets, const int* slots,
                        const int* order, const int* gid, const float* masks, int nmask,
                        const float* X, float* Y, int k, long long ns, int h, int T, int kb,
                        int max_blocks, int probe, int device, cudaStream_t stream) {{
  CmLaunch p;
  cudaError_t err = cm_make_launch(&p, hops, nhop, offsets, slots, order, gid, 4, masks, nmask,
                                   X, Y, k, ns, h, T, kb, max_blocks);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (probe) {{
{cases}    default: return cudaErrorInvalidValue;
  }}
}}

// The z-plane ring on slices of L planes (bs = 4; ns a multiple of 1,024 L).
extern "C" int cr_probe(const float* hops, int nhop, const int* offsets, const int* slots,
                        const int* order, const int* gid, const float* masks, int nmask,
                        const float* X, float* Y, int k, long long ns, int L, int device,
                        cudaStream_t stream) {{
  CmLaunch p;
  cudaError_t err = cm_make_launch(&p, hops, nhop, offsets, slots, order, gid, 4, masks, nmask,
                                   X, Y, k, ns, 1024, 1024, 1, 1);
  if (err != cudaSuccess) return err;
  if (ns % (1024LL * L) != 0 || !p.vec) return cudaErrorInvalidValue;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto kernel = cr_spmm<4>;
  const size_t smem = (4LL * 4 * 1024 + nhop * 16) * sizeof(float);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<int>(ns / (1024LL * L) * k), 256, smem, stream>>>(p, L);
  return cudaGetLastError();
}}
"""
CM_PROBES = ((0, 2, "as built"), (4, 2, "no far loads"), (2, 2, "no window copies"),
             (6, 2, "no window copies, no far loads"), (0, 1, "far loads one at a time"),
             (0, 4, "four far diagonals' loads together"))
CR_PLANES = (8, 16, 32)  # the z-plane ring's slices
# const_block_stencil_plan's pins timed beside the plan: no window (every
# diagonal from L2), a 4-site halo, no hop groups; other groups of
# right-hand sides a block and tiles (kb, sw).
CM_VARIANTS = ({"h": 0}, {"h": 4}, {"grouped": False}, {"kb": 12, "sw": 1}, {"kb": 6, "sw": 2},
               {"kb": 6, "sw": 1}, {"kb": 4, "sw": 1}, {"kb": 3, "sw": 4}, {"kb": 2, "sw": 4},
               {"kb": 8, "sw": 1})


def const_hop_variants(torch, dev, tmp: Path, only: str | None):
    """Row 16 on ``dirac_cbdia(32)`` at k = 12 and 24 under its plan and each
    of ``CM_VARIANTS`` (a pin that leaves no schedule is skipped), each named
    by its plan; then at k = 12 the probe builds of ``CM_PROBES`` and the
    z-plane ring on slices of ``CR_PLANES`` planes, alone and followed by
    ``gram`` (row 17's form); and row 12 at (48, 32^4) on its plan beside a
    launch at twice its stage depth (one block an SM)."""
    import ctypes
    import subprocess

    from blockcg_tpu_torch.ops import _native, fused
    from blockcg_tpu_torch.ops import const_block_stencil as cbs
    from blockcg_tpu_torch.problems import dirac_cbdia

    op = dirac_cbdia(32, device=dev)
    main = (op.hops_main, op.main_offsets, op.main_slots, op.masks_main)
    ns, nd = op.ns, len(op.main_offsets)
    offs = tuple(o % ns for o in op.main_offsets)
    key, nmask = op.main_plans.hop_key, op.masks_main.shape[0]
    cap, sms = _native.max_smem(dev.index), _native.sm_count(dev.index)
    gen = torch.Generator(device=dev).manual_seed(16)
    for k in (12, 24):
        Xm = torch.randn((op.bs * k, ns), generator=gen, device=dev)
        for kw in ({},) + CM_VARIANTS:
            try:
                plan = cbs.const_block_stencil_plan(offs, key, nmask, op.bs, k, ns, cap, sms, **kw)
            except ValueError as e:
                print(json.dumps({"case": f"variant row 16 {kw} k={k}", "skip": str(e)}))
                continue
            name = "row 16 plan" if not kw else f"variant row 16 {kw}"
            yield (f"{name} k={k} [{plan.describe()}]",
                   lambda plan=plan, Xm=Xm: cbs.launch_planned(*main, Xm, plan),
                   cbs_work(op, k, False))
        del Xm
    k = 12
    Xm = torch.randn((op.bs * k, ns), generator=gen, device=dev)
    Y = torch.empty_like(Xm)
    plan = cbs.const_block_stencil_plan(offs, key, nmask, op.bs, k, ns, cap, sms)
    probe = tmp / "cm_probe.cu"
    cases = "".join(f"    case {10 * w + f}: return cm_launch<4, {w}, {f}>(p, max_blocks, "
                    "device, stream);\n" for w, f, _ in CM_PROBES)
    probe.write_text(CM_PROBE.format(src=_native.CSRC / "cbs_merged.cu", cases=cases))
    lib = tmp / "libcmprobe.so"
    built = subprocess.run([_native.nvcc(), *_native.NVCC_FLAGS, "-shared", str(probe), "-o",
                            str(lib)], capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"nvcc failed on the const-hop probe:\n{built.stdout}{built.stderr}")
    P, I, L, IP = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)
    fn, ring = ctypes.CDLL(str(lib)).cm_probe, ctypes.CDLL(str(lib)).cr_probe
    fn.argtypes = [P, I, IP, IP, IP, IP, P, I, P, P, I, L, I, I, I, I, I, I, P]
    ring.argtypes = [P, I, IP, IP, IP, IP, P, I, P, P, I, L, I, I, P]
    fn.restype = ring.restype = I
    stream = torch.cuda.current_stream(dev).cuda_stream
    cint = ctypes.c_int * nd
    p = _native.ptr
    tables = (p(op.hops_main), nd, cint(*offs), cint(*op.main_slots), cint(*plan.order),
              cint(*plan.gid), p(op.masks_main), nmask, p(Xm), p(Y), k, ns)
    for w, f, label in CM_PROBES:
        def run(w=w, f=f):
            rc = fn(*tables, plan.h, plan.T, plan.kb, plan.blocks, 10 * w + f, dev.index, stream)
            if rc != 0:
                raise RuntimeError(f"const-hop probe {w}, {f} failed: {rc}")
            return Y
        yield f"probe row 16 {label} k={k} [{plan.describe()}]", run, cbs_work(op, k, False)
    for planes in CR_PLANES:
        def zring(planes=planes):
            rc = ring(*tables, planes, dev.index, stream)
            if rc != 0:
                raise RuntimeError(f"z-plane ring probe (L = {planes}) failed: {rc}")
            return Y
        yield (f"probe row 16 z-plane ring k={k} L={planes} blocks={ns // (1024 * planes) * k}",
               zring, cbs_work(op, k, False))
        yield (f"probe row 17 z-plane ring + gram k={k} L={planes}",
               lambda zring=zring: (zring(), fused.gram(Xm, Y)), cbs_work(op, k, True))
    del Xm, Y
    gen = torch.Generator(device=dev).manual_seed(12)
    M2 = torch.linalg.qr(torch.randn((48, 48), generator=gen, device=dev))[0].contiguous()
    rho = 0.1 * torch.randn((48, 48), generator=gen, device=dev) / 48 ** 0.5
    Q1, Pf = (torch.randn((48, ns), generator=gen, device=dev) for _ in range(2))
    Q, Pn = torch.empty_like(Q1), torch.empty_like(Pf)
    qplan = fused.qr_p_update_plan(48, dev)
    for kc in (qplan.kc, 2 * qplan.kc):
        def qr(kc=kc):
            _native.launch("variant", "bcg_qr_p_update", dev, p(M2), p(Q1), p(rho), p(Pf), p(Q),
                           p(Pn), 48, 48, ns, kc)
            return Q, Pn
        yield (f"{'row 12 plan' if kc == qplan.kc else 'variant row 12'} kc={kc} (48, 32^4)", qr,
               max(4 * (4 * 48 * ns + 2 * 48 * 48) / 3.35e12, 4 * 48 * 48 * ns / 67e12) * 1e6)


def bf16_cases(torch, dev):
    """(name, fn, bound us) of the bf16 variants of rows 1, 2 and 5-9 at
    (32, 256^3), then of the f32 kernels on the same values in f32."""
    from blockcg_tpu_torch.ops import fused, stencil
    from blockcg_tpu_torch.problems import laplacian_dia

    gen = torch.Generator(device=dev).manual_seed(0)
    k = 32
    op = laplacian_dia((256,) * 3, dtype=torch.bfloat16, device=dev)
    n, nd = op.n, len(op.offsets)
    nnz = int(torch.count_nonzero(op.diags))
    M, M2, M3 = (torch.randn((k, k), generator=gen, device=dev) / k ** 0.5 for _ in range(3))
    fields = [torch.randn((k, n), generator=gen, device=dev).bfloat16() for _ in range(3)]

    for dt in (torch.bfloat16, torch.float32):
        X, V, Z = (f.to(dt) for f in fields)
        D = op.diags.to(dt)
        e = X.element_size()
        # FLOPs at the peak rate of their type: bf16 products with f32 sums
        # on the tensor cores, else f32 outside them (chip_smoke.py's rates)
        rate = 989e12 if e == 2 else 67e12

        def bound(nbytes, flops, rate=rate):
            return max(nbytes / 3.35e12, flops / rate) * 1e6

        fb, kk, syrk = e * k * n, 4 * k * k, k * (k + 1) * n
        what = f"{'bf16' if e == 2 else 'f32'} (32, 256^3)"
        yield (f"row 1 stencil_spmm_t {what}",
               lambda D=D, X=X: stencil.stencil_spmm_t(D, op.offsets, X),
               bound(e * nd * n + 2 * fb, 2 * k * nnz))
        yield (f"row 2 stencil_spmm_gram_t {what}",
               lambda D=D, X=X: stencil.stencil_spmm_gram_t(D, op.offsets, X),
               bound(e * nd * n + 2 * fb + kk, 2 * k * nnz + 2 * k * k * n))
        yield (f"row 5 gram {what}", lambda X=X, V=V: fused.gram(X, V),
               bound(2 * fb + kk, 2 * k * k * n))
        yield (f"row 6 mm_update {what}", lambda X=X: fused.mm_update(M, X),
               bound(2 * fb + kk, 2 * k * k * n))
        yield (f"row 7 mm_update_gram {what}", lambda X=X: fused.mm_update_gram(M, X),
               bound(2 * fb + 2 * kk, 2 * k * k * n + syrk))
        yield (f"row 8 mm2_update_gram {what}",
               lambda X=X, V=V: fused.mm2_update_gram(M, X, M2, V),
               bound(3 * fb + 3 * kk, 4 * k * k * n + syrk))
        yield (f"row 9 px_update {what}",
               lambda X=X, V=V, Z=Z: fused.px_update(M, X, M2, V, M3, Z),
               bound(5 * fb + 3 * kk, 6 * k * k * n))
        del X, V, Z
    yield from row2w_cases(torch, dev)


def row2w_cases(torch, dev):
    """(name, fn, bound us) of the bf16 stencil's Gram above one launch's 64
    rows (row 2w) at the ``[storage]`` shape, (96, 128^3), on bf16 and on
    f32 diagonals of the 7-point operator (``[bf16, wide]``, ``[bf16 field,
    wide]``): X read and Y written once in bf16, the diagonals once, G
    written; the SpMM's FLOPs and the Gram's 2 k^2 a column at the bf16
    tensor-core rate. First one line of the Gram's relative Frobenius
    distance from the f64 Gram of X and the f32 sums, its contract, at k =
    96 and 128 on the 32^3 and 128^3 Laplacians (the checkout's route)."""
    from blockcg_tpu_torch.ops import stencil
    from blockcg_tpu_torch.problems import laplacian_dia

    dist = {}
    for edge in (32, 128):
        lap = laplacian_dia((edge,) * 3, device=dev)
        for k in (96, 128):
            gen = torch.Generator(device=dev).manual_seed(k)
            X = torch.randn((k, lap.n), generator=gen, device=dev).bfloat16()
            S = stencil.stencil_spmm_t(lap.diags, lap.offsets, X.float())
            G64 = X.double() @ S.double().T
            G = stencil.stencil_spmm_gram_t(lap.diags.bfloat16(), lap.offsets, X)[1].double()
            dist[f"({k}, {edge}^3)"] = float(torch.linalg.norm(G - G64) / torch.linalg.norm(G64))
            del X, S, G64, G
    print(json.dumps({"case": "row 2w gram contract distance", "dist": dist}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    k = 96
    op = laplacian_dia((128,) * 3, dtype=torch.bfloat16, device=dev)
    n, nd = op.n, len(op.offsets)
    nnz = int(torch.count_nonzero(op.diags))
    X = torch.randn((k, n), generator=gen, device=dev).bfloat16()
    for D, what in ((op.diags, "[bf16, wide]"), (op.diags.float(), "[bf16 field, wide]")):
        bound = max((D.element_size() * nd * n + 4 * k * n + 4 * k * k) / 3.35e12,
                    (2 * k * nnz + 2 * k * k * n) / 989e12) * 1e6
        yield (f"row 2w stencil_spmm_gram_t{what} (96, 128^3)",
               lambda D=D: stencil.stencil_spmm_gram_t(D, op.offsets, X), bound)


def short_cases(torch, dev):
    """(name, fn, bound us[, plan]) of the rows whose CUDA-event medians in
    ``chip_smoke.py`` time the host's wrapper (PERF.md section 6): row 10
    (``xr_update_gram``) at config 2's (16, 512^2), f32 and bf16, and bf16
    at (48, 32^4) on ``I_4 x C``; row 14 (``const_block_stencil_spmm_t``) on
    ``row14_operands``, each with its launch's plan, and row 16 beside it.
    Bounds as ``chip_smoke.py`` counts them."""
    from blockcg_tpu_torch.ops import const_block_stencil as cbs
    from blockcg_tpu_torch.ops import fused

    gen = torch.Generator(device=dev).manual_seed(0)
    for m, kc, n, dt, what in ((16, 16, 512 ** 2, torch.float32, "f32 (16, 512^2)"),
                              (16, 16, 512 ** 2, torch.bfloat16, "bf16 (16, 512^2)"),
                              (48, 12, 32 ** 4, torch.bfloat16, "bf16 (48, 32^4)")):
        C = torch.randn((kc, kc), generator=gen, device=dev) / kc ** 0.5
        A = C if kc == m else torch.kron(torch.eye(m // kc, device=dev), C)
        F = [torch.randn((m, n), generator=gen, device=dev).to(dt) for _ in range(4)]
        e = F[0].element_size()
        nnz = int(torch.count_nonzero(A))
        rate = 989e12 if e == 2 else 67e12
        bound = max((4 * m * m + 6 * e * m * n + 4 * m * m) / 3.35e12,
                    (4 * n * nnz + m * (m + 1) * n) / rate) * 1e6
        row = "10b" if e == 2 else "10"
        yield (f"row {row} xr_update_gram {what}",
               lambda A=A, F=F: fused.xr_update_gram(A, *F), bound)
    for row, what, hop, Xv in row14_operands(torch, dev, gen):
        main = (hop.hops_main, hop.main_offsets, hop.main_slots, hop.masks_main, Xv)
        # the operator's plans where the view's wrapper takes them (as its applies pass them)
        extra = ((hop.main_plans,) if "plans" in inspect.signature(
            cbs.const_block_stencil_spmm_t).parameters else ())
        k = Xv.shape[0]
        if row == "16":
            Xm = Xv.transpose(0, 1).reshape(hop.bs * k, hop.ns).contiguous()
            yield (f"row 16 const_block_stencil_spmm_m_t {what}",
                   lambda hop=hop, Xm=Xm: cbs.const_block_stencil_spmm_m_t(
                       *main[:4], Xm, hop.main_plans), cbs_work(hop, k, False))
            continue
        yield (f"row 14 const_block_stencil_spmm_t {what}",
               lambda main=main, extra=extra: cbs.const_block_stencil_spmm_t(*main, *extra),
               cbs_work(hop, k, False), row14_plan(hop, k))


def update_cases(torch, dev):
    """(name, fn, bound us[, plan]) of ``csrc/px_update.cu``'s rows, with L2
    flushed: row 13 (``qr_px_update``, f32) at (32, 2^21) and (96, 32^4),
    row 13b (bf16) at (48, 32^4) and, dense, at 16, 32, 64 and 96 rows of
    32^4, beside the rows that share its templates: row 9 (``px_update``,
    f32) at (32, 2^21), 9b (bf16) at (32, 256^3) and at 16, 32, 48 and 64
    rows of 32^4, 12 and 12b (``qr_p_update``) at (48, 32^4). Coefficients dense, scaled by 1 /
    sqrt(m); fresh outputs. Each bound is the fields' bytes (every input read
    once, every output written once) over 3.35 TB/s against 2 m^2 n FLOPs a
    coefficient matrix over 67 TFLOP/s (989 on bf16 fields, the tensor
    cores' rate); each line carries the launch's plan."""
    from blockcg_tpu_torch.ops import fused

    gen = torch.Generator(device=dev).manual_seed(13)

    def bound(m, n, esize, passes, nmat):
        return max(passes * esize * m * n / 3.35e12,
                   nmat * 2 * m * m * n / (989e12 if esize == 2 else 67e12)) * 1e6

    def plan_of(m, n, dt, q):  # the route the wrapper takes, where it is px_update_mma
        if (dt != torch.bfloat16 or m > fused.PX_MMA_MAX_K
                or q and not hasattr(fused._native.library(), "bcg_qr_px_update_mma")):
            return None  # a checkout before this mode ran qr_p_update.cu
        idx = dev.index or 0
        mma = fused.px_update_mma_plan(m, n, fused._native.max_smem(idx),
                                       fused._native.sm_count(idx))
        return f"px_update_mma T={mma.T} stages={mma.stages} smem={mma.smem_bytes}"

    cases = (("13", "qr_px_update", 32, 2 ** 21, torch.float32),
             ("13", "qr_px_update", 96, 32 ** 4, torch.float32),
             ("13b", "qr_px_update", 48, 32 ** 4, torch.bfloat16),
             *(("13b", "qr_px_update", m, 32 ** 4, torch.bfloat16) for m in (16, 32, 64, 96)),
             ("9", "px_update", 32, 2 ** 21, torch.float32),
             ("9b", "px_update", 32, 256 ** 3, torch.bfloat16),
             *(("9b", "px_update", m, 32 ** 4, torch.bfloat16) for m in (16, 32, 48, 64)),
             ("12", "qr_p_update", 48, 32 ** 4, torch.float32),
             ("12b", "qr_p_update", 48, 32 ** 4, torch.bfloat16))
    for row, name, m, n, dt in cases:
        M = [torch.randn((m, m), generator=gen, device=dev) / m ** 0.5 for _ in range(3)]
        F = [torch.randn((m, n), generator=gen, device=dev).to(dt) for _ in range(3)]
        e = F[0].element_size()
        what = f"{'f32' if e == 4 else 'bf16'} ({m}, {n})"
        if name == "qr_px_update":
            fn = lambda M=M, F=F: fused.qr_px_update(M[0], F[0], M[1], F[1], M[2], F[2])
            yield (f"row {row} {name} {what}", fn, bound(m, n, e, 6, 3),
                   plan_of(m, n, dt, True))
        elif name == "px_update":
            fn = lambda M=M, F=F: fused.px_update(M[0], F[0], M[1], F[1], M[2], F[2])
            yield f"row {row} {name} {what}", fn, bound(m, n, e, 5, 3), plan_of(m, n, dt, False)
        else:
            fn = lambda M=M, F=F: fused.qr_p_update(M[0], F[0], M[1], F[1])
            yield f"row {row} {name} {what}", fn, bound(m, n, e, 4, 2)
        del F


def update_variants(torch, dev):
    """Row 13b (``qr_px_update`` on bf16 fields, ``px_update_mma``'s
    QR-with-X mode) at 32, 48 and 64 rows of 32^4 on every column tile and
    ring depth whose shared memory fits, launched through
    ``bcg_qr_px_update_mma`` with the pinned (T, stages), the plan's marked
    ``plan``; beside each, row 9b (``px_update``) on the same pins. Bounds
    as ``update_cases`` counts them."""
    from blockcg_tpu_torch.ops import _native, fused

    gen = torch.Generator(device=dev).manual_seed(13)
    idx = dev.index or 0
    cap, sms = _native.max_smem(idx), _native.sm_count(idx)
    n, p = 32 ** 4, _native.ptr
    for m in (32, 48, 64):
        M = [torch.randn((m, m), generator=gen, device=dev) / m ** 0.5 for _ in range(3)]
        F = [torch.randn((m, n), generator=gen, device=dev).bfloat16() for _ in range(3)]
        O = [torch.empty_like(F[0]) for _ in range(3)]
        for q, row, passes in ((True, "13b", 6), (False, "9b", 5)):
            plan = fused.px_update_mma_plan(m, n, cap, sms)
            for T in (128, 256, 512):
                for stages in (2, 3, 4):
                    if (fused.px_update_mma_smem_bytes(m, T, stages)
                            + fused.RING_BARRIER_BYTES > cap):
                        continue
                    tag = "plan" if (T, stages) == (plan.T, plan.stages) else "variant"
                    args = ((p(M[0]), p(F[0]), p(M[1]), p(F[1]), p(M[2]), p(F[2]), p(O[0]),
                             p(O[1]), p(O[2])) if q else
                            (p(M[0]), p(F[0]), p(M[1]), p(F[1]), p(M[2]), p(F[2]), p(O[1]),
                             p(O[2])))
                    fn_name = "bcg_qr_px_update_mma" if q else "bcg_px_update_mma"
                    yield (f"{tag} row {row} T={T} stages={stages} bf16 ({m}, {n})",
                           lambda fn_name=fn_name, args=args, T=T, stages=stages, m=m:
                           _native.launch("variant", fn_name, dev, *args, m, n, T, stages),
                           max(passes * 2 * m * n / 3.35e12, 6 * m * m * n / 989e12) * 1e6)
        del F, O


def row14_operands(torch, dev, gen):
    """(row, what, operator, X on the (k, bs, ns) view) of row 14's cases:
    the even-odd CG's parity hop of ``dirac_eo(32)`` at one RHS, (1, 4,
    2^19), and config 4's ``dirac_cbdia(32)`` at (12, 4, 32^4), beside row
    16 (the merged launch) on the same field."""
    from blockcg_tpu_torch.problems import dirac_cbdia, dirac_eo

    hop = dirac_eo(32, device=dev).hop_oe
    yield ("14", f"dirac_eo(32) hop_oe (1, {hop.bs}, {hop.ns})", hop,
           torch.randn((1, hop.bs, hop.ns), generator=gen, device=dev))
    op = dirac_cbdia(32, device=dev)
    Xv = torch.randn((12, op.bs, op.ns), generator=gen, device=dev)
    yield "14", f"dirac_cbdia(32) (12, {op.bs}, 32^4)", op, Xv
    yield "16", f"dirac_cbdia(32) merged (k=12, m={op.bs * 12})", op, Xv


def row14_plan(hop, k: int):
    """The plan line of row 14's launch on a checkout that runs it on
    ``csrc/cbs_merged.cu`` (the view's ``MergedPlans`` entry), else None."""
    if "view" not in inspect.signature(hop.main_plans.get).parameters:
        return None
    dev = hop.hops_main.device
    return hop.main_plans.get(hop.main_offsets, hop.masks_main.shape[0], k, hop.ns, dev,
                              view=True).describe()


def short_variants(torch, dev, tmp: Path):
    """Row 14 on ``dirac_eo(32)``'s hop_oe at one RHS and on config 4's (12,
    4, 32^4) view on the view's plan and on pins of
    ``const_block_stencil_plan`` (ungrouped, as the view's): each tile width
    ``sw`` with the plan's halo and with a 16-site and a 512-site one, and the
    plan's grid at two and four times its blocks (more blocks an SM where
    the shared memory holds them); at one RHS also the probe builds of
    ``CM_PROBES`` that load one, two or four far diagonals together
    (``cm_spmm<4, 0, NFB>``; at k = 1 the merged row map is the view's) on
    the plan and the 512-site halo; each with its bound and checksums."""
    import ctypes

    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.ops import const_block_stencil as cbs

    cap, sms = _native.max_smem(dev.index), _native.sm_count(dev.index)
    gen = torch.Generator(device=dev).manual_seed(0)
    for row, what, hop, Xv in row14_operands(torch, dev, gen):
        if row != "14":
            continue
        k, ns = Xv.shape[0], hop.ns
        nmask = hop.masks_main.shape[0]
        main = (hop.hops_main, hop.main_offsets, hop.main_slots, hop.masks_main)
        plan = hop.main_plans.get(hop.main_offsets, nmask, k, ns, dev, view=True)
        offs = tuple(o % ns for o in hop.main_offsets)
        pins = [plan]
        for sw in cbs.CM_SW:
            for h in (plan.h, 16, 512):
                try:
                    v = cbs.const_block_stencil_plan(offs, hop.main_plans.hop_key, nmask, hop.bs,
                                                     k, ns, cap, sms, h=h, sw=sw,
                                                     grouped=False)
                except ValueError:
                    continue
                if v not in pins:
                    pins.append(v)
        for mul in (2, 4):
            pins.append(plan._replace(blocks=min(plan.blocks * mul, _native.MAX_BLOCKS)))
        for v in pins:
            name = "row 14 plan" if v is plan else "variant row 14"
            yield (f"{name} {what} [{v.describe()}]",
                   lambda v=v, Xv=Xv: cbs._launch_cm(*main, Xv, k, ns, False, v, "variant"),
                   cbs_work(hop, k, False))
        if k != 1 or hop.bs > 4:
            continue
        fn = _probe_lib(CM_PROBE.format(
            src=_native.CSRC / "cbs_merged.cu",
            cases="".join(f"    case {f}: return cm_launch<4, 0, {f}>(p, max_blocks, device, "
                          "stream);\n" for f in (1, 2, 4))), "cm_probe", tmp)
        P, I, L, IP = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.POINTER(ctypes.c_int))
        fn.argtypes = [P, I, IP, IP, IP, IP, P, I, P, P, I, L, I, I, I, I, I, I, P]
        fn.restype = I
        stream = torch.cuda.current_stream(dev).cuda_stream
        nd = len(offs)
        cint = ctypes.c_int * nd
        Y = torch.empty_like(Xv)
        h512 = cbs.const_block_stencil_plan(offs, hop.main_plans.hop_key, nmask, hop.bs, k, ns,
                                            cap, sms, h=512, sw=plan.sw, grouped=False)
        for v in (plan, h512):
            for nfb in (1, 2, 4):
                def run(v=v, nfb=nfb):
                    rc = fn(hop.hops_main.data_ptr(), nd, cint(*offs), cint(*hop.main_slots),
                            cint(*v.order), cint(*v.gid), hop.masks_main.data_ptr(), nmask,
                            Xv.data_ptr(), Y.data_ptr(), k, ns, v.h, v.T, v.kb, v.blocks, nfb,
                            dev.index, stream)
                    if rc != 0:
                        raise RuntimeError(f"const-hop probe NFB = {nfb} failed: {rc}")
                    return Y
                yield (f"probe row 14 far loads {nfb} together {what} [{v.describe()}]", run,
                       cbs_work(hop, k, False))


def storage_cases(torch, dev, only: str | None = None):
    """(name, fn, bound us[, plan]) of ``chip_smoke.py``'s ``[storage]``
    shapes: rows 1m, 2m and 2 (the DIA stencil on bf16 and f32 diagonals
    with an f32 field, without and with its Gram) and row 1x (f32 diagonals,
    a bf16 field) at (32, 128^3) on the 7-point Laplacian, row 1b (bf16
    diagonals and field) at config 5's (32, 256^3), row 2 also at (32, 64^3)
    and (64, 256^3); then rows 22h, 23h and 23 (the per-site block
    stencil on bf16 blocks, the (k, bs, ns) view and the merged one, and the
    merged one on f32 blocks) and the folded rows 24f (f32 and bf16 blocks)
    and 24fg (with the fused Gram, and the apply followed by ``gram``) on
    ``dirac_gauged_matrix(32)`` at k = 12 (about 40 s of host build, skipped
    where ``only`` leaves none of those rows). Bounds as ``chip_smoke.py``
    counts them: each input read once and each output written once over
    3.35 TB/s against the FLOPs over 67 TFLOP/s. First one line of rows 2m's
    and 2's Gram distance from the f64 Gram of X and the f32 sums, their
    contract."""
    from blockcg_tpu_torch.ops import _native, fused, stencil
    from blockcg_tpu_torch.ops import block_stencil as bsk
    from blockcg_tpu_torch.problems import dirac_gauged_matrix, laplacian_dia

    def bound(nbytes, flops):
        return max(nbytes / 3.35e12, flops / 67e12) * 1e6

    def wanted(*names):
        return only is None or any(re.search(only, name) for name in names)

    def ring_plan(D, offsets, X):  # a checkout before the ring has no launch_plans
        plans = getattr(stencil, "launch_plans", None)
        return "; ".join(stencil.describe(p) for _, p in plans(D, offsets, X, False)) if plans \
            else None

    def window_plans(D, offsets, X):  # stencil_plan's (h, T) for each row chunk
        kk, n = X.shape
        idx = X.device.index or 0
        return [((r0, r1), stencil.stencil_plan(tuple(int(o) for o in offsets), n, r1 - r0,
                                                _native.max_smem(idx), _native.sm_count(idx),
                                                X.element_size(), D.element_size()))
                for r0, r1 in _native.row_chunks(kk)]

    def window_plan(D, offsets, X):
        return "; ".join(stencil.describe(p) for _, p in window_plans(D, offsets, X))

    def window(D, offsets, X):
        """The window kernel (``stencil_spmm``) launched on ``stencil_plan``'s
        plans, as ``stencil._launch`` launches a ``StencilPlan``: the ring's
        yardstick."""
        n = X.shape[1]
        label, fn = _native.pair_variant("stencil_spmm_t", "bcg_stencil_spmm",
                                         _native.pair_kernel(X, D, stencil.PAIRS))
        offs = (ctypes.c_int * len(offsets))(*(int(o) % n for o in offsets))
        Y = torch.empty_like(X)
        p = _native.ptr
        for (r0, r1), plan in window_plans(D, offsets, X):
            _native.launch(label, fn, X.device, p(D), offs, len(offsets), p(X[r0:r1]),
                           p(Y[r0:r1]), None, None, r1 - r0, n, plan.h, plan.T,
                           min(-(-n // plan.T), _native.MAX_BLOCKS))
        return Y

    gen = torch.Generator(device=dev).manual_seed(0)
    k = 32
    lap = laplacian_dia((128,) * 3, device=dev)
    n, nd = lap.n, len(lap.offsets)
    nnz = int(torch.count_nonzero(lap.diags))
    X = torch.randn((k, n), generator=gen, device=dev)
    d16 = lap.diags.bfloat16()
    if wanted("row 2m ", "row 2 "):
        dist = {}
        for D, row in ((d16, "2m"), (lap.diags, "2")):
            Y, G = stencil.stencil_spmm_gram_t(D, lap.offsets, X)
            G64 = X.double() @ Y.double().T
            dist[row] = float(torch.linalg.norm(G.double() - G64) / torch.linalg.norm(G64))
            del Y, G, G64
        print(json.dumps({"case": "rows 2m, 2 gram contract distance (32, 128^3)",
                          "dist": dist}), flush=True)
    for D, row, what in ((d16, "1m", "[bf16 coeffs]"), (d16, "2m", "[bf16 coeffs]"),
                         (lap.diags, "2", "")):
        fb = D.element_size() * nd * n + 8 * k * n
        if row == "1m":
            yield (f"row 1m stencil_spmm_t{what} (32, 128^3)",
                   lambda D=D: stencil.stencil_spmm_t(D, lap.offsets, X), bound(fb, 2 * k * nnz),
                   ring_plan(D, lap.offsets, X))
        else:
            yield (f"row {row} stencil_spmm_gram_t{what} (32, 128^3)",
                   lambda D=D: stencil.stencil_spmm_gram_t(D, lap.offsets, X),
                   bound(fb + 4 * k * k, 2 * k * nnz + 2 * k * k * n))
    fb = 4 * nd * n + 8 * k * n
    yield ("row 1 stencil_spmm_t (32, 128^3)",
           lambda: stencil.stencil_spmm_t(lap.diags, lap.offsets, X), bound(fb, 2 * k * nnz),
           ring_plan(lap.diags, lap.offsets, X))
    # Rows 1 and 1m at the other widths and operators of the main path, each
    # on its route and, where that is the ring, on the window kernel too.
    for shape, kk, size in ([((128,) * 3, kk, "128^3") for kk in (1, 4, 8, 32, 64)]
                            + [((64,) * 3, 32, "64^3"), ((128,) * 2, 4, "128^2"),
                               ((512,) * 2, 16, "512^2")]):
        at = f"({kk}, {size})"
        if not wanted(f"row 1 stencil_spmm_t {at}", f"row 1m stencil_spmm_t[bf16 coeffs] {at}",
                      f"variant row 1 window {at}", f"variant row 1m window {at}"):
            continue
        op = lap if shape == (128,) * 3 else laplacian_dia(shape, device=dev)
        opn, ond, onnz = op.n, len(op.offsets), int(torch.count_nonzero(op.diags))
        Xk = X[:kk] if op is lap and kk <= k else torch.randn((kk, opn), generator=gen,
                                                              device=dev)
        for D, row, what in ((op.diags, "1", ""), (op.diags.bfloat16(), "1m", "[bf16 coeffs]")):
            work = bound(D.element_size() * ond * opn + 8 * kk * opn, 2 * kk * onnz)
            if (op is not lap or kk != k) and wanted(f"row {row} stencil_spmm_t{what} {at}"):
                yield (f"row {row} stencil_spmm_t{what} {at}",
                       lambda D=D, op=op, Xk=Xk: stencil.stencil_spmm_t(D, op.offsets, Xk),
                       work, ring_plan(D, op.offsets, Xk))
            rings = any(isinstance(pl, stencil.RingPlan)
                        for _, pl in stencil.launch_plans(D, op.offsets, Xk, False))
            if rings and wanted(f"variant row {row} window {at}"):
                yield (f"variant row {row} window {at}",
                       lambda D=D, op=op, Xk=Xk: window(D, op.offsets, Xk), work,
                       window_plan(D, op.offsets, Xk))
        del op, Xk, D
    X16 = X.bfloat16()
    yield ("row 1x stencil_spmm_t[bf16 field] (32, 128^3)",
           lambda: stencil.stencil_spmm_t(lap.diags, lap.offsets, X16),
           bound(4 * nd * n + 4 * k * n, 2 * k * nnz), ring_plan(lap.diags, lap.offsets, X16))
    del X, X16, lap, d16
    if wanted("row 1m stencil_spmm_t[bf16 coeffs] (32, 256^3)",
              "row 1 stencil_spmm_t (32, 256^3)"):
        lap = laplacian_dia((256,) * 3, device=dev)
        n, nd, nnz = lap.n, len(lap.offsets), int(torch.count_nonzero(lap.diags))
        X = torch.randn((k, n), generator=gen, device=dev)
        for D, row, what in ((lap.diags.bfloat16(), "1m", "[bf16 coeffs]"), (lap.diags, "1", "")):
            yield (f"row {row} stencil_spmm_t{what} (32, 256^3)",
                   lambda D=D, X=X: stencil.stencil_spmm_t(D, lap.offsets, X),
                   bound(D.element_size() * nd * n + 8 * k * n, 2 * k * nnz),
                   ring_plan(D, lap.offsets, X))
        del lap, X, D
    if wanted("row 1b stencil_spmm_t[bf16] (32, 256^3)"):
        lap = laplacian_dia((256,) * 3, dtype=torch.bfloat16, device=dev)
        n, nd, nnz = lap.n, len(lap.offsets), int(torch.count_nonzero(lap.diags))
        X = torch.randn((k, n), generator=gen, device=dev).bfloat16()
        yield ("row 1b stencil_spmm_t[bf16] (32, 256^3)",
               lambda lap=lap, X=X: stencil.stencil_spmm_t(lap.diags, lap.offsets, X),
               bound(2 * nd * n + 4 * k * n, 2 * k * nnz), ring_plan(lap.diags, lap.offsets, X))
        del lap, X
    for edge in (64, 128):  # row 2's Gram at 64 rows on the on-card test's X
        if not wanted(f"row 2 gram contract distance (64, {edge}^3)"):
            continue
        lap = laplacian_dia((edge,) * 3, device=dev)
        X = torch.as_tensor(np.random.default_rng(2240 + edge).standard_normal((64, lap.n)),
                            dtype=torch.float32, device=dev)
        Y, G = stencil.stencil_spmm_gram_t(lap.diags, lap.offsets, X)
        G64 = X.double() @ Y.double().T
        print(json.dumps({"case": f"row 2 gram contract distance (64, {edge}^3)",
                          "dist": float(torch.linalg.norm(G.double() - G64)
                                        / torch.linalg.norm(G64)),
                          "checksums": checksums(torch, (Y,))}), flush=True)
        del lap, X, Y, G, G64
    for edge, kk, row in ((64, 32, "2"), (256, 64, "2"), (128, 64, "2"), (64, 64, "2"),
                          (256, 64, "2m")):
        name = (f"row {row} stencil_spmm_gram_t{'[bf16 coeffs]' if row == '2m' else ''} "
                f"({kk}, {edge}^3)")
        if not wanted(name):
            continue
        lap = laplacian_dia((edge,) * 3, device=dev)
        D = lap.diags.bfloat16() if row == "2m" else lap.diags
        n, nnz = lap.n, int(torch.count_nonzero(lap.diags))
        X = torch.randn((kk, n), generator=gen, device=dev)
        yield (name, lambda lap=lap, D=D, X=X: stencil.stencil_spmm_gram_t(D, lap.offsets, X),
               bound(D.element_size() * len(lap.offsets) * n + 8 * kk * n + 4 * kk * kk,
                     2 * kk * nnz + 2 * kk * kk * n),
               "; ".join(stencil.describe(pl) for _, pl in stencil.launch_plans(
                   D, lap.offsets, X, True)) if hasattr(stencil, "launch_plans") else None)
        del lap, X, D
    if not wanted("row 22h block_stencil_spmm_t", "row 23h block_stencil_spmm_m_t",
                  "row 23 block_stencil_spmm_m_t", "row 24f block_stencil_spmm_m_t",
                  "row 24fg block_stencil_spmm_m_gram_t", "row 24fg via gram.cu"):
        return
    os.environ["BLOCKCG_FOLD"] = "1"  # the folded blocks beside the unfolded ones
    try:
        op = dirac_gauged_matrix(32, m=0.5, device=dev)
    finally:
        os.environ.pop("BLOCKCG_FOLD", None)
    k = 12
    blocks, offs = op.blocks, op.offsets
    nd, bs, _, ns = blocks.shape
    m = bs * k
    Xm = torch.randn((m, ns), generator=gen, device=dev)
    Xv = torch.randn((k, bs, ns), generator=gen, device=dev)
    b16 = blocks.bfloat16()
    bnnz = int(torch.count_nonzero(b16))
    tma = getattr(bsk, "_tma_ok", None)  # a checkout before bs_tma has no TMA route

    def describe(B, o, gram, fold=(), X=Xm, merged=True):
        kw = {}
        if tma:  # a checkout whose _tma_ok also took the view refused the (k, bs, ns) one
            kw["tma"] = tma(B, X, merged) if tma.__code__.co_argcount == 3 else tma(B, X)
        return "; ".join(p.describe() for _, p in bsk.launch_plans(B, o, k, gram, dev,
                                                                    fold=fold, **kw))
    for B, row, what in ((b16, "22h", "[bf16 coeffs]"), (b16, "23h", "[bf16 coeffs]"),
                         (blocks, "23", "")):
        w = bound(B.numel() * B.element_size() + 8 * m * ns, 2 * k * bnnz)
        if row == "22h":
            yield (f"row 22h block_stencil_spmm_t{what} ({k}, {bs}, 32^4)",
                   lambda B=B: bsk.block_stencil_spmm_t(B, offs, Xv), w,
                   describe(B, offs, False, X=Xv, merged=False))
        else:
            yield (f"row {row} block_stencil_spmm_m_t{what} ({m}, 32^4)",
                   lambda B=B: bsk.block_stencil_spmm_m_t(B, offs, Xm), w,
                   describe(B, offs, False))
    fb, foffs, fold = op.blocks_folded, op.fold_offsets, op.fold
    del op, Xv, b16
    fb16 = fb.bfloat16()
    for B, what in ((fb, "[fold]"), (fb16, "[fold, bf16 coeffs]")):
        w = (B.numel() * B.element_size() + 8 * m * ns, 2 * k * int(torch.count_nonzero(B)))
        yield (f"row 24f block_stencil_spmm_m_t{what} ({m}, 32^4)",
               lambda B=B: bsk.block_stencil_spmm_m_t(B, foffs, Xm, fold), bound(*w),
               describe(B, foffs, False, fold))
        if B is fb:
            gw = bound(w[0] + 4 * m * m, w[1] + m * (m + 1) * ns)
            yield (f"row 24fg block_stencil_spmm_m_gram_t[fold] ({m}, 32^4)",
                   lambda: bsk.block_stencil_spmm_m_gram_t(fb, foffs, Xm, fold), gw,
                   describe(fb, foffs, True, fold))
            yield (f"row 24fg via gram.cu: block_stencil_spmm_m_t[fold] then gram ({m}, 32^4)",
                   lambda: (lambda Y: (Y, fused.gram(Xm, Y)))(
                       bsk.block_stencil_spmm_m_t(fb, foffs, Xm, fold)), gw)


# Probe builds of rows 2m and 2 (csrc/stencil.cu stencil_mma_f32<ED, 32,
# PROBE>, exported by a source that includes it) at (32, 128^3): parts
# switched off, the far diagonals read at their use instead of a step
# ahead, and the products summed a tile in f32 before the double sums.
F32_PROBE = r"""#include "{src}"
extern "C" int f32_probe(const bf16* diags, const int* offsets, int ndiag, const float* X,
                         float* Y, float* part, float* G, int k, long long n, int h, int T,
                         int max_blocks, int probe, int device, cudaStream_t stream) {{
  Diags dg{{}};
  if (k <= 16 || k > 32 || !make_diags(&dg, offsets, ndiag, n, h)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (probe) {{
{cases}    default: return cudaErrorInvalidValue;
  }}
}}
"""
F32_PROBES = ((0, "as built"), (1, "no far X"), (2, "no Gram"), (4, "no Y stores"),
              (8, "no window refills"), (16, "far X read at its use"), (6, "no Gram, no Y stores"),
              (7, "no far X, no Gram, no Y stores"), (15, "nothing but the near SpMM"),
              (32, "products straight into the double sums"))

# Probe builds of rows 23h and 24h (csrc/block_stencil.cu bs_tma<4, 6,
# PROBE>) on their plan at m = 48: parts switched off.
BT_PROBE = r"""#include "{src}"
extern "C" int bt_probe(const void* blocks, const int* offsets, int nd, int bs, const float* X,
                        float* Y, int k, long long ns, int h, int groups, int ki, int stages,
                        int max_blocks, int probe, int device, cudaStream_t stream) {{
  Launch p;
  cudaError_t err = make_launch(&p, blocks, offsets, nd, bs, X, Y, nullptr, false, k, k, ns, 1,
                                h, groups, ki, 2, max_blocks, 2);
  if (err != cudaSuccess) return err;
  p.stages = stages;
  if (bs > 4 || ki != 6 || !tma_launch_ok(&p, blocks, stages)) return cudaErrorInvalidValue;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (probe) {{
{cases}    default: return cudaErrorInvalidValue;
  }}
}}
"""
BT_PROBES = ((0, "as built"), (1, "no arithmetic"), (3, "no arithmetic, no far X"),
             (5, "no arithmetic, no coefficients"), (9, "no arithmetic, no window"),
             (15, "no arithmetic, no copies"))


def _probe_lib(src: str, name: str, tmp: Path):
    import ctypes
    import subprocess

    from blockcg_tpu_torch.ops import _native

    probe = tmp / f"{name}.cu"
    probe.write_text(src)
    lib = tmp / f"lib{name}.so"
    built = subprocess.run([_native.nvcc(), *_native.NVCC_FLAGS, "-shared", str(probe), "-o",
                            str(lib)], capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{built.stdout}{built.stderr}")
    return getattr(ctypes.CDLL(str(lib)), name)


def row2_wide_variants(torch, dev):
    """Row 2 at (32, 256^3) (config 5's f32 route cut to one
    ``stencil_mma_f32`` launch) on each (h, T) of ``stencil_mma_f32`` that
    fits the card, the plan's marked; then at (32, 256^3) and (32, 128^3)
    the routes a plan could take: the fused launch (``stencil_mma_f32``) and
    the SpMM (``stencil_spmm_t``) followed by ``gram`` on X and the stored
    Y; each with its bound, checksums and one line of its G's distance from
    the f64 Gram of X and Y."""
    import ctypes

    from blockcg_tpu_torch.ops import _native, fused, stencil
    from blockcg_tpu_torch.problems import laplacian_dia

    idx, p = dev.index, _native.ptr
    cap, sms = _native.max_smem(idx), _native.sm_count(idx)
    gen = torch.Generator(device=dev).manual_seed(0)

    def bound(k, n, nd, nnz):
        return max((4 * nd * n + 8 * k * n + 4 * k * k) / 3.35e12,
                   (2 * k * nnz + 2 * k * k * n) / 67e12) * 1e6

    k = 32
    lap = laplacian_dia((256,) * 3, device=dev)
    n, nd = lap.n, len(lap.offsets)
    nnz = int(torch.count_nonzero(lap.diags))
    coffs = (ctypes.c_int * nd)(*(int(o) % n for o in lap.offsets))
    dist = sorted({min(o % n, n - o % n) for o in lap.offsets})
    X = torch.randn((k, n), generator=gen, device=dev)
    plan = stencil.stencil_mma_f32_plan(tuple(lap.offsets), n, k, cap, sms, 4)
    Y = torch.empty_like(X)
    G = torch.empty((k, k), device=dev)
    part = torch.empty((_native.MAX_BLOCKS, k, k), device=dev)
    for T in stencil.MMA_F32_TILES:
        for h in sorted({0} | {-(-d // 4) * 4 for d in dist}):
            if stencil.mma_f32_smem_bytes(k, nd, h, T) + stencil.MMA_STATIC_BYTES > cap:
                continue
            mark = " (plan)" if (h, T) == (plan.h, plan.T) else ""
            yield (f"variant row 2 stencil_mma_f32 h={h} T={T}{mark} ({k}, 256^3)",
                   lambda h=h, T=T: (_native.launch(
                       "variant", "bcg_stencil_spmm", dev, p(lap.diags), coffs, nd, p(X),
                       p(Y), p(part), p(G), k, n, h, T,
                       min(-(-n // T), _native.MAX_BLOCKS)), Y, G)[1:],
                   bound(k, n, nd, nnz))
    del X, Y, G, part, lap
    for edge in (256, 128):
        lap = laplacian_dia((edge,) * 3, device=dev)
        n, nd = lap.n, len(lap.offsets)
        nnz = int(torch.count_nonzero(lap.diags))
        X = torch.randn((k, n), generator=gen, device=dev)
        D, o = lap.diags, lap.offsets
        routes = {"fused": lambda D=D, o=o, X=X: stencil.stencil_spmm_gram_t(D, o, X),
                  "spmm then gram.cu": lambda D=D, o=o, X=X: (lambda Y: (Y, fused.gram(X, Y)))(
                      stencil.stencil_spmm_t(D, o, X))}
        shape = f"({k}, {edge}^3)"
        for what, fn in routes.items():
            Yr, Gr = fn()
            G64 = X.double() @ Yr.double().T
            print(json.dumps({"case": f"variant row 2 {what} {shape} gram contract distance",
                              "dist": float(torch.linalg.norm(Gr.double() - G64)
                                            / torch.linalg.norm(G64))}), flush=True)
            del Yr, Gr, G64
            yield f"variant row 2 {what} {shape}", fn, bound(k, n, nd, nnz)
        del X, lap, routes


# Probe builds of row 2 at 64 rows (csrc/stencil.cu launch_vec_gram<float,
# F>, exported by a source that includes it): the f32 Gram tiles flushed to
# the double sums every F tiles, for each F of VEC_GRAM_FLUSHES.
VG_PROBE = r"""#include "{src}"
extern "C" int vg_probe(const float* diags, const int* offsets, int ndiag, const float* X,
                        float* Y, double* part, float* G, int k, long long n, int h, int T,
                        int max_blocks, int flush, int device, cudaStream_t stream) {{
  Diags dg{{}};
  if (k <= kStMmaF32MaxK || k > 64 || !make_diags(&dg, offsets, ndiag, n, h))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (flush) {{
{cases}    default: return cudaErrorInvalidValue;
  }}
}}
"""
VEC_GRAM_FLUSHES = (1, 2, 4, 8, 16)  # tiles a block's f32 Gram tiles sum before a flush


def vec_gram_variants(torch, dev, tmp: Path):
    """Row 2 at 64 rows on ``stencil_vec_gram`` (``csrc/stencil.cu``) built
    with each flush interval F of ``VEC_GRAM_FLUSHES`` (``VG_PROBE``), the
    one the library is built with (``stencil.VEC_GRAM_FLUSH``) marked: first
    one line per F of G's distance from the f64 Gram of X and the f32 sums
    at (64, 64^3) and (64, 128^3) on the on-card test's X, then the launch
    at (64, 256^3) with its bound."""
    import ctypes

    from blockcg_tpu_torch.ops import _native, stencil
    from blockcg_tpu_torch.problems import laplacian_dia

    idx, p = dev.index, _native.ptr
    cap, sms = _native.max_smem(idx), _native.sm_count(idx)
    stream = torch.cuda.current_stream(dev).cuda_stream
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cases = "".join(f"    case {f}: return launch_vec_gram<float, {f}>(diags, dg, ndiag, X, Y, "
                    "part, G, k, n, h, T, max_blocks, device, stream);\n"
                    for f in VEC_GRAM_FLUSHES)
    probe = _probe_lib(VG_PROBE.format(src=_native.CSRC / "stencil.cu", cases=cases), "vg_probe",
                       tmp)
    probe.argtypes = [P, ctypes.POINTER(I), I, P, P, P, P, I, L, I, I, I, I, I, P]
    probe.restype = I

    def launcher(lap, X, flush):
        n, nd = lap.n, len(lap.offsets)
        plan = stencil.stencil_vec_gram_plan(tuple(lap.offsets), n, 64, cap, sms, 4)
        grid = min(-(-n // plan.T), plan.blocks_per_sm * sms)
        part = torch.empty((grid, 64, 64), dtype=torch.float64, device=dev)
        Y, G = torch.empty_like(X), torch.empty((64, 64), device=dev)
        offs = (ctypes.c_int * nd)(*(int(o) % n for o in lap.offsets))

        def run():
            rc = probe(p(lap.diags), offs, nd, p(X), p(Y), p(part), p(G), 64, n, plan.h, plan.T,
                       grid, flush, idx, stream)
            if rc != 0:
                raise RuntimeError(f"vec_gram probe F={flush} failed: {rc}")
            return Y, G
        return run

    for edge in (64, 128):
        lap = laplacian_dia((edge,) * 3, device=dev)
        X = torch.as_tensor(np.random.default_rng(2240 + edge).standard_normal((64, lap.n)),
                            dtype=torch.float32, device=dev)
        for flush in VEC_GRAM_FLUSHES:
            Y, G = launcher(lap, X, flush)()
            G64 = X.double() @ Y.double().T
            print(json.dumps({"case": f"variant row 2 vec_gram F={flush} (64, {edge}^3) gram "
                                      "contract distance",
                              "dist": float(torch.linalg.norm(G.double() - G64)
                                            / torch.linalg.norm(G64)),
                              "checksums": checksums(torch, (Y,))}), flush=True)
        del lap, X, Y, G, G64
    lap = laplacian_dia((256,) * 3, device=dev)
    n, nd = lap.n, len(lap.offsets)
    nnz = int(torch.count_nonzero(lap.diags))
    X = torch.randn((64, n), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    bnd = max((4 * nd * n + 8 * 64 * n + 4 * 64 * 64) / 3.35e12,
              (2 * 64 * nnz + 2 * 64 * 64 * n) / 67e12) * 1e6
    for flush in VEC_GRAM_FLUSHES:
        mark = " (built)" if flush == stencil.VEC_GRAM_FLUSH else ""
        yield f"variant row 2 vec_gram F={flush}{mark} (64, 256^3)", launcher(lap, X, flush), bnd


def storage_variants(torch, dev, tmp: Path, only: str | None = None):
    """Row 2 at (32, 256^3) on ``row2_wide_variants`` and at 64 rows on
    ``vec_gram_variants``; rows 2m and 2 at (32,
    128^3) on each (h, T) of ``stencil_mma_f32`` that fits the card, the
    plan's marked, then row 2m on its plan in the probe builds of
    ``F32_PROBES``; row 23h on ``dirac_gauged_matrix(32)`` at k = 12 on each
    ring depth and split of ``bs_tma``'s schedule that fits, the plan's
    marked, then in the probe builds of ``BT_PROBES``; each with its bound
    (``storage_cases``) and checksums. ``only`` skips the groups none of
    whose cases it matches."""
    import ctypes

    from blockcg_tpu_torch.ops import _native, stencil
    from blockcg_tpu_torch.ops import block_stencil as bsk
    from blockcg_tpu_torch.problems import dirac_gauged_matrix, laplacian_dia

    idx, p = dev.index, _native.ptr
    cap, sms = _native.max_smem(idx), _native.sm_count(idx)
    stream = torch.cuda.current_stream(dev).cuda_stream
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    IP = ctypes.POINTER(ctypes.c_int)

    def wanted(*words):
        return only is None or any(re.search(only, w) for w in words)
    if wanted("variant row 2 stencil_mma_f32 (32, 256^3)", "variant row 2 fused (32, 256^3)",
              "variant row 2 spmm then gram.cu (32, 256^3)"):
        yield from row2_wide_variants(torch, dev)
    if wanted("variant row 2 vec_gram F=1 (64, 256^3)"):
        yield from vec_gram_variants(torch, dev, tmp)
    if not wanted("variant row 2m (32, 128^3)", "variant row 2 stencil_mma_f32 (32, 128^3)",
                  "probe row 2m", "row 23h plan", "variant row 23h", "probe row 23h"):
        return
    gen = torch.Generator(device=dev).manual_seed(0)
    k = 32
    lap = laplacian_dia((128,) * 3, device=dev)
    n, nd = lap.n, len(lap.offsets)
    nnz = int(torch.count_nonzero(lap.diags))
    X = torch.randn((k, n), generator=gen, device=dev)
    Y = torch.empty_like(X)
    G = torch.empty((k, k), device=dev)
    part = torch.empty((_native.MAX_BLOCKS, k, k), device=dev)
    coffs = (ctypes.c_int * nd)(*(int(o) % n for o in lap.offsets))
    dist = sorted({min(o % n, n - o % n) for o in lap.offsets})
    for D, row in ((lap.diags.bfloat16(), "2m"), (lap.diags, "2")):
        fn = "bcg_stencil_spmm_bf16d" if row == "2m" else "bcg_stencil_spmm"
        bnd = max((D.element_size() * nd * n + 8 * k * n + 4 * k * k) / 3.35e12,
                  (2 * k * nnz + 2 * k * k * n) / 67e12) * 1e6
        plan = stencil.stencil_mma_f32_plan(tuple(lap.offsets), n, k, cap, sms, D.element_size())
        for T in stencil.MMA_TILES:
            for h in sorted({0} | {-(-d // 4) * 4 for d in dist}):
                if (T > max(128, n // sms) or stencil.mma_f32_smem_bytes(
                        k, nd, h, T, D.element_size()) + stencil.MMA_STATIC_BYTES > cap):
                    continue
                mark = " (plan)" if (h, T) == (plan.h, plan.T) else ""
                yield (f"variant row {row} stencil_mma_f32 h={h} T={T}{mark} (32, 128^3)",
                       lambda D=D, fn=fn, h=h, T=T: (_native.launch(
                           "variant", fn, dev, p(D), coffs, nd, p(X), p(Y), p(part), p(G), k, n,
                           h, T, min(-(-n // T), _native.MAX_BLOCKS)), Y, G)[1:], bnd)
    cases = "".join(f"    case {v}: return launch_mma_f32<bf16, 32, {v}>(diags, dg, ndiag, X, Y, "
                    "part, G, k, n, h, T, max_blocks, device, stream);\n" for v, _ in F32_PROBES)
    fn = _probe_lib(F32_PROBE.format(src=_native.CSRC / "stencil.cu", cases=cases), "f32_probe",
                    tmp)
    fn.argtypes, fn.restype = [P, IP, I, P, P, P, P, I, L, I, I, I, I, I, P], I
    D = lap.diags.bfloat16()
    plan = stencil.stencil_mma_f32_plan(tuple(lap.offsets), n, k, cap, sms, 2)
    for v, what in F32_PROBES:
        def run(v=v):
            rc = fn(D.data_ptr(), coffs, nd, X.data_ptr(), Y.data_ptr(), part.data_ptr(),
                    G.data_ptr(), k, n, plan.h, plan.T, min(-(-n // plan.T), _native.MAX_BLOCKS),
                    v, idx, stream)
            if rc != 0:
                raise RuntimeError(f"f32 stencil probe {v} failed: {rc}")
            return Y, G
        yield (f"probe row 2m stencil_mma_f32 {what} h={plan.h} T={plan.T} (32, 128^3)", run,
               None)
    del X, Y, lap, D
    op = dirac_gauged_matrix(32, m=0.5, device=dev)
    k = 12
    b16, offs = op.blocks.bfloat16(), tuple(int(o) % op.blocks.shape[-1] for o in op.offsets)
    del op
    nd, bs, _, ns = b16.shape
    m = bs * k
    Xm = torch.randn((m, ns), generator=gen, device=dev)
    Ym = torch.empty_like(Xm)
    boffs = (ctypes.c_int * nd)(*offs)
    bnd = max((b16.numel() * 2 + 8 * m * ns) / 3.35e12,
              2 * k * int(torch.count_nonzero(b16)) / 67e12) * 1e6
    plan = bsk.block_stencil_plan(offs, ns, bs, k, False, cap, sms, csize=2, tma=True)
    for kw in ({},) + tuple({"stages": s} for s in bsk.TMA_STAGES) + (
            {"groups": 1, "h": 0}, {"groups": 4}, {"h": 0}):
        vplan = bsk.block_stencil_plan(offs, ns, bs, k, False, cap, sms, csize=2, tma=True, **kw)
        if not vplan.tma or (kw and vplan == plan):
            continue

        def run(vplan=vplan):
            _native.launch("variant", "bcg_block_stencil_tma", dev, p(b16), 2, boffs, None, nd,
                           bs, p(Xm), p(Ym), k, k, ns, 1, vplan.h, vplan.groups, vplan.ki,
                           vplan.stages, vplan.blocks)
            return Ym
        name = "row 23h plan" if not kw else f"variant row 23h {kw}"
        yield f"{name} bs_tma (48, 32^4) [{vplan.describe()}]", run, bnd
    cases = "".join(f"    case {v}: return launch_tma<4, 6, bf16, false, {v}>(p, max_blocks, "
                    "device, stream);\n" for v, _ in BT_PROBES)
    fn = _probe_lib(BT_PROBE.format(src=_native.CSRC / "block_stencil.cu", cases=cases),
                    "bt_probe", tmp)
    fn.argtypes, fn.restype = [P, IP, I, I, P, P, I, L, I, I, I, I, I, I, I, P], I
    for v, what in BT_PROBES:
        def run(v=v):
            rc = fn(b16.data_ptr(), boffs, nd, bs, Xm.data_ptr(), Ym.data_ptr(), k, ns, plan.h,
                    plan.groups, plan.ki, plan.stages, plan.blocks, v, idx, stream)
            if rc != 0:
                raise RuntimeError(f"block-stencil TMA probe {v} failed: {rc}")
            return Ym
        yield f"probe row 23h bs_tma {what} (48, 32^4) [{plan.describe()}]", run, None


def bf16_variants(torch, dev):
    """Rows 5 and 6 in bf16 at (32, 256^3) on each (T, stages) of their TMA
    rings that fits the card, the plans' own marked, each with its bound."""
    from blockcg_tpu_torch.ops import _native, fused

    gen = torch.Generator(device=dev).manual_seed(0)
    k, n = 32, 256 ** 3
    idx, p = dev.index, _native.ptr
    cap, sms = _native.max_smem(idx), _native.sm_count(idx)
    U, V, A = (torch.randn((k, n), generator=gen, device=dev).bfloat16() for _ in range(3))
    M = torch.randn((k, k), generator=gen, device=dev) / k ** 0.5
    Y = torch.empty_like(U)
    part = torch.empty((sms, k, k), device=dev)
    G = torch.empty((k, k), device=dev)
    fb = 2 * k * n
    for same in (False, True):
        W = U if same else V
        rows = k if same else 2 * k
        plan = fused.gram_plan(k, k, same, n, cap, sms, 2)
        bound = max((rows * n * 2 + 4 * k * k) / 3.35e12,
                    (k * (k + 1) if same else 2 * k * k) * n / 989e12) * 1e6
        for T in fused.GRAM_TILES:
            for st in range(2, fused.RING_MAX_STAGES + 1):
                if fused.gram_mma_smem_bytes(k, k, same, T, st) + fused.RING_BARRIER_BYTES > cap:
                    continue
                mark = " (plan)" if (T, st) == (plan.T, plan.stages) else ""
                yield (f"variant row 5 gram[bf16] {'U is V ' if same else ''}T={T} stages={st}"
                       f"{mark} (32, 256^3)",
                       lambda W=W, T=T, st=st: (_native.launch(
                           "variant", "bcg_gram_bf16", dev, p(U), p(W), p(part), p(G), k, k, n,
                           T, st, sms), G)[1], bound)
    for a in (None, A):
        plan = fused.mm_update_mma_plan(k, n, a is not None, cap, sms)
        bound = max(((3 if a is not None else 2) * fb + 4 * k * k) / 3.35e12,
                    2 * k * k * n / 989e12) * 1e6
        for T in fused.MM_MMA_TILES:
            for st in range(2, fused.RING_MAX_STAGES + 1):
                if (fused.mm_update_mma_smem_bytes(k, T, st, a is not None)
                        + fused.RING_BARRIER_BYTES > cap):
                    continue
                mark = " (plan)" if (T, st) == (plan.T, plan.stages) else ""
                yield (f"variant row 6 mm_update[bf16] {'+A ' if a is not None else ''}T={T} "
                       f"stages={st}{mark} (32, 256^3)",
                       lambda a=a, T=T, st=st: (_native.launch(
                           "variant", "bcg_mm_update_bf16", dev, p(M), p(U), p(a), p(Y), k, n, T,
                           st), Y)[1], bound)


def bf16_mma_variants(torch, dev):
    """Rows 2, 7 and 8 in bf16 with their Grams on the tensor cores at
    (32, 256^3): the stencil (``stencil_mma``) on each (h, T) that fits the
    card at one block an SM, h one of the halos its plan weighs, and rows 7
    and 8 (``update_gram_mma``) on each (T, stages) that fits; the plans'
    own marked, each with its bound and checksums."""
    from blockcg_tpu_torch.ops import _native, fused, stencil
    from blockcg_tpu_torch.problems import laplacian_dia

    gen = torch.Generator(device=dev).manual_seed(0)
    k = 32
    op = laplacian_dia((256,) * 3, dtype=torch.bfloat16, device=dev)
    n, nd, p = op.n, len(op.offsets), _native.ptr
    idx = dev.index
    cap, sms = _native.max_smem(idx), _native.sm_count(idx)
    U, V = (torch.randn((k, n), generator=gen, device=dev).bfloat16() for _ in range(2))
    M, M2 = (torch.randn((k, k), generator=gen, device=dev) / k ** 0.5 for _ in range(2))
    Y = torch.empty_like(U)
    part = torch.empty((_native.nblocks(n), k, k), device=dev)
    G = torch.empty((k, k), device=dev)
    fb, kk = 2 * k * n, 4 * k * k
    nnz = int(torch.count_nonzero(op.diags))
    plan = stencil.stencil_mma_plan(tuple(op.offsets), n, k, cap, sms)
    offs = [int(o) % n for o in op.offsets]
    import ctypes
    carr = (ctypes.c_int * nd)(*offs)
    bound = max((2 * nd * n + 2 * fb + kk) / 3.35e12,
                (2 * k * nnz + 2 * k * k * n) / 989e12) * 1e6
    dist = [min(o, n - o) for o in offs]
    for T in stencil.MMA_TILES:
        for h in (8, 256):
            nst = min(sum(d > h for d in dist), stencil.MMA_MAX_STAGED)
            if stencil.mma_smem_bytes(k, nd, nst, h, T) + stencil.MMA_STATIC_BYTES > cap:
                continue
            mark = " (plan)" if (h, T) == (plan.h, plan.T) else ""
            yield (f"variant row 2 stencil_spmm_gram_t[bf16] h={h} T={T}{mark} (32, 256^3)",
                   lambda h=h, T=T: (_native.launch(
                       "variant", "bcg_stencil_spmm_bf16", dev, p(op.diags), carr, nd, p(U),
                       p(Y), p(part), p(G), k, n, h, T, _native.nblocks(n)), Y, G)[1:],
                   bound)
    W3 = torch.randn((k, n), generator=gen, device=dev).bfloat16()
    M3 = torch.randn((k, k), generator=gen, device=dev) / k ** 0.5
    Pn, Xn = torch.empty_like(U), torch.empty_like(U)
    pplan = fused.px_update_mma_plan(k, n, cap, sms)
    bound9 = max((5 * fb + 3 * kk) / 3.35e12, 18 * k * k * n / 989e12) * 1e6
    for T in fused.UPDATE_MMA_TILES:
        for st in range(2, fused.RING_MAX_STAGES + 1):
            if fused.px_update_mma_smem_bytes(k, T, st) + fused.RING_BARRIER_BYTES > cap:
                continue
            mark = " (plan)" if (T, st) == (pplan.T, pplan.stages) else ""
            yield (f"variant row 9 px_update[bf16] T={T} stages={st}{mark} (32, 256^3)",
                   lambda T=T, st=st: (_native.launch(
                       "variant", "bcg_px_update_mma", dev, p(M), p(U), p(M2), p(V), p(M3),
                       p(W3), p(Pn), p(Xn), k, n, T, st), Pn, Xn)[1:], bound9)
    for nf in (2, 1):
        mplan = fused.update_gram_mma_plan(k, n, nf, False, cap, sms)
        bound = max(((nf + 1) * fb + (nf + 1) * kk) / 3.35e12,
                    (2 * nf * k * k * n + k * (k + 1) * n) / 989e12) * 1e6
        row = "row 8 mm2_update_gram" if nf == 2 else "row 7 mm_update_gram"
        for T in fused.UPDATE_MMA_TILES:
            for st in range(2, fused.RING_MAX_STAGES + 1):
                if (fused.update_gram_mma_smem_bytes(k, T, st, nf, False)
                        + fused.RING_BARRIER_BYTES > cap):
                    continue
                mark = " (plan)" if (T, st) == (mplan.T, mplan.stages) else ""
                args = ((p(M), p(U), p(M2), p(V), p(Y)) if nf == 2
                        else (p(M), p(U), None, p(Y)))
                fn = "bcg_mm2_update_gram_mma" if nf == 2 else "bcg_mm_update_gram_mma"
                yield (f"variant {row}[bf16] T={T} stages={st}{mark} (32, 256^3)",
                       lambda args=args, fn=fn, T=T, st=st: (_native.launch(
                           "variant", fn, dev, *args, p(part), p(G), k, n, T, st,
                           _native.nblocks(n)), Y, G)[1:], bound)


# Probe builds of the bf16 stencil with its Gram on the tensor cores
# (csrc/stencil.cu stencil_mma<bf16, 32, PROBE>, exported by a source that
# includes it) on its plan at (32, 256^3): parts switched off, to see what
# its time is made of, and other counts of diagonals whose reads are in
# flight together (probe 100 + CH: stencil_mma<bf16, 32, 0, CH>).
SM_PROBE = r"""#include "{src}"
extern "C" int sm_probe(const bf16* diags, const int* offsets, int ndiag, const bf16* X, bf16* Y,
                        float* part, float* G, int k, long long n, int h, int T, int max_blocks,
                        int probe, int device, cudaStream_t stream) {{
  Diags dg{{}};
  if (k <= 16 || k > 32 || !make_diags(&dg, offsets, ndiag, n, h)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (probe) {{
{cases}    default: return cudaErrorInvalidValue;
  }}
}}
"""
SM_PROBES = ((0, "as built"), (1, "no far X"), (2, "no Gram"), (4, "no Y stores"),
             (8, "no window refills"), (6, "no Gram, no Y stores"),
             (7, "no far X, no Gram, no Y stores"), (15, "nothing but the near SpMM"),
             (102, "reads of 2 diagonals in flight"), (104, "reads of 4 diagonals in flight"),
             (108, "reads of 8 diagonals in flight"))


def sm_probe_cases(torch, dev, tmp: Path):
    """Row 2 in bf16 at (32, 256^3) on its plan in the probe builds of
    ``SM_PROBES``."""
    import ctypes
    import subprocess

    from blockcg_tpu_torch.ops import _native, stencil
    from blockcg_tpu_torch.problems import laplacian_dia

    probe = tmp / "sm_probe.cu"
    cases = "".join(f"    case {v}: return launch_mma<bf16, 32, {v if v < 100 else 0}"
                    f"{', ' + str(v - 100) if v >= 100 else ''}>(diags, dg, ndiag, X, Y, part, "
                    "G, k, n, h, T, max_blocks, device, stream);\n" for v, _ in SM_PROBES)
    probe.write_text(SM_PROBE.format(src=_native.CSRC / "stencil.cu", cases=cases))
    lib = tmp / "libsmprobe.so"
    built = subprocess.run([_native.nvcc(), *_native.NVCC_FLAGS, "-shared", str(probe), "-o",
                            str(lib)], capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"nvcc failed on the stencil probe:\n{built.stdout}{built.stderr}")
    fn = ctypes.CDLL(str(lib)).sm_probe
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes, fn.restype = [P, ctypes.POINTER(ctypes.c_int), I, P, P, P, P, I, L, I, I, I, I,
                               I, P], I
    gen = torch.Generator(device=dev).manual_seed(0)
    k = 32
    op = laplacian_dia((256,) * 3, dtype=torch.bfloat16, device=dev)
    n, nd = op.n, len(op.offsets)
    idx = dev.index
    plan = stencil.stencil_mma_plan(tuple(op.offsets), n, k, _native.max_smem(idx),
                                    _native.sm_count(idx))
    U = torch.randn((k, n), generator=gen, device=dev).bfloat16()
    Y = torch.empty_like(U)
    part = torch.empty((_native.nblocks(n), k, k), device=dev)
    G = torch.empty((k, k), device=dev)
    coffs = (ctypes.c_int * nd)(*(int(o) % n for o in op.offsets))
    stream = torch.cuda.current_stream(dev).cuda_stream
    for v, what in SM_PROBES:
        def run(v=v):
            rc = fn(op.diags.data_ptr(), coffs, nd, U.data_ptr(), Y.data_ptr(), part.data_ptr(),
                    G.data_ptr(), k, n, plan.h, plan.T, _native.nblocks(n), v, idx, stream)
            if rc != 0:
                raise RuntimeError(f"stencil probe {v} failed: {rc}")
            return Y, G
        yield f"probe row 2 stencil_spmm_gram_t[bf16] {what} h={plan.h} T={plan.T} (32, 256^3)", \
            run, None


# Probe builds of row 2w, the bf16 stencil's Gram above 64 rows in column
# blocks (csrc/stencil.cu stencil_mma_cols<bf16, PROBE>, exported by a source
# that includes it), on its plans at (96, 128^3): parts switched off.
COLS_PROBE = r"""#include "{src}"
extern "C" int cols_probe(const bf16* diags, const int* offsets, int ndiag, const bf16* X,
                          const bf16* Xa, bf16* Y, float* part, float* G, int k, int ga, int own,
                          long long n, int h, int T, int max_blocks, int probe, int device,
                          cudaStream_t stream) {{
  Diags dg{{}};
  if (!make_diags(&dg, offsets, ndiag, n, h)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (probe) {{
{cases}    default: return cudaErrorInvalidValue;
  }}
}}
"""
COLS_PROBES = ((0, "as built"), (1, "no Gram"), (4, "no SpMM"), (5, "no SpMM, no Gram"),
               (2, "no centre copy"), (16, "no wait for the centre copy"),
               (8, "no refills"), (13, "no refills, no SpMM, no Gram"),
               (32, "one mma.sync chain through a tile"))


def cols_probe_cases(torch, dev, tmp: Path):
    """Row 2w at (96, 128^3) on its plans in the probe builds of
    ``COLS_PROBES``: both column-block launches a call. The builds that
    compute all of G (as built, and the one chain of mma.sync sums through
    a tile) first print their Gram's relative Frobenius distance from the
    f64 Gram of X and the f32 sums, its contract."""
    import ctypes
    import subprocess

    from blockcg_tpu_torch.ops import _native, stencil
    from blockcg_tpu_torch.problems import laplacian_dia

    probe = tmp / "cols_probe.cu"
    cases = "".join(f"    case {v}: return launch_mma_cols<bf16, 3, {v}>(diags, dg, ndiag, X, "
                    "Xa, Y, "
                    "part, G, k, ga, own, n, h, T, max_blocks, device, stream);\n"
                    for v, _ in COLS_PROBES)
    probe.write_text(COLS_PROBE.format(src=_native.CSRC / "stencil.cu", cases=cases))
    lib = tmp / "libcolsprobe.so"
    built = subprocess.run([_native.nvcc(), *_native.NVCC_FLAGS, "-shared", str(probe), "-o",
                            str(lib)], capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"nvcc failed on the column-block probe:\n{built.stdout}{built.stderr}")
    fn = ctypes.CDLL(str(lib)).cols_probe
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes, fn.restype = [P, ctypes.POINTER(ctypes.c_int), I, P, P, P, P, P, I, I, I, L, I,
                               I, I, I, I, P], I
    gen = torch.Generator(device=dev).manual_seed(0)
    k = 96
    op = laplacian_dia((128,) * 3, dtype=torch.bfloat16, device=dev)
    n, nd, idx = op.n, len(op.offsets), dev.index
    cap, sms = _native.max_smem(idx), _native.sm_count(idx)
    X = torch.randn((k, n), generator=gen, device=dev).bfloat16()
    Y = torch.empty_like(X)
    coffs = (ctypes.c_int * nd)(*(int(o) % n for o in op.offsets))
    stream = torch.cuda.current_stream(dev).cuda_stream
    launches = []
    for r0, r1, a0, a1 in stencil.wide_gram_launches(k):
        own = r0 - a0 if a0 <= r0 < a1 else -1
        plan = stencil.stencil_mma_plan(tuple(op.offsets), n, r1 - r0, cap, sms, 2, a1 - a0,
                                        own >= 0)
        mb = min(-(-n // plan.T), _native.MAX_BLOCKS)
        part = torch.empty((mb, a1 - a0, r1 - r0), device=dev)
        G = torch.empty((a1 - a0, r1 - r0), device=dev)
        launches.append((r0, r1, a0, a1, own, plan, mb, part, G))
    S = stencil.stencil_spmm_t(op.diags.float(), op.offsets, X.float())
    G64 = X.double() @ S.double().T
    del S
    Gfull = torch.empty((k, k), dtype=torch.float64, device=dev)
    for v, what in COLS_PROBES:
        def run(v=v):
            for r0, r1, a0, a1, own, plan, mb, part, G in launches:
                rc = fn(op.diags.data_ptr(), coffs, nd, X[r0:r1].data_ptr(),
                        X[a0:a1].data_ptr(), Y[r0:r1].data_ptr(), part.data_ptr(),
                        G.data_ptr(), r1 - r0, a1 - a0, own, n, plan.h, plan.T, mb, v, idx,
                        stream)
                if rc != 0:
                    raise RuntimeError(f"column-block probe {v} failed: {rc}")
            return Y
        plan = launches[0][5]
        if v in (0, 32):
            run()
            for r0, r1, a0, a1, *_, G in launches:
                Gfull[a0:a1, r0:r1] = G
            err = float(torch.linalg.norm(Gfull - G64) / torch.linalg.norm(G64))
            print(json.dumps({"case": f"probe row 2w {what} (96, 128^3)",
                              "gram_contract_distance": err}), flush=True)
        yield (f"probe row 2w stencil_spmm_gram_t[bf16, wide] {what} h={plan.h} T={plan.T} "
               "(96, 128^3)", run, None)


def bound_us(name: str) -> float | None:
    """The least device time of a row 5-9 case (max of its bytes over 3.35
    TB/s and its FLOPs over 67 TFLOP/s, chip_smoke.py's rates) from the
    shape in its name, for the dense k x k coefficients the cases use: each
    input field read once, each output written once; Y = M B is 2 k^2 FLOPs
    a column, a symmetric Gram Y Y^T k (k + 1) (its upper triangle), U V^T
    2 ku kv. The block stencil's cases carry their own bound."""
    g = re.match(r"row 5 gram (U is V |(\d+) x (\d+) )?\((\d+), (\d+)\^(\d+)\)$", name)
    if g is not None:
        k, n = int(g.group(4)), int(g.group(5)) ** int(g.group(6))
        same = g.group(1) == "U is V "
        ku, kv = (int(g.group(2)), int(g.group(3))) if g.group(2) else (k, k)
        nbytes = 4 * ((ku if same else ku + kv) * n + ku * kv)
        flops = ku * (ku + 1) * n if same else 2 * ku * kv * n
        return max(nbytes / 3.35e12, flops / 67e12) * 1e6
    m = re.match(r"row ([6-9]) \S+ (\+A )?\((\d+), (\d+)\^(\d+)\)$", name)
    if m is None:
        return None
    row, with_a = int(m.group(1)), m.group(2) is not None
    k, n = int(m.group(3)), int(m.group(4)) ** int(m.group(5))
    fields, tables, gram = {6: (2 + with_a, 1, False), 7: (2 + with_a, 1, True),
                            8: (3, 2, True), 9: (5, 3, False)}[row]
    nbytes = 4 * (fields * k * n + tables * k * k + gram * k * k)
    flops = 2 * tables * k * k * n + gram * k * (k + 1) * n
    return max(nbytes / 3.35e12, flops / 67e12) * 1e6


def row7(fused, what, M, B, A):
    """Row 7 on fresh outputs: Y = M B (+ A) with its Gram."""
    yield f"row 7 mm_update_gram {what}", lambda: fused.mm_update_gram(M, B)
    yield f"row 7 mm_update_gram +A {what}", lambda: fused.mm_update_gram(M, B, A)


def block_operators(torch, dev):
    """``dirac_gauged_matrix(32)`` and the realified complex core (bs = 8):
    (label, blocks, offsets, k) of each, with the operator's offsets."""
    from blockcg_tpu_torch.operators import realify
    from blockcg_tpu_torch.problems import dirac_gauged_matrix

    op = dirac_gauged_matrix(32, m=0.5, device=dev)
    yield "dirac_gauged_matrix(32)", op.blocks, op.offsets, 12
    del op
    core = realify(dirac_gauged_matrix(32, dtype=torch.complex64, device=dev)).real_op
    yield "realified core", core.blocks, core.offsets, 6


def block_work(blocks, k: int, gram: bool) -> float:
    """bound_us of a block-stencil apply: the blocks, X and Y once (and G);
    2 k FLOPs a nonzero coefficient (and 2 m^2 a site for G = X Y^T)."""
    import torch

    _, bs, _, ns = blocks.shape
    m = bs * k
    nbytes = 4 * (blocks.numel() + 2 * m * ns + gram * m * m)
    flops = 2 * k * int(torch.count_nonzero(blocks)) + gram * 2 * m * m * ns
    return max(nbytes / 3.35e12, flops / 67e12) * 1e6


def block_stencil_cases(torch, dev, library: bool):
    """Rows 22 ((k, bs, ns) view), 23 (merged) and 23b (merged with its Gram)
    on each of ``block_operators``; or torch's BSR product of the same
    blocks (row 23's function)."""
    from blockcg_tpu_torch.ops import block_stencil as bsk

    gen = torch.Generator(device=dev).manual_seed(3)
    for label, blocks, offsets, k in block_operators(torch, dev):
        _, bs, _, ns = blocks.shape
        Xm = torch.randn((bs * k, ns), generator=gen, device=dev)
        Xv = torch.randn((k, bs, ns), generator=gen, device=dev)
        what = f"{label} (k={k}, bs={bs})"
        if library:
            sites = torch.arange(ns, device=dev)
            cols = torch.stack([(sites + o) % ns for o in offsets], dim=1)
            order = torch.argsort(cols, dim=1)
            vals = blocks.permute(3, 0, 1, 2)[sites[:, None], order]
            A = torch.sparse_bsr_tensor(torch.arange(0, (ns + 1) * len(offsets), len(offsets),
                                                     device=dev),
                                        cols.gather(1, order).reshape(-1),
                                        vals.reshape(-1, bs, bs).contiguous(),
                                        size=(ns * bs, ns * bs))
            Xs = Xm.reshape(bs, k, ns).permute(2, 0, 1).reshape(ns * bs, k).contiguous()
            del vals, cols, order
            yield f"library BSR @ dense {what}", lambda A=A, Xs=Xs: A @ Xs
            continue
        plain, gram = block_work(blocks, k, False), block_work(blocks, k, True)
        yield (f"row 22 block_stencil_spmm_t {what}",
               lambda b=blocks, o=offsets, X=Xv: bsk.block_stencil_spmm_t(b, o, X), plain)
        yield (f"row 23 block_stencil_spmm_m_t {what}",
               lambda b=blocks, o=offsets, X=Xm: bsk.block_stencil_spmm_m_t(b, o, X), plain)
        yield (f"row 23b block_stencil_spmm_m_gram_t {what}",
               lambda b=blocks, o=offsets, X=Xm: bsk.block_stencil_spmm_m_gram_t(b, o, X), gram)
        del Xm, Xv


# Probe builds of the Gram (csrc/gram.cu gram_kernel<KMAX, SYM, TS, MINB,
# ST>, f32 fields) beside the built kernels: 4x4 register tiles built for two blocks an
# SM, and a ring of three tiles.
GRAM_PROBE = r"""#include "{src}"
extern "C" int gram_probe(const float* U, const float* V, float* part, float* G, int ku, int kv,
                          long long n, int T, int max_blocks, int which, int device,
                          cudaStream_t stream) {{
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (which) {{
{cases}    default: return cudaErrorInvalidValue;
  }}
}}
"""
# which: (label, template arguments, rows, U is V)
GRAM_PROBES = {0: ("4x4 tiles, two blocks an SM", "32, false, 4, 2", 32, False),
               1: ("4x4 tiles, two blocks an SM", "32, true, 4, 2", 32, True),
               2: ("three tiles in shared memory", "32, false, 8, 1, 3", 32, False),
               3: ("three tiles in shared memory", "32, true, 4, 1, 3", 32, True),
               4: ("three tiles in shared memory", "96, false, 6, 1, 3", 96, False)}


def gram_variants(torch, dev, tmp: Path):
    """Row 5 at (32, 128^3), (48, 32^4) and (96, 32^4), U != V and U is V:
    the plan's column tile, the built kernel on other tiles that fit, and
    the probe builds of ``GRAM_PROBES`` (4x4 tiles on a grid of 2 x SMs)."""
    import ctypes
    import subprocess

    from blockcg_tpu_torch.ops import _native, fused

    probe = tmp / "gram_probe.cu"
    cases = "".join(f"    case {w}: return launch<{args}>(U, V, part, G, ku, kv, n, T, "
                    "max_blocks, device, stream);\n" for w, (_, args, _, _) in GRAM_PROBES.items())
    probe.write_text(GRAM_PROBE.format(src=_native.CSRC / "gram.cu", cases=cases))
    lib = tmp / "libgramprobe.so"
    built = subprocess.run([_native.nvcc(), *_native.NVCC_FLAGS, "-shared", str(probe), "-o",
                            str(lib)], capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"nvcc failed on the gram probe:\n{built.stdout}{built.stderr}")
    fn = ctypes.CDLL(str(lib)).gram_probe
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes, fn.restype = [P, P, P, P, I, I, L, I, I, I, I, P], I
    gen = torch.Generator(device=dev).manual_seed(0)
    sms, cap, p = _native.sm_count(dev.index), _native.max_smem(dev.index), _native.ptr
    stream = torch.cuda.current_stream(dev).cuda_stream
    for k, n, shape, sames in ((32, 128 ** 3, "(32, 128^3)", (False, True)),
                               (48, 32 ** 4, "(48, 32^4)", (False, True)),
                               (96, 32 ** 4, "(96, 32^4)", (False, True))):
        U, V = (torch.randn((k, n), generator=gen, device=dev) for _ in range(2))
        part = torch.empty((2 * sms, k, k), device=dev)
        G = torch.empty((k, k), device=dev)
        for same in sames:
            B = U if same else V
            what = f"{'U is V ' if same else ''}{shape}"
            yield f"row 5 gram {what}", lambda B=B, U=U: fused.gram(U, B)
            for T in (128, 256, 512):
                if fused.gram_smem_bytes(k if same else 2 * k, T, same) <= cap:
                    yield (f"variant row 5 T={T} {what}",
                           lambda B=B, U=U, T=T, part=part, G=G, k=k, n=n: (_native.launch(
                               "variant", "bcg_gram", dev, p(U), p(B), p(part), p(G), k, k, n,
                               T, sms), G)[1])
                for w, (label, _, rows, psame) in GRAM_PROBES.items():
                    if rows != k or psame != same:
                        continue
                    grid = 2 * sms if "two blocks" in label else sms
                    st = 3 if "three tiles" in label else fused.GRAM_STAGES
                    if st * (k if same else 2 * k) * (T + (8 if same else 4)) * 4 > cap:
                        continue

                    def run(B=B, U=U, T=T, part=part, G=G, k=k, n=n, w=w, grid=grid):
                        rc = fn(p(U), p(B), p(part), p(G), k, k, n, T, grid, w, dev.index,
                                stream)
                        if rc != 0:
                            raise RuntimeError(f"gram probe {w} failed: {rc}")
                        return G
                    yield f"variant row 5 {label}, T={T} {what}", run
        del U, V


# Probe builds of the block stencil (csrc/block_stencil.cu bs_spmm<4, 6,
# false, PROBE, PW>, exported by a source that includes it) on row 23's plan
# at m = 48: parts of the kernel switched off, to see what its time is made
# of, and other counts of producer warps.
BS_PROBE = r"""#include "{src}"
extern "C" int bs_probe(const float* blocks, const int* offsets, int nd, int bs, const float* X,
                        float* Y, int k, long long ns, int h, int groups, int ki, int stages,
                        int max_blocks, int probe, int device, cudaStream_t stream) {{
  Launch p;
  cudaError_t err = make_launch(&p, blocks, offsets, nd, bs, X, Y, nullptr, false, k, k, ns, 1,
                                h, groups, ki, stages, max_blocks);
  if (err != cudaSuccess) return err;
  if (bs > 4 || ki != 6) return cudaErrorInvalidValue;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (probe) {{
{cases}    default: return cudaErrorInvalidValue;
  }}
}}
"""
BS_PROBES = ((0, "as built", "0"), (1, "no arithmetic", "1"),
             (3, "no arithmetic, no far X", "3"), (5, "no arithmetic, no coefficients", "5"),
             (9, "no arithmetic, no window", "9"), (15, "no arithmetic, no copies", "15"),
             (104, "4 producer warps", "0, 4"), (112, "12 producer warps", "0, 12"),
             (113, "12 producer warps, no arithmetic", "1, 12"))


def bs_probe_cases(torch, dev, tmp: Path, label, blocks, offsets, k, plan, Xm):
    import ctypes
    import subprocess

    from blockcg_tpu_torch.ops import _native

    probe = tmp / "bs_probe.cu"
    cases = "".join(f"    case {v}: return launch<4, 6, false, {args}>(p, nullptr, max_blocks, "
                    "device, stream);\n" for v, _, args in BS_PROBES)
    probe.write_text(BS_PROBE.format(src=_native.CSRC / "block_stencil.cu", cases=cases))
    lib = tmp / "libbsprobe.so"
    built = subprocess.run([_native.nvcc(), *_native.NVCC_FLAGS, "-shared", str(probe), "-o",
                            str(lib)], capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"nvcc failed on the block-stencil probe:\n{built.stdout}{built.stderr}")
    fn = ctypes.CDLL(str(lib)).bs_probe
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes, fn.restype = [P, ctypes.POINTER(ctypes.c_int), I, I, P, P, I, L, I, I, I, I,
                               I, I, I, P], I
    nd, bs, _, ns = blocks.shape
    coffs = (ctypes.c_int * nd)(*(int(o) % ns for o in offsets))
    stream = torch.cuda.current_stream(dev).cuda_stream
    Y = torch.empty_like(Xm)
    for v, what, _ in BS_PROBES:
        def run(v=v):
            rc = fn(blocks.data_ptr(), coffs, nd, bs, Xm.data_ptr(), Y.data_ptr(), k, ns, plan.h,
                    plan.groups, plan.ki, plan.stages, plan.blocks, v, dev.index, stream)
            if rc != 0:
                raise RuntimeError(f"block-stencil probe {v} failed: {rc}")
            return Y
        yield f"probe row 23 {what} {label} k={k} [{plan.describe()}]", run, None


# Block-stencil schedules timed beside the plan (block_stencil_plan's pins):
# no window; each split of a site's RHS (which sets the tile); each depth.
BS_VARIANTS = ({"h": 0}, {"groups": 1, "h": 0}, {"groups": 4}, {"groups": 8}, {"stages": 2},
               {"stages": 3})


def bs_variants(torch, dev, tmp: Path):
    """Rows 23 and 23b on ``dirac_gauged_matrix(32)`` at k = 12 under the
    plan and each of ``BS_VARIANTS`` (launched with the pinned plan; a pin
    that leaves no schedule is skipped), each named by its plan; then row 23
    on the plan in the probe builds of ``BS_PROBES``."""
    import ctypes

    from blockcg_tpu_torch.ops import _native
    from blockcg_tpu_torch.ops import block_stencil as bsk

    label, blocks, offsets, k = next(block_operators(torch, dev))
    nd, bs, _, ns = blocks.shape
    m = bs * k
    Xm = torch.randn((m, ns), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    offs = tuple(int(o) % ns for o in offsets)
    coffs = (ctypes.c_int * nd)(*offs)
    cap, sms = _native.max_smem(dev.index), _native.sm_count(dev.index)
    p = _native.ptr
    for gram in (False, True):
        for kw in ({},) + BS_VARIANTS:
            try:
                plan = bsk.block_stencil_plan(offs, ns, bs, k, gram, cap, sms, **kw)
            except ValueError as e:
                print(json.dumps({"case": f"variant row 23 {kw} gram={gram}", "skip": str(e)}))
                continue

            def run(plan=plan):
                Y = torch.empty_like(Xm)
                part = G = None
                if plan.fused_gram:
                    part = torch.empty((plan.blocks, m, m), device=dev)
                    G = torch.empty((m, m), device=dev)
                _native.launch("variant", "bcg_block_stencil_spmm", dev, p(blocks), 4, coffs,
                               None, nd, bs, p(Xm), p(Y), p(part), p(G), k, k, ns, 1, plan.h,
                               plan.groups, plan.ki, plan.stages, plan.blocks)
                return Y if G is None else (Y, G)
            name = "row 23 plan" if not kw else f"variant row 23 {kw}"
            yield (f"{name}{'b' if gram else ''} {label} k={k} [{plan.describe()}]", run,
                   block_work(blocks, k, bool(plan.fused_gram)))
    plan = bsk.block_stencil_plan(offs, ns, bs, k, False, cap, sms)
    yield from bs_probe_cases(torch, dev, tmp, label, blocks, offsets, k, plan, Xm)


def sparse_operator(torch, dev):
    """The [sparse] tiles: ``rgg_laplacian(524288, 40)`` through
    ``from_scipy_auto`` (RCM tiles), and the same tiles in bf16."""
    from blockcg_tpu_torch.operators import TiledOperator, from_scipy_auto
    from blockcg_tpu_torch.problems import rgg_laplacian

    op = from_scipy_auto(rgg_laplacian(524288, degree=40, seed=0), torch.float32, device=dev)
    bf = TiledOperator(op.tiles.to(torch.bfloat16), op.rt, op.ct, op.first, op.n, op.perm,
                       op.n0, op.nnz_logical)
    return op, bf


def row25(torch, dev, library: bool):
    """Row 25 on the [sparse] tiles through the operator's apply (its plan
    computed in the warm-up calls): k = 32 with f32 and bf16 tiles, k = 96;
    or torch's BSR product of the same tiles."""
    op, bf = sparse_operator(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for o, k, label in ((op, 32, "f32"), (bf, 32, "bf16"), (op, 96, "f32")):
        Xt = torch.randn((k, o.n), generator=gen, device=dev)
        what = f"[sparse] k={k} {label} tiles"
        if library:
            order = torch.argsort(o.rt.long() * (o.n // 128) + o.ct.long())
            A = torch.sparse_bsr_tensor(o.row_ptr.long(), o.ct[order].long(),
                                        o.tiles[order].float(), size=(o.n, o.n))
            X = Xt.T.contiguous()
            yield f"library BSR @ dense {what}", lambda A=A, X=X: A @ X
        else:
            yield f"row 25 tiled_spmm_t {what}", lambda o=o, Xt=Xt: o.matmat_t(Xt)


def rows89(fused, what, M1, M2, M3, W, P, X):
    """Rows 8 and 9 on fresh outputs: Y = M1 W + M2 P with its Gram, and
    (Pn = M1 W + M2 P, Xn = X + M3 P)."""
    yield (f"row 8 mm2_update_gram {what}",
           lambda: fused.mm2_update_gram(M1, W, M2, P))
    yield f"row 9 px_update {what}", lambda: fused.px_update(M1, W, M2, P, M3, X)


def sweep_cases(torch, dev):
    """The stencil at (32, 128^3) and (32, 64^3), without its Gram
    (``stencil_spmm``, planned by ``stencil_plan``) and with it
    (``stencil_mma_f32``, ``stencil_mma_f32_plan``), launched directly at
    each (h, T) whose shared memory fits, beside the one the plan picks: how
    the window's halo and tile width trade L2 traffic against blocks per
    SM."""
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
            if gram:
                plan = stencil.stencil_mma_f32_plan(tuple(op.offsets), n, k, cap, sms)
                tiles = stencil.MMA_F32_TILES
            else:
                plan = stencil.stencil_plan(tuple(op.offsets), n, k, cap, sms)
                tiles = (128, 256, 512)
            for h in (0, 4, edge):
                for T in tiles:
                    nbytes = (stencil.mma_f32_smem_bytes(k, nd, h, T) + stencil.MMA_STATIC_BYTES
                              if gram else stencil.smem_bytes(k, nd, h, T))
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


# Builds of row 8's kernel at 17-32 rows (csrc/update_gram.cuh launch<E, NF,
# HAS_A, R, GK, MINB> on two f32 fields), exported by a probe that includes the
# source: which = 0, Y without its Gram; 1, with the Gram, built for one
# block an SM (no register cap); 3, built for three; 2, the kernel as built;
# each on the stage depth kc given.
VARIANT_PROBE = r"""#include "{src}"
extern "C" int variant_mm2(const float* M1, const float* B1, const float* M2, const float* B2,
                           float* Y, float* part, float* G, int k, long long n, int kc,
                           int which, int max_blocks, int device, cudaStream_t stream) {{
  if (k < 17 || k > 32) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  switch (which) {{
    case 0: return launch<float, 2, false, 4, 0>(M1, B1, M2, B2, nullptr, Y, nullptr, nullptr, k, k,
                                          n, kc, max_blocks, device, stream);
    case 1: return launch<float, 2, false, 4, 32, 1>(M1, B1, M2, B2, nullptr, Y, part, G, k, k, n, kc,
                                              max_blocks, device, stream);
    case 3: return launch<float, 2, false, 4, 32, 3>(M1, B1, M2, B2, nullptr, Y, part, G, k, k, n, kc,
                                              max_blocks, device, stream);
    default: return launch<float, 2, false, 4, 32>(M1, B1, M2, B2, nullptr, Y, part, G, k, k, n, kc,
                                            max_blocks, device, stream);
  }}
}}
"""
VARIANTS = (("Y without its Gram", 0, None), ("one block an SM, no register cap", 1, None),
            ("kc = 32", 2, 32), ("three blocks an SM, kc = 32", 3, 32))
PX_KC = (32,)  # row 9 at these stage depths beside the plan's


def variant_cases(torch, dev, tmp: Path):
    """Row 8 at (32, 128^3) and (32, 64^3) beside the builds above, on the
    plan's stage depth unless a variant names its own, built from this
    checkout's source; row 9 beside launches at the depths ``PX_KC``."""
    import ctypes
    import subprocess

    from blockcg_tpu_torch.ops import _native, fused

    probe = tmp / "variant.cu"
    probe.write_text(VARIANT_PROBE.format(src=_native.CSRC / "update_gram.cuh"))
    lib = tmp / "libvariant.so"
    built = subprocess.run([_native.nvcc(), *_native.NVCC_FLAGS, "-shared", str(probe), "-o",
                            str(lib)], capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"nvcc failed on the variant probe:\n{built.stdout}{built.stderr}")
    fn = ctypes.CDLL(str(lib)).variant_mm2
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes, fn.restype = [P, P, P, P, P, P, P, I, L, I, I, I, I, P], I
    gen = torch.Generator(device=dev).manual_seed(0)
    for edge in (128, 64):
        n = edge ** 3
        W, P_ = (torch.randn((32, n), generator=gen, device=dev) for _ in range(2))
        M1, M2 = (torch.randn((32, 32), generator=gen, device=dev) / 32 ** 0.5 for _ in range(2))
        Y, G = torch.empty_like(W), torch.empty((32, 32), device=dev)
        nb = _native.nblocks(n)
        part = torch.empty((nb, 32, 32), device=dev)
        plan_kc = fused.mm2_update_gram_plan(32, dev).kc
        stream = torch.cuda.current_stream(dev).cuda_stream

        def run(which, kc, M1=M1, W=W, M2=M2, P_=P_, Y=Y, G=G, part=part, n=n, nb=nb):
            rc = fn(M1.data_ptr(), W.data_ptr(), M2.data_ptr(), P_.data_ptr(), Y.data_ptr(),
                    part.data_ptr(), G.data_ptr(), 32, n, kc, which, nb, dev.index, stream)
            if rc != 0:
                raise RuntimeError(f"variant launch failed: {rc}")
            return (Y, G) if which else Y
        yield f"row 8 mm2_update_gram (32, {edge}^3)", lambda: fused.mm2_update_gram(M1, W, M2, P_)
        for label, which, kc in VARIANTS:
            yield (f"variant row 8, {label} (32, {edge}^3)",
                   lambda which=which, kc=kc or plan_kc: run(which, kc))
        X, M3 = torch.randn_like(W), M2.T.contiguous()
        Pn, Xn = torch.empty_like(W), torch.empty_like(W)

        def px(kc, M1=M1, W=W, M2=M2, P_=P_, M3=M3, X=X, Pn=Pn, Xn=Xn, n=n):
            p = _native.ptr
            _native.launch("px_update", "bcg_px_update", dev, p(M1), p(W), p(M2), p(P_), p(M3),
                           p(X), p(Pn), p(Xn), 32, 32, n, kc)
            return Pn, Xn
        yield f"row 9 px_update (32, {edge}^3)", lambda: fused.px_update(M1, W, M2, P_, M3, X)
        for kc in PX_KC:
            yield f"variant row 9, kc = {kc} (32, {edge}^3)", lambda kc=kc: px(kc)
        del W, P_, Y, X, Pn, Xn
    yield from wide_variants(torch, dev)
    yield from gram_variants(torch, dev, tmp)
    yield from bs_variants(torch, dev, tmp)
    yield from row25_variants(torch, dev)


def wide_kc(k: int, w: int, cap: int) -> int:
    """Deepest even stage split of k input rows that leaves room for the
    coefficients of a w-row launch of update_gram.cuh without its Gram, one
    block an SM (fused.update_smem_bytes)."""
    from blockcg_tpu_torch.ops import fused

    deepest = (cap - fused.update_smem_bytes(w, k, 0, 1, False)) // (2 * fused.UPDATE_TILE * 4)
    if deepest < 1:
        raise ValueError(f"no room for {w}-row chunks at k = {k}")
    return -(-k // -(-k // min(deepest, k)))


def wide_variants(torch, dev):
    """Row 7 at (400, 2^16) and (800, 2^16) as planned beside Y from 64- and
    16-row chunks (each at the deepest stage that fits) of the same kernel
    without its Gram (``bcg_mm_update_gram``, G null), its Gram from
    ``wide_gram``."""
    from blockcg_tpu_torch.ops import _native, fused

    cap = _native.max_smem(dev.index)
    gen = torch.Generator(device=dev).manual_seed(2)
    n, p = 1 << 16, _native.ptr
    for k in (400, 800):
        B, A = (torch.randn((k, n), generator=gen, device=dev) for _ in range(2))
        M = torch.randn((k, k), generator=gen, device=dev) / k ** 0.5
        what = f"({k}, 2^16)"

        def y_chunks(w, kc, M=M, B=B, A=A):
            Y = torch.empty_like(B)
            for r0, r1 in _native.row_chunks(k, w):
                _native.launch("variant", "bcg_mm_update_gram", dev, p(M[r0:r1]), p(B),
                               p(A[r0:r1]), p(Y[r0:r1]), None, None, r1 - r0, k, n, kc,
                               _native.nblocks(n))
            return Y
        yield f"row 7 mm_update_gram +A {what}", lambda M=M, B=B, A=A: fused.mm_update_gram(M, B, A)
        for w in (64, 16):
            kc = wide_kc(k, w, cap)
            yield (f"variant row 7, Y from {w}-row chunks kc = {kc}, wide_gram +A {what}",
                   lambda w=w, kc=kc: (lambda Y: (Y, fused.wide_gram(Y, Y)))(y_chunks(w, kc)))
        del B, A


# Row 25's variants: tiled_plan keywords (slice width J, ring depth, rows of X
# a warp R: a 4 x 4 register tile).
ROW25_VARIANTS = ({"J": 16}, {"J": 32}, {"stages": 3}, {"stages": 4}, {"R": 4})


def row25_variants(torch, dev):
    """Row 25 on the [sparse] tiles at k = 32 (f32 and bf16 tiles) and k = 96
    under its default plan and each of ``ROW25_VARIANTS``, with the plan's
    busiest block beside the mean."""
    from blockcg_tpu_torch.ops import spmm_tiled

    op, bf = sparse_operator(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for o, k, label in ((op, 32, "f32"), (bf, 32, "bf16"), (op, 96, "f32")):
        Xt = torch.randn((k, o.n), generator=gen, device=dev)
        args = (o.tiles, o.rt, o.ct, o.first, Xt, o.row_ptr)
        for kw in ({},) + ROW25_VARIANTS:
            try:
                plan = spmm_tiled.tiled_plan(o.row_ptr, k, dev, o.tiles.dtype, **kw)
            except ValueError as e:
                print(json.dumps({"case": f"variant row 25 {kw} k={k} {label}", "skip": str(e)}))
                continue
            name = "row 25 plan" if not kw else f"variant row 25 {kw}"
            yield (f"{name} k={k} {label} tiles [{plan.describe()}]",
                   lambda args=args, plan=plan: spmm_tiled.tiled_spmm_t(*args, lambda kk: plan))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose blockcg_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--library", action="store_true",
                    help="time the PyTorch library calls instead of the port's kernels")
    ap.add_argument("--sweep", action="store_true",
                    help="time the stencil at each halo and tile width that fits")
    ap.add_argument("--variants", action="store_true",
                    help="time rows 7, 8, 9, 23 and 25 beside other builds and plans")
    ap.add_argument("--const-hop", action="store_true",
                    help="time only rows 12, 16 and 17 (qr_p_update, the merged const-hop "
                         "stencil)")
    ap.add_argument("--bf16", action="store_true",
                    help="time only the bf16 variants of rows 1, 2 and 5-9 and their f32 "
                         "kernels at (32, 256^3)")
    ap.add_argument("--short", action="store_true",
                    help="time only rows 10, 10b and 14, whose event medians time the host")
    ap.add_argument("--storage", action="store_true",
                    help="time only rows 1m, 2m, 2, 1x, 22h, 23h, 23, 24f and 24fg at "
                         "[storage]'s shapes, with L2 flushed")
    ap.add_argument("--updates", action="store_true",
                    help="time only px_update.cu's rows 9, 9b, 12, 12b, 13 and 13b, with L2 "
                         "flushed")
    ap.add_argument("--only", default=None,
                    help="time only the cases whose name matches this regular expression")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_times.py: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(Path(args.root).resolve()))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    flush = l2_flush(torch, dev) if args.short or args.storage or args.updates else None
    with tempfile.TemporaryDirectory() as tmp:
        todo = (chain(bf16_variants(torch, dev), bf16_mma_variants(torch, dev),
                      sm_probe_cases(torch, dev, Path(tmp)),
                      cols_probe_cases(torch, dev, Path(tmp)))
                if args.bf16 and args.variants
                else bf16_cases(torch, dev) if args.bf16
                else update_variants(torch, dev) if args.updates and args.variants
                else update_cases(torch, dev) if args.updates
                else storage_variants(torch, dev, Path(tmp), args.only)
                if args.storage and args.variants
                else storage_cases(torch, dev, args.only) if args.storage
                else short_variants(torch, dev, Path(tmp)) if args.short and args.variants
                else short_cases(torch, dev) if args.short
                else sweep_cases(torch, dev) if args.sweep
                else const_hop_variants(torch, dev, Path(tmp), args.only)
                if args.variants and args.const_hop
                else variant_cases(torch, dev, Path(tmp)) if args.variants
                else const_hop_cases(torch, dev, args.only) if args.const_hop
                else cases(torch, dev, args.library))
        for name, fn, *extra in todo:
            if args.only and not re.search(args.only, name):
                continue
            bound = extra[:1]
            plan = {"plan": extra[1]} if len(extra) > 1 and extra[1] else {}
            for _ in range(2):
                fn()
            out = fn()
            torch.cuda.synchronize()
            cold = {}
            if flush is not None and bound and bound[0] is not None:
                us, shares, got, want = cold_us(torch, fn, args.reps, Path(tmp), flush)
                cold = {"device_us_cold": us, "kernels_us_cold": shares, "records_cold": got,
                        "records_expected": want}
            warm, records = device_us(torch, fn, args.reps, Path(tmp))
            print(json.dumps({"root": args.root, "case": name, "device_us": warm,
                              "records": records, "reps": args.reps,
                              **cold, "host_us": host_us(torch, fn, args.reps),
                              "bound_us": bound[0] if bound else bound_us(name),
                              "checksums": checksums(torch, out), **plan}), flush=True)
            del out


if __name__ == "__main__":
    main()
