#!/usr/bin/env python3
"""Device time of the DIA stencil (rows 1 and 2 of PERF.md's kernel table),
the Gram (row 5), ``mm_update`` (row 6), ``mm_update_gram`` (row 7, with and
without A), ``mm2_update_gram`` (row 8) and ``px_update`` (row 9) from
torch.profiler's kernel records, at the shapes of the north star (32, 128^3)
and config 3 (32, 64^3), rows 6-9 at config 4's (48, 32^4) and at (96,
32^4), rows 6 and 7 (with and without A) at (400, 2^16) and (800, 2^16),
rows 8 and 9 at (800, 2^16); then ``tiled_spmm_t`` (row 25) on the
[sparse] tiles (``rgg_laplacian(524288, 40)`` through ``from_scipy_auto``,
about 10 s of host build) at k = 32 with f32 and bf16 tiles and at k = 96.
Beside them, the one PyTorch call that computes the same function, where
there is one (``U @ V.T``, ``M @ B``, torch's BSR product).

Run on a machine with a card, from the root of a checkout:

    python3 tools/torch_kernel_times.py [--root DIR] [--reps 50] [--only REGEX]
        [--library | --sweep | --variants]

``--root`` imports ``blockcg_tpu_torch`` from another checkout (its kernels
build there), so two commits compare in one call: parent, change, change,
parent. ``--sweep`` times the stencil of this checkout at each window halo
and tile width that fits in shared memory, marking the one its plan picks.
``--variants`` times row 8 beside other builds of its kernel (without the
Gram; one or three blocks an SM; other stage depths), row 9 at other stage
depths, row 7 beside other builds of its Gram and, on fields wider than 128
rows, other row chunks, and row 25 on the [sparse] tiles at other slice
widths, ring depths and register tiles (``tiled_plan``'s keywords).
``--only REGEX`` keeps the cases whose name matches. One JSON line per
case: device us per call (all of the call's kernels, the Gram's second
stage included), host us per call (wall time of the timed calls over their
count, ending in a synchronize), the least time the work could take
(``bound_us``, rows 6-9) and a checksum of the bytes of each of the call's
outputs, so two checkouts show whether a kernel kept its bits. The inputs come from a fixed seed; L2 is not
flushed between calls (the fields are 268-805 MB, far above the 50 MB L2).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import re
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


def checksums(torch, out) -> list[str]:
    """sha256 (first 16 hex digits) of the bytes of each of a call's output
    tensors, in order."""
    return [hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
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
        else:
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
    yield from row25(torch, dev, library)


def bound_us(name: str) -> float | None:
    """The least device time of a row 6-9 case (max of its bytes over 3.35
    TB/s and its FLOPs over 67 TFLOP/s, chip_smoke.py's rates) from the
    shape in its name, for the dense k x k coefficients the cases use: each
    input field read once, each output written once; Y = M B is 2 k^2 FLOPs
    a column, a symmetric Gram Y Y^T k (k + 1) (its upper triangle)."""
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


# Builds of row 8's kernel at 17-32 rows (csrc/update_gram.cuh launch<NF,
# HAS_A, R, GK, MINB> on two fields), exported by a probe that includes the
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
    case 0: return launch<2, false, 4, 0>(M1, B1, M2, B2, nullptr, Y, nullptr, nullptr, k, k,
                                          n, kc, max_blocks, device, stream);
    case 1: return launch<2, false, 4, 32, 1>(M1, B1, M2, B2, nullptr, Y, part, G, k, k, n, kc,
                                              max_blocks, device, stream);
    case 3: return launch<2, false, 4, 32, 3>(M1, B1, M2, B2, nullptr, Y, part, G, k, k, n, kc,
                                              max_blocks, device, stream);
    default: return launch<2, false, 4, 32>(M1, B1, M2, B2, nullptr, Y, part, G, k, k, n, kc,
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
    yield from row7_variants(torch, dev, tmp)
    yield from wide_variants(torch, dev)
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
                    help="time rows 7, 8, 9 and 25 beside other builds and plans")
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
    with tempfile.TemporaryDirectory() as tmp:
        todo = (sweep_cases(torch, dev) if args.sweep
                else variant_cases(torch, dev, Path(tmp)) if args.variants
                else cases(torch, dev, args.library))
        for name, fn in todo:
            if args.only and not re.search(args.only, name):
                continue
            for _ in range(2):
                fn()
            out = fn()
            torch.cuda.synchronize()
            print(json.dumps({"root": args.root, "case": name,
                              "device_us": device_us(torch, fn, args.reps, Path(tmp)),
                              "host_us": host_us(torch, fn, args.reps),
                              "bound_us": bound_us(name),
                              "checksums": checksums(torch, out)}), flush=True)
            del out


if __name__ == "__main__":
    main()
