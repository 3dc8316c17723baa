#!/usr/bin/env python3
"""Registers and spills of the port's CUDA kernels, as ``nvcc -Xptxas -v``
reports them, at the built register widths and at candidate widths: KMAX =
128 for the one-thread-a-column kernels, and for the merged const-hop
kernel (``cbs_merged.cu``) four far diagonals' loads in flight together
(two are built).

Run from the root of a checkout on a machine with nvcc:

    python3 tools/torch_ptxas.py

Each ``blockcg_tpu_torch/csrc/*.cu`` is compiled once with the library's
flags; then, per source, a probe that includes it takes the address of its
kernels at KMAX = 128 (the width a field of up to 128 rows would need in one
launch), which makes nvcc build them. One line per kernel: the source, the
demangled name, registers, spill stores and spill loads (bytes). A field
wider than 64 rows runs as row-chunked launches at the built widths; this
report shows what the alternative would cost in registers. The first pass
reports every built instantiation, among them ``qr_px_update``'s two
routes in ``px_update.cu``: ``px_update_kernel<E, R, true, true>`` (the
streaming QR-with-X mode, R up to 16: 128 rows) and ``px_update_mma<W,
true>`` (the tensor cores, W = 16, 32, 64), and the DIA stencil's ring on
f32 fields, ``stencil_ring<ED, float, R>`` (R = 4, 8).
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from blockcg_tpu_torch.ops import _native  # noqa: E402

# The KMAX = 128 candidates of each source (kernel templates at that width).
PROBES = {
    "gram.cu": ["gram_kernel<128, false>", "gram_kernel<128, true>"],
    "cbs_merged.cu": ["cm_spmm<4, 0, 4>", "cm_spmm<8, 0, 4>"],
    "stencil.cu": [],
    "const_block_stencil.cu": ["cbs_spmm<4, 128, false>", "cbs_spmm<4, 128, true>"],
    "block_stencil.cu": ["bs_spmm<8, 6, false>", "bs_spmm<8, 6, true>"],
}

ENTRY = re.compile(r"Compiling entry function '([^']+)'")
SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
REGS = re.compile(r"Used (\d+) registers")


def demangle(names: list[str]) -> list[str]:
    out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True)
    return out.stdout.splitlines() if out.returncode == 0 else names


def report(src: Path, label: str) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_native.nvcc(), *_native.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
               "-o", str(Path(tmp) / "probe.o")]
        log = subprocess.run(cmd, capture_output=True, text=True)
    if log.returncode != 0:
        print(f"{label}: nvcc failed\n{log.stdout}{log.stderr}")
        return
    rows, name, spill = [], None, None
    for line in (log.stdout + log.stderr).splitlines():
        if m := ENTRY.search(line):
            name, spill = m.group(1), None
        elif (m := SPILL.search(line)) and name:
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := REGS.search(line)) and name:
            rows.append((name, int(m.group(1)), spill or (0, 0)))
            name = None
    for (mangled, regs, (st, ld)), pretty in zip(rows, demangle([r[0] for r in rows])):
        short = pretty[:pretty.rfind("(")] if pretty.endswith(")") else pretty
        short = re.sub(r"^void |\(anonymous namespace\)::|\{anonymous\}::", "", short)
        print(f"{label}\t{short}\tregisters {regs}\tspill stores {st} B"
              f"\tspill loads {ld} B")


def main() -> None:
    for cu in sorted(_native.CSRC.glob("*.cu")):
        report(cu, cu.name)
        probes = PROBES.get(cu.name, [])
        if not probes:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            probe = Path(tmp) / f"kmax128_{cu.name}"
            body = "".join(f"  (void*)&{p},\n" for p in probes)
            probe.write_text(f'#include "{cu}"\nvoid* bcg_kmax128_probe[] = {{\n{body}}};\n')
            report(probe, f"{cu.name} KMAX=128")


if __name__ == "__main__":
    main()
