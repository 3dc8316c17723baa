"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` (all started together), and the
objects are linked into one shared library with a plain C interface, loaded
with ``ctypes``. The library goes to
``build/blockcg_tpu_torch/`` at the root of the checkout (``build/`` is listed
in ``.gitignore``), or to the user's cache directory when the package is
installed (``build_dir``), named by a hash of the sources and flags, so an unchanged
tree builds once. It is built on the first kernel launch, never on import: a
process that only touches CPU tensors needs no ``nvcc``. A failed build
raises; nothing falls back to the plain versions.

Dispatch rule, shared by every wrapper in ``ops/``:

- CPU tensors run the plain PyTorch version;
- CUDA float32 tensors launch the kernel;
- CUDA float64 tensors run the plain version, as the reference's own dtype
  gate sends f64 to XLA instead of Pallas;
- CUDA bfloat16 fields launch the kernel's bf16 variant on the wrappers that
  have one (``field_kernel``): ``gram``, ``mm_update``, ``mm_update_gram``,
  ``mm2_update_gram``, ``px_update``, ``xr_update_gram``, ``qr_p_update``
  and ``qr_px_update`` with float32 k x k coefficients. A bf16 field beside
  coefficients of another dtype raises ``TypeError``;
- the kernels whose reference gate takes the field's and the coefficients'
  dtypes independently launch the variant of the pair (``pair_kernel``,
  ``pair_variant``): ``stencil_spmm_t`` and ``stencil_spmm_gram_t`` take
  float32 or bfloat16 diagonals with a float32 or bfloat16 field (the
  reference's ``DIAOperator._pallas_ok``), the per-site block stencil
  float32 or bfloat16 blocks with a float32 field
  (``BlockDIAOperator._kernel_ok``). Each sums in float32. A pair no rule
  names raises ``TypeError``;
- a CUDA bfloat16 field of an operator whose reference kernels take float32
  fields alone (the per-site block stencil, whatever its blocks; the tiles
  of ``TiledOperator``) goes whole to the operator's plain route, which
  rounds as the reference's XLA route does (``f32_field_gate_refuses``; the
  operators in ``operators/bdia.py`` and ``operators/tiled.py`` read it);
- CUDA bfloat16 operands of the const-hop kernels (the stencil and slab
  adds of ``ops/const_block_stencil.py``, rows 14-21) run the plain version,
  as float64 does: the reference's gate for those kernels
  (``ConstBlockDIAOperator._env_ok``, ``blockcg_tpu/operators/cbdia.py:133-141``,
  which its main and slab kernels share) takes float32 alone and sends every
  other dtype to XLA. ``f32_gate_refuses`` is this rule; the operator
  (``operators/cbdia.py``) reads it and sends a bf16 field whole to the
  plain roll-and-einsum, diagonals in the reference's order, and the
  wrappers read it through ``f32_kernel`` for direct calls. ``cheb_step``
  follows the same rule (the reference's ``cheb_step_available`` takes
  float32 alone). A bf16 operand beside an f32 one there raises
  ``TypeError``;
- a bf16 operand on any other wrapper (the tile kernel, a bf16 field on the
  block stencil's) raises ``TypeError``, as does any other dtype; any other
  device and a non-contiguous operand raise ``ValueError``.

Every rule reads the dtypes before any launch; nothing is tried and retried.

``launches`` counts kernel launches per wrapper; the wrappers add to it where
they launch and nowhere else. ``functions`` counts the same launches by the
library function each called, which tells a wrapper's routes apart. A bf16
variant counts under its own name, the wrapper's with ``[bf16]`` after it (``px_update[bf16]``); the mixed pairs as
``[bf16 coeffs]`` (bf16 diagonals or blocks, f32 field) and ``[bf16 field]``
(f32 diagonals, bf16 field); the stencil's launches that take a column block
of a bf16 field's Gram above one launch as ``[bf16, wide]`` (``[bf16 field,
wide]``); a folded block stencil as ``[fold]`` (``[fold, bf16
coeffs]`` on bf16 blocks).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

THREADS = 128  # csrc/common.cuh kThreads: columns per tile
MAX_BLOCKS = 1024  # grid cap; also the row count of the Gram partials
MAX_K = 64  # widest register tile the kernels are built for: rows per launch

launches: Counter = Counter()
# Launches by library function, beside ``launches``: where a wrapper has
# several kernels (the DIA stencil's ring and window routes, the block
# stencil's TMA and cp.async rings), the route each launch took.
functions: Counter = Counter()


def reset_launches() -> None:
    launches.clear()
    functions.clear()


def nblocks(n: int) -> int:
    """Grid size for a field of n columns. It depends on n alone, so the Gram
    partials are summed in the same order on every call."""
    return min(-(-n // THREADS), MAX_BLOCKS)


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the operands go to the CUDA kernel, False for the plain
    version (see the module docstring for the rule)."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"operands on several devices: {[str(t.device) for t in tensors]}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    dtypes = {t.dtype for t in tensors}
    if dtypes == {torch.float64}:
        return False
    if dtypes != {torch.float32}:
        raise TypeError(f"CUDA kernels take float32 operands (float64 runs the "
                        f"plain version); got {sorted(map(str, dtypes))}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("CUDA kernel operands must be contiguous")
    return True


def f32_gate_refuses(*tensors: torch.Tensor) -> bool:
    """True for operands that are all bfloat16, which a route whose
    reference kernels take float32 alone (the const-hop stencil and slab
    adds) runs by its plain version on any device, as float64 runs on the
    card (see the module docstring)."""
    return all(t.dtype == torch.bfloat16 for t in tensors)


def f32_kernel(*tensors: torch.Tensor) -> bool:
    """``use_kernel`` for the wrappers of those kernels: False where
    ``f32_gate_refuses``."""
    return not f32_gate_refuses(*tensors) and use_kernel(*tensors)


def field_kernel(fields, coeffs=()):
    """The field dtype whose kernel the operands go to (``torch.float32`` or
    ``torch.bfloat16``), or None for the plain version: the rule of
    ``use_kernel``, and besides it bf16 ``fields`` (None entries skipped)
    with float32 ``coeffs`` launch the bf16 variant. Any other mix with a
    bf16 operand raises ``TypeError``."""
    fields = [f for f in fields if f is not None]
    ops = (*fields, *coeffs)
    if not any(t.dtype == torch.bfloat16 for t in ops):
        return torch.float32 if use_kernel(*ops) else None
    dev = ops[0].device
    if any(t.device != dev for t in ops):
        raise ValueError(f"operands on several devices: {[str(t.device) for t in ops]}")
    if dev.type == "cpu":
        return None
    if not (all(f.dtype == torch.bfloat16 for f in fields)
            and all(c.dtype == torch.float32 for c in coeffs)):
        raise TypeError(f"CUDA bf16 kernels take bfloat16 fields with float32 "
                        f"coefficients; got fields {sorted({str(f.dtype) for f in fields})}"
                        f", coefficients {sorted({str(c.dtype) for c in coeffs})}")
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("CUDA kernel operands must be contiguous")
    return torch.bfloat16


def f32_field_gate_refuses(X: torch.Tensor) -> bool:
    """True for a bfloat16 field, which an operator whose reference kernels
    take float32 fields alone (the per-site block stencil, the tiles) sends
    whole to its plain route on any device (see the module docstring)."""
    return X.dtype == torch.bfloat16


F32, BF16 = torch.float32, torch.bfloat16
# (field dtype, coefficient dtype) -> (launch-count tag, library suffix)
PAIR_VARIANTS = {(F32, F32): ("", ""), (BF16, BF16): ("[bf16]", "_bf16"),
                 (F32, BF16): ("[bf16 coeffs]", "_bf16d"),
                 (BF16, F32): ("[bf16 field]", "_bf16x")}


def pair_kernel(field: torch.Tensor, coeff: torch.Tensor, pairs):
    """The (field dtype, coefficient dtype) pair whose kernel variant the
    operands launch, or None for the plain version: CPU tensors, and float64
    for both. Elsewhere the pair must be one of ``pairs`` (else
    ``TypeError``, read before the device type), the device CUDA and both
    operands contiguous (else ``ValueError``)."""
    dev = field.device
    if coeff.device != dev:
        raise ValueError(f"operands on several devices: {field.device}, {coeff.device}")
    if dev.type == "cpu":
        return None
    pair = (field.dtype, coeff.dtype)
    if pair == (torch.float64, torch.float64):
        return None
    if pair not in pairs:
        raise TypeError(f"CUDA kernel: no variant for a {field.dtype} field with "
                        f"{coeff.dtype} coefficients; it takes "
                        f"{sorted((str(f), str(c)) for f, c in pairs)}")
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (field.is_contiguous() and coeff.is_contiguous()):
        raise ValueError("CUDA kernel operands must be contiguous")
    return pair


def pair_variant(name: str, fn_name: str, pair) -> tuple[str, str]:
    """(launch-count name, library function) of the variant of a (field,
    coefficient) dtype pair (``PAIR_VARIANTS``)."""
    tag, suffix = PAIR_VARIANTS[pair]
    return f"{name}{tag}", f"{fn_name}{suffix}"


def variant(name: str, fn_name: str, dtype: torch.dtype) -> tuple[str, str]:
    """(launch-count name, library function) of a wrapper's kernel for the
    field dtype: the bf16 variant counts as ``name[bf16]`` and is
    ``fn_name_bf16`` in the library."""
    if dtype == torch.bfloat16:
        return f"{name}[bf16]", f"{fn_name}_bf16"
    return name, fn_name


def check_field(F: torch.Tensor, k: int, n: int, what: str) -> None:
    if F.shape != (k, n):
        raise ValueError(f"{what}: expected a ({k}, {n}) field, got {tuple(F.shape)}")


def row_chunks(k: int, width: int = MAX_K) -> list[tuple[int, int]]:
    """Row ranges ``[(r0, r1), ...]`` covering ``0..k`` in as few chunks of
    at most ``width`` rows as can be, of balanced sizes: a field wider than a
    kernel's register tile runs as one launch per chunk. ``k <= width`` is one
    chunk, the whole field."""
    if k < 1:
        raise ValueError(f"CUDA kernels take k >= 1 rows, got {k}")
    step = -(-k // -(-k // width))
    return [(r, min(r + step, k)) for r in range(0, k, step)]


def check_kk(M: torch.Tensor, k: int, what: str) -> None:
    if M.shape != (k, k):
        raise ValueError(f"{what}: expected ({k}, {k}), got {tuple(M.shape)}")


def nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found at {cand} or on PATH: the CUDA "
                           "kernels of blockcg_tpu_torch cannot be built")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build_commands(out: Path) -> tuple[list[list[str]], list[str]]:
    """(one compile command per ``.cu``, the link command) for a library at
    ``out``; the objects go beside it."""
    exe = nvcc()
    cus = [p for p in sources() if p.suffix == ".cu"]
    objs = [str(out.with_name(f"{out.name}.{p.stem}.o")) for p in cus]
    compiles = [[exe, *NVCC_FLAGS, "-c", str(p), "-o", o] for p, o in zip(cus, objs)]
    return compiles, [exe, *NVCC_FLAGS, "-shared", "-o", str(out), *objs]


def build_dir(pkg_dir: Path = PKG_DIR) -> Path:
    """Where the library is built. Run from a source checkout (the package
    sits beside ``pyproject.toml``), it is ``build/blockcg_tpu_torch/`` at the
    root of the checkout. Installed, it is ``blockcg_tpu_torch/`` in the
    user's cache directory (``$XDG_CACHE_HOME``, else ``~/.cache``), never
    beside site-packages."""
    root = pkg_dir.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "blockcg_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "blockcg_tpu_torch"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir() / f"libblockcg_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel and raise with the output of every one
    that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    fails = []
    for cmd, proc in zip(cmds, procs):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            fails.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
    if fails:
        raise RuntimeError("\n".join(fails))


def build() -> Path:
    """Compile the library unless this exact source set is already built."""
    out = library_path()
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    compiles, link = build_commands(tmp)
    objs = [Path(c[-1]) for c in compiles]
    try:
        _run_all(compiles)
        _run_all([link])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bcg_stencil_spmm.argtypes = [P, ctypes.POINTER(ctypes.c_int), I, P, P,
                                     P, P, I, L, I, I, I, I, P]
    lib.bcg_mm_update.argtypes = [P, P, P, P, I, L, I, P]
    lib.bcg_gram.argtypes = [P, P, P, P, I, I, L, I, I, I, P]
    lib.bcg_mm_update_gram.argtypes = [P, P, P, P, P, P, I, I, L, I, I, I, P]
    lib.bcg_mm2_update_gram.argtypes = [P, P, P, P, P, P, P, I, I, L, I, I, I, P]
    lib.bcg_px_update.argtypes = [P, P, P, P, P, P, P, P, I, I, L, I, I, P]
    lib.bcg_xr_update_gram.argtypes = [P, P, P, P, P, P, P, P, P, I, I, L, I, I, I, P]
    lib.bcg_qr_p_update.argtypes = [P, P, P, P, P, P, I, I, L, I, I, P]
    lib.bcg_qr_px_update.argtypes = [P, P, P, P, P, P, P, P, P, I, I, L, I, I, P]
    lib.bcg_cbs_spmm.argtypes = [P, ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int), I, I, P, P, P,
                                 P, P, I, L, I, I, P]
    IP = ctypes.POINTER(ctypes.c_int)
    lib.bcg_cbs_merged_spmm.argtypes = [P, I, IP, IP, IP, IP, I, P, I, P, P, I, L, I, I, I, I,
                                        I, I, P]
    for fn in (lib.bcg_slab_stream, lib.bcg_slab_stream_scalar):
        fn.argtypes = [P, I, I, I, L, L, L, L, P, L, P, P, P, P, P, P, P, I, L, I, I, I, I, I, I,
                       P]
        fn.restype = I
    lib.bcg_block_stencil_spmm.argtypes = [P, I, IP, IP, I, I, P, P, P, P, I, I, L, I, I,
                                           I, I, I, I, I, P]
    lib.bcg_block_stencil_tma.argtypes = [P, I, IP, IP, I, I, P, P, I, I, L, I, I, I, I, I,
                                          I, I, P]
    lib.bcg_block_stencil_tma.restype = I
    F = ctypes.c_float
    lib.bcg_cheb_step.argtypes = [P, P, P, P, P, P, F, F, L, I, P]
    lib.bcg_tiled_spmm.argtypes = [P, I, P, P, P, P, I, P, P, I, I, L, I, I, I, I, P]
    for fn in ("stencil_spmm", "mm_update_gram", "mm2_update_gram",
               "px_update", "xr_update_gram", "qr_p_update",
               "qr_px_update"):  # the bf16 variants take the f32 kernels' arguments
        getattr(lib, f"bcg_{fn}_bf16").argtypes = getattr(lib, f"bcg_{fn}").argtypes
        getattr(lib, f"bcg_{fn}_bf16").restype = I
    # The tensor-core variants also take their ring's tile and stage count.
    lib.bcg_gram_bf16.argtypes = [P, P, P, P, I, I, L, I, I, I, I, P]
    lib.bcg_mm_update_bf16.argtypes = [P, P, P, P, I, L, I, I, I, P]
    lib.bcg_mm_update_gram_mma.argtypes = [P, P, P, P, P, P, I, L, I, I, I, I, P]
    lib.bcg_mm2_update_gram_mma.argtypes = [P, P, P, P, P, P, P, I, L, I, I, I, I, P]
    lib.bcg_px_update_mma.argtypes = [P, P, P, P, P, P, P, P, I, L, I, I, I, P]
    lib.bcg_qr_px_update_mma.argtypes = [P, P, P, P, P, P, P, P, P, I, L, I, I, I, P]
    for fn in (lib.bcg_gram_bf16, lib.bcg_mm_update_bf16, lib.bcg_mm_update_gram_mma,
               lib.bcg_mm2_update_gram_mma, lib.bcg_px_update_mma, lib.bcg_qr_px_update_mma):
        fn.restype = I
    for fn in ("bcg_stencil_spmm_bf16d", "bcg_stencil_spmm_bf16x", "bcg_stencil_vec_gram",
               "bcg_stencil_vec_gram_bf16d"):
        getattr(lib, fn).argtypes = lib.bcg_stencil_spmm.argtypes
        getattr(lib, fn).restype = I
    for fn in (lib.bcg_stencil_ring, lib.bcg_stencil_ring_bf16, lib.bcg_stencil_ring_bf16d,
               lib.bcg_stencil_ring_bf16x):
        fn.argtypes = [P, IP, I, P, P, I, L, L, I, I, I, I, I, I, P]
        fn.restype = I
    for fn in (lib.bcg_stencil_mma_cols_bf16, lib.bcg_stencil_mma_cols_bf16x):
        fn.argtypes = [P, IP, I, P, P, P, P, P, I, I, I, L, I, I, I, I, P]
        fn.restype = I
    for fn in (lib.bcg_stencil_spmm, lib.bcg_mm_update, lib.bcg_gram,
               lib.bcg_mm_update_gram, lib.bcg_mm2_update_gram,
               lib.bcg_px_update,
               lib.bcg_xr_update_gram,
               lib.bcg_qr_p_update, lib.bcg_qr_px_update, lib.bcg_cbs_spmm,
               lib.bcg_cbs_merged_spmm,
               lib.bcg_block_stencil_spmm, lib.bcg_cheb_step,
               lib.bcg_tiled_spmm):
        fn.restype = I
    lib.bcg_tiled_spmm_blocks_per_sm.argtypes = [I, I, I, I, I, I]
    lib.bcg_tiled_spmm_blocks_per_sm.restype = I
    lib.bcg_error_string.argtypes = [I]
    lib.bcg_error_string.restype = ctypes.c_char_p
    lib.bcg_max_smem.argtypes = [I]
    lib.bcg_max_smem.restype = I
    return lib


@functools.cache
def max_smem(device_index: int) -> int:
    """Bytes of dynamic shared memory one block may use on the card (the
    opt-in cap the kernels raise themselves to)."""
    got = library().bcg_max_smem(device_index)
    if got < 0:
        raise RuntimeError(f"cannot read the shared-memory cap of cuda:{device_index}")
    return got


@functools.cache
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of the card (``stencil_plan`` caps the tile
    width by it; ``gram_plan`` and ``block_stencil_plan`` size their grids by
    it)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def launch(name: str, fn_name: str, device: torch.device, *args) -> None:
    """Call ``fn_name`` of the library on the current stream of ``device``,
    raise on its CUDA error, and count one launch for ``name``."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, fn_name)(*args, device.index, stream)
    if rc != 0:
        msg = lib.bcg_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed: error {rc} ({msg})")
    launches[name] += 1
    functions[fn_name] += 1
