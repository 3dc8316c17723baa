"""Host-side CSR -> sparse-tile conversion for ``TiledOperator``.

The port's own loader of the repository's ``native/tilize.cpp`` (the C++
tilizer that the reference package also builds): compiled with ``g++`` on
first use into the port's build directory (``build/blockcg_tpu_torch/`` in a
source checkout, see ``ops/_native.build_dir``), named by a hash of the
source, and bound with ``ctypes``. ``native/`` itself is never written.

A numpy path with the same ordering semantics gives the same arrays; it runs
under ``force_numpy``, for dtypes other than float32, and where no ``g++``
is found (``have_native()`` says which). This is host preprocessing, not a
device route.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from blockcg_tpu_torch.ops._native import build_dir

SRC = Path(__file__).resolve().parents[1] / "native" / "tilize.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    return build_dir() / f"libtilize_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.is_file():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC)], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


@functools.cache
def _load():
    """The bound library, or None where it cannot be built here."""
    if not SRC.is_file():
        return None
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, FileNotFoundError, subprocess.CalledProcessError):
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.tilize_count.restype = ctypes.c_int64
    lib.tilize_count.argtypes = [ctypes.c_int64, ctypes.c_int64, i64p, i32p, i32p]
    lib.tilize_fill.restype = None
    lib.tilize_fill.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i64p, i32p, f32p, f32p, i32p, i32p, i32p,
    ]
    return lib


def have_native() -> bool:
    return _load() is not None


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def tilize_csr(a, T: int = 128, force_numpy: bool = False, dtype=np.float32):
    """CSR -> sparse-tile arrays: (tiles (nt, T, T), rt, ct, first int32).

    Tiles are sorted by row tile, then by the order in which the row tile's
    scan first meets each column tile; every row tile emits at least one tile
    (a zero tile on the diagonal if it has no entry). The native path is
    float32; other dtypes take the numpy path."""
    dtype = np.dtype(dtype)
    if dtype != np.float32:
        force_numpy = True
    a = a.tocsr()
    n = a.shape[0]
    nrt = -(-n // T)

    lib = None if force_numpy else _load()
    if lib is not None:
        indptr = np.ascontiguousarray(a.indptr, dtype=np.int64)
        indices = np.ascontiguousarray(a.indices, dtype=np.int32)
        data = np.ascontiguousarray(a.data, dtype=np.float32)
        counts = np.zeros(nrt, dtype=np.int32)
        total = lib.tilize_count(n, T, _ptr(indptr, ctypes.c_int64),
                                 _ptr(indices, ctypes.c_int32), _ptr(counts, ctypes.c_int32))
        tiles = np.zeros((total, T, T), dtype=np.float32)
        rt = np.empty(total, dtype=np.int32)
        ct = np.empty(total, dtype=np.int32)
        first = np.empty(total, dtype=np.int32)
        lib.tilize_fill(n, T, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
                        _ptr(data, ctypes.c_float), _ptr(tiles.reshape(-1), ctypes.c_float),
                        _ptr(rt, ctypes.c_int32), _ptr(ct, ctypes.c_int32),
                        _ptr(first, ctypes.c_int32))
        return tiles, rt, ct, first

    tiles_list, rts, cts, firsts = [], [], [], []
    for rti in range(nrt):
        r0, r1 = rti * T, min((rti + 1) * T, n)
        sub = a[r0:r1]
        if sub.nnz == 0:
            tiles_list.append(np.zeros((T, T), dtype))
            rts.append(rti), cts.append(rti), firsts.append(1)
            continue
        coo = sub.tocoo()
        order_of = {}
        for c in coo.col:  # first-seen order, as the C++ scan
            cti = int(c) // T
            if cti not in order_of:
                order_of[cti] = len(order_of)
        local = {cti: np.zeros((T, T), dtype) for cti in order_of}
        for r, c, v in zip(coo.row, coo.col, coo.data):
            local[int(c) // T][int(r), int(c) - (int(c) // T) * T] += dtype.type(v)
        for j, cti in enumerate(sorted(order_of, key=order_of.get)):
            tiles_list.append(local[cti])
            rts.append(rti), cts.append(cti), firsts.append(1 if j == 0 else 0)
    return (
        np.stack(tiles_list),
        np.asarray(rts, np.int32),
        np.asarray(cts, np.int32),
        np.asarray(firsts, np.int32),
    )
