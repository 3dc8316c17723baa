"""Rank side of ``tests/test_torch_dist.py``: the port's distributed layer
run by D processes of a gloo group on the CPU. It imports no JAX; the test
process holds the reference and compares.

``serve`` is a rank's main loop: it joins the group through a FileStore,
then runs each case it is sent (``CASES``) until it gets None, and puts
``(rank, "ok", result)`` or ``(rank, "error", traceback)`` on the result
queue. Operators and their shards are built once per rank and reused."""

from __future__ import annotations

import datetime
import traceback

import numpy as np
import torch
import torch.distributed as dist

from blockcg_tpu_torch import jacobi_preconditioner
from blockcg_tpu_torch import parallel as P
from blockcg_tpu_torch.problems import (
    dirac_bdia,
    dirac_cbdia,
    dirac_eo,
    dirac_gauged_cbdia,
    dirac_gauged_eo,
    laplacian_dia,
    solve_dirac_eo_dist,
)

BUILD = {
    "laplacian": lambda dt: laplacian_dia((16, 16, 16), dtype=dt, device="cpu"),
    "laplacian2d": lambda dt: laplacian_dia((24, 24), dtype=dt, device="cpu"),
    "cbdia": lambda dt: dirac_cbdia(8, dtype=dt, device="cpu"),
    "cbdia_open": lambda dt: dirac_cbdia(8, bc="open", dtype=dt, device="cpu"),
    "gauged": lambda dt: dirac_gauged_cbdia(8, dtype=dt, device="cpu"),
    "bdia": lambda dt: dirac_bdia(8, dtype=dt, device="cpu"),
    "bdia_open": lambda dt: dirac_bdia(8, bc="open", dtype=dt, device="cpu"),
    "eo": lambda dt: dirac_eo(8, dtype=dt, device="cpu"),
    "eo_gauged": lambda dt: dirac_gauged_eo(8, dtype=dt, device="cpu"),
}
DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}

_OPS: dict = {}
_SHARDS: dict = {}


def operator(kind: str, dtype: str):
    key = (kind, dtype)
    if key not in _OPS:
        _OPS[key] = BUILD[kind](DTYPES[dtype])
    return _OPS[key]


def partition(kind: str, op, D: int):
    if kind.startswith("laplacian"):
        return P.partition_dia(op, D)
    if kind.startswith("bdia"):
        return P.partition_bdia(op, D)
    if kind.startswith("eo"):
        return P.partition_dirac_eo(op, D)
    return P.partition_cbdia(op, D)


def shard(kind: str, dtype: str, rank: int, D: int):
    key = (kind, dtype, D)
    if key not in _SHARDS:
        _SHARDS[key] = partition(kind, operator(kind, dtype), D).shard(rank, P.row_group(),
                                                                          "cpu")
    return _SHARDS[key]


def _global(dop, Yl) -> np.ndarray:
    parts = [torch.empty_like(Yl) for _ in range(dop.D)]
    dist.all_gather(parts, Yl.contiguous())
    return dop.unshard_field(parts).numpy()


def case_halos(rank, D, X, bw):
    """This rank's (halo_l, halo_r) of its column block of X."""
    nl = X.shape[-1] // D
    Xl = torch.from_numpy(np.ascontiguousarray(X[..., rank * nl:(rank + 1) * nl]))
    hl, hr = P.ring_halos(Xl, bw, P.row_group())
    return hl.numpy(), hr.numpy()


def case_apply(rank, D, kind, dtype, Xt, gram=False):
    """The distributed apply of a global flat (k, n) field: global flat Y,
    and with ``gram`` the all-reduced k x k Gram of the fused apply."""
    dop = shard(kind, dtype, rank, D)
    Xl = dop.shard_field(torch.from_numpy(Xt).to(DTYPES[dtype]))
    if not gram:
        return _global(dop, dop.matmat_t(Xl)), None
    Yl, G = dop.matmat_gram_t(Xl)
    dist.all_reduce(G)
    return _global(dop, Yl), G.numpy()


def case_solve(rank, D, kind, dtype, solver, B, kwargs):
    """A distributed solve: (X, iterations, relres) as numpy and ints."""
    g = P.row_group()
    Bt = torch.from_numpy(B).to(DTYPES[dtype])
    op = operator(kind, dtype)
    if solver == "eo":
        X, info = solve_dirac_eo_dist(op, Bt, g, **kwargs)
    else:
        dop = shard(kind, dtype, rank, D)
        if solver == "sbcgrq":
            X, info = P.solve_sbcgrq_dist(dop, Bt, g, **kwargs)
        elif solver == "bcg":
            X, info = P.solve_bcg_dist(dop, Bt, g, **kwargs)
        elif solver == "cg":
            X, info = P.solve_cg_dist(dop, Bt, g, **kwargs)
        elif solver == "shifted":
            X, info = P.solve_shifted_sbcgrq_dist(dop, Bt, kwargs.pop("sigmas"), g, **kwargs)
        elif solver == "psbcgrq":
            X, info = P.solve_psbcgrq_dist(dop, Bt, jacobi_preconditioner(op), g, **kwargs)
        elif solver == "cheb":
            X, info = P.solve_sbcgrq_cheb_dist(dop, Bt, g, **kwargs)
        elif solver == "refined":
            X, info = P.solve_refined_dist(dop, Bt, g, **kwargs)
        else:
            raise ValueError(f"unknown solver {solver!r}")
    return X.to(torch.float64).numpy(), int(info.iterations), info.relres.double().numpy()


def case_raises(rank, D, kind, dtype, B):
    """The exception type of a distributed solve on B (complex here)."""
    try:
        P.solve_sbcgrq_dist(shard(kind, dtype, rank, D), torch.from_numpy(B), P.row_group())
    except Exception as exc:  # the type is the result
        return type(exc).__name__
    return None


CASES = {"halos": case_halos, "apply": case_apply, "solve": case_solve, "raises": case_raises}


def serve(rank: int, D: int, store_path: str, tasks, results) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, D), rank=rank,
                            world_size=D, timeout=datetime.timedelta(seconds=120))
    try:
        while (item := tasks.get()) is not None:
            name, kwargs = item
            try:
                results.put((rank, "ok", CASES[name](rank, D, **kwargs)))
            except Exception:  # reported to the test process, which fails the test
                results.put((rank, "error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()
