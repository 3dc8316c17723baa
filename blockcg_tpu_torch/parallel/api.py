"""Distributed solver entry points over ``torch.distributed``.

Counterpart of ``blockcg_tpu/parallel/api.py``. The reference runs its
solver bodies SPMD inside ``shard_map`` over a 1-D mesh; here every rank of
a process group runs the same solver body (``solvers/``) on its shard, and
every reduction goes through the solvers' ``group`` hook (``all_reduce`` of
the k x k results). Each entry point takes, in place of the reference's
mesh, the process group of the ranks (``row_group()`` for the default one),
and the rank's shard of a partitioned operator (``plan.shard(rank, group)``,
``parallel/dist_ops.py``).

``B`` is the global (n, k) block on every rank, in natural row order; the
entry point takes the rank's rows (zero rows where the plan padded). ``X``
comes back as the global (n, k) on every rank, through one ``all_gather``,
which is what the reference returns in one process. The global tensors sit
on the device of the operator's shard.

Left for later: ``solve_sbcgrq_deflated_dist`` (needs ``solvers/deflate.py``)
and complex right-hand sides on the distributed operators (they raise, as
the single-device solvers do on a complex container).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from blockcg_tpu_torch.operators.base import astype as op_astype
from blockcg_tpu_torch.operators.cheb import ChebyshevOperator
from blockcg_tpu_torch.parallel.dist_ops import DistDIAOperator
from blockcg_tpu_torch.solvers.bcg import _bcg_impl
from blockcg_tpu_torch.solvers.cg import _cg_impl
from blockcg_tpu_torch.solvers.common import (
    acc_dtype,
    check_complex_codec,
    check_precision,
    f_mm_update,
    row_norms2_t,
)
from blockcg_tpu_torch.solvers.pbcg import JacobiPreconditioner, _psbcgrq_impl
from blockcg_tpu_torch.solvers.poly import _cheb_cycle
from blockcg_tpu_torch.solvers.sbcgrq import _sbcgrq_impl
from blockcg_tpu_torch.solvers.shifted_block import _shifted_sbcgrq_impl
from blockcg_tpu_torch.types import SolverInfo


def row_group():
    """The default process group, the counterpart of the reference's
    ``row_mesh()``. It never initialises one: call
    ``torch.distributed.init_process_group`` first (NCCL on the card, gloo on
    the CPU)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no default process group: call "
                           "torch.distributed.init_process_group first")
    return dist.group.WORLD


def _setup(dop, B, group, solver: str, block: bool = True):
    """The entry checks, then B's rows of this rank as the local internal
    field."""
    if group is None:
        raise ValueError(f"{solver}: needs the process group of the shards (row_group())")
    if (dist.get_world_size(group), dist.get_rank(group)) != (dop.D, dop.rank):
        raise ValueError(f"{solver}: shard {dop.rank} of {dop.D} on rank "
                         f"{dist.get_rank(group)} of {dist.get_world_size(group)}")
    if block and B.dim() != 2:
        raise ValueError(f"{solver} expects an (n, k) block")
    check_complex_codec(dop, B, solver)
    check_precision(solver)
    return dop.shard_field(B.T if B.dim() == 2 else B[None, :])


def _gather(dop, Xt, group) -> list[torch.Tensor]:
    """Every rank's local field (the same shape on each rank): one
    ``all_gather``."""
    Xt = Xt.contiguous()
    parts = [torch.empty_like(Xt) for _ in range(dop.D)]
    dist.all_gather(parts, Xt, group=group)
    return parts


def _field_result(dop, Xt, group) -> torch.Tensor:
    """The global (n, k) X from the ranks' local fields."""
    return dop.unshard_field(_gather(dop, Xt, group)).T


def solve_sbcgrq_dist(dop, B: torch.Tensor, group, X0: torch.Tensor | None = None, *,
                      tol=1e-6, max_iter: int = 1000, qr_passes: int = 1,
                      replace_every: int = 0, record_history: bool = False,
                      replace_kappa: float = 0.0, active_floor: int = 0,
                      iter_cap: int | None = None):
    """Row-partitioned SBCGrQ (``solve_sbcgrq``'s options and defaults). The
    kappa and adaptive-QR predicates come from all-reduced k x k Grams, so
    every rank takes the same branch."""
    Bt = _setup(dop, B, group, "solve_sbcgrq_dist")
    X0t = torch.zeros_like(Bt) if X0 is None else dop.shard_field(X0.T)
    Xt, info = _sbcgrq_impl(dop, Bt, X0t, tol, max_iter, qr_passes, replace_every,
                            record_history, int(active_floor), float(replace_kappa),
                            iter_cap=iter_cap, group=group)
    return _field_result(dop, Xt, group), info


def solve_sbcgrq_cheb_dist(dop, B: torch.Tensor, group, *, spectrum: tuple, degree: int = 4,
                           tol=1e-6, max_iter: int = 1000, max_cycles: int = 3,
                           qr_passes: int = 1, record_history: bool = False):
    """Row-partitioned Chebyshev-preconditioned SBCGrQ: each iteration of
    (M A) with M = p_degree(A) does ``degree`` halo exchanges but one round of
    k x k reductions, so a latency-bound distributed solve trades collective
    rounds for SpMMs. ``spectrum=(lo, hi)`` is required (estimate it on a
    single-device operator with ``operators.cheb.estimate_spectrum``), taken
    in the operator's real dtype. Each outer cycle certifies the true
    residual. ``tol`` may be a per-RHS (k,) vector; the info sums the
    iterations and per-RHS counts over the cycles, concatenates their
    histories and ors their breakdown flags."""
    if max_cycles < 1:
        raise ValueError("max_cycles must be >= 1")
    Bt = _setup(dop, B, group, "solve_sbcgrq_cheb_dist")
    rdt = np.float64 if dop.dtype == torch.float64 else np.float32
    pop = ChebyshevOperator(dop, rdt(spectrum[0]), rdt(spectrum[1]), degree)
    rdtype = acc_dtype(Bt.real.dtype)
    bnorm = torch.linalg.vector_norm(B.to(torch.float64), dim=0)  # row-order invariant
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm)).to(rdtype)
    tol_t = torch.as_tensor(tol, dtype=rdtype, device=B.device)
    Xt = torch.zeros_like(Bt)
    iters = matvecs = 0
    per_rhs, broke, hists = 0, False, []
    for _ in range(max_cycles):
        Xt, relres, info = _cheb_cycle(pop, Bt, Xt, bnorm, tol, max_iter, qr_passes,
                                       record_history, group)
        iters += info.iterations
        matvecs += 2 + (degree - 1) + info.matvecs * degree
        per_rhs = per_rhs + info.per_rhs_iters
        broke = broke or bool(info.breakdown)
        if info.history is not None:
            hists.append(info.history)
        if bool((relres <= tol_t).all()):  # the cycle's one host read
            break
    info = SolverInfo(iterations=iters, relres=relres, converged=relres <= tol_t,
                      matvecs=matvecs, history=torch.cat(hists) if hists else None,
                      per_rhs_iters=per_rhs, breakdown=torch.tensor(broke))
    return _field_result(dop, Xt, group), info


def solve_refined_dist(dop, B: torch.Tensor, group, *, tol: float = 1e-10,
                       inner_tol: float = 1e-5, max_cycles: int = 8,
                       inner_max_iter: int = 2000, qr_passes: int = 1,
                       replace_every: int = 0, dop64=None, verbose: bool = False):
    """Row-partitioned mixed-precision refinement below f32's reach: the
    north-star composition ("<= 1e-10 ... row-partitioned"). The f32 SBCGrQ
    inner solves run distributed, and each f64 outer cycle (one distributed
    apply of the f64 operator ``dop64``, default ``operators.astype(dop,
    torch.float64)``, and all-reduced column norms) keeps the fields in the
    ranks' shards: only the (k,) relres is read on the host. Per-RHS scaling
    as in the reference's ``solve_refined_dist``. Returns X in float64."""
    Bt = _setup(dop, B, group, "solve_refined_dist")
    compute_dtype = dop.dtype
    if dop64 is None:
        dop64 = op_astype(dop, torch.float64)
    Bt64 = Bt.to(torch.float64)
    k = B.shape[1]

    def cycle(Xt, Dt, scale, bnorm):
        """X += D scale; R = B - A64 X; per-RHS norms; the next inner RHS
        R / ||R|| in the compute dtype."""
        Xt = Xt + f_mm_update(torch.diag(scale), Dt.to(Xt.dtype), codec=dop64)
        Rt = Bt64 - dop64.matmat_t(Xt)
        nrm = torch.sqrt(row_norms2_t(Rt, codec=dop64, group=group))
        sc = torch.where(nrm > 0, nrm, torch.ones_like(nrm))
        Rn = f_mm_update(torch.diag(1.0 / sc), Rt, codec=dop64).to(compute_dtype)
        return Xt, Rn, sc, nrm / bnorm

    ones = torch.ones((k,), dtype=torch.float64, device=Bt.device)
    # Cycle 0 (X = 0, D = 0, bnorm = 1): sc comes back as ||B e_j||, the
    # normalisation of every later cycle; relres is 1 for nonzero columns.
    Xt, Rt_in, scale, nrm0 = cycle(torch.zeros_like(Bt64), torch.zeros_like(Bt),
                                   ones, ones)
    bnorm = scale
    relres = torch.where(nrm0 > 0, 1.0, 0.0).to(torch.float64)
    matvecs, cycles = 1, 0
    if float(relres.max()) <= tol:
        max_cycles = 0
    for cycles in range(1, max_cycles + 1):
        Dt, inner = _sbcgrq_impl(dop, Rt_in, torch.zeros_like(Rt_in), inner_tol,
                                 inner_max_iter, qr_passes, replace_every, False, group=group)
        matvecs += inner.matvecs
        Xt, Rt_in, scale, relres = cycle(Xt, Dt, scale, bnorm)
        matvecs += 1
        worst = float(relres.max())  # the cycle's one host read
        if verbose:
            print(f"[refine-dist] cycle {cycles}: max relres = {worst:.3e}")
        if worst <= tol:
            break
    info = SolverInfo(iterations=cycles, relres=relres, converged=relres <= tol,
                      matvecs=matvecs)
    return _field_result(dop64, Xt, group), info


def solve_bcg_dist(dop, B: torch.Tensor, group, *, tol: float = 1e-6,
                   max_iter: int = 1000, record_history: bool = False):
    """Row-partitioned O'Leary block CG (``solve_bcg``)."""
    Bt = _setup(dop, B, group, "solve_bcg_dist")
    Xt, info = _bcg_impl(dop, Bt, torch.zeros_like(Bt), tol, max_iter, record_history, group)
    return _field_result(dop, Xt, group), info


def solve_shifted_sbcgrq_dist(dop, B: torch.Tensor, sigmas, group, *, tol: float = 1e-6,
                              max_iter: int = 1000, qr_passes: int = 2):
    """Row-partitioned multi-shift block solve ``(A + sigma_j I) X_j = B``:
    one Krylov space, one halo exchange and the usual k x k reductions per
    iteration for every shift. Returns (Xs (nshift, n, k), info)."""
    Bt = _setup(dop, B, group, "solve_shifted_sbcgrq_dist")
    sig = torch.atleast_1d(torch.as_tensor(sigmas, dtype=acc_dtype(B.real.dtype),
                                           device=Bt.device))
    Xs, info = _shifted_sbcgrq_impl(dop, Bt, sig, tol, max_iter, qr_passes, False, group)
    parts = _gather(dop, Xs, group)
    return torch.stack([dop.unshard_field([p[j] for p in parts]).T
                        for j in range(sig.shape[0])]), info


def solve_cg_dist(dop, b: torch.Tensor, group, *, tol: float = 1e-6, max_iter: int = 1000,
                  record_history: bool = False):
    """Row-partitioned CG for one right-hand side ``b`` (n,), on flat
    row-partitioned operators only (``DistDIAOperator``); the block
    operators' views go through ``solve_bcg_dist`` / ``solve_sbcgrq_dist``.
    Returns (x (n,), info)."""
    if not isinstance(dop, DistDIAOperator):
        raise TypeError("solve_cg_dist supports flat row-partitioned operators only; block "
                        "operators (spin field views) go through solve_bcg_dist/"
                        "solve_sbcgrq_dist")
    if b.dim() != 1:
        raise ValueError("solve_cg_dist expects one right-hand side b of shape (n,)")
    bf = _setup(dop, b, group, "solve_cg_dist", block=False)
    xf, info = _cg_impl(dop, bf, torch.zeros_like(bf), tol, max_iter, record_history, group)
    return _field_result(dop, xf, group)[:, 0], info


def solve_psbcgrq_dist(dop, B: torch.Tensor, M, group, *, tol: float = 1e-6,
                       max_iter: int = 1000, qr_passes: int = 2,
                       record_history: bool = False):
    """Row-partitioned preconditioned SBCGrQ (``solve_psbcgrq``). ``M`` is
    the global JacobiPreconditioner of the unpartitioned operator
    (``jacobi_preconditioner(op)``), whose factor this rank slices as it
    slices B, or any object with ``apply_t``/``matmat_t`` that already acts
    on the rank's local field."""
    Bt = _setup(dop, B, group, "solve_psbcgrq_dist")
    if isinstance(M, JacobiPreconditioner):
        # The factor is a one-row field of the operator's internal layout
        # ((1, n) flat, (bs, ns) merged at k = 1): its flat form shards as B.
        M = JacobiPreconditioner(dop.shard_field(M.dinv_int.reshape(1, -1)))
    Xt, info = _psbcgrq_impl(dop, M, Bt, torch.zeros_like(Bt), tol, max_iter, qr_passes,
                             record_history, group)
    return _field_result(dop, Xt, group), info
