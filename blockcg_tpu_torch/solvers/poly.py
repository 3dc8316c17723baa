"""Chebyshev-preconditioned block solves.

Counterpart of ``blockcg_tpu/solvers/poly.py``. ``solve_sbcgrq_cheb`` runs
SBCGrQ on the commuting-preconditioned system (M A) X = M B with M = p_d(A)
(``operators/cheb.py``): iteration counts drop (the reference's record on
config 3, k = 32: 104 -> 41 at degree 6) at the price of more SpMMs in all
(block CG with many RHS is already near matvec-optimal, so a fixed
polynomial does not beat it on raw matvecs). The trade pays where each
iteration costs a fixed latency: fewer iterations mean fewer host round
trips and, in a distributed solve, fewer collective rounds.

The spectral bounds are estimated once per operator (cached by ``id``, the
entry evicted when the operator is collected) by power iteration. The lo
bound may land above lambda_min on purpose: p(t) t > 0 for every t > 0, the
bulk spectrum above lo is tightly clustered, and the few modes below lo are
what a block solver deflates fastest. The inner solver monitors the
preconditioned residual; every outer cycle is certified on the true one
(true residual -> rhs transform -> inner solve -> update -> new true
residual), with one host read per cycle.
"""

from __future__ import annotations

import weakref
from typing import Any

import numpy as np
import torch

from blockcg_tpu_torch.operators.cheb import ChebyshevOperator, estimate_spectrum
from blockcg_tpu_torch.solvers.common import block_setup, row_norms2_t
from blockcg_tpu_torch.solvers.sbcgrq import _sbcgrq_impl
from blockcg_tpu_torch.types import SolverInfo

# Keyed by id() with a weakref finalizer that evicts the entry when the
# operator is collected, so a recycled id never serves a stale spectrum.
_SPECTRUM_CACHE: dict = {}


def _cheb_cycle(pop, Bt, Xt, bnorm, tol, max_iter, qr_passes, record_history,
                group=None):
    """One certified cycle on internal fields: true residual -> M r -> inner
    SBCGrQ on (M A) D = M r -> X += D. Returns (X, true relres, inner
    info)."""
    base = pop.base
    Rt = Bt - base.matmat_t(Xt)
    MRt = pop.apply_m_t(Rt)
    Dt, info = _sbcgrq_impl(pop, MRt, torch.zeros_like(MRt), tol, max_iter, qr_passes,
                            0, record_history, group=group)
    Xt = Xt + Dt
    relres = torch.sqrt(row_norms2_t(Bt - base.matmat_t(Xt), codec=base, group=group)) / bnorm
    return Xt, relres, info


def solve_sbcgrq_cheb(
    op: Any,
    B: torch.Tensor,
    *,
    degree: int = 4,
    spectrum: tuple | None = None,
    tol: float = 1e-6,
    max_iter: int = 1000,
    max_cycles: int = 3,
    qr_passes: int = 2,
    record_history: bool = False,
) -> tuple[torch.Tensor, SolverInfo]:
    """Solve ``A X = B`` by Chebyshev-preconditioned SBCGrQ.

    ``spectrum`` = (lo, hi) is taken as float32, as the reference does; by
    default it is estimated once per operator. Returns (X, info):
    ``info.relres`` is the true relative residual; ``iterations`` sums the
    inner iterations over the outer cycles; ``matvecs`` counts the SpMMs
    (inner applies, rhs transforms and the outer true-residual checks);
    ``history`` (if recorded) covers the last cycle. ``B`` is not
    modified."""
    if max_cycles < 1:
        raise ValueError("max_cycles must be >= 1")
    if spectrum is not None:
        lo, hi = np.float32(spectrum[0]), np.float32(spectrum[1])
    else:
        cached = _SPECTRUM_CACHE.get(id(op))
        if cached is None:
            cached = estimate_spectrum(op)
            try:
                weakref.finalize(op, _SPECTRUM_CACHE.pop, id(op), None)
                _SPECTRUM_CACHE[id(op)] = cached
            except TypeError:  # not weakly referenceable: no caching
                pass
        lo, hi = cached
    pop = ChebyshevOperator(op, lo, hi, degree)

    Bt, Xt = block_setup(op, B, None, "solve_sbcgrq_cheb")
    bnorm = torch.sqrt(row_norms2_t(Bt, codec=op))
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    iters = matvecs = 0
    for _ in range(max_cycles):
        Xt, relres, info = _cheb_cycle(pop, Bt, Xt, bnorm, tol, max_iter, qr_passes,
                                       record_history)
        iters += info.iterations
        # Per cycle: 2 true-residual applies, (degree - 1) SpMMs in the M r
        # transform, degree SpMMs per inner preconditioned apply.
        matvecs += 2 + (degree - 1) + info.matvecs * degree
        if bool(relres.max() <= tol):  # the cycle's one host read
            break
    info = SolverInfo(iterations=iters, relres=relres, converged=relres <= tol,
                      matvecs=matvecs, history=info.history)
    return op.from_internal(Xt).T, info
