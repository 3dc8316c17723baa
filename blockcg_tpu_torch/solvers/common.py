"""Shared solver primitives: the dtype rule, the k x k algebra and the
dispatchers onto the fused field kernels.

Counterpart of ``blockcg_tpu/solvers/common.py``. Fields are lanes-major,
an (n, k) block V carried as ``Vt = V^T`` of shape (k, n). The k x k algebra
runs as small PyTorch ops on the fields' device at full f32: callers must
leave ``torch.backends.cuda.matmul.allow_tf32`` off (``solve_sbcgrq``
checks).

Distribution: every reduction over the row dimension takes a ``group``, the
counterpart of the reference's ``axis_name``. ``group=None`` is one process.
With a ``torch.distributed`` process group, the same solver code runs on the
rank's row shard (``parallel/``) and the reduction is summed over the ranks
with ``all_reduce``, after the codec's contraction, so k x k goes on the
wire, never m x m. Every rank then holds the same bits, and the solvers'
host-side branches (the stop test, the adaptive second QR pass) read only
such reduced values, so every rank takes the same branch.
"""

from __future__ import annotations

import torch


def acc_dtype(dt: torch.dtype) -> torch.dtype:
    """Accumulation dtype for a field dtype: bf16 fields accumulate in f32;
    everything else keeps its own dtype. k x k algebra lives in this dtype."""
    return torch.float32 if dt == torch.bfloat16 else dt


# Field-algebra codec shims (operators/base.py): ``codec=None`` means flat
# fields (identity).


def allreduce_if(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the ranks of ``group`` (in place on a contiguous x), or
    x itself when ``group`` is None."""
    if group is None:
        return x
    import torch.distributed as dist

    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


def _ce(codec, C):
    return C if codec is None else codec.coeff_expand(C)


def _gc(codec, G):
    return G if codec is None else codec.gram_contract(G)


def _nc(codec, v):
    return v if codec is None else codec.norms2_contract(v)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """k x k coefficient times a lanes-major field (k, ...), in the
    coefficient's dtype (a bf16 field is lifted to it; an f32 coefficient
    stays f32, as on the reference's f32 coefficient route,
    ``BLOCKCG_NO_BF16_MXU=1``)."""
    return torch.tensordot(a, b.to(a.dtype), dims=1)


def kk_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Tiny k x k @ k x k product."""
    return a @ b


def _field_dims(Ut: torch.Tensor) -> tuple[int, ...]:
    return tuple(range(1, Ut.dim()))


def gram_t(Ut: torch.Tensor, Vt: torch.Tensor, codec=None, group=None) -> torch.Tensor:
    """Gram block ``U^H V`` (k x k) from lanes-major fields (k, ...)."""
    adt = acc_dtype(Ut.dtype)
    k = Ut.shape[0]
    G = Ut.reshape(k, -1).conj().to(adt) @ Vt.reshape(k, -1).to(adt).T
    return allreduce_if(_gc(codec, G), group)


def row_norms2_t(Ut: torch.Tensor, codec=None, group=None) -> torch.Tensor:
    """Squared column norms of U (real), from a field (k, ...) -> (k,). A
    bf16 field is lifted to f32 one row at a time, so no f32 copy of the
    whole field is made."""
    adt = acc_dtype(Ut.dtype)
    if adt != Ut.dtype:
        s = torch.stack([Ut[r].to(adt).square().sum() for r in range(Ut.shape[0])])
    else:
        s = (Ut * Ut.conj()).real.sum(dim=_field_dims(Ut))
    return allreduce_if(_nc(codec, s), group)


def vdot_real(u: torch.Tensor, v: torch.Tensor, group=None) -> torch.Tensor:
    """Real part of the conjugating inner product over every element, exact
    for the CG quantities r^H r and p^H A p; bf16 fields reduce in f32."""
    adt = acc_dtype(u.dtype)
    return allreduce_if(torch.vdot(u.reshape(-1).to(adt), v.reshape(-1).to(adt)).real, group)


def safe_cholesky(G: torch.Tensor) -> torch.Tensor:
    """Cholesky of a k x k SPD Gram, or of each matrix of a (..., k, k)
    stack, with a jittered fallback.

    Near-converged RHS columns make the Gram nearly singular. Both
    factorizations are computed on the device (k x k, no host read) and the
    jittered one is taken where the plain one failed, matrix by matrix (the
    jitter scales with each matrix's own trace, as the reference's
    ``vmap``). ``cholesky_ex`` reports failure in ``info`` and returns a
    finite, wrong factor; the reference's ``jnp.linalg.cholesky`` returns NaN
    instead. So failure is ``info != 0`` or a NaN in the factor, and a
    jittered factor that fails too is turned into the reference's NaN (lower
    triangle), so that it propagates."""
    k = G.shape[-1]
    L, info = torch.linalg.cholesky_ex(G)
    rdt = G.real.dtype
    eps, tiny = torch.finfo(rdt).eps, torch.finfo(rdt).tiny
    jitter = (torch.diagonal(G, dim1=-2, dim2=-1).real.sum(-1) / k) * eps * 32.0 + tiny
    eye = torch.eye(k, dtype=G.dtype, device=G.device)
    L2, info2 = torch.linalg.cholesky_ex(G + jitter[..., None, None] * eye)
    lower = torch.ones(k, k, dtype=torch.bool, device=G.device).tril()
    L2 = torch.where(lower & (info2 != 0)[..., None, None], torch.nan, L2)
    bad = (info != 0) | torch.isnan(L).any(dim=(-2, -1))  # L is column-major
    return torch.where(bad[..., None, None], L2, L)


def chol_solve_spd(M: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``M X = B`` for SPD k x k ``M`` (or a stack) via Cholesky."""
    L = safe_cholesky(M)
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.mH, Y, upper=True)


def chol_inverse_spd(M: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of SPD k x k ``M``, or of each matrix of a stack
    (keeps the big updates plain coefficient applies)."""
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return chol_solve_spd(M, eye.expand(M.shape))


def tri_inverse_upper(R: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of upper-triangular k x k ``R``."""
    eye = torch.eye(R.shape[0], dtype=R.dtype, device=R.device)
    return torch.linalg.solve_triangular(R, eye, upper=True)


# ------------------------------------------------ fused-kernel dispatch ----
#
# The ops wrappers pick the CUDA kernel or the plain composition from the
# tensors' device and dtype (ops/_native.py); these add the codec algebra.
# ops imports this module for acc_dtype, hence the imports inside.


def f_gram(Ut, Vt, codec=None, group=None):
    from blockcg_tpu_torch.ops import fused

    return allreduce_if(_gc(codec, fused.gram(Ut, Vt)), group)


def f_mm_update(M, Bt, At=None, codec=None, donate: str | None = None):
    """M @ B (+ A) in one pass (M expanded to internal rows via codec).
    ``donate`` writes the output onto the named dead operand ('a' or 'b')."""
    from blockcg_tpu_torch.ops import fused

    return fused.mm_update(_ce(codec, M), Bt, At, donate=donate)


def f_mm_update_gram(M, Bt, At=None, codec=None, donate: bool = False, group=None):
    """(Y = M @ B (+ A), G = Y Y^T) in one pass; ``donate`` writes Y onto B,
    which must be dead at the call site."""
    from blockcg_tpu_torch.ops import fused

    Y, G = fused.mm_update_gram(_ce(codec, M), Bt, At, donate=donate)
    return Y, allreduce_if(_gc(codec, G), group)


def f_mm2_update_gram(M1, B1t, M2, B2t, codec=None, donate: bool = False, group=None):
    """(Y = M1 @ B1 + M2 @ B2, G = Y Y^T) in one pass: the implicit-Q
    residual-direction update V = Q - Z alpha with Q = M_qr @ W never
    materialized. ``donate`` writes Y onto B1."""
    from blockcg_tpu_torch.ops import fused

    Y, G = fused.mm2_update_gram(_ce(codec, M1), B1t, _ce(codec, M2), B2t,
                                 donate=donate)
    return Y, allreduce_if(_gc(codec, G), group)


def f_px_update(M1, Wt, rho, Pt, C, Xt, codec=None, donate: bool = False):
    """(Pn = M1 @ W + rho @ P, Xn = X + C @ P) in one pass: the implicit-Q
    SBCGrQ iteration tail. ``donate`` writes Pn onto P and Xn onto X."""
    from blockcg_tpu_torch.ops import fused

    return fused.px_update(_ce(codec, M1), Wt, _ce(codec, rho), Pt,
                           _ce(codec, C), Xt, donate=donate)


def f_xr_update_gram(alpha, Pt, Xt, Zt, Rt, codec=None, donate: bool = False, group=None):
    """(Xn = X + alpha @ P, Rn = R - alpha @ Z, S' = Rn Rn^T) in one pass:
    the BCG/BCGA solution and residual updates. ``donate`` writes Xn onto X
    and Rn onto R; P and Z stay live."""
    from blockcg_tpu_torch.ops import fused

    Xn, Rn, S = fused.xr_update_gram(_ce(codec, alpha), Pt, Xt, Zt, Rt, donate=donate)
    return Xn, Rn, allreduce_if(_gc(codec, S), group)


def f_qr_p_update(M2, Q1t, rho, Pt, codec=None, donate: bool = False):
    """(Q = M2 @ Q1, Pn = Q + rho @ P) in one pass: the shifted-block
    SBCGrQ tail. ``donate`` writes Q onto Q1 and Pn onto P."""
    from blockcg_tpu_torch.ops import fused

    return fused.qr_p_update(_ce(codec, M2), Q1t, _ce(codec, rho), Pt, donate=donate)


def f_qr_px_update(M2, Q1t, rho, Pt, C, Xt, codec=None, donate: bool = False):
    """(Q = M2 @ Q1, Pn = Q + rho @ P, Xn = X + C @ P) in one pass: the
    fused SBCGrQ iteration tail, one read of P for both updates. ``donate``
    writes Q onto Q1, Pn onto P and Xn onto X."""
    from blockcg_tpu_torch.ops import fused

    return fused.qr_px_update(_ce(codec, M2), Q1t, _ce(codec, rho), Pt, _ce(codec, C), Xt,
                              donate=donate)


def f_matmat_gram(op, Xt, group=None):
    """(Z = A X, M = X^H Z), with the Gram fused into the operator apply when
    the operator supports it (its Gram is contracted, and local to the rank
    under a ``group``)."""
    Zt, M = op.matmat_gram_t(Xt)
    if M is None:
        return Zt, f_gram(Xt, Zt, codec=op, group=group)
    return Zt, allreduce_if(M, group)


# ------------------------------------------------------ thin-QR from Grams


def qr_factors_from_gram(G, want_cond: bool = False):
    """One equilibrated CholeskyQR pass from a precomputed Gram ``G = V V^T``
    (lanes-major): returns (M1, R1) with ``Q = M1 @ V`` and ``V = Q R1``;
    with ``want_cond`` also the 1-norm condition estimate ``kappa_1(G1)`` of
    the equilibrated Gram (bounds one-pass CholeskyQR's orthogonality loss)."""
    dg = torch.diagonal(G).real
    d = torch.rsqrt(torch.clamp_min(dg, torch.finfo(dg.dtype).tiny))
    G1 = G * d[:, None] * d[None, :]
    L = safe_cholesky(G1)
    Rinv_s = tri_inverse_upper(L.mH)
    M1 = Rinv_s.T * d[None, :]
    R1 = L.mH / d[None, :]
    if want_cond:
        G1inv = kk_mm(Rinv_s, Rinv_s.mH)
        cond1 = (G1.abs().sum(dim=0).max() * G1inv.abs().sum(dim=0).max())
        return M1, R1, cond1
    return M1, R1


def qr_gram_refine(M1, R1, G):
    """k x k-only second CholeskyQR pass computed from the Gram (zero field
    passes): ``H = conj(M1) G M1^T`` is Q1^H Q1 as implied by G; factoring H
    and folding it in repairs the factorization error of an ill-conditioned
    or jitter-repaired first pass."""
    H = kk_mm(M1.conj(), kk_mm(G, M1.T))
    H = 0.5 * (H + H.mH)
    M2, R2 = qr_factors_from_gram(H)
    return kk_mm(M2, M1), kk_mm(R2, R1)


def qr_ortho_err(M, G):
    """k x k-side orthogonality estimate ``max|conj(M) G M^T - I|`` of the
    transform M against the Gram G of the field it is applied to (the
    breakdown detector)."""
    H = kk_mm(M.conj(), kk_mm(G, M.T))
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    return (H - eye).abs().max()


def qr_passes_from_gram(G, Wt, passes: int, codec=None,
                        want_cond: bool = False, want_ortho: bool = False, group=None):
    """Run CholeskyQR passes given a precomputed Gram, deferring the final
    orthonormalization so the caller can fuse it. Returns (M_last, W_last,
    rho) (+ cond1 with ``want_cond``, + the orthogonality error with
    ``want_ortho``): ``Q = M_last @ W_last`` and ``V = Q rho``.

    ``passes=1`` is adaptive: the k x k Gram-side refinement always runs, and
    a real second field pass is taken only when kappa_1(G1) exceeds
    ``0.5 / sqrt(eps)``. The reference decides that inside ``lax.cond``; here
    it is a Python branch on one host read of kappa_1. ``donate`` on the
    second pass overwrites W, which is dead there."""
    if passes == 1:
        Mi, Ri, cond1 = qr_factors_from_gram(G, want_cond=True)
        kappa_crit = 0.5 / torch.finfo(G.real.dtype).eps ** 0.5
        if float(cond1) > kappa_crit:
            Wt, G2 = f_mm_update_gram(Mi, Wt, None, codec, donate=True, group=group)
            Mi2, Ri2 = qr_factors_from_gram(G2)
            oe = qr_ortho_err(Mi2, G2) if want_ortho else None
            Mi, rho = Mi2, kk_mm(Ri2, Ri)
        else:
            Mi, rho = qr_gram_refine(Mi, Ri, G)
            oe = qr_ortho_err(Mi, G) if want_ortho else None
        extras = ((cond1,) if want_cond else ()) + ((oe,) if want_ortho else ())
        return (Mi, Wt, rho) + extras

    rho = Mi = cond1 = None
    for p in range(passes):
        if p == 0 and want_cond:
            Mi, Ri, cond1 = qr_factors_from_gram(G, want_cond=True)
        else:
            Mi, Ri = qr_factors_from_gram(G)
        rho = Ri if rho is None else kk_mm(Ri, rho)
        if p < passes - 1:
            Wt, G = f_mm_update_gram(Mi, Wt, None, codec, donate=True, group=group)
    extras = ((cond1,) if want_cond else ()) + (
        (qr_ortho_err(Mi, G),) if want_ortho else ())
    return (Mi, Wt, rho) + extras


def residual_rebase(S, Sn):
    """Unitary change of basis between a drifted and a freshly recomputed
    residual factorization: ``U = S Sn^{-1}`` re-expresses the fresh pair in
    the old basis, keeping the solver's ``P^T Q = I`` invariant through a
    residual replacement. Regularized so exactly-zero residual columns map
    through the identity."""
    rdt = S.real.dtype
    d = (torch.finfo(rdt).eps * torch.diagonal(Sn).abs().max()
         + torch.finfo(rdt).tiny).to(S.dtype)
    E = d * torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    # U (Sn + dI) = (S + dI); Sn upper triangular with positive diagonal.
    Ut = torch.linalg.solve_triangular((Sn + E).T, (S + E).T, upper=False)
    return Ut.T


def cholqr_fused_t(Vt, passes: int = 2, codec=None, group=None):
    """Thin QR via CholeskyQR(passes) on the fused kernels. Returns (Qt, R)
    with V = Q R. V is left as it was: a second field pass would overwrite
    its operand, so it gets a copy (the reference's XLA inserts the same
    copy)."""
    G = f_gram(Vt, Vt, codec, group)
    Mi, Wt, rho = qr_passes_from_gram(G, Vt.clone(), passes, codec=codec, group=group)
    return f_mm_update(Mi, Wt, codec=codec), rho


# ------------------------------------------------------ solver entry checks


def check_precision(solver: str) -> None:
    """The k x k algebra and the plain f32 routes need full-f32 matmuls."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"{solver} needs full-f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False (TF32 keeps about "
            "three decimal digits)")


def check_complex_codec(op, B: torch.Tensor, solver: str) -> None:
    """A complex ``B`` needs an operator with a complex codec, whose
    ``to_internal`` hands the solver real stacked fields: a realified
    operator. Solves on complex fields themselves are not ported."""
    if B.is_complex() and not getattr(op, "complex_codec", False):
        raise NotImplementedError(
            f"{solver}: complex right-hand sides need a realified operator "
            "(operators.realify(op)); true-complex solves are not ported yet")


def block_setup(op, B: torch.Tensor, X0: torch.Tensor | None, solver: str):
    """The block solvers' entry checks, and their internal fields: B's
    lanes-major view and a private copy of X0, which they update in place."""
    if B.dim() == 1:
        raise ValueError(f"{solver} expects an (n, k) block; use solve_cg for k=1")
    check_complex_codec(op, B, solver)
    check_precision(solver)
    Bt = op.to_internal(B.T.contiguous())
    X0t = (torch.zeros_like(Bt) if X0 is None
           else op.to_internal(X0.T.clone(memory_format=torch.contiguous_format)))
    return Bt, X0t
