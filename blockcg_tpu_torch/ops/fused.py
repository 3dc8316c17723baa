"""Fused per-iteration block updates on lanes-major (k, n) fields.

Counterpart of the main-path kernels of ``blockcg_tpu/ops/fused.py``:

- ``gram(U, V)``                      G = U V^T            (``csrc/gram.cu``)
- ``mm_update(M, B, A)``              Y = M B (+ A)        (``csrc/fused_update.cu``)
- ``mm_update_gram(M, B, A)``         Y = M B (+ A), G = Y Y^T
- ``mm2_update_gram(M1, B1, M2, B2)`` Y = M1 B1 + M2 B2, G = Y Y^T
- ``px_update(M1, W, rho, P, C, X)``  Pn = M1 W + rho P, Xn = X + C P
                                                           (``csrc/px_update.cu``)
- ``xr_update_gram(a, P, X, Z, R)``   Xn = X + a P, Rn = R - a Z, G = Rn Rn^T
                                                           (``csrc/xr_update.cu``)
- ``qr_p_update(M2, Q1, rho, P)``     Q = M2 Q1, Pn = Q + rho P
                                                           (``csrc/qr_p_update.cu``)
- ``cheb_step(R, Z, D, AZ, c1, c2)``  D' = c1 D + c2 (R - AZ), Z' = Z + D'
                                                           (``csrc/cheb_step.cu``)

Each has a plain PyTorch version beside it, the composition the reference's
solvers fall back to (``blockcg_tpu/solvers/common.py:216-218, 233-237,
254-255, 271-273, 286-287, 299-300``, ``blockcg_tpu/operators/cheb.py:54-55``). Dispatch follows
``ops/_native.py``: CPU and CUDA float64 run the plain version, CUDA float32
launches the kernel. Grams are taken on the stored output. Fields must be
contiguous; the k x k coefficients are made so (they are often transposed
views).

``donate`` writes an output into the storage of the named input, which the
caller must treat as dead afterwards; both routes honour it, so a caller that
still reads a donated input fails on the CPU as it would on the card. Column
i of every output depends only on column i of the inputs, which is what makes
the kernels' in-place writes safe.
"""

from __future__ import annotations

import torch

from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.solvers.common import gram_t, mm


def _into(dst, Y):
    """Write Y into the donated operand ``dst`` (or return Y as it is)."""
    return Y if dst is None else dst.copy_(Y)


# ------------------------------------------------------------ plain versions


def gram_plain(U, V):
    return gram_t(U, V)


def mm_update_plain(M, B, A=None):
    Y = mm(M, B)
    return (Y if A is None else Y + A).to(B.dtype)


def mm_update_gram_plain(M, B, A=None):
    Y = mm_update_plain(M, B, A)
    return Y, gram_t(Y, Y)


def mm2_update_gram_plain(M1, B1, M2, B2):
    Y = (mm(M1, B1) + mm(M2, B2)).to(B1.dtype)
    return Y, gram_t(Y, Y)


def px_update_plain(M1, W, rho, P, C, X):
    Pn = (mm(M1, W) + mm(rho, P)).to(P.dtype)
    return Pn, (X + mm(C, P)).to(X.dtype)


def xr_update_gram_plain(alpha, P, X, Z, R):
    Xn = (X + mm(alpha, P)).to(X.dtype)
    Rn = (R - mm(alpha, Z)).to(R.dtype)
    return Xn, Rn, gram_t(Rn, Rn)


def qr_p_update_plain(M2, Q1, rho, P):
    Q = mm(M2, Q1)
    return Q.to(Q1.dtype), (Q + mm(rho, P)).to(P.dtype)


def cheb_step_plain(R, Z, D, AZ, c1: float, c2: float):
    Dn = c1 * D + c2 * (R - AZ)
    return Z + Dn, Dn


# ------------------------------------------------------------------ wrappers


def _gram_buffers(k: int, n: int, device):
    part = torch.empty((_native.nblocks(n), k, k), dtype=torch.float32, device=device)
    return part, torch.empty((k, k), dtype=torch.float32, device=device)


def _field_shape(F, name):
    if F.dim() != 2:
        raise ValueError(f"{name}: CUDA kernels take flat (k, n) fields, got {tuple(F.shape)}")
    k, n = F.shape
    _native.check_width(k)
    return k, n


def gram(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """G = U V^T over the field dims: (k, n) x (k, n) -> (k, k)."""
    if not _native.use_kernel(U, V):
        return gram_plain(U, V)
    k, n = _field_shape(U, "gram")
    _native.check_field(V, k, n, "gram V")
    part, G = _gram_buffers(k, n, U.device)
    _native.launch("gram", "bcg_gram", U.device, _native.ptr(U), _native.ptr(V),
                   _native.ptr(part), _native.ptr(G), k, n, _native.nblocks(n))
    return G


def _coeff_update(name, M1, B1, M2, B2, A, with_gram, out):
    k, n = _field_shape(B1, name)
    for F, what in ((B2, "B2"), (A, "A")):
        if F is not None:
            _native.check_field(F, k, n, f"{name} {what}")
    for M, what in ((M1, "M1"), (M2, "M2")):
        if M is not None:
            _native.check_kk(M, k, f"{name} {what}")
    Y = torch.empty_like(B1) if out is None else out
    part, G = _gram_buffers(k, n, B1.device) if with_gram else (None, None)
    p = _native.ptr
    _native.launch(name, "bcg_coeff_update", B1.device, p(M1), p(B1), p(M2),
                   p(B2), p(A), p(Y), p(part), p(G), k, n, _native.nblocks(n))
    return Y, G


def mm_update(M: torch.Tensor, B: torch.Tensor,
              A: torch.Tensor | None = None, *,
              donate: str | None = None) -> torch.Tensor:
    """Y = M B (+ A); M (k, k), fields (k, n). ``donate`` 'b' writes Y onto
    B, 'a' onto A."""
    M = M.contiguous()
    ops = (M, B) if A is None else (M, B, A)
    if donate not in (None, "a", "b") or (donate == "a" and A is None):
        raise ValueError(f"mm_update: donate must be None, 'b' or 'a' (with A), got {donate!r}")
    dst = {None: None, "a": A, "b": B}[donate]
    if not _native.use_kernel(*ops):
        return _into(dst, mm_update_plain(M, B, A))
    return _coeff_update("mm_update", M, B, None, None, A, False, dst)[0]


def mm_update_gram(M: torch.Tensor, B: torch.Tensor,
                   A: torch.Tensor | None = None, *, donate: bool = False):
    """(Y = M B (+ A), G = Y Y^T); ``donate`` writes Y onto B."""
    M = M.contiguous()
    ops = (M, B) if A is None else (M, B, A)
    dst = B if donate else None
    if not _native.use_kernel(*ops):
        Y, G = mm_update_gram_plain(M, B, A)
        return _into(dst, Y), G
    return _coeff_update("mm_update_gram", M, B, None, None, A, True, dst)


def mm2_update_gram(M1: torch.Tensor, B1: torch.Tensor, M2: torch.Tensor,
                    B2: torch.Tensor, *, donate: bool = False):
    """(Y = M1 B1 + M2 B2, G = Y Y^T); ``donate`` writes Y onto B1."""
    M1, M2 = M1.contiguous(), M2.contiguous()
    dst = B1 if donate else None
    if not _native.use_kernel(M1, B1, M2, B2):
        Y, G = mm2_update_gram_plain(M1, B1, M2, B2)
        return _into(dst, Y), G
    return _coeff_update("mm2_update_gram", M1, B1, M2, B2, None, True, dst)


def px_update(M1: torch.Tensor, W: torch.Tensor, rho: torch.Tensor,
              P: torch.Tensor, C: torch.Tensor, X: torch.Tensor, *,
              donate: bool = False):
    """(Pn = M1 W + rho P, Xn = X + C P); ``donate`` writes Pn onto P and Xn
    onto X."""
    M1, rho, C = M1.contiguous(), rho.contiguous(), C.contiguous()
    if not _native.use_kernel(M1, W, rho, P, C, X):
        Pn, Xn = px_update_plain(M1, W, rho, P, C, X)
        if donate:
            return P.copy_(Pn), X.copy_(Xn)
        return Pn, Xn
    k, n = _field_shape(W, "px_update")
    for F, what in ((P, "P"), (X, "X")):
        _native.check_field(F, k, n, f"px_update {what}")
    for M, what in ((M1, "M1"), (rho, "rho"), (C, "C")):
        _native.check_kk(M, k, f"px_update {what}")
    Pn, Xn = (P, X) if donate else (torch.empty_like(P), torch.empty_like(X))
    p = _native.ptr
    _native.launch("px_update", "bcg_px_update", W.device, p(M1), p(W), p(rho),
                   p(P), p(C), p(X), p(Pn), p(Xn), k, n, _native.nblocks(n))
    return Pn, Xn


def xr_update_gram(alpha: torch.Tensor, P: torch.Tensor, X: torch.Tensor,
                   Z: torch.Tensor, R: torch.Tensor, *, donate: bool = False):
    """(Xn = X + alpha P, Rn = R - alpha Z, G = Rn Rn^T); ``donate`` writes
    Xn onto X and Rn onto R (P and Z are only read)."""
    alpha = alpha.contiguous()
    if not _native.use_kernel(alpha, P, X, Z, R):
        Xn, Rn, G = xr_update_gram_plain(alpha, P, X, Z, R)
        if donate:
            return X.copy_(Xn), R.copy_(Rn), G
        return Xn, Rn, G
    k, n = _field_shape(P, "xr_update_gram")
    for F, what in ((X, "X"), (Z, "Z"), (R, "R")):
        _native.check_field(F, k, n, f"xr_update_gram {what}")
    _native.check_kk(alpha, k, "xr_update_gram alpha")
    Xn, Rn = (X, R) if donate else (torch.empty_like(X), torch.empty_like(R))
    part, G = _gram_buffers(k, n, P.device)
    p = _native.ptr
    _native.launch("xr_update_gram", "bcg_xr_update_gram", P.device, p(alpha), p(P),
                   p(X), p(Z), p(R), p(Xn), p(Rn), p(part), p(G), k, n,
                   _native.nblocks(n))
    return Xn, Rn, G


def qr_p_update(M2: torch.Tensor, Q1: torch.Tensor, rho: torch.Tensor,
                P: torch.Tensor, *, donate: bool = False):
    """(Q = M2 Q1, Pn = Q + rho P); ``donate`` writes Q onto Q1 and Pn onto
    P."""
    M2, rho = M2.contiguous(), rho.contiguous()
    if not _native.use_kernel(M2, Q1, rho, P):
        Q, Pn = qr_p_update_plain(M2, Q1, rho, P)
        if donate:
            return Q1.copy_(Q), P.copy_(Pn)
        return Q, Pn
    k, n = _field_shape(Q1, "qr_p_update")
    _native.check_field(P, k, n, "qr_p_update P")
    for M, what in ((M2, "M2"), (rho, "rho")):
        _native.check_kk(M, k, f"qr_p_update {what}")
    Q, Pn = (Q1, P) if donate else (torch.empty_like(Q1), torch.empty_like(P))
    p = _native.ptr
    _native.launch("qr_p_update", "bcg_qr_p_update", Q1.device, p(M2), p(Q1), p(rho),
                   p(P), p(Q), p(Pn), k, n, _native.nblocks(n))
    return Q, Pn


def cheb_step(R: torch.Tensor, Z: torch.Tensor, D: torch.Tensor, AZ: torch.Tensor,
              c1: float, c2: float, *, donate: bool = False):
    """One Chebyshev semi-iteration step on four fields of one shape, any
    contiguous layout: returns ``(Z' = Z + D', D' = c1 D + c2 (R - AZ))``.
    ``c1`` and ``c2`` are host scalars (float32 on the kernel route).
    ``donate`` writes Z' onto Z and D' onto D, which must not share storage."""
    if donate and Z.data_ptr() == D.data_ptr():
        raise ValueError("cheb_step: donated Z and D share storage")
    if not (R.shape == Z.shape == D.shape == AZ.shape):
        raise ValueError(f"cheb_step: fields of shapes {[tuple(F.shape) for F in (R, Z, D, AZ)]}")
    if not _native.use_kernel(R, Z, D, AZ):
        Zn, Dn = cheb_step_plain(R, Z, D, AZ, c1, c2)
        if donate:
            return Z.copy_(Zn), D.copy_(Dn)
        return Zn, Dn
    Zo, Do = (Z, D) if donate else (torch.empty_like(Z), torch.empty_like(D))
    p = _native.ptr
    _native.launch("cheb_step", "bcg_cheb_step", R.device, p(R), p(Z), p(D), p(AZ),
                   p(Zo), p(Do), float(c1), float(c2), R.numel())
    return Zo, Do
