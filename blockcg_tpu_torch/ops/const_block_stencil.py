"""Const-hop block stencil and the slab accumulate of its periodic wrap
diagonals, on merged spin-major fields and on the (k, bs, ns) view.

Counterpart of ``blockcg_tpu/ops/const_block_stencil.py``; all run as
``csrc/const_block_stencil.cu``, whose row map is a pair of runtime strides:

- ``const_block_stencil_spmm_m_t``: ``Ym[a*k+i, s] = sum_d w_d(s) sum_b
  H_d[a][b] Xm[b*k+i, (s + o_d) mod ns]`` on an (m = bs*k, ns) field, with
  ``w_d = masks[mask_slot[d]]`` (a value: 0/1 gates or +-1 links), or 1 when
  ``mask_slot[d] == -1``;
- ``const_block_stencil_spmm_m_gram_t``: the same with ``Gm = X Y^T`` (m, m);
- ``slab_m_accumulate``: ``Y[:, dst slabs] += (H ⊗ I_k) X[:, src slabs]`` in
  place on Y, optionally with ``G = Gm + X_dst dY^T``;
- ``slab_m_accumulate_from``: ``Y[:, g-blocks dst_base + j] += v * (H ⊗
  I_k) Src[:, g-blocks src_base + j]`` from a separate (m, bw) source (the
  distributed layer's halo), v the per-site ``vals`` (gauged links) or 1,
  optionally with the Gram ``X_dst dY^T`` of the increment alone;
- ``const_block_stencil_spmm_t``, ``const_block_stencil_spmm_gram_t``,
  ``slab_block_accumulate`` and ``slab_block_accumulate_from``: the same sums
  on the (k, bs, ns) view (or its flat (k, bs*ns) form), ``Y[i, a, s] =
  sum_d w_d(s) sum_b H_d[a][b] X[i, b, (s + o_d) mod ns]``; the view's Gram
  contracts over spins and sites to (k, k), and its slab adds have no Gram
  or ``vals``, as in the reference. The reference's
  ``slab_block_accumulate_from`` body is broken (it passes ``_slab_kernel``
  three extra arguments and nothing calls it); the port follows its
  docstring's contract.

At k = 1 the two views are the same memory; ``ConstBlockDIAOperator`` sends
its single-RHS applies through the view's kernels, as the reference does.
The reference's merged kernel needs m % 8 == 0 (``plan_m``, a TPU sublane
rule) and falls back to XLA otherwise; the CUDA kernel takes any m, so
``ConstBlockDIAOperator.matmat_gram_t`` always returns a kernel's Gram. Hops
are the operator's (nd, bs, bs) buffer (nested tuples are accepted and
converted on each call).

Width: one launch holds at most 64 rows after bs is rounded up to a power of
two (``rhs_width(bs)`` right-hand sides). A wider field runs as one launch
per chunk of right-hand sides: on the merged view the chunk's rows
``a * k + j0 .. a * k + j1`` are strided, so the kernel takes the field's
spin stride ``ks = k`` beside the chunk's own width; on the (k, bs, ns) view
a chunk is contiguous. A Gram wider than one launch is ``fused.gram`` of X
and the stored Y (the merged (m, m) one, or the view's (k, k) one on the
flat fields); the slab's with-Gram form computes its increment on the slab's
columns alone, takes its Gram there, and adds it, so Y's bits are the
one-launch add's.

Dispatch follows ``ops/_native.py``: CPU and CUDA float64 tensors run the
plain versions below (the reference's ``_matmat_m_xla`` roll-and-einsum, and
an in-place slab add), CUDA float32 tensors launch the kernels. Kernel
bounds: at most 32 diagonals and bs <= 8; the wrappers raise outside them.
"""

from __future__ import annotations

import ctypes
import math

import torch

from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.solvers.common import acc_dtype, gram_t

MAX_DIAGS = 32  # csrc/const_block_stencil.cu kMaxDiags
MAX_BS = 8  # csrc/const_block_stencil.cu kMaxBs


def _hops(hops, Xm: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(hops, dtype=Xm.dtype, device=Xm.device)


def _check_main(hops, offsets, mask_slot, masks, Xm, name: str):
    if hops.dim() != 3 or hops.shape[1] != hops.shape[2]:
        raise ValueError(f"{name}: hops must be (nd, bs, bs), got {tuple(hops.shape)}")
    nd, bs, _ = hops.shape
    if Xm.dim() != 2 or Xm.shape[0] % bs:
        raise ValueError(f"{name}: expected an (m = {bs} * k, ns) field, got "
                         f"{tuple(Xm.shape)}")
    if len(offsets) != nd or len(mask_slot) != nd:
        raise ValueError(f"{name}: {nd} hops, {len(offsets)} offsets, "
                         f"{len(mask_slot)} mask slots")
    nmask = 0 if masks is None else masks.shape[0]
    if masks is not None and masks.shape != (nmask, Xm.shape[1]):
        raise ValueError(f"{name}: masks {tuple(masks.shape)} for {Xm.shape[1]} sites")
    if any(not -1 <= sl < nmask for sl in mask_slot):
        raise ValueError(f"{name}: mask slots {mask_slot} for {nmask} mask rows")


def rhs_width(bs: int, name: str = "const-hop kernel") -> int:
    """Right-hand sides one launch takes: 64 rows over bs rounded up to a
    power of two."""
    if not 1 <= bs <= MAX_BS:
        raise ValueError(f"{name}: the CUDA kernel takes bs <= {MAX_BS}, got {bs}")
    return _native.MAX_K // (1 << (bs - 1).bit_length())


# ------------------------------------------------------------ plain versions


def const_block_stencil_plain(hops, offsets, mask_slot, masks, Xm,
                              with_gram: bool = False):
    """Plain PyTorch version: the roll-and-einsum of the reference's
    ``ConstBlockDIAOperator._matmat_m_xla``. Returns ``(Ym, Gm or None)``
    with ``Gm = X Y^T`` taken on the accumulator."""
    bs = hops.shape[-1]
    m, ns = Xm.shape
    adt = acc_dtype(Xm.dtype)
    Xv = Xm.reshape(bs, m // bs, ns).to(adt)
    H = hops.to(adt)
    Yv = torch.zeros_like(Xv)
    for d, o in enumerate(offsets):
        src = Xv if o % ns == 0 else torch.roll(Xv, -o, dims=2)
        t = torch.tensordot(H[d], src, dims=1)
        if mask_slot[d] >= 0:
            t = t * masks[mask_slot[d]].to(adt)
        Yv += t
    Y = Yv.reshape(m, ns)
    return Y.to(Xm.dtype), (gram_t(Xm, Y) if with_gram else None)


def slab_columns(g: int, nblocks: int, dst_mul: int, dst_off: int,
                 src_shift: int, ns: int, device=None):
    """(dst, src) site indices of the slab sites, as the kernel walks them:
    destination block j -> (dst_mul * j + dst_off) mod nb, its source
    ``src_shift`` blocks away (toroidal)."""
    nb = ns // g
    j = torch.arange(nblocks, device=device)
    dblk = (dst_mul * j + dst_off) % nb
    sblk = (dblk + src_shift) % nb
    c = torch.arange(g, device=device)
    return (dblk[:, None] * g + c).reshape(-1), (sblk[:, None] * g + c).reshape(-1)


def slab_plain(hop, g, nblocks, dst_mul, dst_off, src_shift, Xm, Ym, Gm=None,
               with_gram: bool = False):
    """Plain version of ``slab_m_accumulate``: adds the slab's rows into Ym
    in place; returns ``Ym``, or ``(Ym, Gm + X_dst dY^T)`` with the Gram."""
    m, ns = Xm.shape
    bs = hop.shape[-1]
    adt = acc_dtype(Xm.dtype)
    dst, src = slab_columns(g, nblocks, dst_mul, dst_off, src_shift, ns, Xm.device)
    Xs = Xm[:, src].reshape(bs, m // bs, -1).to(adt)
    dY = torch.tensordot(hop.to(adt), Xs, dims=1).reshape(m, -1)
    Ym.index_add_(1, dst, dY.to(Ym.dtype))
    if not with_gram:
        return Ym
    G = gram_t(Xm[:, dst], dY)
    return Ym, (G if Gm is None else Gm + G)


def slab_from_plain(hop, g, nblocks, dst_base, src_base, Src, Ym, Xm=None, vals=None,
                    with_gram: bool = False):
    """Plain version of ``slab_m_accumulate_from``: adds the increment into
    Ym's slab columns in place; returns ``Ym``, or ``(Ym, X_dst dY^T)`` with
    the Gram."""
    m = Ym.shape[0]
    bs = hop.shape[-1]
    adt = acc_dtype(Ym.dtype)
    cols = nblocks * g
    d0, s0 = dst_base * g, src_base * g
    Xs = Src[:, s0:s0 + cols].reshape(bs, m // bs, cols).to(adt)
    dY = torch.tensordot(hop.to(adt), Xs, dims=1).reshape(m, cols)
    if vals is not None:
        dY = dY * vals.to(adt)
    Ym[:, d0:d0 + cols] += dY.to(Ym.dtype)
    return (Ym, gram_t(Xm[:, d0:d0 + cols], dY)) if with_gram else Ym


def _to_merged(Xv: torch.Tensor) -> torch.Tensor:
    k, bs, ns = Xv.shape
    return Xv.transpose(0, 1).reshape(bs * k, ns)


def _from_merged(Ym: torch.Tensor, k: int) -> torch.Tensor:
    m, ns = Ym.shape
    return Ym.reshape(m // k, k, ns).transpose(0, 1).contiguous()


def const_block_stencil_v_plain(hops, offsets, mask_slot, masks, Xv,
                                with_gram: bool = False):
    """Plain version on the (k, bs, ns) view: the merged version on the
    transposed field. Returns ``(Yv, G or None)``, G the (k, k)
    ``sum_{a,s} X[i, a, s] Y[j, a, s]`` taken on the accumulator."""
    k = Xv.shape[0]
    Ym = const_block_stencil_plain(hops, offsets, mask_slot, masks, _to_merged(Xv))[0]
    Yv = _from_merged(Ym, k)
    return Yv, (gram_t(Xv, Yv) if with_gram else None)


def slab_v_plain(hop, g, nblocks, dst_mul, dst_off, src_shift, Xv, Yv):
    """Plain version of ``slab_block_accumulate``: adds the slab's sites into
    the (k, bs, ns) view Yv in place and returns it."""
    adt = acc_dtype(Xv.dtype)
    dst, src = slab_columns(g, nblocks, dst_mul, dst_off, src_shift, Xv.shape[-1],
                            Xv.device)
    dY = torch.einsum("ab,kbs->kas", hop.to(adt), Xv[:, :, src].to(adt))
    return Yv.index_add_(2, dst, dY.to(Yv.dtype))


def slab_v_from_plain(hop, g, nblocks, dst_base, src_base, Src, Yv):
    """Plain version of ``slab_block_accumulate_from`` on the (k, bs, ns)
    view: adds in place and returns Yv."""
    adt = acc_dtype(Yv.dtype)
    cols = nblocks * g
    d0, s0 = dst_base * g, src_base * g
    dY = torch.einsum("ab,kbs->kas", hop.to(adt), Src[:, :, s0:s0 + cols].to(adt))
    Yv[:, :, d0:d0 + cols] += dY.to(Yv.dtype)
    return Yv


# ------------------------------------------------------------------ wrappers


def _launch_main(hops, offsets, mask_slot, masks, X, k: int, merged: bool,
                 with_gram: bool, name: str):
    """Launch on a contiguous (bs * k, ns)-shaped field X: the merged view,
    or the (k, bs, ns) view and its flat form, one launch per chunk of
    right-hand sides. Returns (Y shaped like X, the (m, m) Gram on the
    merged view, the (k, k) one on the other, or None)."""
    from blockcg_tpu_torch.ops import fused

    nd, bs, _ = hops.shape
    m = bs * k
    ns = X.numel() // m
    chunks = _native.row_chunks(k, rhs_width(bs, name))
    if nd > MAX_DIAGS:
        raise ValueError(f"{name}: {nd} diagonals, the CUDA kernel takes at most {MAX_DIAGS}")
    offs = (ctypes.c_int * nd)(*(int(o) % ns for o in offsets))
    slots = (ctypes.c_int * nd)(*mask_slot)
    Y = torch.empty_like(X)
    nb = _native.nblocks(ns)
    fused_gram = with_gram and len(chunks) == 1
    part = G = None
    if fused_gram:
        part = torch.empty((nb, m, m), dtype=torch.float32, device=X.device)
        g = m if merged else k
        G = torch.empty((g, g), dtype=torch.float32, device=X.device)
    row = ns * 4 * (1 if merged else bs)  # bytes from one RHS to the next
    p = _native.ptr
    for j0, j1 in chunks:
        _native.launch(name, "bcg_cbs_spmm", X.device, p(hops), offs, slots, nd, bs,
                       p(masks), p(X) + j0 * row, p(Y) + j0 * row, p(part), p(G), j1 - j0,
                       k if merged else j1 - j0, ns, int(merged), nb)
    if with_gram and not fused_gram:
        G = fused.gram(X, Y) if merged else fused.gram(X.reshape(k, -1), Y.reshape(k, -1))
    return Y, G


def _main(hops, offsets, mask_slot, masks, Xm, with_gram: bool, name: str):
    hops = _hops(hops, Xm)
    _check_main(hops, offsets, mask_slot, masks, Xm, name)
    ops = (hops, Xm) if masks is None else (hops, masks, Xm)
    if not _native.use_kernel(*ops):
        return const_block_stencil_plain(hops, offsets, mask_slot, masks, Xm, with_gram)
    return _launch_main(hops, offsets, mask_slot, masks, Xm, Xm.shape[0] // hops.shape[-1],
                        True, with_gram, name)


def _view(hops, offsets, mask_slot, masks, Xt, with_gram: bool, name: str):
    """The (k, bs, ns) view or its flat (k, bs*ns) form; Y comes back in
    Xt's shape."""
    hops = _hops(hops, Xt)
    bs = hops.shape[-1]
    if Xt.dim() not in (2, 3) or (Xt.dim() == 3 and Xt.shape[1] != bs) or (
            Xt.dim() == 2 and Xt.shape[1] % bs):
        raise ValueError(f"{name}: expected a (k, {bs}, ns) or (k, {bs} * ns) field, "
                         f"got {tuple(Xt.shape)}")
    k = Xt.shape[0]
    ns = Xt.numel() // (bs * k)
    # The merged view's checks, on the field's (bs * k, ns) shape.
    _check_main(hops, offsets, mask_slot, masks, Xt.reshape(bs * k, ns), name)
    ops = (hops, Xt) if masks is None else (hops, masks, Xt)
    if not _native.use_kernel(*ops):
        Yv, G = const_block_stencil_v_plain(hops, offsets, mask_slot, masks,
                                            Xt.reshape(k, bs, ns), with_gram)
        return Yv.reshape(Xt.shape), G
    return _launch_main(hops, offsets, mask_slot, masks, Xt, k, False, with_gram, name)


def const_block_stencil_spmm_m_t(hops, offsets: tuple[int, ...],
                                 mask_slot: tuple[int, ...],
                                 masks: torch.Tensor | None,
                                 Xm: torch.Tensor) -> torch.Tensor:
    """Merged-layout const-hop block SpMM: hops (nd, bs, bs), masks
    (nmask, ns) or None, Xm (m = bs*k, ns) with row a*k + i. Returns Ym."""
    return _main(hops, offsets, mask_slot, masks, Xm, False,
                 "const_block_stencil_spmm_m_t")[0]


def const_block_stencil_spmm_m_gram_t(hops, offsets: tuple[int, ...],
                                      mask_slot: tuple[int, ...],
                                      masks: torch.Tensor | None,
                                      Xm: torch.Tensor):
    """``(Ym, Gm = X Y^T)``, Gm (m, m); contract it to k x k with the
    operator's ``gram_contract``."""
    return _main(hops, offsets, mask_slot, masks, Xm, True,
                 "const_block_stencil_spmm_m_gram_t")


def const_block_stencil_spmm_t(hops, offsets: tuple[int, ...],
                               mask_slot: tuple[int, ...],
                               masks: torch.Tensor | None,
                               Xt: torch.Tensor) -> torch.Tensor:
    """Const-hop block SpMM on the (k, bs, ns) view, or its flat (k, bs*ns)
    form; returns Yt shaped like Xt."""
    return _view(hops, offsets, mask_slot, masks, Xt, False,
                 "const_block_stencil_spmm_t")[0]


def const_block_stencil_spmm_gram_t(hops, offsets: tuple[int, ...],
                                    mask_slot: tuple[int, ...],
                                    masks: torch.Tensor | None,
                                    Xt: torch.Tensor):
    """``(Yt, G)`` on the (k, bs, ns) view, with the (k, k) Gram ``G[i, j] =
    sum_{a, s} X[i, a, s] Y[j, a, s]`` (the solvers' ``P^T A P``)."""
    return _view(hops, offsets, mask_slot, masks, Xt, True,
                 "const_block_stencil_spmm_gram_t")


def _check_slab(hop, g, nblocks, dst_mul, Xm, Ym, Gm, name):
    m, ns = Xm.shape
    bs = hop.shape[-1]
    if hop.shape != (bs, bs) or m % bs:
        raise ValueError(f"{name}: hop {tuple(hop.shape)} for an ({m}, {ns}) field")
    if Ym.shape != Xm.shape:
        raise ValueError(f"{name}: Y {tuple(Ym.shape)} for X {tuple(Xm.shape)}")
    if Gm is not None and Gm.shape != (m, m):
        raise ValueError(f"{name}: Gm {tuple(Gm.shape)}, expected ({m}, {m})")
    if g < 1 or ns % g:
        raise ValueError(f"{name}: slab width {g} does not divide {ns} sites")
    nb = ns // g
    # Distinct destination blocks: each destination column has one writer.
    if not 1 <= nblocks <= nb // math.gcd(dst_mul, nb):
        raise ValueError(f"{name}: {nblocks} slabs of stride {dst_mul} repeat a "
                         f"destination among {nb} blocks")


def slab_m_accumulate(hop, g: int, nblocks: int, dst_mul: int, dst_off: int,
                      src_shift: int, Xm: torch.Tensor, Ym: torch.Tensor,
                      Gm: torch.Tensor | None = None, *, with_gram: bool = False):
    """``Y[:, dst slabs] += (hop ⊗ I_k) X[:, src slabs]`` in place on Ym.

    Destination slab j < nblocks covers sites [(dst_mul*j + dst_off mod nb)*g,
    ... + g), nb = ns / g; its source sits ``src_shift`` slabs away
    (toroidal). Returns Ym, or with ``with_gram`` ``(Ym, G = Gm + X_dst
    dY^T)`` (Gm None counts as zero)."""
    name = "slab_m_accumulate"
    hop = _hops(hop, Xm)
    _check_slab(hop, g, nblocks, dst_mul, Xm, Ym, Gm if with_gram else None, name)
    ops = [hop, Xm, Ym] + ([Gm] if with_gram and Gm is not None else [])
    if not _native.use_kernel(*ops):
        return slab_plain(hop, g, nblocks, dst_mul, dst_off, src_shift, Xm, Ym,
                          Gm, with_gram)
    m, ns = Xm.shape
    bs = hop.shape[-1]
    k = m // bs
    chunks = _native.row_chunks(k, rhs_width(bs, name))
    if Ym.data_ptr() == Xm.data_ptr():
        raise ValueError(f"{name}: Y must not share X's storage")
    if with_gram and len(chunks) > 1:
        # On the slab's own columns: the source sites gathered into a compact
        # field whose block j is slab j, the increment into a zeroed buffer
        # (the same bits as the fused add), its Gram against X's destination
        # sites, then the add.
        from blockcg_tpu_torch.ops import fused

        dst, src = slab_columns(g, nblocks, dst_mul, dst_off, src_shift, ns, Xm.device)
        Xs = Xm[:, src]
        dY = slab_m_accumulate(hop, g, nblocks, 1, 0, 0, Xs, torch.zeros_like(Xs))
        G = fused.gram(Xm[:, dst], dY)
        Ym[:, dst] += dY
        return Ym, (G if Gm is None else Gm + G)
    nb = ns // g
    G = _launch_slab(name, hop, g, nblocks, (dst_mul % nb, dst_off % nb),
                     (dst_mul % nb, (dst_off + src_shift) % nb), Xm, ns, None, Xm, Ym,
                     Gm if with_gram else None, with_gram, chunks, True)
    return (Ym, G) if with_gram else Ym


def slab_block_accumulate(hop, g: int, nblocks: int, dst_mul: int, dst_off: int,
                          src_shift: int, Xv: torch.Tensor,
                          Yv: torch.Tensor) -> torch.Tensor:
    """``Y[:, :, dst slabs] += hop @ X[:, :, src slabs]`` in place on the
    (k, bs, ns) view Yv (slab geometry as in :func:`slab_m_accumulate`);
    returns Yv."""
    name = "slab_block_accumulate"
    hop = _hops(hop, Xv)
    bs = hop.shape[-1]
    if Xv.dim() != 3 or Xv.shape[1] != bs or Yv.shape != Xv.shape:
        raise ValueError(f"{name}: expected (k, {bs}, ns) fields X and Y, got "
                         f"{tuple(Xv.shape)} and {tuple(Yv.shape)}")
    k, _, ns = Xv.shape
    _check_slab(hop, g, nblocks, dst_mul, Xv.reshape(bs * k, ns), Yv.reshape(bs * k, ns),
                None, name)
    if not _native.use_kernel(hop, Xv, Yv):
        return slab_v_plain(hop, g, nblocks, dst_mul, dst_off, src_shift, Xv, Yv)
    chunks = _native.row_chunks(k, rhs_width(bs, name))
    if Yv.data_ptr() == Xv.data_ptr():
        raise ValueError(f"{name}: Y must not share X's storage")
    nb = ns // g
    _launch_slab(name, hop, g, nblocks, (dst_mul % nb, dst_off % nb),
                 (dst_mul % nb, (dst_off + src_shift) % nb), Xv, ns, None, None, Yv, None,
                 False, chunks, False)
    return Yv


def _check_from(hop, g, nblocks, dst_base, src_base, m, bw, ns, vals, name):
    """The halo slab's geometry on merged-shaped (m, bw) source and (m, ns)
    destination: whole g-site blocks inside both, vals one per slab site."""
    bs = hop.shape[-1]
    if hop.shape != (bs, bs) or m % bs:
        raise ValueError(f"{name}: hop {tuple(hop.shape)} for {m} rows")
    if g < 1 or ns % g or bw % g:
        raise ValueError(f"{name}: slab width {g} must divide the {ns} sites and the "
                         f"{bw}-site source")
    if nblocks < 1 or not 0 <= dst_base <= ns // g - nblocks or \
            not 0 <= src_base <= bw // g - nblocks:
        raise ValueError(f"{name}: {nblocks} blocks from {src_base} (of {bw // g}) to "
                         f"{dst_base} (of {ns // g})")
    if vals is not None and vals.shape != (1, nblocks * g):
        raise ValueError(f"{name}: vals {tuple(vals.shape)}, expected (1, {nblocks * g})")


def slab_m_accumulate_from(hop, g: int, nblocks: int, dst_base: int, src_base: int,
                           Src: torch.Tensor, Ym: torch.Tensor, Xm: torch.Tensor | None = None,
                           vals: torch.Tensor | None = None, *, with_gram: bool = False):
    """``Y[:, g-blocks dst_base + j] += v * (hop ⊗ I_k) Src[:, g-blocks
    src_base + j]``, j < nblocks, in place on the merged (m, ns) Ym, from a
    separate merged (m, bw) source (a received halo; its row stride is bw).
    ``vals`` (1, nblocks * g) scales each destination site (gauged
    crossings), or None. Returns Ym, or with ``with_gram`` ``(Ym, G)``, G
    the (m, m) Gram ``sum_dst X_dst dY^T`` of the increment alone, X the
    local field ``Xm``."""
    name = "slab_m_accumulate_from"
    hop = _hops(hop, Ym)
    if Src.dim() != 2 or Ym.dim() != 2 or Src.shape[0] != Ym.shape[0]:
        raise ValueError(f"{name}: Src {tuple(Src.shape)} and Y {tuple(Ym.shape)} must be "
                         "merged fields of one height")
    m, ns = Ym.shape
    bw = Src.shape[1]
    _check_from(hop, g, nblocks, dst_base, src_base, m, bw, ns, vals, name)
    if with_gram and (Xm is None or Xm.shape != Ym.shape):
        raise ValueError(f"{name}: the Gram needs the local field X shaped like Y")
    ops = ([hop, Src, Ym] + ([vals] if vals is not None else [])
           + ([Xm] if with_gram else []))
    if not _native.use_kernel(*ops):
        return slab_from_plain(hop, g, nblocks, dst_base, src_base, Src, Ym, Xm, vals,
                               with_gram)
    bs = hop.shape[-1]
    chunks = _native.row_chunks(m // bs, rhs_width(bs, name))
    if Ym.data_ptr() in (Src.data_ptr(), Xm.data_ptr() if with_gram else None):
        raise ValueError(f"{name}: Y must not share Src's or X's storage")
    if with_gram and len(chunks) > 1:
        # As in slab_m_accumulate: the increment into a zeroed compact field,
        # its Gram against X's destination columns, then the add.
        from blockcg_tpu_torch.ops import fused

        cols = nblocks * g
        d0 = dst_base * g
        dY = slab_m_accumulate_from(hop, g, nblocks, 0, src_base, Src,
                                    torch.zeros((m, cols), device=Ym.device), vals=vals)
        G = fused.gram(Xm[:, d0:d0 + cols].contiguous(), dY)
        Ym[:, d0:d0 + cols] += dY
        return Ym, G
    nb, src_nb = ns // g, bw // g
    G = _launch_slab(name, hop, g, nblocks, (1 % nb, dst_base), (1 % src_nb, src_base), Src,
                     bw, vals, Xm, Ym, None, with_gram, chunks, True)
    return (Ym, G) if with_gram else Ym


def slab_block_accumulate_from(hop, g: int, nblocks: int, dst_base: int, src_base: int,
                               Src: torch.Tensor, Yv: torch.Tensor) -> torch.Tensor:
    """``Y[:, :, g-blocks dst_base + j] += hop @ Src[:, :, g-blocks src_base +
    j]`` in place on the (k, bs, ns) view Yv, from a separate (k, bs, bw)
    source; returns Yv. At k = 1 it is ``slab_m_accumulate_from`` without
    ``vals`` on the same memory."""
    name = "slab_block_accumulate_from"
    hop = _hops(hop, Yv)
    bs = hop.shape[-1]
    if (Yv.dim() != 3 or Src.dim() != 3 or Yv.shape[1] != bs
            or Src.shape[:2] != Yv.shape[:2]):
        raise ValueError(f"{name}: expected (k, {bs}, .) fields Src and Y, got "
                         f"{tuple(Src.shape)} and {tuple(Yv.shape)}")
    k, _, ns = Yv.shape
    bw = Src.shape[2]
    _check_from(hop, g, nblocks, dst_base, src_base, bs * k, bw, ns, None, name)
    if not _native.use_kernel(hop, Src, Yv):
        return slab_v_from_plain(hop, g, nblocks, dst_base, src_base, Src, Yv)
    if Yv.data_ptr() == Src.data_ptr():
        raise ValueError(f"{name}: Y must not share Src's storage")
    chunks = _native.row_chunks(k, rhs_width(bs, name))
    _launch_slab(name, hop, g, nblocks, (1 % (ns // g), dst_base), (1 % (bw // g), src_base),
                 Src, bw, None, None, Yv, None, False, chunks, False)
    return Yv


def _launch_slab(name, hop, g, nblocks, dst, src, X, xn, vals, Xd, Y, Gin, with_gram,
                 chunks, merged):
    """One slab launch per row chunk: ``dst`` and ``src`` are the reduced
    (mul, off) block maps of Y (ns columns) and X (xn columns), see
    ``csrc/const_block_stencil.cu``. Returns the (m, m) Gram, Gin plus the
    slab's (merged, one chunk only), or None."""
    bs = hop.shape[-1]
    k = Y.shape[0] // bs if merged else Y.shape[0]
    ns = Y.numel() // (bs * k)
    grid = _native.nblocks(nblocks * g)
    part = G = None
    if with_gram:
        m = bs * k
        part = torch.empty((grid, m, m), dtype=torch.float32, device=Y.device)
        G = torch.empty((m, m), dtype=torch.float32, device=Y.device)
    # Bytes from one RHS to the next: the merged view's rows are a spin
    # stride apart (k), the view's chunks are contiguous.
    yrow, xrow = (ns * 4, xn * 4) if merged else (bs * ns * 4, bs * xn * 4)
    p = _native.ptr
    for j0, j1 in chunks:
        _native.launch(name, "bcg_slab_accumulate", Y.device, p(hop), bs, g, nblocks, *dst,
                       *src, p(X) + j0 * xrow, xn, p(vals),
                       None if Xd is None else p(Xd) + j0 * yrow, p(Y) + j0 * yrow, p(Gin),
                       p(part), p(G), j1 - j0, k if merged else j1 - j0, ns, int(merged),
                       grid)
    return G
