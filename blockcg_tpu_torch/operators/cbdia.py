"""Constant-hop Block-DIA operator: site-independent bs x bs blocks on fixed
site offsets, with per-site masks.

Counterpart of ``blockcg_tpu/operators/cbdia.py``. Semantics:

    A[(a, s), (b, (s + offsets[d]) mod ns)] = hops[d][a][b] * mask_d[s]

with ``mask_d = masks[mask_slot[d]]`` (0/1 boundary gates, or link values
for the gauged operators), and 1 where ``mask_slot[d] == -1``. Rows are
spin-major: row ``a * ns + s``. Complex hops (the complex ``dirac_cbdia``)
make a container: its apply runs the plain version on CPU tensors and raises
on the card, where ``operators.realify`` (doubled real hops) is its route.

The solvers keep their state in the merged spin-major view ``(m = bs * k,
ns)``, row ``a * k + i`` (``to_internal``), and the codec hooks expand every
k x k coefficient to ``I_bs ⊗ C`` and contract (m, m) Grams back to k x k.
Diagonals listed in ``slabs`` (periodic wraps whose support is whole
g-site slabs, found by ``detect_slabs``) go through the slab kernel instead of the
main one. ``matmat_t`` on a single right-hand side (m = bs) runs the
(k, bs, ns) view's kernels, as the reference does; ``matmat_gram_t`` keeps
the merged ones at every width. The main kernel's hop table, mask rows and reduced offsets are
built once, here, as buffers on the operator's device: the reference
gathers them per call inside ``jit``, which a per-call gather or copy would
turn into extra launches on every iteration.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from blockcg_tpu_torch.operators.base import MatmatMixin
from blockcg_tpu_torch.ops import _native
from blockcg_tpu_torch.ops import const_block_stencil as cbs


def _hop_tuple(h) -> tuple:
    """A hop as nested Python scalars: complex when any entry is, else
    floats."""
    rows = tuple(tuple(v for v in row) for row in h)
    cplx = any(isinstance(v, (complex, np.complexfloating)) for row in rows for v in row)
    scal = complex if cplx else float
    return tuple(tuple(scal(v) for v in row) for row in rows)


class ConstBlockDIAOperator(MatmatMixin, nn.Module):
    """masks: (nmask, ns) buffer or None; hops (noff x bs x bs floats),
    offsets, mask_slot, num_sites and slabs are Python tuples. A slab entry is
    ``(d, g, nblocks, dst_mul, dst_off, src_shift)``. ``nnz`` is the
    builder's structural count (default ``noff * bs^2 * ns``). ``dtype`` is
    the real dtype of the masks (with no masks, of the hop tables) and
    ``device`` where they live; complex hops get tables of the matching
    complex dtype."""

    def __init__(self, masks: torch.Tensor | None, hops, offsets, mask_slot,
                 num_sites: int, slabs=(), nnz: int | None = None, *,
                 dtype: torch.dtype | None = None, device=None):
        super().__init__()
        self.hops = tuple(_hop_tuple(h) for h in hops)
        self.offsets = tuple(int(o) for o in offsets)
        self.mask_slot = tuple(int(sl) for sl in mask_slot)
        self.num_sites = int(num_sites)
        self.slabs = tuple(tuple(int(v) for v in e) for e in slabs)
        bs = len(self.hops[0])
        if any(len(h) != bs or any(len(r) != bs for r in h) for h in self.hops):
            raise ValueError("every hop must be a bs x bs block of one size")
        if not len(self.hops) == len(self.offsets) == len(self.mask_slot):
            raise ValueError(f"{len(self.hops)} hops, {len(self.offsets)} offsets, "
                             f"{len(self.mask_slot)} mask slots")
        nmask = 0 if masks is None else masks.shape[0]
        if masks is not None and masks.shape != (nmask, self.num_sites):
            raise ValueError(f"masks {tuple(masks.shape)} for {self.num_sites} sites")
        if any(not -1 <= sl < nmask for sl in self.mask_slot):
            raise ValueError(f"mask slots {self.mask_slot} for {nmask} mask rows")
        if masks is not None:
            dtype = masks.dtype if dtype is None else dtype
            device = masks.device if device is None else device
            masks = masks.to(dtype=dtype, device=device)
        dtype = dtype or torch.float32
        self._nnz = nnz
        self.register_buffer("masks", masks)
        cplx = any(isinstance(v, complex) for h in self.hops for row in h for v in row)
        hdt = dtype.to_complex() if cplx else dtype

        def table(hs):
            return torch.tensor(hs, dtype=hdt, device=device).reshape(len(hs), bs, bs)

        # Every diagonal's hop (the slab kernel reads its row), and the main
        # kernel's statics: its hops, reduced offsets, re-indexed slots and
        # the mask rows it streams.
        self.register_buffer("hops_all", table(self.hops), persistent=False)
        hops_m, offs_m, slots_m, used = self._main_statics()
        self.register_buffer("hops_main", table(hops_m), persistent=False)
        # The merged kernel's launch plans, grouped from the host hops.
        self.main_plans = cbs.MergedPlans(cbs.hop_table_key(hops_m))
        self.main_offsets = tuple(o % self.num_sites for o in offs_m)
        self.main_slots = slots_m
        main_masks = None
        if masks is not None and used:
            main_masks = (masks if used == tuple(range(nmask))
                          else masks[torch.tensor(used, device=masks.device)])
        self.register_buffer("masks_main", main_masks, persistent=False)

    # ------------------------------------------------------------ structure

    @property
    def bs(self) -> int:
        return len(self.hops[0])

    @property
    def ns(self) -> int:
        return self.num_sites

    @property
    def n(self) -> int:
        return self.bs * self.num_sites

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        if self._nnz is not None:
            return self._nnz
        return len(self.offsets) * self.bs * self.bs * self.num_sites

    @property
    def dtype(self) -> torch.dtype:
        return self.hops_all.dtype

    @classmethod
    def from_numpy(cls, masks, hops, offsets, mask_slot, num_sites, slabs=(),
                   nnz: int | None = None, *, dtype: torch.dtype | None = None,
                   device="cuda") -> "ConstBlockDIAOperator":
        """Build from host data, e.g. a reference operator's
        ``(np.asarray(op.masks), op.hops, op.offsets, op.mask_slot,
        op.num_sites, op.slabs, op.nnz)``, so both packages apply the same
        matrix."""
        t = None if masks is None else torch.from_numpy(np.array(masks))
        return cls(t, hops, offsets, mask_slot, num_sites, slabs, nnz,
                   dtype=dtype, device=device)

    def astype_op(self, dtype: torch.dtype) -> "ConstBlockDIAOperator":
        """A new operator in ``dtype`` (a complex dtype names its real
        width). The hop tables are rebuilt from the Python scalars of
        ``hops``, so an f64 copy of an f32 operator applies exactly its matrix
        (the f32-rounded hops), as the reference's ``astype`` does."""
        return ConstBlockDIAOperator(
            self.masks, self.hops, self.offsets, self.mask_slot, self.num_sites,
            self.slabs, self._nnz, dtype=dtype.to_real(), device=self.hops_all.device)

    def _main_statics(self):
        """Main-kernel diagonals: all but the slab-routed ones, with mask
        slots re-indexed against the rows they use (``used``, the original
        slot numbers), so the slab diagonals' masks are not streamed."""
        drop = {e[0] for e in self.slabs}
        keep = [d for d in range(len(self.offsets)) if d not in drop]
        slots = [self.mask_slot[d] for d in keep]
        used = tuple(sorted({sl for sl in slots if sl >= 0}))
        remap = {sl: i for i, sl in enumerate(used)}
        return (
            tuple(self.hops[d] for d in keep),
            tuple(self.offsets[d] for d in keep),
            tuple(remap[sl] if sl >= 0 else -1 for sl in slots),
            used,
        )

    # ----------------------------------------------------------- the codec

    def to_internal(self, Xt: torch.Tensor) -> torch.Tensor:
        """Flat lanes-major (k, bs*ns) [rows a*ns + s] -> merged (bs*k, ns)
        [rows a*k + i], contiguous (the CUDA wrappers take nothing else)."""
        k = Xt.shape[0]
        Xv = Xt.reshape(k, self.bs, self.ns)
        return Xv.transpose(0, 1).reshape(self.bs * k, self.ns).contiguous()

    def from_internal(self, Xm: torch.Tensor) -> torch.Tensor:
        k = Xm.shape[0] // self.bs
        Xv = Xm.reshape(self.bs, k, self.ns)
        return Xv.transpose(0, 1).reshape(k, self.n).contiguous()

    def coeff_expand(self, C: torch.Tensor) -> torch.Tensor:
        """``I_bs ⊗ C``. ``torch.kron`` refuses some transposed views, which
        the solvers pass, hence the contiguous copy."""
        return torch.kron(torch.eye(self.bs, dtype=C.dtype, device=C.device),
                          C.contiguous())

    def gram_contract(self, G: torch.Tensor) -> torch.Tensor:
        """(m, m) -> k x k: the sum of the diagonal spin blocks."""
        k = G.shape[0] // self.bs
        return torch.diagonal(G.reshape(self.bs, k, self.bs, k), dim1=0, dim2=2).sum(-1)

    def norms2_contract(self, v: torch.Tensor) -> torch.Tensor:
        return v.reshape(self.bs, -1).sum(dim=0)

    # ---------------------------------------------------------------- apply

    def _is_internal(self, Xt: torch.Tensor) -> bool:
        return Xt.dim() == 2 and Xt.shape[-1] == self.ns

    def _check_device(self, X: torch.Tensor) -> None:
        if self.hops_all.is_complex() and X.device.type == "cuda":
            raise NotImplementedError(
                "complex ConstBlockDIAOperator hops apply on CPU tensors only; "
                "on the card solve with operators.realify(op)")

    def _apply_m(self, Xm: torch.Tensor, with_gram: bool):
        """Main kernel, then the slab diagonals added in place (each also
        adds its Gram correction). Returns (Ym, Gm or None), Gm (m, m)."""
        self._check_device(Xm)
        Gm = None
        if with_gram:
            Ym, Gm = cbs.const_block_stencil_spmm_m_gram_t(
                self.hops_main, self.main_offsets, self.main_slots,
                self.masks_main, Xm, self.main_plans)
        else:
            Ym = cbs.const_block_stencil_spmm_m_t(
                self.hops_main, self.main_offsets, self.main_slots,
                self.masks_main, Xm, self.main_plans)
        for d, g, nblocks, dst_mul, dst_off, src_shift in self.slabs:
            out = cbs.slab_m_accumulate(self.hops_all[d], g, nblocks, dst_mul,
                                        dst_off, src_shift, Xm, Ym, Gm,
                                        with_gram=with_gram)
            Ym, Gm = out if with_gram else (out, None)
        return Ym, Gm

    def _apply_v(self, Xv: torch.Tensor) -> torch.Tensor:
        """The same on the (k, bs, ns) view: its main kernel, then its slab
        adds in place."""
        self._check_device(Xv)
        Yv = cbs.const_block_stencil_spmm_t(self.hops_main, self.main_offsets,
                                            self.main_slots, self.masks_main, Xv,
                                            self.main_plans)
        for d, g, nblocks, dst_mul, dst_off, src_shift in self.slabs:
            Yv = cbs.slab_block_accumulate(self.hops_all[d], g, nblocks, dst_mul,
                                           dst_off, src_shift, Xv, Yv)
        return Yv

    def _apply(self, Xm: torch.Tensor) -> torch.Tensor:
        """Y = A X on the merged view. One right-hand side (m = bs) goes
        through the (k, bs, ns) view's kernels, which the merged (bs, ns)
        field already is at k = 1, as in the reference (``cbdia.py:179-199``);
        wider blocks through the merged kernels. A bf16 operator and field
        take the reference's route for the dtypes its kernels refuse
        (``_env_ok``; ``_native.f32_gate_refuses``): every diagonal, slab
        ones included, in offset order by the plain roll-and-einsum
        (``_matmat_m_plain``), and no kernel wrapper is called."""
        if _native.f32_gate_refuses(self.hops_all, Xm):
            return self._matmat_m_plain(Xm)
        if Xm.shape[0] == self.bs:
            return self._apply_v(Xm.reshape(1, self.bs, self.ns)).reshape(self.bs, self.ns)
        return self._apply_m(Xm, False)[0]

    def matmat_t(self, Xt: torch.Tensor) -> torch.Tensor:
        """Apply to a lanes-major block: flat (k, n) [spin-major rows], the
        merged internal (m, ns) view, or the (k, bs, ns) view."""
        if Xt.dim() == 3:
            k = Xt.shape[0]
            Xm = Xt.transpose(0, 1).reshape(self.bs * k, self.ns).contiguous()
            Ym = self._apply(Xm)
            return Ym.reshape(self.bs, k, self.ns).transpose(0, 1).contiguous()
        if not self._is_internal(Xt):
            return self.from_internal(self._apply(self.to_internal(Xt)))
        return self._apply(Xt)

    def matmat_gram_t(self, Xt: torch.Tensor):
        """Fused ``(Y = A X, G = X^T Y)`` with G contracted to k x k, on the
        flat or the merged view, through the merged kernels at every k (the
        reference's merged kernel needs 8 | m and has no fused Gram at k = 1;
        the CUDA one takes any m). On a bf16 field G is None, as the
        reference's: the solvers take it from ``gram`` on the stored Y."""
        if not self._is_internal(Xt):
            Ym, G = self.matmat_gram_t(self.to_internal(Xt))
            return self.from_internal(Ym), G
        if _native.f32_gate_refuses(self.hops_all, Xt):
            return self._apply(Xt), None
        Ym, Gm = self._apply_m(Xt, True)
        return Ym, self.gram_contract(Gm)

    def _matmat_m_plain(self, Xm: torch.Tensor) -> torch.Tensor:
        """Every diagonal (slab ones included) by the plain roll-and-einsum,
        as the reference's ``_matmat_m_xla``."""
        return cbs.const_block_stencil_plain(self.hops_all, self.offsets,
                                             self.mask_slot, self.masks, Xm)[0]

    def extra_repr(self) -> str:
        return (f"bs={self.bs}, ns={self.ns}, offsets={self.offsets}, "
                f"slabs={len(self.slabs)}")


# Largest share of the sites a slab-routed diagonal may cover: the default
# of the reference's ``detect_slabs(op, max_frac=0.25)``.
SLAB_MAX_FRAC = 0.25


def detect_slabs(masks, offsets, mask_slot, ns: int) -> tuple:
    """Slab-routable diagonals of an operator's host data, as ``(d, g,
    nblocks, dst_mul, dst_off, src_shift)`` entries for its ``slabs``.

    A diagonal qualifies when its 0/1 mask support is a union of whole
    g-aligned site blocks (g | offset) at a regular stride covering at most
    ``SLAB_MAX_FRAC`` of the sites, e.g. the periodic-wrap diagonals of lattice
    operators."""
    if masks is None:
        return ()
    masks = np.asarray(masks)
    slabs = []
    for d, o in enumerate(offsets):
        ms = mask_slot[d]
        if ms < 0:
            continue
        m = masks[ms]
        if not np.all((m == 0) | (m == 1)):
            continue
        for g in (4096, 2048, 1024, 512, 256):
            if ns % g or o % g:
                continue
            rows = m.reshape(-1, g).sum(axis=1)
            if not np.all((rows == 0) | (rows == g)):
                continue
            blks = np.where(rows == g)[0]
            if len(blks) == 0 or len(blks) * g > SLAB_MAX_FRAC * ns:
                break  # a smaller g cannot reduce the covered fraction
            if len(blks) > 1:
                strides = np.diff(blks)
                if not np.all(strides == strides[0]):
                    continue
                mul = int(strides[0])
            else:
                mul = 1
            slabs.append((d, g, len(blks), mul, int(blks[0]), o // g))
            break
    return tuple(slabs)
