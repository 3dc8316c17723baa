"""Row-partitioned operators over ``torch.distributed``.

Counterpart of ``blockcg_tpu/parallel/dist_ops.py``. The rows (sites) of an
operator are split into D contiguous shards, one per rank of a process
group. A partition plan (``partition_dia``, ``partition_bdia``,
``partition_cbdia``, ``partition_dirac_eo``) is built on the host in numpy,
bitwise the reference's: it holds the global arrays, as the reference's
operator does before ``shard_map`` slices it. ``plan.shard(rank, group,
device)`` takes rank r's slice and returns the rank's operator, an
``nn.Module`` over its local shard (on the card unless ``device`` says
otherwise); ``group`` is the process group of the D ranks (None: D = 1 in
one process, no communication).

Per apply, as in the reference:

  1. post the ring exchange of the field's edge columns (``halo.py``),
  2. run the interior apply: the operator's own kernel on the local shard,
     with every coupling that leaves the shard zeroed out; it does not read
     the halos, so on the card it runs while NCCL moves them,
  3. wait for the halos and add the boundary corrections from them.

Only 2 x (k x bw) halos and the solvers' k x k reductions cross ranks.

Fields: ``DistDIAOperator`` takes flat (k, nl) fields; ``DistBlockDIAOperator``
the (k, bs, ns_l) view; ``DistConstBlockDIAOperator`` the merged (m = bs*k,
ns_l) view, whose crossings (the lattice t-hops) are halo-sourced slab adds
(``slab_m_accumulate_from``, or on one right-hand side
``slab_block_accumulate_from``). ``shard_field`` and ``unshard_field``
convert between global lanes-major (k, n) fields and the rank's local view
(``parallel/api.py`` uses them at its entry points).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from blockcg_tpu_torch.operators.base import MatmatMixin
from blockcg_tpu_torch.operators.bdia import BlockDIAOperator
from blockcg_tpu_torch.operators.cbdia import ConstBlockDIAOperator, detect_slabs
from blockcg_tpu_torch.operators.dia import DIAOperator
from blockcg_tpu_torch.operators.schur import EONormalOperator, SchurEvenOperator
from blockcg_tpu_torch.ops import const_block_stencil as cbs
from blockcg_tpu_torch.parallel.halo import start_ring_halos


def _host(t) -> np.ndarray:
    """A host copy of an operator's buffer (bf16, which numpy lacks, widened
    exactly to f32; the shards take the operator's dtype back)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def _check_group(group, rank: int, D: int) -> None:
    if group is None:
        if D != 1 or rank != 0:
            raise ValueError(f"shard {rank} of {D} needs the process group of the D ranks")
    elif (dist.get_world_size(group), dist.get_rank(group)) != (D, rank):
        raise ValueError(f"shard {rank} of {D} taken on rank {dist.get_rank(group)} of a "
                         f"group of {dist.get_world_size(group)}")


class _Shard(MatmatMixin, nn.Module):
    """The rank's place in the partition: ``rank`` of ``D`` shards of a
    ``group``; ``pad_sites`` inert rows (sites) appended to the last shard."""

    def __init__(self, rank: int, D: int, group, pad_sites: int = 0):
        super().__init__()
        _check_group(group, rank, D)
        self.rank, self.D, self.group, self.pad_sites = rank, D, group, pad_sites

    def _meta(self):
        return self.rank, self.D, self.group


def _local(a: np.ndarray, rank: int, width: int, device, dtype=None) -> torch.Tensor:
    """Rank r's slice of the last axis of a host array, on the device."""
    t = torch.from_numpy(np.ascontiguousarray(a[..., rank * width:(rank + 1) * width]))
    return t.to(device=device, dtype=dtype or t.dtype)


def _pad_validity(vals_by_diag, offsets, n, D, what: str) -> int:
    """Rows to append so D | n, after verifying padding preserves answers.

    Padding appends inert rows at the global end. That is answer-preserving
    iff no real row couples across the global boundary (toroidal wrap): for
    every diagonal, coefficients whose target ``i + o`` falls outside
    ``[0, n)`` must be exactly zero (open/Dirichlet stencils). Operators with
    live wraps (periodic lattices) must use a divisor D; the error lists the
    valid counts."""
    pad = (-n) % D
    if pad == 0:
        return 0
    i = np.arange(n)
    for vals, o in zip(vals_by_diag, offsets):
        wraps = (i + o < 0) | (i + o >= n)
        if np.any(vals[..., wraps] != 0):
            bw = max(abs(oo) for oo in offsets)
            valid = [d for d in range(1, min(D * 4, n) + 1)
                     if n % d == 0 and bw <= n // d]
            raise ValueError(
                f"D={D} does not divide {what}={n} and the operator has live "
                f"periodic wrap couplings (offset {o}), so shard padding "
                f"would change answers. Use a divisor of {n} with shard size "
                f">= bandwidth {bw}; valid D up to {min(D * 4, n)}: {valid}"
            )
    return pad


# ------------------------------------------------------------------ DIA --


class DistDIAOperator(_Shard):
    """The rank's shard of a row-partitioned DIA operator, on flat (k, nl)
    fields. ``interior`` is the local DIAOperator with every cross-shard
    slot zeroed; ``diags_bl`` / ``diags_br`` (ndiag, bw) the coefficients of
    the rows within ``bw`` of the shard's left / right edge."""

    def __init__(self, interior: DIAOperator, diags_bl, diags_br, bw: int, n: int,
                 rank: int, D: int, group, pad_sites: int = 0):
        super().__init__(rank, D, group, pad_sites)
        self.interior = interior
        self.register_buffer("diags_bl", diags_bl)
        self.register_buffer("diags_br", diags_br)
        self.bw, self.n = bw, n

    @property
    def offsets(self):
        return self.interior.offsets

    @property
    def dtype(self):
        return self.interior.dtype

    def astype_op(self, dtype) -> "DistDIAOperator":
        return DistDIAOperator(self.interior.astype_op(dtype), self.diags_bl.to(dtype),
                               self.diags_br.to(dtype), self.bw, self.n, *self._meta(),
                               self.pad_sites)

    def matmat_t(self, Xt: torch.Tensor) -> torch.Tensor:
        bw, nl = self.bw, Xt.shape[1]
        ex = start_ring_halos(Xt, bw, self.group)
        Y = self.interior.matmat_t(Xt)  # does not read the halos
        halo_l, halo_r = ex.wait()
        for d, o in enumerate(self.offsets):  # boundary corrections
            if o < 0:
                Y[:, :-o] += self.diags_bl[d, :-o][None, :] * halo_l[:, bw + o:]
            elif o > 0:
                Y[:, nl - o:] += self.diags_br[d, bw - o:][None, :] * halo_r[:, :o]
        return Y

    def shard_field(self, Bt: torch.Tensor) -> torch.Tensor:
        """Global (k, n) -> the rank's (k, nl), the pad rows zero."""
        nl = (self.n + self.pad_sites) // self.D
        Bt = torch.nn.functional.pad(Bt, (0, self.pad_sites))
        return Bt[:, self.rank * nl:(self.rank + 1) * nl].contiguous()

    def unshard_field(self, parts) -> torch.Tensor:
        return torch.cat(parts, dim=-1)[:, :self.n]


@dataclasses.dataclass
class DIAPartition:
    """Host plan of ``partition_dia``: diags_int (ndiag, D * nl) with the
    cross-shard slots zeroed; diags_bl / diags_br (ndiag, D * bw)."""

    diags_int: np.ndarray
    diags_bl: np.ndarray
    diags_br: np.ndarray
    offsets: tuple
    bw: int
    D: int
    n: int
    pad_sites: int
    dtype: torch.dtype

    def shard(self, rank: int, group=None, device="cuda") -> DistDIAOperator:
        nl = self.diags_int.shape[1] // self.D
        dt = self.dtype
        interior = DIAOperator(_local(self.diags_int, rank, nl, device, dt), self.offsets)
        return DistDIAOperator(interior, _local(self.diags_bl, rank, self.bw, device, dt),
                               _local(self.diags_br, rank, self.bw, device, dt), self.bw,
                               self.n, rank, self.D, group, self.pad_sites)


def partition_dia(op: DIAOperator, D: int) -> DIAPartition:
    """Split each diagonal of ``op`` into an interior part (target row in
    the same shard) and boundary parts (target in a ring neighbour's shard).
    When D does not divide n the last shard gets inert identity rows (open
    stencils only, see ``_pad_validity``). Requires bandwidth <= n / D."""
    diags = _host(op.diags).copy()
    offsets = op.offsets
    ndiag, n = diags.shape
    n0 = n
    pad = _pad_validity([diags[d] for d in range(ndiag)], offsets, n, D, "n")
    if pad:
        diags = np.pad(diags, ((0, 0), (0, pad)))
        if 0 in offsets:
            diags[offsets.index(0), n:] = 1.0  # inert identity rows
        n += pad
    nl = n // D
    bw = max(abs(o) for o in offsets)
    if bw > nl:
        raise ValueError(f"bandwidth {bw} exceeds shard size {nl}")

    j = np.arange(n) % nl  # position within shard
    s = np.arange(n) // nl
    diags_int = diags.copy()
    diags_bl = np.zeros((ndiag, D * bw), dtype=diags.dtype)
    diags_br = np.zeros((ndiag, D * bw), dtype=diags.dtype)
    for d, o in enumerate(offsets):
        crosses = (j + o < 0) | (j + o >= nl)
        diags_int[d, crosses] = 0.0
        if o < 0:
            sel = j + o < 0  # rows [0, -o) of each shard
            diags_bl[d, s[sel] * bw + j[sel]] = diags[d, sel]
        elif o > 0:
            sel = j + o >= nl  # rows [nl-o, nl) of each shard
            diags_br[d, s[sel] * bw + (j[sel] - (nl - bw))] = diags[d, sel]
    return DIAPartition(diags_int, diags_bl, diags_br, tuple(offsets), bw, D, n0, pad,
                        op.dtype)


# ------------------------------------------------------------- BlockDIA --


class DistBlockDIAOperator(_Shard):
    """The rank's shard of a site-partitioned BlockDIA operator, on the
    (k, bs, ns_l) view (or its flat (k, bs * ns_l) form): the local sites of
    every spin plane. ``interior`` is the local BlockDIAOperator with every
    cross-shard slot zeroed (the per-site block kernel); ``blocks_bl`` /
    ``blocks_br`` (noff, bs, bs, bw) the edge sites' blocks. The solvers'
    fields are the view, whose codec is the identity."""

    def __init__(self, interior: BlockDIAOperator, blocks_bl, blocks_br, bw: int, ns: int,
                 rank: int, D: int, group, pad_sites: int = 0):
        super().__init__(rank, D, group, pad_sites)
        self.interior = interior
        self.register_buffer("blocks_bl", blocks_bl)
        self.register_buffer("blocks_br", blocks_br)
        self.bw, self.ns = bw, ns

    @property
    def offsets(self):
        return self.interior.offsets

    @property
    def bs(self) -> int:
        return self.interior.bs

    @property
    def dtype(self):
        return self.interior.dtype

    def astype_op(self, dtype) -> "DistBlockDIAOperator":
        return DistBlockDIAOperator(self.interior.astype_op(dtype), self.blocks_bl.to(dtype),
                                    self.blocks_br.to(dtype), self.bw, self.ns, *self._meta(),
                                    self.pad_sites)

    def matmat_t(self, Xt: torch.Tensor) -> torch.Tensor:
        """Local apply on the (k, bs, ns_l) view, or the flat (k, bs * ns_l)
        form (Y in the input's shape). One einsum per offset adds the edge
        corrections."""
        bs, bw = self.bs, self.bw
        Xv = Xt.reshape(Xt.shape[0], bs, -1)
        ns_l = Xv.shape[2]
        ex = start_ring_halos(Xv, bw, self.group)
        Yv = self.interior.matmat_t(Xv.contiguous())  # does not read the halos
        halo_l, halo_r = ex.wait()
        for d, o in enumerate(self.offsets):
            if o < 0:
                Yv[:, :, :-o] += torch.einsum("abs,kbs->kas", self.blocks_bl[d, :, :, :-o],
                                              halo_l[:, :, bw + o:])
            elif o > 0:
                Yv[:, :, ns_l - o:] += torch.einsum("abs,kbs->kas",
                                                    self.blocks_br[d, :, :, bw - o:],
                                                    halo_r[:, :, :o])
        return Yv.reshape(Xt.shape)

    def shard_field(self, Bt: torch.Tensor) -> torch.Tensor:
        """Global (k, bs * ns) spin-major rows -> the rank's (k, bs, ns_l)."""
        ns_l = (self.ns + self.pad_sites) // self.D
        Bv = torch.nn.functional.pad(Bt.reshape(Bt.shape[0], self.bs, self.ns),
                                     (0, self.pad_sites))
        return Bv[:, :, self.rank * ns_l:(self.rank + 1) * ns_l].contiguous()

    def unshard_field(self, parts) -> torch.Tensor:
        Xv = torch.cat(parts, dim=-1)[:, :, :self.ns]
        return Xv.reshape(Xv.shape[0], -1)


@dataclasses.dataclass
class BlockDIAPartition:
    """Host plan of ``partition_bdia``: blocks_int (noff, bs, bs, D * ns_l)
    with the cross-shard slots zeroed; blocks_bl / blocks_br (noff, bs, bs,
    D * bw)."""

    blocks_int: np.ndarray
    blocks_bl: np.ndarray
    blocks_br: np.ndarray
    offsets: tuple
    bw: int
    D: int
    ns: int
    pad_sites: int
    dtype: torch.dtype

    def shard(self, rank: int, group=None, device="cuda") -> DistBlockDIAOperator:
        ns_l = self.blocks_int.shape[3] // self.D
        dt = self.dtype
        interior = BlockDIAOperator(_local(self.blocks_int, rank, ns_l, device, dt),
                                    self.offsets)
        return DistBlockDIAOperator(interior, _local(self.blocks_bl, rank, self.bw, device, dt),
                                    _local(self.blocks_br, rank, self.bw, device, dt), self.bw,
                                    self.ns, rank, self.D, group, self.pad_sites)


def partition_bdia(op: BlockDIAOperator, D: int) -> BlockDIAPartition:
    """Site-partition a BlockDIAOperator (every shard keeps all bs spin
    planes of its sites). Non-dividing D pads inert identity sites (open
    boundaries only)."""
    blocks = _host(op.blocks).copy()
    offsets = op.offsets
    noff, bs, _, ns = blocks.shape
    ns0 = ns
    pad = _pad_validity([blocks[d] for d in range(noff)], offsets, ns, D, "ns")
    if pad:
        blocks = np.pad(blocks, ((0, 0), (0, 0), (0, 0), (0, pad)))
        if 0 in offsets:  # inert identity blocks on the padded sites
            blocks[offsets.index(0), :, :, ns:] = np.eye(bs, dtype=blocks.dtype)[:, :, None]
        ns += pad
    ns_l = ns // D
    bw = max(abs(o) for o in offsets)
    if bw > ns_l:
        raise ValueError(f"site bandwidth {bw} exceeds shard size {ns_l}")

    j = np.arange(ns) % ns_l
    s = np.arange(ns) // ns_l
    blocks_int = blocks.copy()
    blocks_bl = np.zeros((noff, bs, bs, D * bw), dtype=blocks.dtype)
    blocks_br = np.zeros((noff, bs, bs, D * bw), dtype=blocks.dtype)
    for d, o in enumerate(offsets):
        crosses = (j + o < 0) | (j + o >= ns_l)
        blocks_int[d][:, :, crosses] = 0.0
        if o < 0:
            sel = j + o < 0
            blocks_bl[d][:, :, s[sel] * bw + j[sel]] = blocks[d][:, :, sel]
        elif o > 0:
            sel = j + o >= ns_l
            blocks_br[d][:, :, s[sel] * bw + (j[sel] - (ns_l - bw))] = blocks[d][:, :, sel]
    return BlockDIAPartition(blocks_int, blocks_bl, blocks_br, tuple(offsets), bw, D, ns0,
                             pad, op.dtype)


# -------------------------------------------------------- const-hop DIA --


class DistConstBlockDIAOperator(_Shard):
    """The rank's shard of a site-partitioned constant-hop operator (the
    distributed config-4 path), on merged (m = bs * k, ns_l) fields. ``local``
    is a ConstBlockDIAOperator over the shard: its masks have the
    cross-shard slots zeroed and its slab routing is re-detected on the
    shard. Each crossing ``(d, o, g, nblocks)`` (a diagonal whose couplings
    leave the shard: the lattice t-hops) adds its edge slab from the halo,
    scaled by the edge link values ``cross_vals[i]`` (1, |o|) of gauged
    operators (None for unit couplings)."""

    def __init__(self, local: ConstBlockDIAOperator, cross_vals, crossings, bw: int, g: int,
                 rank: int, D: int, group):
        super().__init__(rank, D, group)
        self.local = local
        self.crossings = tuple(crossings)
        self.bw, self.g = bw, g
        self._vals = []
        for i, v in enumerate(cross_vals):
            self.register_buffer(f"cross_val{i}", v)
            self._vals.append(f"cross_val{i}")

    @property
    def cross_vals(self) -> tuple:
        return tuple(getattr(self, name) for name in self._vals)

    @property
    def bs(self) -> int:
        return self.local.bs

    @property
    def ns(self) -> int:
        return self.local.ns * self.D

    @property
    def dtype(self):
        return self.local.dtype

    def astype_op(self, dtype) -> "DistConstBlockDIAOperator":
        vals = [None if v is None else v.to(dtype.to_real()) for v in self.cross_vals]
        return DistConstBlockDIAOperator(self.local.astype_op(dtype), vals, self.crossings,
                                         self.bw, self.g, *self._meta())

    def coeff_expand(self, C):
        return self.local.coeff_expand(C)

    def gram_contract(self, G):
        return self.local.gram_contract(G)

    def norms2_contract(self, v):
        return self.local.norms2_contract(v)

    def _crossing_map(self, o, ns_l, halo_l, halo_r):
        """(dst0, src0, source halo) of a crossing diagonal: o > 0 fills the
        last o sites from the right neighbour's first o; o < 0 the first
        -o sites from the left neighbour's last -o (the halo holds bw)."""
        if o > 0:
            return ns_l - o, 0, halo_r
        return 0, self.bw + o, halo_l

    def matmat_t(self, Xm: torch.Tensor) -> torch.Tensor:
        """Xm: the merged (m, ns_l) local field. On one right-hand side
        (m = bs, where the local operator runs the (k, bs, ns) view's
        kernels) the unit-valued crossings take the view's halo slab add;
        gauged ones, and wider fields, the merged one."""
        bs, ns_l = self.bs, Xm.shape[1]
        ex = start_ring_halos(Xm, self.bw, self.group)
        Ym = self.local.matmat_t(Xm)  # does not read the halos
        halo_l, halo_r = ex.wait()
        for (d, o, g, nblocks), vals in zip(self.crossings, self.cross_vals):
            hop = self.local.hops_all[d]
            dst0, src0, src = self._crossing_map(o, ns_l, halo_l, halo_r)
            if Xm.shape[0] == bs and vals is None:
                cbs.slab_block_accumulate_from(hop, g, nblocks, dst0 // g, src0 // g,
                                               src.view(1, bs, -1), Ym.view(1, bs, ns_l))
            else:
                cbs.slab_m_accumulate_from(hop, g, nblocks, dst0 // g, src0 // g, src, Ym,
                                           vals=vals)
        return Ym

    def matmat_gram_t(self, Xm: torch.Tensor):
        """Fused (Y = A X, G = X^T Y local part, k x k): the local operator's
        Gram plus each halo slab's Gram of its own increment. The solvers sum
        G over the ranks (``f_matmat_gram``)."""
        ns_l = Xm.shape[1]
        ex = start_ring_halos(Xm, self.bw, self.group)
        Ym, Gk = self.local.matmat_gram_t(Xm)
        halo_l, halo_r = ex.wait()
        for (d, o, g, nblocks), vals in zip(self.crossings, self.cross_vals):
            dst0, src0, src = self._crossing_map(o, ns_l, halo_l, halo_r)
            Ym, Gm = cbs.slab_m_accumulate_from(self.local.hops_all[d], g, nblocks, dst0 // g,
                                                src0 // g, src, Ym, Xm, vals, with_gram=True)
            Gk = Gk + self.local.gram_contract(Gm)
        return Ym, Gk

    def shard_field(self, Bt: torch.Tensor) -> torch.Tensor:
        """Global (k, bs * ns) spin-major rows -> the rank's merged
        (bs * k, ns_l)."""
        k, ns_l = Bt.shape[0], self.local.ns
        Bm = Bt.reshape(k, self.bs, self.ns).transpose(0, 1).reshape(self.bs * k, self.ns)
        return Bm[:, self.rank * ns_l:(self.rank + 1) * ns_l].contiguous()

    def unshard_field(self, parts) -> torch.Tensor:
        Xm = torch.cat(parts, dim=-1)
        k = Xm.shape[0] // self.bs
        return Xm.reshape(self.bs, k, self.ns).transpose(0, 1).reshape(k, -1)


@dataclasses.dataclass
class ConstBlockDIAPartition:
    """Host plan of ``partition_cbdia``: the local operator's global masks
    (nmask, D * ns_l), mask slots and slab routing; the crossings ``(d, o,
    g, nblocks)`` and their edge values (1, D * |o|) or None."""

    masks: np.ndarray | None
    hops: tuple
    offsets: tuple
    mask_slot: tuple
    slabs: tuple
    crossings: tuple
    cross_vals: tuple
    bw: int
    g: int
    D: int
    ns_l: int
    dtype: torch.dtype

    def shard(self, rank: int, group=None, device="cuda") -> DistConstBlockDIAOperator:
        ns_l = self.ns_l
        masks = None if self.masks is None else _local(self.masks, rank, ns_l, device)
        local = ConstBlockDIAOperator(masks, self.hops, self.offsets, self.mask_slot, ns_l,
                                      self.slabs, dtype=self.dtype, device=device)
        vals = [None if v is None else _local(v, rank, abs(o), device, self.dtype)
                for v, (_, o, _, _) in zip(self.cross_vals, self.crossings)]
        return DistConstBlockDIAOperator(local, vals, self.crossings, self.bw, self.g, rank,
                                         self.D, group)


def partition_cbdia(op: ConstBlockDIAOperator, D: int) -> ConstBlockDIAPartition:
    """Partition a ConstBlockDIAOperator over D site-contiguous shards.

    Requirements: D | ns and every crossing diagonal slab-alignable (g |
    offset, |offset| <= ns / D: the lattice t-hops). Crossing diagonals may
    be value-masked (gauged operators): the edge values ride along as
    per-crossing coefficients of the halo slab add. The slab width g is the
    largest power of two from 256 to 4096 dividing the offset and the shard,
    the smallest over the crossings."""
    ns = op.num_sites
    if ns % D:
        # Periodic lattice wraps are live couplings: shard padding would
        # change answers, so const-hop partitioning needs a divisor.
        bw_all = max(abs(o) for o in op.offsets)
        valid = [d for d in range(1, min(4 * D, ns) + 1) if ns % d == 0 and bw_all <= ns // d]
        raise ValueError(
            f"ns={ns} not divisible by D={D}; const-hop (periodic-lattice) "
            f"operators cannot be shard-padded. Valid D up to "
            f"{min(4 * D, ns)}: {valid} (need shard size >= max offset "
            f"{bw_all}); or use partition_bdia on an open-boundary operator."
        )
    ns_l = ns // D
    masks_np = None if op.masks is None else _host(op.masks)
    j = np.arange(ns) % ns_l

    new_masks: list[np.ndarray] = []
    new_slot: list[int] = []
    crossings = []
    cross_vals: list = []
    dtype = np.float32 if masks_np is None else masks_np.dtype
    for d, o in enumerate(op.offsets):
        ms = op.mask_slot[d]
        crosses = (j + o < 0) | (j + o >= ns_l)
        base = np.ones(ns, dtype=dtype) if ms < 0 else masks_np[ms]
        # Effective crossing: rows whose (masked) coupling leaves the shard.
        eff = crosses & (base != 0)
        if not eff.any():
            if ms < 0 and not crosses.any():
                new_slot.append(-1)
            else:
                new_slot.append(len(new_masks))
                new_masks.append(np.where(crosses, 0.0, base).astype(dtype))
            continue
        # Crossing diagonal: the local part masked off at the boundary, and a
        # halo-sourced correction over the edge slab, with the value masks
        # (gauged links) as its edge coefficients.
        new_slot.append(len(new_masks))
        new_masks.append(np.where(crosses, 0.0, base).astype(dtype))
        edge = (j >= ns_l - o) if o > 0 else (j < -o)
        gg = 256
        while gg * 2 <= 4096 and o % (gg * 2) == 0 and ns_l % (gg * 2) == 0:
            gg *= 2
        if o % gg or ns_l % gg or abs(o) > ns_l:
            raise ValueError(f"offset {o}: not slab-alignable (g={gg}); use partition_bdia")
        if np.all(base[edge] == 1.0):
            vals = None
        else:
            eb = base.reshape(D, ns_l)
            ev = eb[:, ns_l - o:] if o > 0 else eb[:, :-o]
            vals = ev.reshape(1, D * abs(o)).astype(dtype)
        crossings.append((d, o, gg, abs(o) // gg))
        cross_vals.append(vals)

    if not crossings:
        raise ValueError("no crossing diagonals; use the operator directly")
    g_all = min(c[2] for c in crossings)
    crossings = tuple((d, o, g_all, abs(o) // g_all) for (d, o, _, _) in crossings)
    bw = max(abs(c[1]) for c in crossings)

    # Slab routing re-detected on shard 0's masks and applied as the same
    # block indices on every shard: valid only when every shard has the same
    # mask pattern (lattices whose shard length is a multiple of the mask
    # period). Otherwise no slabs: the masks stream through the main kernel.
    slabs = ()
    shard_periodic = all(
        np.array_equal(m.reshape(D, ns_l), np.broadcast_to(m.reshape(D, ns_l)[0], (D, ns_l)))
        for m in new_masks)
    if shard_periodic and new_masks:
        slabs = detect_slabs(np.stack([m[:ns_l] for m in new_masks]), op.offsets,
                             tuple(new_slot), ns_l)
    return ConstBlockDIAPartition(
        masks=np.stack(new_masks) if new_masks else None, hops=op.hops,
        offsets=op.offsets, mask_slot=tuple(new_slot), slabs=slabs, crossings=crossings,
        cross_vals=tuple(cross_vals), bw=bw, g=g_all, D=D, ns_l=ns_l,
        dtype=op.hops_all.dtype.to_real())


def to_dist_order(X: np.ndarray, bs: int, D: int) -> np.ndarray:
    """Reorder an (n, k) block from global spin-major rows (a*ns + s) to the
    distributed ordering (shard-major, spin, site-within-shard)."""
    n = X.shape[0]
    ns_l = n // bs // D
    return np.transpose(X.reshape(bs, D, ns_l, -1), (1, 0, 2, 3)).reshape(n, -1)


def from_dist_order(X: np.ndarray, bs: int, D: int) -> np.ndarray:
    n = X.shape[0]
    ns_l = n // bs // D
    return np.transpose(X.reshape(D, bs, ns_l, -1), (1, 0, 2, 3)).reshape(n, -1)


# ----------------------------------------------------- even-odd Schur --


class _DistPair:
    """Field conversion and the rank's place, from ``hop_oe`` (both parity
    hops are DistConstBlockDIAOperators of one partition)."""

    @property
    def rank(self):
        return self.hop_oe.rank

    @property
    def D(self):
        return self.hop_oe.D

    def shard_field(self, Bt):
        return self.hop_oe.shard_field(Bt)

    def unshard_field(self, parts):
        return self.hop_oe.unshard_field(parts)


class DistSchurEvenOperator(_DistPair, SchurEvenOperator):
    """The rank's shard of the even-odd Schur operator S_e = c I - H_eo H_oe
    / c on merged half fields: the apply and codec of
    ``operators.schur.SchurEvenOperator`` over distributed parity hops, each
    doing its own halo exchange (two rounds per Schur apply)."""

    def astype_op(self, dtype) -> "DistSchurEvenOperator":
        return DistSchurEvenOperator(self.hop_eo.astype_op(dtype),
                                     self.hop_oe.astype_op(dtype), self.c)


class DistEONormalOperator(_DistPair, EONormalOperator):
    """The rank's shard of ``mu I - H_eo H_oe`` (the multi-shift even-odd
    base operator) over distributed parity hops."""

    def astype_op(self, dtype) -> "DistEONormalOperator":
        return DistEONormalOperator(self.hop_eo.astype_op(dtype),
                                    self.hop_oe.astype_op(dtype), self.mu)


@dataclasses.dataclass
class DiracEOPartition:
    """Host plan of ``partition_dirac_eo``: both parity hops' plans and c."""

    hop_eo: ConstBlockDIAPartition
    hop_oe: ConstBlockDIAPartition
    c: float

    def shard(self, rank: int, group=None, device="cuda") -> DistSchurEvenOperator:
        return DistSchurEvenOperator(self.hop_eo.shard(rank, group, device),
                                     self.hop_oe.shard(rank, group, device), self.c)


def partition_dirac_eo(eo, D: int) -> DiracEOPartition:
    """Partition an EOContext's Schur system over D site-contiguous shards
    of the half lattice (both parity hops through ``partition_cbdia``;
    gauged value-masked crossings supported). ``problems.dirac_eo.
    solve_dirac_eo_dist`` solves with it; the split, right-hand side and odd
    reconstruction stay on each rank's whole field, as in the reference."""
    return DiracEOPartition(partition_cbdia(eo.hop_eo, D), partition_cbdia(eo.hop_oe, D), eo.c)
