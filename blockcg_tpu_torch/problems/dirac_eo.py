"""Even-odd (red-black) Schur reduction of the lattice Dirac-like operator.

Counterpart of ``blockcg_tpu/problems/dirac_eo.py``. The nearest-neighbour
operator A = c I - H couples only opposite parities. This module builds the
half-lattice parity hops H_eo and H_oe, as ConstBlockDIAOperators (the
structure, offsets and masks per distinct half-index offset, derived from the
coordinate maps, so the const-hop kernels and the slab routing apply) or, for
matrix-valued links, BlockDIAOperators, and wires them into
``operators.schur.SchurEvenOperator``:

    S_e x_e = b_e + H_eo b_o / c,   S_e = c I - H_eo H_oe / c   (half size)
    x_o     = (b_o + H_oe x_e) / c

Half-index convention: a site s = (t, z, y, x) of parity p has half-index
h = s // 2 within its parity class; the half lattice is an (L, L, L, L/2)
grid. Only x-hops depend on the row's x-parity, and the derivation computes
every neighbour's half-index numerically and groups equal offsets into
masked diagonals.

The numpy construction is carried over as it is, so hops, masks, offsets,
slabs, blocks and the matrix-link hops' folded wrap fields (the reference's
opt-in ``BLOCKCG_FOLD``) come out bitwise the reference's. Left out: the
reference's single-jit pipeline, a dispatch optimisation of the same chain, which runs here as the
plain eager chain. ``solve_dirac_eo_dist`` runs the Schur solve row-partitioned
over a process group (``parallel/``).
Splitting and assembling run on the device as a masked select on a
(bs, ns/2, 2, k) view (no gather), and complex U(1) right-hand sides are
converted to the realified system by torch ops on the device, where the
reference goes through host numpy. Every builder puts its operators on the
card unless ``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from blockcg_tpu_torch.operators.base import assert_wrap_zero
from blockcg_tpu_torch.operators.bdia import BlockDIAOperator
from blockcg_tpu_torch.operators.cbdia import ConstBlockDIAOperator, detect_slabs
from blockcg_tpu_torch.operators.realify import k1k2_blocks, real_mask_dtype
from blockcg_tpu_torch.operators.schur import EONormalOperator, SchurEvenOperator
from blockcg_tpu_torch.problems.dirac import (
    BS,
    _NDIM,
    _folded_fields,
    _np_dtype,
    hopping_matrices,
)

__all__ = ["dirac_eo", "dirac_gauged_eo", "dirac_gauged_matrix_eo",
           "eo_split", "eo_assemble", "solve_dirac_eo", "solve_dirac_eo_dist",
           "solve_dirac_eo_shifted", "EOContext"]


def _half_coords(L: int, parity: int):
    """Coordinates of the parity-class sites, indexed by half-index h."""
    ns2 = L**_NDIM // 2
    h = np.arange(ns2)
    l3h, l2h, lh = L**3 // 2, L**2 // 2, L // 2
    t = h // l3h
    z = (h // l2h) % L
    y = (h // lh) % L
    xh = h % lh
    q = (t + z + y + parity) % 2  # x-parity of the site
    x = 2 * xh + q
    return t, z, y, x


def _half_index(L: int, t, z, y, x):
    """Half-index of full-coordinate sites (whatever their parity)."""
    s = ((t * L + z) * L + y) * L + x
    return s // 2


def _real_torch(np_dtype) -> torch.dtype:
    return torch.float32 if np_dtype in (np.float32, np.complex64) else torch.float64


def _parity_hop(L: int, H: np.ndarray, target_parity: int, bc: str,
                np_dtype, links: np.ndarray | None = None,
                device="cuda") -> ConstBlockDIAOperator:
    """Half-lattice hop: Y[target-parity rows] = sum_mu (phi_mu H_mu X[.+mu]
    + phi'_mu H_mu^H X[.-mu]) over the opposite-parity half field.

    With ``links`` (per-axis per-full-site scalar links), the masks carry
    link values times the boundary gate; complex (U(1)) links give the
    realified form, two real value-masked diagonals per hop on doubled spin
    blocks (``phi B = phi_r K1(B) + phi_i K2(B)``). Without links the masks
    are 0/1 gates."""
    ns2 = L**_NDIM // 2
    t, z, y, x = _half_coords(L, target_parity)
    coords = [t, z, y, x]
    s_full = ((t * L + z) * L + y) * L + x  # full site index per row h

    # (offset, block_key) -> accumulated value mask, block, gated?
    diag_vals: dict = {}
    diag_blocks: dict = {}
    diag_gated: dict = {}

    def add(block: np.ndarray, hprime: np.ndarray, valid: np.ndarray,
            vals: np.ndarray | None):
        off_vec = (hprime - np.arange(ns2)) % ns2
        for off in np.unique(off_vec[valid]):
            mask = valid & (off_vec == off)
            soff = int(((off + ns2 // 2) % ns2) - ns2 // 2)  # near-zero rep
            key = (soff, block.tobytes())
            v = np.zeros(ns2)
            v[mask] = 1.0 if vals is None else vals[mask]
            if key in diag_vals:
                diag_vals[key] = diag_vals[key] + v
                diag_gated[key] |= not mask.all()
            else:
                diag_vals[key] = v
                diag_blocks[key] = block
                diag_gated[key] = not mask.all()

    cplx_links = links is not None and np.iscomplexobj(links)
    rdt_blocks = real_mask_dtype(np_dtype) if cplx_links else None

    for ax in range(_NDIM):
        for sgn, block in ((+1, H[ax]), (-1, H[ax].conj().T)):
            nc = [c.copy() for c in coords]
            nc[ax] = coords[ax] + sgn
            wrap = (nc[ax] < 0) | (nc[ax] >= L)
            nc[ax] = nc[ax] % L
            hprime = _half_index(L, *nc)
            valid = np.ones(ns2, bool) if bc == "periodic" else ~wrap
            if links is None:
                vals = None
            elif sgn > 0:
                vals = links[ax][s_full]  # link anchored at the row's site
            else:
                # The -mu link is anchored at the neighbour site s - mu.
                nfull = ((nc[0] * L + nc[1]) * L + nc[2]) * L + nc[3]
                vals = np.conj(links[ax][nfull]) if cplx_links else links[ax][nfull]
            if cplx_links:
                K1, K2 = k1k2_blocks(block, rdt_blocks)
                add(np.ascontiguousarray(K1), hprime, valid, vals.real)
                add(np.ascontiguousarray(K2), hprime, valid, vals.imag)
            else:
                add(np.ascontiguousarray(block.astype(np_dtype)), hprime, valid, vals)

    cplx = np.issubdtype(np_dtype, np.complexfloating)
    mask_dtype = np_dtype if not cplx else real_mask_dtype(np_dtype)
    scal = float if cplx_links else (complex if cplx else float)
    gauged = links is not None

    offsets, hops, mask_slot, masks = [], [], [], []
    for key in sorted(diag_vals, key=lambda kv: kv[0]):
        soff, _ = key
        offsets.append(soff)
        hops.append(tuple(tuple(scal(v) for v in row) for row in diag_blocks[key]))
        if not gauged and not diag_gated[key]:
            mask_slot.append(-1)
        else:
            mask_slot.append(len(masks))
            masks.append(diag_vals[key].astype(mask_dtype))

    nnz = 0
    for d in range(len(offsets)):
        nz = int(np.count_nonzero(np.asarray(hops[d])))
        rows = ns2 if mask_slot[d] < 0 else int(np.count_nonzero(masks[mask_slot[d]]))
        nnz += nz * rows
    masks_np = np.stack(masks) if masks else None
    slabs = detect_slabs(masks_np, offsets, mask_slot, ns2)
    return ConstBlockDIAOperator.from_numpy(
        masks_np, tuple(hops), tuple(offsets), tuple(mask_slot), ns2, slabs=slabs,
        nnz=nnz, dtype=_real_torch(mask_dtype), device=device)


def _parity_hop_matrix(L: int, H: np.ndarray, U: np.ndarray, target_parity: int,
                       bc: str, np_dtype, device="cuda") -> BlockDIAOperator:
    """Half-lattice hop with per-site matrix links, a BlockDIAOperator: the
    +mu block at row site s is U_mu(s) H_mu and the -mu block its Hermitian
    partner anchored at the neighbour, (U_mu(s-mu) H_mu)^H, as in
    ``problems.dirac_gauged_matrix`` up to the global sign."""
    ns2 = L**_NDIM // 2
    t, z, y, x = _half_coords(L, target_parity)
    coords = [t, z, y, x]
    s_full = ((t * L + z) * L + y) * L + x

    diag: dict = {}  # soff -> (BS, BS, ns2) accumulated per-site blocks
    for ax in range(_NDIM):
        for sgn in (+1, -1):
            nc = [c.copy() for c in coords]
            nc[ax] = coords[ax] + sgn
            wrap = (nc[ax] < 0) | (nc[ax] >= L)
            nc[ax] = nc[ax] % L
            hprime = _half_index(L, *nc)
            valid = np.ones(ns2, bool) if bc == "periodic" else ~wrap
            if sgn > 0:
                blk = np.einsum("sij,jk->sik", U[ax][s_full], H[ax])
            else:
                nfull = ((nc[0] * L + nc[1]) * L + nc[2]) * L + nc[3]
                blk = np.conj(np.einsum("sij,jk->sik", U[ax][nfull], H[ax])).transpose(0, 2, 1)
            off_vec = (hprime - np.arange(ns2)) % ns2
            for off in np.unique(off_vec[valid]):
                mask = valid & (off_vec == off)
                soff = int(((off + ns2 // 2) % ns2) - ns2 // 2)
                acc = diag.setdefault(soff, np.zeros((BS, BS, ns2), np_dtype))
                acc[:, :, mask] += blk[mask].transpose(1, 2, 0)

    offsets = sorted(diag)
    blocks = np.stack([diag[o] for o in offsets])
    if bc == "open":
        assert_wrap_zero(blocks, offsets, ns2,
                         what=f"parity hop (L={L}, to={target_parity}, open)")
    # Half-index wraps fold as the full lattice's do (the z and y half
    # strides pair with their (L - 1) multiples; x hops are parity-split and
    # stay plain); _folded_fields checks the structure.
    folded = _folded_fields(blocks, list(offsets), L) if bc == "periodic" else {}
    return BlockDIAOperator.from_numpy(blocks, tuple(offsets), wrap_zero=(bc == "open"),
                                       nnz=int(np.count_nonzero(blocks)), device=device,
                                       **folded)


@dataclasses.dataclass
class EOContext:
    """The Schur operator, its two parity hops and the site maps that split
    and assemble full fields. ``q0`` (on the hops' device) is the x-parity of
    the even site of each site pair {2h, 2h + 1}.

    ``cdtype`` is set for U(1)-gauged complex systems: the context then works
    on the realified system (spin blocks doubled, fields stacked as re/im
    spin planes), and the solves convert complex right-hand sides at the
    boundary."""

    schur: SchurEvenOperator
    hop_eo: object
    hop_oe: object
    c: float
    even_sites: np.ndarray  # (ns/2,) full-lattice site index per half-index
    odd_sites: np.ndarray
    ns: int
    bs: int
    cdtype: torch.dtype | None = None
    q0: torch.Tensor | None = None

    def __post_init__(self):
        if self.q0 is None:
            device = next(iter(self.hop_oe.buffers())).device
            self.q0 = torch.as_tensor(self.even_sites % 2 == 1, device=device)

    @property
    def n(self) -> int:
        return self.bs * self.ns

    def complex_to_real(self, B: torch.Tensor) -> torch.Tensor:
        """Complex (cbs*ns, k) -> realified (2*cbs*ns, k): re spins first."""
        cbs = self.bs // 2
        Bv = B.reshape(cbs, self.ns, -1)
        return torch.cat([Bv.real, Bv.imag], dim=0).reshape(self.n, -1)

    def real_to_complex(self, X: torch.Tensor) -> torch.Tensor:
        cbs = self.bs // 2
        Xv = X.reshape(self.bs, self.ns, -1)
        return torch.complex(Xv[:cbs], Xv[cbs:]).reshape(cbs * self.ns, -1).to(self.cdtype)


def _check_lattice(L: int, bc: str) -> None:
    if bc not in ("periodic", "open"):
        raise ValueError(f"bc must be 'periodic' or 'open', got {bc!r}")
    if L % 2:
        raise ValueError("even-odd reduction needs even L")
    if L < 4:
        # At L = 2 the +mu and -mu neighbours coincide; the diagonal grouping
        # would merge the two (equal) hop contributions instead of summing.
        raise ValueError("even-odd reduction needs L >= 4")


def _context(L: int, hop_eo, hop_oe, c: float, bs: int, cdtype=None) -> EOContext:
    te, ze, ye, xe = _half_coords(L, 0)
    to, zo, yo, xo = _half_coords(L, 1)
    return EOContext(
        schur=SchurEvenOperator(hop_eo, hop_oe, c), hop_eo=hop_eo, hop_oe=hop_oe, c=c,
        even_sites=((te * L + ze) * L + ye) * L + xe,
        odd_sites=((to * L + zo) * L + yo) * L + xo,
        ns=L**_NDIM, bs=bs, cdtype=cdtype)


def dirac_eo(L: int, m: float = 0.5, bc: str = "periodic",
             dtype: torch.dtype = torch.float32, seed: int = 7,
             device="cuda") -> EOContext:
    """Even-odd Schur form of the ``dirac_cbdia``/``dirac_bdia`` matrix. A
    complex dtype gives complex-hop containers, which apply on CPU tensors
    only (their card route would be a realified solve, not built here)."""
    _check_lattice(L, bc)
    np_dtype = _np_dtype(dtype, "dirac_eo")
    cplx = np.issubdtype(np_dtype, np.complexfloating)
    H = hopping_matrices(seed, hermitian=cplx).astype(np_dtype)
    c = float(m * m + 2.0 * _NDIM)
    # A couples row s to column s + mu with -H_mu: the hops carry +H_mu.
    hop_eo = _parity_hop(L, H, 0, bc, np_dtype, device=device)
    hop_oe = _parity_hop(L, H, 1, bc, np_dtype, device=device)
    return _context(L, hop_eo, hop_oe, c, BS)


def dirac_gauged_eo(L: int, m: float = 0.5, bc: str = "periodic",
                    dtype: torch.dtype = torch.float32, seed: int = 7,
                    gauge_seed: int = 11, device="cuda") -> EOContext:
    """Even-odd Schur form of the gauged operator ``dirac_gauged``: the
    parity hops carry the link values in their masks and run the const-hop
    kernels. Real dtypes carry Z2 links; complex dtypes U(1) phases in the
    realified K1/K2 form, and the context then works on the realified
    system (``cdtype`` set, spin blocks doubled)."""
    _check_lattice(L, bc)
    np_dtype = _np_dtype(dtype, "dirac_gauged_eo")
    cplx = np.issubdtype(np_dtype, np.complexfloating)
    H = hopping_matrices(seed, hermitian=cplx).astype(np_dtype)
    grng = np.random.default_rng(gauge_seed)
    ns = L**_NDIM
    if cplx:
        links = np.exp(2j * np.pi * grng.random((_NDIM, ns))).astype(np_dtype)
    else:
        links = grng.choice([-1.0, 1.0], size=(_NDIM, ns)).astype(np_dtype)
    c = float(m * m + 2.0 * _NDIM)
    hop_eo = _parity_hop(L, H, 0, bc, np_dtype, links=links, device=device)
    hop_oe = _parity_hop(L, H, 1, bc, np_dtype, links=links, device=device)
    return _context(L, hop_eo, hop_oe, c, 2 * BS if cplx else BS,
                    cdtype=dtype if cplx else None)


def dirac_gauged_matrix_eo(L: int, m: float = 0.5, bc: str = "periodic",
                           dtype: torch.dtype = torch.float32, seed: int = 7,
                           gauge_seed: int = 11, device="cuda") -> EOContext:
    """Even-odd Schur form of the matrix-link operator
    ``dirac_gauged_matrix(L, m, bc, dtype, seed, gauge_seed)`` (the same link
    field): the parity hops are BlockDIAOperators on the half lattice and run
    the per-site block-stencil kernel. Real dtypes carry orthogonal links,
    complex dtypes unitary ones (complex-block containers, CPU only)."""
    _check_lattice(L, bc)
    np_dtype = _np_dtype(dtype, "dirac_gauged_matrix_eo")
    cplx = np.issubdtype(np_dtype, np.complexfloating)
    H = hopping_matrices(seed, hermitian=cplx).astype(np_dtype)
    ns = L**_NDIM
    grng = np.random.default_rng(gauge_seed)
    g = grng.standard_normal((_NDIM, ns, BS, BS))
    if cplx:
        g = g + 1j * grng.standard_normal((_NDIM, ns, BS, BS))
    U, _ = np.linalg.qr(g)
    U = U.astype(np_dtype)
    c = float(m * m + 2.0 * _NDIM)
    hop_eo = _parity_hop_matrix(L, H, U, 0, bc, np_dtype, device=device)
    hop_oe = _parity_hop_matrix(L, H, U, 1, bc, np_dtype, device=device)
    return _context(L, hop_eo, hop_oe, c, BS)


def _site_rows(sites: np.ndarray, ns: int, bs: int) -> np.ndarray:
    """Spin-major full rows (a*ns + s) for the given sites, all spins."""
    return (np.arange(bs)[:, None] * ns + sites[None, :]).reshape(-1)


def _split_pairs(Bv: torch.Tensor, q: torch.Tensor):
    """(bs, ns2, 2, k) site pairs -> (even, odd) (bs, ns2, k) by a masked
    select: site 2h + q0(h) is the even one."""
    b0, b1 = Bv[..., 0, :], Bv[..., 1, :]
    qe = q[None, :, None]
    return torch.where(qe, b1, b0), torch.where(qe, b0, b1)


def _interleave_pairs(Ev: torch.Tensor, Ov: torch.Tensor, q: torch.Tensor):
    """Inverse of _split_pairs: (bs, ns2, k) halves -> (bs, ns2, 2, k)."""
    qe = q[None, :, None]
    return torch.stack([torch.where(qe, Ov, Ev), torch.where(qe, Ev, Ov)], dim=2)


def eo_split(eo: EOContext, B: torch.Tensor):
    """Full (n, k) field -> (even, odd) half fields, spin-major rows."""
    ns2, k = eo.ns // 2, B.shape[1]
    Be, Bo = _split_pairs(B.reshape(eo.bs, ns2, 2, k), eo.q0.to(B.device))
    return Be.reshape(eo.bs * ns2, k), Bo.reshape(eo.bs * ns2, k)


def eo_assemble(eo: EOContext, Xe: torch.Tensor, Xo: torch.Tensor) -> torch.Tensor:
    """(even, odd) half fields -> full (n, k) field."""
    ns2, k = eo.ns // 2, Xe.shape[1]
    out = _interleave_pairs(Xe.reshape(eo.bs, ns2, k), Xo.reshape(eo.bs, ns2, k),
                            eo.q0.to(Xe.device))
    return out.reshape(eo.n, k)


def _hop(op, F: torch.Tensor) -> torch.Tensor:
    """A parity hop applied to an (n/2, k) half field."""
    return op.matmat_t(F.T.contiguous()).T


def solve_dirac_eo(eo: EOContext, B: torch.Tensor, solver=None, *, tol: float = 1e-6,
                   max_iter: int = 1000, qr_passes: int = 1, replace_every: int = 0,
                   **kwargs):
    """Solve the full system A X = B through the half-size Schur system:
    split, right-hand side ``b_e + H_eo b_o / c``, Schur solve, odd
    reconstruction ``(b_o + H_oe x_e) / c``, assemble. The Schur solve is
    ``solve_sbcgrq`` (with ``qr_passes`` and ``replace_every``) unless
    ``solver(op, rhs, tol=, max_iter=, **kwargs) -> (X, info)`` is given,
    e.g. ``solve_cg`` on an (n, 1) B. Returns (X (n, k), info of the Schur
    solve). Complex B on a U(1) context (``eo.cdtype``) is converted through
    the realified codec on its device."""
    from blockcg_tpu_torch.solvers.sbcgrq import solve_sbcgrq

    if eo.cdtype is not None and B.is_complex():
        Xr, info = solve_dirac_eo(eo, eo.complex_to_real(B), solver, tol=tol,
                                  max_iter=max_iter, qr_passes=qr_passes,
                                  replace_every=replace_every, **kwargs)
        return eo.real_to_complex(Xr), info
    if solver is None:
        solver = solve_sbcgrq
        kwargs = dict(kwargs, qr_passes=qr_passes, replace_every=replace_every)
    be, bo = eo_split(eo, B)
    rhs = be + _hop(eo.hop_eo, bo) / eo.c
    Xe, info = solver(eo.schur, rhs, tol=tol, max_iter=max_iter, **kwargs)
    xo = (bo + _hop(eo.hop_oe, Xe)) / eo.c
    return eo_assemble(eo, Xe, xo), info


# The rank's shard of a context's Schur partition, built once per (context,
# group, D): the host partition and the uploads would dominate repeat
# solves. Keyed by id() with a weakref finalizer that evicts the entry when
# the context is collected.
_EO_PARTITION_CACHE: dict = {}


def solve_dirac_eo_dist(eo: EOContext, B: torch.Tensor, group, *, tol: float = 1e-6,
                        max_iter: int = 1000, qr_passes: int = 1, replace_every: int = 0,
                        record_history: bool = False):
    """``solve_dirac_eo`` with the half-size Schur system row-partitioned
    over the ranks of ``group`` (``parallel.solve_sbcgrq_dist``); the split,
    right-hand side, odd reconstruction and assembly run on every rank's
    whole field. The plan is ``partition_dirac_eo(eo, D)``, D the size of
    ``group``, sharded on the context's device and cached per (context,
    group, D). Complex B on a U(1) context converts as in
    ``solve_dirac_eo``. Returns (X (n, k), info)."""
    import torch.distributed as dist

    from blockcg_tpu_torch.parallel import partition_dirac_eo, solve_sbcgrq_dist

    if eo.cdtype is not None and B.is_complex():
        Xr, info = solve_dirac_eo_dist(eo, eo.complex_to_real(B), group, tol=tol,
                                       max_iter=max_iter, qr_passes=qr_passes,
                                       replace_every=replace_every,
                                       record_history=record_history)
        return eo.real_to_complex(Xr), info
    D = dist.get_world_size(group)
    key = (id(eo), id(group), D)
    dschur = _EO_PARTITION_CACHE.get(key)
    if dschur is None:
        dschur = partition_dirac_eo(eo, D).shard(dist.get_rank(group), group, eo.q0.device)
        weakref.finalize(eo, _EO_PARTITION_CACHE.pop, key, None)
        _EO_PARTITION_CACHE[key] = dschur
    be, bo = eo_split(eo, B)
    rhs = be + _hop(eo.hop_eo, bo) / eo.c
    Xe, info = solve_sbcgrq_dist(dschur, rhs, group, tol=tol, max_iter=max_iter,
                                 qr_passes=qr_passes, replace_every=replace_every,
                                 record_history=record_history)
    xo = (bo + _hop(eo.hop_oe, Xe)) / eo.c
    return eo_assemble(eo, Xe, xo), info


def solve_dirac_eo_shifted(eo: EOContext, B: torch.Tensor, sigmas, *, tol: float = 1e-6,
                           max_iter: int = 1000, qr_passes: int = 1):
    """Multi-shift solve of the full systems ``(A + sigma_j) X_j = B``
    through one even-odd-reduced block Krylov space (the RHMC pattern).

    With f_j = c + sigma_j and K = H_eo H_oe the even-site systems are
    (f_j^2 - K) x_e = f_j b_e + H_eo b_o; with mu0 = (c + min sigma)^2 they
    are non-negative shifts f_j^2 - mu0 of the SPD ``EONormalOperator``
    mu0 - K. By linearity one multi-shift solve on the fixed 2k-column block
    [b_e | H_eo b_o] gives Y1, Y2 and x_e = f Y1 + Y2; x_o = (b_o + H_oe
    x_e) / f. One apply of K (both parity hops) per iteration for all
    shifts. Returns (Xs (nshift, n, k), info)."""
    from blockcg_tpu_torch.solvers.shifted_block import solve_shifted_sbcgrq

    if eo.cdtype is not None and B.is_complex():
        Xr, info = solve_dirac_eo_shifted(eo, eo.complex_to_real(B), sigmas, tol=tol,
                                          max_iter=max_iter, qr_passes=qr_passes)
        return torch.stack([eo.real_to_complex(X) for X in Xr]), info

    sig = np.atleast_1d(np.asarray(sigmas, dtype=np.float64))
    if (sig < 0).any():
        raise ValueError("shifts must be non-negative")
    f = eo.c + sig
    mu0 = float(f.min()) ** 2
    kop = EONormalOperator(eo.hop_eo, eo.hop_oe, mu0)

    be, bo = eo_split(eo, B)
    k = be.shape[1]
    B2 = torch.cat([be, _hop(eo.hop_eo, bo)], dim=1)  # (n_e, 2k)
    mus = [float(fj * fj - mu0) for fj in f]
    Ys, info = solve_shifted_sbcgrq(kop, B2, mus, tol=tol, max_iter=max_iter,
                                    qr_passes=qr_passes)
    outs = []
    for Yj, fj in zip(Ys, map(float, f)):
        xe = fj * Yj[:, :k] + Yj[:, k:]
        xo = (bo + _hop(eo.hop_oe, xe)) / fj
        outs.append(eo_assemble(eo, xe, xo))
    return torch.stack(outs), info
