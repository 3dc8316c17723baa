"""Lattice-Dirac-like SPD block operators (north-star config 4 and the
matrix-link family).

Counterpart of ``blockcg_tpu/problems/dirac.py``. A 4x4-blocked operator on
a 4D lattice L^4 with nearest-neighbour hopping, the structure of an
even-odd-preconditioned Wilson ``D^H D + m^2``:

    A[x, x]      = (m^2 + 8) * I_4
    A[x, x+mu]   = -H_mu          (mu = 0..3)
    A[x, x-mu]   = -H_mu^H

with fixed deterministic Hermitian 4x4 hopping matrices ``H_mu`` of unit
spectral norm (block-Gershgorin SPD/HPD, ``lambda_min >= m^2``). Boundary
conditions are ``periodic`` (wraps become extra masked diagonals) or
``open``. Real dtypes give a real symmetric operator, complex dtypes a
complex Hermitian one.

Two containers:

- ``ConstBlockDIAOperator`` (``dirac_cbdia``, ``dirac_gauged_cbdia``):
  constant hop blocks and per-site masks. Complex hops make a container
  whose card route is ``operators.realify``; the complex U(1)
  ``dirac_gauged_cbdia`` is built realified directly.
- ``BlockDIAOperator`` (``dirac_bdia``, ``dirac_gauged``,
  ``dirac_gauged_matrix``): per-site blocks, for links that vary per site;
  matrix-valued (orthogonal or unitary) links exist only here.

``dirac_bell`` builds the same matrix as a ``BSROperator`` in site-major
order (general block sparsity), and ``dirac_scipy`` exports that form.

The numpy construction is carried over as it is, since the port may not
import the reference package: masks, hops, blocks, offsets, slots, slabs,
``wrap_zero``, nnz and the folded wrap fields (``_folded_fields``, built on
periodic per-site operators under ``BLOCKCG_FOLD``, as the reference's) come
out bitwise the reference's. Every builder puts its operator on the card
unless ``device`` says otherwise.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from blockcg_tpu_torch.operators.base import assert_wrap_zero
from blockcg_tpu_torch.operators.bdia import BlockDIAOperator
from blockcg_tpu_torch.operators.bsr import BSROperator
from blockcg_tpu_torch.operators.cbdia import ConstBlockDIAOperator, detect_slabs
from blockcg_tpu_torch.operators.realify import (
    RealifiedHermitianOperator,
    k1k2_blocks,
    real_mask_dtype,
)

BS = 4  # spin-block size
_NDIM = 4
_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.complex64: np.complex64, torch.complex128: np.complex128}


def hopping_matrices(seed: int = 7, hermitian: bool = False) -> np.ndarray:
    """Four fixed 4x4 hopping matrices with unit spectral norm, (4, 4, 4).

    ``hermitian=False``: real symmetric (the real SPD operator);
    ``hermitian=True``: complex Hermitian."""
    rng = np.random.default_rng(seed)
    hs = []
    for _ in range(_NDIM):
        if hermitian:
            g = rng.standard_normal((BS, BS)) + 1j * rng.standard_normal((BS, BS))
            h = 0.5 * (g + g.conj().T)
        else:
            g = rng.standard_normal((BS, BS))
            h = 0.5 * (g + g.T)
        h = h / np.abs(np.linalg.eigvalsh(h)).max()
        hs.append(h)
    return np.stack(hs)


def _coords(ns: int, L: int) -> tuple[list[np.ndarray], list[int]]:
    idx = np.arange(ns)
    strides = [L ** (_NDIM - 1 - ax) for ax in range(_NDIM)]
    return [(idx // strides[ax]) % L for ax in range(_NDIM)], strides


def _folded_fields(blk: np.ndarray, offsets, L: int, force: bool = False) -> dict:
    """The folded periodic-wrap form of per-site blocks (the reference's
    ``problems/dirac.py`` ``_folded_fields``): each toroidal wrap diagonal
    (offset o (1 - L), nonzero only on its axis's wrap boundary) merged into
    its bulk hop partner (offset o, zero exactly there), so one coefficient
    stream serves both. Returns the keywords ``blocks_folded`` (numpy),
    ``fold_offsets`` and ``fold`` (``((index in the folded offsets, L),
    ...)``), or {} without wrap pairs. The kernel selects the wrap's source
    on destination sites with ``(s // st) % L == phase`` (L - 1 for o > 0, 0
    for o < 0): a pair is folded only where the bulk values are zero on
    exactly those sites and the wrap values nowhere else, checked here.
    Opt-in, as the reference's: ``BLOCKCG_FOLD``, or ``force``."""
    if not (force or os.environ.get("BLOCKCG_FOLD")):
        return {}
    if L <= 2:  # the wrap offset -o is the opposite bulk hop: nothing to fold
        return {}
    ns = blk.shape[-1]
    pairs = []
    used: set[int] = set()
    for d, o in enumerate(offsets):
        if d in used:
            continue
        ow = o * (1 - L)
        if o == 0 or ow == o:
            continue
        st = abs(o)
        if st * L > ns or ns % (st * L) != 0:
            continue
        phase = L - 1 if o > 0 else 0
        on_mask = (np.arange(ns) // st) % L == phase
        if ((np.abs(blk[d]).sum(axis=(0, 1)) > 0) & on_mask).any():
            continue
        # Duplicate offsets are legal: take the first unused wrap candidate
        # whose values sit on the mask's sites alone.
        for dw, oo in enumerate(offsets):
            if oo != ow or dw in used or dw == d:
                continue
            if ((np.abs(blk[dw]).sum(axis=(0, 1)) > 0) & ~on_mask).any():
                continue
            pairs.append((d, dw))
            used.update((d, dw))
            break
    if not pairs:
        return {}
    wrap_idx = {dw for _, dw in pairs}
    keep = [d for d in range(len(offsets)) if d not in wrap_idx]
    folded = blk[keep].copy()
    fold = []
    for d, dw in pairs:
        pos = keep.index(d)
        folded[pos] += blk[dw]
        fold.append((pos, L))
    return {"blocks_folded": folded, "fold_offsets": tuple(offsets[d] for d in keep),
            "fold": tuple(fold)}


def _np_dtype(dtype: torch.dtype, what: str):
    if dtype not in _NP_DTYPES:
        raise TypeError(f"{what}: dtype must be float32, float64, complex64 or "
                        f"complex128, got {dtype} (operators.astype(op, dtype) casts a "
                        f"built operator)")
    return np.dtype(_NP_DTYPES[dtype])


def _setup(L: int, bc: str, dtype: torch.dtype, seed: int, what: str,
           bf16_ok: bool = False):
    """(np dtype, complex?, H, ns, coords, strides) of a builder. A bf16
    build (``bf16_ok``: the builders that take ``torch.bfloat16``) works in
    float32: its operator rounds every entry to bf16 once, which gives the
    reference's bf16 build bitwise."""
    if bc not in ("periodic", "open"):
        raise ValueError(f"bc must be 'periodic' or 'open', got {bc!r}")
    bf16 = bf16_ok and dtype == torch.bfloat16
    np_dtype = _np_dtype(torch.float32 if bf16 else dtype, what)
    cplx = np.issubdtype(np_dtype, np.complexfloating)
    H = hopping_matrices(seed, hermitian=cplx).astype(np_dtype)
    ns = L ** _NDIM
    coords, strides = _coords(ns, L)
    return np_dtype, cplx, H, ns, coords, strides


def _nnz(hops, mask_slot, masks, ns: int) -> int:
    """Structural nonzeros: nonzero hop entries times the rows each diagonal
    reaches (the nonzero entries of its mask)."""
    nnz = 0
    for d, sl in enumerate(mask_slot):
        rows = ns if sl < 0 else int(np.count_nonzero(masks[sl]))
        nnz += int(np.count_nonzero(np.asarray(hops[d]))) * rows
    return nnz


# ------------------------------------------------------ const-hop containers


def dirac_cbdia(L: int, m: float = 0.5, bc: str = "periodic",
                dtype: torch.dtype = torch.float32, seed: int = 7,
                device="cuda") -> ConstBlockDIAOperator:
    """The operator as a ConstBlockDIAOperator (spin-major rows): constant
    hop blocks and 0/1 boundary masks. Wrap diagonals whose support is whole
    g-site slabs (the z-wraps, from L = 16 on) go to the slab kernel
    (``detect_slabs``). A complex dtype gives complex hops over real masks:
    a container, whose card route is ``realify``. ``torch.bfloat16`` builds
    in float32 and rounds every hop entry to bf16 (round to nearest even,
    as the reference's bf16 build does), so ``hops`` holds the bf16 values
    and an f64 copy (``astype``) applies exactly the bf16 matrix."""
    bf16 = dtype == torch.bfloat16
    np_dtype, cplx, H, ns, coords, strides = _setup(L, bc, dtype, seed, "dirac_cbdia",
                                                    bf16_ok=True)
    scal = complex if cplx else float
    # Boundary masks are real 0/1 gates, of the dtype's real width.
    single = np_dtype in (np.float32, np.complex64)
    mask_dtype = np.float32 if single else np.float64

    def tup(block: np.ndarray) -> tuple:
        if bf16:
            block = torch.from_numpy(np.asarray(block)).to(torch.bfloat16).double().numpy()
        return tuple(tuple(scal(v) for v in row) for row in block)

    offsets: list[int] = [0]
    hops: list[tuple] = [tup((m * m + 2.0 * _NDIM) * np.eye(BS, dtype=np_dtype))]
    mask_slot: list[int] = [-1]
    masks: list[np.ndarray] = []

    def add(o: int, block: np.ndarray, mask: np.ndarray | None):
        offsets.append(o)
        hops.append(tup(block))
        if mask is None:
            mask_slot.append(-1)
        else:
            mask_slot.append(len(masks))
            masks.append(mask.astype(mask_dtype))

    for ax in range(_NDIM):
        st = strides[ax]
        c = coords[ax]
        if bc == "periodic" and ax == 0:
            # Slowest axis: the flat-index wraparound is the lattice's
            # (toroidal semantics), so these diagonals need no mask.
            add(st, -H[ax], None)
            add(-st, -H[ax].conj().T, None)
            continue
        add(st, -H[ax], c < L - 1)
        add(-st, -H[ax].conj().T, c > 0)
        if bc == "periodic":
            add(-(L - 1) * st, -H[ax], c == L - 1)
            add((L - 1) * st, -H[ax].conj().T, c == 0)

    masks_np = np.stack(masks) if masks else None
    nnz = _nnz(hops, mask_slot, masks, ns)
    slabs = detect_slabs(masks_np, offsets, mask_slot, ns)
    return ConstBlockDIAOperator.from_numpy(
        masks_np, tuple(hops), tuple(offsets), tuple(mask_slot), ns,
        slabs=slabs, nnz=nnz, dtype=dtype if bf16 else (torch.float32 if single else torch.float64),
        device=device)


def dirac_gauged_cbdia(L: int, m: float = 0.5, bc: str = "periodic",
                       dtype: torch.dtype = torch.float32, seed: int = 7,
                       gauge_seed: int = 11, device="cuda"):
    """Gauged Dirac-like operator in the const-hop container: a scalar link
    field factors every per-site hop into (constant spin matrix) x (per-site
    scalar), so the masks carry the link values times the boundary gate, and
    nothing is slab-routed.

    Real dtypes: Z2 links (+-1), one value mask per hop diagonal; returns a
    ConstBlockDIAOperator. Complex dtypes: U(1) phase links; the realified
    ``phi H = Re(phi) K1 + Im(phi) K2`` (``k1k2_blocks``, constant real
    2bs x 2bs blocks) gives two value-masked diagonals per hop (29 in all),
    returned as a RealifiedHermitianOperator over that real const-hop core.
    Same matrix as ``dirac_gauged``."""
    np_dtype, cplx, H, ns, coords, strides = _setup(L, bc, dtype, seed,
                                                    "dirac_gauged_cbdia")
    grng = np.random.default_rng(gauge_seed)
    if cplx:
        links = np.exp(2j * np.pi * grng.random((_NDIM, ns))).astype(np_dtype)
        rdt = real_mask_dtype(np_dtype)
    else:
        links = grng.choice([-1.0, 1.0], size=(_NDIM, ns)).astype(np_dtype)
        rdt = np_dtype
    s = np.arange(ns)

    def tup(block: np.ndarray) -> tuple:
        return tuple(tuple(float(v) for v in row) for row in block)

    offsets: list[int] = [0]
    hops: list[tuple] = [tup((m * m + 2.0 * _NDIM) * np.eye(2 * BS if cplx else BS, dtype=rdt))]
    mask_slot: list[int] = [-1]
    masks: list[np.ndarray] = []

    def add_masked(o: int, K: np.ndarray, vals: np.ndarray):
        offsets.append(o)
        hops.append(tup(-K))
        mask_slot.append(len(masks))
        masks.append(vals)

    def add(o: int, Hc: np.ndarray, phi: np.ndarray, gate):
        g = np.ones(ns, rdt) if gate is None else gate.astype(rdt)
        if not cplx:
            add_masked(o, Hc, phi.astype(rdt) * g)
            return
        K1, K2 = k1k2_blocks(Hc, rdt)
        for K, part in ((K1, phi.real), (K2, phi.imag)):
            vals = part.astype(rdt) * g
            if np.any(vals):
                add_masked(o, K, vals)

    for ax in range(_NDIM):
        st = strides[ax]
        c = coords[ax]
        phi = links[ax]  # link from site s toward +mu
        # The -mu coupling of row s uses the link anchored at the neighbour.
        dn = (s + st * np.where(c == 0, L - 1, -1)) % ns
        phi_dn = np.conj(links[ax][dn]) if cplx else links[ax][dn]
        if bc == "periodic" and ax == 0:
            add(st, H[ax], phi, None)
            add(-st, H[ax].conj().T, phi_dn, None)
            continue
        add(st, H[ax], phi, c < L - 1)
        add(-st, H[ax].conj().T, phi_dn, c > 0)
        if bc == "periodic":
            add(-(L - 1) * st, H[ax], phi, c == L - 1)
            add((L - 1) * st, H[ax].conj().T, phi_dn, c == 0)

    nnz = _nnz(hops, mask_slot, masks, ns)
    rdtype = torch.float64 if rdt == np.float64 else torch.float32
    core = ConstBlockDIAOperator.from_numpy(
        np.stack(masks), tuple(hops), tuple(offsets), tuple(mask_slot), ns,
        nnz=None if cplx else nnz, dtype=rdtype, device=device)
    if not cplx:
        return core
    # The complex operator's nnz (the real core's quadruples it), as the
    # reference keeps it for nnz/s.
    return RealifiedHermitianOperator(core, BS, ns, rdtype.to_complex(),
                                      nnz=nnz // 4 if nnz % 4 == 0 else nnz)


# ------------------------------------------------------ per-site containers


def _bdia(blk: np.ndarray, offsets, L: int, bc: str, dtype, device) -> BlockDIAOperator:
    """The operator of host blocks, with its folded form on periodic
    lattices (``_folded_fields``), in ``dtype`` (bf16 rounds both block
    arrays once)."""
    ns = blk.shape[-1]
    if bc == "open":
        assert_wrap_zero(blk, offsets, ns, what=f"dirac builder (L={L}, open)")
    folded = _folded_fields(blk, list(offsets), L) if bc == "periodic" else {}
    return BlockDIAOperator.from_numpy(blk, tuple(offsets), wrap_zero=(bc == "open"),
                                       nnz=int(np.count_nonzero(blk)), dtype=dtype,
                                       device=device, **folded)


def _diag_blocks(m: float, ns: int, np_dtype) -> np.ndarray:
    diag = np.zeros((BS, BS, ns), dtype=np_dtype)
    diag[:, :, :] = ((m * m + 2.0 * _NDIM) * np.eye(BS, dtype=np_dtype))[:, :, None]
    return diag


def dirac_bdia(L: int, m: float = 0.5, bc: str = "periodic",
               dtype: torch.dtype = torch.float32, seed: int = 7,
               device="cuda") -> BlockDIAOperator:
    """The operator as a BlockDIAOperator (spin-major rows): the same matrix
    as ``dirac_cbdia``, with every hop block stored per site. ``torch.bfloat16``
    stores the blocks rounded to bf16, as the reference's bf16 build."""
    np_dtype, cplx, H, ns, coords, strides = _setup(L, bc, dtype, seed, "dirac_bdia",
                                                    bf16_ok=True)
    offsets: list[int] = [0]
    blocks: list[np.ndarray] = [_diag_blocks(m, ns, np_dtype)]

    def masked(block: np.ndarray, mask: np.ndarray) -> np.ndarray:
        out = np.zeros((BS, BS, ns), dtype=np_dtype)
        out[:, :, mask] = block[:, :, None]
        return out

    for ax in range(_NDIM):
        st = strides[ax]
        c = coords[ax]
        if bc == "periodic" and ax == 0:
            # Slowest axis: one unmasked diagonal per direction covers hop
            # and wrap ((s +/- L^3) mod ns).
            offsets.append(st)
            blocks.append(masked(-H[ax], np.ones(ns, bool)))
            offsets.append(-st)
            blocks.append(masked(-H[ax].conj().T, np.ones(ns, bool)))
            continue
        offsets.append(st)
        blocks.append(masked(-H[ax], c < L - 1))
        offsets.append(-st)
        blocks.append(masked(-H[ax].conj().T, c > 0))
        if bc == "periodic":
            offsets.append(-(L - 1) * st)
            blocks.append(masked(-H[ax], c == L - 1))
            offsets.append((L - 1) * st)
            blocks.append(masked(-H[ax].conj().T, c == 0))
    return _bdia(np.stack(blocks), offsets, L, bc, dtype, device)


def dirac_gauged(L: int, m: float = 0.5, bc: str = "periodic",
                 dtype: torch.dtype = torch.float32, seed: int = 7,
                 gauge_seed: int = 11, device="cuda") -> BlockDIAOperator:
    """Gauged (site-dependent scalar link) flavour as a BlockDIAOperator:
    real dtypes carry Z2 links (+-1 per site and direction), complex dtypes
    U(1) phases. ``A[x, x+mu] = -phi_mu(x) H_mu``, ``A[x+mu, x] =
    -conj(phi_mu(x)) H_mu^H``; |phi| = 1 keeps ``lambda_min >= m^2``.
    ``torch.bfloat16`` stores the blocks rounded to bf16 (the Z2 links are
    exact), as the reference's bf16 build."""
    np_dtype, cplx, H, ns, coords, strides = _setup(L, bc, dtype, seed, "dirac_gauged",
                                                    bf16_ok=True)
    grng = np.random.default_rng(gauge_seed)
    if cplx:
        links = np.exp(2j * np.pi * grng.random((_NDIM, ns))).astype(np_dtype)
    else:
        links = grng.choice([-1.0, 1.0], size=(_NDIM, ns)).astype(np_dtype)
    offsets: list[int] = [0]
    blocks: list[np.ndarray] = [_diag_blocks(m, ns, np_dtype)]

    def fielded(block: np.ndarray, phi: np.ndarray, mask: np.ndarray):
        out = np.zeros((BS, BS, ns), dtype=np_dtype)
        out[:, :, mask] = block[:, :, None] * phi[mask][None, None, :]
        return out

    s = np.arange(ns)
    for ax in range(_NDIM):
        st = strides[ax]
        c = coords[ax]
        phi = links[ax]
        dn = (s + st * np.where(c == 0, L - 1, -1)) % ns
        phi_dn = np.conj(links[ax][dn]) if cplx else links[ax][dn]
        if bc == "periodic" and ax == 0:
            offsets.append(st)
            blocks.append(fielded(-H[ax], phi, np.ones(ns, bool)))
            offsets.append(-st)
            blocks.append(fielded(-H[ax].conj().T, phi_dn, np.ones(ns, bool)))
            continue
        offsets.append(st)
        blocks.append(fielded(-H[ax], phi, c < L - 1))
        offsets.append(-st)
        blocks.append(fielded(-H[ax].conj().T, phi_dn, c > 0))
        if bc == "periodic":
            offsets.append(-(L - 1) * st)
            blocks.append(fielded(-H[ax], phi, c == L - 1))
            offsets.append((L - 1) * st)
            blocks.append(fielded(-H[ax].conj().T, phi_dn, c == 0))
    return _bdia(np.stack(blocks), offsets, L, bc, dtype, device)


def dirac_gauged_matrix(L: int, m: float = 0.5, bc: str = "periodic",
                        dtype: torch.dtype = torch.float32, seed: int = 7,
                        gauge_seed: int = 11, device="cuda") -> BlockDIAOperator:
    """Matrix-valued-link (SU(N)-style) gauged operator: per site and
    direction a random orthogonal (real) or unitary (complex) bs x bs link
    U_mu(x), with ``A[x, x+mu] = -U_mu(x) H_mu`` and ``A[x+mu, x]`` its
    adjoint. Orthogonal U keeps ``||U H|| = 1``, so ``lambda_min >= m^2``.
    Such links do not factor into the const-hop form: this family needs the
    per-site block stencil. ``torch.bfloat16`` raises, as the reference's
    build does: ``operators.astype(op, torch.bfloat16)`` stores a built
    operator's blocks (and folded blocks) in bf16."""
    np_dtype, cplx, H, ns, coords, strides = _setup(L, bc, dtype, seed,
                                                    "dirac_gauged_matrix")
    grng = np.random.default_rng(gauge_seed)
    g = grng.standard_normal((_NDIM, ns, BS, BS))
    if cplx:
        g = g + 1j * grng.standard_normal((_NDIM, ns, BS, BS))
    U, _ = np.linalg.qr(g)  # batched: orthogonal/unitary per site and direction
    U = U.astype(np_dtype)
    offsets: list[int] = [0]
    blocks: list[np.ndarray] = [_diag_blocks(m, ns, np_dtype)]

    def masked(blk3, mask):
        out = np.zeros((BS, BS, ns), dtype=np_dtype)
        out[:, :, mask] = blk3[:, :, mask]
        return out

    s = np.arange(ns)
    for ax in range(_NDIM):
        st = strides[ax]
        c = coords[ax]
        # forward per-site blocks -U_mu(s) H_mu, laid out (BS, BS, ns)
        fwd = -np.einsum("sij,jk->iks", U[ax], H[ax])
        dn = (s + st * np.where(c == 0, L - 1, -1)) % ns
        # -mu coupling of row s: the adjoint of the neighbour's forward block
        bwd = np.conj(np.transpose(fwd[:, :, dn], (1, 0, 2)))
        if bc == "periodic" and ax == 0:
            offsets.append(st)
            blocks.append(fwd)
            offsets.append(-st)
            blocks.append(bwd)
            continue
        offsets.append(st)
        blocks.append(masked(fwd, c < L - 1))
        offsets.append(-st)
        blocks.append(masked(bwd, c > 0))
        if bc == "periodic":
            offsets.append(-(L - 1) * st)
            blocks.append(masked(fwd, c == L - 1))
            offsets.append((L - 1) * st)
            blocks.append(masked(bwd, c == 0))
    return _bdia(np.stack(blocks), offsets, L, bc, dtype, device)


def bdia_scipy(op: BlockDIAOperator):
    """BlockDIAOperator -> scipy CSR in f64 or c128 (small problems; the test
    oracle)."""
    import scipy.sparse as sp

    bs, ns = op.bs, op.ns
    n = bs * ns
    blocks = op.blocks.detach().cpu().numpy()
    blocks = blocks.astype(np.complex128 if np.iscomplexobj(blocks) else np.float64)
    rows, cols, data = [], [], []
    s = np.arange(ns)
    for d, o in enumerate(op.offsets):
        scol = (s + o) % ns  # toroidal semantics
        for a in range(bs):
            for b in range(bs):
                vals = blocks[d, a, b, :]
                nzm = vals != 0
                rows.append(a * ns + s[nzm])
                cols.append(b * ns + scol[nzm])
                data.append(vals[nzm])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    data = np.concatenate(data)
    return sp.coo_matrix((data, (rows, cols)), shape=(n, n)).tocsr()


def dirac_bell(L: int, m: float = 0.5, dtype: torch.dtype = torch.float32, seed: int = 7,
               bc: str = "periodic", device="cuda") -> BSROperator:
    """The operator as a ``BSROperator`` (block-ELL, site-major rows:
    row ``s * 4 + a``): slot 0 the diagonal block, then the +mu and -mu hops
    of each axis. ``nnz`` counts the nonzero block entries."""
    np_dtype, cplx, H, n_sites, coords, strides = _setup(L, bc, dtype, seed, "dirac_bell")
    wb = 1 + 2 * _NDIM
    idx = np.arange(n_sites)
    cols = np.empty((n_sites, wb), dtype=np.int64)
    vals = np.empty((n_sites, wb, BS, BS), dtype=np_dtype)
    cols[:, 0] = idx
    vals[:, 0] = (m * m + 2.0 * _NDIM) * np.eye(BS, dtype=np_dtype)
    slot = 1
    for ax in range(_NDIM):
        st = strides[ax]
        c = coords[ax]
        if bc == "periodic":
            up = idx + st * np.where(c == L - 1, 1 - L, 1)
            dn = idx + st * np.where(c == 0, L - 1, -1)
            up_mask = np.ones(n_sites, bool)
            dn_mask = np.ones(n_sites, bool)
        else:
            up = np.where(c < L - 1, idx + st, idx)
            dn = np.where(c > 0, idx - st, idx)
            up_mask = c < L - 1
            dn_mask = c > 0
        cols[:, slot] = up
        vals[:, slot] = np.where(up_mask[:, None, None], -H[ax], 0.0)
        cols[:, slot + 1] = dn
        vals[:, slot + 1] = np.where(dn_mask[:, None, None], -H[ax].conj().T, 0.0)
        slot += 2
    return BSROperator(torch.from_numpy(vals).to(device), torch.from_numpy(cols).to(device),
                       int(np.count_nonzero(vals)))


def dirac_scipy(L: int, m: float = 0.5, seed: int = 7, bc: str = "periodic"):
    """scipy CSR export of the BSR (site-major) form in f64 for small L
    (duplicates summed, which handles L = 2, where +mu and -mu coincide)."""
    import scipy.sparse as sp

    op = dirac_bell(L, m=m, dtype=torch.float64, seed=seed, bc=bc, device="cpu")
    nbr, wb = op.cols.shape
    vals = op.vals.numpy()
    cols = op.cols.numpy()
    n = nbr * BS
    br = np.repeat(np.arange(nbr), wb)
    sub_r, sub_c = np.meshgrid(np.arange(BS), np.arange(BS), indexing="ij")
    rows = (br[:, None, None] * BS + sub_r[None]).reshape(-1)
    ccols = (cols.reshape(-1)[:, None, None] * BS + sub_c[None]).reshape(-1)
    return sp.coo_matrix((vals.reshape(-1), (rows, ccols)), shape=(n, n)).tocsr()
