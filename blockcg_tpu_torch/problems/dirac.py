"""Lattice-Dirac-like SPD block operator (north-star config 4), const-hop form.

Counterpart of the const-hop builders of ``blockcg_tpu/problems/dirac.py``.
A 4x4-blocked SPD operator on a 4D lattice L^4 with nearest-neighbour
hopping, the structure of an even-odd-preconditioned Wilson ``D^H D + m^2``:

    A[x, x]      = (m^2 + 8) * I_4
    A[x, x+mu]   = -H_mu          (mu = 0..3)
    A[x, x-mu]   = -H_mu^T

with fixed deterministic symmetric 4x4 hopping matrices ``H_mu`` of unit
spectral norm (block-Gershgorin SPD, ``lambda_min >= m^2``). Boundary
conditions are ``periodic`` (wraps become extra masked diagonals) or
``open``. The numpy construction is carried over as it is, since the port
may not import the reference package: masks, hops, offsets, slots and slabs
come out bitwise the reference's.

Complex dtypes need the realified operator (``operators/realify.py``), which
is not ported yet: they raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from blockcg_tpu_torch.operators.cbdia import ConstBlockDIAOperator, detect_slabs

BS = 4  # spin-block size
_NDIM = 4


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


def _real_np_dtype(dtype: torch.dtype, what: str):
    if dtype.is_complex:
        raise NotImplementedError(
            f"{what}: complex operators need operators/realify.py, which is "
            "not ported yet")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype must be float32 or float64, got {dtype}")
    return np.float64 if dtype == torch.float64 else np.float32


def _check_bc(bc: str) -> None:
    if bc not in ("periodic", "open"):
        raise ValueError(f"bc must be 'periodic' or 'open', got {bc!r}")


def _tup(block: np.ndarray) -> tuple:
    return tuple(tuple(float(v) for v in row) for row in block)


def _nnz(hops, mask_slot, masks, ns: int) -> int:
    """Structural nonzeros: nonzero hop entries times the rows each diagonal
    reaches (the nonzero entries of its mask)."""
    nnz = 0
    for d, sl in enumerate(mask_slot):
        rows = ns if sl < 0 else int(np.count_nonzero(masks[sl]))
        nnz += int(np.count_nonzero(np.asarray(hops[d]))) * rows
    return nnz


def dirac_cbdia(L: int, m: float = 0.5, bc: str = "periodic",
                dtype: torch.dtype = torch.float32, seed: int = 7,
                device=None) -> ConstBlockDIAOperator:
    """The operator as a ConstBlockDIAOperator (spin-major rows): constant
    hop blocks and 0/1 boundary masks. Wrap diagonals whose support is whole
    g-site slabs (the z-wraps, from L = 16 on) go to the slab kernel
    (``detect_slabs``)."""
    _check_bc(bc)
    np_dtype = _real_np_dtype(dtype, "dirac_cbdia")
    H = hopping_matrices(seed).astype(np_dtype)
    ns = L ** _NDIM
    coords, strides = _coords(ns, L)

    offsets: list[int] = [0]
    hops: list[tuple] = [_tup((m * m + 2.0 * _NDIM) * np.eye(BS, dtype=np_dtype))]
    mask_slot: list[int] = [-1]
    masks: list[np.ndarray] = []

    def add(o: int, block: np.ndarray, mask: np.ndarray | None):
        offsets.append(o)
        hops.append(_tup(block))
        if mask is None:
            mask_slot.append(-1)
        else:
            mask_slot.append(len(masks))
            masks.append(mask.astype(np_dtype))

    for ax in range(_NDIM):
        st = strides[ax]
        c = coords[ax]
        if bc == "periodic" and ax == 0:
            # Slowest axis: the flat-index wraparound is the lattice's
            # (toroidal semantics), so these diagonals need no mask.
            add(st, -H[ax], None)
            add(-st, -H[ax].T, None)
            continue
        add(st, -H[ax], c < L - 1)
        add(-st, -H[ax].T, c > 0)
        if bc == "periodic":
            add(-(L - 1) * st, -H[ax], c == L - 1)
            add((L - 1) * st, -H[ax].T, c == 0)

    masks_np = np.stack(masks) if masks else None
    nnz = _nnz(hops, mask_slot, masks, ns)
    slabs = detect_slabs(masks_np, offsets, mask_slot, ns)
    return ConstBlockDIAOperator.from_numpy(
        masks_np, tuple(hops), tuple(offsets), tuple(mask_slot), ns,
        slabs=slabs, nnz=nnz, dtype=dtype, device=device)


def dirac_gauged_cbdia(L: int, m: float = 0.5, bc: str = "periodic",
                       dtype: torch.dtype = torch.float32, seed: int = 7,
                       gauge_seed: int = 11,
                       device=None) -> ConstBlockDIAOperator:
    """Gauged Dirac-like operator with real Z2 links in the const-hop
    container: every hop diagonal carries a value mask, the link (+-1) times
    the boundary gate, so nothing is slab-routed and every diagonal goes
    through the main kernel. (The complex U(1) flavour is realified and
    waits for ``operators/realify.py``.)"""
    _check_bc(bc)
    np_dtype = _real_np_dtype(dtype, "dirac_gauged_cbdia")
    H = hopping_matrices(seed).astype(np_dtype)
    ns = L ** _NDIM
    coords, strides = _coords(ns, L)
    grng = np.random.default_rng(gauge_seed)
    links = grng.choice([-1.0, 1.0], size=(_NDIM, ns)).astype(np_dtype)
    s = np.arange(ns)

    offsets: list[int] = [0]
    hops: list[tuple] = [_tup((m * m + 2.0 * _NDIM) * np.eye(BS, dtype=np_dtype))]
    mask_slot: list[int] = [-1]
    masks: list[np.ndarray] = []

    def add(o: int, Hc: np.ndarray, phi: np.ndarray, gate):
        g = np.ones(ns, np_dtype) if gate is None else gate.astype(np_dtype)
        offsets.append(o)
        hops.append(_tup(-Hc))
        mask_slot.append(len(masks))
        masks.append(phi.astype(np_dtype) * g)

    for ax in range(_NDIM):
        st = strides[ax]
        c = coords[ax]
        phi = links[ax]  # link from site s toward +mu
        # The -mu coupling of row s uses the link anchored at the neighbour.
        dn = (s + st * np.where(c == 0, L - 1, -1)) % ns
        phi_dn = links[ax][dn]
        if bc == "periodic" and ax == 0:
            add(st, H[ax], phi, None)
            add(-st, H[ax].T, phi_dn, None)
            continue
        add(st, H[ax], phi, c < L - 1)
        add(-st, H[ax].T, phi_dn, c > 0)
        if bc == "periodic":
            add(-(L - 1) * st, H[ax], phi, c == L - 1)
            add((L - 1) * st, H[ax].T, phi_dn, c == 0)

    return ConstBlockDIAOperator.from_numpy(
        np.stack(masks), tuple(hops), tuple(offsets), tuple(mask_slot), ns,
        nnz=_nnz(hops, mask_slot, masks, ns), dtype=dtype, device=device)
