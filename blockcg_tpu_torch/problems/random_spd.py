"""Random SPD test fixtures (f64 numpy; cast at the call site).

Counterpart of ``blockcg_tpu/problems/random_spd.py``, the same numbers from
the same seeds: small random Hermitian ``V V^H + delta I`` matrices, as the
reference's unit tests use.
"""

from __future__ import annotations

import numpy as np


def random_spd(n: int, delta: float = 1.0, seed: int = 0) -> np.ndarray:
    """Dense SPD ``V V^T / n + delta * I``."""
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, n))
    return V @ V.T / n + delta * np.eye(n)


def random_block(n: int, k: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, k))


def random_hpd(n: int, delta: float = 1.0, seed: int = 0) -> np.ndarray:
    """Dense complex Hermitian positive-definite ``V V^H / (2n) + delta I``
    (complex128), the complex analog of ``random_spd``."""
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return V @ V.conj().T / (2 * n) + delta * np.eye(n)


def random_block_c(n: int, k: int, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
