"""Even-odd (red-black) Schur-complement operators: lattice preconditioning.

Counterpart of ``blockcg_tpu/operators/schur.py``. A nearest-neighbour
operator couples only opposite parities, so in even/odd ordering

    A = [[c I, -H_eo], [-H_oe, c I]],     c = m^2 + 2 * ndim

and A X = B reduces to the half-size Schur system on the even sites

    S_e x_e = b_e + H_eo b_o / c,   S_e = c I - H_eo H_oe / c
    x_o     = (b_o + H_oe x_e) / c.

S_e is SPD with roughly half A's condition number, so iteration counts drop
about 2x and every field is half-sized. The parity hops are const-hop block
operators on the half lattice (``problems/dirac_eo.py``), or per-site block
operators for matrix-valued links. Both operators hold the two hops as
submodules and take their codec from ``hop_oe``. They have no fused Gram:
an apply is two hop applies, and at k = 1 (the even-odd CG) those run the
const-hop (k, bs, ns) kernels.
"""

from __future__ import annotations

from torch import nn

from blockcg_tpu_torch.operators.base import DelegatedCodecMixin


class _ParityPair(DelegatedCodecMixin, nn.Module):
    """The two half-lattice hops and the codec they share."""

    codec_of = "hop_oe"

    def __init__(self, hop_eo, hop_oe):
        super().__init__()
        self.hop_eo = hop_eo
        self.hop_oe = hop_oe

    @property
    def bs(self) -> int:
        return self.hop_oe.bs

    @property
    def ns(self) -> int:
        return self.hop_oe.ns

    @property
    def n(self) -> int:
        return self.hop_oe.n

    @property
    def shape(self) -> tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        # One apply touches every entry of both hops plus the diagonal.
        return self.hop_eo.nnz + self.hop_oe.nnz + self.n

    @property
    def dtype(self):
        return self.hop_oe.dtype

    def _hop2(self, Xt):
        """H_eo H_oe X."""
        return self.hop_eo.matmat_t(self.hop_oe.matmat_t(Xt))


class SchurEvenOperator(_ParityPair):
    """S_e = c I - hop_eo @ hop_oe / c on even-parity half fields. hop_oe
    maps an even half field to odd rows, hop_eo odd to even."""

    def __init__(self, hop_eo, hop_oe, c: float):
        super().__init__(hop_eo, hop_oe)
        self.c = float(c)

    def matmat_t(self, Xt):
        return self.c * Xt - self._hop2(Xt) / self.c

    def extra_repr(self) -> str:
        return f"c={self.c}"


class EONormalOperator(_ParityPair):
    """``mu I - H_eo H_oe`` on even-parity half fields: the shift-invariant
    base operator of the multi-shift even-odd reduction. The shifted full
    systems (A + sigma) X = B reduce on the evens to ((c + sigma)^2 - K) x_e
    = (c + sigma) b_e + H_eo b_o with K = H_eo H_oe shared by every shift, so
    with mu = (c + sigma_min)^2 this SPD operator seeds one block Krylov
    space for all shifts (``problems.dirac_eo.solve_dirac_eo_shifted``)."""

    def __init__(self, hop_eo, hop_oe, mu: float):
        super().__init__(hop_eo, hop_oe)
        self.mu = float(mu)

    def matmat_t(self, Xt):
        return self.mu * Xt - self._hop2(Xt)

    def extra_repr(self) -> str:
        return f"mu={self.mu}"
