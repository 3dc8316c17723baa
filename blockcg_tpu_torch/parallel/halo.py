"""Ring halo exchange over ``torch.distributed``.

Counterpart of ``blockcg_tpu/parallel/halo.py``: the rows (sites) are split
into D contiguous shards, one per rank of a process group, and the boundary
columns of a lanes-major field go to the ring neighbours. The ring is
toroidal, which matches the operators' toroidal indexing: shard 0's left halo
comes from shard D-1, and operators without a global wrap have zero
coefficients there.

The exchange is one ``batch_isend_irecv`` of four point-to-point operations,
each direction with its own tag. At D = 2 both neighbours are one peer, and
the two messages to it are told apart by the tags and by their order. At
D = 1 the halos are the rank's own edge columns, as ``ppermute`` gives on a
single device (``torch.distributed`` refuses a send to one's own rank).

:func:`start_ring_halos` posts the exchange and returns at once, so the
caller can launch its interior apply, which does not read the halos, before
:meth:`HaloExchange.wait`: with NCCL the transfers run on NCCL's stream
while the interior kernel runs on the current one, and ``wait`` makes the
current stream wait for them before the corrections read the halos.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_TO_RIGHT, _TO_LEFT = 0, 1  # tags: the message's direction round the ring


class HaloExchange:
    """A posted ring exchange: :meth:`wait` returns ``(halo_l, halo_r)``."""

    def __init__(self, halo_l, halo_r, works=(), keep=()):
        self._halos = (halo_l, halo_r)
        self._works = works
        self._keep = keep  # the send buffers, alive until the sends are done

    def wait(self):
        for w in self._works:
            w.wait()
        self._works, self._keep = (), ()
        return self._halos


def start_ring_halos(X: torch.Tensor, bw: int, group) -> HaloExchange:
    """Post the exchange of the boundary columns of ``X`` (..., nl), site
    axis last, with this rank's ring neighbours in ``group`` (None: one
    shard): the left neighbour's last ``bw`` columns and the right
    neighbour's first ``bw``, each (..., bw). ``bw <= nl``."""
    if not 1 <= bw <= X.shape[-1]:
        raise ValueError(f"halo width {bw} for a shard of {X.shape[-1]} sites")
    last, first = X[..., -bw:].contiguous(), X[..., :bw].contiguous()
    D = 1 if group is None else dist.get_world_size(group)
    if D == 1:
        return HaloExchange(last, first)
    rank = dist.get_rank(group)
    gl, gr = (dist.get_global_rank(group, (rank + s) % D) for s in (-1, 1))
    halo_l, halo_r = torch.empty_like(last), torch.empty_like(first)
    ops = [dist.P2POp(dist.isend, last, gr, group, _TO_RIGHT),
           dist.P2POp(dist.irecv, halo_l, gl, group, _TO_RIGHT),
           dist.P2POp(dist.isend, first, gl, group, _TO_LEFT),
           dist.P2POp(dist.irecv, halo_r, gr, group, _TO_LEFT)]
    return HaloExchange(halo_l, halo_r, dist.batch_isend_irecv(ops), (last, first))


def ring_halos(X: torch.Tensor, bw: int, group):
    """``(halo_l, halo_r)``: the left neighbour's last ``bw`` columns of X
    and the right neighbour's first ``bw``, exchanged and waited for."""
    return start_ring_halos(X, bw, group).wait()
