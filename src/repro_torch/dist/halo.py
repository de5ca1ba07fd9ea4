"""Halo mirror sync of the vertex-cut engine — the stacked halves.

Port of ``repro.dist.halo.HaloExchange.reduce_stacked`` /
``broadcast_stacked`` and their helpers.  On one device the k
partitions are a leading axis, and the all_to_all of the reference
(``send`` (k, k, H) → its transpose) becomes index arithmetic: lane
``[p, q, h]`` leaves p's mirror slot ``halo_send[p, q, h]`` and lands in
q's master slot ``halo_recv[q, p, h]``.  ``halo_routes`` turns the two
tables into flat indices over the (k, L_max + 1) value table once per
layout; each phase is then one gather and one scatter.

Every value table carries one pad column at ``L_max``: pad lanes read the
sum's identity 0 there and write there, and the column is sliced off —
the reference's ``mode="drop"`` sentinel.  Float sums scatter with
atomics on the card, so their order (and last bits) vary from run to run.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

EXCHANGE_NAMES = ("halo",)


def halo_routes(halo_send, halo_recv, l_max: int) -> dict:
    """Flat (k·(L_max+1)) indices of every halo lane: ``send_flat[p, q,
    h]`` is the lane's mirror slot on p, ``recv_flat_t[p, q, h]`` its
    master slot on q (the recv table transposed onto the sender's
    lanes)."""
    k = halo_send.shape[0]
    row = (torch.arange(k, device=halo_send.device) * (l_max + 1)
           ).view(k, 1, 1)
    send_flat = halo_send.long() + row
    recv_flat = halo_recv.long() + row
    return {"send_flat": send_flat.reshape(-1),
            "recv_flat_t": recv_flat.transpose(0, 1).reshape(-1)}


def _ext(values):
    """(k, L) → flat (k·(L+1)) with 0, the sum's identity, in the pad
    column."""
    pad = torch.zeros(values.shape[0], 1, dtype=values.dtype,
                      device=values.device)
    return torch.cat([values, pad], dim=1).reshape(-1)


@dataclass(frozen=True)
class HaloExchange:
    """Mirror-routed sync over the layout's halo tables (stacked form).
    ``dev`` must hold ``is_master`` and the ``halo_routes`` indices.
    Partials combine by sum, the combine of every ported program."""
    name = "halo"

    def reduce_stacked(self, partials, dev):
        """Mirror partials → their masters, added to the masters' own
        partials."""
        k, L = partials.shape
        lanes = _ext(partials)[dev["send_flat"]]
        agg = torch.zeros(k * (L + 1), dtype=partials.dtype,
                          device=partials.device)
        agg.index_add_(0, dev["recv_flat_t"], lanes)
        return partials + agg.view(k, L + 1)[:, :L]

    def broadcast_stacked(self, masters, dev):
        """Master values → their mirrors; master slots keep theirs."""
        k, L = masters.shape
        lanes = _ext(masters)[dev["recv_flat_t"]]
        scattered = torch.zeros(k * (L + 1), dtype=masters.dtype,
                                device=masters.device)
        scattered[dev["send_flat"]] = lanes
        scattered = scattered.view(k, L + 1)[:, :L]
        return torch.where(dev["is_master"], masters, scattered)


def get_exchange(name: str) -> HaloExchange:
    if name != "halo":
        raise ValueError(f"exchange {name!r} is not ported yet (ROADMAP, "
                         "Queue 1: dense, quantized and ragged exchanges); "
                         f"the port has {EXCHANGE_NAMES}")
    return HaloExchange()
