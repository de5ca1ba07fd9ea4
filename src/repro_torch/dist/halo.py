"""Mirror sync of the vertex-cut engine — the stacked halves of the dense
and halo exchanges.

Port of ``repro.dist.halo``'s ``DenseExchange`` and ``HaloExchange``
(stacked and stacked-multi halves) and their helpers.  On one device the
k partitions are a leading axis, and the reference's collectives become
index arithmetic, worked out once per layout and device as flat routes
over the (k, N, width) value table of N fused programs:

- halo: lane ``[p, q, h]`` leaves p's mirror slot ``halo_send[p, q, h]``
  and lands in q's master slot ``halo_recv[q, p, h]`` (the all_to_all
  is the transpose of the two tables).  Value tables carry one pad column
  at ``L_max``: pad lanes read the combine's identity there and write
  there, and the column is sliced off — the reference's ``mode="drop"``
  bucket.
- dense: the all_gather'd (k·L_max) slab reduces through ``red_index``
  and broadcasts through ``(owner, own_slot)``.  An entry with
  ``red_index == L_max`` lands in the bucket the reference slices off, so
  the reduce route keeps only the live entries (one per replica).

Each phase is one gather and one scatter for all N programs.  Sums
scatter with ``index_add_``, minima with ``scatter_reduce_(…, "amin")``
into a table that starts from the combine's identity: 0 for a sum,
``iinfo(int32).max`` for an integer min, 3e38 for a float min.  Float
sums scatter with atomics on the card, so their order (and last bits)
vary from run to run; integer sums and minima are exact in any order.

Every exchange is exact, so the exchange ``state`` the reference threads
through its loops is always ``()`` here; the halves take and return it
so the drivers keep the reference's shape.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

EXCHANGE_NAMES = ("dense", "halo")
# the reference's other wire formats, and the ROADMAP item that ports them
NOT_PORTED = {"quantized": "the quantized and ragged exchanges",
              "ragged": "the quantized and ragged exchanges",
              "ragged_quantized": "the quantized and ragged exchanges"}


def _pad_value(combine: str, dtype):
    """The combine's identity: what pad lanes carry and every aggregate
    starts from."""
    if combine == "sum":
        return 0
    if not dtype.is_floating_point:
        return torch.iinfo(dtype).max
    return 3e38


def _segment_combine(vals, segments, num_segments: int, combine: str):
    """Combine ``vals`` into ``num_segments`` buckets by ``segments``
    (int64); empty buckets hold the combine's identity."""
    out = torch.full((num_segments,), _pad_value(combine, vals.dtype),
                     dtype=vals.dtype, device=vals.device)
    if combine == "sum":
        return out.index_add_(0, segments, vals)
    return out.scatter_reduce_(0, segments, vals, "amin", include_self=True)


def _merge(local, received, combine: str):
    if combine == "sum":
        return local + received
    return torch.minimum(local, received)


def lossy_payload(combine: str, dtype) -> bool:
    """Whether a program's payload tolerates lossy codes on a quantized
    wire: only float sums.  Min-combine and integer payloads ship exact."""
    return combine == "sum" and dtype.is_floating_point


def _ext_multi(values, combine: str):
    """(k, N, L) → (k, N, L+1) with the combine's identity in the pad
    column."""
    k, n, _ = values.shape
    pad = torch.full((k, n, 1), _pad_value(combine, values.dtype),
                     dtype=values.dtype, device=values.device)
    return torch.cat([values, pad], dim=2)


def _route(dev, name: str, n: int, width: int):
    """The ``name`` route's flat indices into a (k, n, width) table, one
    per lane and program, lane-major: lane i of program j sits at i·n + j
    (the gather and the scatter of a phase use the same order).  ``dev``
    holds each route once, as flat indices into the (k, width) table of
    one program; the n-program form is built once per n and cached."""
    flat = dev[name]
    if n == 1:
        return flat
    key = (name, n)
    cache = dev["routes"]
    if key not in cache:
        prog = torch.arange(n, device=flat.device)
        row, slot = (flat // width)[:, None], (flat % width)[:, None]
        cache[key] = ((row * n + prog) * width + slot).reshape(-1)
    return cache[key]


def _pack_multi(values, dev, route: str, combine: str):
    """values (k, N, L) → the lanes of ``route`` (one per lane and
    program); pad lanes read the identity in the pad column."""
    ext = _ext_multi(values, combine)
    return ext.reshape(-1)[_route(dev, route, values.shape[1],
                                  ext.shape[2])]


def _segment_combine_multi(lanes, dev, route: str, shape, combine: str):
    """Combine lanes into the slots of ``route`` over a (k, N, L+1) table
    → (k, N, L); slots no lane reaches hold the identity."""
    k, n, L = shape
    idx = _route(dev, route, n, L + 1)
    return _segment_combine(lanes, idx, k * n * (L + 1), combine) \
        .view(k, n, L + 1)[:, :, :L]


def _unpack_multi(new_master, lanes, dev, route: str):
    """Write received master values into the mirror slots of ``route``
    (each real lane reaches a distinct slot; pad lanes land in the pad
    column); master slots keep their own value, other slots read 0."""
    k, n, L = new_master.shape
    out = torch.zeros(k * n * (L + 1), dtype=new_master.dtype,
                      device=new_master.device)
    out[_route(dev, route, n, L + 1)] = lanes
    return torch.where(dev["is_master"][:, None, :], new_master,
                       out.view(k, n, L + 1)[:, :, :L])


def halo_routes(halo_send, halo_recv, l_max: int) -> dict:
    """Flat (k·(L_max+1)) indices of both ends of every halo lane:
    ``mirror[p, q, h]`` is the lane's mirror slot on p, ``master[p, q, h]``
    its master slot on q (the recv table transposed onto the sender's
    lanes).  Pad lanes point at the pad column on both ends."""
    k = halo_send.shape[0]
    row = (torch.arange(k, device=halo_send.device) * (l_max + 1)
           ).view(k, 1, 1)
    return {"mirror": (halo_send.long() + row).reshape(-1),
            "master": (halo_recv.long() + row).transpose(0, 1).reshape(-1)}


def dense_routes(red_index, owner, own_slot, l_max: int) -> dict:
    """The live ``red_index`` entries as lanes: ``gathered`` is each
    entry's flat (k·L_max) index in the all_gather'd slab, ``owned`` the
    flat (k·(L_max+1)) index of the owner's slot it lands in.
    ``owned_by[p, s]`` is the flat (k·L_max) index of slot (p, s)'s owner
    slot, which the broadcast reads."""
    d, j = torch.nonzero(red_index != l_max, as_tuple=True)
    return {"gathered": j, "owned": d * (l_max + 1) + red_index[d, j].long(),
            "owned_by": owner.long() * l_max + own_slot.long()}


class _Stacked:
    """The single-program halves as the N = 1 case of the multi ones."""

    def init_state(self, dev, dtype, combine: str = "sum"):
        return ()

    def init_state_multi(self, dev, dtype, combine: str, n: int):
        return ()

    def reduce_stacked(self, partials, dev, combine: str = "sum", state=()):
        total, state = self.reduce_stacked_multi(partials[:, None], dev,
                                                 combine, state)
        return total[:, 0], state

    def broadcast_stacked(self, masters, dev, combine: str = "sum",
                          state=()):
        value, state = self.broadcast_stacked_multi(masters[:, None], dev,
                                                    combine, state)
        return value[:, 0], state


@dataclass(frozen=True)
class HaloExchange(_Stacked):
    """Mirror-routed sync over the layout's halo tables (stacked form).
    Reduce: mirror partials travel to their masters and combine with the
    masters' own partials.  Broadcast: master values travel back to their
    mirrors; master slots keep theirs."""
    name = "halo"

    @staticmethod
    def routes(dev, l_max: int) -> dict:
        return halo_routes(dev["halo_send"], dev["halo_recv"], l_max)

    def reduce_stacked_multi(self, partials, dev, combine: str = "sum",
                             state=()):
        lanes = _pack_multi(partials, dev, "mirror", combine)
        agg = _segment_combine_multi(lanes, dev, "master", partials.shape,
                                     combine)
        return _merge(partials, agg, combine), state

    def broadcast_stacked_multi(self, masters, dev, combine: str = "sum",
                                state=()):
        lanes = _pack_multi(masters, dev, "master", combine)
        return _unpack_multi(masters, lanes, dev, "mirror"), state


@dataclass(frozen=True)
class DenseExchange(_Stacked):
    """All-gather sync over ``red_index`` and ``(owner, own_slot)``
    (stacked form).  Reduce: every replica's partial, the master's own
    included, combines into its owner's slot; other slots read the
    identity.  Broadcast: every slot reads its owner's value (pad slots
    read partition 0's slot 0, as in the reference)."""
    name = "dense"

    @staticmethod
    def routes(dev, l_max: int) -> dict:
        return dense_routes(dev["red_index"], dev["owner"], dev["own_slot"],
                            l_max)

    def reduce_stacked_multi(self, partials, dev, combine: str = "sum",
                             state=()):
        k, n, L = partials.shape
        lanes = partials.reshape(-1)[_route(dev, "gathered", n, L)]
        return _segment_combine_multi(lanes, dev, "owned", partials.shape,
                                      combine), state

    def broadcast_stacked_multi(self, masters, dev, combine: str = "sum",
                                state=()):
        # one read per (slot, program), laid out (k, N, L) like masters
        k, n, L = masters.shape
        key = ("owned_by", n)
        if n == 1:
            return masters.reshape(-1)[dev["owned_by"]].view(k, 1, L), state
        if key not in dev["routes"]:
            flat = dev["owned_by"].view(k, 1, L)
            prog = torch.arange(n, device=flat.device).view(1, n, 1)
            dev["routes"][key] = (flat // L * n + prog) * L + flat % L
        return masters.reshape(-1)[dev["routes"][key]], state


EXCHANGES = {"dense": DenseExchange, "halo": HaloExchange}


def get_exchange(name: str):
    """Exchange registry: ``name`` ∈ ``EXCHANGE_NAMES``."""
    if name in NOT_PORTED:
        raise ValueError(f"exchange {name!r} is not ported yet (ROADMAP, "
                         f"Queue 1: {NOT_PORTED[name]}); the port has "
                         f"{EXCHANGE_NAMES}")
    if name not in EXCHANGES:
        raise ValueError(f"unknown exchange {name!r}; expected one of "
                         f"{EXCHANGE_NAMES}")
    return EXCHANGES[name]()
