"""Mirror sync of the vertex-cut engine — the stacked and the per-rank
halves of the five wire formats.

Port of ``repro.dist.halo``: ``DenseExchange``, ``HaloExchange``,
``QuantizedHaloExchange``, ``RaggedHaloExchange`` and
``RaggedQuantizedHaloExchange`` (stacked and stacked-multi halves), their
encoders and the registry.  On one device the k partitions are a leading
axis, and the reference's collectives become index arithmetic, worked out
once per layout and device as flat routes over the (k, N, width) value
table of N fused programs:

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
- quantized: the halo lanes, delta-coded against references both ends
  advance in lockstep, with error feedback (int8 codes and one f32 scale
  per lane row; the fused form int4 codes packed two to a byte and eight
  fp16 scales per (pair, program) row).
- ragged: the k−1 ring hops of the layout's ``halo_schedule()``, hop s
  carrying every (p → (p+s) mod k) pair's lanes padded to H_s.  Pad lanes
  only reach the dropped column, so one flat route of the real lanes
  alone, hop by hop, is exact: one gather and one scatter a phase.
- ragged_quantized: each hop ships only the T_s = ⌈top_delta·H_s⌉
  largest-|Δ| lanes (int16 index, int8 code, one f32 scale a row); the
  rows keep their H_s width, and one sort ranks every hop's rows at once.

Each phase of the exact formats is one gather and one scatter for all N
programs.  Sums scatter with ``index_add_``, minima with
``scatter_reduce_(…, "amin")`` into a table that starts from the
combine's identity: 0 for a sum, ``iinfo(int32).max`` for an integer
min, 3e38 for a float min.  Float sums scatter with atomics on the card,
so their order (and last bits) vary from run to run; integer sums and
minima are exact in any order.

**Lane state.**  The exact formats thread ``state = ()``; the lossy ones
thread their references and residuals, made by ``init_state`` per run.
A lane array here is indexed by the pair (mirror partition p, owner
partition q) whichever end holds it, so the wire is the identity; the
reference indexes each array by the partition holding it.  So the
quantized state is the reference's with the reduce's ``rref`` and the
broadcast's ``sref``/``sres`` transposed; the ragged-quantized state
holds, per hop s and row p (the pair (p, p+s)), the reference's with
those arrays rolled by −s, laid hop-major in one flat vector.  The
receiver still decodes from the wire: the codes, scales and indices the
sender made.

**Per-rank halves.**  With one partition a rank (``get_exchange(...,
axis=mesh)``), each rank holds its own row of the tables and values, and
the wires are real collectives (``dist.collectives``): dense an
all-gather of the (N, L_max) slab, halo and quantized an ``all_to_all``
of (k, N, H_max) lanes (codes and scales on the quantized wire), the
ragged two a ``ring_hop`` a populated distance.  Received lanes combine
in rank order (hop order on the ring), as the stacked routes order them,
so on the CPU a rank's result equals its row of the stacked result bit
for bit, f32 sums included.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from . import collectives as coll
from .compress import _QMAX, _div, dequantize_rows, quantize_rows


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
    return _hop_accumulate(out, segments, vals, combine)


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


def _program_rows(flat, n: int, width: int):
    """Flat indices into a (k, width) table, shaped (..., H) → the same
    lanes in a (k, n, width) table shaped (..., n, H): one lane row per
    program, as the lossy encoders quantize them."""
    prog = torch.arange(n, device=flat.device).view(n, 1)
    row, slot = (flat // width).unsqueeze(-2), (flat % width).unsqueeze(-2)
    return (row * n + prog) * width + slot


def _pair_route(dev, name: str, n: int, width: int):
    """A halo route as (k, k, n, H_max) indices into a (k, n, width)
    table, cached per n."""
    k, _, h = dev["halo_send"].shape
    if n == 1:
        return dev[name].view(k, k, 1, h)
    key = ("pairs", name, n)
    cache = dev["routes"]
    if key not in cache:
        cache[key] = _program_rows(dev[name].view(k, k, h), n, width)
    return cache[key]


def _pack_multi(values, idx, combine: str):
    """values (k, N, L) → the lanes at ``idx`` (flat indices into the
    (k, N, L+1) table); pad lanes read the identity in the pad column."""
    return _ext_multi(values, combine).reshape(-1)[idx]


def _segment_combine_multi(lanes, idx, shape, combine: str):
    """Combine lanes into the slots ``idx`` names in a (k, N, L+1) table
    → (k, N, L); slots no lane reaches hold the identity."""
    k, n, L = shape
    return _segment_combine(lanes.reshape(-1), idx.reshape(-1),
                            k * n * (L + 1), combine) \
        .view(k, n, L + 1)[:, :, :L]


def _unpack_multi(new_master, lanes, idx, dev):
    """Write received master values into the mirror slots ``idx`` names
    (each real lane reaches a distinct slot; pad lanes land in the pad
    column); master slots keep their own value, other slots read 0."""
    k, n, L = new_master.shape
    out = torch.zeros(k * n * (L + 1), dtype=new_master.dtype,
                      device=new_master.device)
    out[idx.reshape(-1)] = lanes.reshape(-1).to(new_master.dtype)
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


def _hop_rows(table, s: int, h: int):
    """Rows (p, (p+s) mod k, :h) of a (k, k, H_max) pair table: hop s's
    (k, h) lanes, row p the pair (p, p+s)."""
    k = table.shape[0]
    ar = torch.arange(k, device=table.device)
    return table[ar, (ar + s) % k, :h]


def ring_routes(dev, l_max: int, hops) -> dict:
    """The ragged ring's real lanes as one flat route a phase, hop by hop
    (hop s, then sender p, then lane): ``ring_mirror`` and
    ``ring_master`` as ``halo_routes``' two ends.  A master slot receives
    at most one lane a hop, so its contributions come in hop order, as in
    the reference's deferred reduce over the concatenated hops."""
    k, _, H = dev["halo_send"].shape
    halo = halo_routes(dev["halo_send"], dev["halo_recv"], l_max)
    real = dev["halo_send"] != l_max
    ends = {}
    for end in ("mirror", "master"):
        table = halo[end].view(k, k, H)
        ends[f"ring_{end}"] = torch.cat(
            [_hop_rows(table, s, h)[_hop_rows(real, s, h)] for s, h in hops]
            or [table.new_zeros(0)])
    return ends


# ------------------------------------------------- lossy payload encoders

_Q4MAX = 7.0
# each (pair, program) lane row splits into this many scale subgroups:
# finer groups isolate hot lanes, so the coarse int4 grid stays a
# contraction under error feedback (one scale per row diverges); rows are
# zero-padded to a multiple of 8, so the nibble pack sees an even count
_NUM_SCALE_GROUPS = 8


def _quantize_groups(err):
    """int4 codes + one fp16 scale per eighth of the trailing lane row;
    a row whose width is not a multiple of 8 is zero-padded up to one
    first (pad lanes take code 0; decoders slice them off)."""
    n = err.shape[-1]
    n8 = -(-n // _NUM_SCALE_GROUPS) * _NUM_SCALE_GROUPS
    if n8 != n:
        err = F.pad(err, (0, n8 - n))
    shp = err.shape
    grp = err.reshape(*shp[:-1], _NUM_SCALE_GROUPS, n8 // _NUM_SCALE_GROUPS)
    amax = torch.amax(torch.abs(grp), dim=-1)
    scales = torch.where(amax > 0, _div(amax, _Q4MAX), 1.0) \
        .to(torch.float16)
    s = torch.clamp(scales.to(torch.float32), min=1e-30)[..., None]
    codes = torch.clamp(torch.round(grp / s), -_Q4MAX, _Q4MAX) \
        .to(torch.int8)
    return codes.reshape(shp), scales


def _dequantize_groups(codes, scales):
    """Inverse grid step, with the fp16 scales both ends hold."""
    shp = codes.shape
    grp = codes.reshape(*shp[:-1], _NUM_SCALE_GROUPS,
                        shp[-1] // _NUM_SCALE_GROUPS)
    return (grp.to(torch.float32)
            * scales.to(torch.float32)[..., None]).reshape(shp)


def _nibble_pack(codes):
    """int8 codes in [−7, 7], even trailing dim → two codes a byte (the
    high nibble's shift wraps in int8, as the reference's does)."""
    lo = codes[..., 0::2] & 0xF
    hi = codes[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.int8)


def _nibble_unpack(packed):
    """Inverse of ``_nibble_pack``: int8 shifts are arithmetic, so both
    nibbles sign-extend."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                                 2 * packed.shape[-1])


def _ef_encode(lanes, sref, sres):
    """Error-feedback delta encoder: err = (lanes − sref) + sres quantizes
    per lane row; both ends advance their reference by the dequantized
    step and the rest becomes the next residual."""
    err = lanes - sref + sres
    codes, scales = quantize_rows(err)
    deq = dequantize_rows(codes, scales)
    return sref + deq, err - deq, codes, scales


def _ef_encode_fused(lanes, sref, sres):
    """``_ef_encode`` for the fused wire: int4 codes nibble-packed along
    the lane axis, fp16 scales over 8 subgroups a (pair, program) row."""
    err = lanes - sref + sres
    codes, scales = _quantize_groups(err)
    deq = _dequantize_groups(codes, scales)[..., :err.shape[-1]]
    return sref + deq, err - deq, _nibble_pack(codes), scales


def _ef_decode_fused(packed, scales, n: int):
    """Unpack and dequantize a fused payload back to ``n`` lanes."""
    return _dequantize_groups(_nibble_unpack(packed), scales)[..., :n]


def _scatter_last(idx, vals, n: int):
    """(..., n) zeros with ``vals`` placed at ``idx`` along the last axis
    (indices within a row are distinct)."""
    out = torch.zeros(*idx.shape[:-1], n, dtype=vals.dtype,
                      device=vals.device)
    return out.scatter_(-1, idx.long(), vals)


def _acc_init(shape, dtype, combine: str, device=None):
    """Hopwise reduce accumulator: the fill the reference's segment sum
    and min start from (0, ``iinfo.max``, +inf), so folding the hops one
    by one gives the deferred reduce bit for bit."""
    if combine == "sum":
        return torch.zeros(shape, dtype=dtype, device=device)
    fill = (torch.iinfo(dtype).max if not dtype.is_floating_point
            else float("inf"))
    return torch.full(shape, fill, dtype=dtype, device=device)


def _hop_accumulate(acc, slots, recv, combine: str):
    """Fold received lanes into the flat master accumulator ``acc``."""
    if combine == "sum":
        return acc.index_add_(0, slots, recv)
    return acc.scatter_reduce_(0, slots, recv, "amin", include_self=True)


DEFAULT_TOP_DELTA = 0.25



# -------------------------------------------------- per-rank wire helpers
# One rank of a mesh holds its partition's row of each table: values
# (N, L_max), halo tables (k, H_max) (``halo_send[q]``: my mirror slots
# whose values go to owner q; ``halo_recv[p]``: my master slots where
# lanes from p land).  Received lanes are combined in rank order, hop
# order on the ring, so a rank's result equals the stacked half's row
# bit for bit wherever the arithmetic runs in one order (the CPU).

def _ext_rank(values, combine: str):
    """(N, L) → (N, L+1) with the combine's identity in the pad column."""
    pad = torch.full((values.shape[0], 1), _pad_value(combine, values.dtype),
                     dtype=values.dtype, device=values.device)
    return torch.cat([values, pad], dim=1)


def _lanes_rank(values, table, combine: str):
    """values (N, L) → the lanes at ``table`` (k, H) as (k, N, H)."""
    return _ext_rank(values, combine)[:, table.long()].permute(1, 0, 2) \
        .contiguous()


def _slot_index(slots, n: int, width: int):
    """Slots (…, H) of one program → flat indices into an (n, width)
    table laid out like received lanes (…, n, H)."""
    prog = torch.arange(n, device=slots.device).view(n, 1) * width
    return slots.long().unsqueeze(-2) + prog


def _combine_rank(recv, slots, L: int, combine: str, fill=None):
    """Received lanes (…, N, H) into the master slots ``slots`` (…, H)
    → (N, L), in the lanes' order; slots no lane reaches hold the
    identity (``fill``: a hopwise accumulator's start)."""
    n = recv.shape[-2]
    idx = _slot_index(slots, n, L + 1).reshape(-1)
    if fill is None:
        out = _segment_combine(recv.reshape(-1), idx, n * (L + 1), combine)
    else:
        out = _hop_accumulate(fill, idx, recv.reshape(-1), combine)
    return out.view(n, L + 1)[:, :L]


def _unpack_rank(new_master, recv, slots, dev):
    """Received master values (…, N, H) into this rank's mirror slots
    ``slots`` (…, H) (distinct for real lanes; pads hit the pad column);
    master slots keep their value, others read 0."""
    n, L = new_master.shape
    out = torch.zeros(n * (L + 1), dtype=new_master.dtype,
                      device=new_master.device)
    out[_slot_index(slots, n, L + 1).reshape(-1)] = \
        recv.reshape(-1).to(new_master.dtype)
    return torch.where(dev["is_master"].reshape(1, L), new_master,
                       out.view(n, L + 1)[:, :L])


class _PerRank:
    """The single-program per-rank halves as the N = 1 case of the multi
    ones (an exchange with an ``axis``: a bound ``dist.mesh.Mesh``)."""

    def init_state_rank(self, dev, dtype, combine: str = "sum"):
        return self.init_state_rank_multi(dev, dtype, combine, 1)

    def init_state_rank_multi(self, dev, dtype, combine: str, n: int):
        return ()

    def reduce_to_masters(self, partial, dev, combine: str = "sum",
                          state=(), **kw):
        total, state = self.reduce_to_masters_multi(partial[None], dev,
                                                    combine, state, **kw)
        return total[0], state

    def broadcast_from_masters(self, new_master, dev, combine: str = "sum",
                               state=()):
        value, state = self.broadcast_from_masters_multi(
            new_master[None], dev, combine, state)
        return value[0], state

    def rank_routes(self, dev, l_max: int) -> dict:
        return {}


# --------------------------------------------------------------- exchanges

class _Stacked:
    """The single-program halves as the N = 1 case of the multi ones."""

    def init_state(self, dev, dtype, combine: str = "sum"):
        return self.init_state_multi(dev, dtype, combine, 1)

    def init_state_multi(self, dev, dtype, combine: str, n: int):
        return ()

    def reduce_stacked(self, partials, dev, combine: str = "sum", state=(),
                       **kw):
        total, state = self.reduce_stacked_multi(partials[:, None], dev,
                                                 combine, state, **kw)
        return total[:, 0], state

    def broadcast_stacked(self, masters, dev, combine: str = "sum",
                          state=()):
        value, state = self.broadcast_stacked_multi(masters[:, None], dev,
                                                    combine, state)
        return value[:, 0], state


@dataclass(frozen=True)
class HaloExchange(_Stacked, _PerRank):
    """Mirror-routed sync over the layout's halo tables.  Reduce: mirror
    partials travel to their masters and combine with the masters' own
    partials.  Broadcast: master values travel back to their mirrors;
    master slots keep theirs.  Per rank each phase is one ``all_to_all``
    of (k, N, H_max) lanes."""
    axis: Any = None
    name = "halo"

    @staticmethod
    def routes(dev, l_max: int) -> dict:
        return halo_routes(dev["halo_send"], dev["halo_recv"], l_max)

    def reduce_stacked_multi(self, partials, dev, combine: str = "sum",
                             state=()):
        n, width = partials.shape[1], partials.shape[2] + 1
        lanes = _pack_multi(partials, _route(dev, "mirror", n, width),
                            combine)
        agg = _segment_combine_multi(lanes, _route(dev, "master", n, width),
                                     partials.shape, combine)
        return _merge(partials, agg, combine), state

    def broadcast_stacked_multi(self, masters, dev, combine: str = "sum",
                                state=()):
        n, width = masters.shape[1], masters.shape[2] + 1
        lanes = _pack_multi(masters, _route(dev, "master", n, width),
                            combine)
        return _unpack_multi(masters, lanes, _route(dev, "mirror", n, width),
                             dev), state

    def reduce_to_masters_multi(self, partials, dev, combine: str = "sum",
                                state=()):
        send = _lanes_rank(partials, dev["halo_send"], combine)
        recv = coll.all_to_all(send, self.axis, site="halo.reduce")
        agg = _combine_rank(recv, dev["halo_recv"], partials.shape[1],
                            combine)
        return _merge(partials, agg, combine), state

    def broadcast_from_masters_multi(self, new_masters, dev,
                                     combine: str = "sum", state=()):
        send = _lanes_rank(new_masters, dev["halo_recv"], combine)
        recv = coll.all_to_all(send, self.axis, site="halo.broadcast")
        return _unpack_rank(new_masters, recv, dev["halo_send"], dev), state

    def bytes_per_iter(self, layout, value_bytes: int = 4) -> int:
        return layout.comm_bytes("halo", value_bytes=value_bytes)


@dataclass(frozen=True)
class DenseExchange(_Stacked, _PerRank):
    """All-gather sync over ``red_index`` and ``(owner, own_slot)``
    (stacked form).  Reduce: every replica's partial, the master's own
    included, combines into its owner's slot; other slots read the
    identity.  Broadcast: every slot reads its owner's value (pad slots
    read partition 0's slot 0, as in the reference).  Per rank each phase
    is one all-gather of the (N, L_max) slab."""
    axis: Any = None
    name = "dense"

    @staticmethod
    def routes(dev, l_max: int) -> dict:
        return dense_routes(dev["red_index"], dev["owner"], dev["own_slot"],
                            l_max)

    def reduce_stacked_multi(self, partials, dev, combine: str = "sum",
                             state=()):
        k, n, L = partials.shape
        lanes = partials.reshape(-1)[_route(dev, "gathered", n, L)]
        return _segment_combine_multi(lanes, _route(dev, "owned", n, L + 1),
                                      partials.shape, combine), state

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

    def rank_routes(self, dev, l_max: int) -> dict:
        """One rank's ``red_index`` row as lanes: ``dense_gathered`` the
        live entries' flat (k·L_max) indices in the gathered slab (in
        order), ``dense_owned`` the slot each lands in; ``dense_owned_by``
        every slot's owner slot in the slab."""
        red = dev["red_index"].reshape(-1)
        j = torch.nonzero(red != l_max).reshape(-1)
        return {"dense_gathered": j, "dense_owned": red[j].long(),
                "dense_owned_by": (dev["owner"].long() * l_max
                                   + dev["own_slot"].long()).reshape(-1)}

    def _gather(self, values, site):
        g = coll.all_gather(values, self.axis, site=site)   # (k, N, L)
        return g.permute(1, 0, 2).reshape(values.shape[0], -1)

    def reduce_to_masters_multi(self, partials, dev, combine: str = "sum",
                                state=()):
        flat = self._gather(partials, "dense.reduce")
        lanes = flat[:, dev["dense_gathered"]]
        return _combine_rank(lanes, dev["dense_owned"], partials.shape[1],
                             combine), state

    def broadcast_from_masters_multi(self, new_masters, dev,
                                     combine: str = "sum", state=()):
        flat = self._gather(new_masters, "dense.broadcast")
        return flat[:, dev["dense_owned_by"]], state

    def bytes_per_iter(self, layout, value_bytes: int = 4) -> int:
        return layout.comm_bytes("dense", value_bytes=value_bytes)


def _lane_state(shape, device) -> dict:
    zeros = torch.zeros(shape, dtype=torch.float32, device=device)
    lane_state = {"sref": zeros, "sres": zeros, "rref": zeros}
    return {"reduce": lane_state, "bcast": dict(lane_state)}


@dataclass(frozen=True)
class QuantizedHaloExchange(_PerRank):
    """Halo routing with a delta-coded payload and error feedback: per
    phase (k, k, H_max) int8 codes and one f32 scale a (pair) lane row; the
    fused form int4 codes two to a byte and 8 fp16 scales a (pair,
    program) row.  The sender's reference ``sref`` and the receiver's
    ``rref`` advance by the same dequantized step, and ``sres`` carries
    the quantization error, so a converging fixed point (pagerank) lands
    on the exact one.  Min-combine and integer payloads are exact already
    and ride the plain halo wire (``init_state`` returns ``()``).  Per
    rank the state holds the lanes this rank sends (``sref``, ``sres``,
    (k, [N,] H) by destination) and receives (``rref``, by source): the
    stacked state's row and column of the rank."""
    axis: Any = None
    name = "quantized"
    _exact = HaloExchange()

    @staticmethod
    def routes(dev, l_max: int) -> dict:
        return HaloExchange.routes(dev, l_max)

    def init_state(self, dev, dtype, combine: str = "sum"):
        if not lossy_payload(combine, dtype):
            return ()
        return _lane_state(dev["halo_send"].shape, dev["halo_send"].device)

    def init_state_multi(self, dev, dtype, combine: str, n: int):
        if not lossy_payload(combine, dtype):
            return ()
        k, _, h = dev["halo_send"].shape
        return _lane_state((k, k, n, h), dev["halo_send"].device)

    def _phase(self, values, dev, combine, st, send: str, fused: bool):
        """One lossy phase: the lanes at ``send``, encoded, the wire
        decoded onto the receiver's reference.  Returns (rref, the
        phase's new state)."""
        n = values.shape[1]
        idx = _pair_route(dev, send, n, values.shape[2] + 1)
        lanes = _pack_multi(values, idx, combine)
        if fused:
            sref, sres, packed, scales = _ef_encode_fused(lanes, st["sref"],
                                                          st["sres"])
            rref = st["rref"] + _ef_decode_fused(packed, scales,
                                                 lanes.shape[-1])
        else:
            lanes = lanes[:, :, 0]
            sref, sres, codes, scales = _ef_encode(lanes, st["sref"],
                                                   st["sres"])
            rref = st["rref"] + dequantize_rows(codes, scales)
        return rref, {"sref": sref, "sres": sres, "rref": rref}

    def _reduce(self, partials, dev, combine, state, fused):
        rref, st = self._phase(partials, dev, combine, state["reduce"],
                               "mirror", fused)
        idx = _pair_route(dev, "master", partials.shape[1],
                          partials.shape[2] + 1)
        agg = _segment_combine_multi(rref, idx, partials.shape, combine)
        return _merge(partials, agg, combine), {**state, "reduce": st}

    def _broadcast(self, masters, dev, combine, state, fused):
        rref, st = self._phase(masters, dev, combine, state["bcast"],
                               "master", fused)
        idx = _pair_route(dev, "mirror", masters.shape[1],
                          masters.shape[2] + 1)
        return _unpack_multi(masters, rref, idx, dev), {**state, "bcast": st}

    def reduce_stacked(self, partials, dev, combine: str = "sum", state=()):
        if not state:
            return self._exact.reduce_stacked(partials, dev, combine, state)
        total, state = self._reduce(partials[:, None], dev, combine, state,
                                    False)
        return total[:, 0], state

    def broadcast_stacked(self, masters, dev, combine: str = "sum",
                          state=()):
        if not state:
            return self._exact.broadcast_stacked(masters, dev, combine,
                                                 state)
        values, state = self._broadcast(masters[:, None], dev, combine,
                                        state, False)
        return values[:, 0], state

    def reduce_stacked_multi(self, partials, dev, combine: str = "sum",
                             state=()):
        if not state:
            return self._exact.reduce_stacked_multi(partials, dev, combine,
                                                    state)
        return self._reduce(partials, dev, combine, state, True)

    def broadcast_stacked_multi(self, masters, dev, combine: str = "sum",
                                state=()):
        if not state:
            return self._exact.broadcast_stacked_multi(masters, dev,
                                                       combine, state)
        return self._broadcast(masters, dev, combine, state, True)

    # -- per-rank halves: the codes and scales ride two all_to_alls --
    @property
    def _exact_rank(self) -> HaloExchange:
        return HaloExchange(axis=self.axis)

    def init_state_rank(self, dev, dtype, combine: str = "sum"):
        if not lossy_payload(combine, dtype):
            return ()
        return _lane_state(dev["halo_send"].shape, dev["halo_send"].device)

    def init_state_rank_multi(self, dev, dtype, combine: str, n: int):
        if not lossy_payload(combine, dtype):
            return ()
        k, h = dev["halo_send"].shape
        return _lane_state((k, n, h), dev["halo_send"].device)

    def _rank_phase(self, values, table, st, site, fused: bool):
        """One lossy phase of a rank: (the received lanes (k, N, H) on the
        receiver's reference, the new state)."""
        lanes = _lanes_rank(values, table, "sum")
        if fused:
            sref, sres, codes, scales = _ef_encode_fused(lanes, st["sref"],
                                                         st["sres"])
        else:
            sref, sres, codes, scales = _ef_encode(lanes[:, 0], st["sref"],
                                                   st["sres"])
        rcodes = coll.all_to_all(codes, self.axis, site=site)
        rscales = coll.all_to_all(scales, self.axis, site=site)
        if fused:
            rref = st["rref"] + _ef_decode_fused(rcodes, rscales,
                                                 lanes.shape[-1])
            lanes_in = rref
        else:
            rref = st["rref"] + dequantize_rows(rcodes, rscales)
            lanes_in = rref[:, None]
        return lanes_in, {"sref": sref, "sres": sres, "rref": rref}

    def _rank_reduce(self, partials, dev, combine, state, fused):
        rref, st = self._rank_phase(partials, dev["halo_send"],
                                    state["reduce"], "quantized.reduce",
                                    fused)
        agg = _combine_rank(rref, dev["halo_recv"], partials.shape[1],
                            combine)
        return _merge(partials, agg, combine), {**state, "reduce": st}

    def _rank_broadcast(self, masters, dev, combine, state, fused):
        rref, st = self._rank_phase(masters, dev["halo_recv"],
                                    state["bcast"], "quantized.broadcast",
                                    fused)
        return _unpack_rank(masters, rref, dev["halo_send"], dev), \
            {**state, "bcast": st}

    def reduce_to_masters(self, partial, dev, combine: str = "sum",
                          state=()):
        if not state:
            return self._exact_rank.reduce_to_masters(partial, dev, combine)
        total, state = self._rank_reduce(partial[None], dev, combine, state,
                                         False)
        return total[0], state

    def broadcast_from_masters(self, new_master, dev, combine: str = "sum",
                               state=()):
        if not state:
            return self._exact_rank.broadcast_from_masters(new_master, dev,
                                                           combine)
        value, state = self._rank_broadcast(new_master[None], dev, combine,
                                            state, False)
        return value[0], state

    def reduce_to_masters_multi(self, partials, dev, combine: str = "sum",
                                state=()):
        if not state:
            return self._exact_rank.reduce_to_masters_multi(partials, dev,
                                                            combine)
        return self._rank_reduce(partials, dev, combine, state, True)

    def broadcast_from_masters_multi(self, new_masters, dev,
                                     combine: str = "sum", state=()):
        if not state:
            return self._exact_rank.broadcast_from_masters_multi(
                new_masters, dev, combine)
        return self._rank_broadcast(new_masters, dev, combine, state, True)

    def bytes_per_iter(self, layout, value_bytes: int = 4,
                       combine: str = "sum", dtype=torch.float32) -> int:
        return layout.comm_bytes("quantized",
                                 lossy=lossy_payload(combine, dtype),
                                 value_bytes=value_bytes)


def _hops(schedule):
    """(distance, H_s) of the populated ring distances."""
    return [(s, h) for s, h in enumerate(schedule, 1) if h > 0]


@dataclass(frozen=True)
class RaggedHaloExchange(_Stacked, _PerRank):
    """Mirror-routed sync over the k−1 ring hops of ``schedule`` (the
    layout's ``halo_schedule()``).  On one device every hop lands at
    once, so the real lanes of all hops form one route a phase
    (``ring_routes``).  ``hopwise=True`` on the reduce folds them into an
    accumulator that starts from the reference's hop fill, in hop order
    per slot as the hop loop does — the reduce the overlapped GAS body
    (``engine._gas_body(overlap=True)``) runs; it equals the deferred
    reduce bit for bit.  Per rank hop s is one ``ring_hop`` of (N, H_s)
    lanes to rank r + s (reduce) or r − s (broadcast)."""
    schedule: tuple = ()
    axis: Any = None
    name = "ragged"

    @property
    def k(self) -> int:
        return len(self.schedule) + 1

    def routes(self, dev, l_max: int) -> dict:
        return ring_routes(dev, l_max, _hops(self.schedule))

    def reduce_stacked_multi(self, partials, dev, combine: str = "sum",
                             state=(), *, hopwise: bool = False):
        k, n, L = partials.shape
        lanes = _pack_multi(partials, _route(dev, "ring_mirror", n, L + 1),
                            combine)
        idx = _route(dev, "ring_master", n, L + 1)
        if not hopwise:
            agg = _segment_combine_multi(lanes, idx, partials.shape, combine)
        else:
            acc = _acc_init((k * n * (L + 1),), partials.dtype, combine,
                            partials.device)
            agg = _hop_accumulate(acc, idx, lanes, combine) \
                .view(k, n, L + 1)[:, :, :L]
        return _merge(partials, agg, combine), state

    def broadcast_stacked_multi(self, masters, dev, combine: str = "sum",
                                state=()):
        n, width = masters.shape[1], masters.shape[2] + 1
        lanes = _pack_multi(masters, _route(dev, "ring_master", n, width),
                            combine)
        return _unpack_multi(masters, lanes,
                             _route(dev, "ring_mirror", n, width),
                             dev), state

    def _rank_rows(self, dev, s: int, h: int):
        """Hop s's rows of this rank: the mirror slots it sends to r + s
        and the master slots that r − s's lanes land in."""
        k, me = self.k, self.axis.rank
        return (dev["halo_send"][(me + s) % k, :h],
                dev["halo_recv"][(me - s) % k, :h])

    def reduce_to_masters_multi(self, partials, dev, combine: str = "sum",
                                state=(), *, hopwise: bool = False):
        n, L = partials.shape
        ext = _ext_rank(partials, combine)
        recvs, slots = [], []
        for s, h in _hops(self.schedule):
            send_rows, recv_rows = self._rank_rows(dev, s, h)
            recvs.append(coll.ring_hop(ext[:, send_rows.long()], self.axis,
                                       s, site="ragged.reduce"))
            slots.append(recv_rows)
        if not recvs:
            return partials, state
        fill = _acc_init((n * (L + 1),), partials.dtype, combine,
                         partials.device) if hopwise else None
        agg = _combine_rank(torch.cat(recvs, dim=1), torch.cat(slots), L,
                            combine, fill)
        return _merge(partials, agg, combine), state

    def broadcast_from_masters_multi(self, new_masters, dev,
                                     combine: str = "sum", state=()):
        ext = _ext_rank(new_masters, combine)
        recvs, slots = [], []
        for s, h in _hops(self.schedule):
            send_rows, recv_rows = self._rank_rows(dev, s, h)
            # the reverse route of reduce hop s: owner r ships to r − s
            recvs.append(coll.ring_hop(ext[:, recv_rows.long()], self.axis,
                                       -s, site="ragged.broadcast"))
            slots.append(send_rows)
        if not recvs:
            return new_masters, state
        return _unpack_rank(new_masters, torch.cat(recvs, dim=1),
                            torch.cat(slots), dev), state

    def bytes_per_iter(self, layout, value_bytes: int = 4) -> int:
        return layout.comm_bytes("ragged", value_bytes=value_bytes)


@dataclass(frozen=True)
class RaggedQuantizedHaloExchange(_Stacked, _PerRank):
    """Ragged ring routing with a top-Δ error-feedback payload: per hop
    only the T_s = ⌈top_delta·H_s⌉ largest-|Δ| lanes of each row ship, as
    int16 lane indices, int8 codes and one f32 scale.  References advance
    in lockstep (``sref``, ``rref``) with no carried residual: the
    outstanding delta (lanes − sref) already holds every unsent lane, and
    a carry would count it twice each round and diverge.  Min and integer
    payloads ride the exact ragged wire.

    Every hop is encoded at once.  A phase's lanes lie hop-major in one
    flat vector (hop s, then row p — the pair (p, p+s) — then program,
    then lane; ``_segments``), so one row of one hop is a contiguous
    segment, and a master slot meets its lanes in hop order, as in the
    reference's hop loop.  One stable sort by (segment, −|Δ|) ranks every
    row at once — ties to the lower lane, as ``jax.lax.top_k`` sends them
    — and each segment's first T_s entries are its wire.  The state holds
    ``sref`` and ``rref`` as such flat f32 vectors.

    Per rank each hop encodes its (N, H_s) rows on their own (the same
    stable ranking, row by row) and ships indices, codes and scales with
    three ``ring_hop`` calls; the state holds, per hop, the (N, H_s)
    ``sref`` of the lanes this rank sends and ``rref`` of those it
    receives."""
    schedule: tuple = ()
    top_delta: float = DEFAULT_TOP_DELTA
    axis: Any = None
    name = "ragged_quantized"

    @property
    def k(self) -> int:
        return len(self.schedule) + 1

    @property
    def _exact(self) -> RaggedHaloExchange:
        return RaggedHaloExchange(schedule=self.schedule)

    def _top(self, h: int) -> int:
        return min(h, max(1, math.ceil(self.top_delta * h)))

    def routes(self, dev, l_max: int) -> dict:
        """The exact ring's routes (for min and integer payloads) and both
        halo ends of every hop's (k, H_s) rows, pad lanes kept, hop-major
        (``rq_mirror``, ``rq_master``)."""
        k, _, H = dev["halo_send"].shape
        halo = halo_routes(dev["halo_send"], dev["halo_recv"], l_max)
        hops = _hops(self.schedule)
        ends = {f"rq_{end}": torch.cat(
            [_hop_rows(halo[end].view(k, k, H), s, h).reshape(-1)
             for s, h in hops] or [halo[end].new_zeros(0)])
            for end in ("mirror", "master")}
        return {**self._exact.routes(dev, l_max), **ends}

    def _segments(self, dev, n: int, width: int) -> dict:
        """The hop-major lanes of n programs, cached per n: ``mirror`` and
        ``master`` flat indices into the (k, n, width) table; ``seg`` each
        lane's segment (one row of one program on one hop); ``pos`` the
        sorted positions each segment sends (its first T_s), ``sel_seg``
        their segments and ``base`` their segments' first lane."""
        key = ("rq", n)
        cache = dev["routes"]
        if key in cache:
            return cache[key]
        k, device = self.k, dev["rq_mirror"].device
        widths = [h for _, h in _hops(self.schedule)]
        out = {}
        for end in ("mirror", "master"):
            blocks = torch.split(dev[f"rq_{end}"], [k * h for h in widths])
            out[end] = torch.cat(
                [_program_rows(b.view(k, h), n, width).reshape(-1)
                 for b, h in zip(blocks, widths)]
                or [dev["rq_mirror"].new_zeros(0)])
        seg_w = torch.tensor(widths, device=device).repeat_interleave(k * n)
        seg_t = torch.tensor([self._top(h) for h in widths],
                             device=device).repeat_interleave(k * n)
        nseg = seg_w.numel()
        start = torch.cumsum(seg_w, 0) - seg_w
        out["seg"] = torch.arange(nseg, device=device).repeat_interleave(
            seg_w)
        out["sel_seg"] = torch.arange(nseg, device=device) \
            .repeat_interleave(seg_t)
        t_start = torch.cumsum(seg_t, 0) - seg_t
        within = torch.arange(out["sel_seg"].numel(), device=device) \
            - t_start[out["sel_seg"]]
        out["base"] = start[out["sel_seg"]]
        out["pos"] = out["base"] + within
        out["nseg"] = nseg
        cache[key] = out
        return out

    def init_state_multi(self, dev, dtype, combine: str, n: int):
        if not lossy_payload(combine, dtype):
            return ()
        size = self.k * n * sum(h for _, h in _hops(self.schedule))
        device = dev["halo_send"].device

        def lanes():
            zeros = torch.zeros(size, dtype=torch.float32, device=device)
            return {"sref": zeros, "rref": zeros}

        return {"reduce": lanes(), "bcast": lanes()}

    def _encode(self, lanes, st, seg):
        """Top-Δ step over every segment: the advanced sender state and
        the (index within the hop's row, codes, scales) wire."""
        err = lanes - st["sref"]
        bits = torch.abs(err).view(torch.int32).to(torch.int64)
        order = torch.argsort(seg["seg"] * (1 << 31) + ((1 << 31) - 1 - bits),
                              stable=True)
        sel = order[seg["pos"]]
        vals = err[sel]
        amax = torch.zeros(seg["nseg"], dtype=torch.float32,
                           device=err.device).scatter_reduce_(
            0, seg["sel_seg"], torch.abs(vals), "amax", include_self=True)
        scales = torch.where(amax > 0, _div(amax, _QMAX), 1.0)
        s = scales[seg["sel_seg"]]
        codes = torch.clamp(torch.round(vals / s), -_QMAX, _QMAX) \
            .to(torch.int8)
        deq = _scatter_last(sel, codes.to(torch.float32) * s, err.numel())
        return ({"sref": st["sref"] + deq, "rref": st["rref"]},
                ((sel - seg["base"]).to(torch.int16), codes, scales))

    @staticmethod
    def _decode(ridx, rcodes, rscales, seg, size: int):
        """The wire back onto the lanes: (size,) f32, zero where nothing
        was sent."""
        return _scatter_last(ridx.long() + seg["base"],
                             rcodes.to(torch.float32)
                             * rscales[seg["sel_seg"]], size)

    def _phase(self, values, dev, combine, st, send):
        """One lossy phase: the lanes at ``send`` encoded, the wire decoded
        onto the receiver's reference.  Returns (rref, new state, seg)."""
        n, width = values.shape[1], values.shape[2] + 1
        seg = self._segments(dev, n, width)
        ext = _ext_multi(values, combine).reshape(-1)
        st, wire = self._encode(ext[seg[send]], st, seg)
        rref = st["rref"] + self._decode(*wire, seg, seg["seg"].numel())
        return rref, {**st, "rref": rref}, seg

    def reduce_stacked_multi(self, partials, dev, combine: str = "sum",
                             state=(), *, hopwise: bool = False):
        if not state:
            return self._exact.reduce_stacked_multi(
                partials, dev, combine, state, hopwise=hopwise)
        k, n, L = partials.shape
        rref, st, seg = self._phase(partials, dev, combine, state["reduce"],
                                    "mirror")
        size = k * n * (L + 1)
        if hopwise:
            acc = _hop_accumulate(
                _acc_init((size,), partials.dtype, combine, partials.device),
                seg["master"], rref.to(partials.dtype), combine)
        else:
            acc = _segment_combine(rref, seg["master"], size, combine)
        agg = acc.view(k, n, L + 1)[:, :, :L]
        return _merge(partials, agg, combine), {**state, "reduce": st}

    def broadcast_stacked_multi(self, masters, dev, combine: str = "sum",
                                state=()):
        if not state:
            return self._exact.broadcast_stacked_multi(masters, dev,
                                                       combine, state)
        rref, st, seg = self._phase(masters, dev, combine, state["bcast"],
                                    "master")
        return _unpack_multi(masters, rref, seg["mirror"], dev), \
            {**state, "bcast": st}

    # -- per-rank halves --
    @property
    def _exact_rank(self) -> RaggedHaloExchange:
        return RaggedHaloExchange(schedule=self.schedule, axis=self.axis)

    def init_state_rank_multi(self, dev, dtype, combine: str, n: int):
        if not lossy_payload(combine, dtype):
            return ()
        device = dev["halo_send"].device

        def lanes():
            return tuple({"sref": torch.zeros(n, h, device=device),
                          "rref": torch.zeros(n, h, device=device)}
                         for _, h in _hops(self.schedule))

        return {"reduce": lanes(), "bcast": lanes()}

    def _rank_hop(self, lanes, st, h: int, d: int, site: str):
        """One hop of a rank: the top-T_s step of its (N, h) rows, the
        wire over the ring to r + d, decoded onto the receiver's
        reference.  Returns (rref, the hop's new state)."""
        err = lanes - st["sref"]
        bits = torch.abs(err).view(torch.int32).to(torch.int64)
        order = torch.argsort((1 << 31) - 1 - bits, dim=-1, stable=True)
        sel = order[:, :self._top(h)]
        vals = torch.gather(err, 1, sel)
        amax = torch.amax(torch.abs(vals), dim=-1)
        scales = torch.where(amax > 0, _div(amax, _QMAX), 1.0)
        s = scales[:, None]
        codes = torch.clamp(torch.round(vals / s), -_QMAX, _QMAX) \
            .to(torch.int8)
        sref = st["sref"] + _scatter_last(sel, codes.to(torch.float32) * s, h)
        ridx, rcodes, rscales = (
            coll.ring_hop(w, self.axis, d, site=site)
            for w in (sel.to(torch.int16), codes, scales))
        rref = st["rref"] + _scatter_last(
            ridx.long(), rcodes.to(torch.float32) * rscales[:, None], h)
        return rref, {"sref": sref, "rref": rref}

    def reduce_to_masters_multi(self, partials, dev, combine: str = "sum",
                                state=(), *, hopwise: bool = False):
        if not state:
            return self._exact_rank.reduce_to_masters_multi(
                partials, dev, combine, hopwise=hopwise)
        n, L = partials.shape
        ext = _ext_rank(partials, combine)
        rrefs, slots, new_st = [], [], []
        for (s, h), st in zip(_hops(self.schedule), state["reduce"]):
            send_rows, recv_rows = self._exact_rank._rank_rows(dev, s, h)
            rref, st = self._rank_hop(ext[:, send_rows.long()], st, h, s,
                                      "ragged_quantized.reduce")
            rrefs.append(rref)
            slots.append(recv_rows)
            new_st.append(st)
        if not rrefs:
            return partials, state
        recv = torch.cat(rrefs, dim=1)
        fill = _acc_init((n * (L + 1),), partials.dtype, combine,
                         partials.device) if hopwise else None
        agg = _combine_rank(recv.to(partials.dtype) if hopwise else recv,
                            torch.cat(slots), L, combine, fill)
        return _merge(partials, agg, combine), \
            {**state, "reduce": tuple(new_st)}

    def broadcast_from_masters_multi(self, new_masters, dev,
                                     combine: str = "sum", state=()):
        if not state:
            return self._exact_rank.broadcast_from_masters_multi(
                new_masters, dev, combine)
        ext = _ext_rank(new_masters, combine)
        rrefs, slots, new_st = [], [], []
        for (s, h), st in zip(_hops(self.schedule), state["bcast"]):
            send_rows, recv_rows = self._exact_rank._rank_rows(dev, s, h)
            rref, st = self._rank_hop(ext[:, recv_rows.long()], st, h, -s,
                                      "ragged_quantized.broadcast")
            rrefs.append(rref)
            slots.append(send_rows)
            new_st.append(st)
        if not rrefs:
            return new_masters, state
        return _unpack_rank(new_masters, torch.cat(rrefs, dim=1),
                            torch.cat(slots), dev), \
            {**state, "bcast": tuple(new_st)}

    def bytes_per_iter(self, layout, value_bytes: int = 4,
                       combine: str = "sum", dtype=torch.float32) -> int:
        return layout.comm_bytes("ragged_quantized",
                                 lossy=lossy_payload(combine, dtype),
                                 top_delta=self.top_delta,
                                 value_bytes=value_bytes)


EXCHANGES = {"dense": DenseExchange, "halo": HaloExchange,
             "quantized": QuantizedHaloExchange,
             "ragged": RaggedHaloExchange,
             "ragged_quantized": RaggedQuantizedHaloExchange}
EXCHANGE_NAMES = tuple(EXCHANGES)
# the ragged wire formats need the layout's static per-distance schedule
RAGGED_EXCHANGES = ("ragged", "ragged_quantized")


def get_exchange(name: str, layout=None, *, axis: str | None = None,
                 top_delta: float | None = None):
    """Exchange registry: ``name`` ∈ ``EXCHANGE_NAMES``.  The ragged wire
    formats need ``layout`` for their per-distance lane schedule
    (``layout.halo_schedule()``); ``top_delta`` tunes the ragged-quantized
    sparsification.  ``axis`` (a bound ``dist.mesh.Mesh``, one
    partition a rank) is what the per-rank halves
    (``init_state_rank[_multi]``, ``reduce_to_masters[_multi]``,
    ``broadcast_from_masters[_multi]``) go over; the stacked halves
    ignore it."""
    if name not in EXCHANGES:
        raise ValueError(
            f"unknown exchange {name!r}; expected one of "
            f"{sorted(EXCHANGE_NAMES)}")
    if name in RAGGED_EXCHANGES:
        if layout is None:
            raise ValueError(
                f"exchange {name!r} needs layout= for its static "
                "per-distance lane schedule (layout.halo_schedule())")
        schedule = tuple(int(h) for h in layout.halo_schedule())
        if name == "ragged":
            return RaggedHaloExchange(schedule=schedule, axis=axis)
        return RaggedQuantizedHaloExchange(
            schedule=schedule,
            top_delta=DEFAULT_TOP_DELTA if top_delta is None else top_delta,
            axis=axis)
    return EXCHANGES[name](axis=axis)
