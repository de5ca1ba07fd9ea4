"""Vertex-cut partition layout — a numpy copy of ``repro.graph.partition``.

From an edge→partition assignment to the static padded per-partition
tables the GAS engine runs on (PowerGraph semantics, paper §II-B): each
vertex replicated on several partitions has one master (the partition
holding most of its edges, ties → lowest id) and mirrors elsewhere.
``build_layout`` is the reference's vectorized builder line for line, so
every table is bit-identical (``tests/test_torch_engine.py``).  The
reference's ``repro.graph`` package imports JAX, hence the copy.

  edge_src/edge_dst (k, E_max)    local-slot endpoints, padded with L_max
  vert_gid          (k, L_max)    local slot → global vertex id (pad: V)
  owner / own_slot  (k, L_max)    master device + slot there
  red_index         (k, k·L_max)  flat all_gather entry → my owned slot
  out_deg           (k, L_max)    global out-degree (pagerank)
  halo_send         (k, k, H_max) [p, q, h] → p's mirror slot whose h-th
                                  value goes to owner q (pad: L_max)
  halo_recv         (k, k, H_max) [q, p, h] → q's master slot where the
                                  h-th value from p lands (pad: L_max)
  halo_cnt          (k, k)        real lanes per ordered pair
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np


@dataclass
class PartitionLayout:
    k: int
    num_vertices: int
    num_edges: int
    e_max: int
    l_max: int
    h_max: int               # per-device-pair halo pad length
    edge_src: np.ndarray     # (k, E_max) int32, local slots; pad = l_max
    edge_dst: np.ndarray     # (k, E_max)
    edge_mask: np.ndarray    # (k, E_max) bool
    vert_gid: np.ndarray     # (k, L_max) int32; pad = num_vertices
    vert_mask: np.ndarray    # (k, L_max) bool
    is_master: np.ndarray    # (k, L_max) bool
    owner: np.ndarray        # (k, L_max) int32 master device; pad = 0
    own_slot: np.ndarray     # (k, L_max) int32 slot in owner's table; pad 0
    red_index: np.ndarray    # (k, k*L_max) int32 → my slot or l_max (drop)
    out_deg: np.ndarray      # (k, L_max) int32 global out-degree
    halo_send: np.ndarray    # (k, k, H_max) int32 mirror slots; pad = l_max
    halo_recv: np.ndarray    # (k, k, H_max) int32 master slots; pad = l_max
    halo_cnt: np.ndarray     # (k, k) int32 real lanes per ordered pair
    frontier: np.ndarray     # (k, L_max) bool: replicated vertex
    mirrors_total: int       # Σ_v (|P(v)| − 1)
    # device tables derived from this layout (per device and exchange),
    # built once by the engine and reused by every run on the layout
    cache: dict = field(default_factory=dict, repr=False, compare=False)

    TABLES = ("edge_src", "edge_dst", "edge_mask", "vert_gid", "vert_mask",
              "is_master", "owner", "own_slot", "red_index", "out_deg",
              "halo_send", "halo_recv", "halo_cnt", "frontier")
    # per-device tables every exchange needs, and each wire format's own
    COMMON_TABLES = ("edge_src", "edge_dst", "edge_mask", "vert_gid",
                     "vert_mask", "is_master", "out_deg")
    # quantized rides the halo tables; the ragged exchanges take prefixes
    # of them per ring distance (their schedule lives in the exchange
    # instance) and ``frontier`` for the overlapped body
    EXCHANGE_TABLES = {"dense": ("owner", "own_slot", "red_index"),
                       "halo": ("halo_send", "halo_recv"),
                       "quantized": ("halo_send", "halo_recv"),
                       "ragged": ("halo_send", "halo_recv", "frontier"),
                       "ragged_quantized": ("halo_send", "halo_recv",
                                            "frontier")}

    def device_arrays(self, exchange: str | None = None) -> dict:
        """The numpy tables one exchange needs (leading k axis); None
        gives every exchange's tables."""
        if exchange is not None and exchange not in self.EXCHANGE_TABLES:
            raise ValueError(
                f"unknown exchange {exchange!r}; expected one of "
                f"{sorted(self.EXCHANGE_TABLES)}")
        keys = self.COMMON_TABLES + (
            tuple(t for ts in self.EXCHANGE_TABLES.values() for t in ts)
            if exchange is None else self.EXCHANGE_TABLES[exchange])
        return {f: getattr(self, f) for f in dict.fromkeys(keys)}

    def interior_frontier_stats(self) -> dict:
        """Interior/frontier split of the local vertex tables: interior
        vertices (one replica) can be applied while the ragged ring is in
        flight, frontier ones wait for their mirror lanes.  Per-partition
        interior counts and fractions, and the global interior fraction."""
        local = self.vert_mask.sum(axis=1)
        interior = (self.vert_mask & ~self.frontier).sum(axis=1)
        with np.errstate(invalid="ignore"):
            frac = np.where(local > 0, interior / np.maximum(local, 1), 1.0)
        total_local = int(local.sum())
        return {
            "interior_per_part": interior.astype(int).tolist(),
            "local_per_part": local.astype(int).tolist(),
            "interior_frac_per_part": [round(float(f), 6) for f in frac],
            "interior_frac": (float(interior.sum()) / total_local
                              if total_local else 1.0),
            "interior_frac_min": float(frac.min(initial=1.0)),
        }

    # -- communication model: modelled wire bytes per GAS iteration --

    # every name ``comm_bytes`` routes: the five wire formats, the two
    # bounds ("ideal" = 2·mirrors, "allreduce" = a dense psum) and
    # "dense_gather", an alias of "dense"
    COMM_MODELS = ("allreduce", "dense", "dense_gather", "halo", "ideal",
                   "quantized", "ragged", "ragged_quantized")
    # the fused quantized wire's fp16 scales: 8 a (pair, program) row
    FUSED_SCALE_BYTES = 16

    def comm_bytes(self, exchange: str | None = None, *, programs: int = 1,
                   fused: bool = False, lossy: bool = True,
                   value_bytes: int = 4, top_delta: float = 0.25):
        """Modelled mirror-sync bytes per GAS iteration: ``comm_bytes()``
        the table of every model; ``comm_bytes(exchange)`` one of
        ``COMM_MODELS`` (``lossy``: whether the payload is delta-coded on
        the quantized wires, ``halo.lossy_payload``); ``programs=N,
        fused=True`` N programs in one fused step (the int4 wire when
        quantized and lossy)."""
        if exchange is None:
            if fused or programs != 1:
                raise ValueError(
                    "comm_bytes(programs=..., fused=...) needs an "
                    "explicit exchange=")
            return {"ideal": self._bytes_ideal(value_bytes),
                    "ragged_quantized": self._bytes_ragged_quantized(
                        top_delta),
                    "quantized": self._bytes_halo_quantized(),
                    "ragged": self._bytes_ragged(value_bytes),
                    "halo": self._bytes_halo(value_bytes),
                    "dense_gather": self._bytes_dense_gather(value_bytes),
                    "allreduce": self._bytes_allreduce(value_bytes)}
        if exchange not in self.COMM_MODELS:
            raise ValueError(
                f"unknown exchange {exchange!r}; expected one of "
                f"{self.COMM_MODELS}")
        if fused and exchange == "quantized" and lossy:
            return self._bytes_fused_quantized(programs)
        single = {
            "dense": lambda: self._bytes_dense_gather(value_bytes),
            "dense_gather": lambda: self._bytes_dense_gather(value_bytes),
            "halo": lambda: self._bytes_halo(value_bytes),
            "quantized": lambda: (self._bytes_halo_quantized() if lossy
                                  else self._bytes_halo(value_bytes)),
            "ragged": lambda: self._bytes_ragged(value_bytes),
            "ragged_quantized": lambda: (
                self._bytes_ragged_quantized(top_delta) if lossy
                else self._bytes_ragged(value_bytes)),
            "ideal": lambda: self._bytes_ideal(value_bytes),
            "allreduce": lambda: self._bytes_allreduce(value_bytes),
        }[exchange]()
        return programs * single

    def halo_schedule(self) -> tuple:
        """The ragged ring's lanes per distance: entry s−1 is H_s =
        max_p halo_cnt[p, (p+s) mod k] for s = 1..k−1."""
        k = self.k
        ar = np.arange(k)
        return tuple(int(self.halo_cnt[ar, (ar + s) % k].max(initial=0))
                     for s in range(1, k))

    def _bytes_dense_gather(self, value_bytes: int = 4) -> int:
        """all_gather(k, L_max) a phase: k·L_max values per device."""
        return 2 * self.k * self.k * self.l_max * value_bytes

    def _bytes_halo(self, value_bytes: int = 4) -> int:
        """all_to_all(k, H_max) a phase, the self block staying home."""
        return 2 * self.k * (self.k - 1) * self.h_max * value_bytes

    def _bytes_ragged(self, value_bytes: int = 4) -> int:
        """Σ_s H_s values a device a phase over the k−1 ring hops."""
        return 2 * self.k * sum(self.halo_schedule()) * value_bytes

    def _bytes_ragged_quantized(self, top_delta: float = 0.25) -> int:
        """Per hop T_s = max(1, ⌈top_delta·H_s⌉) (int16 index, int8 code)
        pairs and one f32 scale."""
        total = 0
        for h in self.halo_schedule():
            if h == 0:
                continue
            t = min(h, max(1, int(np.ceil(top_delta * h))))
            total += 3 * t + 4
        return 2 * self.k * total

    def _bytes_halo_quantized(self, code_bytes: int = 1,
                              scale_bytes: int = 4) -> int:
        """H_max int8 codes and one f32 scale per off-diagonal lane group
        a phase."""
        return 2 * self.k * (self.k - 1) * (
            self.h_max * code_bytes + scale_bytes)

    def _bytes_fused_quantized(self, n_programs: int) -> int:
        """N lossy programs on one fused wire: ⌈H_max/8⌉·8 int4 codes two
        to a byte and 16 B of fp16 scales per (pair, program) row."""
        h8 = -(-self.h_max // 8) * 8
        return 2 * self.k * (self.k - 1) * n_programs * (
            h8 // 2 + self.FUSED_SCALE_BYTES)

    def _bytes_ideal(self, value_bytes: int = 4) -> int:
        """Every mirror value once a phase: 2·mirrors·bytes."""
        return 2 * self.mirrors_total * value_bytes

    def _bytes_allreduce(self, value_bytes: int = 4) -> int:
        """A dense psum: a ring all-reduce over (V,) per device."""
        return 2 * (self.k - 1) * self.num_vertices * value_bytes

    # -- deprecated per-format methods (shims over comm_bytes) --

    def _deprecated(self, old: str, new: str):
        warnings.warn(
            f"PartitionLayout.{old} is deprecated; use "
            f"PartitionLayout.{new}", DeprecationWarning, stacklevel=3)

    def comm_bytes_mirror_sync(self, value_bytes: int = 4) -> int:
        self._deprecated("comm_bytes_mirror_sync", "comm_bytes('dense')")
        return self.comm_bytes("dense", value_bytes=value_bytes)

    def comm_bytes_halo(self, value_bytes: int = 4) -> int:
        self._deprecated("comm_bytes_halo", "comm_bytes('halo')")
        return self.comm_bytes("halo", value_bytes=value_bytes)

    def comm_bytes_ragged(self, value_bytes: int = 4) -> int:
        self._deprecated("comm_bytes_ragged", "comm_bytes('ragged')")
        return self.comm_bytes("ragged", value_bytes=value_bytes)

    def comm_bytes_ragged_quantized(self, top_delta: float = 0.25,
                                    value_bytes: int = 4) -> int:
        self._deprecated("comm_bytes_ragged_quantized",
                         "comm_bytes('ragged_quantized')")
        return self.comm_bytes("ragged_quantized", top_delta=top_delta,
                               value_bytes=value_bytes)

    def comm_bytes_halo_quantized(self, code_bytes: int = 1,
                                  scale_bytes: int = 4) -> int:
        self._deprecated("comm_bytes_halo_quantized",
                         "comm_bytes('quantized')")
        return self._bytes_halo_quantized(code_bytes, scale_bytes)

    def comm_bytes_fused_quantized(self, n_programs: int) -> int:
        self._deprecated("comm_bytes_fused_quantized",
                         "comm_bytes('quantized', programs=N, fused=True)")
        return self._bytes_fused_quantized(n_programs)

    def comm_bytes_exchange(self, exchange: str, *, lossy: bool = True,
                            value_bytes: int = 4) -> int:
        self._deprecated("comm_bytes_exchange", "comm_bytes(exchange)")
        return self.comm_bytes(exchange, lossy=lossy,
                               value_bytes=value_bytes)

    def comm_bytes_fused(self, n_programs: int, exchange: str, *,
                         lossy: bool = True, value_bytes: int = 4) -> int:
        self._deprecated(
            "comm_bytes_fused",
            "comm_bytes(exchange, programs=N, fused=True)")
        return self.comm_bytes(exchange, programs=n_programs, fused=True,
                               lossy=lossy, value_bytes=value_bytes)

    def comm_bytes_ideal(self, value_bytes: int = 4) -> int:
        self._deprecated("comm_bytes_ideal", "comm_bytes('ideal')")
        return self.comm_bytes("ideal", value_bytes=value_bytes)

    def comm_bytes_dense(self, value_bytes: int = 4) -> int:
        self._deprecated("comm_bytes_dense", "comm_bytes('allreduce')")
        return self.comm_bytes("allreduce", value_bytes=value_bytes)


def _pad_to(n: int, pad_multiple: int) -> int:
    return int(np.ceil(max(n, 1) / pad_multiple) * pad_multiple)


def build_layout(src: np.ndarray, dst: np.ndarray, assign: np.ndarray,
                 num_vertices: int, k: int,
                 pad_multiple: int = 8) -> PartitionLayout:
    """Vectorized layout builder — pure np.unique/searchsorted/bincount
    passes on the host, no per-vertex Python loops (the reference's
    ``build_layout``, table for table)."""
    E = src.shape[0]
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    assign = np.asarray(assign)
    order = np.argsort(assign, kind="stable")
    s, d, a = src[order], dst[order], assign[order].astype(np.int64)
    bounds = np.searchsorted(a, np.arange(k + 1))

    # global out degree
    gdeg = np.bincount(src, minlength=num_vertices)

    # one row per (partition, vertex) replica, with its endpoint count.
    # np.unique on the fused key sorts by (partition, vertex), so rows are
    # grouped by partition with vertices ascending — the same order the
    # reference builder's per-partition np.unique produces.
    key = np.concatenate([a, a]) * num_vertices + np.concatenate([s, d])
    uniq, cnt = np.unique(key, return_counts=True)
    up = uniq // num_vertices        # partition of each replica row
    uv = uniq % num_vertices         # vertex gid of each replica row
    n_rows = uniq.shape[0]

    # master election: per vertex, the partition with max endpoint count,
    # ties → lowest partition id.  lexsort is keyed last-to-first.
    elect = np.lexsort((up, -cnt, uv))
    uv_e, up_e = uv[elect], up[elect]
    first = np.ones(n_rows, dtype=bool)
    np.not_equal(uv_e[1:], uv_e[:-1], out=first[1:])
    master_of = np.full(num_vertices, -1, dtype=np.int64)
    master_of[uv_e[first]] = up_e[first]

    part_sizes = np.bincount(up, minlength=k)
    l_max = _pad_to(int(part_sizes.max(initial=1)), pad_multiple)
    e_max = _pad_to(int(max(bounds[1:] - bounds[:-1], default=1)),
                    pad_multiple)

    # local slot of each replica row = rank within its partition group
    row_start = np.searchsorted(up, np.arange(k + 1))
    slot = np.arange(n_rows) - row_start[up]

    if k * num_vertices <= (1 << 25):
        # dense inverse map: O(1) per lookup, ≤128 MiB of int32
        _lookup = np.empty(k * num_vertices, dtype=np.int32)
        _lookup[uniq] = slot

        def slot_of(parts: np.ndarray, verts: np.ndarray) -> np.ndarray:
            """Vectorized (partition, gid) → local slot."""
            return _lookup[parts * num_vertices + verts]
    else:
        def slot_of(parts: np.ndarray, verts: np.ndarray) -> np.ndarray:
            """Vectorized (partition, gid) → local slot via sorted keys."""
            return slot[np.searchsorted(uniq, parts * num_vertices + verts)]

    replic = np.bincount(uv, minlength=num_vertices)

    vert_gid = np.full((k, l_max), num_vertices, dtype=np.int32)
    vert_mask = np.zeros((k, l_max), dtype=bool)
    is_master = np.zeros((k, l_max), dtype=bool)
    out_deg = np.zeros((k, l_max), dtype=np.int32)
    owner = np.zeros((k, l_max), dtype=np.int32)
    own_slot = np.zeros((k, l_max), dtype=np.int32)
    frontier = np.zeros((k, l_max), dtype=bool)
    row_owner = master_of[uv]
    row_own_slot = slot_of(row_owner, uv)
    row_is_master = row_owner == up
    row_deg = gdeg[uv]
    row_frontier = replic[uv] > 1
    # rows are grouped by partition, so per-partition contiguous slice
    # copies beat a (k, slot) fancy scatter by ~5×
    for p in range(k):
        r0, r1 = int(row_start[p]), int(row_start[p + 1])
        n = r1 - r0
        if n == 0:
            continue
        rows = slice(r0, r1)
        vert_gid[p, :n] = uv[rows]
        vert_mask[p, :n] = True
        is_master[p, :n] = row_is_master[rows]
        out_deg[p, :n] = row_deg[rows]
        owner[p, :n] = row_owner[rows]
        own_slot[p, :n] = row_own_slot[rows]
        frontier[p, :n] = row_frontier[rows]

    # reduce map: flat all_gather entry (j*L_max + slot) → my slot (if I am
    # the owner of that entry's vertex) else l_max (dropped)
    red_index = np.full((k, k * l_max), l_max, dtype=np.int32)
    red_index[row_owner, up * l_max + slot] = row_own_slot

    edge_src = np.full((k, e_max), l_max, dtype=np.int32)
    edge_dst = np.full((k, e_max), l_max, dtype=np.int32)
    edge_mask = np.zeros((k, e_max), dtype=bool)
    if E:
        src_slots = slot_of(a, s)
        dst_slots = slot_of(a, d)
        # edges are sorted by partition: contiguous copies, no scatter
        for p in range(k):
            lo, hi = int(bounds[p]), int(bounds[p + 1])
            n = hi - lo
            if n == 0:
                continue
            edge_src[p, :n] = src_slots[lo:hi]
            edge_dst[p, :n] = dst_slots[lo:hi]
            edge_mask[p, :n] = True

    # halo routing tables: one lane per mirror replica, grouped by the
    # ordered (mirror partition, owner partition) pair and padded to the
    # max pair population H_max — every mirror is routed exactly once.
    mir = row_owner != up
    mp_, mq = up[mir], row_owner[mir]
    m_slot, m_own_slot = slot[mir], row_own_slot[mir]
    pair = mp_ * k + mq
    po = np.argsort(pair, kind="stable")
    pair_s = pair[po]
    lane = np.arange(pair_s.shape[0]) - np.searchsorted(pair_s, pair_s)
    h_max = _pad_to(int(lane.max(initial=-1)) + 1, pad_multiple)
    halo_send = np.full((k, k, h_max), l_max, dtype=np.int32)
    halo_recv = np.full((k, k, h_max), l_max, dtype=np.int32)
    halo_send[mp_[po], mq[po], lane] = m_slot[po]
    halo_recv[mq[po], mp_[po], lane] = m_own_slot[po]
    halo_cnt = np.bincount(pair, minlength=k * k).reshape(k, k) \
        .astype(np.int32)

    mirrors_total = int(np.maximum(replic - 1, 0).sum())

    return PartitionLayout(
        k=k, num_vertices=num_vertices, num_edges=E, e_max=e_max,
        l_max=l_max, h_max=h_max, edge_src=edge_src, edge_dst=edge_dst,
        edge_mask=edge_mask, vert_gid=vert_gid, vert_mask=vert_mask,
        is_master=is_master, owner=owner, own_slot=own_slot,
        red_index=red_index, out_deg=out_deg, halo_send=halo_send,
        halo_recv=halo_recv, halo_cnt=halo_cnt, frontier=frontier,
        mirrors_total=mirrors_total)
