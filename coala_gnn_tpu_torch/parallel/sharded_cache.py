"""The feature cache front of the host pipeline (port of
``coala_gnn_tpu/parallel/sharded_cache.py``: ``ShardedFeatureCache`` and
its two-phase exchange).

One process drives one card (``parallel/mesh.py``). The cache spreads over
the ranks of a ``Mesh`` in the JAX class's modes:

- "sharded": node ids hash-partitioned over every rank (owner = id %
  world, set = (id // world) % num_sets); a rank's request goes to the
  owners and back in a two-phase exchange over ``all_to_all_single``.
- "node_local": the same, but within each host's block of ``group_size``
  ranks (default: the mesh's ranks per host), every all-to-all scoped to
  the block's group: features never cross hosts (the reference's one
  NVSHMEM world per node).
- "isolated": every rank caches what it requests, privately, and runs no
  collective.

The exchange (``exchange_lookup``) is the JAX function's, with its fixed
``[n_route, bucket_cap]`` buckets (``sizing.lookup_bucket_cap``; -1 marks
an empty slot): phase 1 sends each id to its owner (the owner bucket and
slot from a one-hot prefix sum, ``_owner_rank``), the owner probes its
shard, phase 2 sends the rows and hit bits back (int8 lines + f32 scales
for an int8 cache, dequantised by the requester). Requests past a bucket's
capacity are reported as overflow, apart from misses, and are served from
the host tier. The miss fill (``exchange_fill``) is a third exchange of
ids, rows and colors to their owners, inserted there with
``insert_with_colors``; its buckets are sized from the largest miss count
of any rank (``sizing.fill_bucket_cap``), so every rank ships the same
shapes. That count is one ``all_reduce`` (MAX) on the device before the
miss count's pinned readback (every rank but an isolated one), so every
rank takes the same miss-path decision: the JAX class's replicated
counters. (JAX also sums the counts; only "any miss", which the maximum
answers, and the maximum itself are used.)

With one rank (``n_route == 1``, or "isolated") a lookup is
``feature_cache.lookup`` on the rank's own state, a residency check
``feature_cache.probe``, a fill ``feature_cache.insert_with_colors``.

The public API keeps the JAX class's leading ``[n_local, ...]`` axis, here
always 1 (a rank's own slice), so a ``HostBatch`` passes through
unchanged. The miss path pads the miss list to ``ceil_pow2`` of the miss
count as JAX pads it, so the cache state stays bitwise JAX's. The miss
count streams back without a sync: a pinned host scalar filled by a
``non_blocking`` copy and fenced by a CUDA event (JAX's
``copy_to_host_async``); only the all-hit check reads it. The state is
updated in place. ``parallel/sharded_resident.py`` calls the module
functions over the cache's ``route`` and offers its stages through
``insert_rows``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from coala_gnn_tpu_torch.cache import feature_cache as fc
from coala_gnn_tpu_torch.parallel.mesh import Mesh, as_mesh
from coala_gnn_tpu_torch.parallel.sizing import (ceil_pow2, fill_bucket_cap,
                                                 lookup_bucket_cap)

MODES = ("sharded", "isolated", "node_local")


def start_readback(t: torch.Tensor):
    """Start a device -> host copy of ``t`` into pinned memory; returns
    (host tensor, CUDA event to wait on, or None on the CPU)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    host.copy_(t, non_blocking=True)
    if not t.is_cuda:
        return host, None
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


@dataclasses.dataclass(frozen=True)
class Route:
    """Where a rank's requests go: to ``n_route`` owners (owner = id %
    n_route), the ranks of ``group`` on ``mesh``; ``slack`` sizes the
    buckets. ``n_route`` 1 is the rank's own shard, no exchange."""
    mesh: Optional[Mesh] = None
    n_route: int = 1
    group: Optional[object] = None
    slack: float = 2.0

    def a2a(self, t: torch.Tensor, phase: str) -> torch.Tensor:
        return self.mesh.all_to_all(t, self.group, self.n_route, phase)


LOCAL = Route()


def _owner_rank(ids: torch.Tensor, valid: torch.Tensor, n_dev: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(owner, occurrence rank within the owner's bucket) per request slot,
    int64 [n]; invalid slots get owner ``n_dev``. The rank is a one-hot
    prefix sum over [n, n_dev + 1], as in JAX (no sort)."""
    owner = torch.where(valid, ids.to(torch.int64) % n_dev,
                        torch.full_like(ids, n_dev, dtype=torch.int64))
    onehot = owner[:, None] == torch.arange(n_dev + 1, device=ids.device)
    csum = onehot.to(torch.int32).cumsum(0)
    rank = csum.gather(1, owner[:, None])[:, 0].to(torch.int64) - 1
    return owner, rank


def _bucket(owner: torch.Tensor, rank: torch.Tensor, n_dev: int, cap: int,
            values: torch.Tensor, fill) -> torch.Tensor:
    """``values`` [n, ...] into buckets [n_dev, cap, ...] at (owner,
    rank), empty slots ``fill``; a slot whose owner is ``n_dev`` or whose
    rank is past ``cap`` is dropped (JAX's ``mode="drop"``) into a scratch
    slot that is cut off."""
    ok = (owner < n_dev) & (rank < cap)
    flat = torch.where(ok, owner * cap + rank,
                       torch.full_like(owner, n_dev * cap))
    out = torch.full((n_dev * cap + 1,) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    out[flat] = values
    return out[:n_dev * cap].view((n_dev, cap) + tuple(values.shape[1:]))


def _gather_back(resp: torch.Tensor, owner: torch.Tensor,
                 rank: torch.Tensor, take: torch.Tensor) -> torch.Tensor:
    """Row (owner, rank) of a response grid per request slot, slot (0, 0)
    where ``take`` is false (the caller masks those)."""
    zero = torch.zeros_like(owner)
    return resp[torch.where(take, owner, zero), torch.where(take, rank, zero)]


def exchange_lookup(cfg: fc.CacheConfig, local: fc.ColoredCacheState,
                    ids: torch.Tensor, valid: torch.Tensor,
                    count_stats: bool = True, route: Route = LOCAL
                    ) -> Tuple[fc.ColoredCacheState, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """Look ``ids`` (int32 [n]; ``valid`` masks padding) up in the cache
    spread over ``route``'s ranks: -> (local, feats [n, dim] in cfg.dtype,
    hit bool [n], overflow bool [n]). Rows that miss or overflow read
    zero. The owners count hits and misses of what reaches them
    (``count_stats=False`` leaves the counters alone). An int8 cache sends
    its lines and scales as stored. Collective over ``route.group`` when
    ``route.n_route > 1``."""
    ids = torch.where(valid, ids, torch.zeros_like(ids))
    G = route.n_route
    if G == 1:
        _, feats, hit = fc.lookup(cfg, local.base, ids, valid,
                                  count_stats=count_stats)
        return local, feats, hit, torch.zeros_like(valid)
    c = lookup_bucket_cap(ids.shape[0], G, route.slack)
    owner, rank = _owner_rank(ids, valid, G)
    routed = rank < c

    # phase 1: the ids to their owners
    req = route.a2a(_bucket(owner, rank, G, c, ids.to(torch.int32), -1),
                    "request").reshape(-1)
    req_valid = req >= 0
    safe = torch.where(req_valid, req, torch.zeros_like(req))
    # the owners' probe, then phase 2: rows and hit bits back
    quantized = local.base.scales is not None
    if quantized:
        _, q, sc, hit = fc.lookup_quantized(cfg, local.base, safe, req_valid,
                                            count_stats=count_stats)
        resp_q = route.a2a(q.view(G, c, cfg.dim), "response")
        resp_sc = route.a2a(sc.view(G, c), "response")
    else:
        _, feats, hit = fc.lookup(cfg, local.base, safe, req_valid,
                                  count_stats=count_stats)
        resp = route.a2a(feats.view(G, c, cfg.dim), "response")
    hit_back = route.a2a(hit.view(G, c), "hitbits")

    take = routed & valid
    if quantized:
        rows = fc.dequantize_rows(_gather_back(resp_q, owner, rank, take),
                                  _gather_back(resp_sc, owner, rank, take),
                                  dtype=cfg.dtype)
    else:
        rows = _gather_back(resp, owner, rank, take)
    out = torch.where(take[:, None], rows,
                      torch.zeros((), dtype=rows.dtype, device=rows.device))
    out_hit = _gather_back(hit_back, owner, rank, take) & take
    return local, out, out_hit, ~routed & valid


def exchange_probe(cfg: fc.CacheConfig, local: fc.ColoredCacheState,
                   ids: torch.Tensor, valid: torch.Tensor,
                   route: Route = LOCAL
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residency only, across ``route``'s ranks: ids to their owners, tags
    compared, hit bits back; no rows, no counters, no state change. ->
    (hit, overflow) bool [n]; overflow (past a bucket's capacity) is
    reported apart from misses, since an insert at the owner cannot repair
    it."""
    ids = torch.where(valid, ids, torch.zeros_like(ids))
    G = route.n_route
    if G == 1:
        return fc.probe(cfg, local.base, ids, valid), torch.zeros_like(valid)
    c = lookup_bucket_cap(ids.shape[0], G, route.slack)
    owner, rank = _owner_rank(ids, valid, G)
    routed = rank < c
    req = route.a2a(_bucket(owner, rank, G, c, ids.to(torch.int32), -1),
                    "request").reshape(-1)
    hit = fc.probe(cfg, local.base, torch.where(req >= 0, req,
                                                torch.zeros_like(req)),
                   req >= 0)
    hit_back = route.a2a(hit.view(G, c), "hitbits")
    take = routed & valid
    return _gather_back(hit_back, owner, rank, take) & take, ~routed & valid


def exchange_fill(cfg: fc.CacheConfig, local: fc.ColoredCacheState,
                  ids: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
                  colors: torch.Tensor, route: Route = LOCAL,
                  fill_cap: int = 0) -> None:
    """Insert the rows of ``ids`` (int32 [m], invalid entries 0; ``valid``
    [m]) with their colors at their owners, in place: the third exchange
    (ids, rows in cfg.dtype, colors) over buckets of ``fill_cap`` slots
    per owner, then ``insert_with_colors`` of what arrived. Rows past a bucket are not
    inserted (the JAX fill drops them too). Collective over
    ``route.group`` when ``route.n_route > 1``."""
    G = route.n_route
    if G == 1:
        fc.insert_with_colors(cfg, local, ids, rows, valid, colors)
        return
    owner, rank = _owner_rank(ids, valid, G)
    rid = route.a2a(_bucket(owner, rank, G, fill_cap, ids.to(torch.int32),
                            -1), "fill").reshape(-1)
    rft = route.a2a(_bucket(owner, rank, G, fill_cap, rows.to(cfg.dtype), 0),
                    "fill").reshape(-1, cfg.dim)
    rcl = route.a2a(_bucket(owner, rank, G, fill_cap,
                            colors.to(torch.int32), 0), "fill").reshape(-1)
    ok = rid >= 0
    fc.insert_with_colors(cfg, local, torch.where(ok, rid,
                                                  torch.zeros_like(rid)),
                          rft, ok, rcl)


def repair_misses(cfg: fc.CacheConfig, local: fc.ColoredCacheState,
                  feats: torch.Tensor, dids: torch.Tensor, ids: np.ndarray,
                  need: np.ndarray, host_fetch: Callable,
                  colors: Optional[np.ndarray] = None, fill: bool = True,
                  timers=None, route: Route = LOCAL,
                  m_cap: int = 0) -> torch.Tensor:
    """One rank's miss path (JAX's ``_miss_kernels`` merge and
    ``_fill_local``): gather the rows of the ``need``ed slots (bool
    [n_req]) of request ``ids`` (int [n_req], host) from the host tier,
    write them into a copy of ``feats`` [n_req, dim] at their positions,
    and (``fill``) insert them with their colors at their owners
    (``exchange_fill`` over ``route``). ``dids`` int32 [n_req] are the
    request ids on the device, invalid entries 0; the inserted ids are read
    from them. The lists are padded to ``m_cap`` (default: ``ceil_pow2``
    of this rank's miss count; over more than one rank, the ``ceil_pow2``
    of the largest count of any rank, so that the fill's buckets agree).
    ``timers`` (a ``PhaseTimers``) times the host gather as
    ``host_gather``. -> the repaired features."""
    pos = np.flatnonzero(need)
    m_cap = m_cap or ceil_pow2(pos.size)
    miss_ids = np.asarray(ids)[pos].astype(np.int64)
    positions = np.full(m_cap, -1, dtype=np.int32)
    positions[:pos.size] = pos
    rows = np.zeros((m_cap, cfg.dim), dtype=np.float32)
    miss_colors = np.zeros(m_cap, dtype=np.int32)
    with (timers.time("host_gather") if timers is not None
          else contextlib.nullcontext()):
        rows[:pos.size] = host_fetch(miss_ids)
    if colors is not None:
        miss_colors[:pos.size] = colors[miss_ids]
    device = feats.device
    dpos = torch.from_numpy(positions).to(device)
    drows = torch.from_numpy(rows).to(device).to(cfg.dtype)
    feats = feats.clone()
    feats[dpos[:pos.size].long()] = drows[:pos.size]
    if fill:
        pvalid = dpos >= 0
        fill_ids = torch.where(pvalid, dids[dpos.clamp_min(0).long()],
                               torch.zeros_like(dpos))
        exchange_fill(cfg, local, fill_ids, drows, pvalid,
                      torch.from_numpy(miss_colors).to(device), route,
                      fill_bucket_cap(m_cap, route.n_route, route.slack))
    return feats


class FetchHandle(NamedTuple):
    """A probe in flight (``fetch_begin`` / ``fetch_begin_packed``)."""
    ids: np.ndarray            # int32 [n_local, n_req] request ids (host)
    num_valid: np.ndarray      # int32 [n_local]
    dids: torch.Tensor         # int32 [n_req] the ids on the device,
                               # invalid entries -> 0
    feats: torch.Tensor        # [n_local, n_req, dim] cfg.dtype, misses 0
    hit: torch.Tensor          # bool [n_local, n_req]
    n_miss: torch.Tensor       # int32 [1] valid slots missed or overflowed
                               # (over more ranks: the largest such count)
    n_miss_host: torch.Tensor  # its pinned host copy, filled by the event
    event: Optional["torch.cuda.Event"]
    sentinel: int              # > 0: ids equal to it are invalid
    overflow: Optional[torch.Tensor] = None   # bool [n_local, n_req]

    def miss_count(self) -> int:
        """The miss count on the host; waits for its copy only."""
        if self.event is not None:
            self.event.synchronize()
        return int(self.n_miss_host)


class ShardedFeatureCache:
    """The set-associative device cache in front of the host tier, spread
    over the ranks of ``devices`` (a ``Mesh``, or a list of one device: a
    card on its own). ``mode``: one of ``MODES``. ``group_size``:
    node_local's block of ranks (default: the mesh's ranks per host; it
    must divide the world). ``bucket_slack`` sizes the exchange's buckets.
    Every rank of the mesh builds the cache and calls its methods in the
    same order: they are collective (but for "isolated", whose only
    collective is ``stats``)."""

    def __init__(self, cfg: fc.CacheConfig, devices, mode: str = "sharded",
                 bucket_slack: float = 2.0, group_size: int = 0):
        if mode not in MODES:
            raise ValueError(f"unknown cache mode {mode!r}")
        mesh = as_mesh(devices)
        self.cfg = cfg
        self.mode = mode
        self.mesh = mesh
        self.device = mesh.device
        n_route, group = 1, None
        if mode == "node_local" and mesh.world > 1:
            n_route = group_size or mesh.local_size
            if mesh.world % n_route:
                raise ValueError(f"node_local group_size {n_route} must "
                                 f"divide the world of {mesh.world}")
            group = mesh.block_group(n_route) if n_route > 1 else None
        elif mode == "sharded":
            n_route, group = mesh.world, mesh.group
        self.route = Route(mesh, n_route, group, bucket_slack)
        self.n_route = n_route
        self.n_local = 1
        # every rank takes the miss path when any rank missed (the JAX
        # class's replicated counters); isolated ranks decide alone
        self._agree = mesh.distributed and mode != "isolated"
        self.state = fc.init_colored_state(cfg, self.device)

    def _check_local(self, arr: np.ndarray) -> None:
        if np.ndim(arr) and np.shape(arr)[0] != self.n_local:
            raise ValueError(
                f"expected per-local-device leading dim {self.n_local}, got "
                f"{np.shape(arr)}")

    def _probe(self, ids: np.ndarray, num_valid: np.ndarray,
               dids: torch.Tensor, valid: torch.Tensor,
               sentinel: int) -> FetchHandle:
        safe = torch.where(valid, dids, torch.zeros_like(dids))
        if self.n_route == 1:
            # the rank's own shard: the one-card lookup, nothing overflows
            _, feats, hit = fc.lookup(self.cfg, self.state.base, safe, valid)
            overflow = torch.zeros_like(valid)
            n_miss = (valid & ~hit).sum(dtype=torch.int32)[None]
        else:
            _, feats, hit, overflow = exchange_lookup(
                self.cfg, self.state, safe, valid, route=self.route)
            n_miss = (valid & (~hit | overflow)).sum(dtype=torch.int32)[None]
        if self._agree:
            self.mesh.all_reduce(n_miss, dist.ReduceOp.MAX)
        host, ev = start_readback(n_miss)
        return FetchHandle(ids, num_valid, safe, feats[None], hit[None],
                           n_miss, host, ev, sentinel, overflow[None])

    def fetch_begin(self, ids: np.ndarray,
                    num_valid: np.ndarray) -> FetchHandle:
        """Upload a request (``ids`` int32 [n_local, n_req], valid prefix
        ``num_valid`` [n_local]) and dispatch its probe without blocking;
        resolve it with ``fetch_complete``."""
        ids = np.ascontiguousarray(ids, dtype=np.int32)
        num_valid = np.asarray(num_valid, np.int32)
        self._check_local(ids)
        self._check_local(num_valid)
        dids = torch.from_numpy(ids[0]).to(self.device)
        valid = torch.arange(ids.shape[1], device=self.device) < \
            int(num_valid[0])
        return self._probe(ids, num_valid, dids, valid, 0)

    def fetch_begin_packed(self, ids_np: np.ndarray, num_valid: np.ndarray,
                           dbuf: torch.Tensor, n_req: int,
                           sentinel: int = 0) -> FetchHandle:
        """``fetch_begin`` reading the request out of a request buffer
        already on the device (``dbuf`` int32 [n_local, L],
        ``data/packing.pack_request``): ids ``dbuf[:, 1:1 + n_req]``, the
        valid count ``dbuf[:, 0]`` read on the device. ``sentinel > 0``:
        the contiguous convention (``pack_request_contig``), where entries
        equal to ``sentinel`` are invalid wherever they sit."""
        ids_np = np.ascontiguousarray(ids_np, np.int32)
        num_valid = np.asarray(num_valid, np.int32)
        self._check_local(ids_np)
        if dbuf.dim() != 2 or dbuf.shape[0] != self.n_local or \
                dbuf.device != self.device:
            raise ValueError(f"dbuf must be [{self.n_local}, L] on "
                             f"{self.device}, got {tuple(dbuf.shape)} on "
                             f"{dbuf.device}")
        buf = dbuf[0]
        dids = buf[1:1 + n_req]
        if sentinel > 0:
            valid = dids != sentinel
        else:
            valid = torch.arange(n_req, device=self.device) < buf[0]
        return self._probe(ids_np, num_valid, dids, valid, sentinel)

    def fetch_complete(self, handle: FetchHandle, host_fetch,
                       colors: Optional[np.ndarray] = None,
                       fill: bool = True) -> torch.Tensor:
        """Resolve a probe: gather its misses and overflows from the host
        tier, merge them into the features and (``fill``) insert them at
        their owners. Returns feats [n_local, n_req, dim]. No miss on any
        rank: the probe's features as they are, after reading only the
        miss count."""
        n_miss = handle.miss_count()
        if n_miss == 0:
            return handle.feats
        ids = handle.ids
        n_req = ids.shape[1]
        need = ~handle.hit.cpu().numpy()
        if self.n_route > 1:
            need |= handle.overflow.cpu().numpy()
        if handle.sentinel > 0:
            valid = ids != handle.sentinel
        else:
            valid = np.arange(n_req)[None, :] < handle.num_valid[:, None]
        need &= valid
        return repair_misses(self.cfg, self.state, handle.feats[0],
                             handle.dids, ids[0], need[0], host_fetch,
                             colors, fill, route=self.route,
                             m_cap=ceil_pow2(n_miss) if self._agree
                             else 0)[None]

    def fetch(self, ids: np.ndarray, num_valid: np.ndarray, host_fetch,
              colors: Optional[np.ndarray] = None,
              fill: bool = True) -> torch.Tensor:
        """``fetch_begin`` + ``fetch_complete`` back to back: ids int32
        [n_local, n_req], num_valid [n_local], host_fetch(int64 [m]) -> f32
        [m, dim], colors [num_nodes] node -> color. -> feats [n_local,
        n_req, dim]."""
        return self.fetch_complete(self.fetch_begin(ids, num_valid),
                                   host_fetch, colors=colors, fill=fill)

    def owned(self, ids: np.ndarray) -> np.ndarray:
        """bool, per entry of ``ids`` (negative entries never): the ids this
        rank inserts, its own (id % n_route == its place in its group) over
        more than one rank, else all of them. The resident trainer offers
        its union stage through ``insert_rows``, which inserts these."""
        ids = np.asarray(ids)
        if self.n_route > 1:
            mod = self.n_route
            return (ids >= 0) & (ids % mod == self.mesh.rank % mod)
        return ids >= 0

    def _owned(self, ids: np.ndarray, chunk: int):
        """(positions in ``ids`` that this rank inserts, chunks every rank
        runs): ``owned``; the chunk count is the largest owner's, the same
        on every rank."""
        mine = np.flatnonzero(self.owned(ids))
        if self.n_route > 1:
            mod = self.n_route
            counts = (np.bincount(ids % mod, minlength=mod) if ids.size
                      else np.zeros(mod, np.int64))
            return mine, max(1, int(-(-counts.max() // chunk)))
        return mine, max(1, -(-ids.size // chunk))

    def _insert_chunk(self, ids: np.ndarray, rows: Optional[np.ndarray],
                      colors: Optional[np.ndarray], chunk: int) -> None:
        """One insert of ``chunk`` rows, the tail padded invalid (id -1),
        as the JAX insert kernel takes them."""
        grid = np.full(chunk, -1, dtype=np.int32)
        rbuf = np.zeros((chunk, self.cfg.dim), dtype=np.float32)
        cbuf = np.zeros(chunk, dtype=np.int32)
        grid[:ids.size] = ids
        if ids.size:
            rbuf[:ids.size] = rows
            if colors is not None:
                cbuf[:ids.size] = colors
        dgrid = torch.from_numpy(grid).to(self.device)
        ok = dgrid >= 0
        fc.insert_with_colors(
            self.cfg, self.state, torch.where(ok, dgrid, torch.zeros_like(
                dgrid)), torch.from_numpy(rbuf).to(self.device).to(
                self.cfg.dtype), ok, torch.from_numpy(cbuf).to(self.device))

    def prewarm(self, ids: np.ndarray, host_fetch,
                colors: Optional[np.ndarray] = None,
                chunk: int = 16384) -> None:
        """Insert the rows of ``ids`` (deduplicated; the same list on every
        rank), each at its owner, in chunks; ``colors`` [num_nodes] node ->
        color. No collective: each rank inserts its own part."""
        ids = np.unique(np.asarray(ids, dtype=np.int32).reshape(-1))
        mine, n_chunks = self._owned(ids, chunk)
        for c in range(n_chunks):
            part = ids[mine[c * chunk:(c + 1) * chunk]]
            rows = host_fetch(part.astype(np.int64)) if part.size else None
            self._insert_chunk(part, rows,
                               None if colors is None else colors[part],
                               chunk)

    def insert_rows(self, ids: np.ndarray, rows: np.ndarray,
                    colors: Optional[np.ndarray] = None,
                    chunk: int = 16384) -> None:
        """``prewarm`` with the rows in hand: ``rows`` [n, dim] and
        ``colors`` int32 [n] aligned with ``ids`` (not per node id); each
        row is inserted at its owner (``owned``), so only the owner's rows
        are read. (The JAX method's ``return_evicted`` serves only the
        overlapped staged schedule, ``stage_overlap``: ROADMAP.md queue A,
        "the staged miss path: fused lookup / overlay, and what stays".)"""
        ids = np.asarray(ids, dtype=np.int32).reshape(-1)
        rows = np.asarray(rows)
        mine, n_chunks = self._owned(ids, chunk)
        for c in range(n_chunks):
            sel = mine[c * chunk:(c + 1) * chunk]
            self._insert_chunk(ids[sel], rows[sel],
                               None if colors is None else colors[sel],
                               chunk)

    def prewarm_by_degree(self, graph, host_fetch,
                          colors: Optional[np.ndarray] = None,
                          chunk: int = 16384) -> int:
        """Prewarm the highest in-degree nodes, up to the capacity of the
        ranks that share the id space; returns how many were admitted."""
        deg = np.diff(np.asarray(graph.indptr))
        n_warm = min(graph.num_nodes, self.cfg.capacity * self.n_route)
        top = np.argpartition(deg, -n_warm)[-n_warm:].astype(np.int32)
        self.prewarm(top, host_fetch, colors=colors, chunk=chunk)
        return int(n_warm)

    def color_meta(self) -> np.ndarray:
        """This rank's color-occupancy counters, int32 [num_colors + 1]."""
        return self.state.base.color_counts.cpu().numpy().astype(np.int32)

    def local_color_meta(self) -> np.ndarray:
        """This rank's share of its host's color counters (the per-node
        half of the meta exchange; ``multihost.make_meta_exchange_fn``
        sums a host's ranks)."""
        return self.color_meta()

    def stats(self) -> dict:
        """Hit and miss counters of the probes since the last call, summed
        over the ranks (one ``all_reduce``: collective), reset on read."""
        base = self.state.base
        hm = torch.stack([base.hits, base.misses])
        if self.mesh.distributed:
            self.mesh.all_reduce(hm)
        h, m = (int(v) for v in hm.tolist())
        base.hits.zero_()
        base.misses.zero_()
        return {"hits": h, "misses": m,
                "hit_ratio": h / (h + m) if h + m else 0.0}
