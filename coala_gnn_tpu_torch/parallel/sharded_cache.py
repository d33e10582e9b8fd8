"""The feature cache front of the host pipeline, on one device (port of
``coala_gnn_tpu/parallel/sharded_cache.py``: ``ShardedFeatureCache``).

On one device every mode of the JAX class ("sharded", "isolated",
"node_local") routes to the device itself: a lookup is
``feature_cache.lookup``, a residency check ``feature_cache.probe`` and a
fill ``feature_cache.insert_with_colors`` on the device's own
set-associative state, with no exchange. The public API keeps the JAX
class's leading ``[n_local, ...]`` axis (here 1), so a ``HostBatch``
passes through unchanged. More than one device raises: the exchange over
``all_to_all``, the owner hash and the bucket sizes come with multi-GPU
(ROADMAP.md queue A, "multi-GPU").

The miss path is the JAX class's: a probe (``fetch_begin``, or
``fetch_begin_packed`` reading the ids out of the step's request buffer
already on the device), then ``fetch_complete``, which gathers the misses
from the host tier, merges them into the probe's features and inserts
them (``repair_misses``), with the miss list padded to ``ceil_pow2`` of
the miss count as JAX pads it, so the cache state stays bitwise JAX's.
The miss count streams back without a sync: a pinned host scalar filled
by a ``non_blocking`` copy and fenced by a CUDA event (JAX's
``copy_to_host_async``); only the all-hit check reads it. The state is
updated in place.

The module functions ``exchange_lookup`` and ``exchange_probe`` are the
JAX functions at one device, where they are the local lookup and probe
with no bucket overflow; ``parallel/sharded_resident.py`` calls them and
``repair_misses``.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from coala_gnn_tpu_torch.cache import feature_cache as fc
from coala_gnn_tpu_torch.parallel.sizing import ceil_pow2

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


def exchange_lookup(cfg: fc.CacheConfig, local: fc.ColoredCacheState,
                    ids: torch.Tensor, valid: torch.Tensor,
                    count_stats: bool = True
                    ) -> Tuple[fc.ColoredCacheState, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """The JAX function at one device (its mesh arguments dropped): the
    local lookup on ``local.base``. -> (local, feats [n, dim] in
    cfg.dtype, hit bool [n], overflow bool [n], all false: a device's only
    bucket holds its whole request). ``count_stats=False`` leaves the
    counters alone, as JAX's windows do by dropping the state the lookup
    returns."""
    ids = torch.where(valid, ids, torch.zeros_like(ids))
    _, feats, hit = fc.lookup(cfg, local.base, ids, valid,
                              count_stats=count_stats)
    return local, feats, hit, torch.zeros_like(valid)


def exchange_probe(cfg: fc.CacheConfig, local: fc.ColoredCacheState,
                   ids: torch.Tensor, valid: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residency only, the JAX function at one device: (hit, overflow)
    bool [n], overflow all false; no counters, no state change."""
    ids = torch.where(valid, ids, torch.zeros_like(ids))
    return fc.probe(cfg, local.base, ids, valid), torch.zeros_like(valid)


def repair_misses(cfg: fc.CacheConfig, local: fc.ColoredCacheState,
                  feats: torch.Tensor, dids: torch.Tensor, ids: np.ndarray,
                  need: np.ndarray, host_fetch: Callable,
                  colors: Optional[np.ndarray] = None, fill: bool = True,
                  timers=None) -> torch.Tensor:
    """One device's miss path (JAX's ``_miss_kernels`` merge and, at one
    device, ``_fill_local``): gather the rows of the ``need``ed slots
    (bool [n_req]) of request ``ids`` (int [n_req], host) from the host
    tier, write them into a copy of ``feats`` [n_req, dim] at their
    positions, and (``fill``) insert them with their colors into
    ``local``, in place. ``dids`` int32 [n_req] are the request ids on the
    device, invalid entries 0; the inserted ids are read from them. The
    lists are padded to ``ceil_pow2`` of the miss count, as JAX pads
    them. ``timers`` (a ``PhaseTimers``) times the host gather as
    ``host_gather``. -> the repaired features."""
    pos = np.flatnonzero(need)
    m_cap = ceil_pow2(pos.size)
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
        fc.insert_with_colors(cfg, local, fill_ids, drows, pvalid,
                              torch.from_numpy(miss_colors).to(device))
    return feats


class FetchHandle(NamedTuple):
    """A probe in flight (``fetch_begin`` / ``fetch_begin_packed``)."""
    ids: np.ndarray            # int32 [n_local, n_req] request ids (host)
    num_valid: np.ndarray      # int32 [n_local]
    dids: torch.Tensor         # int32 [n_req] the ids on the device,
                               # invalid entries -> 0
    feats: torch.Tensor        # [n_local, n_req, dim] cfg.dtype, misses 0
    hit: torch.Tensor          # bool [n_local, n_req]
    n_miss: torch.Tensor       # int32 [] valid slots the cache missed
    n_miss_host: torch.Tensor  # its pinned host copy, filled by the event
    event: Optional["torch.cuda.Event"]
    sentinel: int              # > 0: ids equal to it are invalid

    def miss_count(self) -> int:
        """The miss count on the host; waits for its copy only."""
        if self.event is not None:
            self.event.synchronize()
        return int(self.n_miss_host)


class ShardedFeatureCache:
    """The set-associative device cache in front of the host tier.

    ``devices``: the devices the cache spans (the JAX class's mesh); one
    device only so far. ``mode``: one of ``MODES``; on one device all
    three are the device's private cache.
    """

    def __init__(self, cfg: fc.CacheConfig, devices: Sequence,
                 mode: str = "sharded"):
        if mode not in MODES:
            raise ValueError(f"unknown cache mode {mode!r}")
        if len(devices) != 1:
            raise NotImplementedError(
                f"a cache over {len(devices)} devices is not ported yet: "
                "ROADMAP.md queue A, \"multi-GPU\"")
        self.cfg = cfg
        self.mode = mode
        self.device = torch.device(devices[0])
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.n_route = 1
        self.n_local = 1
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
        _, feats, hit = fc.lookup(self.cfg, self.state.base, safe, valid)
        n_miss = (valid & ~hit).sum(dtype=torch.int32)
        host, ev = start_readback(n_miss)
        return FetchHandle(ids, num_valid, safe, feats[None], hit[None],
                           n_miss, host, ev, sentinel)

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
        """Resolve a probe: gather its misses from the host tier, merge them
        into the features and (``fill``) insert them into the cache.
        Returns feats [n_local, n_req, dim]. All hits: the probe's
        features as they are, after reading only the miss count."""
        n_miss = handle.miss_count()
        if n_miss == 0:
            return handle.feats
        ids = handle.ids
        n_req = ids.shape[1]
        hit = handle.hit.cpu().numpy()
        if handle.sentinel > 0:
            valid = ids != handle.sentinel
        else:
            valid = np.arange(n_req)[None, :] < handle.num_valid[:, None]
        need = valid & ~hit
        return repair_misses(self.cfg, self.state, handle.feats[0],
                             handle.dids, ids[0], need[0], host_fetch,
                             colors, fill)[None]

    def fetch(self, ids: np.ndarray, num_valid: np.ndarray, host_fetch,
              colors: Optional[np.ndarray] = None,
              fill: bool = True) -> torch.Tensor:
        """``fetch_begin`` + ``fetch_complete`` back to back: ids int32
        [n_local, n_req], num_valid [n_local], host_fetch(int64 [m]) -> f32
        [m, dim], colors [num_nodes] node -> color. -> feats [n_local,
        n_req, dim]."""
        return self.fetch_complete(self.fetch_begin(ids, num_valid),
                                   host_fetch, colors=colors, fill=fill)

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
        """Insert the rows of ``ids`` (deduplicated) from the host tier, in
        chunks; ``colors`` [num_nodes] node -> color."""
        ids = np.unique(np.asarray(ids, dtype=np.int32).reshape(-1))
        for c in range(max(1, -(-ids.size // chunk))):
            part = ids[c * chunk:(c + 1) * chunk]
            rows = host_fetch(part.astype(np.int64)) if part.size else None
            self._insert_chunk(part, rows,
                               None if colors is None else colors[part],
                               chunk)

    def insert_rows(self, ids: np.ndarray, rows: np.ndarray,
                    colors: Optional[np.ndarray] = None,
                    chunk: int = 16384) -> None:
        """``prewarm`` with the rows in hand: ``rows`` [n, dim] and
        ``colors`` int32 [n] aligned with ``ids`` (not per node id). (The
        JAX method's ``return_evicted`` serves the multi-device overlapped
        staged schedule; it comes with multi-GPU.)"""
        ids = np.asarray(ids, dtype=np.int32).reshape(-1)
        rows = np.asarray(rows)
        for c in range(max(1, -(-ids.size // chunk))):
            sl = slice(c * chunk, (c + 1) * chunk)
            self._insert_chunk(ids[sl], rows[sl],
                               None if colors is None else colors[sl], chunk)

    def prewarm_by_degree(self, graph, host_fetch,
                          colors: Optional[np.ndarray] = None,
                          chunk: int = 16384) -> int:
        """Prewarm the highest in-degree nodes, up to capacity; returns
        how many were admitted."""
        deg = np.diff(np.asarray(graph.indptr))
        n_warm = min(graph.num_nodes, self.cfg.capacity * self.n_route)
        top = np.argpartition(deg, -n_warm)[-n_warm:].astype(np.int32)
        self.prewarm(top, host_fetch, colors=colors, chunk=chunk)
        return int(n_warm)

    def color_meta(self) -> np.ndarray:
        """Color-occupancy counters, int32 [num_colors + 1], summed over
        this process's devices."""
        return self.state.base.color_counts.cpu().numpy().astype(np.int32)

    def local_color_meta(self) -> np.ndarray:
        """This host's color-occupancy counters (the per-node half of the
        meta exchange): on one device, ``color_meta``."""
        return self.color_meta()

    def stats(self) -> dict:
        """Hit and miss counters of the probes since the last call, reset
        on read."""
        return fc.stats(self.state.base)[1]
