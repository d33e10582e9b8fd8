"""Device-resident training through the cache front, on one card or over
the ranks of a ``Mesh`` (port of coala_gnn_tpu/parallel/sharded_resident.py:
``ShardedResidentTrainer``).

The trainer behind the CLI's ``--pipeline resident``, COALA's own
setting: every rank samples its own seed slice on its card, looks its
frontier up in the cache spread over the ranks (the two-phase exchange of
``parallel/sharded_cache.py`` over the cache's ``Route``: "sharded",
"node_local" or "isolated") and trains data-parallel
(``parallel/train._learn_sharded``: one gradient ``all_reduce`` a step).
Per step the host uploads this rank's seed grid [1, B] that the
distributor chose; the host sees only the miss rows. One process drives
one card; on one card (a ``Mesh`` of one rank) the exchange is the local
lookup and no collective runs.

It shares ``ResidentTrainer``'s machinery (``parallel/resident.py``,
``ResidentBase``: sampling, probe, stage, the fused window, the replay net
and both staged schedules of ``train_windows``, the serial ``window(w) ->
offer(stage w) -> probe(w+1)`` and, with ``stage_overlap``, ``probe(w+1)
-> window(w) -> offer(stage w), reporting what it evicted``, with its rank
hooks) and keeps the JAX trainer's differences from it:
  - the cache is the caller's ``ShardedFeatureCache``, never a flat table;
    its state is updated in place;
  - ``full_coverage`` is False unless the caller sets it (after a prewarm
    of every node): windows then run on the lookup alone, with the replay
    net behind them; otherwise every window is staged. Over more than one
    rank the probe's bitmaps are united (a MAX ``all_reduce``), so every
    rank gathers and uploads the same stage, the union, as every JAX
    process does; a slot past its exchange bucket (overflow) is not a
    hit, so the union stages it too and the window serves it from there;
  - no priorities; a window's stage is offered to the cache, each row
    inserted at its owner: an f32 stage from the card
    (``cache.insert_stage``), a bf16 or int8 stage, whose device rows are
    rounded, from the f32 rows read on the host (``cache.insert_rows``;
    only the rows this rank owns are read a second time, at f32); under
    ``stage_overlap`` the offer reports the ids it evicted,
    gathered from every rank (one ``all_gather``), so every rank patches
    the same rows into the next union stage;
  - the per-step ``resolve`` repairs misses through the cache front's own
    miss path (``sharded_cache.repair_misses``, the fill at the owners);
    whether any rank missed is one MAX ``all_reduce`` before the miss
    count is read, so every rank takes the same path;
  - ``train_step`` takes a ``valid`` mask for the masked mean of an
    epoch's wrapped tail step (the global masked mean over the ranks);
    ``eval_step`` returns the correct count summed over the ranks;
  - ``shard_topology`` keeps only this rank's shard of the topology on
    its card (``sampling/sharded_topology.py``; over one rank it is a
    no-op, as in JAX); ``nbr_cap=P`` samples from the replicated padded
    neighbour table (with its relation table on a typed graph), as JAX's
    does; the two together raise JAX's ``ValueError``;
  - the hetero models train here: on a typed graph the blocks are
    ``DeviceHeteroBlock``s and layer 0 takes the frontier's features as
    they are (SAGE, GCN and GAT read them through the gather-SpMM kernel
    at their slot positions, ``TableInput``).

Where the JAX trainer carries ``(params, opt_state)`` and splits keys, this
one updates ``model``, ``optimizer`` and the cache in place and takes a
``torch.Generator`` per step and stream (``utils/rng.py``), as
``ResidentTrainer`` does, a rank past 0 from streams of its own. JAX's
``_prefetch_window`` (a presample prewarm before an unstaged window) has
no counterpart: ``train_windows`` reaches it only through
``_dispatch_window`` without full coverage, and it stages those windows
instead. Every rank calls every method in the same order: they are
collective.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from coala_gnn_tpu_torch.parallel.resident import ResidentBase
from coala_gnn_tpu_torch.parallel.sharded_cache import (
    ShardedFeatureCache, exchange_lookup, exchange_probe, repair_misses,
    start_readback)
from coala_gnn_tpu_torch.parallel.sizing import ceil_pow2
from coala_gnn_tpu_torch.parallel.train import _learn, _learn_sharded
from coala_gnn_tpu_torch.sampling.sharded_topology import \
    put_sharded_topology


class StepHandle(NamedTuple):
    """One step in flight, from ``begin`` to ``resolve``."""

    blocks: List                 # DeviceBlock / DeviceHeteroBlock per layer
    ids: torch.Tensor            # int32 [cap0] frontier ids (sentinel pads)
    valid: torch.Tensor          # bool [cap0]
    feats: torch.Tensor          # [cap0, dim] cfg.dtype, misses zero
    hit: torch.Tensor            # bool [cap0]
    n_miss: Tuple                # (pinned host int32 [1], CUDA event or
                                 # None): the largest of any rank's where
                                 # the ranks agree
    labels: torch.Tensor         # int64 [B]

    def miss_count(self) -> int:
        """The step's miss count; waits for its copy only."""
        host, ev = self.n_miss
        if ev is not None:
            ev.synchronize()
        return int(host)


def _one_device(grid, tail: int) -> np.ndarray:
    """``grid`` with its leading device axis (this rank's one device)
    dropped; the last ``tail`` axes are the grid itself. A grid without the
    device axis passes as it is."""
    a = np.asarray(grid, np.int32)
    a = a.reshape((-1,) + a.shape[a.ndim - tail:])
    if a.shape[0] != 1:
        raise ValueError(f"a grid for one device, got shape "
                         f"{np.shape(grid)}")
    return a[0]


@dataclasses.dataclass
class ShardedResidentTrainer(ResidentBase):
    graph: object                        # host CSCGraph (typed or not)
    host_fetch: Callable                 # host tier fn(int64 ids) -> f32 rows
    labels: np.ndarray                   # [num_nodes]
    cache: ShardedFeatureCache           # the cache front over the ranks
    model: nn.Module                     # on the cache's device
    optimizer: torch.optim.Optimizer     # over ``model``'s parameters
    fanouts: Sequence[int]
    batch_size: int
    colors: Optional[np.ndarray] = None  # int [num_nodes] for color counts
    shard_topology: bool = False         # this rank's shard of the topology
                                         # only (over more than one rank)
    nbr_cap: Optional[int] = None        # padded neighbour table of P
                                         # slots per node, P >= max fanout
    stage_transport: str = "auto"        # float32 | bfloat16 | int8; auto =
                                         # int8 for int8 lines, else float32
    stage_admit: bool = True             # offer staged rows to the cache
                                         # after each window
    stage_overlap: bool = False          # overlapped staged schedule

    _offer_host_rows = True

    def __post_init__(self):
        if self.shard_topology and self.nbr_cap is not None:
            raise ValueError("nbr_cap (padded neighbor table) does not "
                             "combine with shard_topology — the table "
                             "layout is single-replica")
        self.mesh = self.cache.mesh
        self.route = self.cache.route
        self.device = self.cache.device
        self.cache_cfg = self.cache.cfg
        self.direct = False
        self._use_prio = False
        self.priorities = None
        self._setup()

    def _place_graph(self):
        """This rank's shard of the topology with ``shard_topology`` over
        more than one rank, else the replicated ``DeviceGraph``."""
        if self.shard_topology and self._multi:
            return put_sharded_topology(self.graph, self.mesh)
        return super()._place_graph()

    def _offered(self, gid: np.ndarray) -> np.ndarray:
        """The stage ids this rank's offer inserts: the ones it owns."""
        return np.where(self.cache.owned(gid), gid, -1)

    def _learn(self, blocks, x, y: torch.Tensor,
               generator: torch.Generator):
        """A window's step: ``ResidentBase``'s on one card, the
        data-parallel step in a process group (its loss the global mean).
        -> (loss, accuracy or logits), the first detached."""
        if not self.mesh.distributed:
            return super()._learn(blocks, x, y, generator)
        return _learn_sharded(self.mesh, self.model, self.optimizer, blocks,
                              x, y, self.batch_size, generator)

    # ---- the cache front -------------------------------------------------
    def _eng_lookup(self, ids: torch.Tensor, valid: torch.Tensor,
                    count_stats: bool = True):
        """(feats, hit): a slot past its exchange bucket is no hit."""
        _, feats, hit, _ = exchange_lookup(self.cache_cfg, self.cache.state,
                                           ids, valid, count_stats,
                                           self.route)
        return feats, hit

    def _eng_probe(self, ids: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
        return exchange_probe(self.cache_cfg, self.cache.state, ids,
                              valid, self.route)[0]

    def _offer_stage(self, stage, return_evicted: bool = False
                     ) -> Optional[torch.Tensor]:
        """Insert a window's staged rows into the cache (the reference's
        miss insert; correctness never depends on it). Under the f32
        transport the device stage holds the f32 rows bitwise, so they are
        inserted from there (``cache.insert_stage``: the host selects the
        positions from the stage's ids, no row crosses the host link);
        under bf16 or int8 from the f32 rows the stage read on the host
        (``cache.insert_rows``). Patch rows (``offer`` False) are not
        offered. ``return_evicted``: the evicted ids, gathered from every
        rank; None when nothing is offered (every rank alike: the stage is
        the union). The host's selection of the offered rows is a span
        ``insert.pack``, as each chunk's packing in ``insert_rows`` is."""
        mids, rows, offer = stage[6]
        if not offer.any():
            return None
        if self.stage_transport == "float32":
            return self.cache.insert_stage(
                mids, offer, stage[0], stage[1], stage[3], self._scratch,
                return_evicted=return_evicted, timers=self.timers)
        with self.timers.time("insert.pack"):
            mids, rows = mids[offer], rows[offer]
            colors = (None if self.colors is None
                      else np.asarray(self.colors, np.int32)[mids])
        return self.cache.insert_rows(mids, rows, colors,
                                      return_evicted=return_evicted,
                                      timers=self.timers)

    # ---- per-step path -----------------------------------------------------
    def begin(self, seed_grid, generator: torch.Generator) -> StepHandle:
        """Sample and look up one step: ``seed_grid`` int [1, B], this
        rank's seeds from the distributor; ``generator`` the step's
        sampling stream (this rank's). The owners count hits and misses on
        their cards; the miss count (valid slots missed or past their
        bucket; over the ranks that share the cache, the largest of any
        rank's, one MAX ``all_reduce``) starts its copy to the host
        without a wait."""
        seeds = torch.as_tensor(_one_device(seed_grid, 1)).to(self.device)
        blocks, ids, valid, safe = self._sample(seeds, generator)
        _, feats, hit, overflow = exchange_lookup(
            self.cache_cfg, self.cache.state, safe, valid, route=self.route)
        n_miss = (valid & (~hit | overflow)).sum(dtype=torch.int32)[None]
        if self.cache._agree:
            self.mesh.all_reduce(n_miss, dist.ReduceOp.MAX)
        return StepHandle(blocks, ids, valid, feats, hit,
                          start_readback(n_miss), self.labels_dev[seeds])

    def resolve(self, handle: StepHandle) -> tuple:
        """(blocks, feats, labels), the misses gathered from the host tier,
        merged into feats and inserted at their owners (a collective fill
        over the ranks that share the cache, its buckets sized from the
        largest miss count). No miss on any rank: only the miss count is
        read."""
        n_miss = handle.miss_count()
        if n_miss == 0:
            return handle.blocks, handle.feats, handle.labels
        valid = handle.valid
        safe = torch.where(valid, handle.ids, torch.zeros_like(handle.ids))
        feats = repair_misses(
            self.cache_cfg, self.cache.state, handle.feats, safe,
            handle.ids.cpu().numpy(), (valid & ~handle.hit).cpu().numpy(),
            self.host_fetch, self.colors, timers=self.timers,
            route=self.route,
            m_cap=ceil_pow2(n_miss) if self.cache._agree else 0)
        return handle.blocks, feats, handle.labels

    def _weights(self, valid) -> Optional[torch.Tensor]:
        if valid is None:
            return None
        return torch.as_tensor(_one_device(valid, 1)).to(self.device).float()

    def train_step(self, resolved, generator: Optional[torch.Generator],
                   valid=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update -> (loss, accuracy) on the device, both over every
        rank in a process group (the data-parallel step). ``valid`` (bool
        [1, B], this rank's) switches to the masked mean: sum(ce * valid) /
        max(sum(valid), 1) over the ranks, so the wrapped duplicates of an
        epoch's tail add no loss and no gradient."""
        blocks, feats, y = resolved
        learn = _learn if not self.mesh.distributed else \
            (lambda *a: _learn_sharded(self.mesh, *a))
        return learn(self.model, self.optimizer, blocks,
                     self._layer0(feats), y, self.batch_size, generator,
                     self._weights(valid))

    def eval_step(self, resolved, valid=None) -> int:
        """Correct predictions among the seeds, only the ``valid`` slots
        (bool [1, B], this rank's) where given, summed over the ranks (one
        ``all_reduce`` in a process group)."""
        blocks, feats, y = resolved
        with torch.no_grad():
            logits = self.model(blocks, self._layer0(feats),
                                train=False)[:self.batch_size]
        ok = (logits.argmax(-1) == y).float()
        w = self._weights(valid)
        n = (ok.sum() if w is None else (ok * w).sum()).reshape(1)
        if self.mesh.distributed:
            self.mesh.all_reduce(n)
        return int(n[0])

    # ---- fused windows -------------------------------------------------------
    def train_windows(self, seeds_grids: np.ndarray, seed: int,
                      first_window: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """M windows of K steps, seeds_grids int [M, 1, K, B] (this rank's
        slice of JAX's [M, n_dev, K, B]); window w draws from this rank's
        streams (seed, first_window + w, step). -> (losses [M*K], edges
        [M*K]), both over every rank: the losses the global means, the
        edges summed."""
        grids = np.asarray(seeds_grids, np.int32)
        if grids.ndim != 4 or grids.shape[1] != 1:
            raise ValueError(f"seeds_grids [M, 1, K, B], got {grids.shape}")
        return super().train_windows(grids[:, 0], seed, first_window)

    def stats(self) -> dict:
        """The cache's counters (per-step path) and the windows', each
        summed over the ranks, reset on read (collective)."""
        s = self.cache.stats()
        h, m = s["hits"] + self.hits, s["misses"] + self.misses
        self.hits = self.misses = 0
        return {"hits": h, "misses": m,
                "hit_ratio": h / (h + m) if (h + m) else 0.0}
