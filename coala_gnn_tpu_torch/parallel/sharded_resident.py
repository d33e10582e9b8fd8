"""Device-resident training through the cache front, on one device (port
of coala_gnn_tpu/parallel/sharded_resident.py: ``ShardedResidentTrainer``).

The trainer behind the CLI's ``--pipeline resident``. JAX runs it even on
one device, where its exchange is the local lookup (``exchange_lookup`` /
``exchange_probe`` of ``parallel/sharded_cache.py``) and no bucket ever
overflows. Per step the host uploads the seed grid [1, B] that the
distributor chose; the device samples, looks the frontier up in the
caller's set-associative cache and trains; the host sees only the miss
rows.

It shares ``ResidentTrainer``'s machinery (``parallel/resident.py``,
``ResidentBase``: sampling, probe, stage, the fused window, the replay net
and the serial staged schedule ``window(w) -> offer(stage w) ->
probe(w+1)`` of ``train_windows``) and keeps the JAX trainer's
differences from it:
  - the cache is the caller's ``ShardedFeatureCache``, never a flat table;
    its state is updated in place;
  - ``full_coverage`` is False unless the caller sets it (after a prewarm
    of every node): windows then run on the lookup alone, with the replay
    net behind them; otherwise every window is staged;
  - no priorities; a window's stage is offered through
    ``cache.insert_rows``, with the f32 rows gathered on the host;
  - the per-step ``resolve`` repairs misses through the cache front's own
    miss path (``sharded_cache.repair_misses``);
  - ``train_step`` takes a ``valid`` mask for the masked mean of an
    epoch's wrapped tail step;
  - the hetero models train here: on a typed graph the blocks are
    ``DeviceHeteroBlock``s and layer 0 takes the frontier's features as
    they are (SAGE, GCN and GAT read them through the gather-SpMM kernel
    at their slot positions, ``TableInput``).

Where the JAX trainer carries ``(params, opt_state)`` and splits keys, this
one updates ``model``, ``optimizer`` and the cache in place and takes a
``torch.Generator`` per step and stream (``utils/rng.py``), as
``ResidentTrainer`` does. JAX's ``_prefetch_window`` (a presample prewarm
before an unstaged window) has no counterpart: ``train_windows`` reaches it
only through ``_dispatch_window`` without full coverage, and it stages
those windows instead.

``nbr_cap=P`` samples from the padded neighbour table (with its relation
table on a typed graph), as JAX's does; with ``shard_topology`` it raises
JAX's ``ValueError``. Not ported yet, each raising
``NotImplementedError`` that names its ROADMAP.md item: ``shard_topology``
(and a cache over more than one device) and ``stage_overlap``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from coala_gnn_tpu_torch.parallel.resident import ResidentBase
from coala_gnn_tpu_torch.parallel.sharded_cache import (
    ShardedFeatureCache, exchange_lookup, exchange_probe, repair_misses,
    start_readback)
from coala_gnn_tpu_torch.parallel.train import _learn


class StepHandle(NamedTuple):
    """One step in flight, from ``begin`` to ``resolve``."""

    blocks: List                 # DeviceBlock / DeviceHeteroBlock per layer
    ids: torch.Tensor            # int32 [cap0] frontier ids (sentinel pads)
    valid: torch.Tensor          # bool [cap0]
    feats: torch.Tensor          # [cap0, dim] cfg.dtype, misses zero
    hit: torch.Tensor            # bool [cap0]
    n_miss: Tuple                # (pinned host int32 [], CUDA event or None)
    labels: torch.Tensor         # int64 [B]

    def miss_count(self) -> int:
        """The step's miss count; waits for its copy only."""
        host, ev = self.n_miss
        if ev is not None:
            ev.synchronize()
        return int(host)


def _one_device(grid, tail: int) -> np.ndarray:
    """``grid`` with its leading device axis (one device) dropped; the last
    ``tail`` axes are the grid itself. A grid without the device axis
    passes as it is."""
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
    cache: ShardedFeatureCache           # the one-device cache front
    model: nn.Module                     # on the cache's device
    optimizer: torch.optim.Optimizer     # over ``model``'s parameters
    fanouts: Sequence[int]
    batch_size: int
    colors: Optional[np.ndarray] = None  # int [num_nodes] for color counts
    shard_topology: bool = False
    nbr_cap: Optional[int] = None        # padded neighbour table of P
                                         # slots per node, P >= max fanout
    stage_transport: str = "auto"        # float32 | bfloat16 | int8; auto =
                                         # int8 for int8 lines, else float32
    stage_admit: bool = True             # offer staged rows to the cache
                                         # after each window
    stage_overlap: bool = False

    _offer_host_rows = True

    def __post_init__(self):
        if self.shard_topology and self.nbr_cap is not None:
            raise ValueError("nbr_cap (padded neighbor table) does not "
                             "combine with shard_topology — the table "
                             "layout is single-replica")
        if self.cache.mesh.world > 1:
            raise NotImplementedError(
                f"the resident pipeline over {self.cache.mesh.world} ranks "
                "is not ported yet: ROADMAP.md queue A, \"multi-GPU\"")
        if self.shard_topology:
            raise NotImplementedError(
                "shard_topology is not ported yet: ROADMAP.md queue A, "
                "\"multi-GPU\"")
        if self.stage_overlap:
            raise NotImplementedError(
                "stage_overlap on ShardedResidentTrainer is not ported: "
                "ROADMAP.md queue A, \"the staged miss path: fused lookup "
                "/ overlay, and what stays\"")
        self.device = self.cache.device
        self.cache_cfg = self.cache.cfg
        self.direct = False
        self._use_prio = False
        self.priorities = None
        self._setup()

    # ---- the cache front -------------------------------------------------
    def _eng_lookup(self, ids: torch.Tensor, valid: torch.Tensor,
                    count_stats: bool = True):
        _, feats, hit, _ = exchange_lookup(self.cache_cfg, self.cache.state,
                                           ids, valid, count_stats)
        return feats, hit

    def _eng_probe(self, ids: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
        return exchange_probe(self.cache_cfg, self.cache.state, ids,
                              valid)[0]

    def _offer_stage(self, stage) -> None:
        """Insert a window's staged rows into the cache
        (``cache.insert_rows``, the reference's miss insert; correctness
        never depends on it), from the f32 rows the stage gathered."""
        mids, rows, offer = stage[6]
        mids = mids[offer]
        if mids.size:
            self.cache.insert_rows(
                mids, rows[offer],
                None if self.colors is None
                else np.asarray(self.colors, np.int32)[mids])

    # ---- per-step path -----------------------------------------------------
    def begin(self, seed_grid, generator: torch.Generator) -> StepHandle:
        """Sample and look up one step: ``seed_grid`` int [1, B], this
        device's seeds from the distributor; ``generator`` the step's
        sampling stream. The lookup counts hits and misses on the device,
        and the miss count's copy to the host starts without a wait."""
        seeds = torch.as_tensor(_one_device(seed_grid, 1)).to(self.device)
        blocks, ids, valid, safe = self._sample(seeds, generator)
        _, feats, hit, overflow = exchange_lookup(
            self.cache_cfg, self.cache.state, safe, valid)
        n_miss = (valid & (~hit | overflow)).sum(dtype=torch.int32)
        return StepHandle(blocks, ids, valid, feats, hit,
                          start_readback(n_miss), self.labels_dev[seeds])

    def resolve(self, handle: StepHandle) -> tuple:
        """(blocks, feats, labels), the misses gathered from the host tier,
        merged into feats and inserted into the cache. All hits: only the
        miss count is read."""
        if handle.miss_count() == 0:
            return handle.blocks, handle.feats, handle.labels
        valid = handle.valid
        safe = torch.where(valid, handle.ids, torch.zeros_like(handle.ids))
        feats = repair_misses(
            self.cache_cfg, self.cache.state, handle.feats, safe,
            handle.ids.cpu().numpy(), (valid & ~handle.hit).cpu().numpy(),
            self.host_fetch, self.colors, timers=self.timers)
        return handle.blocks, feats, handle.labels

    def _weights(self, valid) -> Optional[torch.Tensor]:
        if valid is None:
            return None
        return torch.as_tensor(_one_device(valid, 1)).to(self.device).float()

    def train_step(self, resolved, generator: Optional[torch.Generator],
                   valid=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update -> (loss, accuracy) on the device. ``valid`` (bool
        [1, B]) switches to the masked mean: sum(ce * valid) /
        max(sum(valid), 1), so the wrapped duplicates of an epoch's tail
        add no loss and no gradient."""
        blocks, feats, y = resolved
        return _learn(self.model, self.optimizer, blocks,
                      self._layer0(feats), y, self.batch_size, generator,
                      self._weights(valid))

    def eval_step(self, resolved, valid=None) -> int:
        """Correct predictions among the seeds, only the ``valid`` slots
        (bool [1, B]) where given."""
        blocks, feats, y = resolved
        with torch.no_grad():
            logits = self.model(blocks, self._layer0(feats),
                                train=False)[:self.batch_size]
        ok = (logits.argmax(-1) == y).float()
        w = self._weights(valid)
        return int(ok.sum() if w is None else (ok * w).sum())

    # ---- fused windows -------------------------------------------------------
    def train_windows(self, seeds_grids: np.ndarray, seed: int,
                      first_window: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """M windows of K steps, seeds_grids int [M, 1, K, B] (JAX's
        [M, n_dev, K, B] at one device); window w draws from the streams
        (seed, first_window + w, step). -> (losses [M*K], edges [M*K])."""
        grids = np.asarray(seeds_grids, np.int32)
        if grids.ndim != 4 or grids.shape[1] != 1:
            raise ValueError(f"seeds_grids [M, 1, K, B], got {grids.shape}")
        return super().train_windows(grids[:, 0], seed, first_window)

    def stats(self) -> dict:
        """The cache's counters (per-step path) and the windows', reset on
        read."""
        s = self.cache.stats()
        h, m = s["hits"] + self.hits, s["misses"] + self.misses
        self.hits = self.misses = 0
        return {"hits": h, "misses": m,
                "hit_ratio": h / (h + m) if (h + m) else 0.0}
