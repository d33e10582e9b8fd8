"""Training data loader: distribution -> sampling -> one host batch per
iteration (port of ``coala_gnn_tpu/data/loader.py``, the same numpy
arrays for the same seeds).

A background worker prepares iteration i + 1's host work (distribution,
sampling, stacking) while the device trains iteration i. The loader
samples ``local_size`` device rows of its part's domain slice, from the
scheduler's ``local_rank`` on: with one process per card, one row, the
rank's own (``local_size`` 1), from the rank's own sampler. (The JAX
loader samples all of a host's devices from one sampler stream, in device
order, so rank r does not draw JAX's device-r draws; the ranks' streams
are ``utils/rng.rank_seed``'s, rank 0's the JAX loader's.) The worker is
host-only: it makes no CUDA call, so the device is driven by the caller's
thread alone. An epoch drops the tail batch unless the distributor keeps
it (``drop_tail=False``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, List, NamedTuple, Optional

import numpy as np

from coala_gnn_tpu_torch.distribution.scheduler import DistributionScheduler
from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler, SampledBatch


class HostBatch(NamedTuple):
    """Device-stacked host batch (numpy; leading axis = local device)."""
    adjs: Optional[List[np.ndarray]]   # per layer int32 [n_dev, cap_dst,
                                       # fanout]; None in the contiguous
                                       # layout (adjacency implicit)
    masks: Optional[List[np.ndarray]]  # per layer float32 [n_dev, cap_dst,
                                       # fanout]; None in the contiguous
                                       # layout (masks follow from the ids)
    input_ids: np.ndarray      # int64 [n_dev, cap_src0]
    num_input: np.ndarray      # int32 [n_dev]
    seeds: np.ndarray          # int64 [n_dev, batch]
    labels: np.ndarray         # int32 [n_dev, batch]
    sampled_nodes: int         # valid sampled nodes, all devices
    rels: Optional[List[np.ndarray]] = None  # per layer int32 [n_dev,
                               # cap_dst, fanout] relation ids (hetero
                               # graphs only)
    edges: int = 0             # valid sampled edges, all devices and layers
    valid: Optional[np.ndarray] = None  # bool [n_dev, batch]; False on the
                               # wrapped tail duplicates (drop_tail=False)


@dataclasses.dataclass
class CoalaDataLoader:
    """Iterates HostBatches for ``local_size`` devices of one part, from
    the scheduler's ``local_rank`` on."""

    scheduler: DistributionScheduler
    sampler: NeighborSampler
    labels: np.ndarray           # [num_nodes] int
    local_size: int
    prefetch: int = 2            # batches prepared ahead (0 = in the
                                 # caller's thread)

    def __post_init__(self):
        self.batch_size = self.sampler.batch_size
        self._steps = self.scheduler.d.num_iters

    def __len__(self) -> int:
        return self._steps

    def _make_batch(self) -> HostBatch:
        domain = self.scheduler.run_domain()
        dv = self.scheduler.domain_valid
        B, first = self.batch_size, self.scheduler.local_rank
        rows = range(first, first + self.local_size)
        valid = (dv.reshape(-1, B)[first:first + self.local_size].copy()
                 if dv is not None else None)
        per_dev: List[SampledBatch] = [
            self.sampler.sample(domain[d * B:(d + 1) * B]) for d in rows]
        n_layers = len(per_dev[0].blocks)
        contig = per_dev[0].blocks[0].adj is None
        adjs = None if contig else [
            np.stack([b.blocks[l].adj for b in per_dev])
            for l in range(n_layers)]
        masks = None if contig else [
            np.stack([b.blocks[l].mask for b in per_dev])
            for l in range(n_layers)]
        edges = int(sum(b.blocks[l].mask.sum()
                        for b in per_dev for l in range(n_layers)))
        rels = None
        if per_dev[0].blocks[0].rel is not None:
            rels = [np.stack([b.blocks[l].rel for b in per_dev])
                    for l in range(n_layers)]
        input_ids = np.stack([b.input_ids for b in per_dev])
        num_input = np.asarray([b.num_input for b in per_dev], np.int32)
        seeds = np.stack([b.seeds for b in per_dev])
        return HostBatch(
            adjs=adjs, masks=masks, input_ids=input_ids, num_input=num_input,
            seeds=seeds, labels=self.labels[seeds].astype(np.int32),
            sampled_nodes=int(num_input.sum()), rels=rels, edges=edges,
            valid=valid)

    def __iter__(self) -> Iterator[HostBatch]:
        if self.prefetch <= 0:
            for _ in range(self._steps):
                yield self._make_batch()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                for _ in range(self._steps):
                    if stop.is_set():
                        return
                    q.put(self._make_batch())
            except BaseException as e:  # handed to the consumer, re-raised
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            for _ in range(self._steps):
                item = q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain, so a worker blocked on put can see the stop
            while not q.empty():
                q.get_nowait()
            t.join(timeout=5)

    def reset(self, shuffle_seed: Optional[int] = None) -> None:
        self.scheduler.reset(shuffle_seed)
