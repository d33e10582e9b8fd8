"""Pipelined seed distribution (port of
``coala_gnn_tpu/distribution/scheduler.py``): the distribution of
iteration i + 1 runs in a background thread while iteration i trains, and
every ``refresh_counter`` iterations the cache's color-occupancy counters
are snapshotted and exchanged across parts in a second thread; the
distributor reads the newest *completed* snapshot, so the step never
waits for it. Host-only: no thread here touches the device."""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np

from coala_gnn_tpu_torch.distribution.distributor import SeedDistributor

DEFAULT_REFRESH_COUNTER = 8


class DistributionScheduler:
    def __init__(self, distributor: SeedDistributor, part_id: int,
                 local_rank: int,
                 meta_fn: Optional[Callable[[], np.ndarray]] = None,
                 meta_exchange_fn: Optional[
                     Callable[[np.ndarray], np.ndarray]] = None,
                 refresh_counter: int = DEFAULT_REFRESH_COUNTER):
        """meta_fn() -> int32 [num_colors + 1] local cache color counts;
        meta_exchange_fn(local) -> int32 [num_parts, num_colors + 1]
        (default: every part holds the local counts)."""
        self.d = distributor
        self.part_id = part_id
        self.local_rank = local_rank
        self.meta_fn = meta_fn
        self.meta_exchange_fn = meta_exchange_fn or (
            lambda m: m[None, :].repeat(distributor.num_parts, 0))
        self.refresh_counter = refresh_counter
        self._meta: Optional[np.ndarray] = None       # newest completed
        self._meta_pending: Optional[np.ndarray] = None
        self._meta_thread: Optional[threading.Thread] = None
        self._dist_thread: Optional[threading.Thread] = None
        self._next_domain: Optional[np.ndarray] = None
        self._next_valid: Optional[np.ndarray] = None
        #: bool [domain_batch]: validity of the last run_domain() slice
        #: (False = a wrapped tail duplicate of a drop_tail=False epoch)
        self.domain_valid: Optional[np.ndarray] = None
        self._iter = 0

    def _distribute(self, it: int) -> None:
        out, valid = self.d.distribute(it, self._meta, return_valid=True)
        self._next_valid = valid[self.part_id]
        self._next_domain = out[self.part_id]

    def _exchange_meta(self, local: np.ndarray) -> None:
        self._meta_pending = self.meta_exchange_fn(local)

    def run(self) -> np.ndarray:
        """This device's seeds of the next iteration (int64
        [batch_size])."""
        return self.d.device_slice(self.run_domain(), self.local_rank)

    def run_domain(self) -> np.ndarray:
        """This part's domain slice of the next iteration (int64
        [domain_batch]); raises StopIteration past the epoch."""
        it = self._iter
        if it >= self.d.num_iters:
            raise StopIteration
        # join the distribution computed one iteration ahead (or compute
        # it now, on the first call)
        if self._dist_thread is not None:
            self._dist_thread.join()
            self._dist_thread = None
        if self._next_domain is None:
            self._distribute(it)
        domain = self._next_domain
        self.domain_valid = self._next_valid
        self._next_domain = self._next_valid = None
        # refresh cadence: flip in the finished snapshot, start the next
        if self.d.mode == "node_color" and self.meta_fn is not None \
                and it % self.refresh_counter == 0:
            if self._meta_thread is not None:
                self._meta_thread.join()
                self._meta = self._meta_pending
            local = np.ascontiguousarray(self.meta_fn(), dtype=np.int32)
            self._meta_thread = threading.Thread(
                target=self._exchange_meta, args=(local,), daemon=True)
            self._meta_thread.start()
        if it + 1 < self.d.num_iters:
            self._dist_thread = threading.Thread(
                target=self._distribute, args=(it + 1,), daemon=True)
            self._dist_thread.start()
        self._iter += 1
        return domain

    def reset(self, shuffle_seed: Optional[int] = None) -> None:
        """New epoch: join the threads, reshuffle if asked, restart."""
        for t in (self._dist_thread, self._meta_thread):
            if t is not None:
                t.join()
        self._dist_thread = self._meta_thread = None
        self._next_domain = self._next_valid = None
        self._iter = 0
        if shuffle_seed is not None:
            self.d.reshuffle(shuffle_seed)
