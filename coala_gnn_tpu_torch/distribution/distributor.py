"""Affinity-aware seed distribution (port of
``coala_gnn_tpu/distribution/distributor.py``, bit for bit).

- ``baseline``: contiguous striping of each global batch across parts.
- ``node_color``: a greedy, capacity-bounded argmax of score(seed, part) =
  sum_k cache_meta[part][topk_color[c][k]] * affinity[c][k], c = the
  seed's color; an uncolored seed scores 0, a full part -1, ties go to
  the lowest part.

Every part computes the same global assignment from the same inputs. A
part is a host; each host splits its domain slice across its devices by
position. Unlike the JAX function, ``greedy_affinity_assign(use_native=
True)`` raises where the native library does not build (no silent
fallback); ``use_native=False`` is the explicit numpy choice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from coala_gnn_tpu_torch.native import lib as native_lib


def greedy_affinity_assign(seeds: np.ndarray, color: np.ndarray,
                           topk_colors: np.ndarray, affinity: np.ndarray,
                           cache_meta: np.ndarray, capacity: int,
                           use_native: bool = True) -> np.ndarray:
    """int32 [len(seeds)] part of each seed. cache_meta int32 [num_parts,
    num_colors + 1]: each part's cache color-occupancy counters (1-based
    color, slot 0 unused)."""
    if use_native:
        return native_lib.distribute_affinity(
            native_lib.get(), seeds, 0, len(seeds), cache_meta.shape[0],
            capacity, color, topk_colors, affinity, cache_meta)
    return _greedy_py(seeds, color, topk_colors, affinity, cache_meta,
                      capacity)


def _greedy_py(seeds, color, topk_colors, affinity, cache_meta, capacity):
    """numpy form of ``cg_distribute_affinity``: the scores vectorised, the
    capacity loop sequential (assignment order decides feasibility)."""
    num_parts = cache_meta.shape[0]
    c = color[seeds]
    valid = c != 0
    rows = np.where(valid, c - 1, 0)
    tk = topk_colors[rows]                            # [S, K]
    af = affinity[rows]                               # [S, K]
    counts = cache_meta[:, :].astype(np.float64)      # [P, C+1]
    scores = np.einsum("psk,sk->sp", counts[:, tk], np.where(tk != 0, af, 0.0))
    scores[~valid] = 0.0
    out = np.zeros(len(seeds), dtype=np.int32)
    bucket = np.zeros(num_parts, dtype=np.int64)
    for i in range(len(seeds)):
        s = scores[i].copy()
        s[bucket >= capacity] = -1.0
        best = int(np.argmax(s))          # the first max: lowest part wins
        out[i] = best
        bucket[best] += 1
    return out


class SeedDistributor:
    """The shuffled train ids and their split per iteration: iteration
    ``it`` takes ``global_batch = batch_size * local_size * num_parts``
    seeds and hands each part its ``domain_batch = batch_size *
    local_size`` slice."""

    def __init__(self, train_ids: np.ndarray, batch_size: int,
                 local_size: int, num_parts: int,
                 mode: str = "baseline",
                 color: Optional[np.ndarray] = None,
                 topk_colors: Optional[np.ndarray] = None,
                 affinity: Optional[np.ndarray] = None,
                 shuffle_seed: int = 0,
                 use_native: bool = True,
                 drop_tail: bool = True):
        if mode not in ("baseline", "node_color"):
            raise ValueError(f"unknown distribution mode {mode!r}")
        if mode == "node_color" and (color is None or topk_colors is None
                                     or affinity is None):
            raise ValueError("node_color mode needs color/topk/affinity "
                             "metadata")
        self.mode = mode
        self.batch_size = batch_size
        self.local_size = local_size
        self.num_parts = num_parts
        self.domain_batch = batch_size * local_size
        self.global_batch = self.domain_batch * num_parts
        self.color = color
        self.topk_colors = topk_colors
        self.affinity = affinity
        self.use_native = use_native
        self.items = np.asarray(train_ids, dtype=np.int64).copy()
        np.random.default_rng(shuffle_seed).shuffle(self.items)
        self.drop_tail = drop_tail
        if drop_tail or len(self.items) == 0:
            # tail seeds that do not fill a global batch are dropped
            self.num_iters = len(self.items) // self.global_batch
        else:
            # exact epoch: the last window wraps around to the epoch's
            # (shuffled) start, since shapes are static
            self.num_iters = -(-len(self.items) // self.global_batch)

    def reshuffle(self, seed: int) -> None:
        np.random.default_rng(seed).shuffle(self.items)

    def distribute(self, it: int, cache_meta: Optional[np.ndarray] = None,
                   return_valid: bool = False):
        """Part slices of iteration ``it``: int64 [num_parts, domain_batch];
        with ``return_valid`` also bool [num_parts, domain_batch], False on
        the wrapped duplicates of the last drop_tail=False window. The flag
        follows its seed through the node_color reordering."""
        if not 0 <= it < self.num_iters:
            raise IndexError(f"iteration {it} out of range "
                             f"[0, {self.num_iters})")
        window = self.items[it * self.global_batch:
                            (it + 1) * self.global_batch]
        n_real = len(window)
        if n_real < self.global_batch:    # cyclic wrap (np.resize repeats
            window = np.concatenate(      # a tiny dataset)
                [window, np.resize(self.items, self.global_batch - n_real)])
        real = np.arange(self.global_batch) < n_real
        if self.mode == "baseline" or cache_meta is None:
            out = window.reshape(self.num_parts, self.domain_batch)
            if return_valid:
                return out, real.reshape(self.num_parts, self.domain_batch)
            return out
        assign = greedy_affinity_assign(
            window, self.color, self.topk_colors, self.affinity, cache_meta,
            capacity=self.domain_batch, use_native=self.use_native)
        out = np.empty((self.num_parts, self.domain_batch), dtype=np.int64)
        valid = np.zeros((self.num_parts, self.domain_batch), dtype=bool)
        for j in range(self.num_parts):
            sel = assign == j
            mine = window[sel]
            mv = real[sel]
            # a part is underfilled only if every other part filled first;
            # pad by wrapping (the pad slots stay invalid)
            if len(mine) < self.domain_batch:
                pad = np.resize(mine if len(mine) else window,
                                self.domain_batch - len(mine))
                mine = np.concatenate([mine, pad])
            out[j] = mine[:self.domain_batch]
            valid[j, :min(len(mv), self.domain_batch)] = \
                mv[:self.domain_batch]
        if return_valid:
            return out, valid
        return out

    def valid_mask(self, it: int) -> np.ndarray:
        """bool [num_parts, domain_batch]: the real (not wrapped) slots of
        ``distribute(it)``, by position; only sound in baseline mode, whose
        striping keeps window order, so other modes raise."""
        if self.mode != "baseline":
            raise ValueError(
                "valid_mask is positional and only sound for mode='baseline'"
                " (node_color reorders slots); run exact-tail eval with a "
                "baseline distributor")
        if not 0 <= it < self.num_iters:
            raise IndexError(f"iteration {it} out of range "
                             f"[0, {self.num_iters})")
        n_real = min(self.global_batch,
                     len(self.items) - it * self.global_batch)
        return (np.arange(self.global_batch) < n_real).reshape(
            self.num_parts, self.domain_batch)

    def device_slice(self, domain_seeds: np.ndarray,
                     local_rank: int) -> np.ndarray:
        """This device's batch of its part's domain slice."""
        return domain_seeds[local_rank * self.batch_size:
                            (local_rank + 1) * self.batch_size]
