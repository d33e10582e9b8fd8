"""Per-step random streams (counterpart of coala_gnn_tpu/utils/rng.py).

The JAX trainers split a root key into one key per window and each
window's key into one per step; a step's key splits again into ``k1``
(sampling) and ``k2`` (dropout), and the presample probe re-derives ``k1``
to see exactly the ids the window will sample.

Here every (window, step, stream) triple gets a ``torch.Generator`` of its
own, seeded from ``numpy.random.SeedSequence(seed, spawn_key=(window,
step, stream))``: the same tree ``SeedSequence(seed).spawn`` would build,
without its spawn counter. A window of the trainer draws step k's sampler
uniforms from ``(w, k, SAMPLE)`` and its dropout masks from ``(w, k,
DROPOUT)``, so the probe can rebuild the sampling stream of any step
without touching the dropout stream, and a replayed step draws what the
window drew. The CLI's resident loop keys a window by the run step it
starts at and a single step by its run step (``(step, 0, stream)``), so no
two steps of a run share a stream; its eval batches sample from ``(batch,
0, EVAL)``, and the probe step of ``--resume`` from ``(0, 0, RESUME)``.
On CUDA the generator is Philox; its draws differ from JAX's threefry,
which is why the tests feed both samplers the same uniforms or use
fanout >= max in-degree (ROADMAP.md section C). In a data-parallel run
every rank past 0 draws its sampling and dropout from streams of its own
(``rank``), where JAX folds the device index into the dropout key.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

SAMPLE, DROPOUT, EVAL, RESUME = 0, 1, 2, 3


def stream_seed(seed: int, window: int, step: int, stream: int,
                rank: int = 0) -> int:
    """63-bit seed of one (window, step, stream) of root ``seed``; a rank
    past 0 of a data-parallel run gets streams of its own (spawn key
    (window, step, stream, rank)), rank 0 the one-card streams."""
    key = (window, step, stream) + ((rank,) if rank else ())
    ss = np.random.SeedSequence(seed, spawn_key=key)
    return int(ss.generate_state(1, np.uint64)[0] >> 1)


def step_generators(seed: int, window: int, num_steps: int, stream: int,
                    device, rank: int = 0) -> List[torch.Generator]:
    """One generator per step of ``window`` for ``stream`` (SAMPLE,
    DROPOUT, EVAL or RESUME), on ``device``, for ``rank``. Calling it
    twice gives two independent copies of the same streams."""
    gens = []
    for step in range(num_steps):
        gen = torch.Generator(device=device)
        gen.manual_seed(stream_seed(seed, window, step, stream, rank))
        gens.append(gen)
    return gens


def rank_seed(seed: int, rank: int) -> int:
    """The host sampler's seed of ``rank``: ``seed`` itself on rank 0 (a
    one-card run is unchanged), a stream of its own on every other rank
    (JAX's one host process samples every device from one stream)."""
    return seed if rank == 0 else stream_seed(seed, 0, 0, SAMPLE, rank)
