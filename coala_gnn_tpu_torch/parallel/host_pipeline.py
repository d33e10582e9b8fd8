"""The host pipeline's training loop (port of ``bench.py:run_host``).

Per step the host distributes seeds (``distribution/``), samples the
blocks (``sampling/neighbor.py``, native), packs the whole batch into one
int32 request buffer (``data/packing.py``) and uploads it once, from
pinned memory without blocking. With a cache (``cache_mb > 0``) the same
buffer feeds the probe (``ShardedFeatureCache.fetch_begin_packed``), one
batch ahead of the step that consumes it, so the probe's miss count
streams back while the previous step runs. ``cache_mb == 0`` is the
uncached configuration: every step gathers its input rows on the host and
uploads them, the self-baseline every cached row is judged against.

Two wire layouts: the dedup layout (``contiguous=False``: ids, adj with
the mask in its sign, labels; SAGE's aggregation through the gather-SpMM
kernel) and the slot-major sentinel layout (``contiguous=True``: ids and
labels only; masks from ``ids != sentinel``, aggregation over slot
planes).

Speculation, as bench.py: after the first step, a step trains on the
probe's features as they are (misses read zero) without waiting for the
miss count; every ``SPEC_GROUP`` steps the group's miss counts, long since
copied back, are read, and if any is nonzero the model and optimizer
return to a copy of their state taken at the group's start (JAX's snapshot
is free because its updates are functional; here it is a device copy) and
the group is replayed through ``fetch_complete``'s miss repair, each step
on its own dropout stream. The result is exact either way.
"""

from __future__ import annotations

import collections
import copy
import sys
import time
from typing import Optional

import numpy as np
import torch

from coala_gnn_tpu_torch.cache import feature_cache as fc
from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
from coala_gnn_tpu_torch.data.loader import CoalaDataLoader
from coala_gnn_tpu_torch.data.packing import (batch_layout, pack_request,
                                              pack_request_contig)
from coala_gnn_tpu_torch.distribution import (DistributionScheduler,
                                              SeedDistributor)
from coala_gnn_tpu_torch.models.gnn import make_model
from coala_gnn_tpu_torch.ops.gather_spmm import LAUNCHES
from coala_gnn_tpu_torch.parallel.resident import HostScratch
from coala_gnn_tpu_torch.parallel.sharded_cache import ShardedFeatureCache
from coala_gnn_tpu_torch.parallel.train import (make_contig_train_step,
                                                make_request_train_step)
from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler
from coala_gnn_tpu_torch.utils.rng import DROPOUT, step_generators
from coala_gnn_tpu_torch.utils.timers import PhaseTimers

SPEC_GROUP = 8   # steps per speculation check (bench.py's default)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_host(ds, B: int, fanouts, dim: int, hidden: int, cache_mb: int,
             bf16: bool, warmup: int, steps: int, tag: str = "host",
             contiguous: bool = False, device="cuda",
             prewarm: str = "arange", dropout: float = 0.5,
             state_dict: Optional[dict] = None) -> dict:
    """``warmup`` + ``steps`` steps of SAGE (``hidden`` wide, Adam 1e-3,
    dropout ``dropout``, weights from seed 1 or ``state_dict``) through
    the host pipeline on ``device``; the measured steps are those after the
    warm-up. ``bf16``: bf16 cache lines (the model stays f32, as bench.py's
    run_host builds it). ``prewarm``: "arange" (the first ``capacity`` node
    ids, bench.py's) or "degree" (the highest in-degree nodes).

    Returns bench.py's keys (``value`` = train edges per second over the
    measured steps, ``unit``, ``cache_hit_ratio`` of the measured probes,
    ``config``) and ``ms_per_step``, ``replays`` (speculative groups
    replayed), ``launches_per_step`` (kernel launches per measured step,
    by kernel), ``losses`` (every step's), ``hits`` / ``misses`` and
    ``timers``: the main thread's host time of the measured steps by
    phase (``PhaseTimers.summary``): ``loader_wait`` (waiting for the
    loader's worker), ``pack_upload``, ``probe_dispatch``, ``host_fetch``
    (uncached gather + upload), ``snapshot``, ``step_dispatch``,
    ``spec_check`` (reading the miss counts, and replays), ``drain`` (the
    final wait for the device)."""
    if warmup < 1 or steps < 1:
        raise ValueError("run_host needs warmup >= 1 and steps >= 1")
    device = torch.device(device)
    sentinel = ds.graph.num_nodes
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=0,
                              contiguous=contiguous)
    distributor = SeedDistributor(ds.train_idx, batch_size=B, local_size=1,
                                  num_parts=1, mode="baseline",
                                  shuffle_seed=0)
    loader = CoalaDataLoader(
        scheduler=DistributionScheduler(distributor, part_id=0,
                                        local_rank=0),
        sampler=sampler, labels=ds.labels, local_size=1, prefetch=2)

    model = make_model("sage", dim, hidden, ds.num_classes, len(fanouts),
                       dropout=dropout, seed=1)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    n_req = sampler.caps[0][1]     # input-layer src capacity = id list
    layout = batch_layout(sampler.caps, fanouts)
    step_fn = (make_contig_train_step(model, optimizer, B, layout, n_req,
                                      sentinel) if contiguous else
               make_request_train_step(model, optimizer, B, layout, n_req))

    store = HostFeatureStore(ds.features)
    cache = None
    if cache_mb > 0:
        cfg = fc.make_config(cache_mb=cache_mb, dim=dim,
                             dtype=torch.bfloat16 if bf16 else torch.float32)
        cache = ShardedFeatureCache(cfg, [device], mode="isolated")
        log(f"host[{tag}]: cache {cfg.num_sets} sets x {cfg.ways} ways "
            f"({cfg.size_mb:.0f} MB, capacity {cfg.capacity} lines)")
        t = time.perf_counter()
        if prewarm == "arange":
            n_warm = min(ds.graph.num_nodes, cfg.capacity)
            cache.prewarm(np.arange(n_warm, dtype=np.int32), store.fetch)
        elif prewarm == "degree":
            n_warm = cache.prewarm_by_degree(ds.graph, store.fetch)
        else:
            raise ValueError(f"unknown prewarm {prewarm!r}")
        log(f"host[{tag}]: prewarmed {n_warm} lines ({prewarm}) in "
            f"{time.perf_counter() - t:.1f}s")
    scratch = HostScratch(pin_memory=device.type == "cuda")
    timers = PhaseTimers()
    it = iter(loader)
    pending = collections.deque()   # (HostBatch, request on device, probe)

    def pull() -> None:
        """Next batch: pack, upload once, dispatch its probe."""
        try:
            with timers.time("loader_wait"):
                hb = next(it)
        except StopIteration:
            return
        with timers.time("pack_upload"):
            ids = hb.input_ids[0].astype(np.int32)
            if contiguous:
                vec = pack_request_contig(ids, int(hb.num_input[0]),
                                          hb.labels[0])
            else:
                vec = pack_request(ids, int(hb.num_input[0]),
                                   [a[0] for a in hb.adjs],
                                   [m[0] for m in hb.masks], hb.labels[0])
            host = scratch.get("request", (1, vec.size), torch.int32)
            host.numpy()[0] = vec
            dbuf = scratch.upload(host, device)
        h = None
        if cache is not None:
            with timers.time("probe_dispatch"):
                h = cache.fetch_begin_packed(hb.input_ids, hb.num_input,
                                             dbuf, n_req,
                                             sentinel if contiguous else 0)
        pending.append((hb, dbuf, h))

    def uncached_rows(hb) -> torch.Tensor:
        """The host gather and upload of the uncached configuration;
        sentinel ids read a clamped row that no slot weighs."""
        host = scratch.get("features", (n_req, dim), torch.float32)
        store.fetch(np.minimum(hb.input_ids[0], sentinel - 1),
                    out=host.numpy())
        return scratch.upload(host, device)

    def dropout_gen(i: int) -> torch.Generator:
        return step_generators(0, i, 1, DROPOUT, device)[0]

    losses: list = []
    group: list = []        # (probe, request, step) since the last check
    snap = None             # (model, optimizer) state at the group's start
    replays = 0

    def flush_group() -> None:
        nonlocal replays, snap
        if group and any(h.miss_count() for h, _, _ in group):
            replays += 1
            model.load_state_dict(snap[0])
            optimizer.load_state_dict(snap[1])
            for h, dbuf, i in group:
                x = cache.fetch_complete(h, store.fetch)[0]
                losses[i] = step_fn(dbuf, x, dropout_gen(i))[0]
        group.clear()
        snap = None

    edges = n_done = 0
    t0 = launches0 = None
    try:
        pull()
        for i in range(warmup + steps):
            if not pending:
                break
            hb, dbuf, handle = pending.popleft()
            pull()          # the next probe goes out before this resolves
            speculative = cache is not None and i > 0
            if speculative:
                if snap is None:
                    with timers.time("snapshot"):
                        snap = (copy.deepcopy(model.state_dict()),
                                copy.deepcopy(optimizer.state_dict()))
                x = handle.feats[0]       # misses unverified
            elif cache is not None:
                x = cache.fetch_complete(handle, store.fetch)[0]
            else:
                with timers.time("host_fetch"):
                    x = uncached_rows(hb)
            if i == 0:
                log(f"host[{tag}]: first batch ready (sampled "
                    f"{hb.sampled_nodes} nodes)")
            with timers.time("step_dispatch"):
                losses.append(step_fn(dbuf, x, dropout_gen(i))[0])
            if speculative:
                group.append((handle, dbuf, i))
                if len(group) >= SPEC_GROUP:
                    with timers.time("spec_check"):
                        flush_group()
            if i == warmup - 1:
                flush_group()
                _sync(device)
                if cache is not None:
                    cache.stats()     # the ratio covers the measured steps
                launches0 = dict(LAUNCHES)
                timers.reset()
                t0 = time.perf_counter()
            if i >= warmup:
                edges += hb.edges
                n_done += 1
        if n_done == 0:
            raise RuntimeError(f"host[{tag}]: the epoch ended in the "
                               "warm-up")
        with timers.time("spec_check"):
            flush_group()
        with timers.time("drain"):
            _sync(device)
        dt = time.perf_counter() - t0
    finally:
        it.close()
    eps = edges / dt
    s = {"hits": None, "misses": None, "hit_ratio": None}
    if cache is not None:
        s = cache.stats()
        log(f"host[{tag}]: cache hit ratio {s['hit_ratio']:.3f} "
            f"({s['hits']} hits / {s['misses']} misses)")
    if replays:
        log(f"host[{tag}]: speculative groups replayed: {replays}")
    loss_values = torch.stack(losses).cpu().numpy().tolist()
    log(f"host[{tag}]: {n_done} steps in {dt:.3f}s -> {eps:,.0f} edges/s "
        f"({1000 * dt / n_done:.1f} ms/step, loss {loss_values[-1]:.4f})")
    return {
        "metric": "train_edges_per_s_per_chip",
        "value": round(eps, 1),
        "unit": "edges/s",
        "vs_baseline": None,
        "cache_hit_ratio": (None if s["hit_ratio"] is None else
                            round(s["hit_ratio"], 4)),
        "hits": s["hits"],
        "misses": s["misses"],
        "ms_per_step": 1000 * dt / n_done,
        "replays": replays,
        "launches_per_step": {k: (v - launches0[k]) / n_done
                              for k, v in LAUNCHES.items()},
        "losses": loss_values,
        "timers": timers.summary(),
        "config": {"batch": B, "fanout": list(fanouts), "dim": dim,
                   "hidden": hidden, "nodes": ds.graph.num_nodes,
                   "cache_mb": cache_mb, "model": "sage", "mode": tag,
                   "layout": "contig" if contiguous else "dedup",
                   "feature_dtype": "bfloat16" if bf16 and cache_mb
                   else "float32",
                   "prewarm": prewarm,
                   "device": str(device)},
    }
