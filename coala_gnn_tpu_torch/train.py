"""Mini-batch GNN training: the port's counterpart of ``examples/train.py``,
its host pipeline (the default) and its ``--pipeline resident``, each on
one card or data-parallel over several.

    python -m coala_gnn_tpu_torch.train --fan_out 10,5 --batch_size 1024 \\
        --hidden_channels 256 --feature_dim 256 --num_nodes 200000 \\
        --cache_size 1024 --epochs 1 --max_steps 50 --eval \\
        [--pipeline resident --window 8 [--shard_topology]] \\
        [--devices 4 --cache_backend sharded]
    torchrun --nproc_per_node 4 -m coala_gnn_tpu_torch.train ...

Data parallel (``--devices N``, or one process per card under torchrun):
one rank per card, each on ``cuda:<local rank>`` (``--device cpu``: N CPU
ranks over gloo). ``--devices N`` spawns the N ranks on this machine
(``parallel/multihost.launch``; a ``ValueError`` if it has fewer cards);
under torchrun (or the JAX package's ``COALA_COORDINATOR`` environment)
the process group comes from the environment. Every rank runs
``train_rank``: ``build`` on its ``Mesh`` (``parallel/mesh.py``), where a
host (a distributor part) is a block of ranks and each rank samples its
own slice of its host's part from its own sampler stream
(``utils/rng.rank_seed``), fetches through the cache spread over the
ranks (``--cache_backend sharded | node_local | isolated``, JAX's modes;
``nccl`` / ``nvshmem`` are the reference's names for sharded) and trains
the data-parallel step (``parallel/train.py``), its dropout from its own
streams. Rank 0 prints the JAX CLI's lines (the hit ratio, the sampled
nodes and the test accuracy summed over the ranks) and writes the
checkpoints. The process group's backend is NCCL on cards and gloo on
the CPU (``multihost.backend_for``).

Host pipeline, per step: seed distribution (``distribution/``), host
sampling (``sampling/neighbor.py``), the blocks and labels uploaded, the
features through the cache front (``parallel/sharded_cache.py``, a
synchronous ``fetch``) or, with ``--cache_size 0``, gathered on the host
and uploaded, then the data-parallel step (``parallel/train.py``).
``--profile_dir`` traces its epoch 0 with ``torch.profiler``.

Resident pipeline (``--pipeline resident``, which needs a cache): the host
picks each step's seed grid and the rest runs on the device, through
``parallel/sharded_resident.py``'s ``ShardedResidentTrainer``, as
``examples/train.py``'s ``_run_resident`` runs it: the run's first step
per step (JAX initialises its params there), then fused windows of
``--window`` steps (clamped to ``--refresh_counter``) or, with ``--window
1``, per-step steps with the next step's ``begin`` one ahead; with
``--mask_tail`` the epoch's wrapped tail step takes the masked step, and
windows stop before it. Every step draws from its own streams
(``utils/rng.py``): a window from ``(seed, its first run step, k)``, a
single step from ``(seed, its run step, 0)``, a rank past 0 from streams
of its own. Over several ranks each rank trains its slice of its host's
seed grid through the cache spread over the ranks, and the windows'
counters, the eval counts and the printed sampled edges are summed over
the ranks. ``--shard_topology`` keeps only each rank's shard of the
topology on its card (``sampling/sharded_topology.py``; a no-op on one
card, as in JAX); over several ranks it is switched on by itself where
the graph does not fit the replicated device layout
(``device_sampler.fits_device_graph``), as ``examples/train.py`` does. On
one card the port does not fall back to the host pipeline there, as JAX
does: its int64 offsets hold any graph whose ids fit int32, and
``to_device_graph`` raises for one whose ids do not.

``--data synthetic`` (the default) builds the synthetic graph of
``--num_nodes`` / ``--avg_degree`` / ``--feature_dim``; any other name goes
to ``graph.datasets.load_dataset`` with ``--path``, ``--dataset_size`` and
``--num_classes`` (``igb``, ``igb-hetero``, ``ogb-mag-hetero``,
``preprocessed``; the features stay a memory map of their file). The
hetero models (``--model_type rsage|rgcn|rgat``) train on a typed graph's
own relations, or on random edge types (``--num_edge_types``, 3 when it is
below 2) drawn onto a graph that has none, as ``examples/train.py`` draws
them, on either pipeline.
``--nbr_cap P`` samples the resident pipeline from the padded neighbour
table. ``--distribution node_color --color_dir DIR`` reads the color
metadata that ``python -m coala_gnn_tpu_torch.generate_colors`` writes:
the distributor scores seeds against the cache's color counters, which
the scheduler refreshes every ``--refresh_counter`` steps, and the cache
lines carry their node's color. ``--save_dir`` writes a checkpoint
(``utils/checkpoint.py``) after every epoch at step ``(epoch + 1) *
steps_per_epoch``; ``--resume`` restores the latest one (``resume``) and
starts at the epoch after it, the resident loop's streams continuing
from its step.
The flags are ``examples/train.py``'s; each one not ported raises
``NotImplementedError`` naming its ROADMAP.md item, and none is ignored.
Runs on the card (``--device cuda``, the default, raises without one)
unless ``--device cpu`` is asked for.

``main`` is ``build`` (the dataset, sampler, loader, cache front, model
and optimizer, and the resident trainer), ``resume`` (with ``--resume``),
``train`` (the epoch loop, which returns the step losses and the epochs'
times) and ``evaluate``; a caller may drive them itself, or drive ranks
through ``train_rank``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import time
from typing import Any, Optional

import numpy as np
import torch

#: the hetero model types
HETERO = ("rsage", "rgcn", "rgat")

#: the ROADMAP.md item that the flags not ported name
_ROADMAP = {
    "jax_only": "ROADMAP.md queue A, \"Not ported: code the system does not "
                "need on a GPU\"",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="COALA-GNN trainer, PyTorch port")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--path", type=str, default="")
    p.add_argument("--data", type=str, default="synthetic")
    p.add_argument("--dataset_size", type=str, default="tiny")
    p.add_argument("--num_classes", type=int, default=16)
    p.add_argument("--model_type", type=str, default="sage",
                   choices=["sage", "distsage", "gcn", "gat",
                            "rsage", "rgcn", "rgat"])
    p.add_argument("--fan_out", type=str, default="5,5")
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--hidden_channels", type=int, default=128)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--decay", type=float, default=0.0,
                   help="weight decay; > 0 selects AdamW")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--num_layers", type=int, default=None,
                   help="defaults to len(fan_out)")
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--cache_size", type=int, default=0,
                   help="feature cache MB; 0 = direct host gather")
    p.add_argument("--cache_backend", type=str, default="sharded",
                   choices=["sharded", "isolated", "node_local", "nvshmem",
                            "nccl"],
                   help="sharded: ids hashed over every rank; node_local: "
                        "over each host's ranks; isolated: each rank's own "
                        "(nvshmem, nccl: sharded); on one card every "
                        "backend is the card's own cache")
    p.add_argument("--devices", type=int, default=0,
                   help="ranks to start on this machine, one per card "
                        "(0 or 1 = one card; under torchrun, 0 or the "
                        "ranks per host)")
    p.add_argument("--feat_cpu", action="store_true",
                   help="accepted for reference-CLI parity: the host-RAM "
                        "feature tier is always the backing store")
    p.add_argument("--pipeline", type=str, default="host",
                   choices=["host", "resident"])
    p.add_argument("--window", type=int, default=1,
                   help="resident pipeline only")
    p.add_argument("--quantize", action="store_true",
                   help="int8 cache lines + a per-line absmax scale")
    p.add_argument("--keep_tail", action="store_true",
                   help="exact epoch: wrap-pad the final global batch "
                        "instead of dropping the tail seeds")
    p.add_argument("--mask_tail", action="store_true",
                   help="implies --keep_tail; the wrapped duplicates get no "
                        "loss or gradient (global masked mean)")
    p.add_argument("--shard_topology", action="store_true",
                   help="resident pipeline: each rank keeps only its shard "
                        "of the topology (E/ranks edges a card); a no-op "
                        "on one card")
    p.add_argument("--nbr_cap", type=int, default=0)
    p.add_argument("--rng_impl", type=str, default="",
                   choices=["", "threefry2x32", "rbg"])
    p.add_argument("--distribution", type=str, default="baseline",
                   choices=["baseline", "node_color"])
    p.add_argument("--refresh_counter", type=int, default=8,
                   help="cache-meta refresh cadence of the scheduler")
    p.add_argument("--color_dir", type=str, default="")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval", action="store_true", help="test eval at the end")
    p.add_argument("--max_steps", type=int, default=0,
                   help="truncate each epoch (0 = full epoch)")
    p.add_argument("--num_edge_types", type=int, default=1)
    p.add_argument("--num_nodes", type=int, default=100_000)
    p.add_argument("--avg_degree", type=int, default=15)
    p.add_argument("--feature_dim", type=int, default=128)
    p.add_argument("--save_dir", type=str, default="")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile_dir", type=str, default="")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """NotImplementedError, naming its ROADMAP.md item, for the first flag
    whose value is not ported; ValueError for a flag that the JAX CLI
    ignores where it is given (ROADMAP.md section C): ``--num_edge_types >
    1`` with a homogeneous model, ``--window > 1``, ``--nbr_cap`` or
    ``--shard_topology`` on the host pipeline, ``--profile_dir`` with
    ``--pipeline resident``, ``--resume`` without ``--save_dir``,
    ``--color_dir`` without ``--distribution node_color``; and for
    ``node_color`` without ``--color_dir``, which it needs."""
    if args.rng_impl:
        raise NotImplementedError("--rng_impl (a JAX PRNG family) is not "
                                  f"ported: {_ROADMAP['jax_only']}")
    if args.num_edge_types > 1 and args.model_type not in HETERO:
        raise ValueError(f"--num_edge_types {args.num_edge_types} needs a "
                         f"hetero model ({', '.join(HETERO)}); "
                         f"--model_type {args.model_type} has no relations")
    if args.window > 1 and args.pipeline != "resident":
        raise ValueError(f"--window {args.window} fuses the steps of "
                         "--pipeline resident; the host pipeline runs one "
                         "step at a time")
    if args.profile_dir and args.pipeline == "resident":
        raise ValueError("--profile_dir traces the host pipeline's epoch 0; "
                         "the JAX CLI ignores it with --pipeline resident")
    if args.nbr_cap > 0 and args.pipeline != "resident":
        raise ValueError(f"--nbr_cap {args.nbr_cap} lays out the topology "
                         "of --pipeline resident; the host pipeline samples "
                         "on the host")
    if args.shard_topology and args.pipeline != "resident":
        raise ValueError("--shard_topology shards the device topology of "
                         "--pipeline resident; the host pipeline samples on "
                         "the host")
    if args.resume and not args.save_dir:
        raise ValueError("--resume restores from --save_dir; give "
                         "--save_dir")
    if args.color_dir and args.distribution != "node_color":
        raise ValueError("--color_dir is read by --distribution node_color; "
                         f"--distribution {args.distribution} ignores it")
    if args.distribution == "node_color" and not args.color_dir:
        raise ValueError("--distribution node_color needs --color_dir (the "
                         "output of python -m "
                         "coala_gnn_tpu_torch.generate_colors)")


@dataclasses.dataclass
class Run:
    """What ``build`` sets up; ``train`` and ``evaluate`` drive it. A
    caller may swap ``optimizer`` (over ``model``'s parameters) or set
    ``model.dropout`` between ``build`` and ``train``. ``trainer`` is the
    resident pipeline's ``ShardedResidentTrainer`` (None on the host
    pipeline), ``window`` its clamped ``--window``, ``meta`` the
    ``--color_dir`` metadata (None without ``node_color``). ``fresh``:
    the resident loop's first step is a single step (where JAX
    initialises its params), until a ``resume`` probe has run. ``mesh``:
    this rank's place among the data-parallel ranks (a card on its own by
    default)."""

    args: argparse.Namespace
    device: torch.device
    ds: Any                      # graph.datasets.Dataset
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    sampler: Any                 # sampling.neighbor.NeighborSampler
    loader: Any                  # data.loader.CoalaDataLoader
    store: Any                   # cache.host_tier.HostFeatureStore
    cache: Optional[Any]         # parallel.sharded_cache.ShardedFeatureCache
    epoch: int = 0               # epochs trained (the loader's reshuffles)
    step: int = 0                # steps trained (the dropout streams)
    sampled: int = 0             # sampled nodes trained
    trainer: Optional[Any] = None
    window: int = 1
    meta: Optional[Any] = None   # coloring.ColorMetadata
    fresh: bool = True
    mesh: Optional[Any] = None   # parallel.mesh.Mesh

    @property
    def scheduler(self):
        return self.loader.scheduler

    @property
    def hetero(self) -> bool:
        return self.args.model_type in HETERO

    @property
    def colors(self) -> Optional[np.ndarray]:
        return None if self.meta is None else self.meta.color

    def put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def blocks(self, hb) -> list:
        """A HostBatch's blocks on the device, with the leading device
        axis (DeviceHeteroBlocks for a hetero model)."""
        from coala_gnn_tpu_torch.models.hetero import DeviceHeteroBlock
        from coala_gnn_tpu_torch.models.layers import DeviceBlock

        if self.hetero:
            return [DeviceHeteroBlock(adj=self.put(a), mask=self.put(m),
                                      rel=self.put(r))
                    for a, m, r in zip(hb.adjs, hb.masks, hb.rels)]
        return [DeviceBlock(adj=self.put(a), mask=self.put(m))
                for a, m in zip(hb.adjs, hb.masks)]

    def features(self, hb) -> torch.Tensor:
        """The batch's input rows [1, cap_src, dim]: through the cache
        front, or gathered on the host and uploaded (no cache)."""
        if self.cache is None:
            return self.put(np.stack([self.store.fetch(ids)
                                      for ids in hb.input_ids]))
        return self.cache.fetch(hb.input_ids, hb.num_input, self.store.fetch,
                                colors=self.colors)


def with_edge_types(ds, num_edge_types: int, seed: int):
    """``ds`` on a copy of its graph with random edge types, drawn as
    ``examples/train.py`` draws them: ``default_rng(seed).integers(0, n,
    num_edges)`` int32, n = ``num_edge_types``, or 3 below 2. A graph that
    has edge types keeps them."""
    if ds.graph.edge_types is not None:
        return ds
    n = num_edge_types if num_edge_types >= 2 else 3
    types = np.random.default_rng(seed).integers(
        0, n, ds.graph.num_edges).astype(np.int32)
    return dataclasses.replace(ds, graph=dataclasses.replace(
        ds.graph, edge_types=types, num_edge_types=n))


def load(args):
    """The dataset of the flags: the synthetic graph for ``--data
    synthetic``, else ``load_dataset(--data, path=--path,
    dataset_size=--dataset_size, num_classes=--num_classes)``."""
    from coala_gnn_tpu_torch.graph.datasets import (load_dataset,
                                                    synthetic_graph)

    if args.data == "synthetic":
        return synthetic_graph(num_nodes=args.num_nodes,
                               avg_degree=args.avg_degree,
                               feature_dim=args.feature_dim,
                               num_classes=args.num_classes, seed=args.seed)
    return load_dataset(args.data, path=args.path,
                        dataset_size=args.dataset_size,
                        num_classes=args.num_classes)


def build(args, ds=None, mesh=None) -> Run:
    """Everything the CLI trains with, printing what ``examples/train.py``
    prints: the model with the JAX CLI's dropout 0.5, Adam (AdamW with
    ``--decay``). ``ds``: the dataset to train on (default: ``load``'s).
    ``mesh``: this rank's ``Mesh`` (default: ``--device`` on its own);
    collective over its ranks."""
    if args.pipeline == "resident" and args.cache_size <= 0:
        raise SystemExit("--pipeline resident requires --cache_size > 0")
    device = torch.device(args.device) if mesh is None else mesh.device
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card here; pass "
                           "--device cpu to train on the CPU")

    from coala_gnn_tpu_torch.cache import feature_cache as fc
    from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu_torch.coloring import load_color_metadata
    from coala_gnn_tpu_torch.data.loader import CoalaDataLoader
    from coala_gnn_tpu_torch.distribution import (DistributionScheduler,
                                                  SeedDistributor)
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.models.hetero import make_hetero_model
    from coala_gnn_tpu_torch.parallel.mesh import make_mesh
    from coala_gnn_tpu_torch.parallel.multihost import make_meta_exchange_fn
    from coala_gnn_tpu_torch.parallel.sharded_cache import \
        ShardedFeatureCache
    from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler
    from coala_gnn_tpu_torch.utils.rng import rank_seed

    mesh = make_mesh(device) if mesh is None else mesh

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"torch {torch.__version__}, device: {device} ({name})")
    fanouts = [int(f) for f in args.fan_out.split(",")]
    num_layers = args.num_layers or len(fanouts)
    if num_layers != len(fanouts):
        raise ValueError("--num_layers must match --fan_out")

    if ds is None:
        ds = load(args)
    hetero = args.model_type in HETERO
    if hetero:
        ds = with_edge_types(ds, args.num_edge_types, args.seed)
    print(f"dataset {ds.name}: {ds.graph.num_nodes} nodes, "
          f"{ds.graph.num_edges} edges, dim {ds.feature_dim}, "
          f"{ds.num_classes} classes, {len(ds.train_idx)} train"
          + (f", {ds.graph.num_edge_types} edge types" if hetero else ""))
    B = args.batch_size
    sampler = NeighborSampler(ds.graph, fanouts, B,
                              seed=rank_seed(args.seed, mesh.rank))
    print(f"sampler native: {sampler._native is not None}")
    print(f"hosts: {mesh.num_hosts} (this={mesh.host_id}), local devices: "
          f"{mesh.local_size}")
    if mesh.distributed:
        print(f"ranks: {mesh.world}, one per card, backend "
              f"{torch.distributed.get_backend()}")

    meta = None
    if args.distribution == "node_color":
        meta = load_color_metadata(args.color_dir)
    distributor = SeedDistributor(
        ds.train_idx, batch_size=B, local_size=mesh.local_size,
        num_parts=mesh.num_hosts,
        mode=args.distribution,
        color=None if meta is None else meta.color,
        topk_colors=None if meta is None else meta.topk,
        affinity=None if meta is None else meta.score,
        shuffle_seed=args.seed,
        drop_tail=not (args.keep_tail or args.mask_tail))
    scheduler = DistributionScheduler(
        distributor, part_id=mesh.host_id, local_rank=mesh.local_rank,
        meta_exchange_fn=(make_meta_exchange_fn(mesh, meta.num_colors)
                          if meta is not None and mesh.distributed
                          else None),
        refresh_counter=args.refresh_counter)
    # --dtype: the cache lines' dtype and the model's compute dtype
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    kw = dict(num_heads=args.num_heads, seed=args.seed, dtype=dtype)
    if hetero:
        model = make_hetero_model(args.model_type, ds.feature_dim,
                                  args.hidden_channels, ds.num_classes,
                                  ds.graph.num_edge_types, num_layers, **kw)
    else:
        model = make_model(args.model_type, ds.feature_dim,
                           args.hidden_channels, ds.num_classes, num_layers,
                           **kw)
    model = model.to(device)
    opt = (torch.optim.AdamW(model.parameters(), lr=args.learning_rate,
                             weight_decay=args.decay) if args.decay
           else torch.optim.Adam(model.parameters(), lr=args.learning_rate))

    store = HostFeatureStore(ds.features)
    cache = None
    if args.cache_size > 0:
        mode = {"nvshmem": "sharded", "nccl": "sharded"}.get(
            args.cache_backend, args.cache_backend)
        shards = {"sharded": mesh.world, "isolated": 1,
                  "node_local": mesh.local_size}[mode]
        cfg = fc.make_config(cache_mb=args.cache_size, dim=ds.feature_dim,
                             num_colors=0 if meta is None
                             else meta.num_colors,
                             dtype=dtype, quantize=args.quantize,
                             num_shards=shards)
        cache = ShardedFeatureCache(cfg, mesh, mode=mode)
        scheduler.meta_fn = cache.local_color_meta
        print(f"cache[{mode}]: {cfg.num_sets} sets x {cfg.ways} ways "
              f"({cfg.size_mb:.0f} MB per device"
              + (", int8 lines)" if args.quantize else ")"))

    loader = CoalaDataLoader(scheduler=scheduler, sampler=sampler,
                             labels=ds.labels, local_size=1, prefetch=2)
    run = Run(args=args, device=device, ds=ds, model=model, optimizer=opt,
              sampler=sampler, loader=loader, store=store, cache=cache,
              meta=meta, mesh=mesh)
    if args.pipeline == "resident":
        from coala_gnn_tpu_torch.parallel.sharded_resident import \
            ShardedResidentTrainer
        from coala_gnn_tpu_torch.sampling.device_sampler import \
            fits_device_graph

        shard = args.shard_topology
        if not shard and mesh.world > 1 and not fits_device_graph(
                ds.graph.num_nodes, ds.graph.num_edges):
            print(f"graph ({ds.graph.num_nodes} nodes, "
                  f"{ds.graph.num_edges} edges) exceeds the replicated "
                  "device-topology limits; auto-enabling --shard_topology")
            shard = True
        run.trainer = ShardedResidentTrainer(
            graph=ds.graph, host_fetch=store.fetch, labels=ds.labels,
            cache=cache, model=model, optimizer=opt, fanouts=fanouts,
            batch_size=B, colors=run.colors, shard_topology=shard,
            nbr_cap=args.nbr_cap or None)
        print("pipeline: device-resident (seeds-only upload"
              + (", sharded topology)" if shard else
                 f", padded table P={args.nbr_cap})" if args.nbr_cap
                 else ")"))
        run.window = max(args.window, 1)
        if run.window > 1 and args.refresh_counter < run.window:
            print(f"note: clamping window {run.window} to refresh_counter "
                  f"{args.refresh_counter} to keep the cache-meta cadence")
            run.window = args.refresh_counter
    return run


def steps_per_epoch(run: Run, max_steps: Optional[int] = None) -> int:
    """The distributor's iterations per epoch, at most ``max_steps``
    (default ``--max_steps``; 0 = no limit)."""
    max_steps = run.args.max_steps if max_steps is None else max_steps
    n = run.scheduler.d.num_iters
    return min(n, max_steps) if max_steps else n


def resume(run: Run) -> int:
    """``--resume``, as ``examples/train.py`` does it on either loop: one
    probe batch (the host loop: the loader's first batch and its fetch;
    the resident loop: one ``begin`` / ``resolve`` from the RESUME stream,
    after which its first step is no longer a single step), then the
    latest checkpoint of ``--save_dir`` restored into the model and the
    optimizer, the run set to start at epoch ``min(step // steps_per_epoch,
    --epochs)`` (its step counter at the checkpoint's step), and the
    scheduler reset to ``--seed`` + that epoch. Prints the JAX
    CLI's line when a checkpoint was found; returns the start epoch."""
    from coala_gnn_tpu_torch.utils import checkpoint as ckpt
    from coala_gnn_tpu_torch.utils.rng import RESUME, step_generators

    args = run.args
    if run.trainer is None:
        batches = iter(run.loader)
        try:
            run.features(next(batches))
        finally:
            batches.close()
    else:
        rt = run.trainer
        gen = step_generators(args.seed, 0, 1, RESUME, run.device,
                              run.mesh.rank)[0]
        rt.resolve(rt.begin(rank_grid(run.scheduler, args.batch_size)[0],
                            gen))
        run.fresh = False
    step0 = ckpt.restore(args.save_dir, run.model, run.optimizer)
    start = 0
    if step0 is not None:
        start = min(step0 // max(steps_per_epoch(run), 1),
                    args.epochs)
        run.step = step0
        print(f"resumed from step {step0} -> starting at epoch {start}")
    run.epoch = start
    run.scheduler.reset(args.seed + start)
    return start


def _save(run: Run, spe: int) -> None:
    """``--save_dir``: the checkpoint of the epoch just trained
    (``run.epoch``), at step ``(epoch + 1) * spe``; rank 0 writes it (every
    rank holds the same parameters)."""
    from coala_gnn_tpu_torch.utils import checkpoint as ckpt

    if run.mesh.rank != 0:
        return

    ckpt.save(run.args.save_dir, run.model, run.optimizer,
              step=(run.epoch + 1) * spe)
    print(f"checkpoint saved to {run.args.save_dir}")


def train(run: Run, epochs: Optional[int] = None,
          max_steps: Optional[int] = None) -> dict:
    """The CLI's epoch loop: ``epochs`` epochs (default: up to
    ``--epochs``, from ``run.epoch``) of at most ``max_steps`` steps
    (default ``--max_steps``, 0 = the whole epoch), each printing the JAX
    CLI's epoch line (and the cache's hit ratio) and, with ``--save_dir``,
    saving its checkpoint. Returns the step losses (numpy f32), the
    epochs' wall seconds (each ending in a device sync), their
    feature-fetch seconds, the sampled edges (the sum of the block masks)
    and nodes of this rank, and each epoch's cache ``stats`` (summed over
    the ranks; none without a cache). The resident pipeline runs
    ``train_resident``."""
    if run.trainer is not None:
        return train_resident(run, epochs, max_steps)
    from coala_gnn_tpu_torch.parallel.train import make_sharded_train_step
    from coala_gnn_tpu_torch.utils.rng import DROPOUT, step_generators

    args, B, mesh = run.args, run.args.batch_size, run.mesh
    train_step = make_sharded_train_step(run.model, run.optimizer, mesh, B,
                                         masked=args.mask_tail)
    epochs = args.epochs - run.epoch if epochs is None else epochs
    spe = steps_per_epoch(run, max_steps)
    losses, epoch_s, agg_s, stats = [], [], [], []
    edges = sampled = 0
    for _ in range(epochs):
        prof = _start_profile(args.profile_dir, run)
        t0 = time.perf_counter()
        agg_time = 0.0
        loss = acc = None
        batches = iter(run.loader)
        try:
            for _, hb in zip(range(spe), batches):
                dblocks = run.blocks(hb)
                ta = time.perf_counter()
                x = run.features(hb)
                agg_time += time.perf_counter() - ta
                valid = None
                if args.mask_tail:
                    valid = run.put(hb.valid if hb.valid is not None
                                    else np.ones((1, B), bool))
                loss, acc = train_step(
                    dblocks, x, run.put(hb.labels), valid,
                    step_generators(args.seed, run.step, 1, DROPOUT,
                                    run.device, mesh.rank)[0])
                losses.append(loss)
                run.step += 1
                run.sampled += hb.sampled_nodes
                sampled += hb.sampled_nodes
                edges += hb.edges
        finally:
            batches.close()
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        if prof is not None:
            prof.stop()
            print(f"profiler trace written to {args.profile_dir}")
        dt = time.perf_counter() - t0
        epoch_s.append(dt)
        agg_s.append(agg_time)
        print(f"Epoch {run.epoch} | loss {float(loss):.4f} | batch acc "
              f"{float(acc):.4f} | Epoch Time: {dt:.3f}s | feature agg time "
              f"{agg_time:.3f}s | sampled nodes "
              f"{_host_sum(run, run.sampled)}")
        if run.cache is not None:
            stats.append(run.cache.stats())
            s = stats[-1]
            print(f"Cache hit ratio: {s['hit_ratio']:.3f} "
                  f"({s['hits']} hits / {s['misses']} misses)")
        run.loader.reset(args.seed + run.epoch + 1)
        if args.save_dir:
            _save(run, spe)
        run.epoch += 1
    return {"losses": (torch.stack(losses).float().cpu().numpy() if losses
                       else np.zeros(0, np.float32)),
            "epoch_s": epoch_s, "agg_s": agg_s, "edges": edges,
            "sampled": sampled, "stats": stats}


def _host_sum(run: Run, n: int, group="host") -> int:
    """``n`` summed over this rank's host (what the JAX CLI's one process
    per host counts), or over every rank (``group=None``); collective over
    those ranks."""
    if not run.mesh.distributed:
        return n
    t = torch.tensor([n], dtype=torch.int64, device=run.device)
    return int(run.mesh.all_reduce(
        t, group=run.mesh.host_group if group == "host" else None)[0])


def rank_grid(sched, batch_size: int) -> tuple:
    """This rank's slice of ``sched``'s next domain: (seeds int32 [1, B],
    valid bool [1, B]), the rank being the scheduler's ``local_rank``
    within its host's part (the whole domain on one card)."""
    domain = sched.run_domain()
    sl = slice(sched.local_rank * batch_size,
               (sched.local_rank + 1) * batch_size)
    return (domain[sl].reshape(1, batch_size).astype(np.int32),
            sched.domain_valid[sl].reshape(1, batch_size))


def _start_profile(profile_dir: str, run: Run):
    """A started ``torch.profiler`` session for epoch 0 of the host
    pipeline, writing its trace into ``profile_dir`` when it stops
    (``examples/train.py``'s ``jax.profiler`` trace), on rank 0; None
    otherwise."""
    if not profile_dir or run.epoch != 0 or run.mesh.rank != 0:
        return None
    acts = [torch.profiler.ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir))
    prof.start()
    return prof


#: the trainer's phases that the resident epoch line reports as its
#: "feature agg time": the host side of the miss path
AGG_PHASES = ("probe_wait", "host_gather", "stage_encode", "stage_upload",
              "insert_dispatch")


def train_resident(run: Run, epochs: Optional[int] = None,
                   max_steps: Optional[int] = None) -> dict:
    """``train`` on the resident pipeline: ``examples/train.py``'s
    ``_run_resident`` epoch loop over ``run.trainer`` (module docstring),
    printing its epoch line, whose "feature agg time" is the epoch's sum
    of the ``AGG_PHASES`` timers and whose "sampled nodes" is the epoch's
    sampled edges as JAX counts them (the run's first step left out,
    summed over the ranks), and the trainer's hit ratio. Returns what
    ``train`` returns (``edges`` and ``sampled``: the edges of every step
    trained, summed over the ranks) and ``stats``, each epoch's hits,
    misses and hit ratio (over the ranks)."""
    from coala_gnn_tpu_torch.utils.rng import DROPOUT, SAMPLE, \
        step_generators

    args, B, rt, sched = run.args, run.args.batch_size, run.trainer, \
        run.scheduler
    rt.model, rt.optimizer = run.model, run.optimizer
    K = run.window
    epochs = args.epochs - run.epoch if epochs is None else epochs
    spe = steps_per_epoch(run, max_steps)
    # the one iteration with wrapped duplicates is the epoch's last
    tail_it = -1
    if args.mask_tail and sched.d.num_iters and \
            len(sched.d.items) % sched.d.global_batch:
        tail_it = sched.d.num_iters - 1

    def gens(step: int) -> list:
        """A single step's (sampling, dropout) generators, this rank's."""
        return [step_generators(args.seed, step, 1, stream, run.device,
                                run.mesh.rank)[0]
                for stream in (SAMPLE, DROPOUT)]

    def grid() -> np.ndarray:
        return rank_grid(sched, B)[0]

    def edges_of(blocks) -> torch.Tensor:
        return sum(b.mask.sum() for b in blocks)

    def total(counts: list) -> int:
        return int(torch.stack(counts).sum()) if counts else 0

    def agg_total() -> float:
        return sum(rt.timers.totals.get(p, 0.0) for p in AGG_PHASES)

    losses, epoch_s, agg_s, stats = [], [], [], []
    # edges of the windows (summed over the ranks by the trainer) and of
    # single steps (this rank's; summed once an epoch)
    run_edges = [[], []]
    for _ in range(epochs):
        t0 = time.perf_counter()
        agg0 = agg_total()
        loss = acc = pending = None
        edge_counts = [[], []]
        it = 0
        while it < spe:
            first = run.fresh and run.step == 0
            if first or it == tail_it:
                # the run's first step (where JAX initialises its params)
                # and the masked tail step: one step, no begin ahead
                g, v = rank_grid(sched, B)
                g_sample, g_drop = gens(run.step)
                h = rt.begin(g, g_sample)
                loss, acc = rt.train_step(rt.resolve(h), g_drop,
                                          valid=v if it == tail_it else None)
                losses.append(loss.reshape(1))
                run_edges[1].append(edges_of(h.blocks))
                if not first:
                    edge_counts[1].append(run_edges[1][-1])
                run.step += 1
                it += 1
            elif K > 1:
                k_here = min(K, spe - it)
                if tail_it >= 0 and it < tail_it < it + k_here:
                    k_here = tail_it - it   # stop the window before the tail
                g = np.stack([grid() for _ in range(k_here)], axis=1)
                wl, we = rt.train_window(g, args.seed, window=run.step)
                loss = wl[-1]
                losses.append(wl)
                edge_counts[0].append(we.sum())
                run_edges[0].append(edge_counts[0][-1])
                run.step += k_here
                it += k_here
            else:
                nxt = pending if pending is not None else rt.begin(
                    grid(), gens(run.step)[0])
                pending = None
                if it + 1 < spe and it + 1 != tail_it:
                    pending = rt.begin(grid(), gens(run.step + 1)[0])
                loss, acc = rt.train_step(rt.resolve(nxt),
                                          gens(run.step)[1])
                losses.append(loss.reshape(1))
                edge_counts[1].append(edges_of(nxt.blocks))
                run_edges[1].append(edge_counts[1][-1])
                run.step += 1
                it += 1
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        dt = time.perf_counter() - t0
        epoch_s.append(dt)
        agg_s.append(agg_total() - agg0)
        sampled = total(edge_counts[0]) + _host_sum(
            run, total(edge_counts[1]), group=None)
        acc_s = f"{float(acc):.4f}" if acc is not None else "n/a"
        print(f"Epoch {run.epoch} | loss {float(loss):.4f} | batch acc "
              f"{acc_s} | Epoch Time: {dt:.3f}s | feature agg time "
              f"{agg_s[-1]:.3f}s | sampled nodes {sampled}")
        stats.append(rt.stats())
        s = stats[-1]
        print(f"Cache hit ratio: {s['hit_ratio']:.3f} "
              f"({s['hits']} hits / {s['misses']} misses)")
        sched.reset(args.seed + run.epoch + 1)
        if args.save_dir:
            _save(run, spe)
        run.epoch += 1
    edges = total(run_edges[0]) + _host_sum(run, total(run_edges[1]),
                                            group=None)
    return {"losses": (torch.cat(losses).float().cpu().numpy() if losses
                       else np.zeros(0, np.float32)),
            "epoch_s": epoch_s, "agg_s": agg_s, "edges": edges,
            "sampled": edges, "stats": stats}


def evaluate(run: Run) -> tuple:
    """Test accuracy over every test node once: the last batch wraps
    (static shapes) and its wrapped slots are left out. Prints the JAX
    CLI's line; returns (correct, total). On the resident pipeline each
    batch goes through the trainer's ``begin`` / ``resolve`` /
    ``eval_step``, its sampling stream ``(seed, batch, 0, EVAL)`` (this
    rank's), its count summed over the ranks. Over several ranks each rank
    evaluates its slice of each batch and the correct counts are summed
    (on the host pipeline one ``all_reduce`` at the end)."""
    from coala_gnn_tpu_torch.data.loader import CoalaDataLoader
    from coala_gnn_tpu_torch.distribution import (DistributionScheduler,
                                                  SeedDistributor)
    from coala_gnn_tpu_torch.parallel.train import make_sharded_eval_step

    ds, B, mesh = run.ds, run.args.batch_size, run.mesh
    eval_distributor = SeedDistributor(
        ds.test_idx, batch_size=B, local_size=mesh.local_size,
        num_parts=mesh.num_hosts, mode="baseline",
        shuffle_seed=run.args.seed, drop_tail=False)
    n_test, gb = len(ds.test_idx), eval_distributor.global_batch
    if run.trainer is not None:
        from coala_gnn_tpu_torch.utils.rng import EVAL, step_generators

        rt, sched = run.trainer, DistributionScheduler(
            eval_distributor, part_id=mesh.host_id,
            local_rank=mesh.local_rank)
        correct = total = 0
        for it in range(eval_distributor.num_iters):
            grid, valid = rank_grid(sched, B)
            gen = step_generators(run.args.seed, it, 1, EVAL, run.device,
                                  mesh.rank)[0]
            correct += rt.eval_step(rt.resolve(rt.begin(grid, gen)), valid)
            total += min(gb, n_test - it * gb)
        print(f"Test accuracy: {correct / max(total, 1):.4f} ({total} "
              "nodes)")
        return correct, total
    eval_loader = CoalaDataLoader(
        scheduler=DistributionScheduler(eval_distributor,
                                        part_id=mesh.host_id,
                                        local_rank=mesh.local_rank),
        sampler=run.sampler, labels=ds.labels, local_size=1, prefetch=2)
    eval_slot = make_sharded_eval_step(run.model, mesh, B, per_slot=True)
    correct = total = 0
    for it, hb in enumerate(eval_loader):
        ok = eval_slot(run.blocks(hb), run.features(hb), run.put(hb.labels))
        correct += int((ok.cpu().numpy() & hb.valid).sum())
        total += min(gb, n_test - it * gb)
    if mesh.distributed:
        correct = int(mesh.all_reduce(torch.tensor(
            [correct], dtype=torch.int64, device=run.device))[0])
    print(f"Test accuracy: {correct / max(total, 1):.4f} ({total} nodes)")
    return correct, total


def train_rank(mesh, args) -> dict:
    """One rank's whole run on its ``mesh`` (``build`` on the mesh's
    device, ``resume`` with ``--resume``, ``train``, ``evaluate`` with
    ``--eval``), as ``multihost.launch`` or torchrun starts it; every rank
    of the mesh runs it. Returns ``train``'s dict with ``eval``
    ((correct, total), or None without ``--eval``), the rank, its
    ``CommLedger`` snapshot and its kernel launch counts."""
    from coala_gnn_tpu_torch.ops.gather_spmm import LAUNCHES

    args = copy.copy(args)
    args.device = str(mesh.device)
    run = build(args, mesh=mesh)
    if args.resume:
        resume(run)
    out = train(run)
    out["eval"] = evaluate(run) if args.eval else None
    out.update(rank=mesh.rank, ledger=mesh.ledger.snapshot(),
               launches=dict(LAUNCHES))
    return out


def rank_devices(args) -> list:
    """One device per rank of ``--devices N``: ``cuda:0`` .. ``cuda:N-1``
    (a ``ValueError`` if the machine has fewer cards), or N times the CPU
    with ``--device cpu``."""
    n = args.devices
    if torch.device(args.device).type != "cuda":
        return ["cpu"] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(f"--devices {n} runs one rank per card, and this "
                         f"machine has {have} CUDA card(s); pass --device "
                         "cpu for CPU ranks")
    return [f"cuda:{r}" for r in range(n)]


def main(argv=None):
    """The CLI: one card, ``--devices N`` ranks spawned here, or this
    process as one rank of a torchrun (or ``COALA_COORDINATOR``) job.
    Returns the ranks' ``train_rank`` results on a data-parallel run."""
    from coala_gnn_tpu_torch.parallel import multihost
    from coala_gnn_tpu_torch.parallel.mesh import make_mesh

    args = parse_args(argv)
    refuse_unported(args)
    backend = multihost.backend_for(args.device)
    if "WORLD_SIZE" in os.environ or os.environ.get("COALA_COORDINATOR"):
        device = torch.device(args.device)
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
            torch.cuda.set_device(device)
        multihost.initialize_distributed(backend)
        try:
            mesh = make_mesh(device)
            if args.devices > 1 and args.devices != mesh.local_size:
                raise ValueError(f"--devices {args.devices}: this job has "
                                 f"{mesh.local_size} ranks per host")
            return [train_rank(mesh, args)]
        finally:
            torch.distributed.destroy_process_group()
    if args.devices > 1:
        return multihost.launch(train_rank, args.devices, rank_devices(args),
                                backend, args=(args,))
    run = build(args)
    if args.resume:
        resume(run)
    train(run)
    if args.eval:
        evaluate(run)


if __name__ == "__main__":
    main()
