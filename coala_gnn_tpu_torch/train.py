"""Mini-batch GNN training on one device: the port's counterpart of
``examples/train.py``, its host pipeline (the default) and its
``--pipeline resident``.

    python -m coala_gnn_tpu_torch.train --fan_out 10,5 --batch_size 1024 \\
        --hidden_channels 256 --feature_dim 256 --num_nodes 200000 \\
        --cache_size 1024 --epochs 1 --max_steps 50 --eval \\
        [--pipeline resident --window 8]

Host pipeline, per step: seed distribution (``distribution/``), host
sampling (``sampling/neighbor.py``), the blocks and labels uploaded, the
features through the cache front (``parallel/sharded_cache.py``, a
synchronous ``fetch``) or, with ``--cache_size 0``, gathered on the host
and uploaded, then the data-parallel step on one device
(``parallel/train.py``). ``--profile_dir`` traces its epoch 0 with
``torch.profiler``.

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
single step from ``(seed, its run step, 0)``.

The hetero models (``--model_type rsage|rgcn|rgat``) train on the
synthetic graph with random edge types (``--num_edge_types``, 3 when it is
below 2), drawn as ``examples/train.py`` draws them, on either pipeline.
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
The flags are ``examples/train.py``'s; each one not ported yet raises
``NotImplementedError`` naming its ROADMAP.md item, and none is ignored.
Runs on the card (``--device cuda``, the default, raises without one)
unless ``--device cpu`` is asked for.

``main`` is ``build`` (the dataset, sampler, loader, cache front, model
and optimizer, and the resident trainer), ``resume`` (with ``--resume``),
``train`` (the epoch loop, which returns the step losses and the epochs'
times) and ``evaluate``; a caller may drive them itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

#: the hetero model types
HETERO = ("rsage", "rgcn", "rgat")

#: the ROADMAP.md items that the flags not ported yet name
_ROADMAP = {
    "multi": "ROADMAP.md queue A, \"multi-GPU\"",
    "data": "ROADMAP.md queue A, \"the real datasets\"",
    "jax_only": "ROADMAP.md queue A, \"Not ported: code the system does not "
                "need on a GPU\"",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="COALA-GNN trainer, PyTorch port (one device)")
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
                   help="on one device every backend is the device's own "
                        "cache")
    p.add_argument("--devices", type=int, default=0,
                   help="local devices; 0 or 1 = one device (more are not "
                        "ported)")
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
    p.add_argument("--shard_topology", action="store_true")
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
    1`` with a homogeneous model, ``--window > 1`` or ``--nbr_cap`` on the
    host pipeline, ``--profile_dir`` with ``--pipeline resident``,
    ``--resume`` without ``--save_dir``, ``--color_dir`` without
    ``--distribution node_color``; and for ``node_color`` without
    ``--color_dir``, which it needs."""
    checks = [
        (args.devices > 1, f"--devices {args.devices}", "multi"),
        (args.shard_topology, "--shard_topology", "multi"),
        (args.data != "synthetic" or bool(args.path) or
         args.dataset_size != "tiny",
         "real datasets (--data, --path, --dataset_size)", "data"),
        (bool(args.rng_impl), "--rng_impl (a JAX PRNG family)", "jax_only"),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet: "
                                      f"{_ROADMAP[item]}")
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
    initialises its params), until a ``resume`` probe has run."""

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


def build(args, ds=None) -> Run:
    """Everything the CLI trains with, printing what ``examples/train.py``
    prints: the model with the JAX CLI's dropout 0.5, Adam (AdamW with
    ``--decay``). ``ds``: the dataset to train on (default: the synthetic
    graph of the flags)."""
    if args.pipeline == "resident" and args.cache_size <= 0:
        raise SystemExit("--pipeline resident requires --cache_size > 0")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card here; pass "
                           "--device cpu to train on the CPU")

    from coala_gnn_tpu_torch.cache import feature_cache as fc
    from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu_torch.coloring import load_color_metadata
    from coala_gnn_tpu_torch.data.loader import CoalaDataLoader
    from coala_gnn_tpu_torch.distribution import (DistributionScheduler,
                                                  SeedDistributor)
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.models.hetero import make_hetero_model
    from coala_gnn_tpu_torch.parallel.sharded_cache import \
        ShardedFeatureCache
    from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"torch {torch.__version__}, device: {device} ({name})")
    fanouts = [int(f) for f in args.fan_out.split(",")]
    num_layers = args.num_layers or len(fanouts)
    if num_layers != len(fanouts):
        raise ValueError("--num_layers must match --fan_out")

    if ds is None:
        ds = synthetic_graph(num_nodes=args.num_nodes,
                             avg_degree=args.avg_degree,
                             feature_dim=args.feature_dim,
                             num_classes=args.num_classes, seed=args.seed)
    hetero = args.model_type in HETERO
    if hetero:
        ds = with_edge_types(ds, args.num_edge_types, args.seed)
    print(f"dataset {ds.name}: {ds.graph.num_nodes} nodes, "
          f"{ds.graph.num_edges} edges, dim {ds.feature_dim}, "
          f"{ds.num_classes} classes, {len(ds.train_idx)} train"
          + (f", {ds.graph.num_edge_types} edge types" if hetero else ""))
    B = args.batch_size
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=args.seed)
    print(f"sampler native: {sampler._native is not None}")
    print("hosts: 1 (this=0), local devices: 1")
    devices = [device]

    meta = None
    if args.distribution == "node_color":
        meta = load_color_metadata(args.color_dir)
    distributor = SeedDistributor(
        ds.train_idx, batch_size=B, local_size=1, num_parts=1,
        mode=args.distribution,
        color=None if meta is None else meta.color,
        topk_colors=None if meta is None else meta.topk,
        affinity=None if meta is None else meta.score,
        shuffle_seed=args.seed,
        drop_tail=not (args.keep_tail or args.mask_tail))
    scheduler = DistributionScheduler(distributor, part_id=0, local_rank=0,
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
        cfg = fc.make_config(cache_mb=args.cache_size, dim=ds.feature_dim,
                             num_colors=0 if meta is None
                             else meta.num_colors,
                             dtype=dtype, quantize=args.quantize)
        cache = ShardedFeatureCache(cfg, devices, mode=mode)
        scheduler.meta_fn = cache.local_color_meta
        print(f"cache[{mode}]: {cfg.num_sets} sets x {cfg.ways} ways "
              f"({cfg.size_mb:.0f} MB per device"
              + (", int8 lines)" if args.quantize else ")"))

    loader = CoalaDataLoader(scheduler=scheduler, sampler=sampler,
                             labels=ds.labels, local_size=1, prefetch=2)
    run = Run(args=args, device=device, ds=ds, model=model, optimizer=opt,
              sampler=sampler, loader=loader, store=store, cache=cache,
              meta=meta)
    if args.pipeline == "resident":
        from coala_gnn_tpu_torch.parallel.sharded_resident import \
            ShardedResidentTrainer

        run.trainer = ShardedResidentTrainer(
            graph=ds.graph, host_fetch=store.fetch, labels=ds.labels,
            cache=cache, model=model, optimizer=opt, fanouts=fanouts,
            batch_size=B, colors=run.colors,
            nbr_cap=args.nbr_cap or None)
        print("pipeline: device-resident (seeds-only upload"
              + (f", padded table P={args.nbr_cap})" if args.nbr_cap
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
        grid = run.scheduler.run_domain().reshape(1, args.batch_size)
        gen = step_generators(args.seed, 0, 1, RESUME, run.device)[0]
        rt.resolve(rt.begin(grid.astype(np.int32), gen))
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
    (``run.epoch``), at step ``(epoch + 1) * spe``."""
    from coala_gnn_tpu_torch.utils import checkpoint as ckpt

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
    and nodes. The resident pipeline runs ``train_resident``."""
    if run.trainer is not None:
        return train_resident(run, epochs, max_steps)
    from coala_gnn_tpu_torch.parallel.train import make_sharded_train_step
    from coala_gnn_tpu_torch.utils.rng import DROPOUT, step_generators

    args, B = run.args, run.args.batch_size
    train_step = make_sharded_train_step(run.model, run.optimizer,
                                         [run.device], B,
                                         masked=args.mask_tail)
    epochs = args.epochs - run.epoch if epochs is None else epochs
    spe = steps_per_epoch(run, max_steps)
    losses, epoch_s, agg_s = [], [], []
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
                                    run.device)[0])
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
              f"{agg_time:.3f}s | sampled nodes {run.sampled}")
        if run.cache is not None:
            s = run.cache.stats()
            print(f"Cache hit ratio: {s['hit_ratio']:.3f} "
                  f"({s['hits']} hits / {s['misses']} misses)")
        run.loader.reset(args.seed + run.epoch + 1)
        if args.save_dir:
            _save(run, spe)
        run.epoch += 1
    return {"losses": (torch.stack(losses).float().cpu().numpy() if losses
                       else np.zeros(0, np.float32)),
            "epoch_s": epoch_s, "agg_s": agg_s, "edges": edges,
            "sampled": sampled}


def _start_profile(profile_dir: str, run: Run):
    """A started ``torch.profiler`` session for epoch 0 of the host
    pipeline, writing its trace into ``profile_dir`` when it stops
    (``examples/train.py``'s ``jax.profiler`` trace); None otherwise."""
    if not profile_dir or run.epoch != 0:
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
    sampled edges as JAX counts them (the run's first step left out), and
    the trainer's hit ratio. Returns what ``train`` returns (``edges`` and
    ``sampled``: the edges of every step trained) and ``stats``, each
    epoch's hits, misses and hit ratio."""
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
        """A single step's (sampling, dropout) generators."""
        return [step_generators(args.seed, step, 1, stream, run.device)[0]
                for stream in (SAMPLE, DROPOUT)]

    def grid() -> np.ndarray:
        return sched.run_domain().reshape(1, B).astype(np.int32)

    def edges_of(blocks) -> torch.Tensor:
        return sum(b.mask.sum() for b in blocks)

    def agg_total() -> float:
        return sum(rt.timers.totals.get(p, 0.0) for p in AGG_PHASES)

    losses, epoch_s, agg_s, all_edges, stats = [], [], [], [], []
    for _ in range(epochs):
        t0 = time.perf_counter()
        agg0 = agg_total()
        loss = acc = pending = None
        edge_counts = []
        it = 0
        while it < spe:
            first = run.fresh and run.step == 0
            if first or it == tail_it:
                # the run's first step (where JAX initialises its params)
                # and the masked tail step: one step, no begin ahead
                g = grid()
                v = sched.domain_valid.reshape(1, B) if it == tail_it \
                    else None
                g_sample, g_drop = gens(run.step)
                h = rt.begin(g, g_sample)
                loss, acc = rt.train_step(rt.resolve(h), g_drop, valid=v)
                losses.append(loss.reshape(1))
                all_edges.append(edges_of(h.blocks))
                if not first:
                    edge_counts.append(all_edges[-1])
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
                edge_counts.append(we.sum())
                all_edges.append(edge_counts[-1])
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
                edge_counts.append(edges_of(nxt.blocks))
                all_edges.append(edge_counts[-1])
                run.step += 1
                it += 1
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        dt = time.perf_counter() - t0
        epoch_s.append(dt)
        agg_s.append(agg_total() - agg0)
        sampled = int(torch.stack(edge_counts).sum()) if edge_counts else 0
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
    edges = int(torch.stack(all_edges).sum()) if all_edges else 0
    return {"losses": (torch.cat(losses).float().cpu().numpy() if losses
                       else np.zeros(0, np.float32)),
            "epoch_s": epoch_s, "agg_s": agg_s, "edges": edges,
            "sampled": edges, "stats": stats}


def evaluate(run: Run) -> tuple:
    """Test accuracy over every test node once: the last batch wraps
    (static shapes) and its wrapped slots are left out. Prints the JAX
    CLI's line; returns (correct, total). On the resident pipeline each
    batch goes through the trainer's ``begin`` / ``resolve`` /
    ``eval_step``, its sampling stream ``(seed, batch, 0, EVAL)``."""
    from coala_gnn_tpu_torch.data.loader import CoalaDataLoader
    from coala_gnn_tpu_torch.distribution import (DistributionScheduler,
                                                  SeedDistributor)
    from coala_gnn_tpu_torch.parallel.train import make_sharded_eval_step

    ds, B = run.ds, run.args.batch_size
    eval_distributor = SeedDistributor(
        ds.test_idx, batch_size=B, local_size=1, num_parts=1,
        mode="baseline", shuffle_seed=run.args.seed, drop_tail=False)
    n_test, gb = len(ds.test_idx), eval_distributor.global_batch
    if run.trainer is not None:
        from coala_gnn_tpu_torch.utils.rng import EVAL, step_generators

        rt, sched = run.trainer, DistributionScheduler(
            eval_distributor, part_id=0, local_rank=0)
        correct = total = 0
        for it in range(eval_distributor.num_iters):
            grid = sched.run_domain().reshape(1, B).astype(np.int32)
            valid = sched.domain_valid.reshape(1, B)
            gen = step_generators(run.args.seed, it, 1, EVAL, run.device)[0]
            correct += rt.eval_step(rt.resolve(rt.begin(grid, gen)), valid)
            total += min(gb, n_test - it * gb)
        print(f"Test accuracy: {correct / max(total, 1):.4f} ({total} "
              "nodes)")
        return correct, total
    eval_loader = CoalaDataLoader(
        scheduler=DistributionScheduler(eval_distributor, part_id=0,
                                        local_rank=0),
        sampler=run.sampler, labels=ds.labels, local_size=1, prefetch=2)
    eval_slot = make_sharded_eval_step(run.model, [run.device], B,
                                       per_slot=True)
    correct = total = 0
    for it, hb in enumerate(eval_loader):
        ok = eval_slot(run.blocks(hb), run.features(hb), run.put(hb.labels))
        correct += int((ok.cpu().numpy() & hb.valid).sum())
        total += min(gb, n_test - it * gb)
    print(f"Test accuracy: {correct / max(total, 1):.4f} ({total} nodes)")
    return correct, total


def main(argv=None) -> None:
    args = parse_args(argv)
    refuse_unported(args)
    run = build(args)
    if args.resume:
        resume(run)
    train(run)
    if args.eval:
        evaluate(run)


if __name__ == "__main__":
    main()
