"""Mini-batch GNN training on one device: the port's counterpart of
``examples/train.py``'s host pipeline (its default path).

    python -m coala_gnn_tpu_torch.train --fan_out 10,5 --batch_size 1024 \\
        --hidden_channels 256 --feature_dim 256 --num_nodes 200000 \\
        --cache_size 1024 --epochs 1 --max_steps 50 --eval

Per step: seed distribution (``distribution/``), host sampling
(``sampling/neighbor.py``), the blocks and labels uploaded, the features
through the cache front (``parallel/sharded_cache.py``, a synchronous
``fetch``) or, with ``--cache_size 0``, gathered on the host and uploaded,
then the data-parallel step on one device (``parallel/train.py``). The
flags are ``examples/train.py``'s; each one not ported yet raises
``NotImplementedError`` naming its ROADMAP.md item, and none is ignored.
Runs on the card (``--device cuda``, the default, raises without one)
unless ``--device cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

#: the ROADMAP.md items that the flags not ported yet name
_ROADMAP = {
    "hetero": "ROADMAP.md queue A, \"hetero models and typed sampling\"",
    "nbr_cap": "ROADMAP.md queue A, \"dedup=True and nbr_cap sampling\"",
    "multi": "ROADMAP.md queue A, \"multi-GPU\"",
    "ckpt": "ROADMAP.md queue A, \"checkpoint and rng\"",
    "cli": "ROADMAP.md queue A, \"CLI --pipeline resident on the port's "
           "ResidentTrainer\"",
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
    whose value is not ported."""
    checks = [
        (args.model_type in ("rsage", "rgcn", "rgat"),
         f"--model_type {args.model_type}", "hetero"),
        (args.num_edge_types > 1, "--num_edge_types > 1", "hetero"),
        (args.nbr_cap > 0, "--nbr_cap", "nbr_cap"),
        (args.devices > 1, f"--devices {args.devices}", "multi"),
        (args.distribution == "node_color", "--distribution node_color",
         "multi"),
        (bool(args.color_dir), "--color_dir (node_color metadata)", "multi"),
        (args.shard_topology, "--shard_topology", "multi"),
        (bool(args.save_dir) or args.resume, "--save_dir / --resume",
         "ckpt"),
        (args.pipeline == "resident", "--pipeline resident", "cli"),
        (args.window > 1, "--window (a resident-pipeline knob)", "cli"),
        (bool(args.profile_dir), "--profile_dir", "cli"),
        (args.data != "synthetic" or bool(args.path) or
         args.dataset_size != "tiny",
         "real datasets (--data, --path, --dataset_size)", "cli"),
        (bool(args.rng_impl), "--rng_impl (a JAX PRNG family)", "jax_only"),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet: "
                                      f"{_ROADMAP[item]}")


def main(argv=None) -> None:
    args = parse_args(argv)
    refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card here; pass "
                           "--device cpu to train on the CPU")

    from coala_gnn_tpu_torch.cache import feature_cache as fc
    from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu_torch.data.loader import CoalaDataLoader
    from coala_gnn_tpu_torch.distribution import (DistributionScheduler,
                                                  SeedDistributor)
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.models.layers import DeviceBlock
    from coala_gnn_tpu_torch.parallel.sharded_cache import \
        ShardedFeatureCache
    from coala_gnn_tpu_torch.parallel.train import (make_sharded_eval_step,
                                                    make_sharded_train_step)
    from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler
    from coala_gnn_tpu_torch.utils.rng import DROPOUT, step_generators

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"torch {torch.__version__}, device: {device} ({name})")
    fanouts = [int(f) for f in args.fan_out.split(",")]
    num_layers = args.num_layers or len(fanouts)
    if num_layers != len(fanouts):
        raise ValueError("--num_layers must match --fan_out")

    ds = synthetic_graph(num_nodes=args.num_nodes,
                         avg_degree=args.avg_degree,
                         feature_dim=args.feature_dim,
                         num_classes=args.num_classes, seed=args.seed)
    print(f"dataset {ds.name}: {ds.graph.num_nodes} nodes, "
          f"{ds.graph.num_edges} edges, dim {ds.feature_dim}, "
          f"{ds.num_classes} classes, {len(ds.train_idx)} train")
    B = args.batch_size
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=args.seed)
    print(f"sampler native: {sampler._native is not None}")
    print("hosts: 1 (this=0), local devices: 1")
    devices = [device]

    distributor = SeedDistributor(
        ds.train_idx, batch_size=B, local_size=1, num_parts=1,
        mode=args.distribution, shuffle_seed=args.seed,
        drop_tail=not (args.keep_tail or args.mask_tail))
    scheduler = DistributionScheduler(distributor, part_id=0, local_rank=0,
                                      refresh_counter=args.refresh_counter)
    # --dtype: the cache lines' dtype and the model's compute dtype
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = make_model(args.model_type, ds.feature_dim, args.hidden_channels,
                       ds.num_classes, num_layers, num_heads=args.num_heads,
                       seed=args.seed, dtype=dtype).to(device)
    optimizer = (torch.optim.AdamW(model.parameters(), lr=args.learning_rate,
                                   weight_decay=args.decay) if args.decay
                 else torch.optim.Adam(model.parameters(),
                                       lr=args.learning_rate))

    store = HostFeatureStore(ds.features)
    cache = None
    if args.cache_size > 0:
        mode = {"nvshmem": "sharded", "nccl": "sharded"}.get(
            args.cache_backend, args.cache_backend)
        cfg = fc.make_config(cache_mb=args.cache_size, dim=ds.feature_dim,
                             dtype=dtype, quantize=args.quantize)
        cache = ShardedFeatureCache(cfg, devices, mode=mode)
        scheduler.meta_fn = cache.local_color_meta
        print(f"cache[{mode}]: {cfg.num_sets} sets x {cfg.ways} ways "
              f"({cfg.size_mb:.0f} MB per device"
              + (", int8 lines)" if args.quantize else ")"))

    def put(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def to_device_stacked(hb):
        return [DeviceBlock(adj=put(a), mask=put(m))
                for a, m in zip(hb.adjs, hb.masks)]

    def fetch_batch(hb) -> torch.Tensor:
        if cache is None:
            return put(np.stack([store.fetch(ids) for ids in hb.input_ids]))
        return cache.fetch(hb.input_ids, hb.num_input, store.fetch)

    loader = CoalaDataLoader(scheduler=scheduler, sampler=sampler,
                             labels=ds.labels, local_size=1, prefetch=2)
    train_step = make_sharded_train_step(model, optimizer, devices, B,
                                         masked=args.mask_tail)
    steps_per_epoch = len(loader)
    if args.max_steps:
        steps_per_epoch = min(steps_per_epoch, args.max_steps)

    sampled_total = step_no = 0
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        agg_time = 0.0
        loss = acc = None
        batches = iter(loader)
        try:
            for _, hb in zip(range(steps_per_epoch), batches):
                dblocks = to_device_stacked(hb)
                ta = time.perf_counter()
                x = fetch_batch(hb)
                agg_time += time.perf_counter() - ta
                valid = None
                if args.mask_tail:
                    valid = put(hb.valid if hb.valid is not None
                                else np.ones((1, B), bool))
                loss, acc = train_step(
                    dblocks, x, put(hb.labels), valid,
                    step_generators(args.seed, step_no, 1, DROPOUT,
                                    device)[0])
                step_no += 1
                sampled_total += hb.sampled_nodes
        finally:
            batches.close()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        print(f"Epoch {epoch} | loss {float(loss):.4f} | batch acc "
              f"{float(acc):.4f} | Epoch Time: {dt:.3f}s | feature agg time "
              f"{agg_time:.3f}s | sampled nodes {sampled_total}")
        if cache is not None:
            s = cache.stats()
            print(f"Cache hit ratio: {s['hit_ratio']:.3f} "
                  f"({s['hits']} hits / {s['misses']} misses)")
        loader.reset(args.seed + epoch + 1)

    if args.eval:
        # exact tail: the last batch wraps (static shapes) and the wrapped
        # slots are left out of the count, so every test node counts once
        eval_distributor = SeedDistributor(
            ds.test_idx, batch_size=B, local_size=1, num_parts=1,
            mode="baseline", shuffle_seed=args.seed, drop_tail=False)
        eval_loader = CoalaDataLoader(
            scheduler=DistributionScheduler(eval_distributor, part_id=0,
                                            local_rank=0),
            sampler=sampler, labels=ds.labels, local_size=1, prefetch=2)
        eval_slot = make_sharded_eval_step(model, devices, B, per_slot=True)
        correct = total = 0
        n_test, gb = len(ds.test_idx), eval_distributor.global_batch
        for it, hb in enumerate(eval_loader):
            ok = eval_slot(to_device_stacked(hb), fetch_batch(hb),
                           put(hb.labels))
            correct += int((ok.cpu().numpy() & hb.valid).sum())
            total += min(gb, n_test - it * gb)
        print(f"Test accuracy: {correct / max(total, 1):.4f} "
              f"({total} nodes)")


if __name__ == "__main__":
    main()
