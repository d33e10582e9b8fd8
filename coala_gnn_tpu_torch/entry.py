"""The port's entry points (counterparts of ``__graft_entry__.py``).

``entry(device="cuda")`` -> ``(fn, args)``: the flagship model's forward,
GraphSAGE-mean over blocks of the host sampler, ``fn(params, blocks, x)
-> logits``, with ``params`` a ``{name: tensor}`` dict (the model's own,
or a JAX tree carried across by ``utils.convert.params_from_flax``), on
the card unless the caller asks for the CPU.

``dryrun_multichip(n, device="cuda")`` trains on tiny shapes through both
pipelines of the JAX package's dry run, with its checks, over ``n`` ranks
(one process each, ``parallel/multihost.launch``; one card on its own at
``n = 1``):

1. the host path: ``node_color`` seed distribution with the cache's color
   meta (every rank's, summed over the host: the meta exchange) refreshed
   every step, host sampling of each rank's slice, the cache front's fetch
   over the ranks and the data-parallel step, 8 steps; finite loss, warm
   hit ratio > 0.5;
2. the resident path (``ShardedResidentTrainer`` on the mesh): 4 per-step
   ``begin`` / ``resolve`` / ``train_step`` warm-up steps (hit ratio >
   0.3), one fused staged window of K = 4 (finite losses, edges, no
   replay, hit ratio > 0.5) and one eval batch;
3. (n > 1) the sharded topology: a rank's edge shard below the graph's
   edges, 2 steps and the window, finite losses;
4. (n > 1, even) node_local over two hosts of n / 2 ranks, the padded
   table (``nbr_cap=8``), a cache prewarmed with every node: 2 steps and
   the window at hit ratio 1.0.

A rank's cache holds ``8 * per`` sets of 32 ways and a step trains ``8 *
per`` seeds a rank, ``per = max(1, 8 // n)``: at n = 1 the 2,048 lines and
the global batch that the JAX dry run spreads over its 8 devices (JAX's
own run at one device, 8 sets and 8 seeds a step, fails its hit-ratio
floors: ROADMAP.md section C), at n = 8 JAX's own shapes.

    python -m coala_gnn_tpu_torch.entry [--device cpu] [--ranks N]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

#: the dry run's cache sets and seeds a step at one rank: the total lines
#: and the global batch of JAX's 8-device run
DRYRUN_SETS, DRYRUN_BATCH = 64, 64


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA card here; pass "
                           "device='cpu' to run on the CPU")
    return device


def _build_problem(device, num_nodes: int = 2000, dim: int = 128,
                  num_classes: int = 8, batch: int = 32,
                  fanouts=(5, 5), seed: int = 0) -> tuple:
    """JAX's ``_build_problem``: (dataset, model, host batch, blocks, x)
    for the train set's first ``batch`` seeds, model and tensors on
    ``device``."""
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.models.layers import blocks_to_device
    from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler

    ds = synthetic_graph(num_nodes=num_nodes, avg_degree=10,
                         feature_dim=dim, num_classes=num_classes, seed=seed)
    sampler = NeighborSampler(ds.graph, list(fanouts), batch, seed=seed)
    batch_s = sampler.sample(ds.train_idx[:batch])
    model = make_model("sage", dim, 128, num_classes, len(fanouts),
                       seed=seed).to(device)
    x = torch.from_numpy(ds.features[batch_s.input_ids]).to(device)
    return ds, model, batch_s, blocks_to_device(batch_s.blocks, device), x


def entry(device="cuda"):
    """The flagship forward: ``fn(params, blocks, x) -> logits`` and its
    example arguments (the model's parameters, one sampled batch)."""
    device = _device(device)
    _, model, _, blocks, x = _build_problem(device)
    model.eval()

    def fn(params, blocks, x):
        with torch.no_grad():
            return torch.func.functional_call(model, params, (blocks, x),
                                              {"train": False})

    params = {k: v.detach() for k, v in model.named_parameters()}
    return fn, (params, blocks, x)


def dryrun_multichip(n_devices: int, device="cuda",
                     devices: Optional[Sequence] = None,
                     backend: Optional[str] = None,
                     timeout: Optional[float] = None) -> dict:
    """Both pipelines for real on tiny shapes (module docstring) over
    ``n_devices`` ranks; returns what rank 0's legs measured. The ranks
    run on ``devices`` (default: ``cuda:0`` .. ``cuda:n-1``, or the CPU)
    over ``backend`` (default: nccl on cards, gloo on the CPU), their
    process group failing a collective that waits ``timeout`` s."""
    device = _device(device)
    if n_devices == 1:
        from coala_gnn_tpu_torch.parallel.mesh import Mesh

        return _dryrun(Mesh(device=device))
    from coala_gnn_tpu_torch.parallel import multihost

    if devices is None:
        if device.type == "cuda" and torch.cuda.device_count() < n_devices:
            raise ValueError(
                f"dryrun_multichip({n_devices}) runs one rank per card and "
                f"this machine has {torch.cuda.device_count()}: pass "
                "devices (e.g. the one card n times, over gloo) or "
                "device='cpu'")
        devices = ([f"cuda:{r}" for r in range(n_devices)]
                   if device.type == "cuda" else ["cpu"] * n_devices)
    backend = backend or multihost.backend_for(torch.device(devices[0]))
    return multihost.launch(_dryrun, n_devices, list(devices), backend,
                            timeout=timeout)[0]


def _dryrun(mesh) -> dict:
    """The dry run's legs on this rank (every rank runs it)."""
    from coala_gnn_tpu_torch.cache import feature_cache as fc
    from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu_torch.coloring import generate_color_metadata
    from coala_gnn_tpu_torch.distribution import SeedDistributor
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.models.layers import blocks_to_device
    from coala_gnn_tpu_torch.parallel.multihost import make_meta_exchange_fn
    from coala_gnn_tpu_torch.parallel.sharded_cache import \
        ShardedFeatureCache
    from coala_gnn_tpu_torch.parallel.sharded_resident import \
        ShardedResidentTrainer
    from coala_gnn_tpu_torch.parallel.train import make_sharded_train_step
    from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler
    from coala_gnn_tpu_torch.utils.rng import (DROPOUT, EVAL, SAMPLE,
                                               rank_seed, step_generators)

    n, r, device = mesh.world, mesh.rank, mesh.device
    per = max(1, 8 // n)
    B, fanouts, dim = DRYRUN_BATCH // 8 * per, [3, 3], 32
    ds = synthetic_graph(num_nodes=1500, avg_degree=8, feature_dim=dim,
                         num_classes=4, seed=2)
    meta = generate_color_metadata(ds.graph, ds.train_idx, base_rate=0.02,
                                   seed=0)
    store = HostFeatureStore(ds.features)
    cfg = fc.CacheConfig(num_sets=DRYRUN_SETS // 8 * per, ways=fc.WAYS,
                         dim=dim, cache_dim=fc.round_cache_dim(dim),
                         num_colors=meta.num_colors, num_shards=n)
    cache = ShardedFeatureCache(cfg, mesh, mode="sharded")
    distributor = SeedDistributor(ds.train_idx, batch_size=B, local_size=n,
                                  num_parts=1, mode="node_color",
                                  color=meta.color, topk_colors=meta.topk,
                                  affinity=meta.score, shuffle_seed=0)
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=rank_seed(0, r))
    model = make_model("sage", dim, 16, 4, 2).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_sharded_train_step(model, opt, mesh, B)
    exchange = make_meta_exchange_fn(mesh, meta.num_colors)
    tag = f"dryrun_multichip({n})"

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def domain_at(it: int, c) -> np.ndarray:
        """Iteration ``it``'s domain, scored against ``c``'s color meta
        summed over the ranks (the same on every rank)."""
        return distributor.distribute(
            it % distributor.num_iters, exchange(c.color_meta()))[0]

    drop = step_generators(0, 0, 8, DROPOUT, device, r)
    for it in range(8):      # node_color: fresh cache meta every step
        b = sampler.sample(distributor.device_slice(domain_at(it, cache), r))
        blocks = [type(d)(adj=d.adj[None], mask=d.mask[None])
                  for d in blocks_to_device(b.blocks, device)]
        x = cache.fetch(b.input_ids[None], np.asarray([b.num_input]),
                        store.fetch, colors=meta.color)
        y = put(ds.labels[b.seeds].astype(np.int64)[None])
        loss, acc = step(blocks, x, y, generator=drop[it])
    loss = float(loss)
    host = cache.stats()
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    if not host["hit_ratio"] > 0.5:
        raise AssertionError(f"host-path hit ratio collapsed: {host}")
    print(f"{tag} host path: ok - 8 steps, loss {loss:.4f}, "
          f"acc {float(acc):.3f}, cache {host}")

    def trainer(c, **kw):
        return ShardedResidentTrainer(
            graph=ds.graph, host_fetch=store.fetch, labels=ds.labels,
            cache=c, model=model, optimizer=opt, fanouts=fanouts,
            batch_size=B, colors=meta.color, **kw)

    cache2 = ShardedFeatureCache(cfg, mesh, mode="sharded")
    rt = trainer(cache2)

    def grid_at(it):
        return distributor.device_slice(domain_at(8 + it, cache2),
                                        r)[None].astype(np.int32)

    def steps(t, n_steps: int, seed: int) -> float:
        samp = step_generators(seed, 0, n_steps, SAMPLE, device, r)
        drop = step_generators(seed, 0, n_steps, DROPOUT, device, r)
        for it in range(n_steps):   # per-step, through begin / resolve
            loss, _ = t.train_step(t.resolve(t.begin(grid_at(it),
                                                     samp[it])), drop[it])
        return float(loss)

    loss2 = steps(rt, 4, 1)
    if not np.isfinite(loss2):
        raise AssertionError(f"non-finite resident loss {loss2}")
    warm = rt.stats()
    if not warm["hit_ratio"] > 0.3:
        raise AssertionError(f"resident warmup hit ratio collapsed: {warm}")

    # one fused staged window: the probe stages every row the lookups
    # will not serve, so it runs exact with no replay; stage-served rows
    # count as misses
    K = 4
    wgrid = np.stack([grid_at(k) for k in range(K)], axis=1)
    wlosses, wedges = rt.train_windows(wgrid[None], seed=40)
    wlosses = wlosses.cpu().numpy()
    if not np.isfinite(wlosses).all():
        raise AssertionError(f"window losses {wlosses}")
    if not float(wedges.sum()) > 0:
        raise AssertionError("the window sampled no edges")
    win = rt.stats()
    if "replay" in rt.timers.totals:
        raise AssertionError("staged window replayed")
    if not win["hit_ratio"] > 0.5:
        raise AssertionError(f"window hit ratio collapsed: {win}")

    gen = step_generators(0, 5, 1, EVAL, device, r)[0]
    correct = rt.eval_step(rt.resolve(rt.begin(grid_at(5), gen)))
    if not 0 <= correct <= n * B:
        raise AssertionError(f"eval correct {correct} of {n * B}")
    print(f"{tag} resident path: ok - 4 steps + fused window K={K} "
          f"(losses {wlosses.round(3).tolist()}), eval correct "
          f"{correct}/{n * B}, cache {win}")
    out = {"host_loss": loss, "host": host, "resident_loss": loss2,
           "warm": warm, "window_losses": wlosses.tolist(), "window": win,
           "eval_correct": correct}
    if n == 1:
        print(f"{tag}: the sharded-topology and node-local legs need more "
              "than one rank")
        return out

    # the sharded topology: each rank holds its own nodes' in-edges
    rt3 = trainer(ShardedFeatureCache(cfg, mesh, mode="sharded"),
                  shard_topology=True)
    shard = int(rt3.g.indices.shape[0])
    if not shard < ds.graph.num_edges:
        raise AssertionError(f"topology not actually sharded: {shard} of "
                             f"{ds.graph.num_edges} edges on rank {r}")
    loss3 = steps(rt3, 2, 60)
    wl3, _ = rt3.train_windows(wgrid[None], seed=80)
    wl3 = wl3.cpu().numpy()
    if not np.isfinite(wl3).all():
        raise AssertionError(f"sharded-topology losses {wl3}")
    print(f"{tag} sharded-topology path: ok - 2 steps + fused window "
          f"K={K}, loss {loss3:.4f}, {shard} of {ds.graph.num_edges} edges "
          "on rank 0's card")
    out.update(topology_loss=loss3, topology_window_losses=wl3.tolist(),
               edges_per_rank=shard)
    if n % 2:
        return out

    # node_local over two hosts of n / 2 ranks: features never cross a
    # host; every node prewarmed, so each host's ranks serve themselves
    L = n // 2
    n_sets = max(8, -(-1500 // (fc.WAYS * L)) * 2)
    cfg_nl = fc.CacheConfig(num_sets=n_sets, ways=fc.WAYS, dim=dim,
                            cache_dim=fc.round_cache_dim(dim),
                            num_colors=meta.num_colors, num_shards=L)
    cache4 = ShardedFeatureCache(cfg_nl, mesh, mode="node_local",
                                 group_size=L)
    rt4 = trainer(cache4, nbr_cap=8)
    cache4.prewarm(np.arange(ds.graph.num_nodes, dtype=np.int32),
                   store.fetch, colors=meta.color)
    cache4.stats()
    loss4 = steps(rt4, 2, 90)
    wl4, _ = rt4.train_windows(wgrid[None], seed=99)
    wl4 = wl4.cpu().numpy()
    if not np.isfinite(wl4).all():
        raise AssertionError(f"node_local losses {wl4}")
    s4 = rt4.stats()
    if s4["hit_ratio"] != 1.0:
        raise AssertionError("node_local groups must self-serve after full "
                             f"prewarm: {s4}")
    print(f"{tag} node_local path: ok - 2 steps + fused window K={K} over "
          f"{n // L} groups of {L}, loss {loss4:.4f}, cache {s4}")
    out.update(node_local_loss=loss4, node_local=s4,
               node_local_window_losses=wl4.tolist())
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="entry() and "
                                "dryrun_multichip(n) of the port")
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=1,
                   help="dryrun_multichip's ranks, one per card (or CPU "
                        "ranks with --device cpu)")
    args = p.parse_args(argv)
    fn, fargs = entry(args.device)
    print("entry: logits", tuple(fn(*fargs).shape))
    dryrun_multichip(args.ranks, args.device)


if __name__ == "__main__":
    main()
