"""The port's entry points (counterparts of ``__graft_entry__.py``).

``entry(device="cuda")`` -> ``(fn, args)``: the flagship model's forward,
GraphSAGE-mean over blocks of the host sampler, ``fn(params, blocks, x)
-> logits``, with ``params`` a ``{name: tensor}`` dict (the model's own,
or a JAX tree carried across by ``utils.convert.params_from_flax``), on
the card unless the caller asks for the CPU.

``dryrun_multichip(n, device="cuda")`` trains on tiny shapes through both
pipelines of the JAX package's dry run, with its checks:

1. the host path: ``node_color`` seed distribution with the cache's color
   meta refreshed every step, host sampling, the cache front's fetch and
   the data-parallel step, 8 steps; finite loss, warm hit ratio > 0.5;
2. the resident path (``ShardedResidentTrainer``): 4 per-step ``begin`` /
   ``resolve`` / ``train_step`` warm-up steps (hit ratio > 0.3), one fused
   staged window of K = 4 (finite losses, edges, no replay, hit ratio >
   0.5) and one eval batch.

Only ``n = 1`` is ported. The JAX run's legs that need more than one
device (the sharded topology, the node-local groups) and any ``n > 1``
raise ``NotImplementedError`` naming ROADMAP.md's "multi-GPU" item. At
``n = 1`` the cache holds 64 sets of 32 ways and a step trains 64 seeds:
the 2,048 lines and the global batch that the JAX dry run spreads over its
8 devices. JAX's own run at one device (8 sets, 8 seeds a step) fails its
hit-ratio floors (ROADMAP.md section C).

    python -m coala_gnn_tpu_torch.entry [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

_MULTI = "ROADMAP.md queue A, \"multi-GPU\""

#: the dry run's cache and batch: the total lines and the global batch of
#: JAX's 8-device run, on one device
DRYRUN_SETS, DRYRUN_BATCH = 64, 64


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA card here; pass "
                           "device='cpu' to run on the CPU")
    return device


def _blocks(host_blocks, device) -> list:
    from coala_gnn_tpu_torch.models.layers import DeviceBlock

    return [DeviceBlock(adj=None if b.adj is None
                        else torch.from_numpy(b.adj).to(device),
                        mask=torch.from_numpy(b.mask).to(device))
            for b in host_blocks]


def _build_problem(device, num_nodes: int = 2000, dim: int = 128,
                  num_classes: int = 8, batch: int = 32,
                  fanouts=(5, 5), seed: int = 0) -> tuple:
    """JAX's ``_build_problem``: (dataset, model, host batch, blocks, x)
    for the train set's first ``batch`` seeds, model and tensors on
    ``device``."""
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler

    ds = synthetic_graph(num_nodes=num_nodes, avg_degree=10,
                         feature_dim=dim, num_classes=num_classes, seed=seed)
    sampler = NeighborSampler(ds.graph, list(fanouts), batch, seed=seed)
    batch_s = sampler.sample(ds.train_idx[:batch])
    model = make_model("sage", dim, 128, num_classes, len(fanouts),
                       seed=seed).to(device)
    x = torch.from_numpy(ds.features[batch_s.input_ids]).to(device)
    return ds, model, batch_s, _blocks(batch_s.blocks, device), x


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


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Both pipelines for real on tiny shapes (module docstring); returns
    what each leg measured."""
    if n_devices != 1:
        raise NotImplementedError(
            f"dryrun_multichip({n_devices}): more than one device is not "
            f"ported yet: {_MULTI}")
    device = _device(device)
    from coala_gnn_tpu_torch.cache import feature_cache as fc
    from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu_torch.coloring import generate_color_metadata
    from coala_gnn_tpu_torch.distribution import SeedDistributor
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.parallel.sharded_cache import \
        ShardedFeatureCache
    from coala_gnn_tpu_torch.parallel.sharded_resident import \
        ShardedResidentTrainer
    from coala_gnn_tpu_torch.parallel.train import make_sharded_train_step
    from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler
    from coala_gnn_tpu_torch.utils.rng import (DROPOUT, EVAL, SAMPLE,
                                               step_generators)

    B, fanouts, dim = DRYRUN_BATCH, [3, 3], 32
    ds = synthetic_graph(num_nodes=1500, avg_degree=8, feature_dim=dim,
                         num_classes=4, seed=2)
    meta = generate_color_metadata(ds.graph, ds.train_idx, base_rate=0.02,
                                   seed=0)
    store = HostFeatureStore(ds.features)
    cfg = fc.CacheConfig(num_sets=DRYRUN_SETS, ways=fc.WAYS, dim=dim,
                         cache_dim=fc.round_cache_dim(dim),
                         num_colors=meta.num_colors)
    cache = ShardedFeatureCache(cfg, [device], mode="sharded")
    distributor = SeedDistributor(ds.train_idx, batch_size=B, local_size=1,
                                  num_parts=1, mode="node_color",
                                  color=meta.color, topk_colors=meta.topk,
                                  affinity=meta.score, shuffle_seed=0)
    sampler = NeighborSampler(ds.graph, fanouts, B, seed=0)
    model = make_model("sage", dim, 16, 4, 2).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = make_sharded_train_step(model, opt, [device], B)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    drop = step_generators(0, 0, 8, DROPOUT, device)
    for it in range(8):      # node_color: fresh cache meta every step
        domain = distributor.distribute(it, cache.color_meta()[None, :])[0]
        b = sampler.sample(distributor.device_slice(domain, 0))
        blocks = [type(d)(adj=d.adj[None], mask=d.mask[None])
                  for d in _blocks(b.blocks, device)]
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
    print(f"dryrun_multichip(1) host path: ok - 8 steps, loss {loss:.4f}, "
          f"acc {float(acc):.3f}, cache {host}")

    cache2 = ShardedFeatureCache(cfg, [device], mode="sharded")
    rt = ShardedResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                                labels=ds.labels, cache=cache2, model=model,
                                optimizer=opt, fanouts=fanouts, batch_size=B,
                                colors=meta.color)

    def grid_at(it):
        domain = distributor.distribute((8 + it) % distributor.num_iters,
                                        cache2.color_meta()[None, :])[0]
        return distributor.device_slice(domain, 0)[None].astype(np.int32)

    samp = step_generators(1, 0, 6, SAMPLE, device)
    drop = step_generators(1, 0, 4, DROPOUT, device)
    for it in range(4):      # per-step warm-up through begin / resolve
        loss2, _ = rt.train_step(rt.resolve(rt.begin(grid_at(it),
                                                     samp[it])), drop[it])
    loss2 = float(loss2)
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

    gen = step_generators(0, 5, 1, EVAL, device)[0]
    correct = rt.eval_step(rt.resolve(rt.begin(grid_at(5), gen)))
    if not 0 <= correct <= B:
        raise AssertionError(f"eval correct {correct} of {B}")
    print(f"dryrun_multichip(1) resident path: ok - 4 steps + fused window "
          f"K={K} (losses {wlosses.round(3).tolist()}), eval correct "
          f"{correct}/{B}, cache {win}")
    print("dryrun_multichip(1): the sharded-topology and node-local legs "
          f"need more than one device: {_MULTI}")
    return {"host_loss": loss, "host": host, "resident_loss": loss2,
            "warm": warm, "window_losses": wlosses.tolist(), "window": win,
            "eval_correct": correct}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="entry() and "
                                "dryrun_multichip(1) of the port")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    fn, fargs = entry(args.device)
    print("entry: logits", tuple(fn(*fargs).shape))
    dryrun_multichip(1, args.device)


if __name__ == "__main__":
    main()
