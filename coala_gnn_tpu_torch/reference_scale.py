"""Reference-scale run: a 10M-node, dim-1024 graph trained off disk on one
card, or over ranks with the sharded topology (the port's counterpart of
``examples/reference_scale.py``).

  --generate  write the graph in ``load_preprocessed``'s layout (csc_*.npy,
              features.npy as a memory map written in 1M-row chunks,
              labels.npy, the split files, meta.json): contiguous
              communities of ``--community_size`` nodes, a ``--p_intra``
              share of each node's out-edges inside its community,
              features a class embedding plus unit noise, labels the
              community modulo ``--num_classes``, 1% of the nodes to
              train. numpy on one seed: the files are bitwise those of
              the JAX script for the same flags.
  --run       ``ResidentTrainer`` off the memory-mapped graph under capacity
              pressure: a ``--cache_mb`` set-associative cache (4096 MB of
              f32 lines is ~10% of 10M rows at dim 1024; ``--quantize``
              int8 lines, ~42%), degree priorities and a degree-top
              prewarm, staged windows of ``--window`` steps with
              ``--stage_transport`` (int8) across the host link, GraphSAGE
              at ``--hidden`` 256, fanout 10,5, batch 1024, Adam 1e-3,
              dropout 0.5; ``--warm_windows`` windows, then ``--windows``
              measured ones. Prints and writes (``--out``) the JAX
              script's keys plus ``EXTRA_KEYS``.
  --mesh      the JAX script's mesh leg over ``--ranks`` ranks, one
              process per card (``parallel/multihost.launch``; ``--device
              cpu``: CPU ranks over gloo): ``ShardedResidentTrainer``
              with the sharded topology (each rank holds its own nodes'
              in-edges, ~E/ranks) and the cache sharded over the ranks,
              at the JAX leg's cuts (batch / 4 and ``--cache_mb`` / 4 a
              rank, windows of 4, 2 of them); each rank its slice of the
              seed grid. Writes the JAX record's keys plus
              ``MESH_EXTRA_KEYS`` under ``mesh_<ranks>ranks``.

    python -m coala_gnn_tpu_torch.reference_scale --generate
    python -m coala_gnn_tpu_torch.reference_scale --run --out REFSCALE_h100.json
    python -m coala_gnn_tpu_torch.reference_scale --run --quantize \\
        --out REFSCALE_h100.json
    python -m coala_gnn_tpu_torch.reference_scale --mesh --ranks 4 \\
        --out REFSCALE_h100.json

The default ``--path`` is ``_data/refscale10m`` in the checkout (listed in
.gitignore): ~41 GB of features and ~2.6 GB of topology at the defaults.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_data",
    "refscale10m")

#: keys of ``run_single``'s record beyond the JAX script's: the card's name
#: and power limit, the staged rows per measured window, and the first
#: and last loss of the warm-up windows
EXTRA_KEYS = ("card", "stage_rows_per_window", "warm_loss_first_last")
#: keys of ``run_mesh``'s record beyond the JAX script's: the card, the
#: backend, every rank's owned edges (its shard's real length), the time
#: per step and the edges per second summed over the ranks
MESH_EXTRA_KEYS = ("card", "backend", "edges_per_rank", "ms_per_step",
                   "edges_per_s")


def generate(path: str, num_nodes: int, avg_degree: int, dim: int,
             num_classes: int, community_size: int, p_intra: float,
             seed: int) -> dict:
    """Write the graph into ``path``; returns meta.json's content."""
    from coala_gnn_tpu_torch.graph.csc import coo_to_csc, save_csc

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()

    num_edges = num_nodes * avg_degree
    src = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    # intra-community edges pick a uniform node of src's community
    dst = rng.integers(0, num_nodes, size=num_edges, dtype=np.int64)
    intra = rng.random(num_edges) < p_intra
    base = (src[intra] // community_size) * community_size
    dst[intra] = np.minimum(
        base + rng.integers(0, community_size, size=int(intra.sum())),
        num_nodes - 1)
    graph = coo_to_csc(src, dst, num_nodes)
    del src, dst, intra, base
    save_csc(graph, path)
    del graph
    t_topo = time.perf_counter() - t0

    labels = ((np.arange(num_nodes, dtype=np.int64) // community_size)
              % num_classes).astype(np.int32)
    np.save(os.path.join(path, "labels.npy"), labels)
    n_train = num_nodes // 100
    perm = rng.permutation(num_nodes)
    np.save(os.path.join(path, "train_idx.npy"),
            np.sort(perm[:n_train]).astype(np.int64))
    np.save(os.path.join(path, "val_idx.npy"),
            np.sort(perm[n_train:n_train + n_train // 4]).astype(np.int64))
    np.save(os.path.join(path, "test_idx.npy"),
            np.sort(perm[n_train + n_train // 4:
                         n_train + n_train // 2]).astype(np.int64))

    t0 = time.perf_counter()
    emb = rng.normal(0, 1, size=(num_classes, dim)).astype(np.float32)
    feat = np.lib.format.open_memmap(
        os.path.join(path, "features.npy"), mode="w+",
        dtype=np.float32, shape=(num_nodes, dim))
    chunk = 1 << 20
    for lo in range(0, num_nodes, chunk):
        hi = min(lo + chunk, num_nodes)
        feat[lo:hi] = emb[labels[lo:hi]] + rng.normal(
            0, 1.0, size=(hi - lo, dim)).astype(np.float32)
    feat.flush()
    del feat
    t_feat = time.perf_counter() - t0

    meta = {"num_nodes": num_nodes, "num_edges": int(num_edges), "dim": dim,
            "num_classes": num_classes, "community_size": community_size,
            "p_intra": p_intra, "train_frac": 0.01,
            "feature_bytes": num_nodes * dim * 4,
            "gen_topology_s": round(t_topo, 1),
            "gen_features_s": round(t_feat, 1)}
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    print(f"generated {path}: {meta}", file=sys.stderr)
    return meta


def _rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def card_string(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def make_trainer(ds, cache_mb: int, batch: int, fanouts, hidden: int,
                 transport: str, quantize: bool = False, device="cuda",
                 dropout: float = 0.5, lr: float = 1e-3):
    """The leg's trainer on a loaded dataset: ``(ResidentTrainer, its cache
    config)``, the native host store behind it, degree priorities, SAGE at
    ``hidden``, Adam; not prewarmed (``prewarm_top``)."""
    from coala_gnn_tpu_torch.cache import feature_cache as fc
    from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.parallel.resident import ResidentTrainer

    device = torch.device(device)
    store = HostFeatureStore(ds.features)
    cfg = fc.make_config(cache_mb=cache_mb, dim=ds.feature_dim, num_colors=0,
                         quantize=quantize)
    model = make_model("sage", ds.feature_dim, hidden, ds.num_classes,
                       len(fanouts), dropout=dropout, seed=1).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    rt = ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                         labels=ds.labels, cache_cfg=cfg, model=model,
                         optimizer=opt, fanouts=list(fanouts),
                         batch_size=batch, device=device,
                         priorities="degree", stage_transport=transport)
    return rt, cfg


def prewarm_top(rt, ds) -> None:
    """Admit the ``capacity`` highest in-degree nodes' rows."""
    cap = rt.cache_cfg.capacity
    deg = np.diff(np.asarray(ds.graph.indptr))
    top = np.argpartition(deg, -cap)[-cap:]
    rt.prewarm(top.astype(np.int32))


def run_single(path: str, cache_mb: int, batch: int, fanout: str,
               hidden: int, window: int, windows: int, warm_windows: int,
               transport: str, quantize: bool = False,
               device="cuda", on_trainer=None) -> dict:
    """Capacity-pressure training off the memory-mapped graph (module
    docstring); returns the record. ``on_trainer(rt, ds)``, where given,
    runs after the measured windows."""
    from coala_gnn_tpu_torch.graph.datasets import load_preprocessed
    from coala_gnn_tpu_torch.utils.rng import SAMPLE, step_generators

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA card here; pass --device "
                           "cpu to run on the CPU")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    ds = load_preprocessed(path, num_classes=meta["num_classes"])
    fanouts = [int(f) for f in fanout.split(",")]
    rt, cfg = make_trainer(ds, cache_mb, batch, fanouts, hidden, transport,
                           quantize, device)
    coverage = cfg.capacity / ds.graph.num_nodes
    card = card_string(device)
    print(f"card: {card}; cache {cache_mb} MB = {cfg.capacity} lines "
          f"({100 * coverage:.1f}% of {ds.graph.num_nodes} nodes); "
          f"features on disk: {meta['feature_bytes'] / 2**30:.1f} GiB",
          file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    prewarm_top(rt, ds)
    t_prewarm = time.perf_counter() - t0
    print(f"prewarm {cfg.capacity} hub lines in {t_prewarm:.1f}s",
          file=sys.stderr, flush=True)

    rng = np.random.default_rng(0)
    K = window

    def grids(n_win):
        need = n_win * K * batch
        reps = -(-need // ds.train_idx.size)
        perm = np.concatenate(
            [rng.permutation(ds.train_idx) for _ in range(reps)])
        return np.ascontiguousarray(
            perm[:need].astype(np.int32).reshape(n_win, K, batch))

    # one per-step batch first, as the JAX script initialises its params
    # on one (same seeds drawn, its misses admitted)
    rt.resolve(rt.begin(
        rng.choice(ds.train_idx, batch, replace=False).astype(np.int32),
        step_generators(9, 0, 1, SAMPLE, device)[0]))

    t0 = time.perf_counter()
    warm, _ = rt.train_windows(grids(warm_windows), seed=0)
    warm = warm.cpu().numpy()
    t_compile = time.perf_counter() - t0
    print(f"warm-up ({warm_windows} windows): {t_compile:.1f}s",
          file=sys.stderr, flush=True)
    rt.stats()
    rt.timers.reset()
    rt.timers.tallies.clear()

    g = grids(windows)
    t0 = time.perf_counter()
    losses, edges = rt.train_windows(g, seed=0, first_window=warm_windows)
    losses = losses.cpu().numpy()
    dt = time.perf_counter() - t0
    edges = float(edges.sum())
    s = rt.stats()
    steps = windows * K
    steps_per_epoch = ds.train_idx.size // batch
    epoch_s = dt / steps * steps_per_epoch
    timer_rows = {k: {"total_s": round(v, 2),
                      "calls": int(rt.timers.counts.get(k, 0))}
                  for k, v in rt.timers.totals.items()}
    out = {
        "graph": {k: meta[k] for k in ("num_nodes", "num_edges", "dim",
                                       "num_classes")},
        "cache_mb": cache_mb, "coverage": round(coverage, 4),
        "batch": batch, "fanout": fanouts, "window": K,
        "stage_transport": rt.stage_transport,
        "prewarm_s": round(t_prewarm, 1),
        "compile_warm_s": round(t_compile, 1),
        "measured_steps": steps,
        "measured_s": round(dt, 2),
        "edges_per_s": round(edges / dt, 1),
        "ms_per_step": round(1000 * dt / steps, 1),
        "hit_ratio": round(s["hit_ratio"], 4),
        "loss_first_last": [round(float(losses[0]), 3),
                            round(float(losses[-1]), 3)],
        "steps_per_epoch": steps_per_epoch,
        "epoch_time_projected_s": round(epoch_s, 1),
        "phase_timers": timer_rows,
        "probe_bitmap_mb": round((meta["num_nodes"] + 1) / 2**20, 1),
        "peak_rss_gb": round(_rss_gb(), 2),
        "card": card,
        "stage_rows_per_window":
            round(rt.timers.tallies.get("stage_rows", 0.0) / windows, 1),
        "warm_loss_first_last": [round(float(warm[0]), 3),
                                 round(float(warm[-1]), 3)],
    }
    print(json.dumps(out, indent=1), file=sys.stderr, flush=True)
    if on_trainer is not None:
        on_trainer(rt, ds)
    return out


def _mesh_rank(mesh, path: str, batch: int, fanout: str, hidden: int,
               cache_mb: int, window: int, windows: int) -> dict:
    """``run_mesh``'s rank body: the record, from this rank's view."""
    from coala_gnn_tpu_torch.cache import feature_cache as fc
    from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu_torch.graph.datasets import load_preprocessed
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.parallel.sharded_cache import \
        ShardedFeatureCache
    from coala_gnn_tpu_torch.parallel.sharded_resident import \
        ShardedResidentTrainer

    device, n = mesh.device, mesh.world
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    ds = load_preprocessed(path, num_classes=meta["num_classes"])
    fanouts = [int(f) for f in fanout.split(",")]
    cfg = fc.make_config(cache_mb=cache_mb, dim=meta["dim"], num_colors=0,
                         num_shards=n)
    cache = ShardedFeatureCache(cfg, mesh, mode="sharded")
    store = HostFeatureStore(ds.features)
    model = make_model("sage", meta["dim"], hidden, ds.num_classes,
                       len(fanouts), seed=1).to(device)
    rt = ShardedResidentTrainer(
        graph=ds.graph, host_fetch=store.fetch, labels=ds.labels,
        cache=cache, model=model,
        optimizer=torch.optim.Adam(model.parameters(), lr=1e-3),
        fanouts=fanouts, batch_size=batch, shard_topology=True)
    rng = np.random.default_rng(0)
    seeds = rng.choice(ds.train_idx,
                       (windows, n, window, batch)).astype(np.int32)
    t0 = time.perf_counter()
    losses, edges = rt.train_windows(seeds[:, mesh.rank:mesh.rank + 1], 2)
    losses = losses.cpu().numpy()
    dt = time.perf_counter() - t0
    steps = windows * window
    return {
        "devices": n, "platform": "gpu" if device.type == "cuda" else "cpu",
        "shard_topology": True,
        "edges_per_device": int(meta["num_edges"] / n),
        "steps": steps,
        "wall_s_incl_compile": round(dt, 1),
        "loss_first_last": [round(float(losses[0]), 3),
                            round(float(losses[-1]), 3)],
        "hit_stats": {k: round(v, 4) if isinstance(v, float) else v
                      for k, v in rt.stats().items()},
        "peak_rss_gb": round(_rss_gb(), 2),
        "card": card_string(device),
        "backend": torch.distributed.get_backend(),
        "edges_per_rank": int(rt.g.indptr[-1]),
        "ms_per_step": round(1000 * dt / steps, 1),
        "edges_per_s": round(float(edges.sum()) / dt, 1),
    }


def run_mesh(path: str, ranks: int, batch: int, fanout: str, hidden: int,
             cache_mb: int, window: int, windows: int, device="cuda",
             devices=None, backend=None, timeout=None) -> dict:
    """The mesh leg (module docstring) over ``ranks`` ranks on ``devices``
    (default: ``cuda:0`` .. ``cuda:ranks-1``, or the CPU) over
    ``backend`` (default: nccl on cards, gloo on the CPU): rank 0's record
    with every rank's ``edges_per_rank``."""
    from coala_gnn_tpu_torch.parallel import multihost

    device = torch.device(device)
    if devices is None:
        if device.type == "cuda" and torch.cuda.device_count() < ranks:
            raise ValueError(f"--mesh --ranks {ranks} runs one rank per "
                             f"card and this machine has "
                             f"{torch.cuda.device_count()}; pass --device "
                             "cpu for CPU ranks")
        devices = ([f"cuda:{r}" for r in range(ranks)]
                   if device.type == "cuda" else ["cpu"] * ranks)
    backend = backend or multihost.backend_for(torch.device(devices[0]))
    recs = multihost.launch(
        _mesh_rank, ranks, list(devices), backend, timeout=timeout,
        args=(path, batch, fanout, hidden, cache_mb, window, windows))
    out = dict(recs[0], edges_per_rank=[r["edges_per_rank"] for r in recs])
    print(json.dumps(out, indent=1), file=sys.stderr, flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="reference-scale leg of the "
                                "port (module docstring)")
    p.add_argument("--path", default=DEFAULT_DIR)
    p.add_argument("--generate", action="store_true")
    p.add_argument("--run", action="store_true")
    p.add_argument("--mesh", action="store_true")
    p.add_argument("--num_nodes", type=int, default=10_000_000)
    p.add_argument("--avg_degree", type=int, default=15)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--num_classes", type=int, default=19)
    p.add_argument("--community_size", type=int, default=2048)
    p.add_argument("--p_intra", type=float, default=0.9)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache_mb", type=int, default=4096)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--fanout", default="10,5")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--window", type=int, default=32)
    p.add_argument("--windows", type=int, default=4)
    p.add_argument("--warm_windows", type=int, default=2)
    p.add_argument("--stage_transport", default="int8")
    p.add_argument("--quantize", action="store_true",
                   help="int8 cache lines + a per-line scale: ~4x the lines "
                        "per MB at dim 1024")
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=2,
                   help="--mesh: ranks, one per card")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    art = {}
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            art = json.load(f)
    if args.generate:
        art["generate"] = generate(args.path, args.num_nodes,
                                   args.avg_degree, args.dim,
                                   args.num_classes, args.community_size,
                                   args.p_intra, args.seed)
    if args.run:
        key = "single_chip_int8_lines" if args.quantize else "single_chip"
        art[key] = run_single(
            args.path, args.cache_mb, args.batch, args.fanout, args.hidden,
            args.window, args.windows, args.warm_windows,
            args.stage_transport, quantize=args.quantize,
            device=args.device)
    if args.mesh:
        art[f"mesh_{args.ranks}ranks"] = run_mesh(
            args.path, args.ranks, args.batch // 4, args.fanout, args.hidden,
            args.cache_mb // 4, window=4, windows=2, device=args.device)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(art, indent=1))
    else:
        print(json.dumps(art, indent=1))
    return art


if __name__ == "__main__":
    main()
