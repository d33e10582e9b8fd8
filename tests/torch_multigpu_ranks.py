"""Rank bodies of the data-parallel tests (tests/test_torch_multigpu_*.py,
tests/test_torch_cuda.py), run in spawned processes by
``coala_gnn_tpu_torch.parallel.multihost.launch``.

This module imports only numpy, torch and the port, never JAX or the JAX
package: a spawned rank imports the module that holds its function, and
the test modules import JAX. The inputs are made here from seeds with
numpy, so the tests can make the same ones for the JAX side."""

import copy

import numpy as np
import torch

from coala_gnn_tpu_torch.cache import feature_cache as fc
from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
from coala_gnn_tpu_torch.models.layers import DeviceBlock
from coala_gnn_tpu_torch.parallel.mesh import make_mesh
from coala_gnn_tpu_torch.parallel.sharded_cache import (ShardedFeatureCache,
                                                        exchange_probe)
from coala_gnn_tpu_torch.parallel.train import (make_sharded_eval_step,
                                                make_sharded_train_step)

N_NODES, DIM, NUM_COLORS, N_REQ = 3000, 16, 6, 64
FETCHES = 5          # fetch steps per case; the one at NO_FILL skips the fill
NO_FILL = 3


def features() -> np.ndarray:
    return np.random.default_rng(0).normal(size=(N_NODES, DIM)).astype(
        np.float32)


def colors() -> np.ndarray:
    return np.random.default_rng(9).integers(
        1, NUM_COLORS + 1, N_NODES).astype(np.int32)


def request(n_dev: int, step: int):
    """(ids int32 [n_dev, N_REQ], valid prefix int32 [n_dev]) of one fetch:
    70% of each rank's valid ids are multiples of 4 (one owner of every
    exchange of 2 or 4), so buckets overflow; repeats within a request."""
    rng = np.random.default_rng(100 + step)
    pool = np.arange(1000)
    ids = np.zeros((n_dev, N_REQ), np.int32)
    nv = np.zeros(n_dev, np.int32)
    for d in range(n_dev):
        n = 48 + (3 * d + step) % 12
        skew = rng.random(n) < 0.7
        ids[d, :n] = np.where(skew, rng.choice(pool[pool % 4 == 0], n),
                              rng.choice(pool, n))
        nv[d] = n
    return ids, nv


def warm_ids():
    """(prewarm ids, row-insert ids, their colors), the same on every
    rank."""
    rng = np.random.default_rng(5)
    rows = rng.choice(N_NODES, 200).astype(np.int32)
    return (rng.choice(N_NODES, 300).astype(np.int32), rows,
            (np.arange(200) % NUM_COLORS).astype(np.int32))


def cache_config(case: dict, n_dev: int) -> dict:
    """CacheConfig keywords of a case: 8 sets of 32 ways per rank, the
    shards the CLI gives each mode."""
    shards = {"sharded": n_dev, "isolated": 1,
              "node_local": case.get("group_size") or n_dev}[case["mode"]]
    return dict(num_sets=8, ways=fc.WAYS, dim=DIM,
                cache_dim=fc.round_cache_dim(DIM),
                num_colors=NUM_COLORS if case["colors"] else 0,
                quantize=case["quantize"], num_shards=shards)


def state_of(cache: ShardedFeatureCache) -> dict:
    """The rank's cache state as numpy (the scratch set cut off)."""
    s, n = cache.state, cache.cfg.num_sets
    out = {"tags": s.base.tags[:n], "data": s.base.data[:n], "rr": s.base.rr,
           "line_colors": s.line_colors[:n],
           "color_counts": s.base.color_counts, "hits": s.base.hits,
           "misses": s.base.misses}
    if s.base.scales is not None:
        out["scales"] = s.base.scales[:n]
    return {k: v.cpu().numpy().copy() for k, v in out.items()}


def cache_cases(mesh, cases: list) -> list:
    """Every case (mode, quantize, colors, group_size, slack) on this
    rank: a prewarm and a row insert, then FETCHES fetches (the one at
    NO_FILL without its fill), each recording the probe's hit and overflow
    bits, the miss count, the features, the state and the bytes handed to
    the collectives; then a probe and the summed stats."""
    feats, cols = features(), colors()
    store = HostFeatureStore(feats)
    r, n_dev = mesh.rank, mesh.world
    out = []
    for case in cases:
        cfg = fc.CacheConfig(**cache_config(case, n_dev))
        cache = ShardedFeatureCache(cfg, mesh, mode=case["mode"],
                                    bucket_slack=case["slack"],
                                    group_size=case.get("group_size", 0))
        color = cols if case["colors"] else None
        warm, rows, rcols = warm_ids()
        cache.prewarm(warm, store.fetch, colors=color, chunk=64)
        cache.insert_rows(rows, feats[rows], rcols if case["colors"] else
                          None, chunk=64)
        rec = {"warm": state_of(cache), "steps": []}
        for step in range(FETCHES):
            ids, nv = request(n_dev, step)
            mesh.ledger.reset()
            h = cache.fetch_begin(ids[r:r + 1], nv[r:r + 1])
            got = cache.fetch_complete(h, store.fetch, colors=color,
                                       fill=step != NO_FILL)
            rec["steps"].append({
                "hit": h.hit.cpu().numpy(), "overflow":
                h.overflow.cpu().numpy(), "miss_count": h.miss_count(),
                "feats": got.cpu().numpy(), "state": state_of(cache),
                "ledger": mesh.ledger.snapshot()})
        ids, nv = request(n_dev, FETCHES)
        hit, over = exchange_probe(
            cfg, cache.state, torch.from_numpy(ids[r]),
            torch.arange(N_REQ) < int(nv[r]), cache.route)
        rec["probe"] = (hit.numpy()[None], over.numpy()[None])
        rec["stats"] = cache.stats()
        rec["color_meta"] = cache.local_color_meta()
        out.append(rec)
    return out


def step_cases(mesh, cases: list) -> list:
    """The data-parallel train and eval steps on this rank's slice of each
    case's batches: ``case`` holds the model (``make``: a picklable
    callable returning it, weights loaded), the optimizer class and rate,
    ``masked``, and per step (blocks [(adj, mask) of [n_dev, ...]], x
    [n_dev, cap_src, dim], labels [n_dev, B], valid [n_dev, B]). Records
    losses, accuracies, the final parameters, the eval step's count and
    per-slot grid, and the bytes of the gradient all-reduce."""
    r = mesh.rank
    out = []
    for case in cases:
        model = case["make"]()
        opt = case["opt"](model.parameters(), lr=case["lr"])
        B = case["batch"]
        step = make_sharded_train_step(model, opt, mesh, B,
                                       masked=case["masked"])
        losses, accs = [], []
        mesh.ledger.reset()

        def mine(blocks, x, labels):
            return ([DeviceBlock(adj=torch.from_numpy(a[r:r + 1]),
                                 mask=torch.from_numpy(m[r:r + 1]))
                     for a, m in blocks], torch.from_numpy(x[r:r + 1]),
                    torch.from_numpy(labels[r:r + 1]))

        for blocks, x, labels, valid in case["steps"]:
            extra = ((torch.from_numpy(valid[r:r + 1]),) if case["masked"]
                     else ())
            loss, acc = step(*mine(blocks, x, labels), *extra)
            losses.append(float(loss))
            accs.append(float(acc))
        ledger = mesh.ledger.snapshot()
        blocks, x, labels, _ = case["steps"][0]
        count = make_sharded_eval_step(model, mesh, B)(*mine(blocks, x,
                                                             labels))
        slots = make_sharded_eval_step(model, mesh, B, per_slot=True)(
            *mine(blocks, x, labels))
        out.append({"losses": losses, "accs": accs, "ledger": ledger,
                    "params": {k: v.numpy().copy()
                               for k, v in model.state_dict().items()},
                    "count": int(count), "slots": slots.numpy(),
                    "param_bytes": 4 * sum(p.numel()
                                           for p in model.parameters())})
    return out


def port_model(kind: str, dim: int, hidden: int, classes: int,
               state_dict: dict):
    """The port's model of ``kind`` (2 layers, 2 heads, dropout 0) with
    ``state_dict`` loaded; picklable with ``functools.partial``."""
    from coala_gnn_tpu_torch.models.gnn import make_model

    model = make_model(kind, dim, hidden, classes, 2, num_heads=2,
                       dropout=0.0)
    model.load_state_dict(state_dict)
    return model


def cli_runs(mesh, runs: list) -> list:
    """``train.train_rank`` (the CLI's rank body) for each of ``runs`` on
    this rank, with dropout 0 and each run's changes: ``args`` (parsed
    flags), ``state_dict`` (weights to start from, the same on every rank;
    default the seeded ones), ``optimizer`` (a callable making it from the
    parameters; default Adam), ``local_size`` (ranks per host; default the
    mesh's), ``ds`` (default ``train.load``'s) and ``prefetch`` (the
    loader's batches ahead; 0 samples in this thread). -> per run,
    ``train_rank``'s record of it."""
    from coala_gnn_tpu_torch import train as cli
    from coala_gnn_tpu_torch.ops import gather_spmm

    out = []
    for spec in runs:
        m = (make_mesh(mesh.device, spec["local_size"])
             if spec.get("local_size") else mesh)
        m.ledger.reset()
        gather_spmm.reset_launches()
        args = copy.copy(spec["args"])
        args.device = str(mesh.device)
        run = cli.build(args, spec.get("ds"), mesh=m)
        run.model.dropout = 0.0
        if spec.get("state_dict") is not None:
            run.model.load_state_dict(spec["state_dict"])
        if spec.get("optimizer") is not None:
            run.optimizer = spec["optimizer"](run.model.parameters())
        if "prefetch" in spec:
            run.loader.prefetch = spec["prefetch"]
        rec = cli.train(run)
        rec["eval"] = cli.evaluate(run) if args.eval else None
        rec.update(rank=m.rank, ledger=m.ledger.snapshot(),
                   launches=dict(gather_spmm.LAUNCHES))
        out.append(rec)
    return out


# ---- the resident pipeline over ranks (tests/test_torch_multigpu_resident.py,
# ---- tests/test_torch_sharded_topology.py) ----------------------------------

def resident_graph(typed: bool):
    """The resident tests' dataset: 600 nodes, avg degree 4, dim 8, 4
    classes, 3 random edge types when ``typed``."""
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph

    ds = synthetic_graph(num_nodes=600, avg_degree=4, feature_dim=8,
                         num_classes=4, seed=5)
    if typed:
        ds.graph.edge_types = np.random.default_rng(5).integers(
            0, 3, ds.graph.num_edges).astype(np.int32)
        ds.graph.num_edge_types = 3
    return ds


def resident_colors() -> np.ndarray:
    return np.random.default_rng(2).integers(0, 5, 600).astype(np.int32)


def _resident_trainer(mesh, case: dict, ds):
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.models.hetero import make_hetero_model
    from coala_gnn_tpu_torch.parallel.sharded_resident import \
        ShardedResidentTrainer

    kind = case["kind"]
    if kind.startswith("r"):
        model = make_hetero_model(kind, 8, 8, 4, 3, 2, num_heads=2,
                                  dropout=0.0)
    else:
        model = make_model(kind, 8, 8, 4, 2, num_heads=2, dropout=0.0)
    model.load_state_dict(case["state_dict"])
    cache = ShardedFeatureCache(fc.CacheConfig(**case["cfg"]), mesh,
                                mode=case["mode"],
                                bucket_slack=case["slack"],
                                group_size=case["group_size"])
    return ShardedResidentTrainer(
        graph=ds.graph, host_fetch=HostFeatureStore(ds.features).fetch,
        labels=ds.labels, cache=cache, model=model,
        optimizer=torch.optim.Adam(model.parameters(), lr=case["lr"]),
        fanouts=case["fanouts"], batch_size=case["batch"],
        colors=resident_colors() if case["colors"] else None,
        shard_topology=case["shard_topology"], nbr_cap=case["nbr_cap"],
        stage_transport=case.get("transport", "auto"),
        stage_overlap=case.get("stage_overlap", False))


def resident_cases(mesh, cases: list) -> list:
    """Each case on this rank's slice of its seed grids: a per-step step,
    per-step steps with one ``begin`` ahead, ``train_windows`` (staged
    under pressure; with ``full``, after a prewarm of every node at full
    coverage), the masked tail step and eval steps. Records the losses,
    window edges, eval counts, cache state (before ``stats``), the summed
    stats, replay, stage rows, the overflow of one probe and the bytes by
    ledger phase."""
    from coala_gnn_tpu_torch.utils.rng import DROPOUT, SAMPLE, \
        step_generators

    r = mesh.rank
    out = []
    for case in cases:
        ds = resident_graph(case["kind"].startswith("r"))
        tt = _resident_trainer(mesh, case, ds)
        mesh.ledger.reset()

        def gens(step):
            return [step_generators(0, step, 1, s, "cpu", r)[0]
                    for s in (SAMPLE, DROPOUT)]

        def mine(grid):
            return grid[r:r + 1]

        steps = case["steps"]
        losses = []
        h = tt.begin(mine(steps[0]), gens(0)[0])
        losses.append(float(tt.train_step(tt.resolve(h), gens(0)[1])[0]))
        pend = None
        for it in range(1, len(steps)):
            nxt = pend or tt.begin(mine(steps[it]), gens(it)[0])
            pend = (tt.begin(mine(steps[it + 1]), gens(it + 1)[0])
                    if it + 1 < len(steps) else None)
            losses.append(float(tt.train_step(tt.resolve(nxt),
                                              gens(it)[1])[0]))
        if case["full"]:
            tt.cache.prewarm(np.arange(600, dtype=np.int32),
                             HostFeatureStore(ds.features).fetch,
                             colors=tt.colors)
            tt.full_coverage = True
        wl, we = tt.train_windows(case["windows"][:, r:r + 1], 0,
                                  first_window=len(steps))
        losses += wl.tolist()
        h = tt.begin(mine(case["tail"]), gens(99)[0])
        losses.append(float(tt.train_step(tt.resolve(h), gens(99)[1],
                                          valid=mine(case["valid"]))[0]))
        evals = [tt.eval_step(tt.resolve(tt.begin(mine(g), gens(0)[0])),
                              valid=mine(case["valid"]))
                 for g in case["evals"]]
        _, ids, valid, safe = tt._sample(torch.from_numpy(
            mine(case["tail"])[0]), gens(7)[0])
        _, ovf = exchange_probe(tt.cache_cfg, tt.cache.state, safe, valid,
                                tt.route)
        state = state_of(tt.cache)
        out.append({"losses": losses, "edges": we.numpy(), "evals": evals,
                    "state": state, "stats": tt.stats(),
                    "replay": "replay" in tt.timers.totals,
                    "stage_rows": tt.timers.tallies.get("stage_rows", 0.0),
                    "overflow": int(ovf.sum()),
                    "shard_edges": int(tt.g.indices.shape[0]),
                    "ledger": mesh.ledger.snapshot()})
    return out


def overlap_insert_ids():
    """(prewarm ids: every node, row-insert ids with repeats) of the
    resident graph, the same on every rank: the prewarm fills every
    rank's cache, so the insert evicts."""
    rng = np.random.default_rng(5)
    return (rng.permutation(600).astype(np.int32),
            rng.choice(600, 300).astype(np.int32))


def overlap_cases(mesh, cases: list) -> list:
    """Each case's windows (``train_windows`` on this rank's slice of its
    seed grids, staged under pressure) with the serial schedule and with
    ``stage_overlap``, each trainer from the case's weights and a cold
    cache: per schedule the losses, window edges, cache state, stats,
    replay, whether ``evict_patch`` was timed, the patch rows that
    ``merge_evicted_patch`` added, the bytes by ledger phase and, per
    step, which frontier slots the window read from the cache (the rest
    it read from the stage: bool [steps, cap0]). Then the
    evict-reporting ``insert_rows`` of ``overlap_insert_ids`` on a fresh
    cache of the case after their prewarm (chunks of 64): its evicted ids
    and the state."""
    from coala_gnn_tpu_torch.parallel import resident

    r = mesh.rank
    merge = resident.merge_evicted_patch
    out = []
    for case in cases:
        ds = resident_graph(False)
        rec = {}
        for overlap in (False, True):
            tt = _resident_trainer(mesh, dict(case, stage_overlap=overlap),
                                   ds)
            patched, reads = [], []
            lookup = tt._eng_lookup

            def recording(ids, valid, count_stats=True):
                feats, hit = lookup(ids, valid, count_stats)
                reads.append((hit & valid).numpy().copy())
                return feats, hit

            tt._eng_lookup = recording

            def counting(*a, **kw):
                got = merge(*a, **kw)
                patched.append(int((~got[2]).sum()))
                return got

            resident.merge_evicted_patch = counting
            mesh.ledger.reset()
            try:
                wl, we = tt.train_windows(case["windows"][:, r:r + 1], 0)
            finally:
                resident.merge_evicted_patch = merge
            rec[overlap] = {
                "losses": wl.numpy(), "edges": we.numpy(),
                "state": state_of(tt.cache), "stats": tt.stats(),
                "replay": "replay" in tt.timers.totals,
                "evict_patch": "evict_patch" in tt.timers.totals,
                "patched": patched, "ledger": mesh.ledger.snapshot(),
                "cache_reads": np.stack(reads)}
        cache = ShardedFeatureCache(fc.CacheConfig(**case["cfg"]), mesh,
                                    mode=case["mode"],
                                    bucket_slack=case["slack"],
                                    group_size=case["group_size"])
        warm, ids = overlap_insert_ids()
        store = HostFeatureStore(ds.features)
        cols = resident_colors() if case["colors"] else None
        cache.prewarm(warm, store.fetch, colors=cols)
        ev = cache.insert_rows(ids, store.fetch(ids),
                               None if cols is None else cols[ids],
                               chunk=64, return_evicted=True)
        rec["evicted"] = ev.numpy()
        rec["evict_state"] = state_of(cache)
        out.append(rec)
    return out


def topology_cases(mesh, cases: list) -> list:
    """The sharded sampler on this rank for each case (typed, fanouts,
    batch, seeds [n, B], uniforms: per layer every rank's f32 [n * cap,
    fanout] grid or None): ``sample_blocks_sharded`` (its blocks, ids and
    count), and given uniforms also each layer through
    ``_sample_layer_sharded`` beside the replicated ``_sample_layer`` on
    the uniforms routed to each dst's owner, then the replicated
    ``sample_blocks_device`` on them; the ledger of the sharded call."""
    from coala_gnn_tpu_torch.sampling import device_sampler as dsm
    from coala_gnn_tpu_torch.sampling import sharded_topology as st
    from coala_gnn_tpu_torch.sampling.neighbor import block_capacities
    from coala_gnn_tpu_torch.utils.rng import SAMPLE, step_generators

    r, n = mesh.rank, mesh.world
    out = []
    for case in cases:
        ds = resident_graph(case["typed"])
        topo = st.put_sharded_topology(ds.graph, mesh)
        seeds = torch.from_numpy(case["seeds"][r])
        fanouts, B, uni = case["fanouts"], case["batch"], case["uniforms"]
        mine = None if uni is None else [torch.from_numpy(u[r]) for u in uni]
        mesh.ledger.reset()
        blocks, ids, num = st.sample_blocks_sharded(
            topo, mesh, seeds, fanouts, B,
            step_generators(0, 0, 1, SAMPLE, "cpu", r)[0], uniforms=mine)
        rec = {"masks": [b.mask.numpy() for b in blocks],
               "rels": [None if getattr(b, "rel", None) is None
                        else b.rel.numpy() for b in blocks],
               "ids": ids.numpy(), "num": int(num),
               "ledger": mesh.ledger.snapshot(),
               "indptr": topo.indptr.numpy(), "indices": topo.indices.numpy()}
        if uni is not None:
            g = dsm.to_device_graph(ds.graph, "cpu")
            caps = block_capacities(B, fanouts)
            dst = torch.cat([seeds.to(torch.int32), torch.full(
                (caps[-1][0] - B,), 600, dtype=torch.int32)])
            routed, layers = [None] * len(fanouts), []
            for layer in range(len(fanouts) - 1, -1, -1):
                cap = caps[layer][0]
                if dst.shape[0] < cap:
                    dst = torch.cat([dst, torch.full(
                        (cap - dst.shape[0],), 600, dtype=torch.int32)])
                owner = (dst.long() % n).numpy()
                grids = uni[layer]              # [n, n * cap, fanout]
                routed[layer] = torch.from_numpy(
                    grids[owner, r * cap + np.arange(cap)])
                got = st._sample_layer_sharded(topo, mesh, dst,
                                               fanouts[layer],
                                               uniforms=mine[layer])
                want = dsm._sample_layer(g, dst, fanouts[layer],
                                         uniforms=routed[layer])
                layers.append((got, want))
                dst = torch.cat([dst, got[0].T.reshape(-1)])
            rep = dsm.sample_blocks_device(g, seeds, fanouts, B,
                                           uniforms=routed)
            rec["layers"] = [tuple(tuple(None if t is None else t.numpy()
                                         for t in side) for side in pair)
                             for pair in layers]
            rec["replicated"] = {
                "masks": [b.mask.numpy() for b in rep[0]],
                "rels": [None if getattr(b, "rel", None) is None
                         else b.rel.numpy() for b in rep[0]],
                "ids": rep[1].numpy(), "num": int(rep[2])}
        out.append(rec)
    return out
