"""Smoke run of the PyTorch / CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths once each, as a user would: ``ResidentTrainer``
training GraphSAGE-mean at ``bench.py``'s resident config (200k-node
synthetic graph, feature dim 256, hidden 256, 2 layers, fanout [10, 5],
batch 1024, dropout 0.5, Adam 1e-3): the flagship row (flat f32 table at
full coverage, K = 8), its bf16-table row, and the pressure row (a
set-associative f32 cache of ~50% of the rows, degree priorities, staged
windows of K = 32 through the native host tier). Phases:

  1. device: a CUDA card must be present; prints its name and power limit;
  2. kernel vs plain: builds the gather-SpMM kernel from the checkout and
     holds it against its plain PyTorch version on the card, f32 and bf16
     tables at the training step's layer-0 shape and a ragged shape; times
     both at the step's shape;
  3. the flagship: 1 warm-up + 2 measured windows (f32 table), then 1 window
     with a bf16 table; checks finite, falling losses, one kernel launch
     per step, full table coverage, and that table, params and optimizer
     state live on the card; prints ms/step and train edges/s;
  4. the kernel on one step's real layer-0 inputs against the plain version;
  5. a small run on the card against the same run of the port on the CPU;
  6. the pressure row: 1 warm-up + 2 measured staged windows (f32
     transport, native fused host gather+encode required); checks finite,
     falling losses, hits and misses, no replay, one kernel launch per
     step, state on the card; prints ms/step, train edges/s, hit ratio,
     stage rows per window and the phase timers; holds the kernel against
     the plain version on one staged step's real layer-0 inputs (cache
     lookup with stage rows overlaid); then one window each with bf16 and
     int8 stage transport;
  7. exactness on the card: a staged run with a small cache and a flat
     full-coverage run on the same seeds and streams give the same losses.

Every failure ends the script with a non-zero code. The line before the
last two is a JSON object with the kernels' launches, errors and times;
the last line is ``{"ok": true, "device": {...}}``. Writes nothing but the
kernel build under coala_gnn_tpu_torch/_build/ and the native host
library under coala_gnn_tpu/native/.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_NODES, DIM, HIDDEN, CLASSES = 200_000, 256, 256, 16
FANOUTS, BATCH, K = [10, 5], 1024, 8
K_PRESSURE = 32     # bench.py BENCH_WINDOW_PRESSURE default
EXACT_RTOL = 1e-5   # staged vs flat losses: the kernel sums the same rows
                    # in the same order on both paths, so they should agree
                    # to the last bit; 1e-5 allows only rounding noise
KERNEL_TOL = 1e-5   # rtol = atol: kernel and plain version both sum the
                    # (exactly widened) rows in f32 in the same slot order;
                    # they differ only by fused vs separate multiply-add
SMALL_RTOL, SMALL_ATOL = 2e-3, 2e-4   # losses, card vs CPU (Adam amplifies
                                      # rounding; the JAX parity tolerance)
SMALL_P_RTOL, SMALL_P_ATOL = 5e-3, 5e-4


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def smi_string() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def median_ms(torch, fn, runs: int = 25) -> float:
    """Median of ``runs`` single calls timed with CUDA events; a 256 MB
    write before each call evicts the 50 MB L2, as a new step's frontier
    would find it cold."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_inputs(torch, S, N, F, D, dtype, gen):
    """Table, sampled-style adj and weights: ~20% of slots masked (w = 0)
    and pointed at row 0, as the sampler's padding is."""
    x = torch.randn(S, D, generator=gen, device="cuda").to(dtype)
    adj = torch.randint(0, S, (N, F), generator=gen, device="cuda",
                        dtype=torch.int32)
    live = torch.rand(N, F, generator=gen, device="cuda") < 0.8
    w = torch.where(live, torch.rand(N, F, generator=gen, device="cuda"),
                    torch.zeros(N, F, device="cuda"))
    adj = torch.where(live, adj, torch.zeros_like(adj))
    return x, adj, w


def max_err(torch, out, ref, what: str) -> float:
    require(out.shape == ref.shape and out.dtype == torch.float32,
            f"{what}: shape/dtype {tuple(out.shape)} {out.dtype}")
    require(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    require(torch.allclose(out, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL),
            f"{what}: kernel disagrees with the plain version")
    return float((out - ref).abs().max())


def phase_kernels(torch, gather_spmm, gather_spmm_reference) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (N_NODES + 1, 6 * BATCH, FANOUTS[0], DIM)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, adj, w = kernel_inputs(torch, *shape, dtype, gen)
        out = gather_spmm(x, adj, w)
        ref = gather_spmm_reference(x, adj, w)
        torch.cuda.synchronize()
        err = max_err(torch, out, ref, f"slice shape {shape} {dtype}")
        ms = median_ms(torch, lambda: gather_spmm(x, adj, w))
        plain_ms = median_ms(torch, lambda: gather_spmm_reference(x, adj, w))
        res[dtype] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"phase 2: gather_spmm {dtype} S,N,F,D={shape}: max_abs_err "
              f"{err:.3g} (tol {KERNEL_TOL}), kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (median of 25, L2 flushed)")
        x, adj, w = kernel_inputs(torch, 50, 17, 10, 128, dtype, gen)
        out = gather_spmm(x, adj, w)
        ref = gather_spmm_reference(x, adj, w)
        torch.cuda.synchronize()
        err = max_err(torch, out, ref, f"ragged (50,17,10,128) {dtype}")
        res[dtype]["max_abs_err"] = max(res[dtype]["max_abs_err"], err)
        print(f"phase 2: gather_spmm {dtype} ragged (50,17,10,128): "
              f"max_abs_err {err:.3g}")
    return res


def make_trainer(torch, ds, store, dtype, device, dropout=0.5, lr=1e-3,
                 fanouts=FANOUTS, batch=BATCH, hidden=HIDDEN, cache_mb=1024,
                 **trainer_kw):
    """bench.py run_resident's trainer: every row prewarmed when the cache
    covers the graph, else (capacity pressure) the highest-degree nodes."""
    from coala_gnn_tpu_torch.cache import feature_cache as fc
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.parallel.resident import ResidentTrainer

    cfg = fc.make_config(cache_mb=cache_mb, dim=ds.feature_dim, dtype=dtype)
    model = make_model("sage", ds.feature_dim, hidden, ds.num_classes,
                       len(fanouts), dropout=dropout, seed=1).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    rt = ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                         labels=ds.labels, cache_cfg=cfg, model=model,
                         optimizer=opt, fanouts=fanouts, batch_size=batch,
                         device=device, **trainer_kw)
    n = ds.graph.num_nodes
    if cfg.capacity >= n:
        rt.prewarm(np.arange(n, dtype=np.int32))
    else:
        deg = np.diff(np.asarray(ds.graph.indptr))
        top = np.argpartition(deg, -cfg.capacity)[-cfg.capacity:]
        rt.prewarm(top.astype(np.int32))
    return rt


def pressure_mb(ds) -> int:
    """bench.py's pressure cache: ~50% of the feature rows as f32 lines."""
    from coala_gnn_tpu_torch.cache.feature_cache import round_cache_dim

    line_b = round_cache_dim(ds.feature_dim) * 4
    return max(int(ds.graph.num_nodes * 0.5 * line_b) >> 20, 1)


def make_grids(ds, n_win, k, batch, rng):
    """Epoch-permutation seeds sliced into [n_win, k, batch] (bench.py)."""
    need = n_win * k * batch
    reps = -(-need // ds.train_idx.size)
    perm = np.concatenate([rng.permutation(ds.train_idx)
                           for _ in range(reps)])
    return perm[:need].astype(np.int32).reshape(n_win, k, batch)


def on_card(torch, rt) -> bool:
    """Cache, params and optimizer state all on the card."""
    c = rt.cache if rt.direct else rt.cache.base
    return (c.data.is_cuda and all(
        p.is_cuda for p in rt.model.parameters()) and all(
        t.is_cuda for st in rt.optimizer.state.values() for t in st.values()
        if torch.is_tensor(t) and t.dim() > 0))


def phase_slice(torch, ds, store, gather_spmm, smi) -> dict:
    rng = np.random.default_rng(0)
    rt = make_trainer(torch, ds, store, torch.float32, "cuda")
    require(bool(rt.cache.admitted[:N_NODES].all()), "prewarm left rows out")
    warm, meas = make_grids(ds, 1, K, BATCH, rng), make_grids(ds, 2, K,
                                                              BATCH, rng)
    torch.cuda.synchronize()
    gather_spmm.launches = 0
    l_warm, _ = rt.train_windows(warm, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l_meas, edges = rt.train_windows(meas, seed=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = gather_spmm.launches
    stats = rt.stats()
    losses = torch.cat([l_warm, l_meas]).cpu().numpy()
    steps = losses.size
    print(f"phase 3: f32 table, {steps} steps, kernel launches {launches}; "
          f"losses {np.array2string(losses, precision=4)}")
    require(np.isfinite(losses).all(), "non-finite loss")
    require(losses[-K:].mean() < losses[:K].mean(),
            "last window's mean loss is not below the first's")
    require(launches == steps, f"{launches} kernel launches for {steps} "
                               "steps")
    require(stats["misses"] == 0 and stats["hits"] > 0,
            f"counters at full coverage: {stats}")
    require(on_card(torch, rt), "state off the card")
    n_meas = l_meas.numel()
    eps = float(edges.sum()) / dt
    print(f"phase 3: {1000 * dt / n_meas:.3f} ms/step, "
          f"train_edges_per_s_per_chip {eps:.1f}, hits {stats['hits']} "
          f"misses {stats['misses']} ({n_meas} measured steps, host clock, "
          f"{smi})")

    rt16 = make_trainer(torch, ds, store, torch.bfloat16, "cuda")
    grid16 = make_grids(ds, 1, K, BATCH, rng)
    torch.cuda.synchronize()
    gather_spmm.launches = 0
    l16, _ = rt16.train_windows(grid16, seed=2)
    torch.cuda.synchronize()
    launches16 = gather_spmm.launches
    l16 = l16.cpu().numpy()
    print(f"phase 3: bf16 table, {K} steps, kernel launches {launches16}; "
          f"losses {np.array2string(l16, precision=4)}")
    require(np.isfinite(l16).all(), "non-finite loss (bf16 table)")
    require(launches16 == K, f"{launches16} launches for {K} bf16 steps")
    return {"rt": rt, "launches": {torch.float32: launches,
                                   torch.bfloat16: launches16}}


def phase_step_inputs(torch, rt, gather_spmm, gather_spmm_reference,
                      ds) -> float:
    from coala_gnn_tpu_torch.ops.aggregate import frontier_adj
    from coala_gnn_tpu_torch.sampling.device_sampler import \
        sample_blocks_device

    seeds = torch.as_tensor(ds.train_idx[:BATCH].astype(np.int32),
                            device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    blocks, ids, _ = sample_blocks_device(rt.g, seeds, FANOUTS, BATCH, gen)
    safe = torch.where(ids != rt.g.num_nodes, ids, torch.zeros_like(ids))
    mask = blocks[0].mask
    adj = frontier_adj(safe, tuple(mask.shape))
    out = gather_spmm(rt.cache.data, adj, mask)
    ref = gather_spmm_reference(rt.cache.data, adj, mask)
    torch.cuda.synchronize()
    err = max_err(torch, out, ref, "one step's layer-0 inputs")
    print(f"phase 4: kernel on a step's layer-0 inputs (table "
          f"{tuple(rt.cache.data.shape)}, adj {tuple(adj.shape)}): "
          f"max_abs_err {err:.3g}")
    return err


def phase_small(torch) -> None:
    """The port's small training run on the card vs on the CPU (the CPU
    port is held against the JAX package by tests/test_torch_resident.py)."""
    from coala_gnn_tpu.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu.graph.datasets import synthetic_graph

    ds = synthetic_graph(num_nodes=250, avg_degree=4, feature_dim=8,
                         num_classes=4, seed=5)
    fan = int(ds.graph.in_degrees().max())
    store = HostFeatureStore(ds.features, use_native=False)
    grids = make_grids(ds, 3, 4, 16, np.random.default_rng(3))
    out = {}
    for device in ("cuda", "cpu"):
        rt = make_trainer(torch, ds, store, torch.float32, device,
                          dropout=0.0, lr=1e-2, fanouts=[fan, fan], batch=16,
                          hidden=8)
        losses, _ = rt.train_windows(grids, seed=7)
        out[device] = (losses.cpu().numpy(),
                       [p.detach().cpu().numpy()
                        for p in rt.model.parameters()])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0],
                               rtol=SMALL_RTOL, atol=SMALL_ATOL)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(a, b, rtol=SMALL_P_RTOL,
                                   atol=SMALL_P_ATOL)
    print(f"phase 5: small run (250 nodes, 12 steps) card vs CPU: losses "
          f"max diff {np.abs(out['cuda'][0] - out['cpu'][0]).max():.3g}, "
          f"within rtol {SMALL_RTOL} atol {SMALL_ATOL}")


def phase_staged_step(torch, rt, ds, gather_spmm, gather_spmm_reference,
                      rng) -> float:
    """The kernel on one staged step's real layer-0 inputs against the
    plain version: a window's probe and stage, step 0's cache lookup with
    the stage rows overlaid (the table), the slot positions (adj) and the
    step's mask, as ``ResidentTrainer._window`` hands them to the kernel."""
    from coala_gnn_tpu_torch.ops.aggregate import frontier_adj
    from coala_gnn_tpu_torch.utils.rng import SAMPLE, step_generators

    seed = 14
    grid = torch.as_tensor(make_grids(ds, 1, K_PRESSURE, BATCH, rng)[0],
                           device=rt.device)
    stage = rt._build_stage(rt._probe_window(grid, seed, 0))
    gen = step_generators(seed, 0, 1, SAMPLE, rt.device)[0]
    blocks, _, valid, safe = rt._sample(grid[0], gen)
    feats, n_hit, n_unres = rt._frontier(safe, valid, stage,
                                         rt._pos_map(stage[0]))
    n_valid, n_hit, n_unres = (int(v) for v in torch.stack(
        [valid.sum(dtype=torch.int32), n_hit, n_unres]).tolist())
    require(n_unres == 0, f"staged step: {n_unres} rows served by neither "
                          "cache nor stage")
    n_stage = n_valid - n_hit
    require(n_stage > 0, "staged step: no stage row in the frontier")
    mask = blocks[0].mask.contiguous()
    adj = frontier_adj(rt._slots, tuple(mask.shape))
    out = gather_spmm(feats, adj, mask)
    ref = gather_spmm_reference(feats, adj, mask)
    torch.cuda.synchronize()
    err = max_err(torch, out, ref, "one staged step's layer-0 inputs")
    print(f"phase 6: kernel on a staged step's layer-0 inputs (frontier "
          f"{tuple(feats.shape)} {feats.dtype}, {n_hit} cache rows + "
          f"{n_stage} stage rows, adj {tuple(adj.shape)}): max_abs_err "
          f"{err:.3g}")
    return err


def phase_pressure(torch, ds, store, gather_spmm, gather_spmm_reference,
                   smi) -> tuple:
    """bench.py's resident-pressure row; returns (kernel launches of its
    trainer runs, the kernel's error on a staged step's inputs)."""
    rng = np.random.default_rng(4)
    mb = pressure_mb(ds)
    kw = dict(cache_mb=mb, priorities="degree")
    rt = make_trainer(torch, ds, store, torch.float32, "cuda",
                      stage_transport="float32", **kw)
    cap = rt.cache_cfg.capacity
    require(not rt.direct and cap < N_NODES, "pressure cache not under "
                                             "pressure")
    require(rt._store is not None, "the native host store did not build: "
                                   "no fused host gather+encode")
    print(f"phase 6: pressure cache {mb} MB = {cap} lines "
          f"({rt.cache_cfg.num_sets} sets x 32) for {N_NODES} nodes; "
          "native fused host gather+encode")
    warm = make_grids(ds, 1, K_PRESSURE, BATCH, rng)
    meas = make_grids(ds, 2, K_PRESSURE, BATCH, rng)
    torch.cuda.synchronize()
    gather_spmm.launches = 0
    l_warm, _ = rt.train_windows(warm, seed=10)
    torch.cuda.synchronize()
    rt.stats()
    rt.timers.reset()
    t0 = time.perf_counter()
    l_meas, edges = rt.train_windows(meas, seed=11)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = gather_spmm.launches
    stats = rt.stats()
    losses = torch.cat([l_warm, l_meas]).cpu().numpy()
    steps = losses.size
    print(f"phase 6: f32 transport, {steps} steps, kernel launches "
          f"{launches}; losses {np.array2string(losses[::4], precision=4)} "
          "(every 4th)")
    require(np.isfinite(losses).all(), "non-finite loss (pressure)")
    require(losses[-K_PRESSURE:].mean() < losses[:K_PRESSURE].mean(),
            "pressure: last window's mean loss is not below the first's")
    require(launches == steps, f"{launches} kernel launches for {steps} "
                               "pressure steps")
    require(stats["misses"] > 0 and stats["hits"] > 0,
            f"pressure counters: {stats}")
    require("replay" not in rt.timers.totals, "the replay net fired")
    require(on_card(torch, rt), "pressure state off the card")
    n_meas = l_meas.numel()
    rows = rt.timers.tallies["stage_rows"] / meas.shape[0]
    print(f"phase 6: {1000 * dt / n_meas:.3f} ms/step, "
          f"train_edges_per_s_per_chip {float(edges.sum()) / dt:.1f}, "
          f"hit ratio {stats['hit_ratio']:.4f} (hits {stats['hits']} misses "
          f"{stats['misses']}), stage rows per window {rows:.0f} "
          f"({n_meas} measured steps, host clock, {smi})")
    print("phase 6: timers of the measured windows:\n" + rt.timers.report())
    err = phase_staged_step(torch, rt, ds, gather_spmm,
                            gather_spmm_reference, rng)
    del rt
    for transport in ("bfloat16", "int8"):
        rt = make_trainer(torch, ds, store, torch.float32, "cuda",
                          stage_transport=transport, **kw)
        grid = make_grids(ds, 1, K_PRESSURE, BATCH, rng)
        torch.cuda.synchronize()
        gather_spmm.launches = 0
        lt, _ = rt.train_windows(grid, seed=12)
        torch.cuda.synchronize()
        n = gather_spmm.launches
        lt = lt.cpu().numpy()
        st = rt.stats()
        print(f"phase 6: {transport} transport, {K_PRESSURE} steps, launches "
              f"{n}, hit ratio {st['hit_ratio']:.4f}; losses "
              f"{np.array2string(lt[::4], precision=4)} (every 4th)")
        require(np.isfinite(lt).all(), f"non-finite loss ({transport})")
        require("replay" not in rt.timers.totals,
                f"the replay net fired ({transport})")
        require(n == K_PRESSURE and st["misses"] > 0,
                f"{transport}: {n} launches, {st}")
        launches += n
        del rt
    return launches, err


def phase_exact(torch, ds, store) -> None:
    """The staged path's claim on the card: a staged run (f32 transport,
    a 16 MB cache) and a flat full-coverage run on the same seeds and
    streams give the same losses."""
    grids = make_grids(ds, 2, K, BATCH, np.random.default_rng(5))
    out = {}
    for name, mb in (("staged", 16), ("flat", 1024)):
        rt = make_trainer(torch, ds, store, torch.float32, "cuda",
                          cache_mb=mb, priorities="degree")
        require(rt.direct == (name == "flat"), f"{name}: wrong tier")
        losses, _ = rt.train_windows(grids, seed=13)
        out[name] = losses.cpu().numpy()
        if name == "staged":
            require(rt.stats()["misses"] > 0 and
                    "replay" not in rt.timers.totals,
                    "exactness run: no misses or the replay net fired")
        del rt
    np.testing.assert_allclose(out["staged"], out["flat"], rtol=EXACT_RTOL,
                               atol=0)
    rel = np.abs(out["staged"] - out["flat"]) / np.abs(out["flat"])
    print(f"phase 7: staged (16 MB cache) vs flat losses over "
          f"{out['flat'].size} steps: max relative diff {rel.max():.3g} "
          f"(rtol {EXACT_RTOL})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    smi = smi_string()
    print(f"phase 1: device {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("phase 1: TF32 off for matmul and cuDNN (full f32 products)")

    from coala_gnn_tpu.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu.graph.datasets import synthetic_graph
    from coala_gnn_tpu_torch.ops.gather_spmm import (gather_spmm,
                                                     gather_spmm_reference)

    t0 = time.perf_counter()
    kern = phase_kernels(torch, gather_spmm, gather_spmm_reference)
    print(f"phase 2: done in {time.perf_counter() - t0:.1f} s (build "
          "included)")

    t0 = time.perf_counter()
    ds = synthetic_graph(num_nodes=N_NODES, avg_degree=15, feature_dim=DIM,
                         num_classes=CLASSES, seed=0)
    store = HostFeatureStore(ds.features, use_native=False)
    print(f"phase 3: graph {ds.graph.num_nodes} nodes "
          f"{ds.graph.num_edges} edges built in "
          f"{time.perf_counter() - t0:.1f} s")
    sl = phase_slice(torch, ds, store, gather_spmm, smi)
    err4 = phase_step_inputs(torch, sl["rt"], gather_spmm,
                             gather_spmm_reference, ds)
    kern[torch.float32]["max_abs_err"] = max(
        kern[torch.float32]["max_abs_err"], err4)
    phase_small(torch)
    native_store = HostFeatureStore(ds.features)
    t0 = time.perf_counter()
    press_launches, err6 = phase_pressure(torch, ds, native_store,
                                          gather_spmm, gather_spmm_reference,
                                          smi)
    kern[torch.float32]["max_abs_err"] = max(
        kern[torch.float32]["max_abs_err"], err6)
    phase_exact(torch, ds, native_store)
    print(f"phase 6-7: done in {time.perf_counter() - t0:.1f} s")

    src = "coala_gnn_tpu_torch/csrc/gather_spmm.cu"
    replaces = {torch.float32: "coala_gnn_tpu/ops/pallas_spmm.py:82",
                torch.bfloat16: "coala_gnn_tpu/ops/pallas_gather.py:77"}
    kernels = [{"name": f"gather_spmm[{str(dt).split('.')[-1]}]",
                "route": "cuda", "source": src, "replaces": replaces[dt],
                "launches": sl["launches"][dt] + (
                    press_launches if dt == torch.float32 else 0),
                **kern[dt]}
               for dt in (torch.float32, torch.bfloat16)]
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
