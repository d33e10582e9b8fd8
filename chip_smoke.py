"""Smoke run of the PyTorch / CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths once each, as a user would: ``ResidentTrainer``
training GraphSAGE-mean at ``bench.py``'s resident config (200k-node
synthetic graph, feature dim 256, hidden 256, 2 layers, fanout [10, 5],
batch 1024, dropout 0.5, Adam 1e-3): the flagship row (flat f32 table at
full coverage, K = 8), its bf16-table row, and the pressure row (a
set-associative f32 cache of ~50% of the rows, degree priorities, staged
windows of K = 32 through the native host tier); then GAT and GCN at the
same config, and the int8 cache lines on both tiers. Phases:

  1. device: a CUDA card must be present; prints its name and power limit;
  2. kernels vs plain: builds the gather-SpMM kernels from the checkout and
     holds each against its plain PyTorch version on the card: the f32,
     bf16 and int8 (+ row scales) forward at the training step's layer-0
     shape, a ragged shape and odd widths (D = 100 and 8); grad_w and
     grad_x at GAT's two head-stacked combine shapes, and grad_x on an adj
     with repeated rows (atomics that meet); times each against its plain
     version;
  3. the flagship: 1 warm-up + 2 measured windows (f32 table), then 1 window
     with a bf16 table; checks finite, falling losses, one kernel launch
     per step, full table coverage, and that table, params and optimizer
     state live on the card; prints ms/step and train edges/s;
  4. the kernel on one step's real layer-0 inputs against the plain version;
  5. small runs (SAGE, and GAT with 2 heads, which runs the backward
     kernels) on the card against the same runs of the port on the CPU;
  6. the pressure row: 1 warm-up + 2 measured staged windows (f32
     transport, native fused host gather+encode required); checks finite,
     falling losses, hits and misses, no replay, one kernel launch per
     step, state on the card; prints ms/step, train edges/s, hit ratio,
     stage rows per window and the phase timers; holds the kernel against
     the plain version on one staged step's real layer-0 inputs (cache
     lookup with stage rows overlaid, itself held against the node
     features); then one window each with bf16 and
     int8 stage transport;
  7. exactness on the card: a staged run with a small cache and a flat
     full-coverage run on the same seeds and streams give the same losses;
  8. bench.py's grid-gat-10x5 row: GAT, 4 heads of 256, flat f32 table at
     full coverage, 1 warm-up + 2 measured K = 8 windows; checks finite,
     falling losses, 6 kernel launches per step (forward, grad_w, grad_x
     on each layer), state on the card; prints ms/step, train edges/s and
     peak device memory; holds the three kernels against their plain
     versions on one real step's feat, attention and upstream gradient;
     then GCN, one K = 8 window: finite, falling losses, one launch per
     step;
  9. int8 lines: bench.py's resident-pressure-int8 row (97 MB of int8
     lines hold every row: flat tier at full coverage, int8 transport,
     1 warm-up + 2 measured K = 8 windows, one int8 launch per step, the
     int8 kernel against its plain version on one step's inputs), then
     dim1024-int8-lines at reduced depth (100k nodes, dim 1024, batch 512,
     48 MB of int8 lines ~ 49% coverage, degree priorities, 1 warm-up + 1
     measured K = 32 window; hits, misses, no replay; one staged step's
     frontier, int8 cache rows with int8 stage rows overlaid, held against
     the node features and fed to the f32 kernel against its plain
     version).

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
HEADS = 4           # bench.py's GAT grid rows: make_model's num_heads default
DIM1024_NODES, DIM1024_BATCH = 100_000, 512   # bench.py run_dim1024
EXACT_RTOL = 1e-5   # staged vs flat losses: the kernel sums the same rows
                    # in the same order on both paths, so they should agree
                    # to the last bit; 1e-5 allows only rounding noise
KERNEL_TOL = 1e-5   # forward, rtol = atol: kernel and plain version both sum
                    # the (exactly widened or dequantised) rows in f32 in the
                    # same slot order; they differ only by fused vs separate
                    # multiply-add. The backward kernels sum in other orders
                    # than their plain versions and are held to the f32
                    # error bound of those sums (ops/gather_spmm.py
                    # grad_w_error_bound / grad_x_error_bound); grad_x is
                    # exact where no table row is read twice
SMALL_RTOL, SMALL_ATOL = 2e-3, 2e-4   # losses, card vs CPU (Adam amplifies
                                      # rounding; the JAX parity tolerance)
SMALL_P_RTOL, SMALL_P_ATOL = 5e-3, 5e-4


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def reset_launches() -> None:
    """Every kernel's launch count to 0, just before a main path runs."""
    from coala_gnn_tpu_torch.ops import gather_spmm as ops

    ops.reset_launches()


def launches() -> dict:
    from coala_gnn_tpu_torch.ops.gather_spmm import LAUNCHES

    return dict(LAUNCHES)


def only_launches(name: str) -> int:
    """Launches of kernel ``name`` since the last reset; fails if any other
    kernel launched."""
    counts = launches()
    others = {k: v for k, v in counts.items() if k != name and v}
    require(not others, f"unexpected kernel launches {others}")
    return counts[name]


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


def masked_slots(torch, S, N, F, gen):
    """Sampled-style adj and weights: ~20% of slots masked (w = 0) and
    pointed at row 0, as the sampler's padding is."""
    adj = torch.randint(0, S, (N, F), generator=gen, device="cuda",
                        dtype=torch.int32)
    live = torch.rand(N, F, generator=gen, device="cuda") < 0.8
    w = torch.where(live, torch.rand(N, F, generator=gen, device="cuda"),
                    torch.zeros(N, F, device="cuda"))
    return torch.where(live, adj, torch.zeros_like(adj)), w


def kernel_inputs(torch, S, N, F, D, dtype, gen):
    """(table, its row scales for int8 else None, adj, w)."""
    from coala_gnn_tpu_torch.cache.feature_cache import quantize_rows

    x = torch.randn(S, D, generator=gen, device="cuda")
    x, scale = quantize_rows(x) if dtype == torch.int8 else (x.to(dtype),
                                                              None)
    return (x, scale, *masked_slots(torch, S, N, F, gen))


def max_err(torch, out, ref, what: str) -> float:
    require(out.shape == ref.shape and out.dtype == torch.float32,
            f"{what}: shape/dtype {tuple(out.shape)} {out.dtype}")
    require(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    require(torch.allclose(out, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL),
            f"{what}: kernel disagrees with the plain version")
    return float((out - ref).abs().max())


def within_bound(torch, out, ref, bound, what: str) -> float:
    """Kernel vs plain within a per-entry error bound -> max abs error."""
    require(out.shape == ref.shape and bool(torch.isfinite(out).all()),
            f"{what}: shape {tuple(out.shape)} or non-finite output")
    err = (out - ref).abs()
    require(bool((err <= bound).all()), f"{what}: kernel outside the f32 "
            f"error bound of its plain version (max err {err.max():.3g})")
    return float(err.max())


def timed(torch, entry: dict, kernel, plain) -> None:
    """Median ms of the kernel and of its plain version into ``entry``."""
    entry["ms"] = median_ms(torch, kernel)
    entry["plain_ms"] = median_ms(torch, plain)


def gat_combine_shapes():
    """(S, N, F, D, cap_src, cap_dst) of GAT's head-stacked combine on each
    layer at the flagship config: S = cap_src * heads rows of feat, N =
    cap_dst * heads dst rows, F = fanout, D = features per head."""
    from coala_gnn_tpu.sampling.neighbor import block_capacities

    caps = block_capacities(BATCH, FANOUTS)
    feats = [HIDDEN, CLASSES]
    return [(src * HEADS, dst * HEADS, f, d, src, dst)
            for (dst, src), f, d in zip(caps, FANOUTS, feats)]


def phase_kernels(torch) -> dict:
    """Every kernel entry against its plain version; returns the kernels
    JSON entries (max_abs_err, ms, plain_ms) by name."""
    from coala_gnn_tpu_torch.models.layers import head_stacked_adj
    from coala_gnn_tpu_torch.ops.gather_spmm import (
        gather_spmm, gather_spmm_grad_w, gather_spmm_grad_w_reference,
        gather_spmm_grad_x, gather_spmm_grad_x_reference,
        gather_spmm_reference, grad_w_error_bound, grad_x_error_bound)

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (N_NODES + 1, 6 * BATCH, FANOUTS[0], DIM)
    res = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        name = f"gather_spmm[{str(dtype).split('.')[-1]}]"
        x, scale, adj, w = kernel_inputs(torch, *shape, dtype, gen)
        out = gather_spmm(x, adj, w, scale)
        ref = gather_spmm_reference(x, adj, w, scale)
        torch.cuda.synchronize()
        res[name] = {"max_abs_err": max_err(torch, out, ref,
                                            f"{name} {shape}")}
        timed(torch, res[name], lambda: gather_spmm(x, adj, w, scale),
              lambda: gather_spmm_reference(x, adj, w, scale))
        print(f"phase 2: {name} S,N,F,D={shape}: max_abs_err "
              f"{res[name]['max_abs_err']:.3g} (tol {KERNEL_TOL}), kernel "
              f"{res[name]['ms']:.4f} ms, plain {res[name]['plain_ms']:.4f} "
              "ms (median of 25, L2 flushed)")
        for S, N, F, D in [(50, 17, 10, 128), (3000, 500, 10, 100),
                           (3000, 500, 10, 8)]:
            x, scale, adj, w = kernel_inputs(torch, S, N, F, D, dtype, gen)
            out = gather_spmm(x, adj, w, scale)
            ref = gather_spmm_reference(x, adj, w, scale)
            torch.cuda.synchronize()
            err = max_err(torch, out, ref, f"{name} ({S},{N},{F},{D})")
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
            print(f"phase 2: {name} S,N,F,D=({S},{N},{F},{D}): max_abs_err "
                  f"{err:.3g}")

    res["gather_spmm_grad_w"], res["gather_spmm_grad_x"] = {}, {}
    for layer, (S, N, F, D, cap_src, cap_dst) in enumerate(
            gat_combine_shapes()):
        x = torch.randn(S, D, generator=gen, device="cuda")
        g = torch.randn(N, D, generator=gen, device="cuda")
        _, w = masked_slots(torch, S, N, F, gen)
        adj = head_stacked_adj(None, cap_src, (cap_dst, F), HEADS, "cuda")
        rand_adj = torch.randint(0, S, (N, F), generator=gen, device="cuda",
                                 dtype=torch.int32)
        gw = gather_spmm_grad_w(x, adj, g)
        err_w = within_bound(torch, gw, gather_spmm_grad_w_reference(
            x, adj, g), grad_w_error_bound(x, adj, g), "grad_w")
        require(bool((gw[w == 0] != 0).any()),
                "grad_w: zero-weight slots got no gradient")
        gx = gather_spmm_grad_x(adj, w, g, S)
        require(bool(torch.equal(gx, gather_spmm_grad_x_reference(
            adj, w, g, S))), "grad_x: not exact on the head-stacked layout")
        gx = gather_spmm_grad_x(rand_adj, w, g, S)
        err_x = within_bound(torch, gx, gather_spmm_grad_x_reference(
            rand_adj, w, g, S), grad_x_error_bound(rand_adj, w, g, S),
            "grad_x, repeated rows")
        torch.cuda.synchronize()
        times = {"gather_spmm_grad_w": {}, "gather_spmm_grad_x": {}}
        timed(torch, times["gather_spmm_grad_w"],
              lambda: gather_spmm_grad_w(x, adj, g),
              lambda: gather_spmm_grad_w_reference(x, adj, g))
        timed(torch, times["gather_spmm_grad_x"],
              lambda: gather_spmm_grad_x(adj, w, g, S),
              lambda: gather_spmm_grad_x_reference(adj, w, g, S))
        for name, err in (("gather_spmm_grad_w", err_w),
                          ("gather_spmm_grad_x", err_x)):
            r = res[name]
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
            if layer == 0:                    # the JSON line's shape
                r.update(times[name])
            print(f"phase 2: {name} GAT layer {layer} combine S,N,F,D="
                  f"({S},{N},{F},{D}): max_abs_err {err:.3g} (f32 sum "
                  f"bound), kernel {times[name]['ms']:.4f} ms, plain "
                  f"{times[name]['plain_ms']:.4f} ms")
    return res


def make_trainer(torch, ds, store, dtype, device, dropout=0.5, lr=1e-3,
                 fanouts=FANOUTS, batch=BATCH, hidden=HIDDEN, cache_mb=1024,
                 model_type="sage", num_heads=HEADS, quantize=False,
                 sgd=False, **trainer_kw):
    """bench.py run_resident's trainer: every row prewarmed when the cache
    covers the graph, else (capacity pressure) the highest-degree nodes."""
    from coala_gnn_tpu_torch.cache import feature_cache as fc
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.parallel.resident import ResidentTrainer

    cfg = fc.make_config(cache_mb=cache_mb, dim=ds.feature_dim, dtype=dtype,
                         quantize=quantize)
    model = make_model(model_type, ds.feature_dim, hidden, ds.num_classes,
                       len(fanouts), num_heads=num_heads, dropout=dropout,
                       seed=1).to(device)
    opt = (torch.optim.SGD(model.parameters(), lr=lr) if sgd else
           torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8))
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


def phase_slice(torch, ds, store, smi) -> dict:
    rng = np.random.default_rng(0)
    rt = make_trainer(torch, ds, store, torch.float32, "cuda")
    require(bool(rt.cache.admitted[:N_NODES].all()), "prewarm left rows out")
    warm, meas = make_grids(ds, 1, K, BATCH, rng), make_grids(ds, 2, K,
                                                              BATCH, rng)
    torch.cuda.synchronize()
    reset_launches()
    l_warm, _ = rt.train_windows(warm, seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l_meas, edges = rt.train_windows(meas, seed=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = only_launches("gather_spmm[float32]")
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
    reset_launches()
    l16, _ = rt16.train_windows(grid16, seed=2)
    torch.cuda.synchronize()
    launches16 = only_launches("gather_spmm[bfloat16]")
    l16 = l16.cpu().numpy()
    print(f"phase 3: bf16 table, {K} steps, kernel launches {launches16}; "
          f"losses {np.array2string(l16, precision=4)}")
    require(np.isfinite(l16).all(), "non-finite loss (bf16 table)")
    require(launches16 == K, f"{launches16} launches for {K} bf16 steps")
    return {"rt": rt, "launches": {"gather_spmm[float32]": launches,
                                   "gather_spmm[bfloat16]": launches16}}


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
    """The port's small training runs on the card vs on the CPU (the CPU
    port is held against the JAX package by tests/test_torch_resident.py):
    SAGE with Adam, and GAT (2 heads) with SGD, whose backward runs the
    grad_w and grad_x kernels. SGD because the softmax over the slots
    cancels the last layer's attn_r wherever its scores stay on one side
    of the leaky ReLU: that gradient is rounding noise, which Adam would
    turn into lr-sized steps of random sign."""
    from coala_gnn_tpu.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu.graph.datasets import synthetic_graph

    ds = synthetic_graph(num_nodes=250, avg_degree=4, feature_dim=8,
                         num_classes=4, seed=5)
    fan = int(ds.graph.in_degrees().max())
    store = HostFeatureStore(ds.features, use_native=False)
    grids = make_grids(ds, 3, 4, 16, np.random.default_rng(3))
    for model_type in ("sage", "gat"):
        out = {}
        for device in ("cuda", "cpu"):
            rt = make_trainer(torch, ds, store, torch.float32, device,
                              dropout=0.0, lr=1e-2, fanouts=[fan, fan],
                              batch=16, hidden=8, model_type=model_type,
                              num_heads=2, sgd=model_type == "gat")
            reset_launches()
            losses, _ = rt.train_windows(grids, seed=7)
            out[device] = (losses.cpu().numpy(),
                           [p.detach().cpu().numpy()
                            for p in rt.model.parameters()], launches())
        card, host = out["cuda"], out["cpu"]
        np.testing.assert_allclose(card[0], host[0], rtol=SMALL_RTOL,
                                   atol=SMALL_ATOL)
        for a, b in zip(card[1], host[1]):
            np.testing.assert_allclose(a, b, rtol=SMALL_P_RTOL,
                                       atol=SMALL_P_ATOL)
        steps = grids.shape[0] * grids.shape[1]
        if model_type == "gat":
            require(card[2]["gather_spmm_grad_w"] == 2 * steps and
                    card[2]["gather_spmm_grad_x"] == 2 * steps,
                    f"small GAT run: backward launches {card[2]}")
        print(f"phase 5: small {model_type} run (250 nodes, {steps} steps) "
              f"card vs CPU: losses max diff "
              f"{np.abs(card[0] - host[0]).max():.3g}, within rtol "
              f"{SMALL_RTOL} atol {SMALL_ATOL}; params within rtol "
              f"{SMALL_P_RTOL} atol {SMALL_P_ATOL}; card launches {card[2]}")


def phase_staged_step(torch, rt, ds, gather_spmm, gather_spmm_reference,
                      rng, batch=BATCH, label="phase 6") -> float:
    """The kernel on one staged step's real layer-0 inputs against the
    plain version: a window's probe and stage, step 0's cache lookup with
    the stage rows overlaid (the table), the slot positions (adj) and the
    step's mask, as ``ResidentTrainer._window`` hands them to the kernel.
    Also holds that table against the graph's features: every valid
    frontier row is its node's row, exactly with f32 lines and f32
    transport, within half a quantisation step with int8 lines and int8
    transport."""
    from coala_gnn_tpu_torch.ops.aggregate import frontier_adj
    from coala_gnn_tpu_torch.utils.rng import SAMPLE, step_generators

    seed = 14
    quantized = rt.cache_cfg.quantize
    require(rt.stage_transport == ("int8" if quantized else "float32"),
            f"{label}: staged check needs f32 lines with f32 transport or "
            f"int8 lines with int8 transport, not {rt.stage_transport}")
    grid = torch.as_tensor(make_grids(ds, 1, K_PRESSURE, batch, rng)[0],
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
    want = torch.as_tensor(ds.features[safe[valid].cpu().numpy()],
                           device=rt.device)
    row_err = (feats[valid].float() - want).abs().amax(dim=1)
    bound = (want.abs().amax(dim=1) * (0.5 / 127 + 2**-20) if quantized
             else torch.zeros_like(row_err))
    require(bool((row_err <= bound).all()), f"{label}: frontier rows "
            "(cache lookup + stage overlay) differ from the node features "
            f"beyond {'half a quantisation step' if quantized else 0}")
    mask = blocks[0].mask.contiguous()
    adj = frontier_adj(rt._slots, tuple(mask.shape))
    out = gather_spmm(feats, adj, mask)
    ref = gather_spmm_reference(feats, adj, mask)
    torch.cuda.synchronize()
    err = max_err(torch, out, ref, f"{label}: one staged step's layer-0 "
                                   "inputs")
    print(f"{label}: frontier rows vs node features: max abs diff "
          f"{float(row_err.max()):.3g} ({'int8' if quantized else 'f32'} "
          f"lines); kernel on a staged step's layer-0 inputs (frontier "
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
    reset_launches()
    l_warm, _ = rt.train_windows(warm, seed=10)
    torch.cuda.synchronize()
    rt.stats()
    rt.timers.reset()
    t0 = time.perf_counter()
    l_meas, edges = rt.train_windows(meas, seed=11)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = only_launches("gather_spmm[float32]")
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
        reset_launches()
        lt, _ = rt.train_windows(grid, seed=12)
        torch.cuda.synchronize()
        n = only_launches("gather_spmm[float32]")
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


def run_row(torch, rt, ds, n_warm, n_meas, k, batch, seed, rng):
    """1 warm-up phase of ``n_warm`` windows and ``n_meas`` measured windows
    of K = ``k``, with every launch count set to 0 just before the warm-up
    and read just after the measured windows. Returns (losses of all steps
    as numpy, measured edges, measured seconds, launches, stats of the
    measured windows)."""
    warm = make_grids(ds, n_warm, k, batch, rng)
    meas = make_grids(ds, n_meas, k, batch, rng)
    torch.cuda.synchronize()
    reset_launches()
    l_warm, _ = rt.train_windows(warm, seed=seed)
    torch.cuda.synchronize()
    rt.stats()
    rt.timers.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    l_meas, edges = rt.train_windows(meas, seed=seed + 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launches()
    losses = torch.cat([l_warm, l_meas]).cpu().numpy()
    return losses, float(edges.sum()), dt, counts, rt.stats()


def check_falling(losses, k: int, what: str) -> None:
    require(np.isfinite(losses).all(), f"non-finite loss ({what})")
    require(losses[-k:].mean() < losses[:k].mean(),
            f"{what}: the last window's mean loss is not below the first's")


def report_row(label: str, losses, edges, dt, n_meas, smi) -> None:
    some = losses[::max(losses.size // 12, 1)]
    print(f"{label}: {1000 * dt / n_meas:.3f} ms/step, "
          f"train_edges_per_s_per_chip {edges / dt:.1f} ({n_meas} measured "
          f"steps, host clock, {smi}); losses "
          f"{np.array2string(some, precision=4)}")


def phase_gat_step(torch, rt, ds) -> dict:
    """The three kernels on one real GAT step against their plain versions:
    the head-stacked feat, adjacency and attention each layer hands the
    forward kernel, and the upstream gradient its output receives. Returns
    max_abs_err by kernel name."""
    from coala_gnn_tpu_torch.models import layers
    from coala_gnn_tpu_torch.models.layers import TableInput
    from coala_gnn_tpu_torch.ops.gather_spmm import (
        gather_spmm_grad_w, gather_spmm_grad_w_reference,
        gather_spmm_grad_x, gather_spmm_grad_x_reference,
        gather_spmm_reference, grad_w_error_bound)
    from coala_gnn_tpu_torch.utils.rng import SAMPLE, step_generators

    seeds = torch.as_tensor(ds.train_idx[:BATCH].astype(np.int32),
                            device="cuda")
    gen = step_generators(30, 0, 1, SAMPLE, rt.device)[0]
    blocks, _, _, safe = rt._sample(seeds, gen)
    kernel, calls = layers.gather_spmm, []

    def recording(x, adj, w):
        out = kernel(x, adj, w)
        rec = {"x": x.detach(), "adj": adj, "w": w.detach(),
               "out": out.detach()}
        out.register_hook(lambda g: rec.update(g=g.detach().contiguous()))
        calls.append(rec)
        return out

    layers.gather_spmm = recording
    try:
        logits = rt.model(blocks, TableInput(rt.cache.data, safe),
                          train=False)[:BATCH]
        torch.nn.functional.cross_entropy(
            logits, rt.labels_dev[seeds.long()]).backward()
    finally:
        layers.gather_spmm = kernel
    rt.optimizer.zero_grad(set_to_none=True)
    require(len(calls) == 2 and all("g" in c for c in calls),
            "GAT step: expected two combines with upstream gradients")
    errs = {"gather_spmm[float32]": 0.0, "gather_spmm_grad_w": 0.0,
            "gather_spmm_grad_x": 0.0}
    for layer, c in enumerate(calls):
        x, adj, w, g = c["x"], c["adj"], c["w"], c["g"]
        s = x.shape[0]
        e_f = max_err(torch, c["out"], gather_spmm_reference(x, adj, w),
                      f"GAT layer {layer} forward")
        e_w = within_bound(torch, gather_spmm_grad_w(x, adj, g),
                           gather_spmm_grad_w_reference(x, adj, g),
                           grad_w_error_bound(x, adj, g),
                           f"GAT layer {layer} grad_w")
        gx = gather_spmm_grad_x(adj, w, g, s)
        ref = gather_spmm_grad_x_reference(adj, w, g, s)
        require(bool(torch.equal(gx, ref)), f"GAT layer {layer} grad_x not "
                "exact (each feat row is read by one slot)")
        torch.cuda.synchronize()
        for name, e in zip(errs, (e_f, e_w, 0.0)):
            errs[name] = max(errs[name], e)
        print(f"phase 8: GAT layer {layer} real step: feat {tuple(x.shape)}, "
              f"adj {tuple(adj.shape)}, alpha zero slots "
              f"{int((w == 0).sum())}: forward max_abs_err {e_f:.3g}, grad_w "
              f"{e_w:.3g} (within bound), grad_x exact")
    return errs


def phase_gat_gcn(torch, ds, store, smi) -> tuple:
    """bench.py's grid-gat-10x5 row, then one GCN window; returns (launches
    by kernel, kernel errors on a real GAT step)."""
    rng = np.random.default_rng(6)
    rt = make_trainer(torch, ds, store, torch.float32, "cuda",
                      model_type="gat")
    require(rt.direct and rt.full_coverage, "GAT row: not at full coverage")
    losses, edges, dt, counts, stats = run_row(torch, rt, ds, 1, 2, K,
                                               BATCH, 20, rng)
    peak = torch.cuda.max_memory_allocated()
    steps = losses.size
    print(f"phase 8: GAT ({HEADS} heads x {HIDDEN}), {steps} steps, "
          f"launches {counts}")
    check_falling(losses, K, "GAT")
    for name in ("gather_spmm[float32]", "gather_spmm_grad_w",
                 "gather_spmm_grad_x"):
        require(counts[name] == 2 * steps, f"GAT: {counts[name]} {name} "
                f"launches for {steps} steps (2 per step)")
    require(sum(counts.values()) == 6 * steps, f"GAT launches {counts}")
    require(stats["misses"] == 0 and stats["hits"] > 0, f"GAT {stats}")
    require(on_card(torch, rt), "GAT state off the card")
    report_row("phase 8: GAT", losses, edges, dt, steps - K, smi)
    print(f"phase 8: GAT peak device memory over the measured windows "
          f"{peak / 2**30:.3f} GiB ({smi})")
    errs = phase_gat_step(torch, rt, ds)
    del rt

    rt = make_trainer(torch, ds, store, torch.float32, "cuda",
                      model_type="gcn")
    grid = make_grids(ds, 1, K, BATCH, rng)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    lg, eg = rt.train_windows(grid, seed=22)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = only_launches("gather_spmm[float32]")
    lg = lg.cpu().numpy()
    require(np.isfinite(lg).all() and lg[-K // 2:].mean() < lg[:K // 2].mean(),
            f"GCN: losses not finite and falling {lg}")
    require(n == K, f"GCN: {n} launches for {K} steps")
    report_row("phase 8: GCN (one window, warm-up included)", lg,
               float(eg.sum()), dt, K, smi)
    counts["gather_spmm[float32]"] += n
    return counts, errs


def phase_int8(torch, ds, store, smi) -> tuple:
    """bench.py's resident-pressure-int8 row, then dim1024-int8-lines at
    reduced depth; returns (launches by kernel, the int8 kernel's error on
    one flat step's real inputs, the f32 kernel's error on one staged
    dim1024 step's real inputs)."""
    from coala_gnn_tpu.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu.graph.datasets import synthetic_graph
    from coala_gnn_tpu_torch.ops.aggregate import frontier_adj
    from coala_gnn_tpu_torch.ops.gather_spmm import (gather_spmm,
                                                     gather_spmm_reference)
    from coala_gnn_tpu_torch.utils.rng import SAMPLE, step_generators

    rng = np.random.default_rng(7)
    mb = pressure_mb(ds)
    rt = make_trainer(torch, ds, store, torch.float32, "cuda", cache_mb=mb,
                      quantize=True)
    cfg = rt.cache_cfg
    require(rt.direct and rt.full_coverage and cfg.quantize and
            rt.stage_transport == "int8" and
            rt.cache.data.dtype == torch.int8, "int8 row: not int8 lines at "
            "full coverage with int8 transport")
    print(f"phase 9: int8 lines, {mb} MB = {cfg.capacity} lines of "
          f"{cfg.line_bytes} B for {N_NODES} nodes: flat tier at full "
          "coverage")
    losses, edges, dt, counts, stats = run_row(torch, rt, ds, 1, 2, K,
                                               BATCH, 40, rng)
    steps = losses.size
    n8 = counts["gather_spmm[int8]"]
    check_falling(losses, K, "int8 lines")
    require(n8 == steps and sum(counts.values()) == n8,
            f"int8 lines: launches {counts} for {steps} steps")
    require(stats["misses"] == 0 and stats["hits"] > 0, f"int8 {stats}")
    require(on_card(torch, rt) and rt.cache.scale.is_cuda,
            "int8 state off the card")
    report_row("phase 9: resident-pressure-int8", losses, edges, dt,
               steps - K, smi)
    seeds = torch.as_tensor(ds.train_idx[:BATCH].astype(np.int32),
                            device="cuda")
    gen = step_generators(41, 0, 1, SAMPLE, rt.device)[0]
    blocks, _, _, safe = rt._sample(seeds, gen)
    mask = blocks[0].mask.contiguous()
    adj = frontier_adj(safe, tuple(mask.shape))
    table, scale = rt.cache.data, rt.cache.scale
    out = gather_spmm(table, adj, mask, scale)
    ref = gather_spmm_reference(table, adj, mask, scale)
    torch.cuda.synchronize()
    err = max_err(torch, out, ref, "int8 kernel on a step's inputs")
    print(f"phase 9: int8 kernel on a step's layer-0 inputs (table "
          f"{tuple(table.shape)} int8 + scales, adj {tuple(adj.shape)}): "
          f"max_abs_err {err:.3g}")
    del rt

    t0 = time.perf_counter()
    ds2 = synthetic_graph(num_nodes=DIM1024_NODES, avg_degree=15,
                          feature_dim=1024, num_classes=CLASSES, seed=0)
    store2 = HostFeatureStore(ds2.features)
    mb2 = max(int(DIM1024_NODES * 0.125 * 1024 * 4) >> 20, 1)
    rt = make_trainer(torch, ds2, store2, torch.float32, "cuda",
                      cache_mb=mb2, quantize=True, priorities="degree",
                      batch=DIM1024_BATCH)
    cfg = rt.cache_cfg
    require(not rt.direct and rt.stage_transport == "int8" and
            rt._store is not None, "dim1024: not staged int8 lines with "
            "the native host store")
    print(f"phase 9: dim1024-int8-lines: graph of {DIM1024_NODES} nodes "
          f"x 1024 built in {time.perf_counter() - t0:.1f} s; {mb2} MB = "
          f"{cfg.capacity} int8 lines ({cfg.capacity / DIM1024_NODES:.3f} "
          "coverage), degree priorities")
    losses, edges, dt, c2, stats = run_row(torch, rt, ds2, 1, 1,
                                           K_PRESSURE, DIM1024_BATCH, 42, rng)
    require(np.isfinite(losses).all(), "dim1024: non-finite loss")
    require(stats["misses"] > 0 and stats["hits"] > 0, f"dim1024 {stats}")
    require("replay" not in rt.timers.totals, "dim1024: the replay net fired")
    require(c2["gather_spmm[float32]"] == losses.size and
            sum(c2.values()) == losses.size, f"dim1024 launches {c2}")
    rows = rt.timers.tallies["stage_rows"]
    report_row("phase 9: dim1024-int8-lines", losses, edges, dt, K_PRESSURE,
               smi)
    print(f"phase 9: dim1024-int8-lines hit ratio {stats['hit_ratio']:.4f} "
          f"(hits {stats['hits']} misses {stats['misses']}), stage rows "
          f"{rows:.0f} in the measured window; timers:\n"
          + rt.timers.report())
    err_staged = phase_staged_step(torch, rt, ds2, gather_spmm,
                                   gather_spmm_reference, rng,
                                   batch=DIM1024_BATCH, label="phase 9")
    del rt
    for name, v in c2.items():
        counts[name] += v
    return counts, err, err_staged


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
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
    kern = phase_kernels(torch)
    print(f"phase 2: done in {time.perf_counter() - t0:.1f} s (build "
          "included)")

    def worst(name, err):
        kern[name]["max_abs_err"] = max(kern[name]["max_abs_err"], err)

    t0 = time.perf_counter()
    ds = synthetic_graph(num_nodes=N_NODES, avg_degree=15, feature_dim=DIM,
                         num_classes=CLASSES, seed=0)
    store = HostFeatureStore(ds.features, use_native=False)
    print(f"phase 3: graph {ds.graph.num_nodes} nodes "
          f"{ds.graph.num_edges} edges built in "
          f"{time.perf_counter() - t0:.1f} s")
    sl = phase_slice(torch, ds, store, smi)
    main_launches = dict(sl["launches"])
    worst("gather_spmm[float32]", phase_step_inputs(
        torch, sl["rt"], gather_spmm, gather_spmm_reference, ds))
    del sl
    phase_small(torch)
    native_store = HostFeatureStore(ds.features)
    t0 = time.perf_counter()
    press_launches, err6 = phase_pressure(torch, ds, native_store,
                                          gather_spmm, gather_spmm_reference,
                                          smi)
    main_launches["gather_spmm[float32]"] += press_launches
    worst("gather_spmm[float32]", err6)
    phase_exact(torch, ds, native_store)
    print(f"phase 6-7: done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    gat_launches, gat_errs = phase_gat_gcn(torch, ds, store, smi)
    for name, err in gat_errs.items():
        worst(name, err)
    print(f"phase 8: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    int8_launches, err9, err9_staged = phase_int8(torch, ds, native_store,
                                                  smi)
    worst("gather_spmm[int8]", err9)
    worst("gather_spmm[float32]", err9_staged)
    print(f"phase 9: done in {time.perf_counter() - t0:.1f} s")
    for counts in (gat_launches, int8_launches):
        for name, n in counts.items():
            main_launches[name] = main_launches.get(name, 0) + n

    src = "coala_gnn_tpu_torch/csrc/gather_spmm.cu"
    replaces = {"gather_spmm[float32]": "coala_gnn_tpu/ops/pallas_spmm.py:82",
                "gather_spmm[bfloat16]":
                    "coala_gnn_tpu/ops/pallas_gather.py:77",
                "gather_spmm[int8]": "coala_gnn_tpu/ops/pallas_spmm.py:82",
                "gather_spmm_grad_w": "coala_gnn_tpu/models/layers.py:143",
                "gather_spmm_grad_x": "coala_gnn_tpu/models/layers.py:143"}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": where, "launches": main_launches[name],
                **kern[name]} for name, where in replaces.items()]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']} never launched on the "
                "main path")
    print(f"all phases: {time.perf_counter() - t_start:.1f} s of command "
          "time (build included)")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
