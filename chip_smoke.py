"""Smoke run of the PyTorch / CUDA port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths once each, as a user would: ``ResidentTrainer``
training GraphSAGE-mean at ``bench.py``'s resident config (200k-node
synthetic graph, feature dim 256, hidden 256, 2 layers, fanout [10, 5],
batch 1024, dropout 0.5, Adam 1e-3): the flagship row (flat f32 table at
full coverage, K = 8), its bf16-table row, and the pressure row (a
set-associative f32 cache of ~50% of the rows, degree priorities, staged
windows of K = 32 through the native host tier); then GAT and GCN at the
same config, the int8 cache lines on both tiers, and the bf16 model dtype
(resident-bf16, a bf16 GAT and GCN, int8 lines on a bf16 table), the
trainer CLI's hetero models, the CLI's ``--pipeline resident``
(``ShardedResidentTrainer``), and the CLI's host and resident pipelines
data-parallel over two ranks. Phases:

  1. device: a CUDA card must be present; prints its name and power limit;
  2. kernels vs plain: builds the gather-SpMM kernels from the checkout and
     holds each against its plain PyTorch version on the card: the f32,
     bf16 and int8 (+ row scales) forward and the f32 and int8 tables read
     as bf16 at the training step's layer-0 shape, a ragged shape, widths
     100, 16, 8 and 1, and GAT layer 1's combine (D = 16); adj's
     transpose, grad_w and grad_x (over the transpose) at GAT's two
     head-stacked combine shapes (grad_w and the forward also on bf16
     feat, a bf16 model's combine), and the
     transpose and grad_x on an adj with repeated rows; the transpose again
     at the host-packed step's layer-1 shape, where it must take its
     one-block form, and at every shape above one block at full width
     (RGAT's stacked layers 0 and 1, GAT layer 0 contiguous and on the
     host sampler's layout with and without its padded rows at row 0),
     bitwise and timed; then one call at each shape captured in a CUDA
     graph: one node (device operation) each, replayed bitwise; prints
     the
     transpose's form at each shape, and each
     kernel's registers and spills; times each against its plain version,
     its bound (bytes or operations over the card's published peak) and,
     for the f32 forward, the one PyTorch call of the same function
     (embedding_bag);
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
     on each layer) plus 2 transposes in the run (one per layer's combine
     shape, kept), state on the card; prints ms/step, train edges/s and
     peak device memory; holds the kernels against their plain versions
     on one real step's feat, attention, kept transpose and upstream
     gradient;
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
     version);
 10. the host pipeline (``parallel/host_pipeline.run_host``, bench.py's
     run_host: host sampler, seed distribution, prefetching loader, one
     request buffer per step, the one-device cache front with the probe
     one batch ahead and speculative groups of 8): host-packed (dedup
     layout, SAGE's aggregation through the kernel) and host-contig
     (slot-major sentinel layout, no kernel) with a 1024 MB cache
     prewarmed to full coverage, host-packed under pressure (phase 6's
     97 MB cache, degree prewarm: misses, fills and replays on the card),
     and uncached (host gather + upload every step); 4 warm-up + 16
     measured steps (uncached 2 + 6); checks finite, falling losses and
     the launches (per dedup step 2 forwards, 1 transpose, 1 grad_x; none
     on the contiguous layout); prints ms/step, edges/s, hit ratio,
     replays, launches per step and the host sampler's and packer's ms
     per batch; holds the forward at layers 0 and 1, grad_x and adj's
     transpose at layer 1 against their plain versions on one real
     host-packed step's inputs (the transpose bitwise, in its one-block
     form), and counts the device operations of one transpose call there
     (``device_ops``, must be one); host-packed-bf16
     (bf16 lines, f32 model: bench.py's run_host(bf16=True)) beside
     host-packed;
 11. resident-bf16 (bench.py's row: bf16 flat table at full coverage, a
     bf16 SAGE, K = 8, 1 warm-up + 2 measured windows): finite, falling
     losses, one bf16 forward per step and nothing else; the kernel on one
     real step's layer-0 inputs;
 12. a bf16 GAT at grid-gat-10x5's shapes on the f32 table, 1 + 1 windows:
     per step the bf16 combine, grad_w on bf16 feat and grad_x on each
     layer (layer 0's frontier rows gathered and rounded to bf16 by
     PyTorch), 2 transposes per run; each kernel on one real step's
     inputs; then one K = 8 window of a bf16 GCN on the f32 table: one
     f32-as-bf16 launch per step and nothing else, the kernel on one real
     step's layer-0 inputs;
 13. int8 lines on a bf16 flat table (phase 9's 97 MB), bf16 SAGE, 1 + 1
     windows: one int8-as-bf16 launch per step (the neighbour sum; the dst
     rows are gathered and rounded by PyTorch), held to the plain version
     on one real step;
 14. small bf16 SAGE and GAT runs (SGD) on the card against the same runs
     of the port on the CPU (rtol = atol = 2e-2);
 15. the hetero models through the trainer CLI's own code
     (``coala_gnn_tpu_torch.train``: ``build`` and its epoch loop
     ``train``): RSAGE, RGCN and RGAT (4 heads) at the flagship widths on
     the 200k-node graph with 3 random edge types (the CLI's default for a
     hetero model), the 1024 MB one-device cache front, dropout 0.5, Adam
     1e-3, 4 warm-up + 16 measured steps each; checks finite, falling
     losses, the kernel launches of every measured step (each layer's
     relations in one stacked gather-SpMM call: RSAGE / RGCN 2 forwards, 1
     transpose and 1 grad_x; RGAT per layer a combine, grad_w, grad_x and
     a transpose) and nothing else, and params, optimizer state and cache
     on the card; prints ms/step, train edges/s and peak device memory;
     holds every stacked entry against its plain version on one real
     step's inputs (forwards at 1e-5, grad_w / grad_x within their f32
     bounds, the transposes bitwise) and times each beside its bound; then
     small CLI runs card vs CPU: each model in f32 (2e-3 / 2e-4), a bf16
     RSAGE and RGAT (2e-2);
 16. the trainer CLI's ``--pipeline resident`` (``train.build`` /
     ``train`` / ``evaluate`` over ``parallel/sharded_resident.py``) at the
     flagship widths, the cache cold at the start, 4 warm-up + 16 measured
     steps per row: SAGE on the 1024 MB cache with ``--window 8``, then
     ``--window 1`` (per-step, one ``begin`` ahead) and its ``--eval``,
     SAGE on 97 MB with ``--window 8`` (staged windows under pressure),
     GAT and RGAT (4 heads, 3 edge types) on 1024 MB with ``--window 8``,
     and RGAT with ``--dtype bfloat16``; checks finite, falling losses,
     the launches of every measured step (SAGE 1 forward, its layer 0 off
     the frontier; GAT / RGAT per layer a combine, grad_w and grad_x, the
     transposes kept; eval 1 forward per batch) and nothing else, no
     replay, state on the card; prints ms/step, train edges/s, hit ratio,
     feature agg ms/step, stage rows and peak memory; holds every kernel
     call of one real step of each row against its plain version and
     times it; a host-CLI SAGE row in the same call, beside the resident
     rows; then small resident CLI runs card vs CPU (SAGE under
     pressure, GAT and RGAT in f32 at 2e-3 / 2e-4, RGAT bf16 at 2e-2);
 17. the last one-card flags, at the flagship widths: (1)
     ``ResidentTrainer(nbr_cap=32)``, the padded neighbour table, 1
     warm-up + 2 measured K = 8 windows in turns with phase 3's CSR
     trainer: the table sampler on the card equals the CSR one given its
     uniforms for every dst of degree <= 32 and stays in the stored subset
     above; finite, falling losses, one f32 launch per step; the table's
     MB and both ms/step; (2) ``ResidentTrainer(dedup=True)``, 2 warm-up +
     8 measured ``begin`` / ``resolve`` / ``train_step`` steps: the card's
     dedup of one real layer-0 ``cat`` bitwise equal to the CPU's, finite,
     falling losses, per step 2 forwards, 1 transpose and 1 grad_x (the
     blocks' adj), every kernel call of one real step against its plain
     version, timed; (3) the resident CLI with ``--nbr_cap 32 --window 8``
     for SAGE and RGAT (4 heads, 3 edge types: the relation table),
     phase 16's checks and prints; (4) the color metadata of the 200k
     graph through the port's native library, then the CLI with
     ``--distribution node_color --color_dir`` on the host path and on
     ``--pipeline resident --window 8``: seed slices equal to a baseline
     distributor's (one part), the cache's color counters equal to its
     colored lines, SAGE's launches; (5) ``--save_dir`` / ``--resume``:
     the resident CLI's SAGE restored bitwise and its resumed epoch's
     losses equal to the uninterrupted run's (1e-5), the host CLI's
     restore bitwise;
 18. the reference's on-disk layouts through the trainer CLI (``--data``,
     ``--path``), written into a temporary directory with the port's own
     ``synthetic_graph``: IGB's homogeneous layout (100k papers, IGB's dim
     1024, avg degree 15, 19 classes, float32 labels, ``edge_index`` [E,
     2]), the preprocessed layout through ``python -m
     coala_gnn_tpu_torch.create_csc_graph``, IGB-hetero's (4 node types,
     4 edge directories, 8 relations with the reverses); ``--data igb``
     SAGE resident (``--window 8``) and on the host pipeline,
     ``--data preprocessed`` SAGE resident, ``--data igb-hetero`` RGAT (4
     heads) on the host pipeline, each at hidden 256, fanout 10,5, batch
     1024, the 1024 MB cache cold, 4 + 16 steps, with phase 16's checks
     and prints (the CLI prints its hit ratio per epoch), the features
     still a memory map of their file (IGB-hetero's flattened table is
     built in RAM, as in JAX); every kernel of one real step of each row
     against its plain version, timed (D = 1024 at layer 0, RGAT's
     stacked calls over 8 relations);
 19. the reference-scale leg (``coala_gnn_tpu_torch.reference_scale``) at
     reduced depth: ``generate`` at 1M nodes, avg degree 15, dim 1024
     (4.1 GB in the temporary directory), then ``run_single`` with a
     410 MB f32 cache (~10% coverage, as 4096 MB is of 41 GB) and again
     with int8 lines: int8 transport, degree priorities and prewarm, K =
     32, 1 warm-up + 1 measured window; staged windows, no replay, loss
     finite and falling over the warm-up window from above 0, one f32
     launch per step; prints the record (the JAX script's keys, the card);
     the kernel on one staged step's frontier against its plain version,
     and the int8 kernel on a table of more than 2^31 elements;
 20. ``entry()``'s forward on the card against the port on the CPU (2e-3
     / 2e-4) and ``dryrun_multichip(1)`` on the card;
 21. data-parallel training on the host pipeline (``train.train_rank``,
     one process per rank, ``parallel/multihost.launch``) at the flagship
     widths with a 64 MB cache per rank, 4 warm-up + 16 measured steps:
     (1) the CLI's host SAGE in an NCCL process group of one rank, bitwise
     the one-card path (losses, cache state, hit counts, launches); (2)
     two ranks on the one card over gloo (its CUDA collectives stage
     through the host) in each cache mode: sharded, node_local over hosts
     of one rank (isolated's routing under the node_local name), isolated,
     and sharded with int8 lines; per rank: finite, falling losses, the
     launches of every measured step (2 forwards, 1 transpose, 1 grad_x),
     state on the card, the bytes handed to the all-to-alls equal to
     ``comm_model.step_traffic``'s count and the gradient all-reduce's
     payload; then 4 dropout-0 steps of each mode against the same two
     ranks on the CPU (2e-3 / 2e-4; they run at the same time); prints
     ms/step, edges/s per card, hit ratio, overflow slots and exchange
     bytes per step beside the backend and the card; gloo on one card
     checks correctness, it is no NCCL speed; (3) two ranks over NCCL on
     two cards where the machine has them, else a line saying why not;
 22. the resident pipeline over ranks (``train.train_rank`` with
     ``--pipeline resident``, ``ShardedResidentTrainer`` on a ``Mesh``) at
     the flagship widths with phase 6's 97 MB cache per rank (staged
     windows), ``--window 8``: (a) the CLI's resident SAGE in an NCCL
     process group of one rank with ``--shard_topology`` (a no-op there)
     bitwise the one-card run (losses, cache state, hit counts,
     launches) over the run's first step and 3 windows; (b) two ranks on
     the one card over gloo, sharded, node_local (hosts of one rank) and
     isolated, each with and without ``--shard_topology``, and sharded
     with the sharded topology and int8 lines: the run's first step and
     1 warm-up + 2 measured windows; per rank finite, falling losses, one
     f32 forward per measured step, no replay, staged windows with hits
     and misses, state on the card, the topology's collectives and a
     shard below the graph's edges exactly where the topology is sharded;
     each row's small run (600 nodes, fanout = max in-degree, dropout 0)
     against the same two ranks on the CPU, run beside them: losses
     within 2e-3 / 2e-4, hit counts, ledger bytes and eval equal; rank
     0's kernel on one real step's layer-0 input against its plain
     version, timed; prints ms/step, edges/s per card, hit ratio, stage
     rows and host-gather ms per window and rank, and the bytes leaving a
     rank per step by phase; (c) ``dryrun_multichip(2)`` on two gloo ranks
     on the card (its four legs and their checks); (d) ``reference_scale
     --mesh`` at two ranks, cut in scale (200k of its 10M nodes, 20 MB a
     rank; dim 1024 and the JAX leg's batch and windows kept): every edge
     on one rank, finite losses, hits and misses.

Every failure ends the script with a non-zero code. The line before the
last two is a JSON object with the kernels' launches, errors, times,
bounds and library times (phase 15's stacked shapes, phase 16's bf16
RGAT calls and phase 17's dedup step as entries of their own, named by
kernel, model and layer); the last line is ``{"ok": true, "device":
{...}}``. Writes coala_gnn_tpu_torch/_build/ (the kernels and the native
host library, built there at first use) and, in phases 17-19, a color
directory, checkpoints and the datasets (~6 GB) under ``tempfile``
directories that it removes (phase 22 a 0.8 GB graph).
Imports nothing of JAX or of coala_gnn_tpu.
"""

from __future__ import annotations

import concurrent.futures
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
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
BF16_RTOL, BF16_ATOL = 2e-2, 2e-2     # a bf16 model, card vs CPU, losses and
                                      # params: cuBLAS and the CPU sum a bf16
                                      # matmul in other orders, and a last-bit
                                      # f32 difference flips a bf16 rounding
                                      # (tests/test_torch_bf16.py's tolerance
                                      # against JAX)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM published peaks at 700 W: HBM3,
F32_OPS_PER_S = 67e12        # and f32 outside the tensor cores


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


def warm_up(torch, seconds: float = 1.0) -> None:
    """Keep the card busy for ``seconds`` before the first timing: after
    the idle build its clocks are low, and the first kernel timed read up
    to ~25% slow."""
    buf = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            buf.zero_()
        torch.cuda.synchronize()


def masked_slots(torch, S, N, F, gen):
    """Sampled-style adj and weights: ~20% of slots masked (w = 0) and
    pointed at row 0, as the sampler's padding is."""
    adj = torch.randint(0, S, (N, F), generator=gen, device="cuda",
                        dtype=torch.int32)
    live = torch.rand(N, F, generator=gen, device="cuda") < 0.8
    w = torch.where(live, torch.rand(N, F, generator=gen, device="cuda"),
                    torch.zeros(N, F, device="cuda"))
    return torch.where(live, adj, torch.zeros_like(adj)), w


#: the forward forms: (table dtype, read_as) by LAUNCHES name
FORMS = {"gather_spmm[float32]": ("float32", None),
         "gather_spmm[bfloat16]": ("bfloat16", None),
         "gather_spmm[int8]": ("int8", None),
         "gather_spmm[float32_as_bf16]": ("float32", "bfloat16"),
         "gather_spmm[int8_as_bf16]": ("int8", "bfloat16")}


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


def forward_work(torch, x, scale, adj, w) -> tuple:
    """(bytes, operations) the forward needs on these inputs: each distinct
    live row (w != 0, index in range) read once, with its scale for int8,
    adj and w read, the f32 output written; one multiply-add per live
    element (and the dequantising multiply for int8)."""
    s, d = x.shape
    live = (w != 0) & (adj >= 0) & (adj < s)
    rows = int(torch.unique(adj[live]).numel())
    nbytes = (rows * (d * x.element_size() + (4 if scale is not None else 0))
              + adj.numel() * 8 + adj.shape[0] * d * 4)
    return nbytes, int(live.sum()) * d * (3 if scale is not None else 2)


def grad_w_work(torch, x, adj, g) -> tuple:
    """grad_w reads every in-range slot's row (w == 0 included) once per
    distinct row, g and adj, and writes [N, F]."""
    rows = int(torch.unique(adj).numel())
    d = x.shape[1]
    return (rows * d * x.element_size() + g.numel() * 4 + adj.numel() * 8,
            2 * adj.numel() * d)


def grad_x_work(torch, adj, w, g, s) -> tuple:
    """grad_x over a transpose handed in: row_ptr, slot and w read, the g
    rows of live slots read once, every [S, D] row written once."""
    d = g.shape[1]
    g_rows = int((w != 0).any(dim=1).sum())
    nbytes = (s + 1) * 4 + adj.numel() * 8 + g_rows * d * 4 + s * d * 4
    return nbytes, 2 * int((w != 0).sum()) * d


def transpose_work(adj, s) -> tuple:
    """The transpose reads adj and writes row_ptr and slot."""
    return adj.numel() * 8 + (s + 1) * 4, 0


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of bytes over the
    HBM rate and operations over the f32 rate (published H100 SXM peaks)."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / F32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def timed(torch, entry: dict, kernel, plain, work: tuple,
          library=None) -> None:
    """Median ms of the kernel, its plain version and (where there is one)
    the library call into ``entry``, with the bound and its share."""
    entry["ms"] = median_ms(torch, kernel)
    entry["plain_ms"] = median_ms(torch, plain)
    entry.update(bound(*work))
    entry["share"] = entry["bound_ms"] / entry["ms"]
    entry["library_ms"] = None if library is None else median_ms(torch,
                                                                 library)


def describe(name: str, entry: dict) -> str:
    lib = entry["library_ms"]
    return (f"kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} "
            f"ms, bound {entry['bound_ms']:.4f} ms ({entry['bound_by']}, "
            f"share {entry['share']:.3f}), library "
            + ("none" if lib is None else f"{lib:.4f} ms") +
            " (median of 25, L2 flushed)")


def embedding_bag(torch, x, adj, w):
    """The one PyTorch call that computes the f32 forward's function."""
    return lambda: torch.nn.functional.embedding_bag(
        adj, x, per_sample_weights=w, mode="sum")


def host_packed_adj(torch, gen):
    """(adj, S) of the host-packed step's layer 1 at the flagship config
    (dedup layout: N 1,024 dst rows, F 5 slots into S 6,144 source rows,
    ~20% of slots masked, pointing at their own dst row, as
    ``sampling.neighbor`` pads them)."""
    from coala_gnn_tpu_torch.sampling.neighbor import block_capacities

    n, s = block_capacities(BATCH, FANOUTS)[1]
    f = FANOUTS[1]
    adj = torch.randint(0, s, (n, f), generator=gen, device="cuda",
                        dtype=torch.int32)
    own = torch.arange(n, device="cuda", dtype=torch.int32)[:, None]
    masked = torch.rand(n, f, generator=gen, device="cuda") < 0.2
    return torch.where(masked, own.expand(n, f), adj), s


def transpose_form(adj, s) -> str:
    """Which form the card's transpose takes for this shape (the C side's
    choice, by the shape and the card's capacity): one-block where it
    needs no scratch, else grid."""
    from coala_gnn_tpu_torch.ops.gather_spmm import transpose_scratch

    words = transpose_scratch(s, adj.numel(), adj.device)
    return "one-block" if words == 0 else "grid"


def rgat_stacked_adj(torch, gen, layer: int, device="cuda"):
    """(adj, S) of RGAT's stacked combine on the host CLI's step at the
    flagship config, layer 0 or 1: a typed block (3 relations, 4 heads),
    ~20% of slots masked and pointed at their own dst row, as the host
    sampler pads them, each relation's dead slots at their own dst row
    (``live_or_own``), stacked by ``head_stacked_adj``."""
    from coala_gnn_tpu_torch.models.layers import head_stacked_adj
    from coala_gnn_tpu_torch.ops.aggregate import live_or_own
    from coala_gnn_tpu_torch.sampling.neighbor import block_capacities

    rels = 3
    cap_dst, n_src = block_capacities(BATCH, FANOUTS)[layer]
    f = FANOUTS[layer]
    adj = torch.randint(0, n_src, (cap_dst, f), generator=gen,
                        device=device, dtype=torch.int32)
    own = torch.arange(cap_dst, device=device,
                       dtype=torch.int32)[:, None].expand(cap_dst, f)
    mask = torch.rand(cap_dst, f, generator=gen, device=device) >= 0.2
    adj = torch.where(mask, adj, own)
    rel = torch.randint(0, rels, (cap_dst, f), generator=gen, device=device)
    live = mask[None] & (rel[None] == torch.arange(rels, device=device)[
        :, None, None])
    stacked = head_stacked_adj(live_or_own(adj[None], live), n_src,
                               (cap_dst, f), HEADS, device, rels)
    return stacked, rels * n_src * HEADS


def gat_host_adj(torch, gen, padded: float = 0.06, device="cuda"):
    """(adj, S) of GAT layer 0's head-stacked combine on the host
    sampler's layout: the last ``padded`` share of the dst rows are
    padding, whose slots all name source row 0 (head-stacked rows 0-3);
    of the others ~20% of slots masked and pointed at their own dst row,
    the rest random source rows. ``padded=0`` is the same shape without
    the skew."""
    from coala_gnn_tpu_torch.models.layers import head_stacked_adj
    from coala_gnn_tpu_torch.sampling.neighbor import block_capacities

    cap_dst, n_src = block_capacities(BATCH, FANOUTS)[0]
    f = FANOUTS[0]
    adj = torch.randint(0, n_src, (cap_dst, f), generator=gen,
                        device=device, dtype=torch.int32)
    own = torch.arange(cap_dst, device=device,
                       dtype=torch.int32)[:, None].expand(cap_dst, f)
    adj = torch.where(torch.rand(cap_dst, f, generator=gen, device=device)
                      < 0.2, own, adj)
    adj[cap_dst - int(padded * cap_dst):] = 0
    return (head_stacked_adj(adj, n_src, (cap_dst, f), HEADS, device),
            n_src * HEADS)


def check_transpose(torch, adj, s, what: str) -> str:
    """The kernel's transpose equal bit for bit to its plain version;
    returns the form it took."""
    from coala_gnn_tpu_torch.ops.gather_spmm import (adj_transpose,
                                                     adj_transpose_reference)

    got, want = adj_transpose(adj, s), adj_transpose_reference(adj, s)
    require(bool(torch.equal(got[0], want[0]) and
                 torch.equal(got[1], want[1])),
            f"adj_transpose {what}: kernel differs from its plain version")
    return transpose_form(adj, s)


#: CUgraphNodeType values (cuda.h) -> names
GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "child graph", 5: "empty", 6: "event wait",
                    7: "event record", 10: "mem alloc", 11: "mem free"}


def capture(torch, fn) -> tuple:
    """(graph, what fn returned): one call of ``fn``, after a call outside
    it, captured in a CUDA graph that keeps its node list."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def graph_ops(graph) -> list:
    """The types of a captured graph's nodes, read through the driver API
    (cuGraphGetNodes, cuGraphNodeGetType)."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    require(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0,
            "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    require(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0,
            "cuGraphGetNodes failed")
    kinds = []
    for i in range(n.value):
        kind = ctypes.c_int(-1)
        require(cu.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]),
                                      ctypes.byref(kind)) == 0,
                "cuGraphNodeGetType failed")
        kinds.append(GRAPH_NODE_TYPES.get(kind.value, f"type {kind.value}"))
    return kinds


def device_ops(torch, fn) -> list:
    """The device operations (kernels, memsets, copies) that one call of
    ``fn`` enqueues: the nodes of a CUDA graph that captures the call, by
    type. torch.profiler gave the same counts in a fresh process, but in a
    long one its later sessions recorded no device events at all."""
    graph, _ = capture(torch, fn)
    ops = graph_ops(graph)
    graph.reset()
    return ops


def gat_combine_shapes():
    """(S, N, F, D, cap_src, cap_dst) of GAT's head-stacked combine on each
    layer at the flagship config: S = cap_src * heads rows of feat, N =
    cap_dst * heads dst rows, F = fanout, D = features per head."""
    from coala_gnn_tpu_torch.sampling.neighbor import block_capacities

    caps = block_capacities(BATCH, FANOUTS)
    feats = [HIDDEN, CLASSES]
    return [(src * HEADS, dst * HEADS, f, d, src, dst)
            for (dst, src), f, d in zip(caps, FANOUTS, feats)]


def ptxas_report() -> None:
    """Registers and spills of every kernel, from the build's -Xptxas -v
    log (demangled by c++filt where it is on PATH)."""
    import re
    import shutil

    from coala_gnn_tpu_torch.ops.gather_spmm import SOURCE
    from coala_gnn_tpu_torch.utils.build import library_path

    with open(library_path(SOURCE) + ".log") as fh:
        log = fh.read()
    names = re.findall(r"Compiling entry function '(\w+)'", log)
    used = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                        r"loads", log)
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               timeout=60).stdout.split("\n")
    for name, regs, (st, ld) in zip(names, used, spills):
        name = name.replace("(anonymous namespace)::", "")
        print(f"ptxas: {regs:>3} registers, spill {st}/{ld} B "
              f"(stores/loads): {name.split('(')[0].removeprefix('void ')}")


def phase_kernels(torch) -> dict:
    """Every kernel entry against its plain version; returns the kernels
    JSON entries (max_abs_err, ms, plain_ms, bound_ms, bound_by, share,
    library_ms) by name."""
    from coala_gnn_tpu_torch.models.layers import head_stacked_adj
    from coala_gnn_tpu_torch.ops.gather_spmm import (
        adj_transpose, adj_transpose_reference, gather_spmm,
        gather_spmm_grad_w, gather_spmm_grad_w_reference,
        gather_spmm_grad_x, gather_spmm_grad_x_reference,
        gather_spmm_grad_x_transposed_reference, gather_spmm_reference,
        grad_w_error_bound, grad_x_error_bound)

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (N_NODES + 1, 6 * BATCH, FANOUTS[0], DIM)
    res = {}
    warm_up(torch)
    floor = median_ms(torch, lambda: torch.zeros(1, device="cuda"))
    print(f"phase 2: timing floor, median_ms of a one-element fill: "
          f"{floor:.4f} ms")
    for name, (stored, read) in FORMS.items():
        dtype = getattr(torch, stored)
        read_as = None if read is None else getattr(torch, read)
        x, scale, adj, w = kernel_inputs(torch, *shape, dtype, gen)
        out = gather_spmm(x, adj, w, scale, read_as=read_as)
        ref = gather_spmm_reference(x, adj, w, scale, read_as)
        torch.cuda.synchronize()
        res[name] = {"max_abs_err": max_err(torch, out, ref,
                                            f"{name} {shape}")}
        timed(torch, res[name],
              lambda: gather_spmm(x, adj, w, scale, read_as=read_as),
              lambda: gather_spmm_reference(x, adj, w, scale, read_as),
              forward_work(torch, x, scale, adj, w),
              embedding_bag(torch, x, adj, w) if name ==
              "gather_spmm[float32]" else None)
        print(f"phase 2: {name} S,N,F,D={shape}: max_abs_err "
              f"{res[name]['max_abs_err']:.3g} (tol {KERNEL_TOL}), "
              + describe(name, res[name]))
        for S, N, F, D in [(50, 17, 10, 128), (3000, 500, 10, 100),
                           (3000, 500, 10, 16), (3000, 500, 10, 8),
                           (3000, 500, 10, 1), (24_576, 4096, 5, 16)]:
            x, scale, adj, w = kernel_inputs(torch, S, N, F, D, dtype, gen)
            out = gather_spmm(x, adj, w, scale, read_as=read_as)
            ref = gather_spmm_reference(x, adj, w, scale, read_as)
            torch.cuda.synchronize()
            err = max_err(torch, out, ref, f"{name} ({S},{N},{F},{D})")
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
            print(f"phase 2: {name} S,N,F,D=({S},{N},{F},{D}): max_abs_err "
                  f"{err:.3g}")
    ptxas_report()

    names = ("gather_spmm_grad_w", "gather_spmm_grad_x", "adj_transpose")
    for n in names + ("gather_spmm_grad_w[bfloat16]",):
        res[n] = {"max_abs_err": 0.0}
    for layer, (S, N, F, D, cap_src, cap_dst) in enumerate(
            gat_combine_shapes()):
        x = torch.randn(S, D, generator=gen, device="cuda")
        g = torch.randn(N, D, generator=gen, device="cuda")
        _, w = masked_slots(torch, S, N, F, gen)
        adj = head_stacked_adj(None, cap_src, (cap_dst, F), HEADS, "cuda")
        rand_adj = torch.randint(0, S, (N, F), generator=gen, device="cuda",
                                 dtype=torch.int32)
        adj_t = adj_transpose(adj, S)
        form = check_transpose(torch, adj, S, f"GAT layer {layer}")
        check_transpose(torch, rand_adj, S, f"GAT layer {layer}, random")
        gw = gather_spmm_grad_w(x, adj, g)
        err_w = within_bound(torch, gw, gather_spmm_grad_w_reference(
            x, adj, g), grad_w_error_bound(x, adj, g), "grad_w")
        require(bool((gw[w == 0] != 0).any()),
                "grad_w: zero-weight slots got no gradient")
        gx = gather_spmm_grad_x(adj, w, g, S, adj_t)
        require(bool(torch.equal(gx, gather_spmm_grad_x_reference(
            adj, w, g, S))), "grad_x: not exact on the head-stacked layout")
        gx = gather_spmm_grad_x(rand_adj, w, g, S)
        err_x = within_bound(torch, gx, gather_spmm_grad_x_reference(
            rand_adj, w, g, S), grad_x_error_bound(rand_adj, w, g, S),
            "grad_x, repeated rows")
        require(bool(torch.equal(gx, gather_spmm_grad_x_transposed_reference(
            adj_transpose_reference(rand_adj, S), w, g))),
            "grad_x, repeated rows: not the slot-order sums")
        torch.cuda.synchronize()
        times = {n: {} for n in names}
        timed(torch, times["gather_spmm_grad_w"],
              lambda: gather_spmm_grad_w(x, adj, g),
              lambda: gather_spmm_grad_w_reference(x, adj, g),
              grad_w_work(torch, x, adj, g))
        timed(torch, times["gather_spmm_grad_x"],
              lambda: gather_spmm_grad_x(adj, w, g, S, adj_t),
              lambda: gather_spmm_grad_x_reference(adj, w, g, S),
              grad_x_work(torch, adj, w, g, S))
        timed(torch, times["adj_transpose"], lambda: adj_transpose(adj, S),
              lambda: adj_transpose_reference(adj, S),
              transpose_work(adj, S))
        fwd = {}
        timed(torch, fwd, lambda: gather_spmm(x, adj, w),
              lambda: gather_spmm_reference(x, adj, w),
              forward_work(torch, x, None, adj, w),
              embedding_bag(torch, x, adj, w))
        for n, err in zip(names, (err_w, err_x, 0.0)):
            r = res[n]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if layer == 0:                    # the JSON line's shape
                r.update(times[n])
            print(f"phase 2: {n} GAT layer {layer} combine S,N,F,D="
                  f"({S},{N},{F},{D}): max_abs_err {err:.3g} "
                  + (f"({form} form, bitwise equal to the plain version) "
                     if n == "adj_transpose" else "")
                  + describe(n, times[n]))
        print(f"phase 2: gather_spmm[float32] GAT layer {layer} combine "
              f"S,N,F,D=({S},{N},{F},{D}): " + describe("forward", fwd))
        # a bf16 model's combine: the same shapes on a bf16 feat
        xb = x.to(torch.bfloat16)
        e_b = within_bound(torch, gather_spmm_grad_w(xb, adj, g),
                           gather_spmm_grad_w_reference(xb, adj, g),
                           grad_w_error_bound(xb, adj, g), "grad_w bf16")
        e_fb = max_err(torch, gather_spmm(xb, adj, w),
                       gather_spmm_reference(xb, adj, w), "bf16 combine")
        torch.cuda.synchronize()
        r = res["gather_spmm_grad_w[bfloat16]"]
        r["max_abs_err"] = max(r["max_abs_err"], e_b)
        t_wb, t_fb = {}, {}
        timed(torch, t_wb, lambda: gather_spmm_grad_w(xb, adj, g),
              lambda: gather_spmm_grad_w_reference(xb, adj, g),
              grad_w_work(torch, xb, adj, g))
        timed(torch, t_fb, lambda: gather_spmm(xb, adj, w),
              lambda: gather_spmm_reference(xb, adj, w),
              forward_work(torch, xb, None, adj, w))
        if layer == 0:
            r.update(t_wb)
        print(f"phase 2: gather_spmm_grad_w[bfloat16] GAT layer {layer} "
              f"combine S,N,F,D=({S},{N},{F},{D}): max_abs_err {e_b:.3g} "
              + describe("grad_w bf16", t_wb))
        print(f"phase 2: gather_spmm[bfloat16] GAT layer {layer} combine "
              f"S,N,F,D=({S},{N},{F},{D}): max_abs_err {e_fb:.3g} "
              + describe("forward bf16", t_fb))

    adj, S = host_packed_adj(torch, gen)
    form = check_transpose(torch, adj, S, "host-packed layer 1")
    require(form == "one-block", f"adj_transpose host-packed layer 1: "
            f"{form} form")
    t = {}
    timed(torch, t, lambda: adj_transpose(adj, S),
          lambda: adj_transpose_reference(adj, S), transpose_work(adj, S))
    print(f"phase 2: adj_transpose host-packed layer 1 S={S} "
          f"N*F={adj.numel()}: {form} form, bitwise equal to the plain "
          "version (its device operations per call: phase 10); "
          + describe("adj_transpose", t))
    shapes = phase_transposes(torch, gen) + [("host-packed layer 1", adj,
                                              S)]
    captured_transposes(torch, shapes)
    return res


def phase_transposes(torch, gen) -> list:
    """adj's transpose at the port's shapes above one block, each at full
    width: RGAT's stacked layers 0 and 1 on the host CLI's step (3
    relations, 4 heads, dead slots at their own row), GAT layer 0's
    contiguous head-stacked adj, and GAT layer 0 on the host sampler's
    layout with its padded rows' slots naming row 0 and without them.
    Each bitwise equal to its plain version, its form printed, timed
    against its bound. Returns (label, adj, S) for the CUDA-graph check,
    which phase 2 takes last."""
    from coala_gnn_tpu_torch.models.layers import head_stacked_adj
    from coala_gnn_tpu_torch.ops.gather_spmm import (adj_transpose,
                                                     adj_transpose_reference)

    *_, cap_src, cap_dst = gat_combine_shapes()[0]
    shapes = [("RGAT layer 0", *rgat_stacked_adj(torch, gen, 0)),
              ("RGAT layer 1", *rgat_stacked_adj(torch, gen, 1)),
              ("GAT layer 0 contiguous",
               head_stacked_adj(None, cap_src, (cap_dst, FANOUTS[0]), HEADS,
                                "cuda"), cap_src * HEADS),
              ("GAT layer 0 host layout, padded rows at row 0",
               *gat_host_adj(torch, gen)),
              ("GAT layer 0 host layout, no padded rows",
               *gat_host_adj(torch, gen, padded=0.0))]
    for label, adj, s in shapes:
        form = check_transpose(torch, adj, s, label)
        t = {}
        timed(torch, t, lambda: adj_transpose(adj, s),
              lambda: adj_transpose_reference(adj, s), transpose_work(adj, s))
        print(f"phase 2: adj_transpose {label} S={s} N*F={adj.numel()}: "
              f"{form} form, bitwise equal to the plain version; "
              + describe("adj_transpose", t))
    return shapes


def captured_transposes(torch, shapes) -> None:
    """One transpose call at each of phase 2's shapes captured in a CUDA
    graph: one node (one device operation) in either form, and the graph
    replayed twice, bitwise equal to the plain version."""
    from coala_gnn_tpu_torch.ops.gather_spmm import (adj_transpose,
                                                     adj_transpose_reference)

    for label, adj, s in shapes:
        graph, got = capture(torch, lambda: adj_transpose(adj, s))
        ops = graph_ops(graph)
        want = adj_transpose_reference(adj, s)
        for _ in range(2):
            got[1].fill_(-7)
            graph.replay()
            torch.cuda.synchronize()
            require(bool(torch.equal(got[0], want[0]) and
                         torch.equal(got[1], want[1])),
                    f"adj_transpose {label}: CUDA graph replay differs")
        graph.reset()
        print(f"phase 2: adj_transpose {label}: {transpose_form(adj, s)} "
              f"form, {len(ops)} device operation(s) per call {ops}; its "
              "CUDA graph replayed twice, bitwise equal to the plain version")
        require(len(ops) == 1, f"adj_transpose {label}: {len(ops)} device "
                "operations per call")


def make_trainer(torch, ds, store, dtype, device, dropout=0.5, lr=1e-3,
                 fanouts=FANOUTS, batch=BATCH, hidden=HIDDEN, cache_mb=1024,
                 model_type="sage", num_heads=HEADS, quantize=False,
                 sgd=False, model_dtype=None, **trainer_kw):
    """bench.py run_resident's trainer (cache lines of ``dtype``, a model
    computing in ``model_dtype``, f32 by default): every row prewarmed when
    the cache covers the graph, else (capacity pressure) the
    highest-degree nodes."""
    from coala_gnn_tpu_torch.cache import feature_cache as fc
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.parallel.resident import ResidentTrainer

    cfg = fc.make_config(cache_mb=cache_mb, dim=ds.feature_dim, dtype=dtype,
                         quantize=quantize)
    model = make_model(model_type, ds.feature_dim, hidden, ds.num_classes,
                       len(fanouts), num_heads=num_heads, dropout=dropout,
                       seed=1, dtype=model_dtype or torch.float32).to(device)
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
                      ds, label="phase 4", read_as=None) -> float:
    """The layer-0 neighbour sum on one real step's inputs (the flat table
    and its scales, the frontier's slot ids, the block mask), read as
    ``read_as``, against its plain version; returns the max abs error."""
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
    table, scale = rt.cache.data, rt.cache.scale
    out = gather_spmm(table, adj, mask, scale, read_as=read_as)
    ref = gather_spmm_reference(table, adj, mask, scale, read_as)
    torch.cuda.synchronize()
    err = max_err(torch, out, ref, f"{label}: one step's layer-0 inputs")
    print(f"{label}: kernel on a step's layer-0 inputs (table "
          f"{tuple(table.shape)} {table.dtype}, read as {read_as}, adj "
          f"{tuple(adj.shape)}): max_abs_err {err:.3g}")
    return err


def phase_small(torch, model_dtype=None, label="phase 5") -> None:
    """The port's small training runs on the card vs on the CPU (the CPU
    port is held against the JAX package by tests/test_torch_resident.py
    and, in bf16, tests/test_torch_bf16.py): SAGE with Adam, and GAT (2
    heads) with SGD, whose backward runs the grad_w and grad_x kernels.
    SGD because the softmax over the slots cancels the last layer's attn_r
    wherever its scores stay on one side of the leaky ReLU: that gradient
    is rounding noise, which Adam would turn into lr-sized steps of random
    sign. A bf16 model (``model_dtype``) trains both with SGD, on an f32
    table (layer 0 reads it as bf16), at the bf16 tolerances."""
    from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph

    bf16 = model_dtype == torch.bfloat16
    rtol, atol, p_rtol, p_atol = ((BF16_RTOL, BF16_ATOL) * 2 if bf16 else
                                  (SMALL_RTOL, SMALL_ATOL, SMALL_P_RTOL,
                                   SMALL_P_ATOL))
    grad_w = "gather_spmm_grad_w[bfloat16]" if bf16 else "gather_spmm_grad_w"
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
                              num_heads=2, sgd=bf16 or model_type == "gat",
                              model_dtype=model_dtype)
            reset_launches()
            losses, _ = rt.train_windows(grids, seed=7)
            out[device] = (losses.cpu().numpy(),
                           [p.detach().cpu().float().numpy()
                            for p in rt.model.parameters()], launches())
        card, host = out["cuda"], out["cpu"]
        np.testing.assert_allclose(card[0], host[0], rtol=rtol, atol=atol)
        for a, b in zip(card[1], host[1]):
            np.testing.assert_allclose(a, b, rtol=p_rtol, atol=p_atol)
        steps = grids.shape[0] * grids.shape[1]
        if model_type == "gat":
            require(card[2][grad_w] == 2 * steps and
                    card[2]["gather_spmm_grad_x"] == 2 * steps and
                    card[2]["adj_transpose"] == 2,
                    f"small GAT run: backward launches {card[2]}")
        print(f"{label}: small {model_type} run (250 nodes, {steps} steps, "
              f"model {model_dtype or torch.float32}) card vs CPU: losses "
              f"max diff {np.abs(card[0] - host[0]).max():.3g}, within rtol "
              f"{rtol} atol {atol}; params within rtol {p_rtol} atol "
              f"{p_atol}; card launches "
              f"{ {k: v for k, v in card[2].items() if v} }")


def phase_staged_step(torch, rt, ds, gather_spmm, gather_spmm_reference,
                      rng, batch=BATCH, label="phase 6") -> float:
    """The kernel on one staged step's real layer-0 inputs against the
    plain version: a window's probe and stage, step 0's cache lookup with
    the stage rows overlaid (the table), the slot positions (adj) and the
    step's mask, as ``ResidentTrainer._window`` hands them to the kernel.
    Also holds that table against the graph's features: every valid
    frontier row is its node's row, exactly with f32 lines and f32
    transport, within half a quantisation step with int8 lines or int8
    transport."""
    from coala_gnn_tpu_torch.ops.aggregate import frontier_adj
    from coala_gnn_tpu_torch.utils.rng import SAMPLE, step_generators

    seed = 14
    quantized = rt.cache_cfg.quantize or rt.stage_transport == "int8"
    require(rt.stage_transport == "int8" or not quantized and
            rt.stage_transport == "float32",
            f"{label}: staged check needs f32 or int8 transport (int8 with "
            f"int8 lines), not {rt.stage_transport}")
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
          f"{float(row_err.max()):.3g} "
          f"({'int8' if rt.cache_cfg.quantize else 'f32'} lines, "
          f"{rt.stage_transport} transport); kernel on a staged step's layer-0 inputs (frontier "
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


def phase_gat_step(torch, rt, ds, label="phase 8") -> dict:
    """The kernels on one real GAT step against their plain versions: the
    head-stacked feat, adjacency and attention each layer hands the
    forward kernel, and the upstream gradient its output receives.
    Returns max_abs_err by kernel name."""
    from coala_gnn_tpu_torch.models import layers
    from coala_gnn_tpu_torch.models.layers import TableInput
    from coala_gnn_tpu_torch.ops.gather_spmm import (
        adj_transpose_reference, gather_spmm_grad_w,
        gather_spmm_grad_w_reference, gather_spmm_grad_x,
        gather_spmm_grad_x_reference, gather_spmm_reference,
        grad_w_error_bound)
    from coala_gnn_tpu_torch.utils.rng import SAMPLE, step_generators

    seeds = torch.as_tensor(ds.train_idx[:BATCH].astype(np.int32),
                            device="cuda")
    gen = step_generators(30, 0, 1, SAMPLE, rt.device)[0]
    blocks, _, _, safe = rt._sample(seeds, gen)
    kernel, calls = layers.gather_spmm, []

    def recording(x, adj, w, scale=None, adj_t=None, read_as=None):
        out = kernel(x, adj, w, scale, adj_t=adj_t, read_as=read_as)
        rec = {"x": x.detach(), "adj": adj, "w": w.detach(), "scale": scale,
               "read_as": read_as, "adj_t": adj_t, "out": out.detach()}
        if out.requires_grad:
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
    bf16 = rt.model.dtype == torch.bfloat16
    fwd = "gather_spmm[bfloat16]" if bf16 else "gather_spmm[float32]"
    grad_w = "gather_spmm_grad_w[bfloat16]" if bf16 else "gather_spmm_grad_w"
    errs = {fwd: 0.0, grad_w: 0.0, "gather_spmm_grad_x": 0.0}
    require(len(calls) == 2 and all("g" in c for c in calls),
            "GAT step: expected two combines with upstream gradients")
    for layer, c in enumerate(calls):
        x, adj, w, g, adj_t = c["x"], c["adj"], c["w"], c["g"], c["adj_t"]
        s = x.shape[0]
        want_t = adj_transpose_reference(adj, s)
        require(adj_t is not None and torch.equal(adj_t[0], want_t[0]) and
                torch.equal(adj_t[1], want_t[1]), f"GAT layer {layer}: the "
                "kept transpose differs from the plain one")
        e_f = max_err(torch, c["out"], gather_spmm_reference(x, adj, w),
                      f"GAT layer {layer} forward")
        e_w = within_bound(torch, gather_spmm_grad_w(x, adj, g),
                           gather_spmm_grad_w_reference(x, adj, g),
                           grad_w_error_bound(x, adj, g),
                           f"GAT layer {layer} grad_w")
        gx = gather_spmm_grad_x(adj, w, g, s, adj_t)
        ref = gather_spmm_grad_x_reference(adj, w, g, s)
        require(bool(torch.equal(gx, ref)), f"GAT layer {layer} grad_x not "
                "exact (each feat row is read by one slot)")
        torch.cuda.synchronize()
        for name, e in zip((fwd, grad_w), (e_f, e_w)):
            errs[name] = max(errs[name], e)
        print(f"{label}: GAT layer {layer} real step: feat {tuple(x.shape)} "
              f"{x.dtype}, "
              f"adj {tuple(adj.shape)}, alpha zero slots "
              f"{int((w == 0).sum())}: forward max_abs_err {e_f:.3g}, grad_w "
              f"{e_w:.3g} (within bound), grad_x exact over the kept "
              "transpose")
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
    # one transpose per layer's combine shape, built at the run's first
    # step and kept: 6 launches per step, plus 2 in the run
    require(counts["adj_transpose"] == 2, f"GAT: {counts['adj_transpose']} "
            "transposes (one per layer)")
    require(sum(counts.values()) == 6 * steps + 2, f"GAT launches {counts}")
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
    from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
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


def phase_bf16(torch, ds, store, smi) -> tuple:
    """The bf16 model dtype's rows (phases 11-13): resident-bf16 (bench.py's
    row: SAGE, bf16 flat table at full coverage, bf16 model, K = 8, 1
    warm-up + 2 measured windows); a bf16 GAT at grid-gat-10x5's shapes on
    the f32 table (layer 0 gathers its frontier rows and rounds them to
    bf16, the combines and their backward run on bf16 feat), 1 + 1
    windows, then one window of a bf16 GCN on the f32 table (its layer-0
    sum reads the table as bf16); int8 lines on a bf16 flat table under a
    bf16 model (phase 9's 97 MB, which holds every row), 1 + 1 windows.
    Each: finite, falling losses, exact launch counts, its kernels on one
    real step's inputs against their plain versions. Returns (launches by
    kernel, kernel errors by name)."""
    from coala_gnn_tpu_torch.ops.gather_spmm import (gather_spmm,
                                                     gather_spmm_reference)

    bf16 = torch.bfloat16
    rng = np.random.default_rng(8)
    total, errs = {}, {}

    def tally(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def worst(found):
        for k, v in found.items():
            errs[k] = max(errs.get(k, 0.0), v)

    rt = make_trainer(torch, ds, store, bf16, "cuda", model_dtype=bf16)
    require(rt.direct and rt.full_coverage and rt.cache.data.dtype == bf16,
            "resident-bf16: not a bf16 flat table at full coverage")
    losses, edges, dt, counts, stats = run_row(torch, rt, ds, 1, 2, K,
                                               BATCH, 50, rng)
    steps = losses.size
    check_falling(losses, K, "resident-bf16")
    n = counts["gather_spmm[bfloat16]"]
    require(n == steps and sum(counts.values()) == n,
            f"resident-bf16: launches {counts} for {steps} steps")
    require(stats["misses"] == 0 and stats["hits"] > 0, f"bf16 {stats}")
    require(on_card(torch, rt), "resident-bf16 state off the card")
    report_row("phase 11: resident-bf16", losses, edges, dt, steps - K, smi)
    worst({"gather_spmm[bfloat16]": phase_step_inputs(
        torch, rt, gather_spmm, gather_spmm_reference, ds,
        label="phase 11", read_as=bf16)})
    tally(counts)
    del rt

    rt = make_trainer(torch, ds, store, torch.float32, "cuda",
                      model_type="gat", model_dtype=bf16)
    require(rt.direct and rt.full_coverage, "bf16 GAT: not at full coverage")
    losses, edges, dt, counts, stats = run_row(torch, rt, ds, 1, 1, K,
                                               BATCH, 52, rng)
    peak = torch.cuda.max_memory_allocated()
    steps = losses.size
    check_falling(losses, K, "bf16 GAT")
    want = {"gather_spmm[bfloat16]": 2 * steps,
            "gather_spmm_grad_w[bfloat16]": 2 * steps,
            "gather_spmm_grad_x": 2 * steps, "adj_transpose": 2}
    require({k: v for k, v in counts.items() if v} == want,
            f"bf16 GAT: launches {counts}, expected {want}")
    require(stats["misses"] == 0 and on_card(torch, rt), "bf16 GAT state")
    report_row("phase 12: bf16 GAT", losses, edges, dt, steps - K, smi)
    print(f"phase 12: bf16 GAT ({HEADS} heads x {HIDDEN}, f32 table) peak "
          f"device memory over the measured window {peak / 2**30:.3f} GiB; "
          f"launches per step {({k: v / steps for k, v in want.items()})} "
          "(the transposes once per run)")
    worst(phase_gat_step(torch, rt, ds, "phase 12"))
    tally(counts)
    del rt

    rt = make_trainer(torch, ds, store, torch.float32, "cuda",
                      model_type="gcn", model_dtype=bf16)
    grid = make_grids(ds, 1, K, BATCH, rng)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    lg, eg = rt.train_windows(grid, seed=53)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = only_launches("gather_spmm[float32_as_bf16]")
    lg = lg.cpu().numpy()
    require(np.isfinite(lg).all() and lg[-K // 2:].mean() < lg[:K // 2].mean(),
            f"bf16 GCN: losses not finite and falling {lg}")
    require(n == K, f"bf16 GCN: {n} f32-as-bf16 launches for {K} steps")
    report_row("phase 12: bf16 GCN on the f32 table (one window, warm-up "
               "included)", lg, float(eg.sum()), dt, K, smi)
    worst({"gather_spmm[float32_as_bf16]": phase_step_inputs(
        torch, rt, gather_spmm, gather_spmm_reference, ds,
        label="phase 12", read_as=bf16)})
    tally({"gather_spmm[float32_as_bf16]": n})
    del rt

    rt = make_trainer(torch, ds, store, bf16, "cuda", cache_mb=pressure_mb(ds),
                      quantize=True, model_dtype=bf16)
    require(rt.direct and rt.full_coverage and
            rt.cache.data.dtype == torch.int8 and
            rt.cache_cfg.dtype == bf16, "int8 lines on a bf16 flat table: "
            "not int8 lines of a bf16 config at full coverage")
    losses, edges, dt, counts, stats = run_row(torch, rt, ds, 1, 1, K,
                                               BATCH, 54, rng)
    steps = losses.size
    check_falling(losses, K, "int8 lines, bf16")
    n = counts["gather_spmm[int8_as_bf16]"]
    require(n == steps and sum(counts.values()) == n,
            f"int8 lines, bf16: launches {counts} for {steps} steps")
    report_row("phase 13: int8 lines on a bf16 flat table, bf16 model",
               losses, edges, dt, steps - K, smi)
    worst({"gather_spmm[int8_as_bf16]": phase_step_inputs(
        torch, rt, gather_spmm, gather_spmm_reference, ds,
        label="phase 13", read_as=bf16)})
    tally(counts)
    del rt
    return total, errs


HOST_ROWS = (  # tag, run_host arguments, warm-up steps, measured steps
    ("host-packed", dict(cache_mb=1024), 4, 16),
    ("host-packed-bf16", dict(cache_mb=1024, bf16=True), 4, 16),
    ("host-contig", dict(cache_mb=1024, contiguous=True), 4, 16),
    ("host-packed-pressure", dict(cache_mb=None, prewarm="degree"), 4, 16),
    ("host-uncached", dict(cache_mb=0), 2, 6))


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def host_side_ms(ds, batches: int = 8) -> dict:
    """The host sampler's (native) and the packer's ms per batch at the
    flagship config, each layout, timed alone on this thread."""
    from coala_gnn_tpu_torch.data.packing import (pack_request,
                                                  pack_request_contig)
    from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler

    out = {}
    for layout, contiguous in (("dedup", False), ("contig", True)):
        sampler = NeighborSampler(ds.graph, FANOUTS, BATCH, seed=0,
                                  contiguous=contiguous)
        t_sample = t_pack = 0.0
        for i in range(batches):
            seeds = ds.train_idx[i * BATCH:(i + 1) * BATCH]
            t0 = time.perf_counter()
            sb = sampler.sample(seeds)
            t1 = time.perf_counter()
            ids = sb.input_ids.astype(np.int32)
            labels = ds.labels[sb.seeds].astype(np.int32)
            if contiguous:
                pack_request_contig(ids, sb.num_input, labels)
            else:
                pack_request(ids, sb.num_input, [b.adj for b in sb.blocks],
                             [b.mask for b in sb.blocks], labels)
            t_sample += t1 - t0
            t_pack += time.perf_counter() - t1
        out[layout] = (1000 * t_sample / batches, 1000 * t_pack / batches)
    return out


def phase_host_step(torch, ds, device="cuda") -> dict:
    """The kernels on one real host-packed step's inputs against their
    plain versions: a sampled batch packed into its request buffer and
    unpacked on the device, its input rows, SAGE's forward (layer 0 on the
    features, layer 1 on layer 0's output) and backward; the forward at
    both layers and grad_x at layer 1 (the upstream gradient its output
    received; repeated rows, so within the f32 error bound). Returns
    max_abs_err by kernel name."""
    from coala_gnn_tpu_torch.data.packing import (batch_layout, pack_request,
                                                  unpack_request_batch)
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.ops import aggregate
    from coala_gnn_tpu_torch.ops.gather_spmm import (
        adj_transpose, adj_transpose_reference, gather_spmm_grad_x,
        gather_spmm_grad_x_reference, gather_spmm_reference,
        grad_x_error_bound)
    from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler

    sampler = NeighborSampler(ds.graph, FANOUTS, BATCH, seed=5)
    sb = sampler.sample(ds.train_idx[:BATCH])
    n_req = sampler.caps[0][1]
    vec = pack_request(sb.input_ids.astype(np.int32), sb.num_input,
                       [b.adj for b in sb.blocks], [b.mask for b in sb.blocks],
                       ds.labels[sb.seeds].astype(np.int32))
    buf = torch.from_numpy(vec).to(device)
    blocks, labels = unpack_request_batch(buf, n_req,
                                          batch_layout(sampler.caps, FANOUTS),
                                          BATCH)
    x = torch.from_numpy(ds.features[sb.input_ids]).to(device)
    model = make_model("sage", DIM, HIDDEN, CLASSES, len(FANOUTS), seed=1,
                       dropout=0.0).to(device)
    kernel, calls = aggregate.gather_spmm, []

    def recording(x, adj, w):
        out = kernel(x, adj, w)
        rec = {"x": x.detach(), "adj": adj, "w": w, "out": out.detach()}
        if out.requires_grad:
            out.register_hook(lambda g: rec.update(g=g.detach().contiguous()))
        calls.append(rec)
        return out

    aggregate.gather_spmm = recording
    try:
        logits = model(blocks, x, train=False)[:BATCH]
        torch.nn.functional.cross_entropy(logits, labels.long()).backward()
    finally:
        aggregate.gather_spmm = kernel
    require(len(calls) == 2 and "g" in calls[1] and "g" not in calls[0],
            "host-packed step: expected two forwards, a gradient at layer 1")
    errs = {"gather_spmm[float32]": 0.0, "gather_spmm_grad_x": 0.0}
    for layer, c in enumerate(calls):
        x, adj, w = c["x"], c["adj"], c["w"]
        e = max_err(torch, c["out"], gather_spmm_reference(x, adj, w),
                    f"host-packed layer {layer} forward")
        errs["gather_spmm[float32]"] = max(errs["gather_spmm[float32]"], e)
        t = {}
        timed(torch, t, lambda: kernel(x, adj, w),
              lambda: gather_spmm_reference(x, adj, w),
              forward_work(torch, x, None, adj, w), embedding_bag(torch, x,
                                                                  adj, w))
        print(f"phase 10: host-packed layer {layer} real step: x "
              f"{tuple(x.shape)}, adj {tuple(adj.shape)}, "
              f"{int((w == 0).sum())} masked slots: forward max_abs_err "
              f"{e:.3g}; " + describe("forward", t))
    c = calls[1]
    adj, w, g, s = c["adj"], c["w"], c["g"], c["x"].shape[0]
    e = within_bound(torch, gather_spmm_grad_x(adj, w, g, s),
                     gather_spmm_grad_x_reference(adj, w, g, s),
                     grad_x_error_bound(adj, w, g, s),
                     "host-packed layer 1 grad_x")
    sync(torch, device)
    errs["gather_spmm_grad_x"] = e
    form = check_transpose(torch, adj, s, "host-packed real step")
    adj_t = adj_transpose(adj, s)
    t_t, t_x = {}, {}
    timed(torch, t_t, lambda: adj_transpose(adj, s),
          lambda: adj_transpose_reference(adj, s), transpose_work(adj, s))
    timed(torch, t_x, lambda: gather_spmm_grad_x(adj, w, g, s, adj_t),
          lambda: gather_spmm_grad_x_reference(adj, w, g, s),
          grad_x_work(torch, adj, w, g, s))
    print(f"phase 10: host-packed layer 1 grad_x over [{s}, {HIDDEN}]: "
          f"max_abs_err {e:.3g} (within the f32 bound of its sums); "
          f"transpose ({form} form, bitwise equal to the plain version): "
          + describe("adj_transpose", t_t) + "; grad_x over it: "
          + describe("grad_x", t_x))
    ops = device_ops(torch, lambda: adj_transpose(adj, s))
    print(f"phase 10: host-packed layer 1 real step: adj_transpose issues "
          f"{len(ops)} device operation(s) per call: {ops}")
    require(form == "one-block" and len(ops) == 1,
            f"host-packed real step: transpose in {form} form, device "
            f"operations per call {ops}")
    return errs


def phase_host(torch, ds, smi, device="cuda") -> tuple:
    """bench.py's host rows through the port's run_host; returns (launches
    by kernel over the rows, kernel errors on a real host-packed step)."""
    from coala_gnn_tpu_torch.parallel.host_pipeline import run_host

    for layout, (ms_s, ms_p) in host_side_ms(ds).items():
        print(f"phase 10: host sampler (native, {layout} layout) "
              f"{ms_s:.2f} ms per batch, pack_request {ms_p:.2f} ms per "
              "batch (this thread, alone)")
    total = {}
    for tag, kw, warm, meas in HOST_ROWS:
        kw = dict(kw)
        if kw["cache_mb"] is None:
            kw["cache_mb"] = pressure_mb(ds)
        sync(torch, device)
        reset_launches()
        t0 = time.perf_counter()
        kw.setdefault("bf16", False)
        r = run_host(ds, BATCH, FANOUTS, DIM, HIDDEN, warmup=warm,
                     steps=meas, tag=tag, device=device, **kw)
        sync(torch, device)
        counts = launches()
        wall = time.perf_counter() - t0
        losses = np.asarray(r["losses"])
        q = max(losses.size // 4, 1)
        require(np.isfinite(losses).all() and
                losses[-q:].mean() < losses[:q].mean(),
                f"{tag}: losses not finite and falling {losses}")
        steps = warm + meas
        per_step = {k: v for k, v in r["launches_per_step"].items() if v}
        if kw.get("contiguous"):
            require(not any(counts.values()), f"{tag}: kernel launches "
                    f"{counts} on the slot-plane layout")
        else:
            n_fwd = counts["gather_spmm[float32]"]
            require(n_fwd >= 2 * steps and n_fwd % 2 == 0 and
                    counts["adj_transpose"] == n_fwd // 2 ==
                    counts["gather_spmm_grad_x"] and
                    sum(counts.values()) == 2 * n_fwd,
                    f"{tag}: launches {counts} for {steps} steps")
            require(n_fwd == 2 * steps or r["replays"] > 0,
                    f"{tag}: {n_fwd} forwards for {steps} steps, no replay")
        if tag == "host-packed-pressure":
            require(r["misses"] > 0 and r["hits"] > 0 and r["replays"] > 0,
                    f"{tag}: no misses, hits or replays ({r['hits']}, "
                    f"{r['misses']}, {r['replays']})")
        elif kw["cache_mb"]:
            require(r["misses"] == 0 and r["replays"] == 0,
                    f"{tag}: misses {r['misses']} or replays at full "
                    "coverage")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        some = losses[::max(losses.size // 10, 1)]
        print(f"phase 10: {tag}: {r['ms_per_step']:.3f} ms/step, "
              f"train_edges_per_s_per_chip {r['value']:.1f}, hit ratio "
              f"{r['cache_hit_ratio']}, replays {r['replays']}, launches per "
              f"measured step {per_step} ({meas} measured steps after "
              f"{warm}, host clock, {smi}); {wall:.1f} s with set-up; "
              f"losses {np.array2string(some, precision=4)}")
        print(f"phase 10: {tag}: main-thread host ms per measured step: "
              + ", ".join(f"{k} {1000 * v['total_s'] / meas:.3f}"
                          for k, v in sorted(r["timers"].items(),
                                             key=lambda kv: -kv[1]["total_s"])))
    return total, phase_host_step(torch, ds, device)


HETERO_KINDS = ("rsage", "rgcn", "rgat")
HETERO_WARM, HETERO_MEAS = 4, 16
#: kernel launches per step of a hetero model on the CLI's host path: RSAGE
#: and RGCN one stacked forward per layer, and layer 1's grad_x over one
#: transpose (layer 0's input needs no gradient); RGAT per layer one stacked
#: combine, its grad_w and grad_x, and one transpose
HETERO_PER_STEP = {
    "rsage": {"gather_spmm[float32]": 2, "adj_transpose": 1,
              "gather_spmm_grad_x": 1},
    "rgcn": {"gather_spmm[float32]": 2, "adj_transpose": 1,
             "gather_spmm_grad_x": 1},
    "rgat": {"gather_spmm[float32]": 2, "gather_spmm_grad_w": 2,
             "gather_spmm_grad_x": 2, "adj_transpose": 2}}
#: the CLI's hetero default on a synthetic graph (examples/train.py)
NUM_EDGE_TYPES = 3


def cli_args(kind: str, device: str = "cuda", **flags) -> list:
    """The trainer CLI's flags for ``kind`` at the flagship widths, a
    hetero model on ``NUM_EDGE_TYPES`` edge types (``flags`` override them,
    ``_`` for ``-``)."""
    base = dict(device=device, model_type=kind, num_nodes=N_NODES,
                feature_dim=DIM, hidden_channels=HIDDEN,
                num_classes=CLASSES, fan_out=",".join(map(str, FANOUTS)),
                batch_size=BATCH, cache_size=1024, num_heads=HEADS)
    if kind in HETERO_KINDS:
        base["num_edge_types"] = NUM_EDGE_TYPES
    base.update(flags)
    return [a for k, v in base.items() if v is not False
            for a in ((f"--{k}",) if v is True else (f"--{k}", str(v)))]


def record_calls(torch, run_step) -> list:
    """Every gather-SpMM call that ``run_step()`` (one real step's forward
    and the loss's backward) makes, with its inputs, output and upstream
    gradient, in call order (layer 0 first)."""
    from coala_gnn_tpu_torch.models import hetero, layers
    from coala_gnn_tpu_torch.ops import aggregate

    kernel, calls = aggregate.gather_spmm, []

    def recording(x, adj, w, scale=None, adj_t=None, read_as=None):
        out = kernel(x, adj, w, scale, adj_t=adj_t, read_as=read_as)
        rec = {"x": x.detach(), "adj": adj, "w": w.detach(), "scale": scale,
               "read_as": read_as, "x_grad": x.requires_grad,
               "w_grad": w.requires_grad, "out": out.detach()}
        if out.requires_grad:
            out.register_hook(lambda g: rec.update(g=g.detach().contiguous()))
        calls.append(rec)
        return out

    aggregate.gather_spmm = hetero.gather_spmm = layers.gather_spmm = \
        recording
    try:
        run_step()
    finally:
        aggregate.gather_spmm = hetero.gather_spmm = layers.gather_spmm = \
            kernel
    return calls


def hetero_step_calls(torch, run) -> list:
    """One real step of a hetero model on the CLI's path (a loader batch,
    its blocks and rows through the cache front, the model's forward and
    the loss's backward, no update): ``record_calls``."""
    from coala_gnn_tpu_torch.parallel.train import _squeeze

    batches = iter(run.loader)
    try:
        hb = next(batches)
    finally:
        batches.close()

    def step():
        logits = run.model(_squeeze(run.blocks(hb)), run.features(hb)[0],
                           train=False)[:BATCH]
        torch.nn.functional.cross_entropy(
            logits, run.put(hb.labels)[0].long()).backward()

    calls = record_calls(torch, step)
    run.optimizer.zero_grad(set_to_none=True)
    return calls


def step_kernels(torch, label, calls) -> dict:
    """Each kernel of one real step's gather-SpMM calls against its plain
    version (the forward at KERNEL_TOL, grad_w and grad_x within the f32
    bound of their sums, the transpose bitwise), timed with its plain
    version and bound; prints one line each under ``label``. Returns
    {(kernel counter, layer): entry}."""
    from coala_gnn_tpu_torch.ops.gather_spmm import (
        _GRAD_W_COUNTER, _form, adj_transpose, adj_transpose_reference,
        gather_spmm, gather_spmm_grad_w, gather_spmm_grad_w_reference,
        gather_spmm_grad_x, gather_spmm_grad_x_reference,
        gather_spmm_reference, grad_w_error_bound, grad_x_error_bound)

    out = {}
    for layer, c in enumerate(calls):
        x, adj, w, sc, ra = c["x"], c["adj"], c["w"], c["scale"], c["read_as"]
        s = x.shape[0]
        shape = f"S {s}, N {adj.shape[0]}, F {adj.shape[1]}, D {x.shape[1]}"
        name = f"gather_spmm[{_form(x, ra)}]"
        e = {"max_abs_err": max_err(torch, c["out"], gather_spmm_reference(
            x, adj, w, sc, ra), f"{label} layer {layer} forward")}
        f32_table = x.dtype == torch.float32 and sc is None and ra is None
        timed(torch, e, lambda: gather_spmm(x, adj, w, sc, read_as=ra),
              lambda: gather_spmm_reference(x, adj, w, sc, ra),
              forward_work(torch, x, sc, adj, w),
              embedding_bag(torch, x, adj, w) if f32_table else None)
        out[(name, layer)] = dict(e, shape=shape)
        if "g" not in c:
            continue
        g = c["g"]
        if c["x_grad"]:
            form = check_transpose(torch, adj, s, f"{label} layer {layer}")
            adj_t = adj_transpose(adj, s)
            e = {"max_abs_err": 0.0, "form": form}
            timed(torch, e, lambda: adj_transpose(adj, s),
                  lambda: adj_transpose_reference(adj, s),
                  transpose_work(adj, s))
            out[("adj_transpose", layer)] = dict(e, shape=shape)
            e = {"max_abs_err": within_bound(
                torch, gather_spmm_grad_x(adj, w, g, s, adj_t),
                gather_spmm_grad_x_reference(adj, w, g, s),
                grad_x_error_bound(adj, w, g, s),
                f"{label} layer {layer} grad_x")}
            timed(torch, e, lambda: gather_spmm_grad_x(adj, w, g, s, adj_t),
                  lambda: gather_spmm_grad_x_reference(adj, w, g, s),
                  grad_x_work(torch, adj, w, g, s))
            out[("gather_spmm_grad_x", layer)] = dict(e, shape=shape)
        if c["w_grad"]:
            e = {"max_abs_err": within_bound(
                torch, gather_spmm_grad_w(x, adj, g),
                gather_spmm_grad_w_reference(x, adj, g),
                grad_w_error_bound(x, adj, g),
                f"{label} layer {layer} grad_w")}
            timed(torch, e, lambda: gather_spmm_grad_w(x, adj, g),
                  lambda: gather_spmm_grad_w_reference(x, adj, g),
                  grad_w_work(torch, x, adj, g))
            out[(_GRAD_W_COUNTER[x.dtype], layer)] = dict(e, shape=shape)
    for (name, layer), e in out.items():
        print(f"{label} layer {layer} real step, {name} "
              f"({e['shape']}" + (f", {e['form']} form" if "form" in e
                                  else "") + f"): max_abs_err "
              f"{e['max_abs_err']:.3g}; " + describe(name, e))
    return out


def hetero_step_kernels(torch, kind, calls) -> dict:
    """``step_kernels`` of one real hetero step, which makes one stacked
    call per layer, with a gradient where the input needs one (RGAT's
    layer 0 too)."""
    rgat = kind == "rgat"
    require(len(calls) == 2 and "g" in calls[1] and
            ("g" in calls[0]) == rgat, f"{kind} step: expected one stacked "
            "call per layer, a gradient where the input needs one")
    return step_kernels(torch, f"phase 15: {kind}", calls)


def on_card_cli(torch, run) -> bool:
    """Params, optimizer state and cache state of a CLI run on the card."""
    st = run.cache.state.base
    return (st.data.is_cuda and st.tags.is_cuda and all(
        p.is_cuda for p in run.model.parameters()) and all(
        t.is_cuda for o in run.optimizer.state.values() for t in o.values()
        if torch.is_tensor(t) and t.dim() > 0))


def hetero_small(torch, smi) -> None:
    """Small runs of the CLI's loop, card vs CPU (the CPU port is held to
    JAX by tests/test_torch_hetero.py): each hetero model in f32 and a bf16
    RSAGE and RGAT, dropout 0, 12 steps on a 600-node graph with a 1 MB
    cache. RGAT and the bf16 models train with SGD (phase 5's reason: the
    last layer's attn_r gradient is rounding noise that Adam would turn
    into random steps)."""
    from coala_gnn_tpu_torch import train as cli

    small = dict(num_nodes=600, feature_dim=8, hidden_channels=8,
                 num_classes=4, fan_out="4,3", batch_size=16, cache_size=1,
                 num_heads=2, learning_rate=0.01, avg_degree=4)
    for kind, dtype in [(k, "float32") for k in HETERO_KINDS] + [
            ("rsage", "bfloat16"), ("rgat", "bfloat16")]:
        bf16 = dtype == "bfloat16"
        sgd = bf16 or kind == "rgat"
        rtol, atol = (BF16_RTOL, BF16_ATOL) if bf16 else (SMALL_RTOL,
                                                          SMALL_ATOL)
        out = {}
        for device in ("cuda", "cpu"):
            args = cli.parse_args(cli_args(kind, device, dtype=dtype,
                                                  **small))
            run = cli.build(args)
            run.model.dropout = 0.0
            if sgd:
                run.optimizer = torch.optim.SGD(run.model.parameters(),
                                                lr=0.01)
            reset_launches()
            out[device] = (cli.train(run, epochs=1, max_steps=12)["losses"],
                           launches())
        card, host = out["cuda"], out["cpu"]
        np.testing.assert_allclose(card[0], host[0], rtol=rtol, atol=atol)
        require(card[1]["adj_transpose"] == 12 * (2 if kind == "rgat" else 1)
                and not any(host[1].values()),
                f"small {kind} {dtype}: launches card {card[1]}, "
                f"CPU {host[1]}")
        print(f"phase 15: small {kind} {dtype} run (600 nodes, 12 steps, "
              f"{'SGD' if sgd else 'Adam'}) card vs CPU: losses max diff "
              f"{np.abs(card[0] - host[0]).max():.3g}, within rtol {rtol} "
              f"atol {atol}; card launches "
              f"{ {k: v for k, v in card[1].items() if v} } ({smi})")


def phase_hetero(torch, ds, smi) -> tuple:
    """The hetero models through the trainer CLI's own code
    (``train.build`` / ``train.train``): RSAGE, RGCN and RGAT (4 heads) at
    the flagship widths, 3 random edge types drawn as the CLI draws them,
    the 1024 MB one-device cache front, dropout 0.5, Adam 1e-3; 4 warm-up
    + 16 measured steps each. Checks finite, falling losses, the launches
    of every measured step (``HETERO_PER_STEP``, nothing else), state on
    the card; prints ms/step (the CLI's epoch time over its steps), train
    edges/s, peak device memory; holds every stacked entry against its
    plain version on one real step; then the small card-vs-CPU runs.
    Returns (launches by kernel, kernels JSON entries of the stacked
    shapes)."""
    from coala_gnn_tpu_torch import train as cli

    total, entries = {}, []
    for kind in HETERO_KINDS:
        args = cli.parse_args(cli_args(kind))
        cli.refuse_unported(args)
        t0 = time.perf_counter()
        run = cli.build(args, ds=ds)
        torch.cuda.synchronize()
        reset_launches()
        warm = cli.train(run, epochs=1, max_steps=HETERO_WARM)
        torch.cuda.synchronize()
        warm_counts = launches()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        meas = cli.train(run, epochs=1, max_steps=HETERO_MEAS)
        torch.cuda.synchronize()
        counts = launches()
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = np.concatenate([warm["losses"], meas["losses"]])
        q = losses.size // 4
        require(np.isfinite(losses).all() and
                losses[-q:].mean() < losses[:q].mean(),
                f"{kind}: losses not finite and falling {losses}")
        want = {k: v * HETERO_MEAS for k, v in HETERO_PER_STEP[kind].items()}
        got = {k: v for k, v in counts.items() if v}
        require(got == want, f"{kind}: launches {got} over {HETERO_MEAS} "
                f"measured steps, expected {want}")
        require(on_card_cli(torch, run), f"{kind}: state off the card")
        for c in (warm_counts, counts):
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
        dt = meas["epoch_s"][0]
        print(f"phase 15: {kind} (CLI, {NUM_EDGE_TYPES} edge types): "
              f"{1000 * dt / HETERO_MEAS:.3f} ms/step, "
              f"train_edges_per_s_per_chip {meas['edges'] / dt:.1f} "
              f"({HETERO_MEAS} measured steps after {HETERO_WARM}, host "
              f"clock, {smi}), of which the cache front's fetch "
              f"{1000 * meas['agg_s'][0] / HETERO_MEAS:.3f} ms/step; peak "
              f"device memory {peak:.3f} GiB; "
              f"launches per measured step "
              f"{ {k: v // HETERO_MEAS for k, v in got.items()} }; "
              f"{time.perf_counter() - t0:.1f} s with set-up; losses "
              f"{np.array2string(losses[::2], precision=4)}")
        for (name, layer), e in hetero_step_kernels(
                torch, kind, hetero_step_calls(torch, run)).items():
            entries.append({"name": f"{name} {kind} layer {layer} stacked",
                            "counter": name,
                            "launches": counts[name] // (
                                2 if name == "gather_spmm[float32]" or
                                kind == "rgat" else 1),
                            **{k: v for k, v in e.items() if k != "form"}})
        del run
        torch.cuda.empty_cache()
    hetero_small(torch, smi)
    return total, entries


#: phase 16's rows: (tag, model, --cache_size MB, --window, --dtype)
RESIDENT_ROWS = (("sage-1024-w8", "sage", 1024, 8, "float32"),
                 ("sage-1024-w1", "sage", 1024, 1, "float32"),
                 ("sage-97-w8", "sage", 97, 8, "float32"),
                 ("gat-1024-w8", "gat", 1024, 8, "float32"),
                 ("rgat-1024-w8", "rgat", 1024, 8, "float32"),
                 ("rgat-bf16-1024-w8", "rgat", 1024, 8, "bfloat16"))
RESIDENT_WARM, RESIDENT_MEAS = 4, 16
#: kernel launches per measured step of the resident CLI: SAGE's layer 0
#: reads the step's frontier through the kernel (TableInput; layer 1 is
#: plane sums); GAT and RGAT per layer a combine, its grad_w and grad_x,
#: their transposes kept per shape since the run's first step
_ATTENTION = {"gather_spmm[float32]": 2, "gather_spmm_grad_w": 2,
              "gather_spmm_grad_x": 2}
RESIDENT_PER_STEP = {
    "sage": {"gather_spmm[float32]": 1}, "gat": _ATTENTION,
    "rgat": _ATTENTION,
    "rgat-bf16": {"gather_spmm[bfloat16]": 2,
                  "gather_spmm_grad_w[bfloat16]": 2,
                  "gather_spmm_grad_x": 2}}

#: kernel launches per step where the blocks carry a local adj (the
#: ``dedup=True`` per-step path and the host CLI's dedup layout), read off
#: the code before the first card run: both layers' neighbour sums through
#: the kernel on the block's adj, and layer 1's backward, its adj's
#: transpose and grad_x into layer 0's output (layer 0's input, the
#: features, takes no gradient, and the mask none either)
ADJ_SAGE_PER_STEP = {"gather_spmm[float32]": 2, "adj_transpose": 1,
                     "gather_spmm_grad_x": 1}


def resident_step_calls(torch, run) -> list:
    """One real step of the resident CLI (this rank's slice of the
    scheduler's next seed grid through the trainer's ``begin`` /
    ``resolve``, collective over the ranks, the model's forward on the
    frontier as the trainer hands it over and the loss's backward, no
    update): ``record_calls``."""
    from coala_gnn_tpu_torch.utils.rng import SAMPLE, step_generators

    from coala_gnn_tpu_torch import train as cli

    rt = run.trainer
    grid = cli.rank_grid(run.scheduler, BATCH)[0]
    gen = step_generators(run.args.seed, run.step, 1, SAMPLE, run.device,
                          run.mesh.rank)[0]
    blocks, feats, y = rt.resolve(rt.begin(grid, gen))

    def step():
        logits = run.model(blocks, rt._layer0(feats), train=False)[:BATCH]
        torch.nn.functional.cross_entropy(logits, y).backward()

    calls = record_calls(torch, step)
    run.optimizer.zero_grad(set_to_none=True)
    return calls


def resident_small(torch, smi) -> None:
    """Small runs of the resident CLI, card vs CPU (the CPU port is held
    to JAX's ``_run_resident`` by tests/test_torch_cli_resident.py), 12
    steps in windows of 4 with eval, dropout 0, fanout = the graph's max
    in-degree (so both sample every in-edge, whatever their generators
    draw): SAGE on 512-wide rows, whose 1 MB cache evicts, with Adam; GAT
    and RGAT in f32 and RGAT in bf16 on 8-wide rows with SGD (phase 5's
    reason)."""
    from coala_gnn_tpu_torch import train as cli
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph

    fanout = int(synthetic_graph(num_nodes=600, avg_degree=4, feature_dim=8,
                                 num_classes=4, seed=0
                                 ).graph.in_degrees().max())
    small = dict(num_nodes=600, hidden_channels=8, num_classes=4,
                 fan_out=f"{fanout},{fanout}", batch_size=16, cache_size=1,
                 num_heads=2, learning_rate=0.01, avg_degree=4,
                 pipeline="resident", window=4)
    for kind, dtype, dim in (("sage", "float32", 512),
                             ("gat", "float32", 8), ("rgat", "float32", 8),
                             ("rgat", "bfloat16", 8)):
        bf16, sgd = dtype == "bfloat16", kind != "sage"
        rtol, atol = (BF16_RTOL, BF16_ATOL) if bf16 else (SMALL_RTOL,
                                                          SMALL_ATOL)
        out = {}
        for device in ("cuda", "cpu"):
            run = cli.build(cli.parse_args(cli_args(
                kind, device, dtype=dtype, feature_dim=dim, **small)))
            run.model.dropout = 0.0
            if sgd:
                run.optimizer = torch.optim.SGD(run.model.parameters(),
                                                lr=0.01)
            reset_launches()
            losses = cli.train(run, epochs=1, max_steps=12)["losses"]
            out[device] = (losses, cli.evaluate(run), launches())
        card, host = out["cuda"], out["cpu"]
        np.testing.assert_allclose(card[0], host[0], rtol=rtol, atol=atol)
        require(any(card[2].values()) and not any(host[2].values()),
                f"small resident {kind} {dtype}: launches card {card[2]}, "
                f"CPU {host[2]}")
        print(f"phase 16: small resident {kind} {dtype} (600 nodes, dim "
              f"{dim}, 12 steps, {'SGD' if sgd else 'Adam'}) card vs CPU: "
              f"losses max diff {np.abs(card[0] - host[0]).max():.3g}, "
              f"within rtol {rtol} atol {atol}; eval correct card "
              f"{card[1][0]} CPU {host[1][0]} of {host[1][1]} ({smi})")


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def cli_row(torch, ds, smi, label, tag, kind, per_step, on_build=None,
            **flags) -> tuple:
    """One row of the trainer CLI (``train.build`` / ``train.train``) for
    ``kind`` at the flagship widths: the cache cold at the start, 4
    warm-up + 16 measured steps. Checks finite, falling losses, the
    launches of every measured step (``per_step``, nothing else), state on
    the card, and on the resident pipeline no replay; prints ms/step,
    edges/s, feature agg ms/step and, on the resident pipeline, hit
    ratio, stage rows, peak memory and the trainer's timers, under
    ``label``. ``flags`` are more CLI flags; ``on_build(run)`` runs after
    ``build``. Returns (launches by kernel of the row, the run, its
    ms/step)."""
    from coala_gnn_tpu_torch import train as cli

    args = cli.parse_args(cli_args(kind, **flags))
    cli.refuse_unported(args)
    t0 = time.perf_counter()
    run = cli.build(args, ds=ds)
    if on_build is not None:
        on_build(run)
    rt = run.trainer
    torch.cuda.synchronize()
    reset_launches()
    warm = cli.train(run, epochs=1, max_steps=RESIDENT_WARM)
    torch.cuda.synchronize()
    row_counts = launches()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    if rt is not None:
        rt.timers.reset()
    meas = cli.train(run, epochs=1, max_steps=RESIDENT_MEAS)
    torch.cuda.synchronize()
    counts = launches()
    add_counts(row_counts, counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = np.concatenate([warm["losses"], meas["losses"]])
    q = losses.size // 4
    require(np.isfinite(losses).all() and
            losses[-q:].mean() < losses[:q].mean(),
            f"{tag}: losses not finite and falling {losses}")
    want = {k: v * RESIDENT_MEAS for k, v in per_step.items()}
    got = {k: v for k, v in counts.items() if v}
    require(got == want, f"{tag}: launches {got} over {RESIDENT_MEAS} "
            f"measured steps, expected {want}")
    require(on_card_cli(torch, run) and
            (rt is None or rt.g.indices.is_cuda), f"{tag}: state off the card")
    dt = meas["epoch_s"][0]
    ms = 1000 * dt / RESIDENT_MEAS
    resident = ""
    if rt is not None:
        require("replay" not in rt.timers.totals, f"{tag}: replayed")
        st = meas["stats"][0]
        resident = (f"; hit ratio {st['hit_ratio']:.4f} ({st['hits']} hits "
                    f"/ {st['misses']} misses); stage rows "
                    f"{rt.timers.tallies.get('stage_rows', 0):.0f} in the "
                    f"measured steps; peak device memory {peak:.3f} GiB")
    given = " ".join(f"--{k} {v}" for k, v in flags.items()) or "defaults"
    print(f"{label}: {tag} (CLI {given}): {ms:.3f} ms/step, "
          f"train_edges_per_s_per_chip {meas['edges'] / dt:.1f} "
          f"({RESIDENT_MEAS} measured steps after {RESIDENT_WARM}, host "
          f"clock, {smi}); feature agg "
          f"{1000 * meas['agg_s'][0] / RESIDENT_MEAS:.3f} ms/step{resident}; "
          f"launches per measured step "
          f"{ {k: v // RESIDENT_MEAS for k, v in got.items()} }; "
          f"{time.perf_counter() - t0:.1f} s with set-up; losses "
          f"{np.array2string(losses[::2], precision=4)}")
    if rt is not None:
        print(f"{label}: {tag} trainer timers of the measured steps:\n"
              + rt.timers.report())
    return row_counts, run, ms


def phase_resident(torch, ds, smi) -> tuple:
    """The trainer CLI's ``--pipeline resident`` (``train.build`` /
    ``train.train`` / ``train.evaluate`` over ``ShardedResidentTrainer``)
    at the flagship widths, one row per ``RESIDENT_ROWS`` entry
    (``cli_row``: the cache cold at the start, dropout 0.5, Adam 1e-3,
    4 warm-up + 16 measured steps); the eval after the ``--window 1``
    row (one forward per eval batch); a host-CLI SAGE row in the same
    call, beside it. Holds every kernel call of one real step of each row
    against its plain version; then the small card-vs-CPU runs. Returns
    (launches by kernel, worst errors of the f32 entries, kernels JSON
    entries of the bf16 RGAT row)."""
    from coala_gnn_tpu_torch import train as cli

    total, errs, entries, ms = {}, {}, [], {}
    for tag, kind, mb, window, dtype in RESIDENT_ROWS:
        key = kind + ("-bf16" if dtype == "bfloat16" else "")
        row_counts, run, ms[tag] = cli_row(
            torch, ds, smi, "phase 16", tag, kind, RESIDENT_PER_STEP[key],
            pipeline="resident", cache_size=mb, window=window, dtype=dtype)
        add_counts(total, row_counts)
        if window == 1:
            reset_launches()
            t1 = time.perf_counter()
            correct, n_test = cli.evaluate(run)
            torch.cuda.synchronize()
            counts = launches()
            add_counts(total, counts)
            n_batches = -(-n_test // BATCH)
            got = {k: v for k, v in counts.items() if v}
            require(got == {"gather_spmm[float32]": n_batches},
                    f"{tag} eval: launches {got}, expected one forward per "
                    f"batch ({n_batches})")
            print(f"phase 16: {tag} --eval: {correct} of {n_test} test "
                  f"nodes correct in {n_batches} batches, "
                  f"{1000 * (time.perf_counter() - t1) / n_batches:.3f} "
                  f"ms/batch ({smi})")
        checked = step_kernels(torch, f"phase 16: {tag}",
                               resident_step_calls(torch, run))
        for (name, layer), e in checked.items():
            if dtype == "bfloat16":
                # the row's launches of this layer's call
                calls = sum(1 for n, _ in checked if n == name)
                entries.append({
                    "name": f"{name} {kind} bf16 resident layer {layer}",
                    "counter": name, "launches": row_counts[name] // calls,
                    **{k: v for k, v in e.items() if k != "form"}})
            else:
                errs[name] = max(errs.get(name, 0.0), e["max_abs_err"])
        del run
        torch.cuda.empty_cache()
    # the CLI's host path, SAGE, in the same call
    counts, run, ms["host-sage"] = cli_row(
        torch, ds, smi, "phase 16", "host-sage", "sage", ADJ_SAGE_PER_STEP)
    add_counts(total, counts)
    print(f"phase 16: resident --window 8 / host "
          f"{ms['sage-1024-w8'] / ms['host-sage']:.3f}, --window 1 / host "
          f"{ms['sage-1024-w1'] / ms['host-sage']:.3f} ({smi})")
    del run
    torch.cuda.empty_cache()
    resident_small(torch, smi)
    return total, errs, entries


#: phase 17: the padded table's slots per node (examples/flagship_tune.py's
#: P), the dedup=True per-step steps, the CLI's 4 + 16 steps
NBR_CAP = 32
DEDUP_WARM, DEDUP_MEAS = 2, 8


def phase_nbr_table(torch, ds, store, smi) -> int:
    """17.1: ``ResidentTrainer(nbr_cap=NBR_CAP)`` at the flagship config,
    in turns with phase 3's CSR trainer on the same seeds (warm-up windows,
    then csr, table, table, csr). Checks the table sampler on the card
    against the CSR one given the same uniforms (bitwise where deg <= P,
    inside the stored subset above), finite, falling losses and one f32
    launch per step. Returns the table trainer's launches."""
    from coala_gnn_tpu_torch.sampling.device_sampler import (
        _sample_layer, sample_blocks_device)

    rng = np.random.default_rng(17)
    t0 = time.perf_counter()
    tab = make_trainer(torch, ds, store, torch.float32, "cuda",
                       nbr_cap=NBR_CAP)
    t_tab = time.perf_counter() - t0
    csr = make_trainer(torch, ds, store, torch.float32, "cuda")
    g = tab.g
    mb = sum(t.numel() * t.element_size() for t in
             (g.nbr_table, g.nbr_deg) if t is not None) / 1e6
    require(g.nbr_table.is_cuda and g.rel_table is None,
            "the padded table is not on the card")

    # the table sampler vs the CSR sampler, same uniforms, on the card:
    # layer 0's dst rows of a real step and every node of degree > P
    seeds = torch.as_tensor(ds.train_idx[:BATCH].astype(np.int32),
                            device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    _, ids, _ = sample_blocks_device(csr.g, seeds, FANOUTS, BATCH, gen)
    deg_all = np.diff(np.asarray(ds.graph.indptr))
    hubs = torch.as_tensor(np.flatnonzero(deg_all > NBR_CAP).astype(
        np.int32), device="cuda")
    dst = torch.cat([ids[:BATCH * (1 + FANOUTS[1])], hubs])
    u = torch.rand(dst.shape[0], FANOUTS[0], generator=gen, device="cuda")
    n_c, m_c, _ = _sample_layer(csr.g, dst, FANOUTS[0], uniforms=u)
    n_t, m_t, _ = _sample_layer(g, dst, FANOUTS[0], uniforms=u)
    deg = csr.g.indptr[dst.long() + 1] - csr.g.indptr[dst.long()]
    small = deg <= NBR_CAP
    require(bool(torch.equal(n_c[small], n_t[small]) and
                 torch.equal(m_c[small], m_t[small])),
            "table sampler differs from CSR on a node of degree <= P")
    big = ~small
    stored = g.nbr_table[dst[big].long()]
    inside = (n_t[big][:, :, None] == stored[:, None, :]).any(-1)
    require(bool(inside.all()) and bool((m_t[big] == 1).all()),
            "table sampler left a node's stored subset")
    print(f"phase 17: padded table P={NBR_CAP}: {tuple(g.nbr_table.shape)} "
          f"int32 + degrees = {mb:.1f} MB on the card, built in "
          f"{t_tab:.1f} s with the trainer; sampler on the card given the "
          f"CSR sampler's uniforms: {int(small.sum())} dst rows of degree "
          f"<= {NBR_CAP} bitwise equal, {int(big.sum())} rows of degree > "
          f"{NBR_CAP} all inside their stored subset")

    warm = make_grids(ds, 1, K, BATCH, rng)
    meas = make_grids(ds, 2, K, BATCH, rng)
    ms = {"csr": [], "table": []}
    losses, n_launch = [], 0

    def window(rt, grid, w, name, timed_run):
        nonlocal n_launch
        torch.cuda.synchronize()
        if name == "table":
            reset_launches()
        t0 = time.perf_counter()
        out, _ = rt.train_windows(grid[None], seed=7, first_window=w)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if name == "table":
            n_launch += only_launches("gather_spmm[float32]")
            losses.append(out.cpu().numpy())
        if timed_run:
            ms[name].append(1000 * dt / K)

    window(csr, warm[0], 0, "csr", False)
    window(tab, warm[0], 0, "table", False)
    for w, name in ((0, "csr"), (0, "table"), (1, "table"), (1, "csr")):
        rt = tab if name == "table" else csr
        window(rt, meas[w], 1 + w, name, True)
    losses = np.concatenate(losses)
    require(np.isfinite(losses).all() and
            losses[-K:].mean() < losses[:K].mean(),
            f"nbr_cap windows: losses not finite and falling {losses}")
    require(n_launch == 3 * K, f"nbr_cap windows: {n_launch} launches for "
            f"{3 * K} steps")
    require(on_card(torch, tab), "nbr_cap trainer: state off the card")
    print(f"phase 17: ResidentTrainer nbr_cap={NBR_CAP} (flat f32 table, "
          f"K = {K}, 1 warm-up + 2 measured windows in turns with the CSR "
          f"trainer): table {np.mean(ms['table']):.3f} ms/step (windows "
          f"{', '.join(f'{v:.3f}' for v in ms['table'])}), CSR "
          f"{np.mean(ms['csr']):.3f} ms/step (windows "
          f"{', '.join(f'{v:.3f}' for v in ms['csr'])}); {n_launch} f32 "
          f"launches for {3 * K} steps; losses "
          f"{np.array2string(losses[::2], precision=4)} ({smi})")
    del tab, csr
    torch.cuda.empty_cache()
    return n_launch


def phase_dedup(torch, ds, store, smi) -> tuple:
    """17.2: ``ResidentTrainer(dedup=True)`` at the flagship config, full
    coverage, ``DEDUP_WARM`` + ``DEDUP_MEAS`` per-step steps (``begin`` /
    ``resolve`` / ``train_step``). Checks the card's dedup of one real
    layer-0 ``cat`` bitwise against the CPU's, finite, falling losses, the
    launches of every measured step (``ADJ_SAGE_PER_STEP``, nothing else)
    and every kernel call of one real step against its plain version.
    Returns (launches by kernel, kernels JSON entries of the step)."""
    from coala_gnn_tpu_torch.sampling.device_sampler import (
        _dedup_first_occurrence, _sample_layer, sample_blocks_device)
    from coala_gnn_tpu_torch.sampling.neighbor import block_capacities
    from coala_gnn_tpu_torch.utils.rng import DROPOUT, SAMPLE, \
        step_generators

    rt = make_trainer(torch, ds, store, torch.float32, "cuda", dedup=True)
    sentinel = rt.g.num_nodes
    cap_dst0 = block_capacities(BATCH, FANOUTS)[0][0]

    # one real layer-0 cat: layer 1 sampled and deduplicated, then layer 0
    gen = torch.Generator(device="cuda").manual_seed(9)
    seeds = torch.as_tensor(ds.train_idx[:BATCH].astype(np.int32),
                            device="cuda")
    nbr1, _, _ = _sample_layer(rt.g, seeds, FANOUTS[1], gen)
    uniq1, _, num1 = _dedup_first_occurrence(
        torch.cat([seeds, nbr1.reshape(-1)]), sentinel)
    live = torch.arange(cap_dst0, device="cuda") < num1
    dst0 = torch.where(live, uniq1, torch.full_like(uniq1, sentinel))
    nbr0, _, _ = _sample_layer(rt.g, dst0, FANOUTS[0], gen)
    cat = torch.cat([dst0, nbr0.reshape(-1)])
    card = _dedup_first_occurrence(cat, sentinel)
    host = _dedup_first_occurrence(cat.cpu(), sentinel)
    require(all(bool(torch.equal(a.cpu(), b)) for a, b in zip(card, host)),
            "dedup of a real cat: the card differs from the CPU")
    t_dedup = median_ms(torch, lambda: _dedup_first_occurrence(cat,
                                                               sentinel))
    t_s = {d: median_ms(torch, lambda d=d: sample_blocks_device(
        rt.g, seeds, FANOUTS, BATCH, gen, dedup=d)) for d in (False, True)}
    print(f"phase 17: dedup of one real layer-0 cat (L {cat.numel()}, "
          f"{int(card[2])} distinct ids): card bitwise equal to the CPU; "
          f"{t_dedup:.4f} ms on the card; sample_blocks_device "
          f"dedup=False {t_s[False]:.4f} ms, dedup=True {t_s[True]:.4f} ms "
          f"(median of 25, L2 flushed, {smi})")

    grids = make_grids(ds, 1, DEDUP_WARM + DEDUP_MEAS, BATCH,
                       np.random.default_rng(19))[0]
    losses = []
    for i, seeds_np in enumerate(grids):
        if i == DEDUP_WARM:
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
        g_s = step_generators(3, i, 1, SAMPLE, "cuda")[0]
        g_d = step_generators(3, i, 1, DROPOUT, "cuda")[0]
        loss, _ = rt.train_step(rt.resolve(rt.begin(seeds_np, g_s)), g_d)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launches()
    losses = torch.stack(losses).cpu().numpy()
    st = rt.stats()
    want = {k: v * DEDUP_MEAS for k, v in ADJ_SAGE_PER_STEP.items()}
    got = {k: v for k, v in counts.items() if v}
    require(got == want, f"dedup steps: launches {got}, expected {want}")
    require(np.isfinite(losses).all() and
            losses[-3:].mean() < losses[:3].mean(),
            f"dedup steps: losses not finite and falling {losses}")
    require(st["misses"] == 0 and on_card(torch, rt),
            f"dedup steps: misses at full coverage or state off the card "
            f"{st}")
    print(f"phase 17: ResidentTrainer dedup=True per-step path (flat f32 "
          f"table, full coverage): {1000 * dt / DEDUP_MEAS:.3f} ms/step "
          f"({DEDUP_MEAS} measured steps after {DEDUP_WARM}, host clock, "
          f"{smi}); launches per step "
          f"{ {k: v // DEDUP_MEAS for k, v in got.items()} }; losses "
          f"{np.array2string(losses, precision=4)}")

    gen = step_generators(3, 99, 1, SAMPLE, "cuda")[0]
    blocks, feats, y = rt.resolve(rt.begin(grids[0], gen))

    def step():
        logits = rt.model(blocks, feats, train=False)[:BATCH]
        torch.nn.functional.cross_entropy(logits, y).backward()

    calls = record_calls(torch, step)
    rt.optimizer.zero_grad(set_to_none=True)
    require(len(calls) == 2 and "g" not in calls[0] and "g" in calls[1],
            "dedup step: expected one call per layer, a gradient at layer 1")
    checked = step_kernels(torch, "phase 17: dedup", calls)
    entries = []
    for (name, layer), e in checked.items():
        per_step = sum(1 for n, _ in checked if n == name)
        entries.append({"name": f"{name} sage dedup resident layer {layer}",
                        "counter": name,
                        "launches": counts[name] // per_step,
                        **{k: v for k, v in e.items() if k != "form"}})
    del rt
    torch.cuda.empty_cache()
    return counts, entries


def phase_nbr_cli(torch, ds, smi) -> tuple:
    """17.3: the resident CLI with ``--nbr_cap`` (``cli_row``):
    SAGE, and RGAT with 4 heads on 3 edge types (the relation table);
    every kernel call of one real step of each against its plain version.
    Returns (launches by kernel, worst errors by kernel)."""
    total, errs = {}, {}
    for tag, kind in (("sage-nbr32-w8", "sage"), ("rgat-nbr32-w8", "rgat")):
        counts, run, _ = cli_row(
            torch, ds, smi, "phase 17", tag, kind, RESIDENT_PER_STEP[kind],
            pipeline="resident", window=8, nbr_cap=NBR_CAP)
        add_counts(total, counts)
        g = run.trainer.g
        require(g.nbr_table is not None and
                (g.rel_table is not None) == (kind == "rgat"),
                f"{tag}: the trainer samples without its table")
        mb = sum(t.numel() * t.element_size() for t in
                 (g.nbr_table, g.nbr_deg, g.rel_table)
                 if t is not None) / 1e6
        print(f"phase 17: {tag}: padded table"
              + (" + relation table" if g.rel_table is not None else "")
              + f" {mb:.1f} MB on the card")
        checked = step_kernels(torch, f"phase 17: {tag}",
                               resident_step_calls(torch, run))
        for (name, _), e in checked.items():
            errs[name] = max(errs.get(name, 0.0), e["max_abs_err"])
        del run
        torch.cuda.empty_cache()
    return total, errs


def record_domains(run) -> list:
    """Wrap the run's scheduler so every seed slice it hands out is kept
    (in call order) in the returned list."""
    kept, orig = [], run.scheduler.run_domain

    def run_domain():
        d = orig()
        kept.append(np.array(d))
        return d

    run.scheduler.run_domain = run_domain
    return kept


def baseline_domains(ds, steps: tuple) -> list:
    """The seed slices a baseline distributor gives one part: ``steps[e]``
    iterations of each epoch e, reshuffled between epochs as the CLI does
    (``--seed`` 0)."""
    from coala_gnn_tpu_torch.distribution import SeedDistributor

    d = SeedDistributor(ds.train_idx, batch_size=BATCH, local_size=1,
                        num_parts=1, mode="baseline", shuffle_seed=0)
    out = []
    for epoch, n in enumerate(steps):
        if epoch:
            d.reshuffle(epoch)
        out.append([np.array(d.distribute(i)[0]) for i in range(n)])
    return out


def check_colors(run, meta, tag: str) -> int:
    """The cache's color counters: non-zero, and summing to the resident
    lines whose node has a color; each line carries its node's color.
    Returns the colored lines."""
    base = run.cache.state.base
    tags = base.tags[:-1].cpu().numpy()
    line_colors = run.cache.state.line_colors[:-1].cpu().numpy()
    counts = base.color_counts.cpu().numpy()
    held = tags >= 0
    colored = int((meta.color[tags[held]] > 0).sum())
    require(colored > 0 and int(counts[1:].sum()) == colored,
            f"{tag}: color counters sum {int(counts[1:].sum())}, colored "
            f"resident lines {colored}")
    require(bool((line_colors[held] == meta.color[tags[held]]).all()),
            f"{tag}: a cache line's color is not its node's")
    return colored


def phase_colors(torch, ds, smi, tmp: str) -> dict:
    """17.4: the color metadata of the 200k graph through the port's
    native library (``generate_color_metadata``), written under ``tmp``;
    then the CLI with ``--distribution node_color --color_dir`` on the
    host path and on ``--pipeline resident --window 8``: the seed slices
    equal a baseline distributor's (one part), the cache's color counters
    match its lines, SAGE's launches. Returns launches by kernel."""
    import os

    from coala_gnn_tpu_torch.coloring import (generate_color_metadata,
                                              load_color_metadata,
                                              save_color_metadata)

    t0 = time.perf_counter()
    meta = generate_color_metadata(ds.graph, ds.train_idx)
    dt = time.perf_counter() - t0
    cdir = os.path.join(tmp, "colors")
    save_color_metadata(meta, cdir)
    back = load_color_metadata(cdir)
    require(np.array_equal(back.color, meta.color) and
            np.array_equal(back.score, meta.score),
            "color metadata round trip")
    print(f"phase 17: generate_color_metadata (native, host): "
          f"{ds.graph.num_nodes} nodes into {meta.num_colors} colors, "
          f"{100 * (meta.color > 0).mean():.2f}% colored, in {dt:.3f} s "
          f"(host clock)")
    total = {}
    base = baseline_domains(ds, (RESIDENT_WARM, RESIDENT_MEAS))
    flags = dict(distribution="node_color", color_dir=cdir)
    for tag, resident in (("sage-node_color-host", False),
                          ("sage-node_color-w8", True)):
        kept = []
        hook = lambda run: kept.append(record_domains(run))
        more = dict(pipeline="resident", window=8) if resident else {}
        counts, run, _ = cli_row(
            torch, ds, smi, "phase 17", tag, "sage",
            RESIDENT_PER_STEP["sage"] if resident else ADJ_SAGE_PER_STEP,
            on_build=hook, **flags, **more)
        add_counts(total, counts)
        require(run.meta is not None and
                run.cache.cfg.num_colors == meta.num_colors,
                f"{tag}: the run does not hold the color metadata")
        domains = kept[0]
        # the host loader prefetches: the epochs' first slices are the
        # trained ones (the loader stops its worker at the epoch's end)
        ok = True
        got = domains
        for want in base:
            idx = next((i for i in range(len(got) - len(want) + 1)
                        if np.array_equal(got[i], want[0])), None)
            ok = ok and idx is not None and all(
                np.array_equal(a, b)
                for a, b in zip(got[idx:idx + len(want)], want))
            got = got[(idx or 0) + len(want):]
        require(ok, f"{tag}: node_color's seed slices differ from the "
                "baseline distributor's (one part)")
        colored = check_colors(run, meta, tag)
        nonzero = int((run.cache.state.base.color_counts[1:] > 0).sum())
        print(f"phase 17: {tag}: seed slices of both epochs equal the "
              f"baseline distributor's; {colored} resident lines hold a "
              f"colored node, and the {meta.num_colors} color counters sum "
              f"to them ({nonzero} colors non-zero)")
        del run
        torch.cuda.empty_cache()
    return total


def same_state(torch, run, path: str) -> bool:
    """The run's model and optimizer state equal, bit for bit, the
    checkpoint file ``path``."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    model = run.model.state_dict()
    ok = set(model) == set(saved["model"]) and all(
        torch.equal(model[k].cpu(), saved["model"][k]) for k in model)
    got, want = run.optimizer.state_dict(), saved["optimizer"]
    ok = ok and got["param_groups"] == want["param_groups"]
    ok = ok and set(got["state"]) == set(want["state"]) and len(want["state"])
    for k, st in want["state"].items():
        ok = ok and set(got["state"][k]) == set(st) and all(
            torch.equal(torch.as_tensor(got["state"][k][n]).cpu(),
                        torch.as_tensor(v)) for n, v in st.items())
    return bool(ok)


def phase_checkpoint(torch, ds, smi, tmp: str) -> None:
    """17.5: ``--save_dir`` / ``--resume`` through the CLI. The resident
    SAGE (``--window 8``) trains 2 epochs of 4 steps saving each; a second
    run resumes from the first epoch's checkpoint: its state equals the
    file bitwise, it starts at epoch 1, and its epoch's losses equal the
    uninterrupted run's (1e-5). The host CLI's SAGE saves one epoch and a
    second run restores it bitwise."""
    import os
    import shutil

    from coala_gnn_tpu_torch import train as cli
    from coala_gnn_tpu_torch.utils import checkpoint as ckpt

    def args_of(save_dir, resume=False, **flags):
        return cli.parse_args(cli_args(
            "sage", epochs=2, max_steps=4, save_dir=save_dir, resume=resume,
            **flags))

    full, part = os.path.join(tmp, "ck_full"), os.path.join(tmp, "ck_part")
    resident = dict(pipeline="resident", window=8)
    run = cli.build(args_of(full, **resident), ds=ds)
    ref = cli.train(run)["losses"]
    require(ckpt.latest_step(full) == 8 and
            sorted(os.listdir(full)) == ["step_4", "step_8"],
            f"resident --save_dir wrote {sorted(os.listdir(full))}")
    del run
    shutil.copytree(os.path.join(full, "step_4"),
                    os.path.join(part, "step_4"))
    run = cli.build(args_of(part, True, **resident), ds=ds)
    start = cli.resume(run)
    require(start == 1 and run.step == 4 and not run.fresh,
            f"resume: start epoch {start}, step {run.step}")
    require(same_state(torch, run, os.path.join(part, "step_4",
                                                ckpt.FILE)),
            "resident resume: restored state differs from the checkpoint")
    require(on_card_cli(torch, run), "resident resume: state off the card")
    got = cli.train(run)["losses"]
    require(got.shape == (4,) and np.allclose(got, ref[4:], rtol=1e-5,
                                              atol=1e-5),
            f"resumed epoch losses {got} vs uninterrupted {ref[4:]}")
    print(f"phase 17: resident CLI --save_dir / --resume: restored params "
          f"and Adam state bitwise equal to step_4; resumed epoch 1 losses "
          f"{np.array2string(got, precision=6)} vs uninterrupted "
          f"{np.array2string(ref[4:], precision=6)}, max diff "
          f"{np.abs(got - ref[4:]).max():.3g} ({smi})")
    del run
    host = os.path.join(tmp, "ck_host")
    run = cli.build(cli.parse_args(cli_args(
        "sage", epochs=1, max_steps=4, save_dir=host)), ds=ds)
    cli.train(run)
    del run
    run = cli.build(args_of(host, True), ds=ds)
    require(cli.resume(run) == 1 and same_state(
        torch, run, os.path.join(host, "step_4", ckpt.FILE)) and
        on_card_cli(torch, run),
        "host resume: restored state differs from the checkpoint")
    print("phase 17: host CLI --save_dir / --resume: restored params and "
          "Adam state bitwise equal to step_4, starting at epoch 1")
    del run
    torch.cuda.empty_cache()


def phase_ports(torch, ds, store, smi) -> tuple:
    """Phase 17 (the module docstring): returns (launches by kernel, worst
    errors by kernel, kernels JSON entries of the dedup step)."""
    import shutil
    import tempfile

    total = {"gather_spmm[float32]": phase_nbr_table(torch, ds, store, smi)}
    counts, entries = phase_dedup(torch, ds, store, smi)
    add_counts(total, counts)
    counts, errs = phase_nbr_cli(torch, ds, smi)
    add_counts(total, counts)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        add_counts(total, phase_colors(torch, ds, smi, tmp))
        phase_checkpoint(torch, ds, smi, tmp)
    finally:
        shutil.rmtree(tmp)
    return total, errs, entries


#: phase 18: the IGB layouts (IGB-tiny's 100k papers at IGB's dim 1024)
IGB_PAPERS, IGB_DIM, IGB_CLASSES = 100_000, 1024, 19
#: phase 18's rows: (tag, --data, --model_type, more flags, launches per
#: measured step); every row at the flagship widths, 4 + 16 steps
DATA_ROWS = (
    ("igb-sage-resident", "igb", "sage",
     dict(pipeline="resident", window=8), RESIDENT_PER_STEP["sage"]),
    ("igb-sage-host", "igb", "sage", {}, ADJ_SAGE_PER_STEP),
    ("preprocessed-sage-resident", "preprocessed", "sage",
     dict(pipeline="resident", window=8), RESIDENT_PER_STEP["sage"]),
    ("igb-hetero-rgat-host", "igb-hetero", "rgat", {},
     HETERO_PER_STEP["rgat"]))
#: phase 19: the reference-scale leg at reduced depth: 1M of its 10M nodes
#: at dim 1024 (4.1 GB of features), a cache of the same ~10% coverage
#: that 4096 MB is of 41 GB, K = 32, 1 warm-up + 1 measured window
REFSCALE_NODES, REFSCALE_MB = 1_000_000, 410


def write_igb_layout(ds, out: str, size: str = "tiny") -> str:
    """IGB's homogeneous raw layout of ``ds`` under ``out`` (as
    examples/make_igb_fixture.py writes it: float32 features and labels,
    ``edge_index`` [E, 2] int32 (src, dst) in CSC order), plus the
    preprocessed layout's features, labels and train split in
    ``out/preprocessed`` (its csc_*.npy come from create_csc_graph)."""
    import os

    paper = os.path.join(out, size, "processed", "paper")
    cites = os.path.join(out, size, "processed", "paper__cites__paper")
    pre = os.path.join(out, "preprocessed")
    for d in (paper, cites, pre):
        os.makedirs(d, exist_ok=True)
    np.save(os.path.join(paper, "node_feat.npy"), ds.features)
    np.save(os.path.join(paper, "node_label_19.npy"),
            ds.labels.astype(np.float32))
    dst = np.repeat(np.arange(ds.graph.num_nodes, dtype=np.int32),
                    np.diff(ds.graph.indptr))
    np.save(os.path.join(cites, "edge_index.npy"),
            np.stack([ds.graph.indices.astype(np.int32), dst], axis=1))
    np.save(os.path.join(pre, "features.npy"), ds.features)
    np.save(os.path.join(pre, "labels.npy"), ds.labels.astype(np.int32))
    np.save(os.path.join(pre, "train_idx.npy"),
            ds.train_idx.astype(np.int64))
    return out


def write_igb_hetero_layout(out: str, num_paper: int, dim: int,
                            size: str = "tiny", avg_degree: int = 8,
                            seed: int = 0) -> str:
    """IGB-hetero's raw layout under ``out``, as
    examples/make_igb_fixture.py's ``write_igb_hetero_fixture`` writes it
    (the same draws): 4 node types of one dim, the papers the synthetic
    graph, 4 edge directories of [E, 2] (src, dst), paper labels
    float32."""
    import os

    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph

    rng = np.random.default_rng(seed)
    ds = synthetic_graph(num_nodes=num_paper, avg_degree=avg_degree,
                         feature_dim=dim, num_classes=19, seed=seed)
    counts = {"paper": num_paper, "author": max(num_paper // 2, 8),
              "institute": max(num_paper // 20, 4),
              "fos": max(num_paper // 10, 4)}
    base = os.path.join(out, size, "processed")
    for t, n in counts.items():
        os.makedirs(os.path.join(base, t), exist_ok=True)
        feat = (ds.features if t == "paper" else
                rng.normal(0, 1, size=(n, dim)).astype(np.float32))
        np.save(os.path.join(base, t, "node_feat.npy"), feat)
    np.save(os.path.join(base, "paper", "node_label_19.npy"),
            ds.labels.astype(np.float32))
    dst = np.repeat(np.arange(num_paper, dtype=np.int32),
                    np.diff(ds.graph.indptr))
    src = np.asarray(ds.graph.indices, dtype=np.int32)

    def dump(d, s, t):
        os.makedirs(os.path.join(base, d), exist_ok=True)
        np.save(os.path.join(base, d, "edge_index.npy"),
                np.stack([np.asarray(s, np.int32),
                          np.asarray(t, np.int32)], axis=1))
    dump("paper__cites__paper", src, dst)
    n_pa = num_paper * 2
    dump("paper__written_by__author",
         rng.integers(0, counts["paper"], n_pa),
         rng.integers(0, counts["author"], n_pa))
    n_ai = counts["author"]
    dump("author__affiliated_to__institute",
         np.arange(n_ai), rng.integers(0, counts["institute"], n_ai))
    dump("paper__topic__fos", rng.integers(0, counts["paper"], num_paper),
         rng.integers(0, counts["fos"], num_paper))
    return out


def machine_report(path: str) -> str:
    """Host RAM (total, available), free disk under ``path`` and CPU
    count of this machine."""
    import os

    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":")
            mem[k] = int(v.split()[0]) / 2**20      # kB -> GiB
    disk = shutil.disk_usage(path)
    return (f"host RAM {mem['MemTotal']:.1f} GiB ({mem['MemAvailable']:.1f} "
            f"available, page cache {mem['Cached']:.1f}), disk free under "
            f"the temporary directory {disk.free / 2**30:.1f} of "
            f"{disk.total / 2**30:.1f} GiB, {os.cpu_count()} CPUs")


def data_entries(tag: str, row_counts: dict, checked: dict) -> list:
    """Kernels JSON entries of one row's real-step calls: the row's
    launches of each kernel split over the step's calls of it."""
    entries = []
    for (name, layer), e in checked.items():
        calls = sum(1 for n, _ in checked if n == name)
        entries.append({"name": f"{name} {tag} layer {layer}",
                        "counter": name,
                        "launches": row_counts.get(name, 0) // calls,
                        **{k: v for k, v in e.items() if k != "form"}})
    return entries


def phase_data(torch, smi, tmp: str) -> tuple:
    """Phase 18: the reference's on-disk layouts through the trainer CLI
    (``train.build`` loading ``--data`` / ``--path``): IGB's homogeneous
    layout (100k papers, dim 1024, avg degree 15, 19 classes), its
    preprocessed layout through ``python -m
    coala_gnn_tpu_torch.create_csc_graph``, IGB-hetero's (100k papers, 4
    node types, 8 relations with the reverses); the ``DATA_ROWS`` at
    hidden 256, fanout 10,5, batch 1024, the 1024 MB cache cold at the
    start, 4 + 16 steps (``cli_row``'s checks and prints), each kernel of
    one real step against its plain version. Returns (launches by
    kernel, kernels JSON entries)."""
    import os

    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph

    t0 = time.perf_counter()
    print(f"phase 18: {machine_report(tmp)}")
    igb = os.path.join(tmp, "igb")
    write_igb_layout(synthetic_graph(
        num_nodes=IGB_PAPERS, avg_degree=15, feature_dim=IGB_DIM,
        num_classes=IGB_CLASSES, seed=0), igb)
    pre = os.path.join(igb, "preprocessed")
    done = subprocess.run(
        [sys.executable, "-m", "coala_gnn_tpu_torch.create_csc_graph",
         "--edge_index", os.path.join(igb, "tiny", "processed",
                                      "paper__cites__paper",
                                      "edge_index.npy"),
         "--num_nodes", str(IGB_PAPERS), "--out", pre],
        capture_output=True, text=True, timeout=600)
    require(done.returncode == 0, f"create_csc_graph failed: "
            f"{done.stderr[-2000:]}")
    igbh = write_igb_hetero_layout(os.path.join(tmp, "igbh"), IGB_PAPERS,
                                   IGB_DIM, avg_degree=15)
    print(f"phase 18: wrote the IGB, preprocessed ("
          f"{done.stdout.strip().splitlines()[-1]}) and IGB-hetero layouts "
          f"in {time.perf_counter() - t0:.1f} s")
    paths = {"igb": igb, "preprocessed": pre, "igb-hetero": igbh}
    total, entries = {}, []
    for tag, data, kind, flags, per_step in DATA_ROWS:
        row_counts, run, _ = cli_row(
            torch, None, smi, "phase 18", tag, kind, per_step, data=data,
            path=paths[data], dataset_size="tiny", num_classes=IGB_CLASSES,
            **flags)
        require(isinstance(run.ds.features, np.memmap) ==
                (data != "igb-hetero"), f"{tag}: features copied into RAM")
        if kind in HETERO_KINDS:
            require(run.ds.graph.num_edge_types == 8,
                    f"{tag}: {run.ds.graph.num_edge_types} relations, "
                    "expected IGB-hetero's 4 and their reverses")
        add_counts(total, row_counts)
        calls = (resident_step_calls(torch, run) if run.trainer is not None
                 else hetero_step_calls(torch, run))
        entries += data_entries(tag, row_counts, step_kernels(
            torch, f"phase 18: {tag}", calls))
        del run
        torch.cuda.empty_cache()
    return total, entries


def int8_past_2_31(torch) -> dict:
    """The int8 kernel on a table of more than 2^31 elements (2,101,248 x
    1024, as int8 lines of a 4 GB cache at dim 1024 hold ~4.2M rows), adj
    reaching its last rows, against its plain version: the 64-bit row
    offsets. Returns its entry (error, times, bound)."""
    from coala_gnn_tpu_torch.ops.gather_spmm import (gather_spmm,
                                                     gather_spmm_reference)

    rows, d = (1 << 31) // 1024 + 4096, 1024
    gen = torch.Generator(device="cuda").manual_seed(19)
    x = torch.randint(-127, 128, (rows, d), dtype=torch.int8,
                      device="cuda", generator=gen)
    scale = torch.rand(rows, device="cuda", generator=gen) / 127
    n, f = 6 * BATCH, FANOUTS[0]
    adj = torch.randint(rows - 200_000, rows, (n, f), dtype=torch.int32,
                        device="cuda", generator=gen)
    adj[0, 0] = rows - 1
    w = torch.rand(n, f, device="cuda", generator=gen)
    e = {"max_abs_err": max_err(torch, gather_spmm(x, adj, w, scale),
                                gather_spmm_reference(x, adj, w, scale),
                                "int8 table past 2^31 elements")}
    timed(torch, e, lambda: gather_spmm(x, adj, w, scale),
          lambda: gather_spmm_reference(x, adj, w, scale),
          forward_work(torch, x, scale, adj, w))
    print(f"phase 19: int8 kernel on a {rows} x {d} table "
          f"({rows * d} elements, past 2^31), adj in its last 200,000 "
          f"rows: max_abs_err {e['max_abs_err']:.3g}; "
          + describe("gather_spmm[int8]", e))
    return e


def phase_refscale(torch, smi, tmp: str) -> tuple:
    """Phase 19: ``reference_scale.generate`` at ``REFSCALE_NODES`` (avg
    degree 15, dim 1024, 19 classes, communities of 2048, p_intra 0.9,
    seed 0) into ``tmp``, then ``run_single`` with f32 lines and with int8
    lines (``--quantize``): ``REFSCALE_MB``, int8 transport, degree
    priorities and prewarm, SAGE at hidden 256, fanout 10,5, batch 1024,
    K = 32, 1 + 1 windows. Checks staged windows with hits, misses and no
    replay, finite losses falling over the warm-up window from a first
    loss above 0, one f32 launch per step; prints the record; holds the
    kernel against its plain version on one staged step's frontier, and
    the int8 kernel on a table past 2^31 elements. Returns (launches by
    kernel, worst error by kernel)."""
    import os

    from coala_gnn_tpu_torch import reference_scale as rs
    from coala_gnn_tpu_torch.ops.gather_spmm import (gather_spmm,
                                                     gather_spmm_reference)

    path = os.path.join(tmp, "refscale")
    t0 = time.perf_counter()
    meta = rs.generate(path, REFSCALE_NODES, 15, 1024, 19, 2048, 0.9, 0)
    print(f"phase 19: generated {REFSCALE_NODES} nodes x 1024 "
          f"({meta['feature_bytes'] / 2**30:.2f} GiB of features) in "
          f"{time.perf_counter() - t0:.1f} s (topology "
          f"{meta['gen_topology_s']} s, features {meta['gen_features_s']} "
          f"s); {machine_report(tmp)}")
    total, errs = {}, {"gather_spmm[float32]": 0.0}
    for quantize in (False, True):
        tag = "int8 lines" if quantize else "f32 lines"
        seen = {}

        def after(rt, ds):
            seen["counts"] = launches()
            require(not rt.direct and rt.stage_transport == "int8" and
                    rt._store is not None and
                    rt.cache.base.data.dtype == (torch.int8 if quantize
                                                 else torch.float32),
                    f"{tag}: not staged {tag} with int8 transport and the "
                    "native host store")
            require("replay" not in rt.timers.totals, f"{tag}: replayed")
            require(rt.g.indices.is_cuda and on_card(torch, rt),
                    f"{tag}: state off the card")
            seen["err"] = phase_staged_step(
                torch, rt, ds, gather_spmm, gather_spmm_reference,
                np.random.default_rng(19), label=f"phase 19 ({tag})")

        t0 = time.perf_counter()
        reset_launches()
        out = rs.run_single(path, REFSCALE_MB, BATCH, "10,5", HIDDEN,
                            K_PRESSURE, 1, 1, "int8", quantize=quantize,
                            device="cuda", on_trainer=after)
        counts = {k: v for k, v in seen["counts"].items() if v}
        require(counts == {"gather_spmm[float32]": 2 * K_PRESSURE},
                f"{tag}: launches {counts}, expected one f32 forward per "
                f"step of 2 windows of {K_PRESSURE}")
        add_counts(total, counts)
        warm = out["warm_loss_first_last"]
        require(np.isfinite(warm + out["loss_first_last"]).all() and
                warm[0] > 0 and warm[1] < warm[0],
                f"{tag}: warm-up losses not finite and falling from above 0 "
                f"{warm}")
        require(0 < out["hit_ratio"] < 1, f"{tag}: hit ratio "
                f"{out['hit_ratio']}")
        errs["gather_spmm[float32]"] = max(errs["gather_spmm[float32]"],
                                           seen["err"])
        print(f"phase 19: reference scale, {tag} (run_single, "
              f"{time.perf_counter() - t0:.1f} s with set-up): "
              f"{out['ms_per_step']} ms/step, edges/s {out['edges_per_s']}, "
              f"hit ratio {out['hit_ratio']}, stage rows per window "
              f"{out['stage_rows_per_window']} ({smi}); record "
              + json.dumps(out))
        torch.cuda.empty_cache()
    errs["gather_spmm[int8]"] = int8_past_2_31(torch)["max_abs_err"]
    torch.cuda.empty_cache()
    return total, errs


def phase_entry(torch, smi) -> dict:
    """Phase 20: ``entry()``'s forward on the card against the port on the
    CPU (SMALL_RTOL / SMALL_ATOL), its two f32 launches; then
    ``dryrun_multichip(1)`` on the card (both pipelines, their checks).
    Returns the launches by kernel."""
    from coala_gnn_tpu_torch import entry

    reset_launches()
    fn, args = entry.entry("cuda")
    out = fn(*args)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launches().items() if v}
    require(counts == {"gather_spmm[float32]": 2}, f"entry(): launches "
            f"{counts}, expected one forward per layer")
    fn_cpu, args_cpu = entry.entry("cpu")
    ref = fn_cpu(*args_cpu).numpy()
    np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=SMALL_RTOL,
                               atol=SMALL_ATOL)
    print(f"phase 20: entry() logits {tuple(out.shape)} on the card vs the "
          f"CPU port: max diff {np.abs(out.cpu().numpy() - ref).max():.3g} "
          f"(rtol {SMALL_RTOL} atol {SMALL_ATOL}); launches {counts}")
    total = dict(counts)
    reset_launches()
    t0 = time.perf_counter()
    got = entry.dryrun_multichip(1, "cuda")
    torch.cuda.synchronize()
    counts = {k: v for k, v in launches().items() if v}
    require(counts.get("gather_spmm[float32]", 0) > 0,
            f"dryrun_multichip(1): launches {counts}")
    add_counts(total, counts)
    print(f"phase 20: dryrun_multichip(1) on the card in "
          f"{time.perf_counter() - t0:.1f} s: host hit ratio "
          f"{got['host']['hit_ratio']:.4f}, window hit ratio "
          f"{got['window']['hit_ratio']:.4f}, launches {counts} ({smi})")
    return total


MULTI_MB = 64           # cache MB per rank: ~60% of the 205 MB of rows
MULTI_WARM, MULTI_MEAS = 4, 16    # over two ranks, ~30% on one
MULTI_SMALL = 4         # steps of the card-vs-CPU comparison, dropout 0
MULTI_MODES = (("sharded", False), ("node_local", False),
               ("isolated", False), ("sharded", True))


def multi_mesh(mesh, mode: str):
    """The rank's mesh for ``mode``: node_local over hosts of one rank
    each (its group of 1 routes every id to the rank itself, isolated's
    routing under the node_local name; the miss decision still spans
    every rank), the mesh as it is otherwise."""
    import dataclasses

    if mode != "node_local":
        return mesh
    return dataclasses.replace(mesh, local_size=1,
                               host_group=mesh.block_group(1))


def watch_fetches(cache) -> list:
    """(miss count that decided the miss path, overflow slots) of every
    fetch the cache front resolves from now on."""
    seen, resolve = [], cache.fetch_complete

    def fetch_complete(handle, *args, **kwargs):
        seen.append((handle.miss_count(), int(handle.overflow.sum())))
        return resolve(handle, *args, **kwargs)

    cache.fetch_complete = fetch_complete
    return seen


def multi_rank(mesh, ds, measure: bool) -> list:
    """Phase 21's rank body (every rank runs it, ``multihost.launch``):
    per mode of ``MULTI_MODES`` the trainer CLI's host SAGE at the flagship
    widths on this rank's mesh, a ``MULTI_MB`` cache per rank. With
    ``measure``: ``MULTI_WARM`` warm-up + ``MULTI_MEAS`` measured steps at
    the CLI's dropout 0.5, recording the measured steps' launches, the
    bytes handed to the collectives, each fetch's miss count and overflow
    slots, the summed hit counts and the time. Then, from fresh weights,
    ``MULTI_SMALL`` steps at dropout 0: the losses that the same run on
    the CPU is held to."""
    import torch

    from coala_gnn_tpu_torch import train as cli

    out = []
    for mode, quant in MULTI_MODES:
        rec = {"mode": mode, "quantize": quant}
        m = multi_mesh(mesh, mode)
        args = cli.parse_args(cli_args("sage", device=str(mesh.device),
                                       cache_size=MULTI_MB,
                                       cache_backend=mode, quantize=quant))
        if measure:
            run = cli.build(args, ds=ds, mesh=m)
            fetches = watch_fetches(run.cache)
            warm = cli.train(run, epochs=1, max_steps=MULTI_WARM)
            sync(torch, mesh.device)
            reset_launches()
            mesh.ledger.reset()
            fetches.clear()
            meas = cli.train(run, epochs=1, max_steps=MULTI_MEAS)
            sync(torch, mesh.device)
            rec.update(
                losses=np.concatenate([warm["losses"], meas["losses"]]),
                launches={k: v for k, v in launches().items() if v},
                ledger=mesh.ledger.snapshot(), fetches=list(fetches),
                stats=meas["stats"][0], dt=meas["epoch_s"][0],
                edges=meas["edges"], n_req=run.sampler.caps[0][1],
                route=run.cache.n_route, on_card=on_card_cli(torch, run),
                param_bytes=4 * sum(p.numel()
                                    for p in run.model.parameters()))
            del run
        run = cli.build(args, ds=ds, mesh=m)
        run.model.dropout = 0.0
        rec["small"] = cli.train(run, epochs=1,
                                 max_steps=MULTI_SMALL)["losses"]
        del run
        out.append(rec)
    return out


def multi_bytes(rec: dict) -> dict:
    """What ``comm_model.step_traffic`` says a rank hands to the
    all-to-alls over ``rec``'s measured steps, by phase (the fill's summed
    over the fetches that filled, each sized from its miss count)."""
    from coala_gnn_tpu_torch.parallel import comm_model

    G = rec["route"]

    def traffic(misses=0):
        return comm_model.step_traffic(
            rec["mode"], rec["n_req"], n_dev=2,
            local=G if rec["mode"] == "node_local" else 2, dim=DIM,
            int8_response=rec["quantize"], misses=misses)

    ex = traffic()["exchange"]["off_device"]
    want = {p: MULTI_MEAS * ex[p] for p in ("request", "response",
                                             "hitbits")}
    want["fill"] = sum(traffic(m)["fill_miss_step"]["off_device"]
                       for m, _ in rec["fetches"] if m)
    return want


def check_multi(ranks: list, cpu: list, tag: str, smi: str,
                backend: str) -> dict:
    """Phase 21's checks and prints for one launch of ``multi_rank``
    (``ranks``: each rank's records) against the CPU run's (``cpu``);
    returns the measured steps' launches summed over ranks and modes."""
    total = {}
    for i, (mode, quant) in enumerate(MULTI_MODES):
        name = f"{mode}{'-int8' if quant else ''}"
        for r, rank in enumerate(ranks):
            rec = rank[i]
            what = f"phase 21 {tag} {name} rank {r}"
            losses = rec["losses"]
            q = losses.size // 4
            require(np.isfinite(losses).all() and
                    losses[-q:].mean() < losses[:q].mean(),
                    f"{what}: losses not finite and falling {losses}")
            np.testing.assert_allclose(rec["small"], cpu[r][i]["small"],
                                       rtol=SMALL_RTOL, atol=SMALL_ATOL,
                                       err_msg=what + " vs the CPU run")
            want = {k: v * MULTI_MEAS for k, v in ADJ_SAGE_PER_STEP.items()}
            require(rec["launches"] == want, f"{what}: launches "
                    f"{rec['launches']}, expected {want}")
            require(rec["on_card"], f"{what}: state off the card")
            led = rec["ledger"]
            got = {p: led["handed"].get(p, 0) - led["kept"].get(p, 0)
                   for p in ("request", "response", "hitbits", "fill")}
            require(got == multi_bytes(rec), f"{what}: bytes handed to the "
                    f"all-to-alls {got}, comm_model {multi_bytes(rec)}")
            require(led["handed"]["grad"] ==
                    MULTI_MEAS * (rec["param_bytes"] + 8),
                    f"{what}: gradient all-reduce {led['handed']['grad']}")
            add_counts(total, rec["launches"])
        rec = ranks[0][i]
        st = rec["stats"]
        over = sum(o for rank in ranks for _, o in rank[i]["fetches"])
        ex = sum(multi_bytes(rec).values()) / MULTI_MEAS
        diff = max(np.abs(rank[i]["small"] - c[i]["small"]).max()
                   for rank, c in zip(ranks, cpu))
        print(f"phase 21: {tag} {name} (CLI --devices 2 --cache_backend "
              f"{mode}{' --quantize' if quant else ''} --cache_size "
              f"{MULTI_MB}, route {rec['route']}): "
              f"{1000 * rec['dt'] / MULTI_MEAS:.3f} ms/step, "
              f"train_edges_per_s_per_card {rec['edges'] / rec['dt']:.1f} "
              f"(rank 0; {MULTI_MEAS} measured steps after {MULTI_WARM}, "
              f"host clock, backend {backend}, {smi}); hit ratio "
              f"{st['hit_ratio']:.4f} ({st['hits']} hits / {st['misses']} "
              f"misses, both ranks); overflow slots {over}; all-to-all "
              f"bytes leaving each rank per step {ex:.0f} (= "
              f"comm_model.step_traffic); losses rank 0 "
              f"{np.array2string(rec['losses'][::2], precision=4)}; "
              f"dropout-0 steps vs the CPU run: max diff {diff:.3g}")
    return total


def cache_state(run) -> dict:
    s, n = run.cache.state, run.cache.cfg.num_sets
    return {"tags": s.base.tags[:n], "data": s.base.data[:n],
            "rr": s.base.rr, "line_colors": s.line_colors[:n],
            "color_counts": s.base.color_counts}


def phase_multi(torch, ds, smi) -> dict:
    """Phase 21: data-parallel training on the host pipeline (module
    docstring). Returns the launches by kernel."""
    from coala_gnn_tpu_torch import train as cli
    from coala_gnn_tpu_torch.parallel import multihost
    from coala_gnn_tpu_torch.parallel.mesh import make_mesh

    total, runs = {}, {}
    args = cli.parse_args(cli_args("sage", cache_size=MULTI_MB))
    for name in ("one card", "nccl world 1"):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
        try:
            if name == "nccl world 1":
                multihost.initialize_distributed(
                    "nccl", f"file://{tmp}/store", 1, 0)
            mesh = make_mesh("cuda:0")
            run = cli.build(args, ds=ds, mesh=mesh)
            torch.cuda.synchronize()
            reset_launches()
            out = cli.train(run, epochs=1, max_steps=MULTI_WARM + MULTI_MEAS)
            torch.cuda.synchronize()
            runs[name] = (out, {k: v.cpu() for k, v in
                                cache_state(run).items()},
                          {k: v for k, v in launches().items() if v},
                          mesh.ledger.snapshot())
            add_counts(total, runs[name][2])
            del run
        finally:
            if name == "nccl world 1":
                torch.distributed.destroy_process_group()
            shutil.rmtree(tmp)
    (a, sa, la, _), (b, sb, lb, ledger) = runs["one card"], \
        runs["nccl world 1"]
    require(a["losses"].tobytes() == b["losses"].tobytes(),
            f"phase 21: nccl world 1 losses {b['losses']} differ from the "
            f"one-card path's {a['losses']}")
    require(all(torch.equal(sa[k], sb[k]) for k in sa) and
            a["stats"] == b["stats"] and la == lb,
            "phase 21: nccl world 1 cache state, hit counts or launches "
            "differ from the one-card path's")
    steps = MULTI_WARM + MULTI_MEAS
    require(ledger["calls"].get("grad") == steps and
            ledger["calls"].get("control", 0) >= steps,
            f"phase 21: nccl world 1 ran no collectives: {ledger}")
    print(f"phase 21: NCCL at world 1 (process group, the data-parallel "
          f"step's all-reduce and the miss decision's) bitwise the one-card "
          f"path over {steps} steps: losses, cache state, hit counts "
          f"{b['stats']}, launches {lb}; collectives {ledger['calls']}")

    # the CPU ranks run beside the card's (their own process group)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        on_cpu = pool.submit(multihost.launch, multi_rank, 2, ["cpu", "cpu"],
                             "gloo", args=(ds, False))
        card = multihost.launch(multi_rank, 2, ["cuda:0", "cuda:0"], "gloo",
                                args=(ds, True))
        t1 = time.perf_counter()
        cpu = on_cpu.result()
    print(f"phase 21: 2 ranks on cuda:0 over gloo in {t1 - t0:.1f} s, the "
          f"CPU comparison (2 ranks, gloo, at the same time) in "
          f"{time.perf_counter() - t0:.1f} s (process start and set-up "
          "included)")
    add_counts(total, check_multi(card, cpu, "gloo 2 ranks on 1 card", smi,
                                  "gloo"))
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        nccl = multihost.launch(multi_rank, 2, ["cuda:0", "cuda:1"], "nccl",
                                args=(ds, True))
        add_counts(total, check_multi(nccl, cpu, "nccl 2 cards", smi,
                                      "nccl"))
    else:
        print(f"phase 21: multi-rank NCCL not run: this machine has "
              f"{n_cards} card, and NCCL takes one rank per card")
    return total


MRES_MB = 97            # cache MB per rank: phase 6's pressure cache
MRES_WARM, MRES_MEAS = 1 + K, 2 * K   # the run's first step + 1 window; 2
MRES_ROWS = (  # cache mode, --shard_topology, --quantize
    ("sharded", False, False), ("sharded", True, False),
    ("node_local", False, False), ("node_local", True, False),
    ("isolated", False, False), ("isolated", True, False),
    ("sharded", True, True))
MRES_SMALL_STEPS = 9    # the small card-vs-CPU runs: first step + 2 x 4
MESH_NODES, MESH_MB = 200_000, 20   # phase 22(d): the mesh leg cut in scale


def mres_name(row) -> str:
    mode, topo, quant = row
    return mode + (" --shard_topology" if topo else "") + (
        " --quantize" if quant else "")


def mres_small_args(row, device: str) -> list:
    """The small card-vs-CPU run of a phase 22 row: 600 nodes of 512-wide
    rows (a 1 MB cache per rank evicts), fanout = the graph's max
    in-degree (every in-edge taken, whatever the generators draw), batch
    16, windows of 4, Adam 1e-2; the row's mode and flags."""
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph

    mode, topo, quant = row
    fanout = int(synthetic_graph(num_nodes=600, avg_degree=4, feature_dim=8,
                                 num_classes=4, seed=0
                                 ).graph.in_degrees().max())
    return cli_args("sage", device, num_nodes=600, feature_dim=512,
                    hidden_channels=8, num_classes=4, avg_degree=4,
                    fan_out=f"{fanout},{fanout}", batch_size=16,
                    cache_size=1, learning_rate=0.01, pipeline="resident",
                    window=4, cache_backend=mode, shard_topology=topo,
                    quantize=quant)


def mres_rank(mesh, ds, measure: bool) -> list:
    """Phase 22(b)'s rank body (``multihost.launch``): per row of
    ``MRES_ROWS``, with ``measure``, the resident CLI's SAGE at the
    flagship widths on this rank's mesh (``multi_mesh``), a ``MRES_MB``
    cache per rank, ``--window 8``: ``MRES_WARM`` warm-up + ``MRES_MEAS``
    measured steps at dropout 0.5, recording the measured steps' launches,
    ledger, stats, time, edges, stage rows, host-gather seconds and replay;
    on the first row every rank runs one real step's begin / resolve
    (collective) and rank 0 holds its kernel calls against their plain
    versions. Then the row's small run at dropout 0 (``mres_small_args``):
    its losses, stats, ledger and eval."""
    import torch

    from coala_gnn_tpu_torch import train as cli

    dev = str(mesh.device)
    out = []
    for i, row in enumerate(MRES_ROWS):
        mode, topo, quant = row
        rec = {"row": row}
        m = multi_mesh(mesh, mode)
        if measure:
            args = cli.parse_args(cli_args(
                "sage", device=dev, pipeline="resident", cache_size=MRES_MB,
                window=K, cache_backend=mode, shard_topology=topo,
                quantize=quant))
            run = cli.build(args, ds=ds, mesh=m)
            rt = run.trainer
            warm = cli.train(run, epochs=1, max_steps=MRES_WARM)
            sync(torch, mesh.device)
            reset_launches()
            m.ledger.reset()
            rt.timers.reset()
            rt.timers.tallies.clear()
            meas = cli.train(run, epochs=1, max_steps=MRES_MEAS)
            sync(torch, mesh.device)
            rec.update(
                losses=np.concatenate([warm["losses"], meas["losses"]]),
                launches={k: v for k, v in launches().items() if v},
                ledger=m.ledger.snapshot(), stats=meas["stats"][0],
                dt=meas["epoch_s"][0], edges=meas["edges"],
                stage_rows=rt.timers.tallies.get("stage_rows", 0.0),
                host_gather=rt.timers.totals.get("host_gather", 0.0),
                replay="replay" in rt.timers.totals,
                on_card=on_card_cli(torch, run) and rt.g.indices.is_cuda,
                shard_edges=int(rt.g.indices.shape[0]),
                route=run.cache.n_route)
            if i == 0:
                calls = resident_step_calls(torch, run)
                if mesh.rank == 0:
                    rec["kernels"] = step_kernels(
                        torch, f"phase 22 rank 0 {mres_name(row)}", calls)
            del run, rt
            torch.cuda.empty_cache()
        run = cli.build(cli.parse_args(mres_small_args(row, dev)), mesh=m)
        run.model.dropout = 0.0
        m.ledger.reset()
        small = cli.train(run, epochs=1, max_steps=MRES_SMALL_STEPS)
        rec.update(small=small["losses"], small_stats=small["stats"][0],
                   small_ledger=m.ledger.snapshot(),
                   small_eval=cli.evaluate(run),
                   small_replay="replay" in run.trainer.timers.totals)
        del run
        out.append(rec)
    return out


def check_mres(card: list, cpu: list, smi: str) -> tuple:
    """Phase 22(b)'s checks and prints over the card ranks' records and
    the CPU ranks'; returns (launches summed over ranks and rows, the
    kernel entries of rank 0's real step)."""
    total = {}
    want = {k: v * MRES_MEAS for k, v in RESIDENT_PER_STEP["sage"].items()}
    for i, row in enumerate(MRES_ROWS):
        name = mres_name(row)
        for r, rank in enumerate(card):
            rec, host = rank[i], cpu[r][i]
            what = f"phase 22 {name} rank {r}"
            losses = rec["losses"]
            q = losses.size // 4
            require(np.isfinite(losses).all() and
                    losses[-q:].mean() < losses[:q].mean(),
                    f"{what}: losses not finite and falling {losses}")
            require(not rec["replay"] and not rec["small_replay"] and
                    not host["small_replay"], f"{what}: a window replayed")
            require(rec["launches"] == want, f"{what}: launches "
                    f"{rec['launches']}, expected {want}")
            require(rec["on_card"], f"{what}: state off the card")
            require(0 < rec["stats"]["hit_ratio"] < 1 and
                    rec["stage_rows"] > 0, f"{what}: not staged under "
                    f"pressure: {rec['stats']}, {rec['stage_rows']} rows")
            require(("topology" in rec["ledger"]["handed"]) == row[1] and
                    (rec["shard_edges"] < N_NODES * 15) == row[1],
                    f"{what}: topology {rec['ledger']['handed']}, "
                    f"{rec['shard_edges']} edges on the card")
            np.testing.assert_allclose(rec["small"], host["small"],
                                       rtol=SMALL_RTOL, atol=SMALL_ATOL,
                                       err_msg=what + " vs the CPU ranks")
            require(rec["small_stats"] == host["small_stats"] and
                    rec["small_ledger"] == host["small_ledger"] and
                    rec["small_eval"] == host["small_eval"],
                    f"{what}: hit counts, ledger or eval differ from the "
                    f"CPU ranks': {rec['small_stats']} vs "
                    f"{host['small_stats']}")
            add_counts(total, rec["launches"])
        rec = card[0][i]
        st, led = rec["stats"], rec["ledger"]
        per = {p: (led["handed"].get(p, 0) - led["kept"].get(p, 0))
               / MRES_MEAS for p in ("request", "response", "hitbits",
                                     "fill", "topology", "probe", "grad")}
        diff = max(np.abs(rank[i]["small"] - c[i]["small"]).max()
                   for rank, c in zip(card, cpu))
        print(f"phase 22: gloo 2 ranks on 1 card, resident {name} (CLI "
              f"--devices 2 --pipeline resident --cache_size {MRES_MB} "
              f"--window {K}, route {rec['route']}): "
              f"{1000 * rec['dt'] / MRES_MEAS:.3f} ms/step, "
              f"train_edges_per_s_per_card "
              f"{rec['edges'] / 2 / rec['dt']:.1f} (rank 0; "
              f"{MRES_MEAS} measured steps after {MRES_WARM}, host clock, "
              f"backend gloo, {smi}); hit ratio {st['hit_ratio']:.4f} "
              f"({st['hits']} hits / {st['misses']} misses, both ranks); "
              f"stage rows per window {rec['stage_rows'] / 2:.0f}, host "
              f"gather {1000 * rec['host_gather'] / 2:.1f} ms per window "
              f"per rank; edges on rank 0's card {rec['shard_edges']}; "
              f"bytes leaving rank 0 per step by phase "
              f"{ {k: round(v) for k, v in per.items() if v} }; losses "
              f"rank 0 {np.array2string(rec['losses'][::3], precision=4)}; "
              f"small runs vs the CPU ranks: max diff {diff:.3g}, hit "
              f"counts, ledger and eval equal")
    return total, card[0][0]["kernels"]


def phase_multi_resident(torch, ds, smi) -> tuple:
    """Phase 22: the resident pipeline over ranks (module docstring).
    Returns (launches by kernel, the worst error of the f32 forward)."""
    import os

    from coala_gnn_tpu_torch import entry
    from coala_gnn_tpu_torch import reference_scale as rs
    from coala_gnn_tpu_torch import train as cli
    from coala_gnn_tpu_torch.parallel import multihost
    from coala_gnn_tpu_torch.parallel.mesh import make_mesh

    # (a) an NCCL group of one rank with --shard_topology (a no-op there)
    # against the one card on its own
    total, runs = {}, {}
    steps = 1 + 3 * K
    for name in ("one card", "nccl world 1"):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
        try:
            flags = dict(pipeline="resident", cache_size=MRES_MB, window=K)
            if name == "nccl world 1":
                multihost.initialize_distributed(
                    "nccl", f"file://{tmp}/store", 1, 0)
                flags["shard_topology"] = True
            mesh = make_mesh("cuda:0")
            run = cli.build(cli.parse_args(cli_args("sage", **flags)), ds=ds,
                            mesh=mesh)
            torch.cuda.synchronize()
            reset_launches()
            out = cli.train(run, epochs=1, max_steps=steps)
            torch.cuda.synchronize()
            runs[name] = (out, {k: v.cpu() for k, v in
                                cache_state(run).items()},
                          {k: v for k, v in launches().items() if v},
                          mesh.ledger.snapshot())
            add_counts(total, runs[name][2])
            del run
        finally:
            if name == "nccl world 1":
                torch.distributed.destroy_process_group()
            shutil.rmtree(tmp)
    (a, sa, la, _), (b, sb, lb, ledger) = runs["one card"], \
        runs["nccl world 1"]
    require(a["losses"].tobytes() == b["losses"].tobytes(),
            f"phase 22: nccl world 1 losses {b['losses']} differ from the "
            f"one-card run's {a['losses']}")
    require(all(torch.equal(sa[k], sb[k]) for k in sa) and
            a["stats"] == b["stats"] and la == lb,
            "phase 22: nccl world 1 cache state, hit counts or launches "
            "differ from the one-card run's")
    require(ledger["calls"].get("grad", 0) == steps and
            "topology" not in ledger["calls"],
            f"phase 22: nccl world 1 collectives {ledger['calls']}")
    print(f"phase 22: resident CLI in an NCCL group of one rank with "
          f"--shard_topology (a no-op there) bitwise the one-card run over "
          f"{steps} steps ({MRES_MB} MB, --window {K}): losses, cache "
          f"state, hit counts {b['stats']}, launches {lb}; collectives "
          f"{ledger['calls']}")

    # (b) two ranks on the card over gloo, two CPU ranks beside them
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        on_cpu = pool.submit(multihost.launch, mres_rank, 2, ["cpu", "cpu"],
                             "gloo", args=(None, False), timeout=600)
        card = multihost.launch(mres_rank, 2, ["cuda:0", "cuda:0"], "gloo",
                                args=(ds, True), timeout=600)
        t1 = time.perf_counter()
        cpu = on_cpu.result()
    print(f"phase 22: 2 ranks on cuda:0 over gloo in {t1 - t0:.1f} s, the "
          f"CPU ranks (2, gloo, at the same time) in "
          f"{time.perf_counter() - t0:.1f} s (start and set-up included)")
    counts, kernels = check_mres(card, cpu, smi)
    add_counts(total, counts)
    err = kernels[("gather_spmm[float32]", 0)]["max_abs_err"]

    # (c) dryrun_multichip(2) on gloo ranks on the card
    t0 = time.perf_counter()
    got = entry.dryrun_multichip(2, "cuda", devices=["cuda:0", "cuda:0"],
                                 backend="gloo", timeout=600)
    print(f"phase 22: dryrun_multichip(2) on 2 gloo ranks on the card in "
          f"{time.perf_counter() - t0:.1f} s: host hit ratio "
          f"{got['host']['hit_ratio']:.4f}, window {got['window']}, "
          f"sharded topology {got['edges_per_rank']} of the graph's edges "
          f"on rank 0, node_local {got['node_local']}")

    # (d) reference_scale.py --mesh at 2 ranks, cut in scale
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        path = os.path.join(tmp, "refscale")
        t0 = time.perf_counter()
        meta = rs.generate(path, MESH_NODES, 15, 1024, 19, 2048, 0.9, 0)
        rec = rs.run_mesh(path, 2, BATCH // 4, "10,5", HIDDEN, MESH_MB,
                          window=4, windows=2, devices=["cuda:0", "cuda:0"],
                          backend="gloo", timeout=600)
        require(rec["shard_topology"] and
                sum(rec["edges_per_rank"]) == meta["num_edges"] and
                np.isfinite(rec["loss_first_last"]).all() and
                0 < rec["hit_stats"]["hit_ratio"] < 1,
                f"phase 22 reference_scale --mesh: {rec}")
        print(f"phase 22: reference_scale --mesh --ranks 2 (cut: "
              f"{MESH_NODES} of 10M nodes, {MESH_MB} MB a rank; dim 1024, "
              f"fanout 10,5, batch {BATCH // 4}, windows of 4 as the JAX "
              f"leg; gloo on one card) in {time.perf_counter() - t0:.1f} s "
              f"with generate; record " + json.dumps(rec))
    finally:
        shutil.rmtree(tmp)
    return total, err


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

    from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
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
    t0 = time.perf_counter()
    host_launches, host_errs = phase_host(torch, ds, smi)
    for name, err in host_errs.items():
        worst(name, err)
    print(f"phase 10: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bf16_launches, bf16_errs = phase_bf16(torch, ds, store, smi)
    for name, err in bf16_errs.items():
        worst(name, err)
    phase_small(torch, model_dtype=torch.bfloat16, label="phase 14")
    print(f"phase 11-14: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hetero_launches, hetero_entries = phase_hetero(torch, ds, smi)
    print(f"phase 15: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    resident_launches, resident_errs, resident_entries = phase_resident(
        torch, ds, smi)
    for name, err in resident_errs.items():
        worst(name, err)
    print(f"phase 16: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    port_launches, port_errs, port_entries = phase_ports(torch, ds, store,
                                                         smi)
    for name, err in port_errs.items():
        worst(name, err)
    print(f"phase 17: done in {time.perf_counter() - t0:.1f} s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    try:
        t0 = time.perf_counter()
        data_launches, data_entries_ = phase_data(torch, smi, tmp)
        print(f"phase 18: done in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ref_launches, ref_errs = phase_refscale(torch, smi, tmp)
        for name, err in ref_errs.items():
            worst(name, err)
        print(f"phase 19: done in {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp)
    t0 = time.perf_counter()
    entry_launches = phase_entry(torch, smi)
    print(f"phase 20: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    multi_launches = phase_multi(torch, ds, smi)
    print(f"phase 21: done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mres_launches, err22 = phase_multi_resident(torch, ds, smi)
    worst("gather_spmm[float32]", err22)
    print(f"phase 22: done in {time.perf_counter() - t0:.1f} s")
    for counts in (gat_launches, int8_launches, host_launches,
                   bf16_launches, hetero_launches, resident_launches,
                   port_launches, data_launches, ref_launches,
                   entry_launches, multi_launches, mres_launches):
        for name, n in counts.items():
            main_launches[name] = main_launches.get(name, 0) + n

    src = "coala_gnn_tpu_torch/csrc/gather_spmm.cu"
    replaces = {"gather_spmm[float32]": "coala_gnn_tpu/ops/pallas_spmm.py:82",
                "gather_spmm[bfloat16]":
                    "coala_gnn_tpu/ops/pallas_gather.py:77",
                "gather_spmm[int8]": "coala_gnn_tpu/ops/pallas_spmm.py:82",
                "gather_spmm[float32_as_bf16]":
                    "coala_gnn_tpu/ops/pallas_spmm.py:82",
                "gather_spmm[int8_as_bf16]":
                    "coala_gnn_tpu/ops/pallas_spmm.py:82",
                "gather_spmm_grad_w": "coala_gnn_tpu/models/layers.py:143",
                "gather_spmm_grad_w[bfloat16]":
                    "coala_gnn_tpu/models/layers.py:143",
                "gather_spmm_grad_x": "coala_gnn_tpu/models/layers.py:143",
                "adj_transpose": "coala_gnn_tpu/models/layers.py:143"}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": where, "launches": main_launches[name],
                **kern[name]} for name, where in replaces.items()]
    kernels += [{"route": "cuda", "source": src,
                 "replaces": replaces[e["counter"]], **e}
                for e in hetero_entries + resident_entries + port_entries
                + data_entries_]
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
