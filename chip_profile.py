"""Device profile of one training window of the port on one CUDA card.

    python3 chip_profile.py [sage|gcn|gat|sage-bf16|gat-bf16|sage-nbr32|
                             step|step-dedup|
                             rsage|rgcn|rgat|cli-sage|cli-gat|
                             cli-resident-sage|cli-resident-rgat ...]
                                                    (default: gat)

For each row: builds ``chip_smoke.py``'s trainer at the flagship config
(200k-node synthetic graph, feature dim 256, hidden 256, fanout [10, 5],
batch 1024, flat table at full coverage, Adam 1e-3; GAT with 4 heads),
trains one K = 8 warm-up window, then traces one K = 8 window with
``torch.profiler`` and prints:

  - host wall time of the traced window (profiler on);
  - device busy time: the union of the intervals of every device event
    (kernels and copies; user annotations such as ``Optimizer.step#...``
    dropped), per step, and the idle share 1 - busy / wall;
  - the gather-SpMM kernels' (forward, grad_w, grad_x, and the transpose,
    which a steady window should not launch) share of the summed device
    time, each kernel's time, and the 14 largest device events.

    python3 chip_profile.py --turns ROW ROW ...

times the rows' K = 8 windows instead, without the profiler, in turns on
one card (a b b a, three rounds, each trainer built and warmed first;
host clock ending in a synchronize) and prints each row's ms/step per
window and their median: the way to compare rows whose ms/step spreads
~2x between calls.

The rows: sage, gcn and gat on the f32 table with an f32 model;
sage-bf16 is ``chip_smoke.py``'s resident-bf16 (bf16 table, bf16 model)
and gat-bf16 its phase 12 (f32 table, bf16 model); sage-nbr32 samples
from the padded neighbour table (``nbr_cap=32``, phase 17). step and
step-dedup are ``ResidentTrainer``'s per-step path (``begin`` /
``resolve`` / ``train_step``, SAGE at full coverage) with ``dedup=False``
and ``dedup=True`` (phase 17): one warm-up round of 8 steps, then 8
traced steps. rsage, rgcn and rgat
are the trainer CLI's hetero models as ``chip_smoke.py``'s phase 15 runs
them (``train.build`` on the 200k-node graph with 3 edge types, the 1024
MB cache front): one warm-up epoch of 8 steps, then one traced epoch of 8
steps of the CLI's loop (``train.train``: its loader, fetches and steps;
the epoch's wall time, as the CLI prints it, includes the loader's first
batch); ``cli-MODEL`` (cli-sage, cli-gcn, cli-gat) is a homogeneous
model through the same loop, beside them. ``cli-resident-MODEL``
(cli-resident-sage, cli-resident-rgat, any model) is the CLI's
``--pipeline resident --window 8`` as ``chip_smoke.py``'s phase 16 runs
it: one warm-up epoch of 8 steps, then one traced epoch of one window of
8.

    python3 chip_profile.py --against OTHER_CHECKOUT ROW ...

times the same f32 rows of this checkout and of OTHER_CHECKOUT (an older
tree, unpacked with ``git archive``) in turns: one process per turn,
other, this, this, other, each importing its own checkout's package and
``chip_smoke.py``; per turn the resident rows (sage, gcn, gat) train three
K = 8 windows after a warm-up one, and host-packed is one ``run_host`` of
``chip_smoke.py``'s phase 10 (4 + 16 steps, 1024 MB cache). Prints each
side's ms/step per window and the medians, and a JSON line.

Needs one card; exits with a non-zero code without one.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

STEPS = 8
#: row -> (model type, table dtype, model dtype), dtypes by torch name
ROWS = {"sage": ("sage", "float32", "float32"),
        "gcn": ("gcn", "float32", "float32"),
        "gat": ("gat", "float32", "float32"),
        "sage-bf16": ("sage", "bfloat16", "bfloat16"),
        "gat-bf16": ("gat", "float32", "bfloat16"),
        "sage-nbr32": ("sage", "float32", "float32", {"nbr_cap": 32})}
#: rows of ResidentTrainer's per-step path (begin / resolve / train_step
#: per step, SAGE, flat f32 table at full coverage) -> its ``dedup``
STEP_ROWS = {"step": False, "step-dedup": True}
#: the ``__global__`` functions of the gather-SpMM source, which a trace
#: names by substring
OURS = tuple(re.findall(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
    open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "coala_gnn_tpu_torch", "csrc", "gather_spmm.cu")).read()))


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile_window(torch, run_steps) -> tuple:
    """(host wall seconds, device events) of one traced call of
    ``run_steps`` (one window or one CLI epoch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_steps()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and "#" not in e.name and not e.name.startswith("ProfilerStep")]
    return wall, events


def make_row(torch, cs, ds, store, row):
    kind, table, model, *kw = ROWS[row]
    return cs.make_trainer(torch, ds, store, getattr(torch, table), "cuda",
                           model_type=kind, model_dtype=getattr(torch, model),
                           **(kw[0] if kw else {}))


def per_step(rt, grid, seed: int) -> None:
    """The steps of ``grid`` [K, B] through ``rt``'s per-step path, each
    on its own (seed, step) streams."""
    from coala_gnn_tpu_torch.utils.rng import DROPOUT, SAMPLE, \
        step_generators

    for i, seeds in enumerate(grid):
        g_s = step_generators(seed, i, 1, SAMPLE, "cuda")[0]
        g_d = step_generators(seed, i, 1, DROPOUT, "cuda")[0]
        rt.train_step(rt.resolve(rt.begin(seeds, g_s)), g_d)


def time_turns(torch, cs, ds, store, rows, rng, rounds: int = 3) -> None:
    """ms/step of each row's K = STEPS windows, in turns (a b b a per
    round) after one warm-up window each."""
    trainers = {}
    for row in rows:
        trainers[row] = make_row(torch, cs, ds, store, row)
        trainers[row].train_windows(cs.make_grids(ds, 1, STEPS, cs.BATCH,
                                                  rng), seed=0)
    torch.cuda.synchronize()
    times = {row: [] for row in rows}
    for r in range(rounds):
        for row in rows + rows[::-1]:
            grid = cs.make_grids(ds, 1, STEPS, cs.BATCH, rng)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses, _ = trainers[row].train_windows(grid, seed=r + 1)
            torch.cuda.synchronize()
            times[row].append(1000 * (time.perf_counter() - t0) / STEPS)
            cs.require(bool(torch.isfinite(losses).all()),
                       f"{row}: non-finite loss")
    for row in rows:
        print(f"turns {row}: ms/step per window "
              f"{[round(t, 3) for t in times[row]]}, median "
              f"{float(np.median(times[row])):.3f}")


def child_times(torch, cs, ds, store, rows, rng, rounds: int = 3) -> dict:
    """ms/step of each f32 row in this process's checkout: ``rounds`` K =
    STEPS windows after a warm-up one (resident rows), or one host-packed
    run_host (the measured steps after its warm-up)."""
    out = {}
    for row in rows:
        if row == "host-packed":
            from coala_gnn_tpu_torch.parallel.host_pipeline import run_host

            r = run_host(ds, cs.BATCH, cs.FANOUTS, cs.DIM, cs.HIDDEN,
                         cache_mb=1024, bf16=False, warmup=4, steps=16,
                         tag=row, device="cuda")
            cs.require(bool(np.isfinite(r["losses"]).all()),
                       f"{row}: non-finite loss")
            out[row] = [r["ms_per_step"]]
            continue
        kind, table, model, *_ = ROWS[row]
        cs.require(table == model == "float32", f"{row}: --against times "
                   "the f32 rows, which both checkouts run")
        rt = cs.make_trainer(torch, ds, store, torch.float32, "cuda",
                             model_type=kind)
        rt.train_windows(cs.make_grids(ds, 1, STEPS, cs.BATCH, rng), seed=0)
        out[row] = []
        for r in range(rounds):
            grid = cs.make_grids(ds, 1, STEPS, cs.BATCH, rng)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses, _ = rt.train_windows(grid, seed=r + 1)
            torch.cuda.synchronize()
            out[row].append(1000 * (time.perf_counter() - t0) / STEPS)
            cs.require(bool(torch.isfinite(losses).all()),
                       f"{row}: non-finite loss")
        del rt
    return out


def against(other: str, rows) -> int:
    """The f32 rows of OTHER_CHECKOUT and of this one in turns, one process
    per turn (other, this, this, other)."""
    here = os.path.dirname(os.path.abspath(__file__))
    times = {"other": {r: [] for r in rows}, "this": {r: [] for r in rows}}
    for side, path in (("other", other), ("this", here), ("this", here),
                       ("other", other)):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", os.path.abspath(path), *rows],
                           capture_output=True, text=True, timeout=1200)
        if p.returncode:
            print(p.stdout[-3000:] + p.stderr[-3000:], file=sys.stderr)
            return p.returncode
        for row, ts in json.loads(p.stdout.strip().splitlines()[-1]).items():
            times[side][row].extend(ts)
    for row in rows:
        med = {k: float(np.median(times[k][row])) for k in times}
        shown = {k: [round(t, 3) for t in times[k][row]] for k in times}
        print(f"against {row}: other ms/step {shown['other']} median "
              f"{med['other']:.3f}; this {shown['this']} median "
              f"{med['this']:.3f}; this / other "
              f"{med['this'] / med['other']:.3f}")
    print(json.dumps({"other": os.path.abspath(other), "ms_per_step": times}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    args = sys.argv[1:]
    if args[:1] == ["--against"]:
        return against(args[1], args[2:])
    if args[:1] == ["--child"]:           # one turn of --against
        sys.path.insert(0, args[1])
    import chip_smoke as cs
    from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.smi_string()
    print(f"card: {smi}")
    ds = synthetic_graph(num_nodes=cs.N_NODES, avg_degree=15,
                         feature_dim=cs.DIM, num_classes=cs.CLASSES, seed=0)
    store = HostFeatureStore(ds.features, use_native=False)
    rng = np.random.default_rng(0)
    if args[:1] == ["--child"]:
        print(json.dumps(child_times(torch, cs, ds, store, args[2:], rng)))
        return 0
    if args[:1] == ["--turns"]:
        time_turns(torch, cs, ds, store, args[1:], rng)
        return 0
    for model_type in args or ["gat"]:
        if model_type in cs.HETERO_KINDS or model_type.startswith("cli-"):
            from coala_gnn_tpu_torch import train as cli

            kind = model_type.removeprefix("cli-")
            flags = {}
            if kind.startswith("resident-"):
                kind = kind.removeprefix("resident-")
                flags = dict(pipeline="resident", window=STEPS)
            rt = cli.build(cli.parse_args(cs.cli_args(kind, **flags)),
                           ds=ds)
            cli.train(rt, epochs=1, max_steps=STEPS)
            run_steps = lambda: cli.train(rt, epochs=1, max_steps=STEPS)
        elif model_type in STEP_ROWS:
            rt = cs.make_trainer(torch, ds, store, torch.float32, "cuda",
                                 dedup=STEP_ROWS[model_type])
            per_step(rt, cs.make_grids(ds, 1, STEPS, cs.BATCH, rng)[0], 0)
            grid = cs.make_grids(ds, 1, STEPS, cs.BATCH, rng)[0]
            run_steps = lambda: per_step(rt, grid, 1)
        else:
            rt = make_row(torch, cs, ds, store, model_type)
            rt.train_windows(cs.make_grids(ds, 1, STEPS, cs.BATCH, rng),
                             seed=0)
            grid = cs.make_grids(ds, 1, STEPS, cs.BATCH, rng)
            run_steps = lambda: rt.train_windows(grid, seed=1)
        torch.cuda.synchronize()
        wall, events = profile_window(torch, run_steps)
        cs.require(bool(events), f"{model_type}: the trace holds no device "
                                 "event")
        busy = busy_us((e.time_range.start, e.time_range.end)
                       for e in events)
        total = sum(e.time_range.end - e.time_range.start for e in events)
        by_name: dict = {}
        for e in events:
            by_name[e.name] = (by_name.get(e.name, 0.0) + e.time_range.end
                               - e.time_range.start)
        ours = {k: v for k, v in by_name.items()
                if any(t in k for t in OURS)}
        print(f"{model_type}: {STEPS} steps, wall {1000 * wall:.2f} ms "
              f"(profiler on), device busy {busy / 1000:.3f} ms = "
              f"{busy / 1000 / STEPS:.3f} ms/step, idle share "
              f"{1 - busy / (1e6 * wall):.4f}; device event sum "
              f"{total / 1000:.3f} ms over {len(events)} events ({smi})")
        for k, v in sorted(ours.items(), key=lambda kv: -kv[1]):
            print(f"  gather-SpMM {v / 1000:.4f} ms "
                  f"({100 * v / total:.2f}% of device time) {k[:100]}")
        print(f"  gather-SpMM total {sum(ours.values()) / 1000:.4f} ms = "
              f"{100 * sum(ours.values()) / total:.2f}% of device time")
        for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:14]:
            print(f"  top {v / 1000:.4f} ms {k[:100]}")
        del rt
    return 0


if __name__ == "__main__":
    sys.exit(main())
