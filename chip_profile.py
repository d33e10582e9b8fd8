"""Device profile of one training window of the port on one CUDA card.

    python3 chip_profile.py [sage|gcn|gat ...]      (default: gat)

For each model type: builds ``chip_smoke.py``'s trainer at the flagship
config (200k-node synthetic graph, feature dim 256, hidden 256, fanout
[10, 5], batch 1024, flat f32 table at full coverage, Adam 1e-3; GAT with
4 heads), trains one K = 8 warm-up window, then traces one K = 8 window
with ``torch.profiler`` and prints:

  - host wall time of the traced window (profiler on);
  - device busy time: the union of the intervals of every device event
    (kernels and copies; user annotations such as ``Optimizer.step#...``
    dropped), per step, and the idle share 1 - busy / wall;
  - the gather-SpMM kernels' (forward, grad_w, grad_x) share of the summed
    device time, each kernel's time, and the 14 largest device events.

Needs one card; exits with a non-zero code without one.
"""

from __future__ import annotations

import sys
import time

import numpy as np

STEPS = 8
OURS = ("gather_spmm_kernel", "grad_w_kernel", "grad_x_kernel")


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


def profile_window(torch, rt, grid) -> tuple:
    """(host wall seconds, device events) of one traced window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.train_windows(grid, seed=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and "#" not in e.name and not e.name.startswith("ProfilerStep")]
    return wall, events


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from coala_gnn_tpu.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu.graph.datasets import synthetic_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.smi_string()
    print(f"card: {smi}")
    ds = synthetic_graph(num_nodes=cs.N_NODES, avg_degree=15,
                         feature_dim=cs.DIM, num_classes=cs.CLASSES, seed=0)
    store = HostFeatureStore(ds.features, use_native=False)
    rng = np.random.default_rng(0)
    for model_type in sys.argv[1:] or ["gat"]:
        rt = cs.make_trainer(torch, ds, store, torch.float32, "cuda",
                             model_type=model_type)
        rt.train_windows(cs.make_grids(ds, 1, STEPS, cs.BATCH, rng), seed=0)
        torch.cuda.synchronize()
        wall, events = profile_window(
            torch, rt, cs.make_grids(ds, 1, STEPS, cs.BATCH, rng))
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
