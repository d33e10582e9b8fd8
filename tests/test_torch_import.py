"""The port runs where there is no JAX: in a fresh interpreter with jax,
flax, optax and ml_dtypes blocked, every module of coala_gnn_tpu_torch and
chip_smoke.py and chip_profile.py import, and a tiny ResidentTrainer trains one window at full
coverage and staged windows under pressure with bf16 and int8 transport
(fused native and gather + encode stores)."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("jax", "flax", "optax", "ml_dtypes"):
    sys.modules[name] = None
import torch
torch.set_num_threads(1)
import numpy as np
import coala_gnn_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(coala_gnn_tpu_torch.__path__,
                                               "coala_gnn_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import chip_profile
from coala_gnn_tpu.cache.host_tier import HostFeatureStore
from coala_gnn_tpu.graph.datasets import synthetic_graph
ds = synthetic_graph(num_nodes=200, avg_degree=4, feature_dim=8,
                     num_classes=4, seed=0)
rt = chip_smoke.make_trainer(torch, ds, HostFeatureStore(ds.features,
                             use_native=False), torch.float32, "cpu",
                             fanouts=[3, 2], batch=8, hidden=8)
grids = chip_smoke.make_grids(ds, 1, 2, 8, np.random.default_rng(0))
losses, edges = rt.train_windows(grids, seed=0)
assert torch.isfinite(losses).all() and losses.shape == (2,)
for native in (True, False):
    for transport in ("bfloat16", "int8"):
        rt = chip_smoke.make_trainer(
            torch, ds, HostFeatureStore(ds.features, use_native=native),
            torch.float32, "cpu", fanouts=[3, 2], batch=8, hidden=8,
            cache_mb=0, priorities="degree", stage_transport=transport)
        assert not rt.direct and (rt._store is not None) == native
        losses, edges = rt.train_windows(grids, seed=0)
        assert torch.isfinite(losses).all() and rt.stats()["misses"] > 0
jaxish = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
                and sys.modules[m] is not None)
assert not jaxish, jaxish
print("modules", len(mods))
"""


def test_port_imports_and_trains_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split("modules")[-1])
    assert n >= 12   # ops, models, sampling, cache, parallel, utils modules


def test_profile_busy_time_and_no_card():
    """chip_profile.py's device busy time is the union of the event
    intervals (overlaps counted once, gaps not at all), and without a card
    the script exits with a non-zero code before it builds anything."""
    sys.path.insert(0, ROOT)
    try:
        import chip_profile
    finally:
        sys.path.remove(ROOT)
    assert chip_profile.busy_us([]) == 0.0
    assert chip_profile.busy_us([(5, 9), (0, 2), (1, 3), (8, 10)]) == 8.0
    assert chip_profile.busy_us(iter([(0, 4), (1, 2)])) == 4.0
    if not torch.cuda.is_available():
        assert chip_profile.main() != 0
