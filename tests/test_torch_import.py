"""The port stands alone: in a fresh interpreter with the JAX package
(coala_gnn_tpu) and jax, flax, optax and ml_dtypes blocked, every module of
coala_gnn_tpu_torch and the chip scripts (chip_smoke.py, chip_profile.py,
chip_compare.py) import, a
tiny ResidentTrainer (on the port's own synthetic graph and host store)
trains one window at full coverage and staged windows under pressure with
bf16 and int8 transport (fused native and gather + encode stores), and
the host pipeline runs (``run_host`` under pressure, the CLI with a cache
and eval), and so does the CLI's resident pipeline
(``parallel/sharded_resident.py``) for SAGE and RGCN; the coloring
(``coloring/``, ``generate_colors.py``) writes its metadata, and the
resident CLI trains on the padded table with ``node_color``, saves a
checkpoint (``utils/checkpoint.py``) and resumes from it; the real-dataset
layouts (IGB, its preprocessed form through ``create_csc_graph``,
IGB-hetero) train through the CLI, the reference-scale leg
(``reference_scale``) generates and runs, and ``entry`` runs its forward
and ``dryrun_multichip(1)``; ``bench_ops`` writes its rows at a tiny
CPU size and ``utils.roofline`` reads them into a report;
``dryrun_multichip(2)`` (the resident
pipeline over ranks, the sharded topology, node_local) and the CLI's
data-parallel host loop (``--devices 2``, node_color) train on two
spawned CPU ranks, whose processes start with the same modules blocked (a
``sitecustomize`` on their ``PYTHONPATH``), so a rank that reached for JAX
would fail the run."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
for name in ("coala_gnn_tpu", "jax", "flax", "optax", "ml_dtypes"):
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
import chip_compare
from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
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
from coala_gnn_tpu_torch import train as cli
from coala_gnn_tpu_torch.parallel.host_pipeline import run_host
r = run_host(ds, 8, [3, 2], 8, 8, 1, False, 1, 2, device="cpu",
             prewarm="degree")
assert np.isfinite(r["losses"]).all() and len(r["losses"]) == 3
cli.main(["--device", "cpu", "--num_nodes", "300", "--feature_dim", "8",
          "--batch_size", "8", "--fan_out", "3,2", "--hidden_channels", "8",
          "--max_steps", "2", "--cache_size", "1", "--eval"])
for kind in ("sage", "rgcn"):
    cli.main(["--device", "cpu", "--num_nodes", "300", "--feature_dim", "8",
              "--batch_size", "8", "--fan_out", "3,2", "--hidden_channels",
              "8", "--max_steps", "3", "--cache_size", "1", "--eval",
              "--pipeline", "resident", "--window", "2", "--model_type",
              kind])
import os, shutil, tempfile
from coala_gnn_tpu_torch import generate_colors
from coala_gnn_tpu_torch.coloring import load_color_metadata
from coala_gnn_tpu_torch.utils import checkpoint
tmp = tempfile.mkdtemp()
try:
    colors = os.path.join(tmp, "colors")
    generate_colors.main(["--num_nodes", "300", "--feature_dim", "8",
                          "--out", colors])
    assert load_color_metadata(colors).num_colors > 0
    flags = ["--device", "cpu", "--num_nodes", "300", "--feature_dim", "8",
             "--batch_size", "8", "--fan_out", "3,2", "--hidden_channels",
             "8", "--max_steps", "3", "--cache_size", "1", "--pipeline",
             "resident", "--window", "2", "--nbr_cap", "4",
             "--distribution", "node_color", "--color_dir", colors,
             "--save_dir", os.path.join(tmp, "ck")]
    cli.main(flags)
    cli.main(flags + ["--epochs", "2", "--resume"])
    assert checkpoint.latest_step(os.path.join(tmp, "ck")) == 6
finally:
    shutil.rmtree(tmp)
from coala_gnn_tpu_torch import create_csc_graph, entry, reference_scale
tmp = tempfile.mkdtemp()
try:
    chip_smoke.write_igb_layout(ds, os.path.join(tmp, "igb"))
    create_csc_graph.main([
        "--edge_index", os.path.join(tmp, "igb", "tiny", "processed",
                                     "paper__cites__paper", "edge_index.npy"),
        "--num_nodes", "200", "--out", os.path.join(tmp, "igb",
                                                    "preprocessed")])
    chip_smoke.write_igb_hetero_layout(os.path.join(tmp, "igbh"), 100, 8)
    for data, path, kind in (("igb", "igb", "sage"),
                             ("preprocessed", "igb/preprocessed", "sage"),
                             ("igb-hetero", "igbh", "rgcn")):
        cli.main(["--device", "cpu", "--data", data, "--path",
                  os.path.join(tmp, path), "--num_classes", "19",
                  "--batch_size", "8", "--fan_out", "3,2",
                  "--hidden_channels", "8", "--max_steps", "2",
                  "--cache_size", "1", "--model_type", kind, "--pipeline",
                  "resident", "--window", "2"])
    rs = os.path.join(tmp, "rs")
    reference_scale.generate(rs, 3000, 5, 16, 5, 256, 0.9, 0)
    out = reference_scale.run_single(rs, 1, 16, "3,2", 8, 2, 1, 1, "int8",
                                     device="cpu")
    assert 0 < out["hit_ratio"] < 1 and out["card"] == "cpu"
finally:
    shutil.rmtree(tmp)
fn, fargs = entry.entry("cpu")
assert fn(*fargs).shape == (32, 8)
entry.dryrun_multichip(1, "cpu")
got = entry.dryrun_multichip(2, "cpu", timeout=120)
assert got["node_local"]["hit_ratio"] == 1.0
tmp = tempfile.mkdtemp()
try:
    colors = os.path.join(tmp, "colors")
    generate_colors.main(["--num_nodes", "300", "--feature_dim", "8",
                          "--out", colors])
    ranks = cli.main(["--device", "cpu", "--devices", "2", "--num_nodes",
                      "300", "--feature_dim", "8", "--batch_size", "8",
                      "--fan_out", "3,2", "--hidden_channels", "8",
                      "--max_steps", "3", "--cache_size", "1", "--eval",
                      "--distribution", "node_color", "--color_dir",
                      colors, "--refresh_counter", "1"])
finally:
    shutil.rmtree(tmp)
assert [r["rank"] for r in ranks] == [0, 1]
assert all(np.isfinite(r["losses"]).all() and len(r["losses"]) == 3
           and r["ledger"]["calls"]["grad"] == 3 for r in ranks)
from coala_gnn_tpu_torch import bench_ops
from coala_gnn_tpu_torch.utils import roofline
tmp = tempfile.mkdtemp()
try:
    ops = os.path.join(tmp, "ops.json")
    bench_ops.main(["--device", "cpu", "--iters", "1", "--warmup", "0",
                    "--json", ops])
    peaks = roofline.class_peaks(roofline.op_peaks(ops), 4, 4)
    rep = roofline.report(roofline.step_cost(8, [3, 2], 8, 8, 4), peaks, 1.0)
    assert rep["roofline_pct"] > 0
finally:
    shutil.rmtree(tmp)
jaxish = sorted(m for m in sys.modules
                if m.split(".")[0] in ("coala_gnn_tpu", "jax", "jaxlib",
                                       "flax", "optax", "ml_dtypes")
                and sys.modules[m] is not None)
assert not jaxish, jaxish
print("modules", len(mods))
"""


BLOCKER = """import sys
for name in ("coala_gnn_tpu", "jax", "flax", "optax", "ml_dtypes"):
    sys.modules[name] = None
"""


def test_port_imports_and_trains_without_jax(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(BLOCKER)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path),
                                                       ROOT]))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n = int(proc.stdout.split("modules")[-1])
    assert n >= 12   # ops, models, sampling, cache, parallel, utils modules


def test_profile_busy_time_and_no_card():
    """chip_profile.py's device busy time is the union of the event
    intervals (overlaps counted once, gaps not at all), and without a card
    the script (and chip_compare.py) exits with a non-zero code before it
    builds anything."""
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
        import chip_compare
        assert chip_compare.main() != 0
