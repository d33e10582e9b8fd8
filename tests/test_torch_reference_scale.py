"""The reference-scale leg of the port (``coala_gnn_tpu_torch.
reference_scale``) against ``examples/reference_scale.py`` on the CPU at
a small size:

- ``generate`` writes the JAX script's files bitwise (20k nodes, dim 32;
  meta.json equal but for its two timings);
- ``run_single`` records the JAX script's keys plus ``EXTRA_KEYS``, with
  finite losses and a hit ratio in (0, 1), both reading the same files;
- the leg's trainer (``make_trainer``: degree priorities, int8 stage
  transport, the degree-top prewarm, the JAX script's one per-step batch
  before the windows) at dropout 0 and fanout = max in-degree, JAX's
  params converted, against JAX's ``ResidentTrainer`` built as the JAX
  script builds it on the same loaded graph: window losses at 1e-5;
- ``--mesh`` over two CPU ranks records the JAX script's mesh keys plus
  ``MESH_EXTRA_KEYS``;
- the flat probe's host dedup (a node bitmap) gives ``np.unique``'s ids,
  and a stage buffer grows once, with headroom, not every window."""

import json
import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.cache.host_tier import HostFeatureStore as JaxStore
from coala_gnn_tpu.graph.datasets import load_preprocessed as jax_load
from coala_gnn_tpu.models import make_model as jax_make_model
from coala_gnn_tpu.models.layers import DeviceBlock as JBlock
from coala_gnn_tpu.parallel.resident import ResidentTrainer as JaxTrainer
from coala_gnn_tpu.sampling.neighbor import block_capacities
from coala_gnn_tpu_torch import reference_scale as rs
from coala_gnn_tpu_torch.graph.datasets import load_preprocessed
from coala_gnn_tpu_torch.utils.convert import params_from_flax
from coala_gnn_tpu_torch.utils.rng import SAMPLE, step_generators

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))

import reference_scale as jrs  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
GEN = dict(num_nodes=20_000, avg_degree=15, dim=32, num_classes=19,
           community_size=2048, p_intra=0.9, seed=0)
SMALL = dict(num_nodes=3000, avg_degree=5, dim=32, num_classes=5,
             community_size=256, p_intra=0.9, seed=1)
RUN = dict(cache_mb=1, batch=64, fanout="5,3", hidden=16, window=4,
           windows=2, warm_windows=1, transport="int8")


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """The same graph written by both scripts -> (port dir, JAX dir)."""
    port = str(tmp_path_factory.mktemp("rs_port"))
    theirs = str(tmp_path_factory.mktemp("rs_jax"))
    rs.generate(port, **GEN)
    jrs.generate(theirs, **GEN)
    return port, theirs


def test_generate_writes_the_jax_files(generated):
    port, theirs = generated
    names = sorted(os.listdir(theirs))
    assert names == sorted(os.listdir(port))
    assert {"csc_indptr.npy", "csc_indices.npy", "csc_edge_ids.npy",
            "features.npy", "labels.npy", "train_idx.npy", "val_idx.npy",
            "test_idx.npy", "meta.json"} == set(names)
    for name in names:
        if name == "meta.json":
            continue
        with open(os.path.join(port, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name

    def meta(path):
        with open(os.path.join(path, "meta.json")) as f:
            m = json.load(f)
        return {k: v for k, v in m.items() if not k.startswith("gen_")}
    assert meta(port) == meta(theirs)


@pytest.mark.parametrize("quantize", [False, True])
def test_run_single_records_the_jax_keys(generated, quantize):
    port, theirs = generated
    args = (RUN["cache_mb"], RUN["batch"], RUN["fanout"], RUN["hidden"],
            RUN["window"], RUN["windows"], RUN["warm_windows"],
            RUN["transport"])
    ours = rs.run_single(port, *args, quantize=quantize, device="cpu")
    ref = jrs.run_single(theirs, *args, quantize=quantize)
    assert set(ours) == set(ref) | set(rs.EXTRA_KEYS)
    assert ours["card"] == "cpu"
    for key in ("graph", "cache_mb", "coverage", "batch", "fanout", "window",
                "stage_transport", "measured_steps", "steps_per_epoch",
                "probe_bitmap_mb"):
        assert ours[key] == ref[key], key
    assert 0 < ours["hit_ratio"] < 1
    assert ours["stage_rows_per_window"] > 0
    assert np.isfinite(ours["loss_first_last"]).all()
    assert np.isfinite(ours["warm_loss_first_last"]).all()
    assert ours["warm_loss_first_last"][0] > 0
    assert {"probe_wait", "host_gather", "stage_upload", "window_dispatch",
            "insert_dispatch"} <= set(ours["phase_timers"])


def _max_in_degree(path) -> int:
    return int(np.diff(np.load(os.path.join(path, "csc_indptr.npy"))).max())


def test_leg_trainer_matches_jax_resident_trainer(tmp_path):
    """Dropout 0, fanout = max in-degree (sampling takes every neighbour,
    so neither side's random draws matter), under capacity pressure
    (staged windows, int8 transport, degree priorities)."""
    path = str(tmp_path / "g")
    rs.generate(path, **SMALL)
    f = _max_in_degree(path)
    fanouts, batch, hidden, K = [f, f], 16, 16, 2
    ds, jds = (load_preprocessed(path, num_classes=SMALL["num_classes"]),
               jax_load(path, num_classes=SMALL["num_classes"]))

    rt, cfg = rs.make_trainer(ds, 1, batch, fanouts, hidden, "int8",
                              device="cpu", dropout=0.0)
    assert rt.cache_cfg.capacity < ds.graph.num_nodes     # under pressure
    jm = jax_make_model("sage", hidden=hidden, num_classes=ds.num_classes,
                        num_layers=2, dropout=0.0)
    caps = block_capacities(batch, fanouts)
    params = jm.init(jax.random.key(1),
                     [JBlock(adj=None, mask=jax.numpy.ones((caps[l][0], f)))
                      for l in range(2)],
                     jax.numpy.zeros((caps[0][1], SMALL["dim"])))
    rt.model.load_state_dict(params_from_flax(jax.device_get(params)))
    jrt = JaxTrainer(graph=jds.graph, host_fetch=JaxStore(jds.features).fetch,
                     labels=jds.labels,
                     cache_cfg=jfc.make_config(cache_mb=1, dim=SMALL["dim"],
                                               num_colors=0),
                     model=jm, tx=optax.adam(1e-3), fanouts=fanouts,
                     batch_size=batch, priorities="degree",
                     stage_transport="int8")
    assert jrt.cache_cfg.capacity == cfg.capacity

    rs.prewarm_top(rt, ds)
    deg = np.diff(np.asarray(jds.graph.indptr))
    top = np.argpartition(deg, -cfg.capacity)[-cfg.capacity:]
    jrt.prewarm(top.astype(np.int32))

    rng = np.random.default_rng(0)
    seeds = rng.choice(ds.train_idx, batch, replace=False).astype(np.int32)
    rt.resolve(rt.begin(seeds, step_generators(9, 0, 1, SAMPLE, "cpu")[0]))
    jrt.resolve(jrt.begin(seeds, jax.random.key(9)))
    grids = rng.choice(ds.train_idx, (3, K, batch)).astype(np.int32)
    got, _ = rt.train_windows(grids, seed=0)
    opt_state = jrt.tx.init(params)
    _, _, want, _ = jrt.train_windows(params, opt_state, grids,
                                      jax.random.key(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    s, js = rt.stats(), jrt.stats()
    assert (s["hits"], s["misses"]) == (js["hits"], js["misses"])
    assert 0 < s["hit_ratio"] < 1


def test_mesh_records_the_jax_keys(generated, tmp_path):
    """``--mesh --ranks 2`` on CPU ranks (the sharded topology and cache
    over the ranks, the JAX leg's cuts) writes the JAX script's ``--mesh``
    record keys plus ``MESH_EXTRA_KEYS``; every edge sits on one rank."""
    port, theirs = generated
    out = str(tmp_path / "rs.json")
    art = rs.main(["--path", port, "--mesh", "--ranks", "2", "--device",
                   "cpu", "--cache_mb", "4", "--batch", "256", "--hidden",
                   "16", "--fanout", "5,3", "--out", out])
    ours = art["mesh_2ranks"]
    with open(out) as f:
        assert json.load(f) == art
    ref = jrs.run_mesh(theirs, 64, "5,3", 16, 1, window=4, windows=2)
    assert set(ours) == set(ref) | set(rs.MESH_EXTRA_KEYS)
    assert ours["devices"] == 2 and ours["shard_topology"] is True
    assert ours["steps"] == ref["steps"] == 8
    assert ours["edges_per_device"] == GEN["num_nodes"] * 15 // 2
    assert sum(ours["edges_per_rank"]) == GEN["num_nodes"] * 15
    assert set(ours["hit_stats"]) == set(ref["hit_stats"])
    assert np.isfinite(ours["loss_first_last"]).all()
    assert ours["backend"] == "gloo" and ours["card"] == "cpu"


def test_flat_probe_ids_equal_np_unique(tmp_path):
    """At the leg's scale the probe reads back its flat [K * cap0] form
    (10M + 1 > 4 * 32 * 67,584), which the host deduplicates through a
    node bitmap: the same sorted ids as ``np.unique``."""
    path = str(tmp_path / "g")
    rs.generate(path, **SMALL)
    ds = load_preprocessed(path, num_classes=SMALL["num_classes"])
    rt, _ = rs.make_trainer(ds, 1, 16, [3, 2], 8, "int8", device="cpu")
    rng = np.random.default_rng(5)
    for n in (0, 1, 5000):
        arr = rng.integers(-1, ds.graph.num_nodes, n).astype(np.int32)
        arr[::7] = -1
        got = rt._probe_miss_ids(("flat", torch.from_numpy(arr), None))
        want = np.unique(arr[arr >= 0]).astype(np.int32)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    cap0 = block_capacities(1024, [10, 5])[0][1]
    assert 10_000_000 + 1 > 4 * 32 * cap0


def test_host_scratch_grows_with_headroom():
    """A stage buffer that outgrows its pinned buffer grows once to 1/8
    more than the request, so a window's stage a few percent larger than
    the last one reuses it."""
    from coala_gnn_tpu_torch.parallel.resident import HostScratch

    pool = HostScratch(pin_memory=False)
    a = pool.get("enc", (800, 4), torch.int8)
    pool.get("enc", (10, 4), torch.int8)            # the other buffer
    b = pool.get("enc", (880, 4), torch.int8)       # +10%: no new buffer
    assert b.untyped_storage().data_ptr() == a.untyped_storage().data_ptr()
    assert a.untyped_storage().nbytes() == 800 * 4 + 800 * 4 // 8
