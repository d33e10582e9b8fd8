"""The host-side pieces of the data-parallel port, bitwise against the JAX
package's: the exchange's bucket sizes (``parallel/sizing.py``), the byte
model (``parallel/comm_model.py``), the distributed set index and
``lookup_quantized`` (``cache/feature_cache.py``), ``clustered_graph``
(``graph/datasets.py``); and the process topology without a process group
(``parallel/mesh.py``, ``parallel/multihost.py``)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.graph.datasets import clustered_graph as jax_clustered
from coala_gnn_tpu.parallel import comm_model as jcm
from coala_gnn_tpu.parallel import sizing as jsizing
from coala_gnn_tpu_torch.cache import feature_cache as fc
from coala_gnn_tpu_torch.graph.datasets import clustered_graph
from coala_gnn_tpu_torch.parallel import comm_model as cm
from coala_gnn_tpu_torch.parallel import mesh as pmesh
from coala_gnn_tpu_torch.parallel import multihost
from coala_gnn_tpu_torch.parallel import sizing

torch.set_num_threads(1)


@pytest.mark.parametrize("fn", ["lookup_bucket_cap", "fill_bucket_cap"])
def test_bucket_sizes_equal_jax(fn):
    grid = itertools.product([1, 7, 64, 4096, 67584, 100_003],
                             [1, 2, 3, 4, 8, 16], [1.0, 1.5, 2.0, 3.0])
    for n, g, slack in grid:
        assert getattr(sizing, fn)(n, g, slack) == \
            getattr(jsizing, fn)(n, g, slack), (n, g, slack)
    for x in range(0, 70_000, 37):
        assert sizing.ceil_pow2(x) == jsizing.ceil_pow2(x)


MODEL_ARGS = [
    # mode, n_req, n_dev, local, dim, extras
    ("sharded", 67_584, 2, 2, 256, {}),
    ("sharded", 67_584, 8, 4, 256, dict(int8_response=True, misses=3000)),
    ("node_local", 6_144, 8, 4, 128, dict(num_colors=32, param_bytes=10**6)),
    ("node_local", 64, 4, 1, 16, dict(misses=17)),
    ("isolated", 6_144, 4, 4, 256, dict(feat_bytes=2, param_bytes=4096)),
    ("sharded", 1_000, 16, 8, 100, dict(slack=1.0, refresh_counter=3,
                                        num_colors=7, misses=999)),
]


@pytest.mark.parametrize("args", MODEL_ARGS, ids=lambda a: f"{a[0]}-{a[2]}")
def test_comm_model_equals_jax(args):
    """``step_traffic``, its parts and the projections, value for value
    (the port names JAX's dcn / ici link rates cross / intra)."""
    mode, n_req, n_dev, local, dim, kw = args
    got = cm.step_traffic(mode, n_req, n_dev, local, dim, **kw)
    assert got == jcm.step_traffic(mode, n_req, n_dev, local, dim, **kw)
    shape = dict(n_req=n_req, bucket_cap=got["bucket_cap"], n_dev=n_dev,
                 group=got["group"], local=local, dim=dim,
                 int8_response=kw.get("int8_response", False))
    s, js = cm.ExchangeShape(**shape), jcm.ExchangeShape(**shape)
    assert s.row_resp_bytes == js.row_resp_bytes
    assert cm.exchange_step_bytes(s) == jcm.exchange_step_bytes(js)
    assert cm.fill_step_bytes(s, 300) == jcm.fill_step_bytes(js, 300)
    assert cm.grad_psum_bytes(12345, n_dev, local) == \
        jcm.grad_psum_bytes(12345, n_dev, local)
    assert cm.meta_allgather_bytes(31, n_dev // local) == \
        jcm.meta_allgather_bytes(31, n_dev // local)
    assert cm.step_time(0.01, got, 25.0, 450.0) == \
        jcm.step_time(0.01, got, 25.0, 450.0)
    eff = dict(int8_response=kw.get("int8_response", False))
    assert cm.efficiency_1_to_2_hosts(mode, 0.02, n_req, local, dim, 25.0,
                                      450.0, **eff) == \
        jcm.efficiency_1_to_2_hosts(mode, 0.02, n_req, local, dim, 25.0,
                                    450.0, **eff)
    assert cm.project_efficiency(0.02, 10**6, 10**7, 25.0, 450.0) == \
        jcm.project_efficiency(0.02, 10**6, 10**7, 25.0, 450.0)


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4, 8])
def test_set_index_equals_jax(num_shards):
    kw = dict(num_sets=37, ways=fc.WAYS, dim=16, cache_dim=128,
              num_colors=0, num_shards=num_shards)
    ids = np.random.default_rng(num_shards).integers(
        0, 2**31 - 1, 5000).astype(np.int32)
    got = fc._set_index(fc.CacheConfig(**kw), torch.from_numpy(ids))
    want = jfc.set_index(jfc.CacheConfig(**kw), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert fc.make_config(8, 100, num_shards=num_shards) == fc.CacheConfig(
        **dict(kw, num_sets=fc.make_config(8, 100).num_sets, dim=100))


@pytest.mark.parametrize("num_shards", [1, 4])
def test_lookup_quantized_equals_jax(num_shards):
    """The raw int8 lines, their scales and the hit bits of a lookup on
    the same state, and the same counters after it; missed rows zero with
    scale 1."""
    kw = dict(num_sets=8, ways=fc.WAYS, dim=24, cache_dim=128,
              num_colors=0, quantize=True, num_shards=num_shards)
    cfg, jcfg = fc.CacheConfig(**kw), jfc.CacheConfig(**kw)
    rng = np.random.default_rng(3)
    rows = rng.normal(size=(400, 24)).astype(np.float32)
    ids = rng.choice(2000, 400, replace=False).astype(np.int32)
    state = fc.init_colored_state(cfg, "cpu")
    valid = torch.ones(400, dtype=torch.bool)
    fc.insert_with_colors(cfg, state, torch.from_numpy(ids),
                          torch.from_numpy(rows), valid,
                          torch.zeros(400, dtype=torch.int32))
    jstate = jfc.init_state(jcfg)
    jstate = jfc.insert(jcfg, jstate, jnp.asarray(ids), jnp.asarray(rows),
                        jnp.ones(400, bool))
    n = cfg.num_sets
    np.testing.assert_array_equal(state.base.tags[:n].numpy(),
                                  np.asarray(jstate.tags))
    q_ids = np.concatenate([ids[:100], rng.choice(2000, 60).astype(
        np.int32)])
    q_valid = np.arange(160) < 150
    _, q, sc, hit = fc.lookup_quantized(cfg, state.base,
                                        torch.from_numpy(q_ids),
                                        torch.from_numpy(q_valid))
    jstate, jq, jsc, jhit = jfc.lookup_quantized(
        jcfg, jstate, jnp.asarray(q_ids), jnp.asarray(q_valid))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_max_ulp(sc.numpy(), np.asarray(jsc), maxulp=1)
    assert (int(state.base.hits), int(state.base.misses)) == \
        (int(jstate.hits), int(jstate.misses))
    assert hit.any() and not hit.all()
    assert (sc.numpy()[~hit.numpy()] == 1.0).all()


@pytest.mark.parametrize("seed,kw", [
    (0, dict(num_nodes=3000, num_communities=8, avg_degree=4)),
    (7, dict(num_nodes=5000, num_communities=64, avg_degree=10,
             p_intra=0.8, feature_dim=32, num_classes=16))])
def test_clustered_graph_equals_jax(seed, kw):
    ds, jds = clustered_graph(seed=seed, **kw), jax_clustered(seed=seed,
                                                              **kw)
    for name in ("indptr", "indices"):
        a, b = getattr(ds.graph, name), getattr(jds.graph, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("features", "labels", "train_idx", "val_idx", "test_idx"):
        a, b = getattr(ds, name), getattr(jds, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert (ds.name, ds.num_classes) == (jds.name, jds.num_classes)


def test_topology_without_a_process_group(monkeypatch):
    """One card on its own: no process group, no collective; the meta
    exchange hands the rank's own counters back as its host's; the
    environment's absence keeps ``initialize_distributed`` a no-op; a list
    of more than one device is refused (one process per card)."""
    for var in ("WORLD_SIZE", "RANK", "COALA_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_distributed("gloo") is False
    mesh = pmesh.make_mesh("cpu")
    assert (mesh.world, mesh.rank, mesh.num_hosts, mesh.host_id,
            mesh.local_rank, mesh.distributed) == (1, 0, 1, 0, 0, False)
    assert multihost.topology() == (1, 0, 1, 0)
    assert multihost.topology(mesh) == (1, 0, 1, 0)
    counts = np.arange(5, dtype=np.int32)
    out = multihost.make_meta_exchange_fn(mesh, 4)(counts)
    assert out.shape == (1, 5) and (out[0] == counts).all()
    assert pmesh.as_mesh(["cpu"]).device == torch.device("cpu")
    assert pmesh.as_mesh(mesh) is mesh
    with pytest.raises(ValueError, match="one process per card"):
        pmesh.as_mesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="process group"):
        pmesh.make_mesh("cpu", local_size=2)
    assert multihost.backend_for("cpu") in ("gloo", "mpi")
    assert multihost.backend_for("cuda:0") == "nccl"
    with pytest.raises(ValueError, match="2 devices"):
        multihost.launch(print, 2, ["cpu"], "gloo")
