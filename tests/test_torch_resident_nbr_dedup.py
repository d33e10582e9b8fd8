"""The resident trainers' ``dedup=True`` and ``nbr_cap`` against the JAX
package's, from the same converted params (``utils/convert.py``), seed
grids, graph and host tier, dropout 0.

- ``ResidentTrainer(dedup=True)``: the per-step path (``begin`` /
  ``resolve`` / ``train_step``) with half the nodes prewarmed, so misses
  are fetched, merged and admitted; fanout = max in-degree makes the draws
  irrelevant. Losses 1e-5, counters and the cache state exact.
- ``ResidentTrainer(nbr_cap=P)``: flat full-coverage windows with fanout
  and P below the largest degrees (so rows are truncated and slots drawn),
  the port fed JAX's own uniforms per step, replayed from its window keys
  (the injected-uniforms pattern of tests/test_torch_sampler.py). Losses
  1e-5, edges and counters exact.
- ``ShardedResidentTrainer(nbr_cap)``: SAGE and RGAT (the relation table)
  through tests/test_torch_sharded_resident.py's ``_drive`` (per-step and
  staged windows under eviction, masked tail, eval) at P = fanout = max
  in-degree; and the one-device subject of
  tests/test_sharded_resident.py:88-140 (exact features, training, the
  refusals)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_sharded_resident as tsr
from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.cache.host_tier import HostFeatureStore
from coala_gnn_tpu.graph.datasets import synthetic_graph
from coala_gnn_tpu.models import make_model as jax_make_model
from coala_gnn_tpu.models.layers import DeviceBlock as JBlock
from coala_gnn_tpu.parallel.resident import ResidentTrainer as JTrainer
from coala_gnn_tpu.sampling.neighbor import block_capacities
from coala_gnn_tpu_torch.cache import feature_cache as tfc
from coala_gnn_tpu_torch.models.gnn import make_model
from coala_gnn_tpu_torch.parallel import resident
from coala_gnn_tpu_torch.parallel.resident import ResidentTrainer
from coala_gnn_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

B, LR = 16, 1e-2
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def graph():
    ds = synthetic_graph(num_nodes=250, avg_degree=4, feature_dim=8,
                         num_classes=4, seed=5)
    return ds, int(ds.graph.in_degrees().max())


def _params(fanouts):
    jm = jax_make_model("sage", hidden=8, num_classes=4, num_layers=2,
                       dropout=0.0)
    caps = block_capacities(B, fanouts)
    blocks = [JBlock(adj=None, mask=jnp.ones((caps[l][0], fanouts[l])))
              for l in range(2)]
    return jm, jm.init(jax.random.key(0), blocks,
                       jnp.zeros((caps[0][1], 8), jnp.float32))


def _trainers(ds, fanouts, colors=None, **kw):
    """(JAX trainer, port trainer, params0): flat tier (capacity 256 >=
    250 nodes), Adam, the same params."""
    jm, params = _params(fanouts)
    cfg = dict(num_sets=8, ways=jfc.WAYS, dim=8,
               cache_dim=jfc.round_cache_dim(8),
               num_colors=0 if colors is None else 4)
    jt = JTrainer(graph=ds.graph,
                  host_fetch=HostFeatureStore(ds.features).fetch,
                  labels=ds.labels, cache_cfg=jfc.CacheConfig(**cfg),
                  model=jm, tx=optax.adam(LR), fanouts=fanouts,
                  batch_size=B, colors=colors, **kw)
    model = make_model("sage", 8, 8, 4, 2, dropout=0.0)
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    tt = ResidentTrainer(
        graph=ds.graph,
        host_fetch=HostFeatureStore(ds.features, use_native=False).fetch,
        labels=ds.labels, cache_cfg=tfc.CacheConfig(**cfg), model=model,
        optimizer=torch.optim.Adam(model.parameters(), lr=LR),
        fanouts=fanouts, batch_size=B, device="cpu", colors=colors, **kw)
    return jt, tt, params


def _grids(ds, shape, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape[:-1]))
    return np.stack([rng.choice(ds.train_idx, B, replace=False)
                     for _ in range(n)]).astype(np.int32).reshape(shape)


def test_dedup_per_step_path_matches_jax(graph):
    """dedup=True begin / resolve / train_step: deduplicated frontier,
    blocks with adj (both layers' sums over it), misses repaired and
    admitted with their colors. The blocks, ids and count equal JAX's."""
    ds, max_deg = graph
    fanouts = [max_deg, max_deg]
    colors = np.random.default_rng(4).integers(0, 5, ds.graph.num_nodes)
    jt, tt, params = _trainers(ds, fanouts, colors, dedup=True)
    warm = np.arange(0, ds.graph.num_nodes, 2, dtype=np.int32)
    jt.prewarm(warm)
    tt.prewarm(warm)
    jp, jo = params, jt.tx.init(params)
    jl, tl = [], []
    for step, seeds in enumerate(_grids(ds, (5, B), 3)):
        jh = jt.begin(seeds, jax.random.key(step))
        th = tt.begin(seeds, torch.Generator().manual_seed(step))
        jblocks, jids, jvalid = jh[0], jh[1], jh[2]
        tblocks, tids, tvalid = th[0], th[1], th[2]
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
        for a, b in zip(jblocks, tblocks):
            np.testing.assert_array_equal(b.adj.numpy(), np.asarray(a.adj))
            np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        jp, jo, loss, _ = jt.train_step(jp, jo, jax.random.key(99),
                                        jt.resolve(jh))
        jl.append(float(loss))
        tl.append(float(tt.train_step(tt.resolve(th), None)[0]))
    np.testing.assert_allclose(tl, jl, **TOL)
    ts, js = tt.stats(), jt.stats()
    assert ts == js and ts["misses"] > 0 and ts["hits"] > 0
    np.testing.assert_array_equal(tt.cache.admitted.numpy(),
                                  np.asarray(jt.cache.admitted))
    np.testing.assert_array_equal(tt.cache.color_counts.numpy(),
                                  np.asarray(jt.cache.color_counts))


def _jax_window_uniforms(key, M, K, fanouts):
    """The uniforms JAX's ``train_windows(..., key)`` draws, per step in
    order: window keys ``split(key, M)``, step keys ``split(window key,
    K)``, the sampling key the first of ``split(step key)``, then one
    ``split`` per layer (``jax_uniforms``)."""
    caps = block_capacities(B, fanouts)
    out = []
    for wk in jax.random.split(key, M):
        for sk in jax.random.split(wk, K):
            k = jax.random.split(sk)[0]
            per = [None] * len(fanouts)
            for layer in range(len(fanouts) - 1, -1, -1):
                k, sub = jax.random.split(k)
                per[layer] = torch.from_numpy(np.array(jax.random.uniform(
                    sub, (caps[layer][0], fanouts[layer]))))
            out.append(per)
    return out


def test_nbr_cap_windows_match_jax(graph, monkeypatch):
    """nbr_cap = 4 below the largest degrees, fanout 3: windows on the
    padded table (truncated rows, drawn slots) equal JAX's given its
    uniforms; the table equals JAX's bitwise."""
    ds, max_deg = graph
    fanouts, P, M, K = [3, 3], 4, 2, 3
    assert max_deg > P
    jt, tt, params = _trainers(ds, fanouts, nbr_cap=P)
    np.testing.assert_array_equal(tt.g.nbr_table.numpy(),
                                  np.asarray(jt.g.nbr_table))
    nodes = np.arange(ds.graph.num_nodes, dtype=np.int32)
    jt.prewarm(nodes)
    tt.prewarm(nodes)
    grids = _grids(ds, (M, K, B), 6)
    key = jax.random.key(7)
    jp, _, jlosses, jedges = jt.train_windows(params, jt.tx.init(params),
                                              grids, key)
    uniforms = _jax_window_uniforms(key, M, K, fanouts)
    sample = resident.sample_blocks_device

    def replayed(g, seeds, fanouts, batch_size, generator=None,
                 dedup=False, uniforms=None):
        return sample(g, seeds, fanouts, batch_size, dedup=dedup,
                      uniforms=queue.pop(0))

    queue = list(uniforms)
    monkeypatch.setattr(resident, "sample_blocks_device", replayed)
    tlosses, tedges = tt.train_windows(grids, seed=0)
    assert not queue
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), **TOL)
    np.testing.assert_array_equal(tedges.numpy(), np.asarray(jedges))
    assert tt.stats() == jt.stats()
    want = params_from_flax(jax.device_get(jp))
    for name, p in tt.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   rtol=5e-5, atol=5e-6)


def test_refusals(graph):
    """nbr_cap below the largest fanout raises ValueError as JAX's does;
    a typed graph still raises NotImplementedError."""
    ds, _ = graph
    for trainer in (JTrainer, ResidentTrainer):
        with pytest.raises(ValueError, match="nbr_cap"):
            kw = dict(tx=optax.adam(LR)) if trainer is JTrainer else dict(
                optimizer=None, device="cpu")
            trainer(graph=ds.graph, host_fetch=None, labels=ds.labels,
                    cache_cfg=tfc.CacheConfig(num_sets=8, ways=tfc.WAYS,
                                              dim=8, cache_dim=8,
                                              num_colors=0),
                    model=None, fanouts=[4, 3], batch_size=B, nbr_cap=2,
                    **kw)
    typed = synthetic_graph(num_nodes=250, avg_degree=4, feature_dim=8,
                            num_classes=4, seed=5)
    typed.graph.edge_types = np.zeros(typed.graph.num_edges, np.int32)
    with pytest.raises(NotImplementedError, match="ShardedResidentTrainer"):
        ResidentTrainer(graph=typed.graph, host_fetch=None,
                        labels=typed.labels,
                        cache_cfg=tfc.CacheConfig(num_sets=8, ways=tfc.WAYS,
                                                  dim=8, cache_dim=8,
                                                  num_colors=0),
                        model=None, optimizer=None, fanouts=[4, 3],
                        batch_size=B, device="cpu", dedup=True, nbr_cap=4)


# ---- ShardedResidentTrainer(nbr_cap) ---------------------------------------

@pytest.fixture(scope="module")
def sharded_data():
    """tests/test_torch_sharded_resident.py's data: (homogeneous, typed,
    fanouts = max in-degree)."""
    ds = synthetic_graph(num_nodes=600, avg_degree=4, feature_dim=tsr.DIM,
                         num_classes=tsr.CLASSES, seed=5)
    typed = synthetic_graph(num_nodes=600, avg_degree=4, feature_dim=tsr.DIM,
                            num_classes=tsr.CLASSES, seed=5)
    typed.graph.edge_types = np.random.default_rng(5).integers(
        0, tsr.R, typed.graph.num_edges).astype(np.int32)
    typed.graph.num_edge_types = tsr.R
    max_deg = int(ds.graph.in_degrees().max())
    return ds, typed, [max_deg, max_deg]


@pytest.mark.parametrize("kind", ["sage", "rgat"])
def test_sharded_nbr_cap_matches_jax(sharded_data, kind):
    """The CLI's schedule (per-step steps, staged windows of 4 under
    eviction, masked tail, eval) with nbr_cap = max in-degree: both sample
    the padded table (RGAT its relation table too) and agree with JAX."""
    ds, typed, fanouts = sharded_data
    ds = typed if kind == "rgat" else ds
    jt, tt, params = tsr._pair(ds, fanouts, kind, tsr.EVICTS,
                               nbr_cap=fanouts[0])
    assert (tt.g.rel_table is not None) == (kind == "rgat")
    from coala_gnn_tpu.sampling.device_sampler import to_device_graph
    jg = to_device_graph(ds.graph, nbr_cap=fanouts[0])
    for name in ("nbr_table", "nbr_deg", "rel_table"):
        got, want = getattr(tt.g, name), getattr(jg, name)
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    valid = np.ones((1, B), bool)
    valid[0, B // 2:] = False
    jl, tl, je, te = tsr._drive(jt, tt, params, tsr._grids(ds, 10, 3), 4,
                                valid, tsr._grids(ds, 2, 4))
    np.testing.assert_allclose(tl, jl, **(TOL if kind == "sage"
                                          else tsr.ADAM_ATTN_TOL))
    assert te == je and tt.stats() == jt.stats()
    tsr._same_cache(tt, jt)


def test_sharded_padded_topology_trains(sharded_data):
    """tests/test_sharded_resident.py's padded-topology subject on one
    device, fanouts [4, 3] and nbr_cap 8 (some rows truncated): exact
    features against the host store, falling loss; nbr_cap below the
    largest fanout and nbr_cap with shard_topology raise ValueError."""
    ds, _, _ = sharded_data
    fanouts = [4, 3]
    tt = tsr._port(ds, fanouts, "sage", tsr.FULL, nbr_cap=8)
    assert int(ds.graph.in_degrees().max()) > 8
    losses = []
    for step, grid in enumerate(tsr._grids(ds, 6, 3)):
        g_sample, g_drop = tsr._gens(step)
        h = tt.begin(grid, g_sample)
        resolved = tt.resolve(h)
        ids, valid = h.ids.numpy(), h.valid.numpy()
        np.testing.assert_array_equal(resolved[1].numpy()[valid],
                                      ds.features[ids[valid]])
        losses.append(float(tt.train_step(resolved, g_drop)[0]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for kw in (dict(nbr_cap=2), dict(nbr_cap=8, shard_topology=True)):
        with pytest.raises(ValueError, match="nbr_cap"):
            tsr._port(ds, fanouts, "sage", tsr.FULL, **kw)
