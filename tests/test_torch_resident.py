"""The slice as a whole: coala_gnn_tpu_torch's ResidentTrainer against the
JAX package's ResidentTrainer, flat tier, on the same converted params,
seed grids, graph and host tier.

With fanout = max in-degree the sampler takes every in-edge in order, so
neither trainer depends on its random draws (as in
tests/test_training_parity.py); dropout is 0. Tolerances are that test's:
losses rtol 2e-3 / atol 2e-4, final params rtol 5e-3 / atol 5e-4 (Adam
divides by the root of small second moments and so amplifies rounding
differences of the matmuls). Hit and miss counts are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.cache.host_tier import HostFeatureStore
from coala_gnn_tpu.graph.datasets import synthetic_graph
from coala_gnn_tpu.models import make_model as jax_make_model
from coala_gnn_tpu.models.layers import DeviceBlock as JBlock
from coala_gnn_tpu.parallel.resident import ResidentTrainer as JTrainer
from coala_gnn_tpu.sampling.neighbor import block_capacities
from coala_gnn_tpu_torch.cache import feature_cache as tfc
from coala_gnn_tpu_torch.models.gnn import make_model
from coala_gnn_tpu_torch.parallel.resident import ResidentTrainer
from coala_gnn_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

B, K, M, LR = 16, 4, 3, 1e-2
LOSS_TOL = dict(rtol=2e-3, atol=2e-4)
PARAM_TOL = dict(rtol=5e-3, atol=5e-4)


@pytest.fixture(scope="module")
def setup():
    ds = synthetic_graph(num_nodes=250, avg_degree=4, feature_dim=8,
                         num_classes=4, seed=5)
    max_deg = int(ds.graph.in_degrees().max())
    fanouts = [max_deg, max_deg]
    jm = jax_make_model("sage", hidden=8, num_classes=4, num_layers=2,
                        dropout=0.0)
    caps = block_capacities(B, fanouts)
    blocks0 = [JBlock(adj=None, mask=jnp.ones((caps[l][0], fanouts[l])))
               for l in range(2)]
    params0 = jm.init(jax.random.key(0), blocks0,
                      jnp.zeros((caps[0][1], 8), jnp.float32))
    rng = np.random.default_rng(3)
    grids = np.stack([np.stack([rng.choice(ds.train_idx, B, replace=False)
                                for _ in range(K)])
                      for _ in range(M)]).astype(np.int32)
    return ds, fanouts, jm, params0, grids


def _jax_trainer(ds, fanouts, jm, colors=None):
    # capacity 256 >= 250 nodes: the flat (direct) tier
    cfg = jfc.CacheConfig(num_sets=8, ways=jfc.WAYS, dim=8,
                          cache_dim=jfc.round_cache_dim(8),
                          num_colors=0 if colors is None else 4)
    return JTrainer(graph=ds.graph,
                    host_fetch=HostFeatureStore(ds.features).fetch,
                    labels=ds.labels, cache_cfg=cfg, model=jm,
                    tx=optax.adam(LR), fanouts=fanouts, batch_size=B,
                    colors=colors)


def _torch_trainer(ds, fanouts, params0, colors=None):
    cfg = tfc.CacheConfig(num_sets=8, ways=tfc.WAYS, dim=8,
                          cache_dim=tfc.round_cache_dim(8),
                          num_colors=0 if colors is None else 4)
    model = make_model("sage", 8, 8, 4, 2, dropout=0.0)
    model.load_state_dict(params_from_flax(jax.device_get(params0)))
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    store = HostFeatureStore(ds.features, use_native=False)
    return ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                           labels=ds.labels, cache_cfg=cfg, model=model,
                           optimizer=opt, fanouts=fanouts, batch_size=B,
                           device="cpu", colors=colors)


def test_train_windows_match_jax(setup):
    ds, fanouts, jm, params0, grids = setup
    jt = _jax_trainer(ds, fanouts, jm)
    jt.prewarm(np.arange(ds.graph.num_nodes, dtype=np.int32))
    assert jt.direct and jt.full_coverage
    opt0 = jt.tx.init(params0)
    jp, _, jlosses, jedges = jt.train_windows(params0, opt0, grids,
                                              jax.random.key(7))
    jstats = jt.stats()

    tt = _torch_trainer(ds, fanouts, params0)
    tt.prewarm(np.arange(ds.graph.num_nodes, dtype=np.int32))
    assert tt.direct and tt.full_coverage
    tlosses, tedges = tt.train_windows(grids, seed=7)
    tstats = tt.stats()

    assert tlosses.shape == (M * K,)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               **LOSS_TOL)
    np.testing.assert_array_equal(tedges.numpy(), np.asarray(jedges))
    assert tstats == jstats and tstats["misses"] == 0
    assert tstats["hits"] > 0
    want = params_from_flax(jax.device_get(jp))
    for name, p in tt.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   **PARAM_TOL)


def test_per_step_path_with_misses_matches_jax(setup):
    """begin / resolve / train_step with half the nodes prewarmed: misses
    are fetched from the host tier, merged and admitted (with their color
    counts), as in JAX."""
    ds, fanouts, jm, params0, grids = setup
    colors = np.random.default_rng(4).integers(0, 5, ds.graph.num_nodes)
    warm = np.arange(0, ds.graph.num_nodes, 2, dtype=np.int32)
    jt = _jax_trainer(ds, fanouts, jm, colors)
    jt.prewarm(warm)
    tt = _torch_trainer(ds, fanouts, params0, colors)
    tt.prewarm(warm)
    assert not tt.full_coverage
    jp, jo = params0, jt.tx.init(params0)
    for step, seeds in enumerate(grids[0]):
        resolved = jt.resolve(jt.begin(seeds, jax.random.key(step)))
        jp, jo, jloss, jacc = jt.train_step(jp, jo, jax.random.key(99),
                                            resolved)
        gen = torch.Generator().manual_seed(step)
        tloss, tacc = tt.train_step(tt.resolve(tt.begin(seeds, gen)), gen)
        np.testing.assert_allclose(float(tloss), float(jloss), **LOSS_TOL)
        assert float(tacc) == pytest.approx(float(jacc))
        jst, tst = jt.stats(), tt.stats()
        assert tst == jst
        if step == 0:
            assert tst["misses"] > 0
    np.testing.assert_array_equal(tt.cache.admitted.numpy(),
                                  np.asarray(jt.cache.admitted))
    np.testing.assert_array_equal(tt.cache.color_counts.numpy(),
                                  np.asarray(jt.cache.color_counts))
    assert int(tt.cache.color_counts.sum()) > 0


def test_unported_paths_raise(setup):
    """What stays unported raises and names its ROADMAP.md item:
    dedup=True and nbr_cap sampling, int8 cache lines, GCN and GAT."""
    ds, fanouts, _, params0, grids = setup
    tt = _torch_trainer(ds, fanouts, params0)
    for kw in ({"dedup": True}, {"nbr_cap": 2 * max(fanouts)}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ResidentTrainer(graph=ds.graph, host_fetch=None,
                            labels=ds.labels, cache_cfg=tt.cache_cfg,
                            model=tt.model, optimizer=tt.optimizer,
                            fanouts=fanouts, batch_size=B, device="cpu",
                            **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfc.make_config(8, 8, quantize=True)
    for model_type in ("gcn", "gat"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_model(model_type, 8, 8, 4, 2)
