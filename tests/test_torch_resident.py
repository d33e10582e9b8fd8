"""The slice as a whole: coala_gnn_tpu_torch's ResidentTrainer against the
JAX package's ResidentTrainer, flat tier, on the same converted params,
seed grids, graph and host tier: SAGE, GCN and GAT, with f32 and int8
tables.

With fanout = max in-degree the sampler takes every in-edge in order, so
neither trainer depends on its random draws (as in
tests/test_training_parity.py); dropout is 0. Tolerances are that test's:
losses rtol 2e-3 / atol 2e-4, final params rtol 5e-3 / atol 5e-4 (Adam
divides by the root of small second moments and so amplifies rounding
differences of the matmuls). Hit and miss counts are exact."""

import dataclasses

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


def _jax_model(kind, fanouts):
    """(flax model, its params) of ``kind``, 2 layers, GAT with 2 heads."""
    jm = jax_make_model(kind, hidden=8, num_classes=4, num_layers=2,
                        num_heads=2, dropout=0.0)
    caps = block_capacities(B, fanouts)
    blocks0 = [JBlock(adj=None, mask=jnp.ones((caps[l][0], fanouts[l])))
               for l in range(2)]
    return jm, jm.init(jax.random.key(0), blocks0,
                       jnp.zeros((caps[0][1], 8), jnp.float32))


def _jax_trainer(ds, fanouts, jm, colors=None, quantize=False, sgd=False):
    # capacity 256 >= 250 nodes: the flat (direct) tier
    cfg = jfc.CacheConfig(num_sets=8, ways=jfc.WAYS, dim=8,
                          cache_dim=jfc.round_cache_dim(8),
                          num_colors=0 if colors is None else 4,
                          quantize=quantize)
    return JTrainer(graph=ds.graph,
                    host_fetch=HostFeatureStore(ds.features).fetch,
                    labels=ds.labels, cache_cfg=cfg, model=jm,
                    tx=optax.sgd(LR) if sgd else optax.adam(LR),
                    fanouts=fanouts, batch_size=B,
                    colors=colors)


def _torch_trainer(ds, fanouts, params0, colors=None, kind="sage",
                   quantize=False, sgd=False):
    cfg = tfc.CacheConfig(num_sets=8, ways=tfc.WAYS, dim=8,
                          cache_dim=tfc.round_cache_dim(8),
                          num_colors=0 if colors is None else 4,
                          quantize=quantize)
    model = make_model(kind, 8, 8, 4, 2, num_heads=2, dropout=0.0)
    model.load_state_dict(params_from_flax(jax.device_get(params0)))
    opt = (torch.optim.SGD(model.parameters(), lr=LR) if sgd else
           torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                            eps=1e-8))
    store = HostFeatureStore(ds.features, use_native=False)
    return ResidentTrainer(graph=ds.graph, host_fetch=store.fetch,
                           labels=ds.labels, cache_cfg=cfg, model=model,
                           optimizer=opt, fanouts=fanouts, batch_size=B,
                           device="cpu", colors=colors)


def test_train_windows_match_jax(setup):
    ds, fanouts, jm, params0, grids = setup
    _windows_match(ds, fanouts, jm, params0, grids, "sage", False)


@pytest.mark.parametrize("kind,quantize", [("gcn", False), ("gat", False),
                                           ("sage", True), ("gcn", True),
                                           ("gat", True)])
def test_models_and_int8_table_match_jax(setup, kind, quantize):
    """GCN and GAT on the f32 table, and all three models on an int8
    table (stage transport "auto" -> int8, layer 0 through the kernel's
    int8 form for SAGE and GCN, through the dequantised frontier for
    GAT); the int8 table and its scales equal JAX's bitwise.

    GAT trains with SGD here, which holds every leaf; the Adam run of
    bench.py's GAT rows is test_gat_adam_matches_jax."""
    ds, fanouts, _, _, grids = setup
    jm, params0 = _jax_model(kind, fanouts)
    jt, tt = _windows_match(ds, fanouts, jm, params0, grids, kind, quantize,
                            sgd=kind == "gat")
    if quantize:
        assert tt.stage_transport == jt.stage_transport == "int8"
        assert tt.cache.data.dtype == torch.int8
        np.testing.assert_array_equal(tt.cache.data.numpy(),
                                      np.asarray(jt.cache.data))
        # the port divides absmax by 127 as JAX's quantize_rows does op by
        # op; JAX's jitted insert multiplies by 1/127, one ulp off on some
        # rows (tests/test_torch_cache.py holds the eager form bitwise)
        np.testing.assert_allclose(tt.cache.scale.numpy(),
                                   np.asarray(jt.cache.scale), rtol=2**-23,
                                   atol=0)


def _rounding_level_entries(ds, fanouts, jm, params0, grids):
    """Per leaf, a mask of the entries whose JAX gradient at ``params0`` is
    at rounding level on every step of ``grids``: at most 16 f32 ulps of
    the largest gradient entry of the model. Such a gradient is the
    residue of sums that cancel, and differs in sign between frameworks."""
    jt = _jax_trainer(ds, fanouts, jm)
    jt.prewarm(np.arange(ds.graph.num_nodes, dtype=np.int32))
    worst = None
    for seeds in grids.reshape(-1, grids.shape[-1]):
        blocks, feats, y = jt.resolve(jt.begin(seeds, jax.random.key(0)))

        def loss_fn(p):
            logits = jm.apply(p, blocks, feats, train=False)[:B]
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()

        g = {k: v.abs().numpy() for k, v in params_from_flax(
            jax.device_get(jax.grad(loss_fn)(params0))).items()}
        worst = g if worst is None else {k: np.maximum(worst[k], g[k])
                                         for k in g}
    top = max(float(v.max()) for v in worst.values())
    return {k: v <= 16 * np.finfo(np.float32).eps * top
            for k, v in worst.items()}


def test_gat_adam_matches_jax(setup):
    """GAT with Adam, as bench.py's GAT rows train it. The softmax over the
    slots cancels a head's ``attn_r`` in the last layer wherever that
    head's scores stay on one side of the leaky ReLU; its gradient is then
    rounding noise, which Adam (dividing by its root mean square) turns
    into lr-sized steps of random sign in both frameworks. Those entries
    are found by their reference gradient (``_rounding_level_entries``)
    and left out; the losses and every other entry are held as in
    ``_windows_match``."""
    ds, fanouts, _, _, grids = setup
    jm, params0 = _jax_model("gat", fanouts)
    noise = _rounding_level_entries(ds, fanouts, jm, params0, grids)
    n_noise = sum(int(m.sum()) for m in noise.values())
    assert 0 < n_noise <= sum(m.size for m in noise.values()) // 20
    _windows_match(ds, fanouts, jm, params0, grids, "gat", False,
                   skip=noise)


def _windows_match(ds, fanouts, jm, params0, grids, kind, quantize,
                   sgd=False, skip=None):
    """Full-coverage windows of both trainers: losses, edges, counters and
    final params agree, apart from the entries ``skip`` masks per leaf.
    Returns (JAX trainer, port trainer)."""
    jt = _jax_trainer(ds, fanouts, jm, quantize=quantize, sgd=sgd)
    jt.prewarm(np.arange(ds.graph.num_nodes, dtype=np.int32))
    assert jt.direct and jt.full_coverage
    opt0 = jt.tx.init(params0)
    jp, _, jlosses, jedges = jt.train_windows(params0, opt0, grids,
                                              jax.random.key(7))
    jstats = jt.stats()

    tt = _torch_trainer(ds, fanouts, params0, kind=kind, quantize=quantize,
                        sgd=sgd)
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
        keep = (np.ones(p.shape, bool) if skip is None else
                ~skip[name])
        np.testing.assert_allclose(p.numpy()[keep], want[name].numpy()[keep],
                                   **PARAM_TOL)
    return jt, tt


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
    dedup=True and nbr_cap sampling, and int8 lines on a bf16 flat
    table."""
    ds, fanouts, _, params0, grids = setup
    tt = _torch_trainer(ds, fanouts, params0)
    for kw in ({"dedup": True}, {"nbr_cap": 2 * max(fanouts)}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ResidentTrainer(graph=ds.graph, host_fetch=None,
                            labels=ds.labels, cache_cfg=tt.cache_cfg,
                            model=tt.model, optimizer=tt.optimizer,
                            fanouts=fanouts, batch_size=B, device="cpu",
                            **kw)
    bf16_int8 = dataclasses.replace(tt.cache_cfg, dtype=torch.bfloat16,
                                    quantize=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ResidentTrainer(graph=ds.graph, host_fetch=None, labels=ds.labels,
                        cache_cfg=bf16_int8, model=tt.model,
                        optimizer=tt.optimizer, fanouts=fanouts,
                        batch_size=B, device="cpu")
