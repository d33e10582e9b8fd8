"""coala_gnn_tpu_torch's ShardedResidentTrainer against the JAX package's on
a one-device mesh (``make_mesh(jax.devices()[:1])``), from the same
converted params, seed grids, graph and host tier: SAGE, GAT and RGAT, the
per-step path (K = 1, one ``begin`` ahead as the CLI runs it) and fused
windows (K = 4), at a cache that holds every row and at one that evicts,
each run ending in a masked tail step and eval steps.

With fanout = max in-degree the sampler takes every in-edge in order, so
neither trainer depends on its random draws and both sample the same
frontiers; dropout is 0. Losses agree per step at 1e-5; GAT and RGAT under
Adam at tests/test_torch_hetero.py's ``ADAM_RGAT_TOL`` (the last layer's
``attn_r`` gradient is rounding noise that Adam turns into lr-sized
steps). Hit and miss counts and eval counts are exact, and the cache state
(tags, lines, cursors, colors, counters) is bitwise JAX's after the run.

The one-device subjects of tests/test_sharded_resident.py are mirrored
too: exact features, training that hits, the masked tail's exactness, the
cold-cache staged window, fused windows, hetero training, staged windows
under pressure equal to full coverage, bf16 transport close to f32."""

import functools

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
from coala_gnn_tpu.models import hetero as jh
from coala_gnn_tpu.models.layers import DeviceBlock as JBlock
from coala_gnn_tpu.parallel.mesh import make_mesh
from coala_gnn_tpu.parallel.sharded_cache import \
    ShardedFeatureCache as JCache, init_sharded_state
from coala_gnn_tpu.parallel.sharded_resident import \
    ShardedResidentTrainer as JTrainer
from coala_gnn_tpu.sampling.neighbor import block_capacities
from coala_gnn_tpu.utils.timers import PhaseTimers
from coala_gnn_tpu_torch.cache import feature_cache as tfc
from coala_gnn_tpu_torch.models.gnn import make_model
from coala_gnn_tpu_torch.models.hetero import make_hetero_model
from coala_gnn_tpu_torch.parallel import sharded_cache as tsc
from coala_gnn_tpu_torch.parallel.resident import ResidentTrainer
from coala_gnn_tpu_torch.parallel.sharded_resident import \
    ShardedResidentTrainer
from coala_gnn_tpu_torch.utils.convert import params_from_flax
from coala_gnn_tpu_torch.utils.rng import DROPOUT, SAMPLE, step_generators

torch.set_num_threads(1)

B, DIM, CLASSES, R, LR = 16, 8, 4, 3, 1e-2
TOL = dict(rtol=1e-5, atol=1e-5)
ADAM_ATTN_TOL = dict(rtol=2e-4, atol=2e-4)   # test_torch_hetero.py's
FULL, EVICTS = 32, 4      # num_sets: 1,024 lines hold all 600 rows; 128 not


@pytest.fixture(scope="module")
def data():
    """(homogeneous dataset, typed dataset, fanouts = max in-degree)."""
    ds = synthetic_graph(num_nodes=600, avg_degree=4, feature_dim=DIM,
                         num_classes=CLASSES, seed=5)
    typed = synthetic_graph(num_nodes=600, avg_degree=4, feature_dim=DIM,
                            num_classes=CLASSES, seed=5)
    typed.graph.edge_types = np.random.default_rng(5).integers(
        0, R, typed.graph.num_edges).astype(np.int32)
    typed.graph.num_edge_types = R
    max_deg = int(ds.graph.in_degrees().max())
    return ds, typed, [max_deg, max_deg]


@functools.lru_cache(maxsize=None)
def _jax_model(kind, fanouts):
    """(flax model, params at the contiguous layout's shapes); ``fanouts``
    a tuple. Built once per model: flax's init compiles."""
    caps = block_capacities(B, list(fanouts))
    if kind.startswith("r"):
        jm = jh.make_hetero_model(kind, hidden=8, num_classes=CLASSES,
                                  num_rels=R, num_layers=2, num_heads=2,
                                  dropout=0.0)
        blocks = [jh.DeviceHeteroBlock(
            adj=None, mask=jnp.ones((caps[l][0], fanouts[l])),
            rel=jnp.zeros((caps[l][0], fanouts[l]), jnp.int32))
            for l in range(2)]
    else:
        jm = jax_make_model(kind, hidden=8, num_classes=CLASSES,
                            num_layers=2, num_heads=2, dropout=0.0)
        blocks = [JBlock(adj=None, mask=jnp.ones((caps[l][0], fanouts[l])))
                  for l in range(2)]
    return jm, jm.init(jax.random.key(0), blocks,
                       jnp.zeros((caps[0][1], DIM), jnp.float32))


def _cfg_kw(num_sets, quantize=False, colors=None):
    return dict(num_sets=num_sets, ways=jfc.WAYS, dim=DIM,
                cache_dim=jfc.round_cache_dim(DIM),
                num_colors=0 if colors is None else int(np.max(colors)),
                quantize=quantize)


_JAX = {}   # (kind, num_sets, quantize, colors, kw) -> (trainer, params)


def _pair(ds, fanouts, kind, num_sets, colors=None, quantize=False, **kw):
    """(JAX trainer, port trainer, params) on one device, from the same
    params. A JAX trainer is built once per configuration and handed out
    again with a cold cache, zero counters and fresh timers, so its jitted
    functions compile once per configuration."""
    key = (kind, num_sets, quantize, colors is not None,
           tuple(sorted(kw.items())))
    if key not in _JAX:
        jm, params = _jax_model(kind, tuple(fanouts))
        cache = JCache(cfg=jfc.CacheConfig(**_cfg_kw(num_sets, quantize,
                                                     colors)),
                       mesh=make_mesh(jax.devices()[:1]))
        _JAX[key] = (JTrainer(
            graph=ds.graph, host_fetch=HostFeatureStore(ds.features).fetch,
            labels=ds.labels, cache=cache, model=jm, tx=optax.adam(LR),
            fanouts=fanouts, batch_size=B, colors=colors, **kw), params)
    jt, params = _JAX[key]
    jt.cache.state = init_sharded_state(jt.cache.cfg, jt.cache.mesh)
    jt.hits = jt.misses = 0
    jt.timers = PhaseTimers()
    return jt, _port(ds, fanouts, kind, num_sets, params, colors, quantize,
                     **kw), params


def _port(ds, fanouts, kind, num_sets, params=None, colors=None,
          quantize=False, **kw):
    """The port's trainer; ``params`` (flax) replace the model's own
    initialisation."""
    if kind.startswith("r"):
        model = make_hetero_model(kind, DIM, 8, CLASSES, R, 2, num_heads=2,
                                  dropout=0.0)
    else:
        model = make_model(kind, DIM, 8, CLASSES, 2, num_heads=2,
                           dropout=0.0)
    if params is not None:
        model.load_state_dict(params_from_flax(jax.device_get(params)))
    tcache = tsc.ShardedFeatureCache(
        tfc.CacheConfig(**_cfg_kw(num_sets, quantize, colors)), ["cpu"])
    return ShardedResidentTrainer(
        graph=ds.graph, host_fetch=HostFeatureStore(ds.features).fetch,
        labels=ds.labels, cache=tcache, model=model,
        optimizer=torch.optim.Adam(model.parameters(), lr=LR),
        fanouts=fanouts, batch_size=B, colors=colors, **kw)


def _same_cache(tt, jt):
    """Bitwise, but int8 scales within one ulp (JAX's jitted insert
    computes absmax * (1/127), ROADMAP.md section C)."""
    n = tt.cache_cfg.num_sets
    s, js = tt.cache.state, jt.cache.state
    for got, want in ((s.base.tags[:n], js.tags), (s.base.data[:n], js.data),
                      (s.base.rr, js.rr), (s.line_colors[:n], js.line_colors),
                      (s.base.color_counts, js.color_counts),
                      (s.base.hits, js.hits), (s.base.misses, js.misses)):
        want = np.asarray(want)[0]
        assert got.numpy().tobytes() == want.tobytes()
    if js.scales is not None:
        np.testing.assert_array_max_ulp(s.base.scales[:n].numpy(),
                                        np.asarray(js.scales)[0], maxulp=1)


def _grids(ds, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(ds.train_idx, B, replace=False)
                     for _ in range(n)]).astype(np.int32)[:, None]  # [n,1,B]


def _gens(step):
    """A port step's (sampling, dropout) generators."""
    return (step_generators(0, step, 1, SAMPLE, "cpu")[0],
            step_generators(0, step, 1, DROPOUT, "cpu")[0])


def _drive(jt, tt, params, grids, K, valid, eval_grids):
    """Both trainers through the CLI's schedule: one per-step step, then
    per-step steps with one begin ahead (K = 1) or windows of K, then a
    masked tail step and eval steps. -> (JAX losses, port losses, JAX eval
    counts, port eval counts)."""
    opt = jt.tx.init(params)
    key = jax.random.key(1)
    jl, tl = [], []

    def step_both(jh_, th_, t_step, v=None):
        nonlocal params, opt
        params, opt, loss, _ = jt.train_step(params, opt, key,
                                             jt.resolve(jh_), valid=v)
        jl.append(float(loss))
        tl.append(float(tt.train_step(tt.resolve(th_), _gens(t_step)[1],
                                      valid=v)[0]))

    step_both(jt.begin(grids[0], key), tt.begin(grids[0], _gens(0)[0]), 0)
    n, it = len(grids) - 1, 1
    if K == 1:
        pend = None
        while it < n:
            nxt = pend or (jt.begin(grids[it], key),
                           tt.begin(grids[it], _gens(it)[0]))
            pend = None
            if it + 1 < n:
                pend = (jt.begin(grids[it + 1], key),
                        tt.begin(grids[it + 1], _gens(it + 1)[0]))
            step_both(*nxt, it)
            it += 1
    else:
        while it < n:
            grid = np.swapaxes(grids[it:it + K], 0, 1)       # [1, K, B]
            params, opt, losses, jedges = jt.train_window(params, opt, grid,
                                                          key)
            tlosses, tedges = tt.train_window(grid, 0, window=it)
            jl += np.asarray(losses).tolist()
            tl += tlosses.tolist()
            np.testing.assert_array_equal(tedges.numpy(), np.asarray(jedges))
            it += K
    step_both(jt.begin(grids[n], key), tt.begin(grids[n], _gens(n)[0]), n,
              valid)
    je = [jt.eval_step(params, jt.resolve(jt.begin(g, key)), valid=valid)
          for g in eval_grids]
    te = [tt.eval_step(tt.resolve(tt.begin(g, _gens(0)[0])), valid=valid)
          for g in eval_grids]
    return np.asarray(jl), np.asarray(tl), je, te


CASES = [(kind, K, sets) for kind in ("sage", "gat", "rgat")
         for K in (1, 4) for sets in (FULL, EVICTS)]


@pytest.mark.parametrize("kind,K,num_sets", CASES)
def test_run_matches_jax(data, kind, K, num_sets):
    ds, typed, fanouts = data
    ds = typed if kind.startswith("r") else ds
    jt, tt, params = _pair(ds, fanouts, kind, num_sets)
    grids = _grids(ds, 1 + 2 * K + 1, 3)
    valid = np.ones((1, B), bool)
    valid[0, B // 2:] = False
    jl, tl, je, te = _drive(jt, tt, params, grids, K, valid,
                            _grids(ds, 2, 4))
    assert tl.shape == (2 * K + 2,) and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, **(TOL if kind == "sage"
                                          else ADAM_ATTN_TOL))
    assert te == je
    ts, js = tt.stats(), jt.stats()
    assert ts == js and ts["hits"] > 0 and ts["misses"] > 0
    _same_cache(tt, jt)
    if num_sets == EVICTS and K > 1:
        assert tt.timers.tallies["stage_rows"] > 0
    for t in (jt, tt):
        assert "replay" not in t.timers.totals


def test_colors_and_int8_lines_match_jax(data):
    """Colored inserts (per-step repair and the stage's offer) and int8
    lines under pressure: counters, color counts and the int8 cache equal
    JAX's."""
    ds, _, fanouts = data
    colors = np.random.default_rng(2).integers(0, 5, ds.graph.num_nodes)
    kw = dict(num_sets=EVICTS, quantize=True)
    jt, tt, params = _pair(ds, fanouts, "sage", colors=colors, **kw)
    assert tt.stage_transport == jt.stage_transport == "int8"
    jl, tl, je, te = _drive(jt, tt, params, _grids(ds, 6, 7), 4, None,
                            _grids(ds, 1, 8))
    np.testing.assert_allclose(tl, jl, **TOL)
    assert te == je and tt.stats() == jt.stats()
    _same_cache(tt, jt)
    assert int(tt.cache.state.base.color_counts.sum()) > 0


# ---- the one-device subjects of tests/test_sharded_resident.py -------------

def test_features_exact(data):
    """begin / resolve on a cold cache: every valid frontier row equals the
    node's features; labels are the seeds'."""
    ds, _, fanouts = data
    tt = _port(ds, fanouts, "sage", EVICTS)
    for trial, grid in enumerate(_grids(ds, 3, 0)):
        h = tt.begin(grid, _gens(trial)[0])
        _, feats, y = tt.resolve(h)
        ids, valid = h.ids.numpy(), h.valid.numpy()
        np.testing.assert_array_equal(feats.numpy()[valid],
                                      ds.features[ids[valid]])
        np.testing.assert_array_equal(y.numpy(), ds.labels[grid[0]])


def test_trains_and_hits(data):
    ds, _, fanouts = data
    tt = _port(ds, fanouts, "sage", FULL)
    losses = []
    for step, grid in enumerate(np.tile(_grids(ds, 2, 1), (4, 1, 1))):
        g_sample, g_drop = _gens(step)
        losses.append(float(tt.train_step(tt.resolve(tt.begin(
            grid, g_sample)), g_drop)[0]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert tt.stats()["hits"] > 0


def test_masked_tail_exactness(data):
    """The masked step ignores what invalid slots hold (their labels), and
    an all-true mask equals the unmasked step."""
    ds, _, fanouts = data

    def once(relabel, valid):
        tt = _port(ds, fanouts, "sage", FULL)
        blocks, feats, y = tt.resolve(tt.begin(_grids(ds, 1, 23)[0],
                                               _gens(0)[0]))
        if relabel:
            y = y.clone()
            y[~torch.from_numpy(valid[0])] += 1
            y %= CLASSES
        loss, acc = tt.train_step((blocks, feats, y), None, valid=valid)
        return float(loss), float(acc), tt.model.state_dict()

    valid = np.ones((1, B), bool)
    valid[0, B // 2:] = False
    a, b = once(False, valid), once(True, valid)
    assert a[:2] == b[:2]
    for k in a[2]:
        torch.testing.assert_close(a[2][k], b[2][k], rtol=0, atol=0)
    m = once(False, np.ones((1, B), bool))
    tt = _port(ds, fanouts, "sage", FULL)
    loss, acc = tt.train_step(tt.resolve(tt.begin(_grids(ds, 1, 23)[0],
                                                  _gens(0)[0])), None)
    assert m[0] == pytest.approx(float(loss), rel=1e-6)
    assert m[1] == pytest.approx(float(acc))
    for k, v in tt.model.state_dict().items():
        torch.testing.assert_close(m[2][k], v, rtol=2e-5, atol=2e-6)


def test_cold_cache_staged_window(data):
    """Cold cache: the probe stages every row the window reads, the window
    runs without replay, deterministically; stage-served rows count as
    misses."""
    ds, _, fanouts = data
    out = []
    for _ in range(2):
        tt = _port(ds, fanouts, "sage", EVICTS)
        losses, _ = tt.train_window(np.swapaxes(_grids(ds, 3, 9), 0, 1), 1)
        out.append(losses.numpy())
        s = tt.stats()
        assert s["misses"] > 0 and "replay" not in tt.timers.totals
        assert tt.timers.tallies["stage_rows"] > 0
    np.testing.assert_array_equal(out[0], out[1])
    assert np.isfinite(out[0]).all()


def test_fused_windows_train(data):
    ds, _, fanouts = data
    tt = _port(ds, fanouts, "sage", FULL)
    grids = np.tile(_grids(ds, 3, 7), (4, 1, 1)).reshape(4, 3, 1, B)
    losses, edges = tt.train_windows(np.swapaxes(grids, 1, 2), 2)
    assert losses.shape == (12,) and torch.isfinite(losses).all()
    assert float(losses[-1]) < float(losses[0]) and (edges > 0).all()


def test_hetero_resident_trains(data):
    """RGCN on the typed graph: hetero blocks through the per-step path and
    a fused window."""
    _, typed, fanouts = data
    tt = _port(typed, fanouts, "rgcn", EVICTS)
    h = tt.begin(_grids(typed, 1, 0)[0], _gens(0)[0])
    assert all(b.rel is not None for b in h.blocks)
    loss, _ = tt.train_step(tt.resolve(h), None)
    wl, _ = tt.train_window(np.swapaxes(_grids(typed, 2, 1), 0, 1), 3)
    assert np.isfinite(float(loss)) and torch.isfinite(wl).all()


def _staged_losses(ds, fanouts, num_sets, transport, prewarm_all=False):
    tt = _port(ds, fanouts, "sage", num_sets, stage_transport=transport)
    if prewarm_all:
        tt.cache.prewarm(np.arange(ds.graph.num_nodes, dtype=np.int32),
                         HostFeatureStore(ds.features).fetch)
        tt.full_coverage = True
    grids = _grids(ds, 6, 17).reshape(3, 2, 1, B)
    losses, _ = tt.train_windows(np.swapaxes(grids, 1, 2), 7)
    assert "replay" not in tt.timers.totals
    return losses.numpy(), tt.stats()


def test_staged_under_pressure_equals_full_coverage(data):
    ds, _, fanouts = data
    lp, sp = _staged_losses(ds, fanouts, EVICTS, "float32")
    lf, sf = _staged_losses(ds, fanouts, FULL, "float32", prewarm_all=True)
    np.testing.assert_array_equal(lp, lf)
    assert sp["misses"] > 0 and sf["misses"] == 0


def test_bf16_transport_close(data):
    ds, _, fanouts = data
    l32, _ = _staged_losses(ds, fanouts, EVICTS, "float32")
    l16, _ = _staged_losses(ds, fanouts, EVICTS, "bfloat16")
    np.testing.assert_allclose(l32, l16, rtol=0.05, atol=0.05)


# ---- the one-device exchange and the refusals ------------------------------

def test_exchange_is_the_local_lookup(data):
    ds, _, _ = data
    cache = tsc.ShardedFeatureCache(tfc.CacheConfig(**_cfg_kw(EVICTS)),
                                    ["cpu"])
    cache.prewarm(np.arange(0, 600, 3, dtype=np.int32),
                  HostFeatureStore(ds.features).fetch)
    ids = torch.arange(0, 40, dtype=torch.int32)
    valid = ids % 5 != 0
    _, feats, hit, ovf = tsc.exchange_lookup(cache.cfg, cache.state, ids,
                                             valid, count_stats=False)
    probe, povf = tsc.exchange_probe(cache.cfg, cache.state, ids, valid)
    assert not ovf.any() and not povf.any()
    torch.testing.assert_close(probe, hit)
    assert hit.any() and (hit <= valid).all()
    np.testing.assert_array_equal(feats[hit].numpy(),
                                  ds.features[ids[hit].numpy()])
    assert cache.stats()["hits"] == 0          # count_stats=False


@pytest.mark.parametrize("kw,error,item", [
    ({"shard_topology": True, "nbr_cap": 32}, ValueError, "shard_topology"),
    # stage_overlap raised NotImplementedError until it was ported; the
    # case keeps its id and now builds and trains staged windows
    pytest.param({"stage_overlap": True}, None, "staged miss path",
                 id="kw1-NotImplementedError-staged miss path"),
])
def test_unported_options_raise(data, kw, error, item):
    """What is not ported raises naming its ROADMAP.md item; nbr_cap is
    ported (tests/test_torch_resident_nbr_dedup.py) and keeps JAX's
    ValueError with shard_topology. ``stage_overlap`` is ported: the
    trainer builds and trains two staged windows under pressure in the
    overlapped order (the second's stage patched after the first's
    evict-reporting offer; JAX parity: tests/test_torch_sharded_overlap.py)."""
    ds, _, fanouts = data
    if error is not None:
        with pytest.raises(error, match=item):
            _port(ds, fanouts, "sage", FULL, **kw)
        return
    tt = _port(ds, fanouts, "sage", EVICTS, **kw)
    grids = np.swapaxes(_grids(ds, 4, 9).reshape(2, 2, 1, B), 1, 2)
    losses, _ = tt.train_windows(grids, 1)
    assert tt.stage_overlap and torch.isfinite(losses).all()
    assert losses.shape == (4,) and tt.stats()["misses"] > 0
    assert "evict_patch" in tt.timers.totals
    assert "replay" not in tt.timers.totals


def test_shard_topology_is_a_no_op_on_one_rank(data):
    """On one card ``shard_topology`` keeps the replicated topology, as
    JAX's trainer does on a one-device mesh: the same graph on the device
    and the same losses and counters, bitwise (the sharded topology over
    more ranks: tests/test_torch_multigpu_resident.py)."""
    ds, _, fanouts = data
    out = []
    for shard in (False, True):
        tt = _port(ds, fanouts, "sage", EVICTS, shard_topology=shard)
        assert tt.shard_topology == shard
        assert tt.g.indices.shape[0] == ds.graph.num_edges + 1
        losses, edges = tt.train_window(np.swapaxes(_grids(ds, 3, 9), 0, 1),
                                        1)
        out.append((losses.numpy(), edges.numpy(), tt.stats()))
    assert out[0][0].tobytes() == out[1][0].tobytes()
    assert out[0][1].tobytes() == out[1][1].tobytes()
    assert out[0][2] == out[1][2]


def test_resident_trainer_names_the_sharded_trainer(data):
    _, typed, fanouts = data
    with pytest.raises(NotImplementedError, match="ShardedResidentTrainer"):
        ResidentTrainer(graph=typed.graph, host_fetch=None, labels=None,
                        cache_cfg=None, model=None, optimizer=None,
                        fanouts=fanouts, batch_size=B, device="cpu")
