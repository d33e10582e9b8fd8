"""The resident pipeline over 2 and 4 ranks (``ShardedResidentTrainer`` on a
``Mesh``: the cache spread over the ranks, the windows' probes united, the
sharded topology, the data-parallel step) against the JAX package's
``ShardedResidentTrainer`` on a mesh of as many of the 8 virtual CPU
devices.

The port's ranks run in spawned gloo processes (one spawn per world size,
tests/torch_multigpu_ranks.py's ``resident_cases``); rank r trains its row
of the seed grids that JAX's trainer takes whole. Both start from one flax
init (converted for the port) with dropout 0 and fanout = max in-degree,
so neither side's draws matter (rank r samples from its own streams, JAX
folds the device index into its keys: ROADMAP.md section C). Each case
runs a per-step step, per-step steps with one ``begin`` ahead, two
``train_windows`` windows (staged under capacity pressure, or at full
coverage after a prewarm of every node), the masked tail step and eval
steps, in the "sharded", "node_local" and "isolated" modes, with the
replicated topology, the sharded one (``shard_topology``, on a typed graph
too) and the padded table (``nbr_cap``); one case's buckets are small
enough (slack 0.5) that the exchange overflows, and the stage serves what
overflowed. Held to JAX: every loss within 1e-5, the windows' edges
(summed over the ranks) and the eval counts exactly, each rank's cache
state bitwise JAX's shard on its device (int8 scales within one ulp:
JAX's jitted insert multiplies by 1/127), the hit and miss counts equal;
no window replays on either side."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_multigpu_cache as tmc
import torch_multigpu_ranks as ranks
from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.cache.host_tier import HostFeatureStore as JaxStore
from coala_gnn_tpu.models import hetero as jh
from coala_gnn_tpu.models import make_model as jax_make_model
from coala_gnn_tpu.models.layers import DeviceBlock as JBlock
from coala_gnn_tpu.parallel.mesh import make_mesh
from coala_gnn_tpu.parallel.sharded_cache import \
    ShardedFeatureCache as JaxCache
from coala_gnn_tpu.parallel.sharded_resident import \
    ShardedResidentTrainer as JaxTrainer
from coala_gnn_tpu.sampling.neighbor import block_capacities
from coala_gnn_tpu_torch.parallel.multihost import launch
from coala_gnn_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

B, LR, STEPS, K = 16, 1e-2, 3, 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(name, kind, mode, sets, slack=2.0, group_size=0, quantize=False,
          colors=False, shard_topology=False, nbr_cap=False, full=False):
    return dict(name=name, kind=kind, mode=mode, sets=sets, slack=slack,
                group_size=group_size, quantize=quantize, colors=colors,
                shard_topology=shard_topology, nbr_cap=nbr_cap, full=full)


CASES = {
    # 4 sets of 32 ways a rank hold 128 of the 600 rows: windows staged
    2: [_case("sharded-colors", "sage", "sharded", 4, colors=True),
        _case("sharded-topology-typed", "rsage", "sharded", 4,
              shard_topology=True),
        _case("node_local-nbr_cap-overflow", "sage", "node_local", 4,
              slack=0.5, nbr_cap=True),
        _case("isolated-topology", "sage", "isolated", 4,
              shard_topology=True),
        _case("sharded-full-coverage", "sage", "sharded", 32, full=True)],
    4: [_case("sharded-topology", "sage", "sharded", 2,
              shard_topology=True),
        _case("node_local2-int8", "sage", "node_local", 4, group_size=2,
              quantize=True),
        _case("isolated-nbr_cap", "sage", "isolated", 4, nbr_cap=True)],
}
PARAMS = [(n, c["name"]) for n in sorted(CASES) for c in CASES[n]]


@functools.lru_cache(maxsize=None)
def _fanout() -> int:
    return int(ranks.resident_graph(False).graph.in_degrees().max())


@functools.lru_cache(maxsize=None)
def _flax(kind):
    """(flax model, dropout 0, and its params at the contiguous layout)."""
    f = _fanout()
    caps = block_capacities(B, [f, f])
    if kind.startswith("r"):
        jm = jh.make_hetero_model(kind, hidden=8, num_classes=4, num_rels=3,
                                  num_layers=2, num_heads=2, dropout=0.0)
        blocks = [jh.DeviceHeteroBlock(
            adj=None, mask=jnp.ones((caps[l][0], f)),
            rel=jnp.zeros((caps[l][0], f), jnp.int32)) for l in range(2)]
    else:
        jm = jax_make_model(kind, hidden=8, num_classes=4, num_layers=2,
                            num_heads=2, dropout=0.0)
        blocks = [JBlock(adj=None, mask=jnp.ones((caps[l][0], f)))
                  for l in range(2)]
    return jm, jm.init(jax.random.key(0), blocks,
                       jnp.zeros((caps[0][1], 8), jnp.float32))


def _cfg(case, n):
    shards = {"sharded": n, "isolated": 1,
              "node_local": case["group_size"] or n}[case["mode"]]
    return dict(num_sets=case["sets"], ways=jfc.WAYS, dim=8,
                cache_dim=jfc.round_cache_dim(8),
                num_colors=5 if case["colors"] else 0,
                quantize=case["quantize"], num_shards=shards)


def _grids(n, count, seed):
    rng = np.random.default_rng(seed)
    train = ranks.resident_graph(False).train_idx
    return np.stack([np.stack([rng.choice(train, B, replace=False)
                               for _ in range(n)])
                     for _ in range(count)]).astype(np.int32)  # [c, n, B]


def _inputs(case, n):
    """The case's seed grids and the keywords both sides build from."""
    valid = np.ones((n, B), bool)
    valid[:, B // 2:] = False
    windows = np.swapaxes(_grids(n, 2 * K, 11).reshape(2, K, n, B), 1, 2)
    return dict(case, cfg=_cfg(case, n), fanouts=[_fanout()] * 2, batch=B,
                lr=LR, nbr_cap=_fanout() if case["nbr_cap"] else None,
                steps=_grids(n, STEPS, 10), windows=windows,
                tail=_grids(n, 1, 12)[0], valid=valid,
                evals=_grids(n, 2, 13),
                state_dict=params_from_flax(jax.device_get(
                    _flax(case["kind"])[1])))


@functools.lru_cache(maxsize=None)
def _port(n):
    return launch(ranks.resident_cases, n, ["cpu"] * n, "gloo", threads=1,
                  args=([_inputs(c, n) for c in CASES[n]],), timeout=300)


@functools.lru_cache(maxsize=None)
def _jax(n, name):
    """The same sequence on JAX's trainer over ``jax.devices()[:n]``."""
    case = _inputs(next(c for c in CASES[n] if c["name"] == name), n)
    ds = ranks.resident_graph(case["kind"].startswith("r"))
    jm, params = _flax(case["kind"])
    store = JaxStore(ds.features)
    cache = JaxCache(cfg=jfc.CacheConfig(**case["cfg"]),
                     mesh=make_mesh(jax.devices()[:n]), mode=case["mode"],
                     bucket_slack=case["slack"],
                     group_size=case["group_size"])
    jt = JaxTrainer(graph=ds.graph, host_fetch=store.fetch,
                    labels=ds.labels, cache=cache, model=jm,
                    tx=optax.adam(LR), fanouts=case["fanouts"],
                    batch_size=B,
                    colors=ranks.resident_colors() if case["colors"]
                    else None, shard_topology=case["shard_topology"],
                    nbr_cap=case["nbr_cap"])
    opt = jt.tx.init(params)
    key = jax.random.key(1)
    losses = []

    def step(handle, valid=None):
        nonlocal params, opt
        params, opt, loss, _ = jt.train_step(params, opt, key,
                                             jt.resolve(handle), valid=valid)
        losses.append(float(loss))

    steps = case["steps"]
    step(jt.begin(steps[0], key))
    pend = None
    for it in range(1, len(steps)):      # one begin ahead, as the port's
        nxt = pend or jt.begin(steps[it], key)
        pend = jt.begin(steps[it + 1], key) if it + 1 < len(steps) else None
        step(nxt)
    if case["full"]:
        cache.prewarm(np.arange(600, dtype=np.int32), store.fetch,
                      colors=jt.colors)
        jt.full_coverage = True
    params, opt, wl, we = jt.train_windows(params, opt, case["windows"],
                                           key)
    losses += np.asarray(wl).tolist()
    step(jt.begin(case["tail"], key), case["valid"])
    evals = [jt.eval_step(params, jt.resolve(jt.begin(g, key)),
                          valid=case["valid"]) for g in case["evals"]]
    state = tmc._jax_state(cache)
    return {"losses": np.asarray(losses), "edges": np.asarray(we),
            "evals": evals, "state": state, "stats": jt.stats(),
            "replay": "replay" in jt.timers.totals,
            "stage_rows": jt.timers.tallies.get("stage_rows", 0.0)}


@pytest.mark.parametrize("n,name", PARAMS)
def test_resident_ranks_match_jax(n, name):
    case = next(c for c in CASES[n] if c["name"] == name)
    i = CASES[n].index(case)
    want = _jax(n, name)
    assert np.isfinite(want["losses"]).all() and not want["replay"]
    for r in range(n):
        got = _port(n)[r][i]
        what = f"{name} rank {r}"
        np.testing.assert_allclose(got["losses"], want["losses"], **TOL,
                                   err_msg=what)
        np.testing.assert_array_equal(got["edges"], want["edges"])
        assert got["evals"] == want["evals"], what
        tmc._states_equal(got["state"], want["state"], r, what)
        assert got["stats"] == want["stats"], what
        assert not got["replay"], what
        # the union stage: every rank stages the same rows as JAX
        assert got["stage_rows"] == want["stage_rows"], what
    st = want["stats"]
    assert st["hits"] > 0 and (st["misses"] > 0 or case["full"])
    assert (want["stage_rows"] > 0) != case["full"]


@pytest.mark.parametrize("n,name", PARAMS)
def test_resident_rank_collectives(n, name):
    """What each rank hands to the collectives: the sharded topology's
    gathers and scatters only with ``shard_topology``, a probe
    ``all_reduce`` (the bitmap union) per staged window, exchange bytes
    only where the cache routes to more than one rank, the overflow of the
    small-bucket case served without a replay, and every rank's shard of
    the edges below the graph's."""
    case = next(c for c in CASES[n] if c["name"] == name)
    i = CASES[n].index(case)
    E = ranks.resident_graph(False).graph.num_edges
    route = {"sharded": n, "isolated": 1,
             "node_local": case["group_size"] or n}[case["mode"]]
    for r in range(n):
        got = _port(n)[r][i]
        handed = got["ledger"]["handed"]
        assert ("topology" in handed) == case["shard_topology"]
        assert (got["shard_edges"] <= E) == case["shard_topology"]
        assert ("probe" in handed) == (not case["full"])
        assert ("request" in handed) == (route > 1)
        assert handed["grad"] > 0 and handed["control"] > 0
        if case["slack"] < 1:
            assert got["overflow"] > 0 and not got["replay"]
        else:
            assert got["overflow"] == 0
