"""The cache spread over 2 and 4 ranks (``parallel/sharded_cache.py``)
against the JAX package's ``ShardedFeatureCache`` on a mesh of as many of
the 8 virtual CPU devices.

The port's ranks run in spawned processes over gloo
(``multihost.launch``, file-store rendezvous in a fresh temporary
directory); their bodies are tests/torch_multigpu_ranks.py's, which import
no JAX. All cases of one world size share one spawn. Each case prewarms,
inserts rows, then fetches skewed requests (70% of the ids on one owner,
so buckets overflow) with fills, one fetch without; rank r is held to
device r of the JAX mesh:

- the probe's hit and overflow bits, the miss count that decides the miss
  path (the largest of any rank), the fetched features and the whole cache
  state bitwise after every step (int8 lines: scales within one ulp, since
  JAX's jitted insert multiplies by 1/127 where the port divides, and the
  dequantised rows within the two ulps that moves; ROADMAP.md section C);
- a residency probe (``exchange_probe``) bitwise, and the hit and miss
  counters summed over the ranks;
- in "sharded", "node_local" (blocks of 2 at 4 ranks, of 1 at 2, which is
  routing to oneself) and "isolated", f32 and int8 responses;
- and the bytes each rank handed to ``all_to_all_single`` per phase equal
  ``comm_model.step_traffic``'s count (the rank's own bucket row stays),
  the fill's on the steps that fill; isolated ranks hand over nothing.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_multigpu_ranks as ranks
from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.cache.host_tier import HostFeatureStore as JaxStore
from coala_gnn_tpu.parallel import sizing as jsizing
from coala_gnn_tpu.parallel.mesh import DATA_AXIS, make_mesh
from coala_gnn_tpu.parallel.sharded_cache import \
    ShardedFeatureCache as JaxCache
from coala_gnn_tpu.parallel.sharded_cache import _to_local
from coala_gnn_tpu.parallel.sharded_cache import exchange_probe as jprobe
from coala_gnn_tpu_torch.parallel import comm_model
from coala_gnn_tpu_torch.parallel.multihost import launch
from coala_gnn_tpu_torch.parallel.sizing import lookup_bucket_cap

torch.set_num_threads(1)


def _case(name, mode, quantize, colors, slack, group_size=0):
    return dict(name=name, mode=mode, quantize=quantize, colors=colors,
                slack=slack, group_size=group_size)


CASES = {
    # in a group of 2 a slack of 2 makes a bucket as long as the request;
    # 1.0 lets the skewed owner overflow
    2: [_case("sharded-f32-colors", "sharded", False, True, 1.0),
        _case("sharded-int8", "sharded", True, False, 1.0),
        _case("node_local-f32-colors", "node_local", False, True, 1.0),
        _case("node_local1-int8", "node_local", True, False, 1.0, 1),
        _case("isolated-f32-colors", "isolated", False, True, 1.0),
        _case("isolated-int8", "isolated", True, False, 1.0)],
    4: [_case("sharded-f32-colors", "sharded", False, True, 2.0),
        _case("sharded-int8", "sharded", True, False, 2.0),
        _case("node_local2-f32-colors", "node_local", False, True, 1.0, 2),
        _case("node_local2-int8", "node_local", True, False, 1.0, 2),
        _case("isolated-f32", "isolated", False, False, 2.0)],
}
PARAMS = [(n, c["name"]) for n in sorted(CASES) for c in CASES[n]]


@functools.lru_cache(maxsize=None)
def _port(n: int) -> list:
    """Every case of world size ``n`` on ``n`` spawned gloo ranks: [rank]
    -> [case] -> record."""
    return launch(ranks.cache_cases, n, ["cpu"] * n, "gloo", threads=1,
                  args=(CASES[n],))


def _jax_probe(ref, ids, nv):
    """JAX's ``exchange_probe`` under shard_map over ``ref``'s mesh, as the
    JAX trainers call it."""
    cap = jsizing.lookup_bucket_cap(ids.shape[1], ref.n_route,
                                    ref.bucket_slack)
    specs = jax.tree.map(lambda _: P(DATA_AXIS), ref.state)

    def body(state, ids, nv):
        valid = jnp.arange(ids.shape[1]) < nv[0]
        hit, over = jprobe(ref.cfg, cap, ref.n_route, _to_local(state),
                           ids[0], valid, groups=ref.groups)
        return hit[None], over[None]

    f = jax.jit(shard_map(body, mesh=ref.mesh,
                          in_specs=(specs, P(DATA_AXIS), P(DATA_AXIS)),
                          out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
                          check_vma=False))
    return [np.asarray(a) for a in f(ref.state, jnp.asarray(ids),
                                     jnp.asarray(nv))]


@functools.lru_cache(maxsize=None)
def _jax(n: int, name: str) -> dict:
    """The same sequence on JAX's cache over ``jax.devices()[:n]``."""
    case = next(c for c in CASES[n] if c["name"] == name)
    feats, cols = ranks.features(), ranks.colors()
    store = JaxStore(feats)
    ref = JaxCache(cfg=jfc.CacheConfig(**ranks.cache_config(case, n)),
                   mesh=make_mesh(jax.devices()[:n]), mode=case["mode"],
                   bucket_slack=case["slack"],
                   group_size=case["group_size"])
    color = cols if case["colors"] else None
    warm, rows, rcols = ranks.warm_ids()
    ref.prewarm(warm, store.fetch, colors=color, chunk=64)
    ref.insert_rows(rows, feats[rows], rcols if case["colors"] else None,
                    chunk=64)
    rec = {"warm": _jax_state(ref), "steps": []}
    for step in range(ranks.FETCHES):
        ids, nv = ranks.request(n, step)
        h = ref.fetch_begin(ids, nv)
        got = ref.fetch_complete(h, store.fetch, colors=color,
                                 fill=step != ranks.NO_FILL)
        rec["steps"].append({"hit": np.asarray(h[4]),
                             "overflow": np.asarray(h[5]),
                             "miss_max": int(np.asarray(h[7])),
                             "feats": np.asarray(got),
                             "state": _jax_state(ref)})
    rec["probe"] = _jax_probe(ref, *ranks.request(n, ranks.FETCHES))
    rec["stats"] = ref.stats()
    rec["color_counts"] = np.asarray(ref.state.color_counts)
    return rec


def _jax_state(ref) -> dict:
    s = ref.state
    out = {"tags": s.tags, "data": s.data, "rr": s.rr,
           "line_colors": s.line_colors, "color_counts": s.color_counts,
           "hits": s.hits, "misses": s.misses}
    if s.scales is not None:
        out["scales"] = s.scales
    return {k: np.asarray(v) for k, v in out.items()}


def _bitwise(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _states_equal(got: dict, want: dict, r: int, what: str) -> None:
    assert set(got) == set(want), what
    for k in got:
        if k == "scales":
            np.testing.assert_array_max_ulp(got[k], want[k][r], maxulp=1)
        else:
            _bitwise(got[k], want[k][r], f"{what}: {k}")


@pytest.mark.parametrize("n,name", PARAMS)
def test_exchange_matches_jax(n, name):
    case = next(c for c in CASES[n] if c["name"] == name)
    i = CASES[n].index(case)
    want = _jax(n, name)
    overflowed = 0
    for r in range(n):
        got = _port(n)[r][i]
        _states_equal(got["warm"], want["warm"], r, "prewarm + insert_rows")
        for s, (g, w) in enumerate(zip(got["steps"], want["steps"])):
            what = f"rank {r} fetch {s}"
            _bitwise(g["hit"][0], w["hit"][r], what + " hit")
            _bitwise(g["overflow"][0], w["overflow"][r], what + " overflow")
            overflowed += int(g["overflow"].sum())
            if case["mode"] != "isolated":
                assert g["miss_count"] == w["miss_max"], what
            if case["quantize"]:
                np.testing.assert_array_max_ulp(g["feats"][0],
                                                w["feats"][r], maxulp=2)
            else:
                _bitwise(g["feats"][0], w["feats"][r], what + " feats")
            _states_equal(g["state"], w["state"], r, what)
        _bitwise(got["probe"][0][0], want["probe"][0][r], "probe hit")
        _bitwise(got["probe"][1][0], want["probe"][1][r], "probe overflow")
        assert got["stats"] == want["stats"]
        _bitwise(got["color_meta"], want["color_counts"][r], "color meta")
    # the skewed requests overflow wherever there is an exchange
    routed = {"sharded": n, "isolated": 1,
              "node_local": case["group_size"] or n}[case["mode"]]
    assert (overflowed > 0) == (routed > 1)
    assert want["stats"]["hits"] > 0 and want["stats"]["misses"] > 0


@pytest.mark.parametrize("n,name", PARAMS)
def test_exchange_bytes_equal_comm_model(n, name):
    """``comm_model.step_traffic`` counts what each rank hands to the
    exchange's all-to-alls: request ids, response rows (int8 lines and f32
    scales, or f32 rows) and hit bits on every fetch, the fill's ids, rows
    and colors on a fetch that fills after a miss (its buckets sized from
    the largest miss count of any rank); one all-reduce of that count per
    fetch, and nothing at all in isolated mode."""
    case = next(c for c in CASES[n] if c["name"] == name)
    i = CASES[n].index(case)
    group = {"sharded": n, "isolated": 1,
             "node_local": case["group_size"] or n}[case["mode"]]
    for r in range(n):
        for s, step in enumerate(_port(n)[r][i]["steps"]):
            led = step["ledger"]
            handed, kept = led["handed"], led["kept"]
            fills = s != ranks.NO_FILL and step["miss_count"] > 0
            want = comm_model.step_traffic(
                case["mode"], ranks.N_REQ, n_dev=n,
                local=group if case["mode"] == "node_local" else n,
                dim=ranks.DIM, int8_response=case["quantize"],
                slack=case["slack"],
                misses=step["miss_count"] if fills else 0)
            assert want["group"] == group
            if group == 1:
                assert want["exchange"]["off_device"]["total"] == 0
                assert set(handed) <= {"control"}
            for phase in ("request", "response", "hitbits"):
                off = handed.get(phase, 0) - kept.get(phase, 0)
                assert off == want["exchange"]["off_device"][phase], phase
                if group > 1:
                    assert kept[phase] * group == handed[phase], phase
            assert (handed.get("fill", 0) - kept.get("fill", 0)
                    == want["fill_miss_step"]["off_device"])
            assert (handed.get("fill", 0) > 0) == (fills and group > 1)
            if group > 1:
                assert want["bucket_cap"] == lookup_bucket_cap(
                    ranks.N_REQ, group, case["slack"])
            # the miss decision: one 4-byte all-reduce, none when isolated
            assert handed.get("control", 0) == (
                0 if case["mode"] == "isolated" else 4)
