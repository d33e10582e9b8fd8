"""The overlapped staged schedule on ``ShardedResidentTrainer``
(``stage_overlap=True``: probe(w+1) read before window w, the offer
reporting the ids it evicted, gathered from every rank, and those rows
patched into stage w+1) against the JAX package's trainer with
``stage_overlap=True`` on a mesh of as many of the 8 virtual CPU devices,
and against the port's own serial schedule.

One rank runs in this process (a ``Mesh`` of one CPU device); 2 and 4
ranks run in spawned gloo processes (tests/torch_multigpu_ranks.py's
``overlap_cases``, one spawn per world size), rank r on its row of the
seed grids that JAX's trainer takes whole. Both sides start from one flax
init with dropout 0 and fanout = max in-degree (tests/
test_torch_multigpu_resident.py's inputs), and train 3 windows of K = 2
(one case 8) under capacity pressure (4 sets of 32 ways a rank for 600
rows), with f32 or int8 stage transport and int8 lines, in the "sharded",
"node_local" and "isolated" modes. Held: the overlapped losses within 1e-5
of JAX's and the port's serial losses bitwise up to the first step that
reads a row at another precision in the two schedules (and within
``SPLIT_TOL`` from it), the windows' edges equal, each rank's
cache state bitwise JAX's shard (int8 scales within one ulp), hit counts
JAX's, ``evict_patch`` timed, patch rows merged in, no replay on either
side. The evict-reporting ``insert_rows``
returns the same ids on every rank, JAX's ``_insert_evict_kernel`` output
(its per-chunk gathers reordered rank-major), with the state bitwise
JAX's."""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

import test_torch_multigpu_cache as tmc
import test_torch_multigpu_resident as tmr
import torch_multigpu_ranks as ranks
from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.cache.host_tier import HostFeatureStore as JaxStore
from coala_gnn_tpu.parallel.mesh import make_mesh
from coala_gnn_tpu.parallel.sharded_cache import \
    ShardedFeatureCache as JaxCache
from coala_gnn_tpu.parallel.sharded_resident import \
    ShardedResidentTrainer as JaxTrainer
from coala_gnn_tpu_torch.parallel.mesh import as_mesh
from coala_gnn_tpu_torch.parallel.multihost import launch

torch.set_num_threads(1)

M, K = 3, 2            # windows of K steps; overlap needs M > 1
CHUNK = 64             # insert_rows' chunk in the evicted-id check
TOL = dict(rtol=1e-5, atol=1e-5)
#: overlap vs serial from the first step that reads a row at f32 in one
#: schedule and dequantised from int8 in the other (the long case's
#: losses part by at most 5.1e-4 relative over its last 10 steps)
SPLIT_TOL = dict(rtol=5e-3, atol=1e-4)


def _case(name, mode, transport="auto", quantize=False, colors=False,
          group_size=0, n_windows=M, splits=False):
    """``splits``: the run reaches a step that reads a row at another
    precision in the two schedules (``_precision_split``)."""
    return dict(tmr._case(name, "sage", mode, 4, group_size=group_size,
                          quantize=quantize, colors=colors),
                transport=transport, n_windows=n_windows, splits=splits)


CASES = {
    1: [_case("f32", "sharded", "float32", colors=True),
        _case("int8-transport", "sharded", "int8"),
        _case("int8-lines", "sharded", quantize=True),
        _case("int8-transport-long", "sharded", "int8", n_windows=8,
              splits=True)],
    2: [_case("sharded-colors", "sharded", colors=True),
        _case("node_local-int8-transport", "node_local", "int8"),
        _case("isolated", "isolated")],
    4: [_case("sharded-int8-lines", "sharded", quantize=True),
        _case("node_local2", "node_local", group_size=2),
        _case("isolated-int8-transport", "isolated", "int8")],
}
PARAMS = [(n, c["name"]) for n in sorted(CASES) for c in CASES[n]]


def _inputs(case, n):
    """The case's windows [m, n, K, B] (m = its ``n_windows``) and the
    keywords both sides build from."""
    m = case["n_windows"]
    windows = np.swapaxes(tmr._grids(n, m * K, 21).reshape(m, K, n, tmr.B),
                          1, 2)
    return dict(case, cfg=tmr._cfg(case, n), fanouts=[tmr._fanout()] * 2,
                batch=tmr.B, lr=tmr.LR, nbr_cap=None, windows=windows,
                state_dict=tmr._inputs(case, n)["state_dict"])


@functools.lru_cache(maxsize=None)
def _port(n):
    """Each rank's records of every case of world ``n``."""
    cases = [_inputs(c, n) for c in CASES[n]]
    if n == 1:
        return [ranks.overlap_cases(as_mesh(["cpu"]), cases)]
    return launch(ranks.overlap_cases, n, ["cpu"] * n, "gloo", threads=1,
                  args=(cases,), timeout=300)


@functools.lru_cache(maxsize=None)
def _jax(n, name):
    """JAX's overlapped trainer over ``jax.devices()[:n]`` on the case's
    windows, then its evict-reporting ``insert_rows`` on a fresh cache."""
    case = _inputs(next(c for c in CASES[n] if c["name"] == name), n)
    ds = ranks.resident_graph(False)
    jm, params = tmr._flax("sage")
    store = JaxStore(ds.features)
    colors = ranks.resident_colors() if case["colors"] else None
    mesh = make_mesh(jax.devices()[:n])

    def cache():
        return JaxCache(cfg=jfc.CacheConfig(**case["cfg"]), mesh=mesh,
                        mode=case["mode"], bucket_slack=case["slack"],
                        group_size=case["group_size"])

    jt = JaxTrainer(graph=ds.graph, host_fetch=store.fetch,
                    labels=ds.labels, cache=cache(), model=jm,
                    tx=optax.adam(tmr.LR), fanouts=case["fanouts"],
                    batch_size=tmr.B, colors=colors,
                    stage_transport=case["transport"], stage_overlap=True)
    _, _, wl, we = jt.train_windows(params, jt.tx.init(params),
                                    case["windows"], jax.random.key(1))
    out = {"losses": np.asarray(wl), "edges": np.asarray(we),
           "state": tmc._jax_state(jt.cache), "stats": jt.stats(),
           "replay": "replay" in jt.timers.totals,
           "evict_patch": "evict_patch" in jt.timers.totals}
    c = cache()
    warm, ids = ranks.overlap_insert_ids()
    c.prewarm(warm, store.fetch, colors=colors)
    ev = c.insert_rows(ids, store.fetch(ids),
                       None if colors is None else colors[ids],
                       chunk=CHUNK, return_evicted=True)
    out["evicted"] = np.concatenate([np.asarray(e) for e in ev])
    out["evict_state"] = tmc._jax_state(c)
    return out


def _record(n, name):
    i = [c["name"] for c in CASES[n]].index(name)
    return [rank[i] for rank in _port(n)]


@pytest.mark.parametrize("n,name", PARAMS)
def test_overlap_matches_jax(n, name):
    want = _jax(n, name)
    assert np.isfinite(want["losses"]).all() and not want["replay"]
    assert want["evict_patch"] and want["stats"]["misses"] > 0
    for r, rec in enumerate(_record(n, name)):
        got, what = rec[True], f"{name} rank {r}"
        np.testing.assert_allclose(got["losses"], want["losses"], **TOL,
                                   err_msg=what)
        np.testing.assert_array_equal(got["edges"], want["edges"])
        tmc._states_equal(got["state"], want["state"], r, what)
        assert got["stats"] == want["stats"], what
        assert got["evict_patch"] and not got["replay"], what


def _precision_split(case, recs) -> int:
    """The steps the two schedules must train bitwise alike: all of them
    where a stage row is the cache line it stands for (f32 transport over
    f32 lines, int8 transport over int8 lines); with int8 transport over
    f32 lines, those before the first step at which some rank reads a
    frontier row from its cache in one schedule (at f32) and from its
    stage in the other (dequantised)."""
    steps = recs[0][False]["losses"].size
    if not (case["transport"] == "int8" and not case["quantize"]):
        return steps
    for rec in recs:
        a, b = rec[False]["cache_reads"], rec[True]["cache_reads"]
        assert a.shape == b.shape == (steps, a.shape[1])
        split = np.flatnonzero((a != b).any(axis=1))
        steps = min(steps, int(split[0]) if split.size else steps)
    return steps


@pytest.mark.parametrize("n,name", PARAMS)
def test_overlap_equals_serial(n, name):
    """The two schedules train alike to the last bit up to the first step
    that reads a row at another precision in one of them: a window reads
    a row from the cache where it is resident and from the stage where it
    is not, and both stages hold every row the window misses. The caches
    part ways (JAX's rule, not a fault): a row the previous offer evicted
    rides in the overlapped stage as a patch row and is not offered
    again, where the serial probe finds it missing and offers it. With a
    stage row equal to its cache line that changes no value, and the
    losses are bitwise alike throughout; with int8 transport over f32
    lines one schedule may read at f32 a row the other reads dequantised,
    so the losses are bitwise alike before that step (``_precision_split``)
    and within ``SPLIT_TOL`` from it. The overlapped run patched rows in,
    and only it gathers evicted ids (over more than one rank)."""
    case = next(c for c in CASES[n] if c["name"] == name)
    recs = _record(n, name)
    split = _precision_split(case, recs)
    assert (split < recs[0][False]["losses"].size) == case["splits"]
    for r, rec in enumerate(recs):
        ser, ovl, what = rec[False], rec[True], f"{name} rank {r}"
        assert ovl["losses"][:split].tobytes() == \
            ser["losses"][:split].tobytes(), what
        np.testing.assert_allclose(ovl["losses"][split:],
                                   ser["losses"][split:], **SPLIT_TOL,
                                   err_msg=what)
        assert ovl["edges"].tobytes() == ser["edges"].tobytes(), what
        assert ser["stats"]["misses"] > 0 and not ser["replay"], what
        assert not ser["evict_patch"], what
        m = case["n_windows"]
        assert len(ovl["patched"]) == m - 1 and sum(ovl["patched"]) > 0, \
            what
        gathered = ovl["ledger"]["calls"].get("evicted", 0)
        assert gathered == (m - 1 if n > 1 else 0), what
        assert "evicted" not in ser["ledger"]["calls"], what


@pytest.mark.parametrize("n,name", PARAMS)
def test_evicted_ids_gathered_like_jax(n, name):
    """``insert_rows(return_evicted=True)``: the same array on every rank,
    [world * n_chunks * CHUNK] rank-major, equal to JAX's per-chunk
    gathers (chunk-major) reordered; evictions happened; each rank's
    state bitwise JAX's shard."""
    want = _jax(n, name)
    recs = _record(n, name)
    got = recs[0]["evicted"]
    for r, rec in enumerate(recs):
        assert rec["evicted"].tobytes() == got.tobytes(), f"rank {r}"
        tmc._states_equal(rec["evict_state"], want["evict_state"], r,
                          f"{name} rank {r}")
    assert got.dtype == np.int32 and got.size % (n * CHUNK) == 0
    chunks = got.size // (n * CHUNK)
    np.testing.assert_array_equal(
        got.reshape(n, chunks, CHUNK).transpose(1, 0, 2).reshape(-1),
        want["evicted"])
    assert (got >= 0).any() and (got == -1).any()
