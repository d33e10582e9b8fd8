"""``coala_gnn_tpu_torch.sampling.sharded_topology`` (the topology sharded
over the ranks, sampled by routing the frontier) against the JAX package's
``sampling/sharded_topology.py`` on a mesh of 2 and 4 of the 8 virtual CPU
devices.

- ``shard_topology_arrays`` bitwise JAX's: every rank's shard, one rank's
  alone, chunked builds (chunks of 7 and 64 rows), indices as a memory
  map, the typed graph's edge types.
- ``sample_blocks_sharded`` on spawned gloo ranks (one spawn per world
  size, tests/torch_multigpu_ranks.py's ``topology_cases``): at fanout =
  max in-degree (no draw matters) its masks, relations, input ids and
  counts bitwise JAX's ``sample_blocks_sharded`` under ``shard_map``;
  at fanout below the degrees, given uniforms over the gathered grid,
  each layer and the whole blocks bitwise the port's replicated sampler
  (``_sample_layer`` / ``sample_blocks_device``) on the uniforms that each
  dst's owner used; each rank's shard on its card equal to the host build.
- the ``"topology"`` bytes in each rank's ledger: per layer an all-gather
  of the dst ids (4 bytes a slot to each rank) and one reduce-scatter of
  the packed [world * cap, 2 * fanout + 1] (typed) or [.., fanout + 1]
  int32 grid."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_multigpu_ranks as ranks
from coala_gnn_tpu.parallel.mesh import DATA_AXIS, make_mesh
from coala_gnn_tpu.sampling import sharded_topology as jst
from coala_gnn_tpu_torch.parallel.multihost import launch
from coala_gnn_tpu_torch.sampling import sharded_topology as st
from coala_gnn_tpu_torch.sampling.neighbor import block_capacities

B = 8


def _graph(typed):
    return ranks.resident_graph(typed).graph


def _max_deg():
    return int(_graph(False).in_degrees().max())


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("chunk", [7, 64, 1 << 20])
def test_shard_arrays_bitwise_jax(n, typed, chunk):
    g = _graph(typed)
    got = st.shard_topology_arrays(g, n, chunk_rows=chunk)
    want = jst.shard_topology_arrays(g, n, chunk_rows=chunk)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # one rank's shard alone: the same rows, max_e still the largest rank's
    one = st.shard_topology_arrays(g, n, device_ids=[n - 1],
                                   chunk_rows=chunk)
    assert one[1].shape == (1, got[1].shape[1])
    assert one[0].tobytes() == got[0][n - 1:].tobytes()
    # every edge lands on its destination's owner
    ptr, idx = got[0].astype(np.int64), got[1]
    assert sum(int(p[-1]) for p in ptr) == g.num_edges
    ip = np.asarray(g.indptr)
    for node in (0, 1, 599, 123):
        d, row = node % n, node // n
        np.testing.assert_array_equal(
            idx[d, ptr[d, row]:ptr[d, row + 1]],
            np.asarray(g.indices)[ip[node]:ip[node + 1]])


def test_shard_arrays_from_a_memory_map(tmp_path):
    """Indices and edge types as memory maps (never read whole): the same
    shards as from arrays in memory."""
    g = _graph(True)
    mm = {}
    for name in ("indices", "edge_types"):
        a = np.asarray(getattr(g, name), np.int32)
        m = np.lib.format.open_memmap(str(tmp_path / f"{name}.npy"),
                                      mode="w+", dtype=np.int32,
                                      shape=a.shape)
        m[:] = a
        m.flush()
        mm[name] = np.load(str(tmp_path / f"{name}.npy"), mmap_mode="r")
    mapped = dataclasses.replace(g, **mm)
    for a, b in zip(st.shard_topology_arrays(mapped, 4, chunk_rows=16),
                    jst.shard_topology_arrays(g, 4, chunk_rows=16)):
        assert a.tobytes() == b.tobytes()


def _uniforms(n, fanouts, seed):
    """Per layer, every rank's uniforms over its gathered grid: f32 [n, n *
    cap_dst, fanout]."""
    caps = block_capacities(B, fanouts)
    rng = np.random.default_rng(seed)
    return [rng.random((n, n * caps[layer][0], fanouts[layer]),
                       dtype=np.float32) for layer in range(len(fanouts))]


def _seeds(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(600, B, replace=False)
                     for _ in range(n)]).astype(np.int32)


def _cases(n):
    full = [_max_deg()] * 2
    return [dict(typed=False, fanouts=full, batch=B, seeds=_seeds(n, 1),
                 uniforms=None),
            dict(typed=True, fanouts=full, batch=B, seeds=_seeds(n, 2),
                 uniforms=None),
            dict(typed=False, fanouts=[3, 2], batch=B, seeds=_seeds(n, 3),
                 uniforms=_uniforms(n, [3, 2], 4)),
            dict(typed=True, fanouts=[2, 3], batch=B, seeds=_seeds(n, 5),
                 uniforms=_uniforms(n, [2, 3], 6))]


@functools.lru_cache(maxsize=None)
def _port(n):
    return launch(ranks.topology_cases, n, ["cpu"] * n, "gloo", threads=1,
                  args=(_cases(n),), timeout=120)


def _jax_blocks(n, case):
    """JAX's ``sample_blocks_sharded`` under shard_map over n devices:
    (masks [n, ...] per layer, rels or None per layer, ids [n, cap0], num
    [n])."""
    g = _graph(case["typed"])
    mesh = make_mesh(jax.devices()[:n])
    topo = jst.put_sharded_topology(g, mesh)
    specs = jax.tree.map(lambda _: P(DATA_AXIS, None), topo)
    fanouts, L = case["fanouts"], len(case["fanouts"])

    def body(t, seeds, key):
        blocks, ids, num = jst.sample_blocks_sharded(
            t, g.num_nodes, seeds[0], fanouts, B, key, n)
        rels = [b.rel[None] for b in blocks] if case["typed"] else []
        return [b.mask[None] for b in blocks], rels, ids[None], num[None]

    f = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(specs, P(DATA_AXIS), P()),
        out_specs=([P(DATA_AXIS)] * L, [P(DATA_AXIS)] * (
            L if case["typed"] else 0), P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False))
    masks, rels, ids, num = f(topo, jnp.asarray(case["seeds"]),
                              jax.random.key(0))
    return ([np.asarray(m) for m in masks],
            [np.asarray(r) for r in rels] or [None] * L,
            np.asarray(ids), np.asarray(num))


def _bitwise(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("typed", [False, True])
def test_sampler_bitwise_jax(n, typed):
    i = 1 if typed else 0
    case = _cases(n)[i]
    masks, rels, ids, num = _jax_blocks(n, case)
    ptrs, idx, _ = st.shard_topology_arrays(_graph(typed), n)
    for r in range(n):
        got = _port(n)[r][i]
        for layer in range(2):
            _bitwise(got["masks"][layer], masks[layer][r], f"mask {layer}")
            if typed:
                _bitwise(got["rels"][layer], rels[layer][r], f"rel {layer}")
            else:
                assert got["rels"][layer] is None
        _bitwise(got["ids"], ids[r], "ids")
        assert got["num"] == int(num[r]) > B
        # the rank's shard on its card: the host build's row r, one pad
        np.testing.assert_array_equal(got["indptr"], ptrs[r])
        _bitwise(got["indices"][:-1], idx[r], "indices")
        assert got["indices"][-1] == 0


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("typed", [False, True])
def test_sampler_equals_replicated_on_routed_uniforms(n, typed):
    """Below the degrees (draws matter): the owner's uniforms give the
    replicated sampler's slots, layer by layer and whole."""
    i = 3 if typed else 2
    for r in range(n):
        got = _port(n)[r][i]
        sampled_past_degree = False
        for (nbr, mask, rel), (wnbr, wmask, wrel) in got["layers"]:
            _bitwise(nbr, wnbr, "nbr")
            _bitwise(mask, wmask, "mask")
            if typed:
                _bitwise(rel, wrel, "rel")
            sampled_past_degree |= bool(mask.all(axis=1).any())
        assert sampled_past_degree
        rep = got["replicated"]
        for layer in range(2):
            _bitwise(got["masks"][layer], rep["masks"][layer], "mask")
            if typed:
                _bitwise(got["rels"][layer], rep["rels"][layer], "rel")
        _bitwise(got["ids"], rep["ids"], "ids")
        assert got["num"] == rep["num"]


@pytest.mark.parametrize("n", [2, 4])
def test_topology_bytes_in_the_ledger(n):
    """Per layer: the all-gather hands the rank's [cap_dst] int32 ids to
    each of the n ranks (itself included), the reduce-scatter its packed
    int32 grid [n * cap_dst, fanout + 1 (+ fanout typed)], keeping 1/n."""
    for i, case in enumerate(_cases(n)):
        caps = block_capacities(B, case["fanouts"])
        handed = kept = 0
        for layer, f in enumerate(case["fanouts"]):
            cap = caps[layer][0]
            width = 2 * f + 1 if case["typed"] else f + 1
            handed += 4 * cap * n + 4 * n * cap * width
            kept += 4 * cap + 4 * cap * width
        for r in range(n):
            led = _port(n)[r][i]["ledger"]
            assert led["handed"] == {"topology": handed}
            assert led["kept"] == {"topology": kept}
            assert led["calls"] == {"topology": 2 * len(case["fanouts"])}
