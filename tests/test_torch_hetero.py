"""The hetero models (RSAGE, RGCN, RGAT) and typed sampling of
coala_gnn_tpu_torch against the JAX package, on the CPU:

- typed host sampling, native and numpy, bit for bit JAX's (adj, mask,
  rel, input ids), the typed native draw equal to the untyped one,
  ``coo_to_csc(edge_types=)`` and ``HostBatch.rels`` bitwise, and typed
  device sampling given JAX's uniforms bitwise (``rel`` included);
- each relational layer on both block layouts against flax with params
  carried by ``utils/convert.py``: forward rtol = atol = 1e-5 (f32 matmuls
  and sums over the same inputs; RGAT also the softmax, whose exp differs
  in its last bits), gradients against ``jax.grad`` 1e-4 (two more matmul
  chains and a softmax), bf16 2e-2 (tests/test_torch_bf16.py's tolerance)
  with JAX's output dtype (f32 for RGAT on the ``adj`` layout);
- the relation-stacked neighbour sum (one gather-SpMM call for all
  relations) equal to a loop of per-relation ``padded_gather_sum`` (1e-6;
  on the CPU both are the slot-order loop, so equal to the bit);
- whole runs of the CLI's own loop (``train.build`` / ``train.train``,
  dropout 0) against a loop of JAX pieces (its sampler,
  ``hetero_blocks_to_device``, ``make_hetero_model``, ``optax.adam``) from
  one set of params: losses within 1e-5 (rtol = atol; Adam on both sides
  over the same f32 sums), RGAT with SGD at 1e-5 and with Adam at 2e-4
  (``ADAM_RGAT_TOL``);
- the CLI on ``--device cpu`` with a hetero model, and what it refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from coala_gnn_tpu.data.loader import CoalaDataLoader as JaxLoader
from coala_gnn_tpu.distribution import DistributionScheduler as JaxScheduler
from coala_gnn_tpu.distribution import SeedDistributor as JaxDistributor
from coala_gnn_tpu.graph.csc import coo_to_csc as jax_coo_to_csc
from coala_gnn_tpu.graph.datasets import synthetic_graph as jax_synthetic
from coala_gnn_tpu.models import hetero as jh
from coala_gnn_tpu.native import lib as jax_native
from coala_gnn_tpu.ops.aggregate import padded_gather_sum as jax_gather_sum
from coala_gnn_tpu.sampling import device_sampler as jds
from coala_gnn_tpu.sampling.neighbor import NeighborSampler as JaxSampler
from coala_gnn_tpu_torch import train as cli
from coala_gnn_tpu_torch.data.loader import CoalaDataLoader
from coala_gnn_tpu_torch.distribution import (DistributionScheduler,
                                              SeedDistributor)
from coala_gnn_tpu_torch.graph.csc import coo_to_csc
from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
from coala_gnn_tpu_torch.models import hetero as th
from coala_gnn_tpu_torch.native import lib as native_lib
from coala_gnn_tpu_torch.ops.aggregate import (padded_gather_sum,
                                               relation_gather_sum)
from coala_gnn_tpu_torch.parallel.resident import ResidentTrainer
from coala_gnn_tpu_torch.sampling import device_sampler as tds
from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler
from coala_gnn_tpu_torch.utils.convert import params_from_flax, params_to_flax
from test_torch_sampler import jax_uniforms

torch.set_num_threads(1)

KW = dict(num_nodes=1500, avg_degree=8, feature_dim=16, num_classes=4,
          seed=2)
R = 3
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# RGAT under Adam: the softmax over a relation's slots cancels the last
# layer's attn_r_r{r} wherever the relation's scores stay on one side of
# the leaky ReLU; that gradient is rounding noise, which Adam (dividing by
# its root mean square) turns into lr-sized steps of random sign in both
# frameworks (as for GAT, tests/test_torch_resident.py::
# test_gat_adam_matches_jax). The losses then part by up to ~4e-5 over the
# run; with SGD they agree within 4e-7.
ADAM_RGAT_TOL = dict(rtol=2e-4, atol=2e-4)
KINDS = ("rsage", "rgcn", "rgat")


@pytest.fixture(scope="module")
def dss():
    """(port dataset, JAX dataset) on one graph with the CLI's edge types:
    ``default_rng(seed).integers(0, 3, E)``, as examples/train.py draws
    them."""
    ds = cli.with_edge_types(synthetic_graph(**KW), R, KW["seed"])
    jds_ = jax_synthetic(**KW)
    jds_.graph.edge_types = np.random.default_rng(KW["seed"]).integers(
        0, R, jds_.graph.num_edges).astype(np.int32)
    jds_.graph.num_edge_types = R
    return ds, jds_


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# -- graph and sampling ------------------------------------------------------

@pytest.mark.parametrize("typed", [True, False])
def test_coo_to_csc_carries_edge_types_bitwise_jax(typed):
    rng = np.random.default_rng(0)
    n, e = 50, 400
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    ets = rng.integers(0, 5, e) if typed else None
    got = coo_to_csc(src, dst, n, edge_types=ets)
    want = jax_coo_to_csc(src, dst, n, edge_types=ets)
    _equal(got.indptr, want.indptr)
    _equal(got.indices, want.indices)
    assert got.num_edge_types == want.num_edge_types == (5 if typed else 1)
    if typed:
        _equal(got.edge_types, want.edge_types)
    else:
        assert got.edge_types is None and want.edge_types is None


def test_cli_edge_types_equal_jax(dss):
    ds, jds_ = dss
    _equal(ds.graph.edge_types, jds_.graph.edge_types)
    assert ds.graph.num_edge_types == R
    # the graph is a copy: the homogeneous dataset keeps no types, and a
    # typed one keeps its own
    assert synthetic_graph(**KW).graph.edge_types is None
    assert cli.with_edge_types(ds, 5, 9) is ds
    assert cli.with_edge_types(synthetic_graph(**KW), 1, 0) \
        .graph.num_edge_types == 3


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_native_typed_layer_bitwise_jax(dss, idx_dtype):
    """cg_sample_layer_typed against JAX's native typed draw, and its
    neighbours and mask equal to the untyped draw's (the relation ids ride
    along; the draws do not change)."""
    g = dss[0].graph
    g = type(g)(indptr=g.indptr, indices=g.indices.astype(idx_dtype),
                edge_types=g.edge_types, num_edge_types=R)
    dst = np.random.default_rng(3).integers(0, g.num_nodes, 300)
    for fanout in (3, 10):
        got = native_lib.sample_layer_typed(native_lib.get(), g, dst,
                                            fanout, 77)
        want = jax_native.sample_layer_typed(jax_native.get(), g, dst,
                                             fanout, 77)
        for a, b in zip(got, want):
            _equal(a, b)
        nbr, mask = native_lib.sample_layer(native_lib.get(), g, dst,
                                            fanout, 77)
        _equal(nbr, got[0])
        _equal(mask, got[1])
        assert (got[2][got[1] == 0] == 0).all()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("fanouts", [[4, 3], [10, 5]])
def test_typed_host_sampling_bitwise_jax(dss, use_native, fanouts):
    ds, jds_ = dss
    B = 16
    ours = NeighborSampler(ds.graph, fanouts, B, seed=5,
                           use_native=use_native)
    ref = JaxSampler(jds_.graph, fanouts, B, seed=5, use_native=use_native)
    assert (ref._native is not None) == use_native
    for i in range(3):
        seeds = ds.train_idx[i * B:(i + 1) * B]
        a, b = ours.sample(seeds), ref.sample(seeds)
        _equal(a.input_ids, b.input_ids)
        assert a.num_input == b.num_input
        for x, y in zip(a.blocks, b.blocks):
            for name in ("src_ids", "adj", "mask", "rel"):
                _equal(getattr(x, name), getattr(y, name))
            assert (x.num_dst, x.num_src) == (y.num_dst, y.num_src)
            assert (x.rel[x.mask == 0] == 0).all()
            # a valid slot carries the type of an edge of its dst
            g = ds.graph
            for i_dst in range(min(x.num_dst, 6)):
                v = x.src_ids[i_dst]
                types = set(g.edge_types[g.indptr[v]:g.indptr[v + 1]])
                assert set(x.rel[i_dst][x.mask[i_dst] > 0]) <= types


def test_host_batch_rels_equal_jax(dss):
    out = []
    for ds, Dist, Sched, Sampler, Loader in (
            (dss[0], SeedDistributor, DistributionScheduler, NeighborSampler,
             CoalaDataLoader),
            (dss[1], JaxDistributor, JaxScheduler, JaxSampler, JaxLoader)):
        d = Dist(ds.train_idx, batch_size=16, local_size=2, num_parts=1,
                 mode="baseline", shuffle_seed=3)
        out.append(Loader(scheduler=Sched(d, part_id=0, local_rank=0),
                          sampler=Sampler(ds.graph, [4, 3], 16, seed=7),
                          labels=ds.labels, local_size=2, prefetch=0))
    for _, a, b in zip(range(3), *out):
        assert len(a.rels) == len(b.rels) == 2
        for x, y in zip(a.rels, b.rels):
            _equal(x, y)
        for x, y in zip(a.adjs, b.adjs):
            _equal(x, y)
        _equal(a.input_ids, b.input_ids)
        assert (a.edges, a.sampled_nodes) == (b.edges, b.sampled_nodes)


@pytest.mark.parametrize("fanouts", [[4, 3], [10, 5]])
def test_typed_device_sampling_bitwise_given_jax_uniforms(dss, fanouts):
    g = dss[0].graph
    B = 8
    seeds = np.random.default_rng(1).choice(g.num_nodes, B, replace=False) \
        .astype(np.int32)
    key = jax.random.key(11)
    jblocks, jids, jnum = jds.sample_blocks_device(
        jds.to_device_graph(dss[1].graph), jnp.asarray(seeds), fanouts, B,
        key, dedup=False)
    uni = [torch.from_numpy(u) for u in jax_uniforms(key, B, fanouts)]
    tg = tds.to_device_graph(g, "cpu")
    assert tg.edge_types.shape == (g.num_edges + 1,)
    tblocks, tids, tnum = tds.sample_blocks_device(
        tg, torch.from_numpy(seeds), fanouts, B, uniforms=uni)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert int(tnum) == int(jnum)
    for tb, jb in zip(tblocks, jblocks):
        assert isinstance(tb, th.DeviceHeteroBlock) and tb.adj is None
        np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))
        np.testing.assert_array_equal(tb.rel.numpy(), np.asarray(jb.rel))
        assert tb.rel.dtype == torch.int32


# -- layers and models -------------------------------------------------------

CAPS = [(8, 32), (4, 8)]        # (cap_dst, cap_src): fanouts 3 and 1
D_IN, HIDDEN, CLASSES, HEADS = 8, 16, 4, 2


def _blocks(rng, layout):
    """Per layer (adj or None, mask, rel), input-most first."""
    out = []
    for cap_dst, cap_src in CAPS:
        f = cap_src // cap_dst - 1
        mask = (rng.random((cap_dst, f)) < 0.8).astype(np.float32)
        rel = np.where(mask > 0, rng.integers(0, R, (cap_dst, f)), 0) \
            .astype(np.int32)
        adj = (None if layout == "contiguous" else
               rng.integers(0, cap_src, (cap_dst, f)).astype(np.int32))
        out.append((adj, mask, rel))
    return out


def _jax_blocks(blocks):
    return [jh.DeviceHeteroBlock(adj=None if a is None else jnp.asarray(a),
                                 mask=jnp.asarray(m), rel=jnp.asarray(r))
            for a, m, r in blocks]


def _torch_blocks(blocks):
    return [th.DeviceHeteroBlock(adj=None if a is None else
                                 torch.from_numpy(a),
                                 mask=torch.from_numpy(m),
                                 rel=torch.from_numpy(r))
            for a, m, r in blocks]


def _model_pair(rng, layout, kind, dtype=jnp.float32):
    blocks = _blocks(rng, layout)
    x = rng.normal(size=(CAPS[0][1], D_IN)).astype(np.float32)
    jm = jh.make_hetero_model(kind, hidden=HIDDEN, num_classes=CLASSES,
                              num_rels=R, num_layers=2, num_heads=HEADS,
                              dropout=0.0, dtype=dtype)
    params = jm.init(jax.random.key(0), _jax_blocks(blocks), jnp.asarray(x))
    tm = th.make_hetero_model(
        kind, D_IN, HIDDEN, CLASSES, R, 2, num_heads=HEADS, dropout=0.0,
        dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    return jm, params, tm, blocks, x


@pytest.mark.parametrize("layout", ["contiguous", "adj"])
@pytest.mark.parametrize("kind", KINDS)
def test_forward_matches_flax(rng, kind, layout):
    jm, params, tm, blocks, x = _model_pair(rng, layout, kind)
    want = np.asarray(jm.apply(params, _jax_blocks(blocks), jnp.asarray(x)))
    got = tm(_torch_blocks(blocks), torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def _grads(jm, params, tm, blocks, x, y):
    def loss_fn(p):
        logits = jm.apply(p, _jax_blocks(blocks), jnp.asarray(x))[:4]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), jnp.asarray(y)).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    logits = tm(_torch_blocks(blocks), torch.from_numpy(x))[:4]
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    return (loss.item(), float(jloss),
            {k: p.grad for k, p in tm.named_parameters()},
            params_from_flax(jax.device_get(jgrads)))


@pytest.mark.parametrize("layout", ["contiguous", "adj"])
@pytest.mark.parametrize("kind", KINDS)
def test_grads_match_jax(rng, kind, layout):
    jm, params, tm, blocks, x = _model_pair(rng, layout, kind)
    y = rng.integers(0, CLASSES, size=4).astype(np.int32)
    loss, jloss, got, want = _grads(jm, params, tm, blocks, x, y)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], **GRAD_TOL)


@pytest.mark.parametrize("layout", ["contiguous", "adj"])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_model_matches_jax(rng, kind, layout):
    """A bf16 model: logits and gradients within 2e-2 (the bf16 param
    leaves, RGAT's attention params, stay bf16)."""
    jm, params, tm, blocks, x = _model_pair(rng, layout, kind, jnp.bfloat16)
    want = np.asarray(jm.apply(params, _jax_blocks(blocks),
                               jnp.asarray(x)).astype(jnp.float32))
    got = tm(_torch_blocks(blocks), torch.from_numpy(x)).detach()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **BF16_TOL)
    tm.zero_grad()
    y = rng.integers(0, CLASSES, size=4).astype(np.int32)
    loss, jloss, got, want = _grads(jm, params, tm, blocks, x, y)
    np.testing.assert_allclose(loss, jloss, **BF16_TOL)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k].float(), want[k].float(),
                                   **BF16_TOL)


_LAYERS = {"rsage": (jh.RelSAGEConv, th.RelSAGEConv),
           "rgcn": (jh.RelGraphConv, th.RelGraphConv),
           "rgat": (jh.RelGATConv, th.RelGATConv)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["contiguous", "adj"])
@pytest.mark.parametrize("kind", KINDS)
def test_layer_matches_flax_with_its_output_dtype(rng, kind, layout, dtype):
    """One relational layer on layer 0's block, fed ``dtype`` rows: the
    output within 1e-5 (f32) or 2e-2 (bf16) of flax's and of JAX's dtype:
    ``dtype``, except RGAT on the ``adj`` layout in bf16, where JAX's plane
    sums of bf16 rows times f32 attention promote to f32."""
    jcls, tcls = _LAYERS[kind]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    adj, mask, rel = _blocks(rng, layout)[0]
    x = rng.normal(size=(CAPS[0][1], D_IN)).astype(np.float32)
    kw = {"num_heads": HEADS} if kind == "rgat" else {}
    jl = jcls(features=HIDDEN, num_rels=R, dtype=jdt, **kw)
    jb = _jax_blocks([(adj, mask, rel)])[0]
    jx = jnp.asarray(x).astype(jdt)
    params = jl.init(jax.random.key(1), jb, jx)
    want = jl.apply(params, jb, jx)
    tl = (tcls(D_IN, HIDDEN, R, HEADS, torch.Generator(), dtype=tdt)
          if kind == "rgat" else
          tcls(D_IN, HIDDEN, R, torch.Generator(), dtype=tdt))
    tl.load_state_dict(params_from_flax(jax.device_get(params)))
    got = tl(_torch_blocks([(adj, mask, rel)])[0],
             torch.from_numpy(x).to(tdt)).detach()
    promoted = kind == "rgat" and layout == "adj" and dtype == "bfloat16"
    assert str(want.dtype) == ("float32" if promoted else dtype)
    assert got.dtype == (torch.float32 if promoted else tdt)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        **(TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("kind", KINDS)
def test_params_round_trip(rng, kind):
    """The converter carries the relation-indexed leaves (``fc_neigh_r1``,
    ``fc_r2``, ``attn_l_r0`` ...) both ways, bit for bit."""
    _, params, tm, _, _ = _model_pair(rng, "adj", kind)
    tree = jax.device_get(params)
    sd = params_from_flax(tree)
    assert sorted(sd) == sorted(tm.state_dict())
    names = {"rsage": "layer_0.fc_neigh_r2.weight",
             "rgcn": "layer_1.fc_r1.bias", "rgat": "layer_0.attn_r_r2"}
    assert names[kind] in sd
    back = params_to_flax(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_relation_masking_is_exact(dss):
    """tests/test_hetero.py's test, mirrored: RGCN with every sampled edge
    of type 2; zeroing fc_r2 zeroes the output (no other relation is
    live, and RelGraphConv has no term outside its relations), and the
    unzeroed output equals JAX's."""
    ds = dss[0]
    B = 8
    s = NeighborSampler(ds.graph, [3], B, seed=3)
    batch = s.sample(ds.train_idx[:B])
    blk = batch.blocks[0]
    blk.rel[:] = np.where(blk.mask > 0, 2, 0)
    x = ds.features[batch.input_ids]
    jm = jh.make_hetero_model("rgcn", hidden=8, num_classes=8, num_rels=3,
                              num_layers=1)
    jblocks = jh.hetero_blocks_to_device([blk])
    params = jm.init(jax.random.key(0), jblocks, jnp.asarray(x))
    tm = th.make_hetero_model("rgcn", ds.feature_dim, 8, 8, 3, 1)
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    blocks = th.hetero_blocks_to_device([blk], "cpu")
    out = tm(blocks, torch.from_numpy(x)).detach()
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jm.apply(params, jblocks, jnp.asarray(x))),
        **TOL)
    assert out[:B].abs().max() > 0
    with torch.no_grad():
        tm.layer_0.fc_r2.weight.zero_()
        tm.layer_0.fc_r2.bias.zero_()
    np.testing.assert_allclose(tm(blocks, torch.from_numpy(x))[:B]
                               .detach().numpy(), 0.0, atol=1e-6)


def test_blocks_to_device_needs_edge_types(dss):
    b = NeighborSampler(synthetic_graph(**KW).graph, [3], 4, seed=0) \
        .sample(dss[0].train_idx[:4]).blocks
    with pytest.raises(ValueError, match="edge types"):
        th.hetero_blocks_to_device(b, "cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relation_stacked_sum_equals_per_relation_loop(rng, dtype):
    """The stacked call (adj repeated per relation, each relation's
    weights) equals R calls of padded_gather_sum, each held to JAX's."""
    s, n, f, d = 40, 12, 5, 7
    x = torch.from_numpy(rng.normal(size=(s, d)).astype(np.float32)) \
        .to(dtype)
    adj = torch.from_numpy(rng.integers(0, s, (n, f)).astype(np.int32))
    mask = (rng.random((n, f)) < 0.8).astype(np.float32)
    rel = rng.integers(0, R, (n, f))
    w = torch.from_numpy(np.stack([mask * (rel == r) for r in range(R)]))
    got = relation_gather_sum(x, adj, w)
    assert got.shape == (R, n, d) and got.dtype == dtype
    for r in range(R):
        loop = padded_gather_sum(x, adj, w[r])
        torch.testing.assert_close(got[r], loop, rtol=1e-6, atol=1e-6)
        jx = jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        want = jax_gather_sum(jx, jnp.asarray(adj.numpy()),
                              jnp.asarray(w[r].numpy()))
        np.testing.assert_allclose(loop.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=1e-6, atol=1e-6)


def test_dead_slots_point_at_their_own_row():
    """Slots that are not live in a relation (another relation's, masked,
    padded rows') name their own dst row in the stacked adj, so no source
    row is named by more slots than its live ones and its dst's own."""
    from coala_gnn_tpu_torch.ops.aggregate import live_or_own

    adj = torch.tensor([[5, 0, 0], [5, 5, 0], [0, 0, 0]], dtype=torch.int32)
    live = torch.tensor([[[1, 0, 0], [1, 1, 0], [0, 0, 0]],
                         [[0, 1, 0], [0, 0, 1], [0, 0, 0]]]) > 0
    got = live_or_own(adj[None], live)
    want = torch.tensor([[[5, 0, 0], [5, 5, 1], [2, 2, 2]],
                         [[0, 0, 0], [1, 1, 0], [2, 2, 2]]], dtype=torch.int32)
    assert torch.equal(got, want) and got.dtype == torch.int32


def test_relation_stacked_adj_rows():
    """head_stacked_adj with relations: row (r * cap_dst + i) * H + h of
    slot k reads feat row r * n_src * H + adj[i, k] * H + h; one relation
    is GAT's head stacking."""
    from coala_gnn_tpu_torch.models.layers import head_stacked_adj

    adj = torch.tensor([[0, 2], [1, 1], [2, 0]], dtype=torch.int32)
    n_src, H = 3, 2
    got = head_stacked_adj(adj, n_src, (3, 2), H, "cpu", num_rels=R)
    assert got.shape == (R * 3 * H, 2) and got.dtype == torch.int32
    for r in range(R):
        for i in range(3):
            for h in range(H):
                for k in range(2):
                    assert got[(r * 3 + i) * H + h, k] == \
                        r * n_src * H + adj[i, k] * H + h
    torch.testing.assert_close(got[:3 * H],
                               head_stacked_adj(adj, n_src, (3, 2), H,
                                                "cpu"))
    with pytest.raises(ValueError, match="int32"):
        head_stacked_adj(adj, 2**29, (3, 2), 2, "cpu", num_rels=2)


# -- whole runs and the CLI --------------------------------------------------

RUN_ARGS = ["--device", "cpu", "--num_nodes", str(KW["num_nodes"]),
            "--avg_degree", str(KW["avg_degree"]), "--feature_dim",
            str(KW["feature_dim"]), "--num_classes", str(KW["num_classes"]),
            "--seed", str(KW["seed"]), "--batch_size", "16", "--fan_out",
            "4,3", "--hidden_channels", "8", "--num_heads", "2",
            "--learning_rate", "0.01", "--cache_size", "1"]
STEPS = 6


def _jax_loop(jds_, kind, params, steps, sgd=False):
    """The JAX pieces the CLI's loop mirrors: the distributor's first
    epoch, the sampler, hetero_blocks_to_device, the flax model and
    optax.adam (or optax.sgd); -> losses."""
    B, seed = 16, KW["seed"]
    jm = jh.make_hetero_model(kind, hidden=8, num_classes=KW["num_classes"],
                              num_rels=R, num_layers=2, num_heads=2,
                              dropout=0.0)
    sched = JaxScheduler(JaxDistributor(
        jds_.train_idx, batch_size=B, local_size=1, num_parts=1,
        mode="baseline", shuffle_seed=seed), part_id=0, local_rank=0)
    sampler = JaxSampler(jds_.graph, [4, 3], B, seed=seed)
    tx = optax.sgd(0.01) if sgd else optax.adam(0.01)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt, blocks, x, labels):
        def loss_fn(p):
            lg = jm.apply(p, blocks, x)[:B]
            return optax.softmax_cross_entropy_with_integer_labels(
                lg, labels).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss

    losses = []
    for _ in range(steps):
        batch = sampler.sample(sched.run_domain()[:B])
        params, opt, loss = step(
            params, opt, jh.hetero_blocks_to_device(batch.blocks),
            jnp.asarray(jds_.features[batch.input_ids]),
            jnp.asarray(jds_.labels[batch.seeds].astype(np.int32)))
        losses.append(float(loss))
    return np.asarray(losses), jm


@pytest.mark.parametrize("kind,sgd", [("rsage", False), ("rgcn", False),
                                      ("rgat", True), ("rgat", False)])
def test_cli_loop_matches_jax_loop(dss, kind, sgd, capsys):
    """``train.build`` + ``train.train`` (the CLI's loop: loader, cache
    front, the sharded step, Adam or SGD) at dropout 0 against the JAX
    loop, from the JAX model's params: losses within 1e-5 step by step
    (RGAT under Adam: ``ADAM_RGAT_TOL``)."""
    ds, jds_ = dss
    args = cli.parse_args(RUN_ARGS + ["--model_type", kind])
    run = cli.build(args, ds=synthetic_graph(**KW))
    run.model.dropout = 0.0
    if sgd:
        run.optimizer = torch.optim.SGD(run.model.parameters(), lr=0.01)
    _equal(run.ds.graph.edge_types, jds_.graph.edge_types)
    jm = jh.make_hetero_model(kind, hidden=8, num_classes=KW["num_classes"],
                              num_rels=R, num_layers=2, num_heads=2,
                              dropout=0.0)
    batch = JaxSampler(jds_.graph, [4, 3], 16, seed=0).sample(
        jds_.train_idx[:16])
    params = jm.init(jax.random.key(3),
                     jh.hetero_blocks_to_device(batch.blocks),
                     jnp.asarray(jds_.features[batch.input_ids]))
    run.model.load_state_dict(params_from_flax(jax.device_get(params)))
    got = cli.train(run, epochs=1, max_steps=STEPS)
    want, _ = _jax_loop(jds_, kind, params, STEPS, sgd)
    assert got["losses"].shape == (STEPS,) and got["edges"] > 0
    np.testing.assert_allclose(
        got["losses"], want,
        **(ADAM_RGAT_TOL if kind == "rgat" and not sgd else TOL))
    out = capsys.readouterr().out
    assert f"{R} edge types" in out and "Cache hit ratio" in out


def test_cli_trains_and_evaluates_a_hetero_model_on_cpu(capsys):
    cli.main(["--device", "cpu", "--model_type", "rgcn", "--num_nodes",
              "2000", "--feature_dim", "16", "--batch_size", "32",
              "--fan_out", "4,3", "--hidden_channels", "16", "--max_steps",
              "3", "--eval"])
    out = capsys.readouterr().out
    assert "2000 nodes" in out and ", 3 edge types" in out
    losses = [float(line.split("| loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("Epoch")]
    assert len(losses) == 1 and np.isfinite(losses).all()
    acc = [line for line in out.splitlines() if line.startswith("Test")]
    assert len(acc) == 1 and "(400 nodes)" in acc[0]


@pytest.mark.parametrize("flags,error,match", [
    (["--model_type", "sage", "--num_edge_types", "3"], ValueError,
     "needs a hetero model"),
    (["--model_type", "rgat", "--pipeline", "resident"],
     SystemExit, "--cache_size"),
])
def test_cli_refuses_what_hetero_does_not_run(flags, error, match):
    """``--num_edge_types > 1`` with a homogeneous model raises (the JAX
    CLI ignores it: ROADMAP.md section C); hetero resident training runs
    (tests/test_torch_cli_resident.py) but, as in JAX, not without a
    cache."""
    with pytest.raises(error, match=match):
        cli.main(["--device", "cpu"] + flags)


def test_resident_trainer_refuses_a_typed_graph(dss):
    with pytest.raises(NotImplementedError, match="ShardedResidentTrainer"):
        ResidentTrainer(graph=dss[0].graph, host_fetch=None, labels=None,
                        cache_cfg=None, model=None, optimizer=None,
                        fanouts=[2], batch_size=4, device="cpu")
