"""coala_gnn_tpu_torch/models (SAGE, GCN, GAT and their layers) and
utils/convert.py against the flax models of coala_gnn_tpu/models, on the
same converted params, and GCN / GAT layers against the dense full-graph
reference (the COO oracles of ops/segment.py), as
tests/test_dense_reference.py holds the JAX layers.

Tolerances: forward 1e-5 (two f32 matmul layers over the same inputs;
for GAT also the softmax, whose exp differs between XLA and torch in its
last bits); the fused table form of layer 0 against the dense form 1e-6
(the same sums, only the input rows are read from the table in place);
gradients 1e-4 (the backward adds two more matmul chains and a softmax);
the dense reference 2e-4, tests/test_dense_reference.py's own."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from coala_gnn_tpu.graph.datasets import synthetic_graph
from coala_gnn_tpu.models import make_model as jax_make_model
from coala_gnn_tpu.models.layers import DeviceBlock as JBlock
from coala_gnn_tpu.models.layers import GATConv as JGATConv
from coala_gnn_tpu.sampling.neighbor import NeighborSampler, block_capacities
from coala_gnn_tpu_torch.cache.feature_cache import quantize_rows
from coala_gnn_tpu_torch.models.gnn import (GAT, GCN, SAGE, dropout,
                                            make_model)
from coala_gnn_tpu_torch.models.layers import (DeviceBlock, GATConv,
                                               GraphConv, TableInput)
from coala_gnn_tpu_torch.ops.segment import spmm_coo
from coala_gnn_tpu_torch.utils.convert import params_from_flax, params_to_flax

torch.set_num_threads(1)

B, FANOUTS, D_IN, HIDDEN, CLASSES = 4, [3, 2], 8, 16, 4


def _blocks(rng, layout):
    """Per layer (adj or None, mask), input-most first."""
    out = []
    for cap_dst, cap_src in block_capacities(B, FANOUTS):
        f = cap_src // cap_dst - 1
        mask = (rng.random((cap_dst, f)) < 0.7).astype(np.float32)
        adj = (None if layout == "contiguous" else
               rng.integers(0, cap_src, size=(cap_dst, f)).astype(np.int32))
        out.append((adj, mask))
    return out


def _jax_blocks(blocks):
    return [JBlock(adj=None if a is None else jnp.asarray(a),
                   mask=jnp.asarray(m)) for a, m in blocks]


def _torch_blocks(blocks):
    return [DeviceBlock(adj=None if a is None else torch.from_numpy(a),
                        mask=torch.from_numpy(m)) for a, m in blocks]


def _pair(rng, layout, kind="sage"):
    """(flax model, flax params, torch model with the same params, blocks,
    x); GAT with 2 heads."""
    blocks = _blocks(rng, layout)
    x = rng.normal(size=(block_capacities(B, FANOUTS)[0][1], D_IN)) \
        .astype(np.float32)
    jm = jax_make_model(kind, hidden=HIDDEN, num_classes=CLASSES,
                        num_layers=2, num_heads=2, dropout=0.0)
    params = jm.init(jax.random.key(0), _jax_blocks(blocks), jnp.asarray(x))
    tm = make_model(kind, D_IN, HIDDEN, CLASSES, 2, num_heads=2, dropout=0.0)
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    return jm, params, tm, blocks, x


@pytest.mark.parametrize("layout", ["contiguous", "adj"])
def test_forward_matches_flax(rng, layout):
    jm, params, tm, blocks, x = _pair(rng, layout)
    want = np.asarray(jm.apply(params, _jax_blocks(blocks), jnp.asarray(x)))
    got = tm(_torch_blocks(blocks), torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_table_form_equals_dense_form(rng, table_dtype):
    _, _, tm, blocks, _ = _pair(rng, "contiguous")
    table = torch.from_numpy(
        rng.normal(size=(30, D_IN)).astype(np.float32)).to(table_dtype)
    ids = torch.from_numpy(rng.integers(
        0, 30, size=block_capacities(B, FANOUTS)[0][1]).astype(np.int32))
    tb = _torch_blocks(blocks)
    dense = tm(tb, table[ids].float())
    fused = tm(tb, TableInput(table, ids))
    torch.testing.assert_close(fused, dense, rtol=1e-6, atol=1e-6)


def test_table_form_needs_contiguous_blocks(rng):
    _, _, tm, blocks, _ = _pair(rng, "adj")
    ids = torch.zeros(block_capacities(B, FANOUTS)[0][1], dtype=torch.int32)
    with pytest.raises(ValueError):
        tm(_torch_blocks(blocks), TableInput(torch.zeros(5, D_IN), ids))


@pytest.mark.parametrize("layout", ["contiguous", "adj"])
def test_grads_match_jax(rng, layout):
    jm, params, tm, blocks, x = _pair(rng, layout)
    y = rng.integers(0, CLASSES, size=B).astype(np.int32)

    def loss_fn(p):
        logits = jm.apply(p, _jax_blocks(blocks), jnp.asarray(x))[:B]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    logits = tm(_torch_blocks(blocks), torch.from_numpy(x))[:B]
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = params_from_flax(jax.device_get(jgrads))
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)


def test_params_round_trip(rng):
    _, params, tm, _, _ = _pair(rng, "contiguous")
    tree = jax.device_get(params)
    sd = params_from_flax(tree)
    assert sorted(sd) == sorted(tm.state_dict())
    back = params_to_flax(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert sd["layer_0.fc_self.weight"].shape == (HIDDEN, D_IN)


def test_init_is_flax_lecun_normal():
    """Same law as flax's Dense kernels: std 1/sqrt(fan_in), truncated at
    2 std of the untruncated normal; zero biases. 10% on the std (65k
    draws put the sampling error near 0.5%)."""
    d_in = 256
    tm = SAGE(d_in, 256, 16, num_layers=2, seed=3)
    jm = jax_make_model("sage", hidden=256, num_classes=16, num_layers=2)
    caps = block_capacities(2, [1, 1])
    jb = [JBlock(adj=None, mask=jnp.ones((c, 1))) for c, _ in caps]
    jp = jm.init(jax.random.key(3), jb, jnp.zeros((caps[0][1], d_in)))
    jw = np.asarray(jp["params"]["layer_0"]["fc_self"]["kernel"])
    tw = tm.layer_0.fc_self.weight.detach().numpy()
    std = 1 / np.sqrt(d_in)
    assert abs(tw.std() / std - 1) < 0.1 and abs(jw.std() / std - 1) < 0.1
    bound = 2 * std / .87962566103423978
    assert np.abs(tw).max() <= bound * (1 + 1e-6)
    assert not tm.layer_0.fc_self.bias.detach().any()
    torch.testing.assert_close(
        SAGE(d_in, 256, 16, seed=3).layer_1.fc_neigh.weight,
        tm.layer_1.fc_neigh.weight, rtol=0, atol=0)


def test_dropout_uses_its_generator_only():
    h = torch.ones(4000)
    a = dropout(h, 0.5, torch.Generator().manual_seed(0))
    b = dropout(h, 0.5, torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert abs((a > 0).float().mean().item() - 0.5) < 0.05
    tm = make_model("sage", D_IN, HIDDEN, CLASSES, 2, dropout=0.5)
    with pytest.raises(ValueError):
        tm([], torch.zeros(1, D_IN), train=True)


@pytest.mark.parametrize("kind", ["gcn", "gat"])
def test_unported_models_raise(kind):
    """GCN and GAT are ported: make_model builds them as it builds SAGE
    (2 layers named as flax names them), and a kind neither package has
    raises ValueError, as JAX's make_model does."""
    tm = make_model(kind, D_IN, HIDDEN, CLASSES, 2)
    assert isinstance(tm, (GAT if kind == "gat" else GCN))
    assert tm.num_layers == 2 and hasattr(tm, "layer_1")
    with pytest.raises(ValueError):
        make_model("gin", D_IN, HIDDEN, CLASSES, 2)


# ---- GCN and GAT ------------------------------------------------------------

KINDS = ["gcn", "gat"]


@pytest.mark.parametrize("layout", ["contiguous", "adj"])
@pytest.mark.parametrize("kind", KINDS)
def test_gcn_gat_forward_matches_flax(rng, kind, layout):
    jm, params, tm, blocks, x = _pair(rng, layout, kind)
    want = np.asarray(jm.apply(params, _jax_blocks(blocks), jnp.asarray(x)))
    got = tm(_torch_blocks(blocks), torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (
        block_capacities(B, FANOUTS)[-1][0], CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["contiguous", "adj"])
@pytest.mark.parametrize("kind", KINDS)
def test_gcn_gat_grads_match_jax(rng, kind, layout):
    """Parameter gradients against jax.grad; GAT's run through the
    gather_spmm Function's backward (grad_w into the attention, grad_x
    into feat)."""
    jm, params, tm, blocks, x = _pair(rng, layout, kind)
    y = rng.integers(0, CLASSES, size=B).astype(np.int32)

    def loss_fn(p):
        logits = jm.apply(p, _jax_blocks(blocks), jnp.asarray(x))[:B]
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    logits = tm(_torch_blocks(blocks), torch.from_numpy(x))[:B]
    loss = F.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = params_from_flax(jax.device_get(jgrads))
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kind", ["sage", "gcn", "gat"])
def test_table_form_equals_dense_form_all_models(rng, kind, table_dtype):
    """Layer 0 read from a table (f32, bf16, or int8 with its scales) and
    from the dense rows it holds give the same logits; the int8 dense rows
    are dequantize_rows'."""
    _, _, tm, blocks, _ = _pair(rng, "contiguous", kind)
    rows = torch.from_numpy(rng.normal(size=(30, D_IN)).astype(np.float32))
    scale = None
    if table_dtype == "int8":
        table, scale = quantize_rows(rows)
    else:
        table = rows.to(getattr(torch, table_dtype))
    ids = torch.from_numpy(rng.integers(
        0, 30, size=block_capacities(B, FANOUTS)[0][1]).astype(np.int32))
    tb = _torch_blocks(blocks)
    dense_rows = table.float() if scale is None else \
        table.float() * scale[:, None]
    dense = tm(tb, dense_rows[ids])
    fused = tm(tb, TableInput(table, ids, scale))
    torch.testing.assert_close(fused, dense, rtol=1e-6, atol=1e-6)


def test_gcn_table_form_needs_contiguous_blocks(rng):
    _, _, tm, blocks, _ = _pair(rng, "adj", "gcn")
    ids = torch.zeros(block_capacities(B, FANOUTS)[0][1], dtype=torch.int32)
    with pytest.raises(ValueError):
        tm(_torch_blocks(blocks), TableInput(torch.zeros(5, D_IN), ids))


def test_gat_conv_matches_flax_and_asserts_no_bias(rng):
    """One GATConv, 3 heads, against the flax GATConv; a bias on fc breaks
    the score fold and is refused."""
    blocks = _blocks(rng, "adj")
    x = rng.normal(size=(block_capacities(B, FANOUTS)[0][1], D_IN)) \
        .astype(np.float32)
    jb = _jax_blocks(blocks)[0]
    jl = JGATConv(features=5, num_heads=3)
    p = jl.init(jax.random.key(1), jb, jnp.asarray(x))
    tl = GATConv(D_IN, 5, 3, torch.Generator().manual_seed(0))
    tl.load_state_dict(params_from_flax(jax.device_get(p)))
    tb = _torch_blocks(blocks)[0]
    got = tl(tb, torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jl.apply(p, jb, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got.shape == (tb.cap_dst, 3, 5)
    tl.fc.bias = torch.nn.Parameter(torch.zeros(15))
    with pytest.raises(AssertionError, match="bias"):
        tl(tb, torch.from_numpy(x))


def test_gat_params_round_trip_and_init(rng):
    """params_from_flax / params_to_flax carry attn_l / attn_r untransposed;
    the port's init follows flax's laws: lecun-normal fc without bias,
    glorot-uniform attention on (H, F) within +-sqrt(6 / (H + F))."""
    _, params, tm, _, _ = _pair(rng, "contiguous", "gat")
    tree = jax.device_get(params)
    sd = params_from_flax(tree)
    assert sorted(sd) == sorted(tm.state_dict())
    assert sd["layer_0.attn_l"].shape == (2, HIDDEN)
    np.testing.assert_array_equal(sd["layer_1.attn_r"].numpy(),
                                  np.asarray(tree["params"]["layer_1"]
                                             ["attn_r"]))
    back = params_to_flax(sd)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(a), b)
    gat = GAT(256, 64, 16, num_layers=2, num_heads=4, seed=5)
    assert gat.layer_0.fc.bias is None
    assert gat.layer_1.fc.weight.shape == (4 * 16, 4 * 64)
    w = gat.layer_0.fc.weight.detach().numpy()
    assert abs(w.std() * np.sqrt(256) - 1) < 0.1
    a = gat.layer_0.attn_l.detach().numpy()
    limit = np.sqrt(6 / (4 + 64))
    assert np.abs(a).max() <= limit and np.abs(a).max() > 0.8 * limit


def _full_graph_layer(kind, seed):
    """(port layer with converted JAX params, its output on a full-fanout
    block, the JAX params, dataset, seeds) as test_dense_reference.py sets
    them up."""
    ds = synthetic_graph(num_nodes=300, avg_degree=5, feature_dim=12,
                         num_classes=4, seed=seed)
    g = ds.graph
    sampler = NeighborSampler(g, [int(g.in_degrees().max())], 16, seed=1,
                              use_native=False)
    seeds = ds.train_idx[:16]
    batch = sampler.sample(seeds)
    blk, x = batch.blocks[0], ds.features[batch.input_ids]
    jb = JBlock(adj=jnp.asarray(blk.adj), mask=jnp.asarray(blk.mask))
    if kind == "gcn":
        jl = jax_make_model("gcn", hidden=8, num_classes=8, num_layers=1)
        p = jl.init(jax.random.key(0), [jb], jnp.asarray(x))
        tl = make_model("gcn", 12, 8, 8, 1)
    else:
        jl = JGATConv(features=8, num_heads=2)
        p = jl.init(jax.random.key(2), jb, jnp.asarray(x))
        tl = GATConv(12, 8, 2, torch.Generator().manual_seed(0))
    tl.load_state_dict(params_from_flax(jax.device_get(p)))
    tb = DeviceBlock(adj=torch.from_numpy(blk.adj),
                     mask=torch.from_numpy(blk.mask))
    out = tl([tb] if kind == "gcn" else tb, torch.from_numpy(x))
    return out.detach().numpy()[:16], p["params"], ds, seeds


def _edges(g):
    dst = np.repeat(np.arange(g.num_nodes), np.diff(g.indptr))
    return torch.from_numpy(np.asarray(g.indices).astype(np.int64)), \
        torch.from_numpy(dst)


def test_gcn_layer_matches_dense_reference():
    out, p, ds, seeds = _full_graph_layer("gcn", 4)
    g = ds.graph
    src, dst = _edges(g)
    agg = spmm_coo(torch.from_numpy(ds.features).double(), src, dst,
                   g.num_nodes).numpy()
    deg = g.in_degrees().astype(np.float64)
    norm = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)[:, None]
    fc = p["layer_0"]["fc"]
    want = (agg * norm)[seeds] @ np.asarray(fc["kernel"]) \
        + np.asarray(fc["bias"])
    np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-4)


def test_gat_layer_matches_dense_reference():
    """Exact per-edge attention over ALL in-edges, with the port's
    segment_softmax and spmm_coo as the oracle."""
    from coala_gnn_tpu_torch.ops.segment import segment_softmax

    out, p, ds, seeds = _full_graph_layer("gat", 6)
    g = ds.graph
    H, Fh = 2, 8
    src, dst = _edges(g)
    W = torch.from_numpy(np.array(p["fc"]["kernel"])).double()
    feat = (torch.from_numpy(ds.features).double() @ W).view(-1, H, Fh)
    el = torch.einsum("nhf,hf->nh", feat,
                      torch.from_numpy(np.array(p["attn_l"])).double())
    er = torch.einsum("nhf,hf->nh", feat,
                      torch.from_numpy(np.array(p["attn_r"])).double())
    e = F.leaky_relu(el[src] + er[dst], 0.2)                 # [E, H]
    a = segment_softmax(e, dst, g.num_nodes)
    msg = (feat[src] * a[:, :, None]).reshape(src.numel(), H * Fh)
    want = spmm_coo(msg, torch.arange(src.numel()), dst, g.num_nodes)
    want = want.view(-1, H, Fh)[torch.from_numpy(seeds.astype(np.int64))]
    np.testing.assert_allclose(out, want.numpy(), rtol=2e-4, atol=2e-4)
