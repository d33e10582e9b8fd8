"""The bf16 model dtype of coala_gnn_tpu_torch against the JAX package, on
the CPU: the three models per layer layout (logits and gradients), the
param converter, the rounding reads of the gather-SpMM kernel's plain
versions, the cache's bf16 rows, whole resident windows (flat and staged)
and the CLI. The CLI's train and eval steps with a bf16 model are held to
JAX's by tests/test_torch_host_pipeline.py::test_sharded_steps_match_jax,
run_host's bf16 lines by its test_run_host_bf16_lines_match_jax_loop.

Inputs come from numpy with a seed; params from JAX's ``init`` of the bf16
model, carried across by ``utils/convert.py``.

Tolerances:
- bf16 models, logits, gradients and losses: rtol 2e-2 / atol 2e-2
  (``TOL``). Both sides round to bf16 at the same points (the layer input,
  every Dense output, the aggregations, GAT's scores and softmax), but
  XLA and torch sum a bf16 matmul or softmax in their own orders, a
  last-bit f32 difference flips a bf16 rounding (2^-8 relative), and a
  flipped rounding carries through the layers and, over a window, Adam.
- Bitwise where both sides round the same f32 values once: the rounding
  reads against ``astype(bfloat16)`` and ``dequantize_rows(...,
  dtype=bfloat16)``, the table forms against the dense forms of the port,
  the cache's bf16 rows against JAX's, and the converter's round trip.
- The table forms against JAX's dense bf16 aggregations: one bf16 ulp,
  2^-7 (``tests/test_torch_ops.py``'s bf16 tolerance: XLA may fuse the
  multiply-add the port rounds twice, which can flip the final rounding).

``padded_gather_sum`` / ``agg_sum`` / ``agg_mean`` on bf16 activations (the
layers above 0) are held to JAX by ``tests/test_torch_ops.py``'s bf16
cases, both layouts; here they run inside the models and windows.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.cache.host_tier import HostFeatureStore
from coala_gnn_tpu.graph.datasets import synthetic_graph
from coala_gnn_tpu.models import make_model as jax_make_model
from coala_gnn_tpu.models.layers import DeviceBlock as JBlock
from coala_gnn_tpu.ops import aggregate as jagg
from coala_gnn_tpu.parallel.resident import ResidentTrainer as JTrainer
from coala_gnn_tpu.sampling.neighbor import block_capacities
from coala_gnn_tpu_torch import train as cli
from coala_gnn_tpu_torch.cache import feature_cache as tfc
from coala_gnn_tpu_torch.models.gnn import make_model
from coala_gnn_tpu_torch.models.layers import DeviceBlock, TableInput
from coala_gnn_tpu_torch.ops import aggregate as tagg
from coala_gnn_tpu_torch.ops.gather_spmm import (LAUNCHES, _rows,
                                                 gather_spmm,
                                                 gather_spmm_reference)
from coala_gnn_tpu_torch.parallel.resident import ResidentTrainer
from coala_gnn_tpu_torch.utils.convert import params_from_flax, params_to_flax

torch.set_num_threads(1)

BF16 = torch.bfloat16
TOL = dict(rtol=2e-2, atol=2e-2)
ULP = 2.0 ** -7
KINDS = ["sage", "gcn", "gat"]
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


def _pair(rng, layout, kind):
    """(flax bf16 model, its params, the port's bf16 model on the same
    params, blocks, x f32); GAT with 2 heads."""
    blocks = _blocks(rng, layout)
    x = rng.normal(size=(block_capacities(B, FANOUTS)[0][1], D_IN)) \
        .astype(np.float32)
    jm = jax_make_model(kind, hidden=HIDDEN, num_classes=CLASSES,
                        num_layers=2, num_heads=2, dropout=0.0,
                        dtype=jnp.bfloat16)
    params = jm.init(jax.random.key(0), _jax_blocks(blocks), jnp.asarray(x))
    tm = make_model(kind, D_IN, HIDDEN, CLASSES, 2, num_heads=2, dropout=0.0,
                    dtype=BF16)
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    return jm, params, tm, blocks, x


# ---- the models ---------------------------------------------------------------

@pytest.mark.parametrize("layout", ["contiguous", "adj"])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_forward_matches_flax(rng, kind, layout):
    jm, params, tm, blocks, x = _pair(rng, layout, kind)
    want = np.asarray(jm.apply(params, _jax_blocks(blocks), jnp.asarray(x)))
    got = tm(_torch_blocks(blocks), torch.from_numpy(x)).detach()
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("layout", ["contiguous", "adj"])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_grads_match_jax(rng, kind, layout):
    """Every param's gradient against jax.grad, in the param's own dtype
    (f32 for the Dense params, bf16 for GAT's attention)."""
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
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    want = params_from_flax(jax.device_get(jgrads))
    got = {k: p.grad for k, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k].float(), want[k].float(), **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_params_and_converter(rng, kind):
    """Dense weights and biases stay f32 (flax's param_dtype), GAT's
    attention params are bf16, in the flax tree, the converted state_dict
    and the port's own model; the round trip is bitwise with a numpy
    bfloat16 type, exact widened to f32, and refused without one."""
    _, params, tm, _, _ = _pair(rng, "contiguous", kind)
    tree = jax.device_get(params)
    sd = params_from_flax(tree)
    own = make_model(kind, D_IN, HIDDEN, CLASSES, 2, num_heads=2, dtype=BF16)
    for name, t in sd.items():
        attn = name.endswith(("attn_l", "attn_r"))
        want = BF16 if attn else torch.float32
        assert t.dtype == own.state_dict()[name].dtype == want, name
    assert any(t.dtype == BF16 for t in sd.values()) == (kind == "gat")
    back = params_to_flax(tm.state_dict(), bf16_as=ml_dtypes.bfloat16)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      b.view(np.uint8))
    wide = params_to_flax(sd, bf16_as=np.float32)
    for (_, a), (_, b) in zip(flat_a,
                              jax.tree_util.tree_flatten_with_path(wide)[0]):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    if kind == "gat":
        with pytest.raises(ValueError, match="bfloat16"):
            params_to_flax(sd)
    with pytest.raises(ValueError):
        make_model(kind, D_IN, HIDDEN, CLASSES, 2, dtype=torch.float16)


# ---- the rounding reads ------------------------------------------------------

def _table_rows(rng, n=40, d=24):
    """f32 rows with spread magnitudes, plus rows exactly halfway between
    two bf16 values (ties: round to even) and just above and below."""
    x = (rng.normal(size=(n, d)) * rng.uniform(1e-3, 50, size=(n, 1))) \
        .astype(np.float32)
    bits = x.view(np.uint32)
    bits[0] = (bits[0] & 0xFFFF0000) | 0x8000        # ties
    bits[1] = (bits[1] & 0xFFFF0000) | 0x8001        # just above
    bits[2] = (bits[2] & 0xFFFF0000) | 0x7FFF        # just below
    return x


def test_rounding_reads_equal_jax_bitwise(rng):
    """The plain versions' bf16 reads equal JAX's roundings bit for bit:
    an f32 table ``astype(bfloat16)``, an int8 table
    ``dequantize_rows(..., dtype=bfloat16)``; ``TableInput.rows`` returns
    those rows."""
    x = _table_rows(rng)
    idx = rng.integers(0, x.shape[0], size=60)
    tidx = torch.from_numpy(idx)
    got = _rows(torch.from_numpy(x), tidx, None, BF16)
    want = np.asarray(jnp.asarray(x[idx]).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    q, scale = jfc.quantize_rows(jnp.asarray(x))
    tq, ts = torch.from_numpy(np.array(q)), torch.from_numpy(np.array(scale))
    got8 = _rows(tq, tidx, ts, BF16)
    want8 = np.asarray(jfc.dequantize_rows(q[idx], scale[idx],
                                           dtype=jnp.bfloat16)
                       .astype(jnp.float32))
    np.testing.assert_array_equal(got8.numpy(), want8)
    ids = tidx.to(torch.int32)
    tx = torch.from_numpy(x)
    for table, sc, row_dtype, read_as, rows in (
            (tx, None, None, BF16, want),             # f32 under bf16
            (tq, ts, BF16, torch.float32, want8),     # int8 served as bf16
            (tq, ts, BF16, BF16, want8),
            (tq, ts, torch.float32, BF16, want8),     # int8 under bf16
            (tx, None, None, torch.float32, x[idx])):  # no rounding
        out = TableInput(table, ids, sc, row_dtype).rows(read_as=read_as)
        assert out.dtype == read_as
        np.testing.assert_array_equal(out.float().numpy(), rows)


@pytest.mark.parametrize("table", ["float32", "int8"])
@pytest.mark.parametrize("name", ["sum", "mean"])
def test_table_forms_equal_dense_bf16_forms(rng, table, name):
    """``table_agg_sum`` / ``table_agg_mean`` read as bf16 with a bf16
    result: bitwise the port's dense ``agg_sum`` / ``agg_mean`` over the
    rows rounded to bf16, and within one bf16 ulp of JAX's."""
    cap, fan, d = 12, 5, 16
    rows = _table_rows(rng, 30, d)
    ids = torch.from_numpy(rng.integers(0, 30, size=cap * (1 + fan))
                           .astype(np.int32))
    mask = (rng.random((cap, fan)) < 0.7).astype(np.float32)
    mask[0] = 0.0
    w = mask * rng.random((cap, fan)).astype(np.float32)
    scale = None
    if table == "int8":
        tbl, scale = tfc.quantize_rows(torch.from_numpy(rows))
        dense = tfc.dequantize_rows(tbl[ids], scale[ids], dtype=BF16)
        jdense = jfc.dequantize_rows(jnp.asarray(tbl.numpy()[ids.numpy()]),
                                     jnp.asarray(scale.numpy()[ids.numpy()]),
                                     dtype=jnp.bfloat16)
    else:
        tbl = torch.from_numpy(rows)
        dense = tbl[ids].to(BF16)
        jdense = jnp.asarray(rows[ids.numpy()]).astype(jnp.bfloat16)
    weights = mask if name == "mean" else w
    tw = torch.from_numpy(weights)
    if name == "sum":
        got = tagg.table_agg_sum(tbl, ids, tw, scale, BF16, BF16)
        want_t = tagg.agg_sum(dense, None, tw)
        want_j = jagg.agg_sum(jdense, None, jnp.asarray(weights))
    else:
        got = tagg.table_agg_mean(tbl, ids, tw, scale, BF16, BF16)
        want_t = tagg.agg_mean(dense, None, tw)
        want_j = jagg.agg_mean(jdense, None, jnp.asarray(weights))
    assert got.dtype == want_t.dtype == BF16
    assert torch.equal(got, want_t)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want_j.astype(jnp.float32)),
                               rtol=ULP, atol=ULP)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8_bf16",
                                         "int8_f32"])
@pytest.mark.parametrize("kind", KINDS)
def test_bf16_table_input_equals_dense_rows(rng, kind, table_dtype):
    """A bf16 model's layer 0 read from a table in place gives the logits
    of the same model on the dense rows JAX's ``flat_lookup`` hands it,
    bit for bit: f32 and bf16 tables, and int8 lines served as bf16 or as
    f32 (``row_dtype``)."""
    _, _, tm, blocks, _ = _pair(rng, "contiguous", kind)
    rows = torch.from_numpy(_table_rows(rng, 30, D_IN))
    ids = torch.from_numpy(rng.integers(
        0, 30, size=block_capacities(B, FANOUTS)[0][1]).astype(np.int32))
    scale = row_dtype = None
    if table_dtype.startswith("int8"):
        row_dtype = BF16 if table_dtype == "int8_bf16" else torch.float32
        table, scale = tfc.quantize_rows(rows)
        dense = tfc.dequantize_rows(table[ids], scale[ids], dtype=row_dtype)
    else:
        table = rows.to(getattr(torch, table_dtype))
        dense = table[ids]
    tb = _torch_blocks(blocks)
    fused = tm(tb, TableInput(table, ids, scale, row_dtype))
    assert torch.equal(fused, tm(tb, dense))


def test_int8_lines_served_as_bf16_under_an_f32_model(rng):
    """An f32 model on int8 lines of a bf16 cache reads the rows JAX's
    ``flat_lookup(dtype=bfloat16)`` returns, widened: the layer-0 table
    form (the kernel's int8-as-bf16 read) equals the model on those rows
    within the f32 table-form tolerance of tests/test_torch_models.py."""
    blocks = _blocks(rng, "contiguous")
    tm = make_model("sage", D_IN, HIDDEN, CLASSES, 2, dropout=0.0)
    table, scale = tfc.quantize_rows(torch.from_numpy(_table_rows(rng, 30,
                                                                  D_IN)))
    ids = torch.from_numpy(rng.integers(
        0, 30, size=block_capacities(B, FANOUTS)[0][1]).astype(np.int32))
    tb = _torch_blocks(blocks)
    dense = tfc.dequantize_rows(table[ids], scale[ids], dtype=BF16)
    fused = tm(tb, TableInput(table, ids, scale, BF16))
    torch.testing.assert_close(fused, tm(tb, dense), rtol=1e-6, atol=1e-6)
    f32_read = tm(tb, TableInput(table, ids, scale))
    assert not torch.equal(f32_read, fused)


def test_rounding_forms_are_constant_and_count_no_cpu_launch(rng):
    x = torch.from_numpy(_table_rows(rng, 20, 16))
    adj = torch.from_numpy(rng.integers(0, 20, size=(6, 3)).astype(np.int32))
    w = torch.rand(6, 3)
    before = dict(LAUNCHES)
    out = gather_spmm(x, adj, w, read_as=BF16)
    torch.testing.assert_close(out, gather_spmm_reference(x, adj, w,
                                                          read_as=BF16),
                               rtol=0, atol=0)
    assert not torch.equal(out, gather_spmm(x, adj, w))
    assert LAUNCHES == before
    assert {"gather_spmm[float32_as_bf16]", "gather_spmm[int8_as_bf16]",
            "gather_spmm_grad_w[bfloat16]"} <= set(LAUNCHES)
    with pytest.raises(ValueError, match="constant"):
        gather_spmm(x.clone().requires_grad_(), adj, w, read_as=BF16)
    with pytest.raises(ValueError, match="constant"):
        gather_spmm(x, adj, w.clone().requires_grad_(), read_as=BF16)
    with pytest.raises(TypeError):
        gather_spmm(x, adj, w, read_as=torch.float16)
    # a bf16 table read as bf16 is the bf16 form, differentiable
    xb = x.to(BF16).requires_grad_()
    gather_spmm(xb, adj, w, read_as=BF16).sum().backward()
    assert xb.grad.dtype == BF16


# ---- the cache's rows ----------------------------------------------------------

def test_cache_serves_int8_lines_as_bf16_rows_like_jax(rng):
    """int8 lines on a bf16 cache config: ``flat_lookup(dtype=bfloat16)``
    and the set-associative ``lookup`` return bf16 rows bitwise JAX's."""
    n, dim = 40, 12
    kw = dict(num_sets=2, ways=jfc.WAYS, dim=dim,
              cache_dim=jfc.round_cache_dim(dim), num_colors=0,
              quantize=True)
    jcfg = jfc.CacheConfig(dtype=jnp.bfloat16, **kw)
    tcfg = tfc.CacheConfig(dtype=BF16, **kw)
    feats = _table_rows(rng, n, dim)
    ids = np.arange(0, n, 2, dtype=np.int32)
    valid = np.ones(ids.size, bool)
    colors = np.zeros(ids.size, np.int32)
    js = jfc.flat_insert(jcfg, jfc.flat_init(jcfg, n),
                         *map(jnp.asarray, (ids, feats[ids], valid, colors)))
    ts = tfc.flat_insert(tcfg, tfc.flat_init(tcfg, n, "cpu"),
                         *map(torch.from_numpy,
                              (ids, feats[ids], valid, colors)))
    q = rng.integers(0, n, size=30).astype(np.int32)
    qv = np.ones(q.size, bool)
    _, jf, _ = jfc.flat_lookup(js, jnp.asarray(q), jnp.asarray(qv),
                               dtype=jnp.bfloat16)
    _, tf, _ = tfc.flat_lookup(ts, torch.from_numpy(q), torch.from_numpy(qv),
                               dtype=BF16)
    assert tf.dtype == BF16
    np.testing.assert_array_equal(tf.float().numpy(),
                                  np.asarray(jf.astype(jnp.float32)))
    part = ids[:20]
    jst = jfc.insert(jcfg, jfc.init_state(jcfg), jnp.asarray(part),
                     jnp.asarray(feats[part]),
                     jnp.ones(part.size, bool))
    tst = tfc.init_state(tcfg, "cpu")
    tfc.insert(tcfg, tst, torch.from_numpy(part),
               torch.from_numpy(feats[part]), torch.ones(part.size,
                                                         dtype=torch.bool))
    _, jf, jh = jfc.lookup(jcfg, jst, jnp.asarray(q), jnp.asarray(qv))
    _, tf, th = tfc.lookup(tcfg, tst, torch.from_numpy(q),
                           torch.from_numpy(qv))
    assert tf.dtype == BF16 and bool(th.any())
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tf.float().numpy(),
                                  np.asarray(jf.astype(jnp.float32)))


# ---- whole resident windows ------------------------------------------------------

WB, WK, WM, LR = 16, 4, 3, 1e-2


@pytest.fixture(scope="module")
def setup():
    ds = synthetic_graph(num_nodes=250, avg_degree=4, feature_dim=8,
                         num_classes=4, seed=5)
    max_deg = int(ds.graph.in_degrees().max())
    rng = np.random.default_rng(3)
    grids = np.stack([np.stack([rng.choice(ds.train_idx, WB, replace=False)
                                for _ in range(WK)])
                      for _ in range(WM)]).astype(np.int32)
    return ds, [max_deg, max_deg], grids


def _jax_init(kind, fanouts, model_dtype):
    jm = jax_make_model(kind, hidden=8, num_classes=4, num_layers=2,
                        num_heads=2, dropout=0.0, dtype=model_dtype)
    caps = block_capacities(WB, fanouts)
    blocks0 = [JBlock(adj=None, mask=jnp.ones((caps[l][0], fanouts[l])))
               for l in range(2)]
    return jm, jm.init(jax.random.key(0), blocks0,
                       jnp.zeros((caps[0][1], 8), jnp.float32))


def _trainers(ds, fanouts, kind, model_bf16, lines, num_sets=8,
              sgd=False, **kw):
    """(JAX trainer, port trainer) of ``kind`` on the same params; lines
    "float32", "bfloat16" or "int8_bf16" (int8 lines on a bf16 config);
    num_sets 8 (256 lines) holds the 250-node graph: the flat tier."""
    jm, params0 = _jax_init(kind, fanouts,
                            jnp.bfloat16 if model_bf16 else jnp.float32)
    bf16_cfg = lines != "float32"
    ckw = dict(num_sets=num_sets, ways=jfc.WAYS, dim=8,
               cache_dim=jfc.round_cache_dim(8), num_colors=0,
               quantize=lines == "int8_bf16")
    jt = JTrainer(graph=ds.graph,
                  host_fetch=HostFeatureStore(ds.features).fetch,
                  labels=ds.labels,
                  cache_cfg=jfc.CacheConfig(
                      dtype=jnp.bfloat16 if bf16_cfg else jnp.float32,
                      **ckw),
                  model=jm, tx=optax.sgd(LR) if sgd else optax.adam(LR),
                  fanouts=fanouts, batch_size=WB, **kw)
    model = make_model(kind, 8, 8, 4, 2, num_heads=2, dropout=0.0,
                       dtype=BF16 if model_bf16 else torch.float32)
    model.load_state_dict(params_from_flax(jax.device_get(params0)))
    opt = (torch.optim.SGD(model.parameters(), lr=LR) if sgd else
           torch.optim.Adam(model.parameters(), lr=LR))
    tt = ResidentTrainer(graph=ds.graph,
                         host_fetch=HostFeatureStore(ds.features).fetch,
                         labels=ds.labels,
                         cache_cfg=tfc.CacheConfig(
                             dtype=BF16 if bf16_cfg else torch.float32,
                             **ckw),
                         model=model, optimizer=opt, fanouts=fanouts,
                         batch_size=WB, device="cpu", **kw)
    return jt, tt, params0


def _final_params_close(tt, jp):
    want = params_from_flax(jax.device_get(jp))
    for name, p in tt.model.state_dict().items():
        assert p.dtype == want[name].dtype, name
        torch.testing.assert_close(p.float(), want[name].float(), **TOL)


FLAT = [("sage", True, "float32", False),     # the f32-as-bf16 read
        ("sage", True, "bfloat16", False),    # resident-bf16
        ("sage", True, "int8_bf16", False),   # the int8-as-bf16 read
        ("sage", False, "int8_bf16", False),  # ... under an f32 model
        ("gcn", True, "float32", False),
        ("gcn", True, "int8_bf16", False),
        ("gat", True, "float32", True),       # GAT with SGD (every leaf)
        ("gat", True, "bfloat16", True)]


@pytest.mark.parametrize("kind,model_bf16,lines,sgd", FLAT)
def test_flat_windows_match_jax(setup, kind, model_bf16, lines, sgd):
    """Full-coverage flat windows of both trainers (fanout = max in-degree,
    dropout 0): losses within ``TOL``, edges and counters exact, final
    params within ``TOL``. int8 lines on a bf16 config equal JAX's."""
    ds, fanouts, grids = setup
    jt, tt, params0 = _trainers(ds, fanouts, kind, model_bf16, lines,
                                sgd=sgd)
    for t in (jt, tt):
        t.prewarm(np.arange(ds.graph.num_nodes, dtype=np.int32))
    assert tt.direct and tt.full_coverage
    jp, _, jlosses, jedges = jt.train_windows(params0, jt.tx.init(params0),
                                              grids, jax.random.key(7))
    tlosses, tedges = tt.train_windows(grids, seed=7)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), **TOL)
    np.testing.assert_array_equal(tedges.numpy(), np.asarray(jedges))
    assert tt.stats() == jt.stats()
    if lines == "int8_bf16":
        assert tt.cache.data.dtype == torch.int8
        np.testing.assert_array_equal(tt.cache.data.numpy(),
                                      np.asarray(jt.cache.data))
    _final_params_close(tt, jp)


@pytest.mark.parametrize("lines", ["float32", "int8_bf16"])
def test_staged_windows_with_a_bf16_model_match_jax(setup, lines):
    """A bf16 SAGE on the set-associative tier (4 sets = 128 lines for 250
    nodes, staged windows): the frontier reaches the model in cfg.dtype
    (int8 lines and int8 stage rows dequantised to bf16), and layer 0
    reads it as bf16; losses within ``TOL``, counters exact, no replay."""
    ds, fanouts, grids = setup
    jt, tt, params0 = _trainers(ds, fanouts, "sage", True, lines,
                                num_sets=4, direct=False)
    assert not tt.direct
    for t in (jt, tt):
        t.prewarm(np.arange(t.cache_cfg.capacity, dtype=np.int32))
    _, _, jlosses, jedges = jt.train_windows(params0, jt.tx.init(params0),
                                             grids, jax.random.key(5))
    tlosses, tedges = tt.train_windows(grids, seed=5)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses), **TOL)
    np.testing.assert_array_equal(tedges.numpy(), np.asarray(jedges))
    ts, js = tt.stats(), jt.stats()
    assert ts == js and ts["misses"] > 0 and ts["hits"] > 0
    assert "replay" not in tt.timers.totals


def test_replay_net_with_a_bf16_model_matches_jax(setup):
    """The per-step path that the replay net runs (begin / resolve /
    train_step, half the nodes prewarmed on the flat tier, bf16 lines):
    misses are fetched and merged in bf16, and each step's loss is JAX's
    within ``TOL``."""
    ds, fanouts, grids = setup
    jt, tt, params0 = _trainers(ds, fanouts, "sage", True, "bfloat16")
    warm = np.arange(0, ds.graph.num_nodes, 2, dtype=np.int32)
    for t in (jt, tt):
        t.prewarm(warm)
    jp, jo = params0, jt.tx.init(params0)
    for step, seeds in enumerate(grids[0]):
        resolved = jt.resolve(jt.begin(seeds, jax.random.key(step)))
        jp, jo, jloss, _ = jt.train_step(jp, jo, jax.random.key(99),
                                         resolved)
        gen = torch.Generator().manual_seed(step)
        resolved_t = tt.resolve(tt.begin(seeds, gen))
        assert resolved_t[1].dtype == BF16
        tloss, _ = tt.train_step(resolved_t, gen)
        np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
        assert tt.stats() == jt.stats()


# ---- the CLI --------------------------------------------------------------------

CLI_ARGS = ["--device", "cpu", "--num_nodes", "2000", "--feature_dim", "16",
            "--batch_size", "32", "--fan_out", "4,3", "--hidden_channels",
            "16", "--epochs", "4", "--max_steps", "6", "--learning_rate",
            "0.01", "--eval", "--dtype", "bfloat16"]


@pytest.mark.parametrize("extra", [["--cache_size", "1"],
                                   ["--cache_size", "1", "--quantize"],
                                   ["--model_type", "gat"]])
def test_cli_trains_in_bf16_on_cpu(capsys, extra):
    """``--dtype bfloat16``: bf16 cache lines (int8 lines served as bf16
    with ``--quantize``) and a bf16 model; the loss falls and the test
    accuracy is printed. The steps it trains and evaluates with are
    JAX's on the same rows (test_sharded_steps_match_jax)."""
    cli.main(CLI_ARGS + extra)
    out = capsys.readouterr().out
    losses = [float(line.split("| loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("Epoch")]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < 0.9 * losses[0], losses
    acc = [line for line in out.splitlines() if line.startswith("Test")]
    assert len(acc) == 1 and "(400 nodes)" in acc[0]
    assert ("int8 lines" in out) == ("--quantize" in extra)
