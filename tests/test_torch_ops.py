"""coala_gnn_tpu_torch/ops/aggregate.py and ops/segment.py against
coala_gnn_tpu/ops/aggregate.py and ops/segment.py on the same numpy
inputs, both block layouts (``adj`` given, and the contiguous slot-major
``adj is None``), f32 and bf16 (and int8 tables for the table forms).

Tolerances: f32 1e-6 (rtol and atol; the same products summed in the same
slot order, at most fused vs separate multiply-add apart). bf16 results are
compared in f32 at 2^-7 (one bf16 ulp: both sides round the same f32 sum
once, and an f32 difference in the last bit can flip that rounding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.ops import aggregate as jagg
from coala_gnn_tpu.ops import segment as jseg
from coala_gnn_tpu_torch.ops import aggregate as tagg
from coala_gnn_tpu_torch.ops import segment as tseg

torch.set_num_threads(1)

CAP, FAN, DIM = 12, 5, 16
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7)}


@pytest.fixture
def inputs(rng):
    x = rng.normal(size=(CAP * (1 + FAN), DIM)).astype(np.float32)
    adj = rng.integers(0, x.shape[0], size=(CAP, FAN)).astype(np.int32)
    mask = (rng.random((CAP, FAN)) < 0.7).astype(np.float32)
    mask[0] = 0.0                                  # a dst with no neighbour
    weights = rng.random((CAP, FAN)).astype(np.float32)
    return x, adj, mask, weights


def _both(x, adj, w, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    j = (jnp.asarray(x, jdt), None if adj is None else jnp.asarray(adj),
         jnp.asarray(w))
    t = (torch.from_numpy(x).to(tdt),
         None if adj is None else torch.from_numpy(adj), torch.from_numpy(w))
    return j, t


def _check(jout, tout, dtype, exact=False):
    assert str(tout.dtype).split(".")[-1] == str(jout.dtype)
    want = np.asarray(jnp.asarray(jout, jnp.float32))
    got = tout.float().numpy()
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        tol = DTYPES[dtype][2]
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["padded_gather_sum", "padded_mean"])
def test_padded(inputs, dtype, name):
    x, adj, mask, weights = inputs
    w = mask if name == "padded_mean" else weights * mask
    j, t = _both(x, adj, w, dtype)
    _check(getattr(jagg, name)(*j), getattr(tagg, name)(*t), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["adj", "contiguous"])
@pytest.mark.parametrize("name", ["agg_sum", "agg_mean"])
def test_agg(inputs, dtype, layout, name):
    x, adj, mask, weights = inputs
    w = mask if name == "agg_mean" else weights * mask
    j, t = _both(x, adj if layout == "adj" else None, w, dtype)
    _check(getattr(jagg, name)(*j), getattr(tagg, name)(*t), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["adj", "contiguous"])
def test_views(inputs, dtype, layout):
    """slot_planes and neighbor_view move data only: bitwise equal."""
    x, adj, mask, _ = inputs
    j, t = _both(x, adj if layout == "adj" else None, mask, dtype)
    _check(jagg.neighbor_view(j[0], j[1], (CAP, FAN)),
           tagg.neighbor_view(t[0], t[1], (CAP, FAN)), dtype, exact=True)
    _check(jagg.slot_planes(j[0], (CAP, FAN)),
           tagg.slot_planes(t[0], (CAP, FAN)), dtype, exact=True)


def test_frontier_adj_is_the_slot_major_layout(rng):
    ids = torch.from_numpy(
        rng.integers(0, 1000, size=CAP * (1 + FAN)).astype(np.int32))
    adj = tagg.frontier_adj(ids, (CAP, FAN))
    assert adj.dtype == torch.int32 and adj.is_contiguous()
    for i in range(CAP):
        for k in range(FAN):
            assert adj[i, k] == ids[CAP + k * CAP + i]


@pytest.mark.parametrize("dtype", DTYPES)
def test_table_agg_mean_equals_agg_mean_on_gathered_rows(rng, inputs,
                                                         dtype):
    """The fused layer-0 form against the JAX contiguous agg_mean on the
    gathered (f32-widened) rows."""
    _, _, mask, _ = inputs
    _, tdt, _ = DTYPES[dtype]
    table = rng.normal(size=(50, DIM)).astype(np.float32)
    ids = rng.integers(0, 50, size=CAP * (1 + FAN)).astype(np.int32)
    t_table = torch.from_numpy(table).to(tdt)
    gathered = t_table[torch.from_numpy(ids)].float().numpy()
    want = jagg.agg_mean(jnp.asarray(gathered), None, jnp.asarray(mask))
    got = tagg.table_agg_mean(t_table, torch.from_numpy(ids),
                              torch.from_numpy(mask))
    _check(want, got, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_padded_gather_sum_dense(inputs, dtype):
    x, adj, mask, weights = inputs
    j, t = _both(x, adj, weights * mask, dtype)
    _check(jagg.padded_gather_sum_dense(*j),
           tagg.padded_gather_sum_dense(*t), dtype)


def _table(rng, dtype):
    """(table, scale or None, the f32 rows the table holds) for a table of
    50 rows in ``dtype`` (int8: JAX's quantize_rows of normal rows)."""
    rows = rng.normal(size=(50, DIM)).astype(np.float32)
    if dtype == "int8":
        q, scale = jfc.quantize_rows(jnp.asarray(rows))
        deq = np.array(jfc.dequantize_rows(q, scale))
        return (torch.from_numpy(np.array(q)),
                torch.from_numpy(np.array(scale)), deq)
    t = torch.from_numpy(rows).to(getattr(torch, dtype))
    return t, None, t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", ["agg_sum", "agg_mean"])
def test_table_aggregates_equal_jax_on_the_rows_held(rng, inputs, dtype,
                                                     name):
    """table_agg_sum / table_agg_mean (scale for an int8 table) against the
    JAX contiguous agg_sum / agg_mean on the rows the table holds: widened,
    or dequantised by JAX's dequantize_rows."""
    _, _, mask, weights = inputs
    w = mask if name == "agg_mean" else weights * mask
    table, scale, rows = _table(rng, dtype)
    ids = rng.integers(0, 50, size=CAP * (1 + FAN)).astype(np.int32)
    want = getattr(jagg, name)(jnp.asarray(rows[ids]), None, jnp.asarray(w))
    got = getattr(tagg, f"table_{name}")(table, torch.from_numpy(ids),
                                         torch.from_numpy(w), scale)
    _check(want, got, "float32")


# ---- ops/segment.py: the COO oracles --------------------------------------

def _coo(rng, n_src=30, n_dst=12, n_edges=80):
    src = rng.integers(0, n_src, n_edges).astype(np.int32)
    dst = rng.integers(0, n_dst - 2, n_edges).astype(np.int32)  # 2 empty
    return src, dst


@pytest.mark.parametrize("weighted", [False, True])
def test_spmm_coo_matches_jax(rng, weighted):
    src, dst = _coo(rng)
    x = rng.normal(size=(30, DIM)).astype(np.float32)
    w = rng.random(src.size).astype(np.float32) if weighted else None
    want = jseg.spmm_coo(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
                         12, None if w is None else jnp.asarray(w))
    got = tseg.spmm_coo(torch.from_numpy(x), torch.from_numpy(src),
                        torch.from_numpy(dst), 12,
                        None if w is None else torch.from_numpy(w))
    _check(want, got, "float32")
    assert not got[10:].any()


@pytest.mark.parametrize("heads", [None, 3])
def test_segment_softmax_matches_jax(rng, heads):
    """Per-edge scores [E] or [E, heads]; two segments are empty. 1e-6:
    exp and the segment sums differ in their last bits."""
    src, dst = _coo(rng)
    shape = (src.size,) if heads is None else (src.size, heads)
    scores = (5 * rng.normal(size=shape)).astype(np.float32)
    want = jseg.segment_softmax(jnp.asarray(scores), jnp.asarray(dst), 12)
    got = tseg.segment_softmax(torch.from_numpy(scores),
                               torch.from_numpy(dst), 12)
    _check(want, got, "float32")
    sums = tseg.spmm_coo(got.reshape(src.size, -1), torch.arange(src.size),
                         torch.from_numpy(dst), 12)
    torch.testing.assert_close(sums[:10], torch.ones_like(sums[:10]))
