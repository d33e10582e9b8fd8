"""The port's own copies of the JAX package's host modules, held bit for
bit against the originals on the same seeds and inputs:
``graph/datasets.py`` (``synthetic_graph``), ``graph/csc.py``
(``coo_to_csc``), ``sampling/neighbor.py`` (``block_capacities``),
``cache/host_tier.py`` (``HostFeatureStore.fetch`` / ``fetch_encoded``,
native and numpy), ``native/lib.py`` over ``csrc/host_native.cpp`` (the
five row functions) and ``utils/timers.py`` (``PhaseTimers``).

Exact equality throughout: the copies run the same numpy calls in the same
order, and the native functions the same arithmetic built with the same
g++ flags."""

import numpy as np
import pytest

from coala_gnn_tpu.cache.host_tier import HostFeatureStore as JaxStore
from coala_gnn_tpu.graph.csc import coo_to_csc as jax_coo_to_csc
from coala_gnn_tpu.graph.datasets import synthetic_graph as jax_synthetic
from coala_gnn_tpu.native import lib as jax_native
from coala_gnn_tpu.sampling.neighbor import \
    block_capacities as jax_block_capacities
from coala_gnn_tpu.utils.timers import PhaseTimers as JaxTimers
from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
from coala_gnn_tpu_torch.graph.csc import CSCGraph, coo_to_csc
from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
from coala_gnn_tpu_torch.native import lib as native
from coala_gnn_tpu_torch.sampling.neighbor import block_capacities
from coala_gnn_tpu_torch.utils.timers import PhaseTimers


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kw", [
    dict(num_nodes=300, avg_degree=4, feature_dim=8, num_classes=4, seed=0),
    dict(num_nodes=1000, avg_degree=15, feature_dim=32, num_classes=16,
         seed=5),
    dict(num_nodes=777, avg_degree=6, feature_dim=3, num_classes=7, seed=9,
         power_law=False),
])
def test_synthetic_graph_is_numpy_identical(kw):
    ours, ref = synthetic_graph(**kw), jax_synthetic(**kw)
    for name in ("features", "labels", "train_idx", "val_idx", "test_idx"):
        _equal(getattr(ours, name), getattr(ref, name))
    _equal(ours.graph.indptr, ref.graph.indptr)
    _equal(ours.graph.indices, ref.graph.indices)
    assert (ours.num_classes, ours.name, ours.feature_dim) == \
        (ref.num_classes, ref.name, ref.feature_dim)
    assert (ours.graph.num_nodes, ours.graph.num_edges) == \
        (ref.graph.num_nodes, ref.graph.num_edges)
    _equal(ours.graph.in_degrees(), ref.graph.in_degrees())
    nodes = np.array([0, 5, 17])
    _equal(ours.graph.in_degrees(nodes), ref.graph.in_degrees(nodes))


@pytest.mark.parametrize("n,e,dtype", [(50, 400, np.int64), (10, 0, np.int64),
                                       (200, 999, np.int32), (1, 7, np.int64)])
def test_coo_to_csc_is_numpy_identical(rng, n, e, dtype):
    """Repeated edges, isolated nodes, an empty edge list, int32 ids."""
    src = rng.integers(0, n, size=e).astype(dtype)
    dst = rng.integers(0, n, size=e).astype(dtype)
    ours, ref = coo_to_csc(src, dst, n), jax_coo_to_csc(src, dst, n)
    _equal(ours.indptr, ref.indptr)
    _equal(ours.indices, ref.indices)
    with pytest.raises(ValueError):
        coo_to_csc(src, dst[:-1] if e else np.zeros(1, dtype), n)


def test_csc_graph_checks_its_arrays():
    with pytest.raises(ValueError):
        CSCGraph(indptr=np.array([0, 2, 3]), indices=np.zeros(2, np.int32))
    with pytest.raises(ValueError):
        CSCGraph(indptr=np.zeros((2, 2)), indices=np.zeros(0, np.int32))
    g = CSCGraph(indptr=np.array([0, 2, 3], np.int32),
                 indices=np.array([1, 0, 0], np.int32))
    assert g.indptr.dtype == np.int64 and g.num_nodes == 2


@pytest.mark.parametrize("batch,fanouts", [
    (1024, [10, 5]), (1, [3]), (64, [5, 4]), (512, [15, 10, 5]),
    (16, [1, 1, 1, 1]), (7, [])])
def test_block_capacities_equal(batch, fanouts):
    assert block_capacities(batch, fanouts) == \
        jax_block_capacities(batch, fanouts)


def _features(rng, n=300, dim=24):
    x = rng.normal(size=(n, dim)).astype(np.float32)
    x[3] = 0.0                                    # an all-zero row
    x[4, :5] = [np.nan, np.inf, -np.inf, 1e-40, -0.0]
    x[5] = np.float32(2.5) * np.float32(1 / 127)  # ties at the int8 step
    return x


def _ids(rng, n, k=97):
    ids = rng.integers(0, n, size=k).astype(np.int64)
    ids[[0, 10, 50]] = -1
    ids[[1, 2]] = [3, 5]
    return ids


@pytest.mark.parametrize("use_native", [True, False])
def test_fetch_equals_jax_store(rng, use_native):
    x = _features(rng)
    ours, ref = (HostFeatureStore(x, use_native=use_native),
                 JaxStore(x, use_native=use_native))
    assert ours._native_ok == ref._native_ok == use_native
    ids = _ids(rng, x.shape[0])
    _equal(ours.fetch(ids), ref.fetch(ids))
    out_a, out_b = (np.full((ids.size, x.shape[1]), 7, np.float32)
                    for _ in range(2))
    ours.fetch(ids, out=out_a)
    ref.fetch(ids, out=out_b)
    _equal(out_a, out_b)
    assert not out_a[0].any()


@pytest.mark.parametrize("transport", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("use_native", [True, False])
def test_fetch_encoded_equals_jax_store(rng, transport, use_native):
    """bf16 comes back as its uint16 bits, JAX's as an ml_dtypes view of
    the same bits; without the native library both return None."""
    x = _features(rng)
    ours, ref = (HostFeatureStore(x, use_native=use_native),
                 JaxStore(x, use_native=use_native))
    ids = _ids(rng, x.shape[0])
    got, want = (ours.fetch_encoded(ids, transport),
                 ref.fetch_encoded(ids, transport))
    if not use_native:
        assert got is None and want is None
        return
    if transport == "bfloat16":
        assert got[0].dtype == np.uint16
        want = (want[0].view(np.uint16), None)
    _equal(got[0], want[0])
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        _equal(got[1], want[1])
        assert got[1][0] == 1.0 and not got[0][0].any()   # id -1
    with pytest.raises(ValueError, match="float16"):
        ours.fetch_encoded(ids, "float16")


@pytest.mark.parametrize("use_native", [True, False])
def test_fetch_encoded_refuses_an_unknown_transport(rng, use_native):
    """The port raises where the JAX store returns None (ROADMAP.md
    section C), with or without the native library."""
    x = _features(rng)
    ours, ref = (HostFeatureStore(x, use_native=use_native),
                 JaxStore(x, use_native=use_native))
    ids = _ids(rng, x.shape[0])
    assert ref.fetch_encoded(ids, "float16") is None
    with pytest.raises(ValueError, match="'float16'"):
        ours.fetch_encoded(ids, "float16")


def test_fetch_encoded_fills_caller_buffers(rng):
    x = _features(rng)
    ours, ref = HostFeatureStore(x), JaxStore(x)
    ids = _ids(rng, x.shape[0])
    q, s = np.empty((ids.size, x.shape[1]), np.int8), np.empty(ids.size,
                                                             np.float32)
    got = ours.fetch_encoded(ids, "int8", enc_out=q, scale_out=s)
    assert got[0] is q and got[1] is s
    _equal(q, ref.fetch_encoded(ids, "int8")[0])
    bits = np.empty((ids.size, x.shape[1]), np.uint16)
    assert ours.fetch_encoded(ids, "bfloat16", enc_out=bits)[0] is bits
    _equal(bits, ref.fetch_encoded(ids, "bfloat16")[0].view(np.uint16))


def test_store_without_native_for_other_layouts(rng):
    """A non-f32 or non-contiguous matrix takes the numpy gather."""
    x = _features(rng)
    assert not HostFeatureStore(x.astype(np.float64))._native_ok
    assert not HostFeatureStore(np.asfortranarray(x))._native_ok
    ids = _ids(rng, x.shape[0])
    _equal(HostFeatureStore(np.asfortranarray(x)).fetch(ids),
           JaxStore(x, use_native=False).fetch(ids))


@pytest.mark.parametrize("fn", ["gather_rows_f32", "quantize_rows",
                                "encode_bf16", "gather_rows_bf16",
                                "gather_quantize_rows"])
def test_native_functions_equal_jax(rng, fn):
    lib, jlib = native.get(), jax_native.get()
    x = _features(rng)
    ids = _ids(rng, x.shape[0])
    if fn == "gather_rows_f32":
        _equal(native.gather_rows(lib, x, ids),
               jax_native.gather_rows(jlib, x, ids))
    elif fn == "quantize_rows":
        for a, b in zip(native.quantize_rows(lib, x),
                        jax_native.quantize_rows_native(x)):
            _equal(a, b)
    elif fn == "encode_bf16":
        _equal(native.encode_bf16(lib, x),
               jax_native.encode_bf16(x).view(np.uint16))
    elif fn == "gather_rows_bf16":
        _equal(native.gather_rows_bf16(lib, x, ids),
               jax_native.gather_rows_bf16(jlib, x, ids).view(np.uint16))
    else:
        for a, b in zip(native.gather_quantize_rows(lib, x, ids),
                        jax_native.gather_quantize_rows(jlib, x, ids)):
            _equal(a, b)


def test_native_library_builds_into_the_port(rng):
    """The port's library lives under coala_gnn_tpu_torch/_build/, named
    by its source's hash, and the gather refuses a non-f32 table."""
    import os

    from coala_gnn_tpu_torch.utils import build

    path = build.library_path(native.SOURCE)
    assert os.path.dirname(path) == build.BUILD_DIR
    assert build.BUILD_DIR.endswith(os.path.join("coala_gnn_tpu_torch",
                                                 "_build"))
    native.get()
    assert os.path.exists(path)
    with pytest.raises(TypeError):
        native.gather_rows(native.get(), np.zeros((4, 2)), np.zeros(1))


def test_phase_timers_match_jax():
    ours, ref = PhaseTimers(), JaxTimers()
    for t in (ours, ref):
        t.add("gather", 0.25)
        t.add("gather", 0.5)
        t.add("upload", 0.125)
        t.tally("stage_rows", 1234)
        t.tally("stage_rows", 66)
    assert ours.summary() == ref.summary()
    assert ours.report() == ref.report()
    with ours.time("probe"):
        pass
    assert ours.counts["probe"] == 1 and ours.totals["probe"] >= 0
    ours.reset()
    assert not ours.totals and not ours.counts and not ours.tallies
