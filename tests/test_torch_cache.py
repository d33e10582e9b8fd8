"""The flat tier of coala_gnn_tpu_torch/cache/feature_cache.py against the
flat tier of coala_gnn_tpu/cache/feature_cache.py: the same inserts and
lookups give the same table, admission bytes, color counts, rows, hits
and counters (exact: the ops move data and count)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu_torch.cache import feature_cache as tfc

torch.set_num_threads(1)

N, DIM = 40, 8


def _cfgs(num_colors, tdt=torch.float32, jdt=jnp.float32, quantize=False):
    kw = dict(num_sets=2, ways=jfc.WAYS, dim=DIM,
              cache_dim=jfc.round_cache_dim(DIM), num_colors=num_colors,
              quantize=quantize)
    return jfc.CacheConfig(dtype=jdt, **kw), tfc.CacheConfig(dtype=tdt, **kw)


def _same_state(t, j):
    np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
    assert (t.scale is None) == (j.scale is None)
    if j.scale is not None:
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    np.testing.assert_array_equal(t.admitted.numpy(), np.asarray(j.admitted))
    np.testing.assert_array_equal(t.color_counts.numpy(),
                                  np.asarray(j.color_counts))
    assert int(t.hits) == int(j.hits) and int(t.misses) == int(j.misses)


def _insert_lookup_probe(rng, num_colors, quantize):
    jcfg, tcfg = _cfgs(num_colors, quantize=quantize)
    feats = (rng.normal(size=(N, DIM)) *
             rng.uniform(0.01, 30, size=(N, 1))).astype(np.float32)
    colors_all = rng.integers(0, num_colors + 1, size=N).astype(np.int32)
    js, ts = jfc.flat_init(jcfg, N), tfc.flat_init(tcfg, N, "cpu")
    _same_state(ts, js)
    # two batches with repeats within and across them, and invalid slots
    for ids in (np.array([3, 7, 7, 11, 0, 3, 25], np.int32),
                np.array([7, 30, 31, 31, 2], np.int32)):
        valid = np.ones(ids.size, bool)
        valid[-1] = False
        args = (ids, feats[ids], valid, colors_all[ids])
        js = jfc.flat_insert(jcfg, js, *map(jnp.asarray, args))
        ts = tfc.flat_insert(tcfg, ts, *map(torch.from_numpy, args))
        _same_state(ts, js)
    if num_colors:
        assert int(ts.color_counts.sum()) > 0

    ids = rng.integers(0, N, size=25).astype(np.int32)
    valid = rng.random(25) < 0.8
    for _ in range(2):                            # counters accumulate
        js, jf, jh = jfc.flat_lookup(js, jnp.asarray(ids),
                                     jnp.asarray(valid))
        ts, tf, th = tfc.flat_lookup(ts, torch.from_numpy(ids),
                                     torch.from_numpy(valid))
        assert tf.dtype == torch.float32
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        _same_state(ts, js)
    assert int(ts.hits) > 0 and int(ts.misses) > 0
    np.testing.assert_array_equal(
        tfc.flat_probe(ts, torch.from_numpy(ids),
                       torch.from_numpy(valid)).numpy(),
        np.asarray(jfc.flat_probe(js, jnp.asarray(ids), jnp.asarray(valid))))


@pytest.mark.parametrize("num_colors", [0, 4])
def test_insert_lookup_probe_match_jax(rng, num_colors):
    _insert_lookup_probe(rng, num_colors, quantize=False)


@pytest.mark.parametrize("num_colors", [0, 4])
def test_int8_table_matches_jax(rng, num_colors):
    """quantize=True: int8 rows and f32 scales (ones where nothing was
    admitted) bitwise equal to JAX's after each insert, and lookups that
    dequantise to the same f32 rows."""
    _insert_lookup_probe(rng, num_colors, quantize=True)
    _, tcfg = _cfgs(num_colors, quantize=True)
    st = tfc.flat_init(tcfg, N, "cpu")
    assert st.data.dtype == torch.int8 and st.data.shape == (N + 1, DIM)
    assert (st.scale == 1).all() and st.scale.shape == (N + 1,)


def test_bf16_table_rounds_like_jax(rng):
    jcfg, tcfg = _cfgs(0, torch.bfloat16, jnp.bfloat16)
    ids = np.arange(0, N, 3, dtype=np.int32)
    rows = rng.normal(size=(ids.size, DIM)).astype(np.float32)
    valid = np.ones(ids.size, bool)
    colors = np.zeros(ids.size, np.int32)
    js = jfc.flat_insert(jcfg, jfc.flat_init(jcfg, N),
                         *map(jnp.asarray, (ids, rows, valid, colors)))
    ts = tfc.flat_insert(tcfg, tfc.flat_init(tcfg, N, "cpu"),
                         *map(torch.from_numpy, (ids, rows, valid, colors)))
    assert ts.data.dtype == torch.bfloat16
    np.testing.assert_array_equal(ts.data.float().numpy(),
                                  np.asarray(js.data.astype(jnp.float32)))


@pytest.mark.parametrize("dim", [1, 100, 128, 129, 300, 1024, 1500])
def test_round_cache_dim(dim):
    assert tfc.round_cache_dim(dim) == jfc.round_cache_dim(dim)


@pytest.mark.parametrize("tdt,jdt", [(torch.float32, jnp.float32),
                                     (torch.bfloat16, jnp.bfloat16)])
def test_make_config_matches(tdt, jdt):
    for mb, dim in [(1, 8), (64, 256), (1024, 256), (3, 1000)]:
        t = tfc.make_config(mb, dim, num_colors=3, dtype=tdt)
        j = jfc.make_config(mb, dim, num_colors=3, dtype=jdt)
        assert (t.num_sets, t.ways, t.dim, t.cache_dim, t.num_colors,
                t.capacity) == \
            (j.num_sets, j.ways, j.dim, j.cache_dim, j.num_colors,
             j.capacity)
        # int8 lines page by cache_dim + 4 bytes, whatever the dtype
        t = tfc.make_config(mb, dim, num_colors=3, dtype=tdt, quantize=True)
        j = jfc.make_config(mb, dim, num_colors=3, dtype=jdt, quantize=True)
        assert t.quantize and (t.num_sets, t.capacity, t.line_bytes,
                               t.size_mb) == \
            (j.num_sets, j.capacity, j.line_bytes, j.size_mb)


def test_ids_must_fit_int32():
    tfc.assert_ids_fit_int32(2**31 - 1)
    with pytest.raises(ValueError):
        tfc.assert_ids_fit_int32(2**31)
