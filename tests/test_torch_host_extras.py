"""The port's last small host functions against the JAX package's:
``HostFeatureStore.fetch_async`` (the future's rows equal ``fetch``'s and
the JAX store's, bitwise, native and numpy gathers; the ids are copied at
the call) and ``data/packing.py``'s ``packed_size`` / ``request_size`` /
``request_size_contig`` (equal to JAX's and to the length of the buffers
the ``pack_*`` functions build) and ``models/layers.py``'s
``blocks_to_device``."""

import numpy as np
import pytest

from coala_gnn_tpu.cache.host_tier import HostFeatureStore as JaxStore
from coala_gnn_tpu.data import packing as jpack
from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
from coala_gnn_tpu_torch.data import packing
from coala_gnn_tpu_torch.sampling.neighbor import block_capacities


@pytest.mark.parametrize("native", [True, False])
def test_fetch_async_equals_fetch(native):
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(500, 24)).astype(np.float32)
    store = HostFeatureStore(feats, use_native=native)
    jstore = JaxStore(feats, use_native=native)
    assert store._native_ok == native
    for n in (0, 1, 37, 400):
        ids = rng.integers(-1, 500, n)
        keep = ids.copy()
        fut = store.fetch_async(ids)
        jfut = jstore.fetch_async(ids)
        ids[:] = 7                       # each call copied the ids
        got, want = fut.result(timeout=30), jfut.result(timeout=30)
        assert got.shape == (n, 24) and got.dtype == np.float32
        assert got.tobytes() == want.tobytes() == \
            store.fetch(keep).tobytes()
        assert (got[keep < 0] == 0).all()


@pytest.mark.parametrize("fanouts,batch", [([10, 5], 1024), ([4, 3, 2], 16),
                                           ([7], 5)])
def test_packed_and_request_sizes_equal_jax(fanouts, batch):
    caps = block_capacities(batch, fanouts)
    layout = packing.batch_layout(caps, fanouts)
    assert layout == jpack.batch_layout(caps, fanouts)
    n_req = caps[0][1]
    assert packing.packed_size(layout, batch) == \
        jpack.packed_size(layout, batch)
    assert packing.request_size(n_req, layout, batch) == \
        jpack.request_size(n_req, layout, batch)
    assert packing.request_size_contig(n_req, batch) == \
        jpack.request_size_contig(n_req, batch)
    # each equals the length of the buffer it sizes
    rng = np.random.default_rng(0)
    adjs = [rng.integers(0, 9, (cd, f)).astype(np.int32) for cd, f in layout]
    masks = [rng.random((cd, f)) < 0.7 for cd, f in layout]
    labels = rng.integers(0, 4, batch)
    ids = rng.integers(0, 99, n_req).astype(np.int32)
    assert packing.pack_batch(adjs, masks, labels).size == \
        packing.packed_size(layout, batch)
    assert packing.pack_request(ids, n_req, adjs, masks, labels).size == \
        packing.request_size(n_req, layout, batch)
    assert packing.pack_request_contig(ids, n_req, labels).size == \
        packing.request_size_contig(n_req, batch)


def test_blocks_to_device_equals_jax():
    """Host blocks of both layouts -> device blocks: adj and mask as JAX's
    ``blocks_to_device`` gives them, ``adj=None`` passed through."""
    from coala_gnn_tpu.models.layers import blocks_to_device as jax_blocks
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
    from coala_gnn_tpu_torch.models.layers import blocks_to_device
    from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler

    ds = synthetic_graph(num_nodes=300, avg_degree=4, feature_dim=8,
                         num_classes=4, seed=0)
    for contiguous in (False, True):
        s = NeighborSampler(ds.graph, [4, 3], 8, seed=0, use_native=False,
                            contiguous=contiguous)
        blocks = s.sample(ds.train_idx[:8]).blocks
        got, want = blocks_to_device(blocks, "cpu"), jax_blocks(blocks)
        for g, w in zip(got, want):
            assert (g.adj is None) == (w.adj is None) == contiguous
            if not contiguous:
                assert g.adj.numpy().tobytes() == \
                    np.asarray(w.adj).tobytes()
            assert g.mask.numpy().tobytes() == np.asarray(w.mask).tobytes()

