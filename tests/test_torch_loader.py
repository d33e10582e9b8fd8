"""The port's loader and packing (``data/loader.py``, ``data/packing.py``)
against the JAX package's: every ``HostBatch`` field equal for the same
seeds (both wire layouts, one and two local devices, the prefetch thread
and the caller's thread, an exact-tail epoch), ``pack_*`` byte-identical,
and the torch ``unpack_*`` giving JAX's blocks and labels from the same
buffer. Mirrors tests/test_packing.py, tests/test_loader_contract.py and
the wire roundtrip of tests/test_contig_host_pipeline.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coala_gnn_tpu.data import packing as jpack
from coala_gnn_tpu.data.loader import CoalaDataLoader as JaxLoader
from coala_gnn_tpu.distribution import DistributionScheduler as JaxScheduler
from coala_gnn_tpu.distribution import SeedDistributor as JaxDistributor
from coala_gnn_tpu.graph.datasets import synthetic_graph as jax_synthetic
from coala_gnn_tpu.sampling.neighbor import NeighborSampler as JaxSampler
from coala_gnn_tpu_torch.data import packing
from coala_gnn_tpu_torch.data.loader import CoalaDataLoader, HostBatch
from coala_gnn_tpu_torch.distribution import (DistributionScheduler,
                                              SeedDistributor)
from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler

KW = dict(num_nodes=3000, avg_degree=8, feature_dim=8, num_classes=4,
          seed=5)
B, FANOUTS = 16, [4, 3]


@pytest.fixture(scope="module")
def dss():
    return synthetic_graph(**KW), jax_synthetic(**KW)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _loaders(dss, contiguous, local_size, prefetch, drop_tail=True):
    out = []
    for ds, Dist, Sched, Sampler, Loader in (
            (dss[0], SeedDistributor, DistributionScheduler, NeighborSampler,
             CoalaDataLoader),
            (dss[1], JaxDistributor, JaxScheduler, JaxSampler, JaxLoader)):
        d = Dist(ds.train_idx, batch_size=B, local_size=local_size,
                 num_parts=1, mode="baseline", shuffle_seed=3,
                 drop_tail=drop_tail)
        out.append(Loader(scheduler=Sched(d, part_id=0, local_rank=0),
                          sampler=Sampler(ds.graph, FANOUTS, B, seed=7,
                                          contiguous=contiguous),
                          labels=ds.labels, local_size=local_size,
                          prefetch=prefetch))
    return out


def _host_batches_equal(a: HostBatch, b) -> None:
    for name in HostBatch._fields:
        x, y = getattr(a, name), getattr(b, name)
        if name in ("adjs", "masks"):
            assert (x is None) == (y is None), name
            for u, v in zip(x or [], y or []):
                _equal(u, v)
        elif name in ("sampled_nodes", "edges"):
            assert x == y, name
        else:
            assert (x is None) == (y is None), name
            if x is not None:
                _equal(x, y)
    assert b.rels is None


@pytest.mark.parametrize("contiguous", [False, True])
@pytest.mark.parametrize("local_size,prefetch", [(1, 2), (2, 0)])
def test_host_batches_equal_jax(dss, contiguous, local_size, prefetch):
    """Five batches, then (in the caller's thread, where the sampler's
    stream has not run ahead) a reshuffled epoch's first."""
    ours, ref = _loaders(dss, contiguous, local_size, prefetch)
    assert len(ours) == len(ref)
    for _, a, b in zip(range(5), ours, ref):
        _host_batches_equal(a, b)
    if prefetch == 0:
        ours.reset(11)
        ref.reset(11)
        _host_batches_equal(next(iter(ours)), next(iter(ref)))


def test_exact_tail_epoch_equals_jax(dss):
    """drop_tail=False: the last batch's validity mask rides along."""
    ours, ref = _loaders(dss, False, 1, 2, drop_tail=False)
    batches = list(zip(ours, ref))
    assert len(batches) == len(ours) == -(-len(dss[0].train_idx) // B)
    for a, b in batches:
        _host_batches_equal(a, b)
    assert not batches[-1][0].valid.all() and batches[0][0].valid.all()


def test_contiguous_batches_carry_edges_not_masks(dss):
    contig, _ = _loaders(dss, True, 2, 0)
    padded, _ = _loaders(dss, False, 2, 0)
    hb_c, hb_p = next(iter(contig)), next(iter(padded))
    assert hb_c.adjs is None and hb_c.masks is None and hb_c.edges > 0
    assert hb_p.edges == int(sum(m.sum() for m in hb_p.masks))
    np.testing.assert_array_equal(hb_c.seeds, hb_p.seeds)


def test_worker_errors_reach_the_consumer(dss):
    ours, _ = _loaders(dss, False, 1, 2)

    def broken(seeds):
        raise KeyError("sampler failed")

    ours.sampler.sample = broken
    with pytest.raises(KeyError):
        next(iter(ours))


def _sample(dss, contiguous, seed=0):
    s = NeighborSampler(dss[0].graph, FANOUTS, B, seed=seed,
                        contiguous=contiguous)
    batch = s.sample(dss[0].train_idx[:B])
    labels = dss[0].labels[batch.seeds].astype(np.int32)
    return s, batch, labels


def _blocks_equal(ours, ref) -> None:
    for a, b in zip(ours, ref):
        assert (a.adj is None) == (b.adj is None)
        if a.adj is not None:
            assert a.adj.dtype == torch.int32
            _equal(a.adj.numpy(), np.asarray(b.adj))
        assert a.mask.dtype == torch.float32
        _equal(a.mask.numpy(), np.asarray(b.mask))


def test_pack_and_unpack_batch_equal_jax(dss):
    s, batch, labels = _sample(dss, False)
    adjs = [b.adj for b in batch.blocks]
    masks = [b.mask for b in batch.blocks]
    buf = packing.pack_batch(adjs, masks, labels)
    _equal(buf, jpack.pack_batch(adjs, masks, labels))
    layout = packing.batch_layout(s.caps, FANOUTS)
    assert layout == jpack.batch_layout(s.caps, FANOUTS)
    assert buf.shape == (sum(cd * f for cd, f in layout) + B,)
    blocks, lab = packing.unpack_batch(torch.from_numpy(buf), layout, B)
    jblocks, jlab = jax.jit(lambda b: jpack.unpack_batch(b, layout, B))(
        jnp.asarray(buf))
    _blocks_equal(blocks, jblocks)
    _equal(lab.numpy(), np.asarray(jlab))
    _equal(lab.numpy(), labels)
    for blk, host in zip(blocks, batch.blocks):
        m = host.mask > 0
        np.testing.assert_array_equal(blk.adj.numpy()[m], host.adj[m])


def test_pack_and_unpack_request_equal_jax(dss):
    s, batch, labels = _sample(dss, False, seed=1)
    ids = batch.input_ids.astype(np.int32)
    args = (ids, batch.num_input, [b.adj for b in batch.blocks],
            [b.mask for b in batch.blocks], labels)
    vec = packing.pack_request(*args)
    _equal(vec, jpack.pack_request(*args))
    n_req = s.caps[0][1]
    layout = packing.batch_layout(s.caps, FANOUTS)
    assert vec.shape == (1 + n_req + sum(cd * f for cd, f in layout) + B,)
    buf = torch.from_numpy(vec)
    got_ids, n_valid = packing.unpack_request_ids(buf, n_req)
    want_ids, want_n = jpack.unpack_request_ids(jnp.asarray(vec), n_req)
    _equal(got_ids.numpy(), np.asarray(want_ids))
    assert int(n_valid) == int(want_n) == batch.num_input
    blocks, lab = packing.unpack_request_batch(buf, n_req, layout, B)
    jblocks, jlab = jax.jit(lambda b: jpack.unpack_request_batch(
        b, n_req, layout, B))(jnp.asarray(vec))
    _blocks_equal(blocks, jblocks)
    _equal(lab.numpy(), np.asarray(jlab))


def test_pack_and_unpack_contig_request_equal_jax(dss):
    s, batch, labels = _sample(dss, True, seed=2)
    sent = dss[0].graph.num_nodes
    ids = batch.input_ids.astype(np.int32)
    vec = packing.pack_request_contig(ids, batch.num_input, labels)
    _equal(vec, jpack.pack_request_contig(ids, batch.num_input, labels))
    n_req = s.caps[0][1]
    assert vec.shape == (1 + n_req + B,)
    layout = packing.batch_layout(s.caps, FANOUTS)
    blocks, lab = packing.unpack_request_contig(torch.from_numpy(vec), n_req,
                                                layout, B, sent)
    jblocks, jlab = jax.jit(lambda b: jpack.unpack_request_contig(
        b, n_req, layout, B, sent))(jnp.asarray(vec))
    _blocks_equal(blocks, jblocks)
    _equal(lab.numpy(), np.asarray(jlab))
    for blk, host in zip(blocks, batch.blocks):
        _equal(blk.mask.numpy(), host.mask)
