"""coala_gnn_tpu_torch/sampling/device_sampler.py against
coala_gnn_tpu/sampling/device_sampler.py (dedup=False).

The two frameworks draw other random numbers from a seed (threefry vs
Philox / the CPU generator), so the port is fed JAX's own uniforms,
replayed from the key: sample_blocks_device splits ``key, sub =
split(key)`` once per layer, output-most layer first, and draws
``uniform(sub, (cap_dst, fanout))``. Given the same uniforms the ids and
masks must be bitwise equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coala_gnn_tpu.sampling import device_sampler as jds
from coala_gnn_tpu.sampling.neighbor import block_capacities
from coala_gnn_tpu_torch.sampling import device_sampler as tds

torch.set_num_threads(1)


def jax_uniforms(key, batch_size, fanouts):
    """JAX's draws, indexed by layer (input-most first)."""
    caps = block_capacities(batch_size, fanouts)
    out = [None] * len(fanouts)
    for layer in range(len(fanouts) - 1, -1, -1):
        key, sub = jax.random.split(key)
        out[layer] = np.array(
            jax.random.uniform(sub, (caps[layer][0], fanouts[layer])))
    return out


@pytest.mark.parametrize("fanouts", [[4, 3], [2, 2, 2], [10, 5]])
def test_blocks_bitwise_equal_given_jax_uniforms(tiny_dataset, fanouts):
    g = tiny_dataset.graph
    assert int(g.in_degrees().max()) > max(fanouts)   # random branch live
    B = 8
    seeds = np.random.default_rng(1).choice(g.num_nodes, B, replace=False) \
        .astype(np.int32)
    key = jax.random.key(11)
    jblocks, jids, jnum = jds.sample_blocks_device(
        jds.to_device_graph(g), jnp.asarray(seeds), fanouts, B, key,
        dedup=False)
    uni = [torch.from_numpy(u) for u in jax_uniforms(key, B, fanouts)]
    tblocks, tids, tnum = tds.sample_blocks_device(
        tds.to_device_graph(g, "cpu"), torch.from_numpy(seeds), fanouts, B,
        uniforms=uni)
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert int(tnum) == int(jnum)
    assert len(tblocks) == len(jblocks)
    for tb, jb in zip(tblocks, jblocks):
        assert tb.adj is None and jb.adj is None
        np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask))


def test_sample_layer_with_sentinel_rows(tiny_dataset):
    """Padding dst rows (the sentinel id num_nodes) read degree 0 through
    the padded indptr: all slots masked, pointing at the sentinel."""
    g = tiny_dataset.graph
    n = g.num_nodes
    deg = np.diff(np.asarray(g.indptr))
    dst = np.array([int(deg.argmax()), int(deg.argmin()), 5, n, n],
                   np.int32)
    key = jax.random.key(2)
    jnbr, jmask, _ = jds._sample_layer(jds.to_device_graph(g),
                                       jnp.asarray(dst), 4, key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (5, 4))))
    tg = tds.to_device_graph(g, "cpu")
    tnbr, tmask, trel = tds._sample_layer(tg, torch.from_numpy(dst), 4,
                                          uniforms=u)
    np.testing.assert_array_equal(tnbr.numpy(), np.asarray(jnbr))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert trel is None      # an untyped graph has no relation ids
    assert tg.num_nodes == n and tg.indptr.dtype == torch.int64
    assert int(tg.indptr[n + 1] - tg.indptr[n]) == 0
    assert (tnbr[3:] == n).all() and not tmask[3:].any()


def test_generator_draws(tiny_dataset):
    """Without uniforms the port draws from the generator: the same seed
    gives the same blocks, and every sampled slot is a real in-edge."""
    g = tiny_dataset.graph
    tg = tds.to_device_graph(g, "cpu")
    seeds = torch.arange(16, dtype=torch.int32)

    def run(s):
        return tds.sample_blocks_device(tg, seeds, [4, 3], 16,
                                        torch.Generator().manual_seed(s))

    (b1, ids1, _), (b2, ids2, _) = run(5), run(5)
    assert torch.equal(ids1, ids2)
    assert not torch.equal(ids1, run(6)[1])
    indptr, indices = np.asarray(g.indptr), np.asarray(g.indices)
    cap = 16 * 4
    adj = ids1[cap:].view(4, cap).T.numpy()
    mask = b1[0].mask.numpy()
    dst = ids1[:cap].numpy()
    for i in range(cap):
        if dst[i] == g.num_nodes:
            assert not mask[i].any()
            continue
        nbrs = set(indices[indptr[dst[i]]:indptr[dst[i] + 1]].tolist())
        deg = len(indices[indptr[dst[i]]:indptr[dst[i] + 1]])
        assert mask[i].sum() == min(deg, 4)
        for k in range(4):
            assert (adj[i, k] in nbrs) if mask[i, k] else adj[i, k] == dst[i]


def test_fits_device_graph():
    i32 = np.iinfo(np.int32).max
    for nodes, edges in [(10, 100), (i32, 2**31 - 1), (i32 + 1, 10)]:
        assert tds.fits_device_graph(nodes, edges) == \
            jds.fits_device_graph(nodes, edges)
    # int64 offsets: past 2^32-1 edges the port still fits, where the JAX
    # layout (uint32 offsets) refuses (ROADMAP.md section C)
    assert tds.fits_device_graph(1000, 2**32)
    assert not jds.fits_device_graph(1000, 2**32)


def test_unported_options_raise(tiny_dataset):
    """dedup=True and the nbr_cap table are ported
    (tests/test_torch_device_sampler_dedup.py); what the JAX module refuses
    the port refuses too: a table of fewer than one slot per node."""
    with pytest.raises(ValueError, match="nbr_cap must be >= 1"):
        tds.to_device_graph(tiny_dataset.graph, "cpu", nbr_cap=0)
    with pytest.raises(ValueError, match="nbr_cap must be >= 1"):
        jds.to_device_graph(tiny_dataset.graph, nbr_cap=0)
    tg = tds.to_device_graph(tiny_dataset.graph, "cpu")
    blocks, _, num = tds.sample_blocks_device(
        tg, torch.arange(4, dtype=torch.int32), [2], 4, torch.Generator(),
        dedup=True)
    assert blocks[0].adj is not None and int(num) >= 4
