"""coala_gnn_tpu_torch/sampling/device_sampler.py against
coala_gnn_tpu/sampling/device_sampler.py: ``dedup=True`` sampling and the
``nbr_cap`` padded neighbour table, mirroring the twelve tests of
tests/test_device_sampler.py.

The two frameworks draw other random numbers from a seed, so the port is
fed JAX's own uniforms, replayed from the key (``jax_uniforms``: one
``key, sub = split(key)`` per layer, output-most layer first). Given them,
ids, counts, masks, adj and relation ids are bitwise equal; the tables are
built on the host by both and compared bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coala_gnn_tpu.graph.datasets import synthetic_graph as jax_synthetic
from coala_gnn_tpu.models import make_model as jax_make_model
from coala_gnn_tpu.sampling import device_sampler as jds
from coala_gnn_tpu.sampling.neighbor import block_capacities
from coala_gnn_tpu_torch.cache.feature_cache import assert_ids_fit_int32
from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
from coala_gnn_tpu_torch.models.gnn import make_model
from coala_gnn_tpu_torch.sampling import device_sampler as tds
from coala_gnn_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)


def jax_uniforms(key, batch_size, fanouts):
    """JAX's draws as torch tensors, indexed by layer (input-most first)."""
    caps = block_capacities(batch_size, fanouts)
    out = [None] * len(fanouts)
    for layer in range(len(fanouts) - 1, -1, -1):
        key, sub = jax.random.split(key)
        out[layer] = torch.from_numpy(np.array(
            jax.random.uniform(sub, (caps[layer][0], fanouts[layer]))))
    return out


def both(graph, seeds, fanouts, B, key, dedup, nbr_cap=None, nbr_seed=0):
    """(JAX's (blocks, ids, num), jitted as its trainers run it, the
    port's) on the same uniforms."""
    jg = jds.to_device_graph(graph, nbr_cap=nbr_cap, nbr_seed=nbr_seed)
    j = jax.jit(lambda s, k: jds.sample_blocks_device(
        jg, s, fanouts, B, k, dedup=dedup))(jnp.asarray(seeds), key)
    t = tds.sample_blocks_device(
        tds.to_device_graph(graph, "cpu", nbr_cap=nbr_cap,
                            nbr_seed=nbr_seed),
        torch.from_numpy(seeds), fanouts, B, dedup=dedup,
        uniforms=jax_uniforms(key, B, fanouts))
    return j, t


def assert_same(j, t, rel=False):
    (jb, jids, jnum), (tb, tids, tnum) = j, t
    assert tids.dtype == torch.int32 and tnum.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    assert int(tnum) == int(jnum)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(a.mask))
        assert (a.adj is None) == (b.adj is None)
        if a.adj is not None:
            assert b.adj.dtype == torch.int32
            np.testing.assert_array_equal(b.adj.numpy(), np.asarray(a.adj))
        if rel:
            np.testing.assert_array_equal(b.rel.numpy(), np.asarray(a.rel))


@pytest.mark.parametrize("cat", [
    [7, 3, 7, 9, 3, 5, 9, 7],
    np.random.default_rng(0).integers(0, 40, 500).tolist(),
    np.random.default_rng(1).integers(0, 101, 300).tolist()])
def test_dedup_first_occurrence(cat):
    """uniq, local and num bitwise JAX's (the last case holds the
    sentinel 100 at random places)."""
    c = np.asarray(cat, np.int32)
    want = jds._dedup_first_occurrence(jnp.asarray(c), 100)
    got = tds._dedup_first_occurrence(torch.from_numpy(c), 100)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if len(cat) == 8:
        assert int(got[2]) == 4
        np.testing.assert_array_equal(got[0][:4].numpy(), [7, 3, 9, 5])
        np.testing.assert_array_equal(got[1].numpy(),
                                      [0, 1, 0, 2, 1, 3, 2, 0])


def test_dedup_sentinel_forced_last():
    c = np.array([5, 100, 2, 100, 5], np.int32)
    uniq, local, num = tds._dedup_first_occurrence(torch.from_numpy(c), 100)
    assert int(num) == 2
    np.testing.assert_array_equal(uniq[:3].numpy(), [5, 2, 100])
    assert int(local[1]) == 2
    want = jds._dedup_first_occurrence(jnp.asarray(c), 100)
    for g, w in zip((uniq, local, num), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fanouts", [[5, 3], [2, 2, 2], [10, 5]])
def test_device_blocks_match_contract(small_dataset, fanouts):
    """dedup=True blocks, ids and num bitwise JAX's given its uniforms,
    with the block contract: a unique valid prefix of real ids, adj
    within the source array."""
    g = small_dataset.graph
    B = 32
    seeds = small_dataset.train_idx[:B].astype(np.int32)
    j, t = both(g, seeds, fanouts, B, jax.random.key(0), dedup=True)
    assert_same(j, t)
    blocks, ids, num = t
    caps = block_capacities(B, fanouts)
    for l, b in enumerate(blocks):
        assert tuple(b.adj.shape) == (caps[l][0], fanouts[l])
    assert ids.shape == (caps[0][1],)
    n = int(num)
    assert np.unique(ids[:n].numpy()).size == n
    assert (ids[:n] < g.num_nodes).all()
    assert int(blocks[0].adj.max()) < caps[0][1]


def test_device_sampler_neighbors_are_real(small_dataset):
    """One layer, dedup=True: the dst prefix is the seeds and every live
    slot decodes through the ids to a true in-neighbour, min(deg, fanout)
    of them per dst."""
    g = small_dataset.graph
    B, fanout = 16, 4
    seeds = small_dataset.train_idx[:B].astype(np.int32)
    blocks, ids, _ = tds.sample_blocks_device(
        tds.to_device_graph(g, "cpu"), torch.from_numpy(seeds), [fanout], B,
        torch.Generator().manual_seed(1), dedup=True)
    ids, adj, mask = ids.numpy(), blocks[0].adj.numpy(), \
        blocks[0].mask.numpy()
    np.testing.assert_array_equal(ids[:B], seeds)
    indptr, indices = np.asarray(g.indptr), np.asarray(g.indices)
    for i in range(B):
        nbrs = set(indices[indptr[seeds[i]]:indptr[seeds[i] + 1]].tolist())
        live = mask[i] > 0
        assert all(ids[adj[i, k]] in nbrs for k in np.flatnonzero(live))
        assert live.sum() == min(int(indptr[seeds[i] + 1]
                                     - indptr[seeds[i]]), fanout)


def test_device_sampler_trains(small_dataset):
    """dedup=True blocks feed SAGE (layer sums over adj, the kernel's
    plain version here) and training on them matches JAX's on the same
    draws and params step by step (1e-5), and learns."""
    import optax

    ds = small_dataset
    B, fanouts, lr = 64, [5, 5], 1e-2
    jg, tg = jds.to_device_graph(ds.graph), tds.to_device_graph(ds.graph,
                                                                "cpu")
    feats = jnp.asarray(ds.features)
    jm = jax_make_model("sage", hidden=32, num_classes=ds.num_classes,
                        num_layers=2, dropout=0.0)
    tx = optax.adam(lr)
    caps = block_capacities(B, fanouts)
    params = jm.init(jax.random.key(0), [
        jds.DeviceBlock(adj=jnp.zeros((caps[l][0], fanouts[l]), jnp.int32),
                        mask=jnp.ones((caps[l][0], fanouts[l])))
        for l in range(2)], jnp.zeros((caps[0][1], ds.feature_dim)))
    opt = tx.init(params)
    tm = make_model("sage", ds.feature_dim, 32, ds.num_classes, 2,
                    dropout=0.0)
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    topt = torch.optim.Adam(tm.parameters(), lr=lr)
    tfeats = torch.from_numpy(ds.features)
    tlabels = torch.from_numpy(ds.labels.astype(np.int64))

    @jax.jit
    def step(params, opt, seeds, key):
        blocks, ids, _ = jds.sample_blocks_device(jg, seeds, fanouts, B, key)
        x = feats[jnp.clip(ids, 0, feats.shape[0] - 1)]

        def loss_fn(p):
            lg = jm.apply(p, blocks, x)[:B]
            return optax.softmax_cross_entropy_with_integer_labels(
                lg, jnp.asarray(ds.labels)[seeds]).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss

    rng = np.random.default_rng(0)
    jl, tl = [], []
    for i in range(5):
        seeds = rng.choice(ds.train_idx, B, replace=False).astype(np.int32)
        key = jax.random.key(i + 1)
        params, opt, loss = step(params, opt, jnp.asarray(seeds), key)
        jl.append(float(loss))
        blocks, ids, _ = tds.sample_blocks_device(
            tg, torch.from_numpy(seeds), fanouts, B, dedup=True,
            uniforms=jax_uniforms(key, B, fanouts))
        x = tfeats[ids.clamp(max=ds.graph.num_nodes - 1).long()]
        loss = torch.nn.functional.cross_entropy(
            tm(blocks, x)[:B], tlabels[torch.from_numpy(seeds).long()])
        topt.zero_grad()
        loss.backward()
        topt.step()
        tl.append(loss.item())
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    assert np.isfinite(tl).all() and tl[-1] < tl[0]


def test_wide_offset_layout_matches_int32(small_dataset):
    """The port's int64 offsets against both JAX layouts (int32 and the
    forced uint32 one), in both dedup modes."""
    g = small_dataset.graph
    seeds = small_dataset.train_idx[:32].astype(np.int32)
    key = jax.random.key(11)
    wide = jds.to_device_graph(g, force_wide_offsets=True)
    assert wide.indptr.dtype == jnp.uint32
    assert tds.to_device_graph(g, "cpu").indptr.dtype == torch.int64
    for dedup in (False, True):
        j, t = both(g, seeds, [3, 2], 32, key, dedup)
        assert_same(j, t)
        jw = jax.jit(lambda s, k: jds.sample_blocks_device(
            wide, s, [3, 2], 32, k, dedup=dedup))(jnp.asarray(seeds), key)
        assert_same(jw, t)


def test_padded_table_bit_parity(small_dataset):
    """nbr_cap >= max degree: the table and degrees are JAX's bitwise, and
    sampling equals the CSR layout's (and JAX's) in both dedup modes."""
    g = small_dataset.graph
    maxdeg = int(g.in_degrees().max())
    P = 1 << (maxdeg - 1).bit_length()
    tg = tds.to_device_graph(g, "cpu", nbr_cap=P)
    jg = jds.to_device_graph(g, nbr_cap=P)
    assert tuple(tg.nbr_table.shape) == (g.num_nodes + 1, P)
    np.testing.assert_array_equal(tg.nbr_table.numpy(),
                                  np.asarray(jg.nbr_table))
    np.testing.assert_array_equal(tg.nbr_deg.numpy(),
                                  np.asarray(jg.nbr_deg))
    np.testing.assert_array_equal(tg.nbr_deg[:-1].numpy(),
                                  g.in_degrees().astype(np.int32))
    seeds = small_dataset.train_idx[:32].astype(np.int32)
    key = jax.random.key(11)
    for dedup in (False, True):
        j, t = both(g, seeds, [3, 2], 32, key, dedup, nbr_cap=P)
        assert_same(j, t)
        _, c = both(g, seeds, [3, 2], 32, key, dedup)
        assert_same(t, c)


def test_padded_table_hetero_rel_parity():
    """A typed graph: the relation table bitwise JAX's, and the table's
    relation ids equal the CSR gather's (and JAX's) with truncation on."""
    ds = jax_synthetic(num_nodes=600, avg_degree=6, feature_dim=8,
                       num_classes=4, seed=3)
    ds.graph.edge_types = np.random.default_rng(4).integers(
        0, 3, ds.graph.num_edges).astype(np.int32)
    ds.graph.num_edge_types = 3
    g = ds.graph
    maxdeg = int(g.in_degrees().max())
    seeds = ds.train_idx[:16].astype(np.int32)
    key = jax.random.key(5)
    for P, nbr_seed in ((1 << (maxdeg - 1).bit_length(), 0), (4, 2)):
        tg = tds.to_device_graph(g, "cpu", nbr_cap=P, nbr_seed=nbr_seed)
        jg = jds.to_device_graph(g, nbr_cap=P, nbr_seed=nbr_seed)
        for name in ("nbr_table", "nbr_deg", "rel_table"):
            np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                          np.asarray(getattr(jg, name)))
        for dedup in (False, True):
            j, t = both(g, seeds, [4, 3], 16, key, dedup, nbr_cap=P,
                        nbr_seed=nbr_seed)
            assert_same(j, t, rel=True)
    _, c = both(g, seeds, [4, 3], 16, key, False)
    j, t = both(g, seeds, [4, 3], 16, key, False, nbr_cap=32)
    assert_same(c, t, rel=True)


def test_padded_table_truncation_subset(small_dataset):
    """deg > nbr_cap: the stored row is a P-subset of the edge positions
    without replacement (JAX's, bitwise, at ``nbr_seed``), and sampling
    returns only stored entries."""
    g = small_dataset.graph
    P, fanout = 4, 3
    tg = tds.to_device_graph(g, "cpu", nbr_cap=P, nbr_seed=3)
    jg = jds.to_device_graph(g, nbr_cap=P, nbr_seed=3)
    np.testing.assert_array_equal(tg.nbr_table.numpy(),
                                  np.asarray(jg.nbr_table))
    deg = g.in_degrees()
    dsts = np.argsort(deg)[-8:]
    assert (deg[dsts] > P).all()
    tbl = tg.nbr_table.numpy()
    np.testing.assert_array_equal(tg.nbr_deg.numpy()[dsts], P)
    indptr, indices = np.asarray(g.indptr), np.asarray(g.indices)
    for v in dsts:
        nbrs = indices[indptr[v]:indptr[v + 1]]
        assert set(tbl[v].tolist()) <= set(nbrs.tolist())
        assert all((tbl[v] == x).sum() <= (nbrs == x).sum()
                   for x in set(tbl[v].tolist()))
    key = jax.random.key(0)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (8, fanout))))
    nbr, mask, _ = tds._sample_layer(tg, torch.from_numpy(
        dsts.astype(np.int32)), fanout, uniforms=u)
    jnbr, jmask, _ = jds._sample_layer(jg, jnp.asarray(dsts.astype(
        np.int32)), fanout, key)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(jnbr))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert (mask == 1.0).all()
    for i, v in enumerate(dsts):
        assert set(nbr[i].tolist()) <= set(tbl[v].tolist())
    with pytest.raises(ValueError):
        tds.to_device_graph(g, "cpu", nbr_cap=0)


def test_fits_device_graph_gate():
    """Node ids are the port's only limit (int64 offsets): papers100M
    symmetrised fits, and so does a graph past 2^32 edges, where JAX's
    uint32 offsets refuse it; 2^31 nodes do not fit either."""
    assert tds.fits_device_graph(111_000_000, 3_200_000_000)
    assert tds.fits_device_graph(111_000_000, 2**32)
    assert not jds.fits_device_graph(111_000_000, 2**32)
    assert not tds.fits_device_graph(2**31, 1000)
    assert not jds.fits_device_graph(2**31, 1000)


def test_node_id_overflow_refused():
    assert_ids_fit_int32(2**31 - 1)
    with pytest.raises(ValueError):
        assert_ids_fit_int32(2**31)


def test_sampling_estimators_unbiased_across_engines():
    """The port's device sampler draws with replacement, from the CSR
    arrays and from the padded table alike; both are unbiased estimators
    of the true neighbourhood mean (the port's native host sampler, which
    draws without replacement, too)."""
    from coala_gnn_tpu_torch.native import lib as native_lib

    ds = synthetic_graph(num_nodes=2000, avg_degree=10, feature_dim=32,
                         num_classes=8, seed=7)
    g = ds.graph
    deg = g.in_degrees()
    dsts = np.argsort(deg)[-8:].astype(np.int64)
    fanout, R = 3, 1500
    assert (deg[dsts] > fanout).all()
    indptr, indices = np.asarray(g.indptr), np.asarray(g.indices)
    true_mean = np.stack([ds.features[indices[indptr[v]:indptr[v + 1]]]
                          .mean(axis=0) for v in dsts])
    lib = native_lib.get()
    acc = np.zeros_like(true_mean)
    for r in range(R):
        nbr, _ = native_lib.sample_layer(lib, g, dsts, fanout, seed=r)
        acc += ds.features[nbr].mean(axis=1)
    assert np.abs(acc / R - true_mean).max() < 0.12
    dst = torch.from_numpy(dsts.astype(np.int32))
    for graph in (tds.to_device_graph(g, "cpu"),
                  tds.to_device_graph(g, "cpu", nbr_cap=64)):
        gen = torch.Generator().manual_seed(7)
        nbr = torch.stack([tds._sample_layer(graph, dst, fanout, gen)[0]
                           for _ in range(R)]).numpy()
        est = ds.features[nbr].mean(axis=2).mean(axis=0)
        assert np.abs(est - true_mean).max() < 0.12
