"""The capacity-pressure path of coala_gnn_tpu_torch's ResidentTrainer
against the JAX package's: set-associative tier, priority admission,
staged fused windows (serial and overlapped), the flat prefill schedule,
the replay net and the per-step path, on the same converted params, seed
grids, graph and host tier.

With fanout = max in-degree the sampler takes every in-edge in order, so
neither trainer depends on its random draws and both sample the same
frontiers; dropout is 0. Tolerances are tests/test_torch_resident.py's:
losses rtol 2e-3 / atol 2e-4 (Adam amplifies rounding differences of the
matmuls). Hit and miss counts and the final cache state are exact: the
same frontiers give the same probe misses, stages and inserts.

The first test needs no JAX run: with fanout below the max in-degree and
dropout 0.5, the probe must see exactly the ids the window then reads."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.cache.host_tier import HostFeatureStore
from coala_gnn_tpu.graph.datasets import synthetic_graph
from coala_gnn_tpu.models import make_model as jax_make_model
from coala_gnn_tpu.models.layers import DeviceBlock as JBlock
from coala_gnn_tpu.parallel import resident as jres
from coala_gnn_tpu.sampling.neighbor import block_capacities
from coala_gnn_tpu_torch.cache import feature_cache as tfc
from coala_gnn_tpu_torch.models.gnn import make_model
from coala_gnn_tpu_torch.parallel import resident as tres
from coala_gnn_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

B, K, M, LR, DIM = 16, 3, 3, 1e-2, 8
LOSS_TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def setup():
    ds = synthetic_graph(num_nodes=600, avg_degree=4, feature_dim=DIM,
                         num_classes=4, seed=5)
    max_deg = int(ds.graph.in_degrees().max())
    fanouts = [max_deg, max_deg]
    jm = jax_make_model("sage", hidden=8, num_classes=4, num_layers=2,
                        dropout=0.0)
    caps = block_capacities(B, fanouts)
    blocks0 = [JBlock(adj=None, mask=jnp.ones((caps[l][0], fanouts[l])))
               for l in range(2)]
    params0 = jm.init(jax.random.key(0), blocks0,
                      jnp.zeros((caps[0][1], DIM), jnp.float32))
    rng = np.random.default_rng(3)
    grids = np.stack([np.stack([rng.choice(ds.train_idx, B, replace=False)
                                for _ in range(K)])
                      for _ in range(M)]).astype(np.int32)
    return ds, fanouts, jm, params0, grids


def _kw(num_sets, colors, quantize=False):
    return dict(num_sets=num_sets, ways=jfc.WAYS, dim=DIM,
                cache_dim=jfc.round_cache_dim(DIM),
                num_colors=0 if colors is None else int(colors.max()),
                quantize=quantize)


def _jax(ds, fanouts, jm, num_sets=8, colors=None, quantize=False, **kw):
    return jres.ResidentTrainer(
        graph=ds.graph, host_fetch=HostFeatureStore(ds.features).fetch,
        labels=ds.labels,
        cache_cfg=jfc.CacheConfig(**_kw(num_sets, colors, quantize)),
        model=jm, tx=optax.adam(LR), fanouts=fanouts, batch_size=B,
        colors=colors, **kw)


def _torch(ds, fanouts, params0, num_sets=8, native=True, dropout=0.0,
           colors=None, quantize=False, **kw):
    model = make_model("sage", DIM, 8, 4, 2, dropout=dropout)
    if params0 is not None:
        model.load_state_dict(params_from_flax(jax.device_get(params0)))
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    store = HostFeatureStore(ds.features, use_native=native)
    return tres.ResidentTrainer(
        graph=ds.graph, host_fetch=store.fetch, labels=ds.labels,
        cache_cfg=tfc.CacheConfig(**_kw(num_sets, colors, quantize)),
        model=model,
        optimizer=opt, fanouts=fanouts, batch_size=B, device="cpu",
        colors=colors, **kw)


def _same_cache(tt, jt):
    S = tt.cache_cfg.num_sets
    tb, jb = tt.cache.base, jt.cache.base
    np.testing.assert_array_equal(tb.tags[:S].numpy(), np.asarray(jb.tags))
    np.testing.assert_array_equal(tb.rr.numpy(), np.asarray(jb.rr))
    np.testing.assert_array_equal(tb.data[:S].numpy(), np.asarray(jb.data))
    assert (tb.scales is None) == (jb.scales is None)
    if jb.scales is not None:
        # JAX's jitted insert computes absmax * (1/127), the port (and JAX
        # op by op) absmax / 127: one ulp apart on some lines
        np.testing.assert_allclose(tb.scales[:S].numpy(),
                                   np.asarray(jb.scales), rtol=2**-23,
                                   atol=0)
    assert (tt.cache.line_prio is None) == (jt.cache.line_prio is None)
    if jt.cache.line_prio is not None:
        np.testing.assert_array_equal(tt.cache.line_prio[:S].numpy(),
                                      np.asarray(jt.cache.line_prio))


# ---- 0. the random streams -------------------------------------------------

def test_probe_sees_the_ids_the_window_reads():
    """fanout [5, 4] below the max in-degree and dropout 0.5: per step, the
    presample probe's miss ids equal the window's non-hit ids, in every
    window of the serial staged schedule (each probe runs against the
    cache state its window reads)."""
    ds = synthetic_graph(num_nodes=600, avg_degree=8, feature_dim=DIM,
                         num_classes=4, seed=5)
    fanouts = [5, 4]
    assert int(ds.graph.in_degrees().max()) > max(fanouts)
    tt = _torch(ds, fanouts, None, dropout=0.5, priorities="degree")
    tt.prewarm(np.arange(0, 600, 3, dtype=np.int32))
    kk = 4
    rng = np.random.default_rng(1)
    grids = np.stack([np.stack([rng.choice(ds.train_idx, B, replace=False)
                                for _ in range(kk)])
                      for _ in range(M)]).astype(np.int32)
    probed, read = [], []
    probe_window, eng_lookup = tt._probe_window, tt._eng_lookup

    def spy_probe(seeds_grid, seed, window):
        flat = tt.presample(seeds_grid, seed, window).numpy()
        probed.append([set(r[r >= 0].tolist())
                       for r in flat.reshape(kk, -1)])
        return probe_window(seeds_grid, seed, window)

    def spy_lookup(ids, valid, count_stats=True):
        feats, hit = eng_lookup(ids, valid, count_stats)
        if not count_stats:                    # the window's lookups
            read.append(set(ids[valid & ~hit].tolist()))
        return feats, hit

    tt._probe_window, tt._eng_lookup = spy_probe, spy_lookup
    tt.train_windows(grids, seed=11)
    assert len(probed) == M and len(read) == M * kk
    for w in range(M):
        for k in range(kk):
            assert probed[w][k] == read[w * kk + k], (w, k)
    assert sum(map(len, read)) > 0
    assert "replay" not in tt.timers.totals


# ---- host helpers -----------------------------------------------------------

@pytest.mark.parametrize("transport", ["float32", "bfloat16", "int8"])
def test_encode_stage_rows_matches_jax(transport):
    rows = (np.random.default_rng(0).standard_normal((50, 24)) *
            np.linspace(1e-3, 300, 50)[:, None]).astype(np.float32)
    rows[7] = 0.0
    t_enc, t_scale = tres.encode_stage_rows(rows, transport)
    j_enc, j_scale = jres.encode_stage_rows(rows, transport)
    j_enc = np.asarray(j_enc)
    if transport == "bfloat16":
        assert t_enc.dtype == np.uint16
        j_enc = j_enc.view(np.uint16)
    np.testing.assert_array_equal(t_enc, j_enc)
    assert (t_scale is None) == (j_scale is None)
    if j_scale is not None:
        np.testing.assert_array_equal(t_scale, j_scale)
    with pytest.raises(ValueError):
        tres.encode_stage_rows(rows, "float16")


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000, 8192, 8193, 20000, 40960])
def test_stage_cap_matches_jax(n):
    assert tres.stage_cap(n) == jres.stage_cap(n)
    assert tres._pow2(n) == jres._pow2(n)


def test_merge_evicted_patch_matches_jax():
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((100, 4)).astype(np.float32)

    def fetch(ids):
        return feats[ids]

    for _ in range(5):
        mids = np.unique(rng.integers(0, 100, 30)).astype(np.int32)
        ev = rng.integers(-1, 100, 25).astype(np.int32)
        t = tres.merge_evicted_patch(mids, feats[mids], ev, fetch)
        j = jres.merge_evicted_patch(mids, feats[mids], ev, fetch)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
        assert not t[2].all()                 # patch rows are not offered


def test_host_scratch_rotates_and_grows():
    pool = tres.HostScratch(pin_memory=False)
    a = pool.get("x", (4, 2), torch.float32)
    b = pool.get("x", (4, 2), torch.float32)
    assert a.data_ptr() != b.data_ptr()
    assert pool.get("x", (3, 2), torch.float32).data_ptr() == a.data_ptr()
    big = pool.get("x", (9, 2), torch.float32)      # outgrows buffer 1
    assert big.shape == (9, 2) and big.data_ptr() != b.data_ptr()
    up = pool.upload(big, torch.device("cpu"))
    assert up.data_ptr() != big.data_ptr()          # a copy, not an alias


# ---- whole runs against JAX --------------------------------------------------

STAGED = {
    "serial_f32_fused": dict(),
    "serial_f32_gather": dict(native=False),
    "serial_bf16": dict(stage_transport="bfloat16"),
    "serial_int8": dict(stage_transport="int8"),
    "overlap_f32": dict(stage_overlap=True),
    "serial_degree_prio": dict(priorities="degree"),
    "serial_no_admit": dict(stage_admit=False),
    "overlap_int8_degree_prio": dict(priorities="degree",
                                     stage_transport="int8",
                                     stage_overlap=True),
}


@pytest.mark.parametrize("name", sorted(STAGED))
def test_staged_run_matches_jax(setup, name):
    ds, fanouts, jm, params0, grids = setup
    kw = dict(STAGED[name])
    native = kw.pop("native", True)
    jt = _jax(ds, fanouts, jm, direct=False, **kw)
    tt = _torch(ds, fanouts, params0, native=native, **kw)
    assert not tt.direct and tt.cache_cfg.capacity < ds.graph.num_nodes
    assert (tt._store is not None) == native
    for t in (jt, tt):
        t.prewarm(np.arange(t.cache_cfg.capacity, dtype=np.int32))
    _same_cache(tt, jt)
    _, _, jlosses, jedges = jt.train_windows(params0, jt.tx.init(params0),
                                             grids, jax.random.key(5))
    tlosses, tedges = tt.train_windows(grids, seed=5)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               **LOSS_TOL)
    np.testing.assert_array_equal(tedges.numpy(), np.asarray(jedges))
    ts, js = tt.stats(), jt.stats()
    assert ts == js and ts["misses"] > 0 and ts["hits"] > 0
    _same_cache(tt, jt)
    for t in (jt, tt):
        assert "replay" not in t.timers.totals
        assert t.timers.tallies["stage_rows"] > 0


@pytest.mark.parametrize("overlap", [False, True], ids=["serial",
                                                       "overlap"])
def test_int8_lines_staged_run_matches_jax(setup, overlap):
    """int8 lines on the set-associative tier (quantize=True, so the stage
    transport "auto" is int8), degree priorities: the staged overlay
    dequantises stage rows to cfg.dtype and the lookup dequantises cache
    lines, in JAX's order; losses, counters and the int8 cache agree."""
    ds, fanouts, jm, params0, grids = setup
    kw = dict(priorities="degree", stage_overlap=overlap, quantize=True)
    jt = _jax(ds, fanouts, jm, direct=False, **kw)
    tt = _torch(ds, fanouts, params0, **kw)
    assert tt.stage_transport == jt.stage_transport == "int8"
    assert tt.cache.base.data.dtype == torch.int8
    for t in (jt, tt):
        t.prewarm(np.arange(t.cache_cfg.capacity, dtype=np.int32))
    _same_cache(tt, jt)
    _, _, jlosses, _ = jt.train_windows(params0, jt.tx.init(params0), grids,
                                        jax.random.key(6))
    tlosses, _ = tt.train_windows(grids, seed=6)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               **LOSS_TOL)
    ts, js = tt.stats(), jt.stats()
    assert ts == js and ts["misses"] > 0 and ts["hits"] > 0
    _same_cache(tt, jt)
    for t in (jt, tt):
        assert "replay" not in t.timers.totals


def test_overlap_losses_equal_serial(setup):
    """The overlapped schedule stages a superset (probe before the insert,
    evicted rows patched in) and so trains exactly like the serial one."""
    ds, fanouts, _, params0, grids = setup
    out = []
    for overlap in (False, True):
        tt = _torch(ds, fanouts, params0, stage_overlap=overlap,
                    priorities="degree")
        tt.prewarm(np.arange(tt.cache_cfg.capacity, dtype=np.int32))
        losses, _ = tt.train_windows(grids, seed=5)
        assert tt.stats()["misses"] > 0
        assert "replay" not in tt.timers.totals
        out.append(losses.numpy())
    np.testing.assert_array_equal(out[0], out[1])


def test_flat_prefill_matches_jax(setup):
    """Flat tier under partial coverage: probe misses are inserted before
    each window, so the window only hits (misses stay 0, as in JAX)."""
    ds, fanouts, jm, params0, grids = setup
    jt = _jax(ds, fanouts, jm, num_sets=32)
    tt = _torch(ds, fanouts, params0, num_sets=32)
    warm = np.arange(0, ds.graph.num_nodes, 4, dtype=np.int32)
    for t in (jt, tt):
        assert t.direct
        t.prewarm(warm)
        assert not t.full_coverage
    _, _, jlosses, _ = jt.train_windows(params0, jt.tx.init(params0), grids,
                                        jax.random.key(2))
    tlosses, _ = tt.train_windows(grids, seed=2)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               **LOSS_TOL)
    ts, js = tt.stats(), jt.stats()
    assert ts == js and ts["misses"] == 0 and ts["hits"] > 0
    n = ds.graph.num_nodes
    np.testing.assert_array_equal(tt.cache.admitted.numpy(),
                                  np.asarray(jt.cache.admitted))
    np.testing.assert_array_equal(tt.cache.data[:n].numpy(),
                                  np.asarray(jt.cache.data)[:n])
    assert tt.timers.totals["host_gather"] > 0


def test_replay_net_matches_jax(setup):
    """full_coverage forced on a cold set-associative cache: every window
    misses, both trainers discard it and replay it step by step with
    exact features, and a second pass over the same seeds then hits."""
    ds, fanouts, jm, params0, grids = setup
    jt = _jax(ds, fanouts, jm, num_sets=32, direct=False)
    tt = _torch(ds, fanouts, params0, num_sets=32, direct=False)
    for t in (jt, tt):
        t.full_coverage = True
    jp, jo, jlosses, _ = jt.train_windows(params0, jt.tx.init(params0),
                                          grids, jax.random.key(3))
    tlosses, _ = tt.train_windows(grids, seed=3)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               **LOSS_TOL)
    ts, js = tt.stats(), jt.stats()
    assert ts == js and ts["misses"] > 0
    for t in (jt, tt):
        assert "replay" in t.timers.totals
    _same_cache(tt, jt)
    _, _, jlosses, _ = jt.train_windows(jp, jo, grids, jax.random.key(4))
    tlosses, _ = tt.train_windows(grids, seed=4)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               **LOSS_TOL)
    ts = tt.stats()
    assert ts == jt.stats() and ts["hit_ratio"] > 0.9


def test_degree_priorities_resist_scans(setup):
    """priorities="degree": prewarmed hub lines stay resident through
    windows full of cold rows; the final cache equals JAX's."""
    ds, fanouts, jm, params0, grids = setup
    jt = _jax(ds, fanouts, jm, direct=False, priorities="degree")
    tt = _torch(ds, fanouts, params0, priorities="degree")
    deg = np.diff(ds.graph.indptr)
    cap = tt.cache_cfg.capacity
    hubs = np.argpartition(deg, -cap)[-cap:].astype(np.int32)
    for t in (jt, tt):
        t.prewarm(hubs)
    _same_cache(tt, jt)

    def resident():
        return int(tfc.probe(tt.cache_cfg, tt.cache.base,
                             torch.from_numpy(hubs),
                             torch.ones(cap, dtype=torch.bool)).sum())

    before = resident()
    jt.train_windows(params0, jt.tx.init(params0), grids, jax.random.key(1))
    tt.train_windows(grids, seed=1)
    assert resident() >= before > 0
    _same_cache(tt, jt)


def test_per_step_set_associative_matches_jax(setup):
    """begin / resolve on a cold set-associative cache with priorities and
    colors: features are exact, counters, color counts and cache state
    equal JAX's each step; eval_step agrees."""
    ds, fanouts, jm, params0, grids = setup
    colors = np.random.default_rng(4).integers(0, 5, ds.graph.num_nodes)
    jt = _jax(ds, fanouts, jm, direct=False, priorities="degree",
              colors=colors)
    tt = _torch(ds, fanouts, params0, priorities="degree", colors=colors)
    for step, seeds in enumerate(grids.reshape(-1, B)[:4]):
        jr = jt.resolve(jt.begin(seeds, jax.random.key(step)))
        h = tt.begin(seeds, torch.Generator().manual_seed(step))
        ids, valid = h[1].numpy(), h[2].numpy()
        blocks, feats, y = tt.resolve(h)
        np.testing.assert_array_equal(feats.numpy()[valid],
                                      ds.features[ids[valid]])
        np.testing.assert_array_equal(feats.numpy(), np.asarray(jr[1]))
        np.testing.assert_array_equal(y.numpy(), ds.labels[seeds])
        assert tt.stats() == jt.stats()
        _same_cache(tt, jt)
        np.testing.assert_array_equal(
            tt.cache.base.color_counts.numpy(),
            np.asarray(jt.cache.base.color_counts))
        assert tt.eval_step((blocks, feats, y)) == jt.eval_step(params0, jr)
