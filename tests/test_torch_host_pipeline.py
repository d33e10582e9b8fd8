"""The host pipeline as a whole: the port's train steps
(``parallel/train.py``), its ``run_host`` (``parallel/host_pipeline.py``)
and its CLI (``python -m coala_gnn_tpu_torch.train``).

- The steps start from the JAX model's params converted by
  ``utils/convert.py``, with dropout 0, on the same sampled batches; losses
  and params agree with the JAX steps' within 1e-5 over 8 steps (rtol =
  atol: both sum the same f32 products, the JAX side fused by XLA). The
  CLI's steps also run a bf16 model (``--dtype bfloat16``) on bf16 rows and
  on int8 rows served as bf16 (``--quantize``), held at
  tests/test_torch_bf16.py's bf16 tolerance (rtol = atol = 2e-2).
- ``run_host`` against the same loop built from the JAX pieces (bench.py's
  ``run_host`` with dropout 0 and the converted params): losses within
  1e-5 step by step, hit and miss counts and speculative replays equal,
  under full coverage, both wire layouts, capacity pressure and uncached.
- The CLI trains and evaluates on ``--device cpu`` with a falling loss and
  raises ``NotImplementedError`` on every flag not ported.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.cache.host_tier import HostFeatureStore as JaxStore
from coala_gnn_tpu.data.loader import CoalaDataLoader as JaxLoader
from coala_gnn_tpu.data.packing import pack_request as jpack_request
from coala_gnn_tpu.data.packing import \
    pack_request_contig as jpack_request_contig
from coala_gnn_tpu.distribution import DistributionScheduler as JaxScheduler
from coala_gnn_tpu.distribution import SeedDistributor as JaxDistributor
from coala_gnn_tpu.graph.datasets import synthetic_graph as jax_synthetic
from coala_gnn_tpu.models import blocks_to_device as jblocks_to_device
from coala_gnn_tpu.models import make_model as jax_make_model
from coala_gnn_tpu.models.layers import DeviceBlock as JBlock
from coala_gnn_tpu.parallel import train as jtrain
from coala_gnn_tpu.parallel.mesh import DATA_AXIS, make_mesh
from coala_gnn_tpu.parallel.sharded_cache import \
    ShardedFeatureCache as JaxCache
from coala_gnn_tpu.sampling.neighbor import NeighborSampler as JaxSampler
from coala_gnn_tpu_torch import train as cli
from coala_gnn_tpu_torch.data.packing import (batch_layout, pack_batch,
                                              pack_request,
                                              pack_request_contig)
from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
from coala_gnn_tpu_torch.models.gnn import make_model
from coala_gnn_tpu_torch.models.layers import DeviceBlock
from coala_gnn_tpu_torch.parallel import train
from coala_gnn_tpu_torch.parallel.host_pipeline import run_host
from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler
from coala_gnn_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

KW = dict(num_nodes=3000, avg_degree=8, feature_dim=16, num_classes=4,
          seed=11)
B, FANOUTS, HIDDEN, LR, STEPS = 16, [4, 3], 8, 1e-2, 8
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def dss():
    return synthetic_graph(**KW), jax_synthetic(**KW)


@pytest.fixture(scope="module")
def dss_wide():
    kw = dict(KW, feature_dim=160)
    return synthetic_graph(**kw), jax_synthetic(**kw)


def blocks_to_device(blocks, device):
    """Host blocks -> the port's DeviceBlocks (adj None stays None)."""
    return [DeviceBlock(adj=None if b.adj is None else
                        torch.from_numpy(b.adj).to(device),
                        mask=torch.from_numpy(b.mask).to(device))
            for b in blocks]


def _jax_init(kind, batch, x, key=0, dtype=jnp.float32):
    jm = jax_make_model(kind, hidden=HIDDEN, num_classes=KW["num_classes"],
                        num_layers=2, num_heads=2, dropout=0.0, dtype=dtype)
    return jm, jm.init(jax.random.key(key), jblocks_to_device(batch.blocks),
                       jnp.asarray(x))


def _port_model(kind, params, dtype=torch.float32):
    model = make_model(kind, KW["feature_dim"], HIDDEN, KW["num_classes"], 2,
                       num_heads=2, dropout=0.0, dtype=dtype)
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model


def _params_close(model, params, tol=TOL) -> None:
    got = model.state_dict()
    want = params_from_flax(jax.device_get(params))
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k].float().numpy(),
                                   want[k].float().numpy(), **tol, err_msg=k)


def _served_rows(x, rows):
    """The rows the CLI's cache serves its steps, as (JAX array, torch
    tensor) of the same values: "float32" as they are, "bfloat16" rounded
    to bf16 lines, "int8_bf16" int8 lines dequantised to bf16 (a bf16
    config with --quantize)."""
    if rows == "float32":
        return jnp.asarray(x), torch.from_numpy(x)
    jx = (jnp.asarray(x).astype(jnp.bfloat16) if rows == "bfloat16" else
          jfc.dequantize_rows(*jfc.quantize_rows(jnp.asarray(x)),
                              dtype=jnp.bfloat16))
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)


def _batches(ds, contiguous, n=STEPS, seed=3):
    s = NeighborSampler(ds.graph, FANOUTS, B, seed=seed,
                        use_native=False, contiguous=contiguous)
    out = []
    for i in range(n):
        batch = s.sample(ds.train_idx[i * B:(i + 1) * B])
        sent = ds.graph.num_nodes
        x = ds.features[np.minimum(batch.input_ids, sent - 1)]
        out.append((batch, x, ds.labels[batch.seeds].astype(np.int32)))
    return s, out


@pytest.mark.parametrize("form", ["classic", "packed", "request", "contig"])
def test_train_steps_match_jax(dss, form):
    ds = dss[0]
    contiguous = form == "contig"
    s, batches = _batches(ds, contiguous)
    layout = batch_layout(s.caps, FANOUTS)
    n_req, sent = s.caps[0][1], ds.graph.num_nodes
    jm, params = _jax_init("sage", batches[0][0], batches[0][1])
    tx = optax.adam(LR)
    opt_state = tx.init(params)
    model = _port_model("sage", params)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step = {"classic": train.make_train_step(model, opt, B),
            "packed": train.make_packed_train_step(model, opt, B, layout),
            "request": train.make_request_train_step(model, opt, B, layout,
                                                     n_req),
            "contig": train.make_contig_train_step(model, opt, B, layout,
                                                   n_req, sent)}[form]
    jstep = {"classic": jtrain.make_train_step(jm, tx, B),
             "packed": jtrain.make_packed_train_step(jm, tx, B, layout),
             "request": jtrain.make_request_train_step(jm, tx, B, layout,
                                                       n_req),
             "contig": jtrain.make_contig_train_step(jm, tx, B, layout,
                                                     n_req, sent)}[form]
    key = jax.random.key(4)
    for batch, x, labels in batches:
        adjs = [b.adj for b in batch.blocks]
        masks = [b.mask for b in batch.blocks]
        ids = batch.input_ids.astype(np.int32)
        if form == "classic":
            args = (blocks_to_device(batch.blocks, "cpu"),
                    torch.from_numpy(x), torch.from_numpy(labels))
            jargs = (jblocks_to_device(batch.blocks), jnp.asarray(x),
                     jnp.asarray(labels))
        else:
            vec = {"packed": lambda: pack_batch(adjs, masks, labels),
                   "request": lambda: pack_request(ids, batch.num_input,
                                                   adjs, masks, labels),
                   "contig": lambda: pack_request_contig(
                       ids, batch.num_input, labels)}[form]()
            args = (torch.from_numpy(vec), torch.from_numpy(x))
            jargs = (jnp.asarray(vec), jnp.asarray(x))
        loss, acc = step(*args)
        params, opt_state, jloss, jacc = jstep(params, opt_state, key,
                                               *jargs)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
        assert float(acc) == pytest.approx(float(jacc), abs=1e-6)
    _params_close(model, params)


SHARDED = [("sage", True, "float32"), ("sage", False, "float32"),
           ("gcn", True, "float32"), ("gat", False, "float32"),
           # --dtype bfloat16: bf16 lines, and int8 lines with --quantize
           ("sage", True, "bfloat16"), ("sage", False, "int8_bf16"),
           ("gcn", True, "int8_bf16"), ("gat", False, "bfloat16")]


@pytest.mark.parametrize("kind,masked,rows", SHARDED, ids=[
    f"{k}-{m}" + ("" if r == "float32" else f"-{r}") for k, m, r in SHARDED])
def test_sharded_steps_match_jax(dss, kind, masked, rows):
    """The CLI's steps: the data-parallel train step (masked: the last
    batch's tail seeds weigh 0) and the per-slot eval step, with the
    leading device axis, on one device. ``rows``: the cache rows the steps
    are served (``_served_rows``); bf16 rows come with a bf16 model, as
    ``--dtype bfloat16`` builds both, held at ``BF16_TOL`` (the per-slot
    correctness exactly). GAT trains with SGD: the softmax over the slots
    cancels the last layer's attn_r gradient to rounding noise, which Adam
    would turn into lr-sized steps of random sign
    (tests/test_torch_resident.py)."""
    ds = dss[0]
    _, batches = _batches(ds, False)
    bf16 = rows != "float32"
    tol = BF16_TOL if bf16 else TOL
    jm, params = _jax_init(kind, batches[0][0], batches[0][1],
                           dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tx = optax.sgd(LR) if kind == "gat" else optax.adam(LR)
    opt_state = tx.init(params)
    mesh = make_mesh(jax.devices()[:1])
    model = _port_model(kind, params,
                        torch.bfloat16 if bf16 else torch.float32)
    opt = (torch.optim.SGD if kind == "gat" else torch.optim.Adam)(
        model.parameters(), lr=LR)
    step = train.make_sharded_train_step(model, opt, ["cpu"], B,
                                         masked=masked)
    jstep = jtrain.make_sharded_train_step(jm, tx, mesh, B, masked=masked)
    key = jax.random.key(5)
    for i, (batch, x, labels) in enumerate(batches):
        valid = np.ones((1, B), bool)
        if i == STEPS - 1:
            valid[0, B // 2:] = False
        blocks = [b._replace(adj=b.adj[None], mask=b.mask[None])
                  for b in blocks_to_device(batch.blocks, "cpu")]
        jblocks = [b._replace(adj=b.adj[None], mask=b.mask[None])
                   for b in jblocks_to_device(batch.blocks)]
        extra = (torch.from_numpy(valid),) if masked else ()
        jx, tx_rows = _served_rows(x, rows)
        loss, acc = step(blocks, tx_rows[None],
                         torch.from_numpy(labels[None]), *extra)
        params, opt_state, jloss, jacc = jstep(
            params, opt_state, key, jblocks, jx[None],
            jnp.asarray(labels[None]), *((jnp.asarray(valid),) if masked
                                         else ()))
        np.testing.assert_allclose(float(loss), float(jloss), **tol)
        assert float(acc) == pytest.approx(float(jacc), abs=1e-6)
    _params_close(model, params, tol)
    ok = train.make_sharded_eval_step(model, ["cpu"], B, per_slot=True)(
        blocks, tx_rows[None], torch.from_numpy(labels[None]))
    jok = jtrain.make_sharded_eval_step(jm, mesh, B, per_slot=True)(
        params, jblocks, jx[None], jnp.asarray(labels[None]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    correct, n = train.make_eval_step(model, B)(
        blocks_to_device(batch.blocks, "cpu"), tx_rows,
        torch.from_numpy(labels))
    jcorrect, jn = jtrain.make_eval_step(jm, B)(
        params, jblocks_to_device(batch.blocks), jx, jnp.asarray(labels))
    assert (int(correct), n) == (int(jcorrect), int(jn))
    assert int(train.make_sharded_eval_step(model, ["cpu"], B)(
        blocks, tx_rows[None],
        torch.from_numpy(labels[None]))) == int(correct)
    with pytest.raises(ValueError, match="one process per card"):
        train.make_sharded_train_step(model, opt, ["cpu", "cpu"], B)


def _jax_run_host(ds, cache_mb, warmup, steps, contiguous, prewarm, params,
                  bf16=False):
    """bench.py's run_host built from the JAX pieces, with dropout 0 and
    the given params, every step's loss kept; ``bf16``: bf16 cache lines
    (the model stays f32)."""
    dim = ds.feature_dim
    sentinel = ds.graph.num_nodes
    sampler = JaxSampler(ds.graph, FANOUTS, B, seed=0, contiguous=contiguous)
    distributor = JaxDistributor(ds.train_idx, batch_size=B, local_size=1,
                                 num_parts=1, mode="baseline",
                                 shuffle_seed=0)
    loader = JaxLoader(scheduler=JaxScheduler(distributor, part_id=0,
                                              local_rank=0),
                       sampler=sampler, labels=ds.labels, local_size=1,
                       prefetch=2)
    model = jax_make_model("sage", hidden=HIDDEN,
                           num_classes=ds.num_classes, num_layers=2,
                           dropout=0.0)
    tx = optax.adam(1e-3)
    n_req = sampler.caps[0][1]
    layout = batch_layout(sampler.caps, FANOUTS)
    step_fn = (jtrain.make_contig_train_step(model, tx, B, layout, n_req,
                                             sentinel) if contiguous else
               jtrain.make_request_train_step(model, tx, B, layout, n_req))
    store = JaxStore(ds.features)
    cache = None
    if cache_mb > 0:
        cfg = jfc.make_config(cache_mb=cache_mb, dim=dim, num_colors=0,
                              dtype=jnp.bfloat16 if bf16 else jnp.float32)
        cache = JaxCache(cfg=cfg, mesh=make_mesh(jax.devices()[:1]),
                         mode="isolated")
        if prewarm == "arange":
            cache.prewarm(np.arange(min(ds.graph.num_nodes, cfg.capacity),
                                    dtype=np.int32), store.fetch)
        else:
            cache.prewarm_by_degree(ds.graph, store.fetch)
    opt_state = tx.init(params)
    key = jax.random.key(0)
    it = iter(loader)
    pending, group, losses = [], [], []
    state = {"snap": None, "replays": 0, "params": params,
             "opt_state": opt_state}

    def pull():
        try:
            hb = next(it)
        except StopIteration:
            return
        ids = hb.input_ids[0].astype(np.int32)
        if contiguous:
            vec = jpack_request_contig(ids, int(hb.num_input[0]),
                                       hb.labels[0])
        else:
            vec = jpack_request(ids, int(hb.num_input[0]),
                                [a[0] for a in hb.adjs],
                                [m[0] for m in hb.masks], hb.labels[0])
        h = None
        if cache is not None:
            dbuf = jax.device_put(vec[None, :], NamedSharding(
                cache.mesh, P(DATA_AXIS, None)))
            h = cache.fetch_begin_packed(hb.input_ids, hb.num_input, dbuf,
                                         n_req, sentinel=sentinel
                                         if contiguous else 0)
        else:
            dbuf = jnp.asarray(vec[None, :])
        pending.append((hb, dbuf, h))

    def flush_group():
        if group and any(int(np.asarray(h[6])) for h, _, _, _ in group):
            state["replays"] += 1
            state["params"], state["opt_state"] = state["snap"]
            for h, dbuf, k, i in group:
                x = cache.fetch_complete(h, store.fetch)[0]
                state["params"], state["opt_state"], losses[i], _ = step_fn(
                    state["params"], state["opt_state"], k, dbuf, x)
        group.clear()
        state["snap"] = None

    pull()
    for i in range(warmup + steps):
        hb, dbuf, handle = pending.pop(0)
        pull()
        spec = cache is not None and i > 0
        if spec:
            if state["snap"] is None:
                state["snap"] = (state["params"], state["opt_state"])
            x = handle[3][0]
        elif cache is not None:
            x = cache.fetch_complete(handle, store.fetch)[0]
        else:
            x = jnp.asarray(ds.features[np.minimum(hb.input_ids[0],
                                                   sentinel - 1)])
        key, sub = jax.random.split(key)
        state["params"], state["opt_state"], loss, _ = step_fn(
            state["params"], state["opt_state"], sub, dbuf, x)
        losses.append(loss)
        if spec:
            group.append((handle, dbuf, sub, i))
            if len(group) >= 8:
                flush_group()
        if i == warmup - 1:
            flush_group()
            if cache is not None:
                cache.stats()
    flush_group()
    stats = cache.stats() if cache is not None else None
    return [float(l) for l in losses], stats, state["replays"]


@pytest.mark.parametrize("cache_mb,contiguous,prewarm", [
    (4, False, "arange"),       # full coverage, the dedup wire
    (4, True, "arange"),        # full coverage, the slot-major wire
    (1, False, "degree"),       # capacity pressure: misses, fills, replays
    (1, True, "arange"),
    (0, False, None),           # uncached: the host gather every step
])
def test_run_host_matches_jax_loop(dss, cache_mb, contiguous, prewarm):
    ds, jds = dss
    jm = jax_make_model("sage", hidden=HIDDEN, num_classes=ds.num_classes,
                        num_layers=2, dropout=0.0)
    caps = NeighborSampler(ds.graph, FANOUTS, B, use_native=False).caps
    params = jm.init(jax.random.key(1), [
        JBlock(adj=jnp.zeros((cd, f), jnp.int32), mask=jnp.ones((cd, f)))
        for (cd, _), f in zip(caps, FANOUTS)],
        jnp.zeros((caps[0][1], ds.feature_dim), jnp.float32))
    warmup, steps = 3, 12
    got = run_host(ds, B, FANOUTS, ds.feature_dim, HIDDEN, cache_mb, False,
                   warmup, steps, contiguous=contiguous, device="cpu",
                   prewarm=prewarm, dropout=0.0,
                   state_dict=params_from_flax(jax.device_get(params)))
    losses, stats, replays = _jax_run_host(jds, cache_mb, warmup, steps,
                                           contiguous, prewarm, params)
    np.testing.assert_allclose(got["losses"], losses, **TOL)
    assert got["replays"] == replays
    assert (replays > 0) == (cache_mb == 1)   # misses only under pressure
    if cache_mb:
        assert (got["hits"], got["misses"]) == (stats["hits"],
                                                stats["misses"])
        assert got["cache_hit_ratio"] == round(stats["hit_ratio"], 4)
    else:
        assert got["cache_hit_ratio"] is None and got["hits"] is None
    assert got["config"]["layout"] == ("contig" if contiguous else "dedup")
    assert got["value"] > 0 and got["ms_per_step"] > 0
    assert all(v == 0 for v in got["launches_per_step"].values())


def test_run_host_refuses_bf16(dss):
    """``run_host(bf16=True)`` no longer refuses: it runs with bf16 cache
    lines and an f32 model, as bench.py's run_host does (it refused,
    wrongly, until the bf16 model dtype was ported;
    ``test_run_host_bf16_lines_match_jax_loop`` holds it to JAX). An
    uncached run has no lines and reports f32 features."""
    r = run_host(dss[0], B, FANOUTS, 16, HIDDEN, 4, True, 1, 1, device="cpu")
    assert np.isfinite(r["losses"]).all() and len(r["losses"]) == 2
    assert r["config"]["feature_dtype"] == "bfloat16"
    r = run_host(dss[0], B, FANOUTS, 16, HIDDEN, 0, True, 1, 1, device="cpu")
    assert r["config"]["feature_dtype"] == "float32"


@pytest.mark.parametrize("cache_mb,contiguous,prewarm", [
    (4, False, "arange"),       # full coverage, the dedup wire
    (1, False, "degree"),       # under pressure: misses, fills, replays
    (4, True, "arange"),        # full coverage, the slot-major wire
    (1, True, "arange"),
])
def test_run_host_bf16_lines_match_jax_loop(dss_wide, cache_mb, contiguous,
                                            prewarm):
    """``run_host(bf16=True)`` (bf16 lines in the one-device cache front,
    an f32 SAGE, as bench.py's) against the same loop of JAX pieces: the
    bf16 rows are widened exactly, so the losses agree at 1e-5 as in the
    f32 cases; hit and miss counts and replays are equal. The graph's rows
    are 160 wide (256-wide lines), so 1 MB of bf16 lines holds 2,048 of its
    3,000 rows."""
    ds, jds = dss_wide
    jm = jax_make_model("sage", hidden=HIDDEN, num_classes=ds.num_classes,
                        num_layers=2, dropout=0.0)
    caps = NeighborSampler(ds.graph, FANOUTS, B, use_native=False).caps
    params = jm.init(jax.random.key(1), [
        JBlock(adj=jnp.zeros((cd, f), jnp.int32), mask=jnp.ones((cd, f)))
        for (cd, _), f in zip(caps, FANOUTS)],
        jnp.zeros((caps[0][1], ds.feature_dim), jnp.float32))
    warmup, steps = 3, 9
    got = run_host(ds, B, FANOUTS, ds.feature_dim, HIDDEN, cache_mb, True,
                   warmup, steps, contiguous=contiguous, device="cpu",
                   prewarm=prewarm, dropout=0.0,
                   state_dict=params_from_flax(jax.device_get(params)))
    losses, stats, replays = _jax_run_host(jds, cache_mb, warmup, steps,
                                           contiguous, prewarm, params,
                                           bf16=True)
    np.testing.assert_allclose(got["losses"], losses, **TOL)
    assert got["replays"] == replays and (replays > 0) == (cache_mb == 1)
    assert (got["hits"], got["misses"]) == (stats["hits"], stats["misses"])
    assert got["config"]["feature_dtype"] == "bfloat16"


CLI_ARGS = ["--device", "cpu", "--num_nodes", "2000", "--feature_dim", "16",
            "--batch_size", "32", "--fan_out", "4,3", "--hidden_channels",
            "16", "--epochs", "4", "--max_steps", "6", "--learning_rate",
            "0.01", "--eval"]


@pytest.mark.parametrize("extra", [["--cache_size", "1"], ["--mask_tail"],
                                   ["--model_type", "gcn", "--cache_size",
                                    "1", "--quantize"]])
def test_cli_trains_and_evaluates_on_cpu(capsys, extra):
    cli.main(CLI_ARGS + extra)
    out = capsys.readouterr().out
    losses = [float(line.split("| loss ")[1].split()[0])
              for line in out.splitlines() if line.startswith("Epoch")]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert losses[-1] < 0.9 * losses[0], losses
    assert "sampler native: True" in out
    acc = [line for line in out.splitlines() if line.startswith("Test")]
    assert len(acc) == 1 and "(400 nodes)" in acc[0]
    assert ("Cache hit ratio" in out) == ("--cache_size" in extra)


def test_cli_runs_on_the_card_unless_asked_for_the_cpu():
    assert cli.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["--num_nodes", "200"])


@pytest.mark.parametrize("flags,item", [
    (["--data", "ogbn-products"], "Not ported"),
    (["--data", "ogbn-papers100M", "--path", "data"], "Not ported"),
    (["--data", "ogbn-mag", "--dataset_size", "full"], "Not ported"),
    (["--rng_impl", "threefry2x32"], "Not ported"),
    (["--pipeline", "resident", "--cache_size", "1", "--data",
      "ogbn-arxiv"], "Not ported"),
    (["--data", "ogbn-arxiv"], "Not ported"),
    (["--rng_impl", "rbg"], "Not ported"),
])
def test_cli_refuses_every_unported_flag(flags, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["--device", "cpu"] + flags)


#: small runs of the flags that the multi-GPU port brought in
SMALL = ["--num_nodes", "600", "--feature_dim", "8", "--batch_size", "16",
         "--fan_out", "3,2", "--hidden_channels", "8", "--max_steps", "2"]


@pytest.mark.parametrize("flags,error", [
    # the resident pipeline over ranks (tests/test_torch_multigpu_resident.py
    # and _cli_resident.py hold it to JAX) and --shard_topology, a no-op on
    # one card; on the host pipeline --shard_topology is refused, as JAX
    # ignores it there
    (["--model_type", "rgcn", "--pipeline", "resident", "--cache_size", "1",
      "--devices", "2"], None),
    (["--model_type", "rsage", "--devices", "2", "--shard_topology"],
     "--shard_topology"),
    (["--model_type", "rgat", "--shard_topology"], "--shard_topology"),
    (["--devices", "2", "--shard_topology"], "--shard_topology"),
    (["--distribution", "node_color", "--devices", "2", "--pipeline",
      "resident", "--cache_size", "1"], "--color_dir"),
    (["--shard_topology"], "--shard_topology"),
    (["--pipeline", "resident", "--cache_size", "1", "--shard_topology",
      "--devices", "2"], None),
    (["--pipeline", "resident", "--cache_size", "1", "--shard_topology"],
     None),
])
def test_cli_multi_gpu_flags_run_or_refuse(flags, error, capsys):
    argv = ["--device", "cpu"] + flags + SMALL
    if "--pipeline" in flags:
        argv += ["--window", "2"]
    if error is not None:
        with pytest.raises(ValueError, match=error):
            cli.main(argv)
        return
    out = cli.main(argv)
    if "--devices" in flags:
        assert [r["rank"] for r in out] == [0, 1]
        assert all(np.isfinite(r["losses"]).all() and r["edges"] > 0
                   for r in out)
        assert ("topology" in out[0]["ledger"]["handed"]) == \
            ("--shard_topology" in flags)
    else:
        assert "sharded topology" in capsys.readouterr().out
