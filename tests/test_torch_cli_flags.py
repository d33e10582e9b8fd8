"""The trainer CLI's last one-device flags against the JAX CLI
(``examples/train.py``): ``--distribution node_color --color_dir`` on both
pipelines, ``--save_dir`` / ``--resume`` on both, and ``--nbr_cap`` on
``--pipeline resident``; with tests/test_torch_cli_resident.py's
recorded-steps harness (the JAX loop's ``model.init`` hands out fixed
params, its steps are recorded as they run, dropout 0 and fanout = max
in-degree, so neither side depends on its random draws).

- node_color: the seed slices, the cache state with its color counters
  and the printed lines equal JAX's; losses at 1e-5 on the resident loop,
  2e-3 / 2e-4 on the host loop (whose sampler is the host one, held to JAX
  bitwise by tests/test_torch_host_sampler.py).
- save / resume: both CLIs save after each epoch; the port then resumes
  from JAX's own checkpoint, converted (``utils/convert.py``), and both
  print the same resume line, start at the same epoch and train the
  resumed epoch to the same losses. On the port's resident loop a resumed
  run equals an uninterrupted one from the resumed epoch on, bitwise.
- nbr_cap: SAGE and RGAT (its relation table) on the padded table.
- the flags that JAX ignores where they are given raise ValueError."""

import os
import shutil

import jax
import numpy as np
import optax
import pytest
import torch

import test_torch_cli_resident as tcr
from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.cache.host_tier import HostFeatureStore as JaxStore
from coala_gnn_tpu.coloring import generate_color_metadata as jax_colors
from coala_gnn_tpu.coloring import save_color_metadata as jax_save_colors
from coala_gnn_tpu.distribution import DistributionScheduler as JaxScheduler
from coala_gnn_tpu.distribution import SeedDistributor as JaxDistributor
from coala_gnn_tpu.graph.datasets import synthetic_graph as jax_synthetic
from coala_gnn_tpu.parallel.mesh import make_mesh
from coala_gnn_tpu.parallel.multihost import make_meta_exchange_fn
from coala_gnn_tpu.parallel.sharded_cache import \
    ShardedFeatureCache as JaxCache
from coala_gnn_tpu.parallel.sharded_resident import \
    ShardedResidentTrainer as JaxTrainer
from coala_gnn_tpu.utils import checkpoint as jax_ckpt
from coala_gnn_tpu_torch import train as cli
from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
from coala_gnn_tpu_torch.utils import checkpoint as ckpt
from coala_gnn_tpu_torch.utils.convert import (adam_state_from_optax,
                                               params_from_flax)

torch.set_num_threads(1)

TOL = tcr.TOL
HOST_TOL = dict(rtol=2e-3, atol=2e-4)
N, DIM, BATCH = 800, 64, 32


@pytest.fixture(scope="module")
def fanout():
    return int(synthetic_graph(num_nodes=N, avg_degree=4, feature_dim=8,
                               num_classes=4, seed=0
                               ).graph.in_degrees().max())


@pytest.fixture(scope="module")
def color_dir(tmp_path_factory):
    """The JAX package's color metadata of the run's graph."""
    ds = jax_synthetic(num_nodes=N, avg_degree=4, feature_dim=DIM,
                       num_classes=4, seed=0)
    path = str(tmp_path_factory.mktemp("colors"))
    jax_save_colors(jax_colors(ds.graph, ds.train_idx), path)
    return path


def _argv(fanout, kind="sage", resident=True, extra=()):
    argv = tcr._flags(N, DIM, BATCH, fanout, kind, list(extra))
    if not resident:
        i = argv.index("--pipeline")
        argv = argv[:i] + argv[i + 2:]
    return argv


def _record_domains(monkeypatch):
    """Every seed slice a JAX scheduler hands out, in call order."""
    kept, orig = [], JaxScheduler.run_domain

    def run_domain(self):
        d = orig(self)
        kept.append(np.array(d))
        return d

    monkeypatch.setattr(JaxScheduler, "run_domain", run_domain)
    return kept


def _run_jax_resident(args, jm, params, monkeypatch, tx=None):
    """tests/test_torch_cli_resident.py's ``_run_jax`` (Adam 0.01 unless
    ``tx``) with the color metadata wired as ``examples/train.py``'s main
    wires it. -> (losses, cache, seed slices)."""
    from coala_gnn_tpu.coloring import load_color_metadata

    jcli = tcr._jax_cli()
    ds = jax_synthetic(num_nodes=args.num_nodes, avg_degree=args.avg_degree,
                       feature_dim=args.feature_dim,
                       num_classes=args.num_classes, seed=args.seed)
    if args.model_type.startswith("r"):
        ds.graph.edge_types = np.random.default_rng(args.seed).integers(
            0, 3, ds.graph.num_edges).astype(np.int32)
        ds.graph.num_edge_types = 3
    meta = load_color_metadata(args.color_dir) if args.color_dir else None
    cache = JaxCache(cfg=jfc.make_config(
        cache_mb=args.cache_size, dim=ds.feature_dim, num_shards=1,
        num_colors=0 if meta is None else meta.num_colors),
        mesh=make_mesh(jax.devices()[:1]))
    sched = JaxScheduler(JaxDistributor(
        ds.train_idx, batch_size=args.batch_size, local_size=1, num_parts=1,
        mode=args.distribution, shuffle_seed=args.seed,
        color=None if meta is None else meta.color,
        topk_colors=None if meta is None else meta.topk,
        affinity=None if meta is None else meta.score),
        part_id=0, local_rank=0,
        meta_exchange_fn=(None if meta is None else
                          make_meta_exchange_fn(meta.num_colors)),
        refresh_counter=args.refresh_counter)
    sched.meta_fn = cache.local_color_meta
    losses = []
    step, window = JaxTrainer.train_step, JaxTrainer.train_window

    def rec_step(self, *a, **k):
        out = step(self, *a, **k)
        losses.append(float(out[2]))
        return out

    def rec_window(self, *a, **k):
        out = window(self, *a, **k)
        losses.extend(np.asarray(out[2]).tolist())
        return out

    monkeypatch.setattr(JaxTrainer, "train_step", rec_step)
    monkeypatch.setattr(JaxTrainer, "train_window", rec_window)
    domains = _record_domains(monkeypatch)
    jcli._run_resident(args, ds, meta, cache, JaxStore(ds.features),
                       tcr._FixedInit(jm, params), tx or optax.adam(0.01),
                       sched,
                       [int(f) for f in args.fan_out.split(",")],
                       args.batch_size, 1, jax)
    return np.asarray(losses), cache, domains


def _run_jax_host(argv, jm, params, monkeypatch):
    """``examples/train.py``'s ``main`` on its host loop, one device of the
    CPU mesh, its model's ``init`` handing out ``params``, its steps and
    cache recorded. -> (losses, cache, seed slices)."""
    import coala_gnn_tpu.models as jmodels
    import coala_gnn_tpu.parallel.sharded_cache as jsc
    import coala_gnn_tpu.parallel.train as jtrain
    import coala_gnn_tpu.utils.jaxconfig as jconfig

    jcli = tcr._jax_cli()
    monkeypatch.setattr(jconfig, "setup", lambda *a, **k: None)
    monkeypatch.setattr(jmodels, "make_model",
                        lambda *a, **k: tcr._FixedInit(jm, params))
    losses, caches = [], []
    make_step = jtrain.make_sharded_train_step

    def recorded_step(*a, **k):
        fn = make_step(*a, **k)

        def run(*aa, **kk):
            out = fn(*aa, **kk)
            losses.append(float(out[2]))
            return out
        return run

    class Cache(jsc.ShardedFeatureCache):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            caches.append(self)

    monkeypatch.setattr(jtrain, "make_sharded_train_step", recorded_step)
    monkeypatch.setattr(jsc, "ShardedFeatureCache", Cache)
    domains = _record_domains(monkeypatch)
    jcli.main(argv + ["--devices", "1"])
    return np.asarray(losses), caches[0], domains


def _port(argv, params):
    """The port's CLI built from ``argv`` on the CPU, dropout 0, the
    JAX params loaded; its seed slices recorded."""
    args = cli.parse_args(["--device", "cpu"] + argv)
    cli.refuse_unported(args)
    run = cli.build(args)
    run.model.dropout = 0.0
    run.model.load_state_dict(params_from_flax(jax.device_get(params)))
    kept, orig = [], run.scheduler.run_domain

    def run_domain():
        d = orig()
        kept.append(np.array(d))
        return d

    run.scheduler.run_domain = run_domain
    return run, kept


def _same_lines(out, jax_out, prefixes):
    for prefix in prefixes:
        assert tcr._lines(out, prefix) == tcr._lines(jax_out, prefix), prefix
    ours, theirs = tcr._lines(out, "Epoch"), tcr._lines(jax_out, "Epoch")
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        a, b = tcr._counted(a), tcr._counted(b)
        assert a[1:] == b[1:]
        assert float(a[0].split()[-1]) == pytest.approx(
            float(b[0].split()[-1]), abs=2e-4)


def test_node_color_resident_matches_jax(fanout, color_dir, capsys,
                                         monkeypatch):
    """--pipeline resident --window 4 --distribution node_color: JAX's
    seed slices (one part: the baseline's seeds), cache state with its
    color counters, losses and lines."""
    argv = _argv(fanout, extra=["--window", "4", "--max_steps", "8",
                                "--epochs", "2", "--distribution",
                                "node_color", "--color_dir", color_dir])
    jm, params = tcr._params("sage", fanout, BATCH, DIM)
    want, jcache, jdom = _run_jax_resident(cli.parse_args(argv), jm, params,
                                           monkeypatch)
    jax_out = capsys.readouterr().out
    run, dom = _port(argv, params)
    got = cli.train(run)
    out = capsys.readouterr().out
    assert run.meta is not None and run.trainer.colors is run.meta.color
    assert len(dom) == len(jdom) == 16
    for a, b in zip(dom, jdom):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got["losses"], want, **TOL)
    tcr._state_equal(run.cache, jcache)
    counts = run.cache.state.base.color_counts
    assert int(counts[1:].sum()) > 0
    _same_lines(out, jax_out, ("Cache hit ratio", "pipeline"))


def test_node_color_host_matches_jax(fanout, color_dir, capsys,
                                     monkeypatch):
    """The host loop with --distribution node_color: JAX's seed slices
    (the trained ones; both loaders prefetch), fetches with the nodes'
    colors (the cache state bitwise), losses and lines."""
    argv = _argv(fanout, resident=False, extra=[
        "--max_steps", "6", "--distribution", "node_color", "--color_dir",
        color_dir])
    jm, params = tcr._params("sage", fanout, BATCH, DIM)
    want, jcache, jdom = _run_jax_host(argv, jm, params, monkeypatch)
    jax_out = capsys.readouterr().out
    run, dom = _port(argv, params)
    got = cli.train(run)
    out = capsys.readouterr().out
    assert len(want) == 6 and len(dom) >= 6 and len(jdom) >= 6
    for a, b in zip(dom[:6], jdom[:6]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got["losses"], want, **HOST_TOL)
    tcr._state_equal(run.cache, jcache)
    assert int(run.cache.state.base.color_counts[1:].sum()) > 0
    _same_lines(out, jax_out, ("Cache hit ratio",))


def _to_port_checkpoint(jax_dir, port_dir, run, params):
    """JAX's latest orbax checkpoint -> the port's, through the
    converters: params and Adam state into ``run``'s model and optimizer,
    saved at the same step. ``params``: the flax tree (orbax's restore
    template)."""
    tx = optax.adam(0.01)
    like = {"params": params, "opt_state": tx.init(params), "step": 0}
    jp, jo, step = jax_ckpt.restore(jax_dir, like)
    run.model.load_state_dict(params_from_flax(jax.device_get(jp)))
    adam_state_from_optax(jax.device_get(jo), run.model, run.optimizer)
    ckpt.save(port_dir, run.model, run.optimizer, step)
    return step


@pytest.mark.parametrize("resident", [True, False])
def test_save_then_resume_matches_jax(fanout, tmp_path, capsys, monkeypatch,
                                      resident):
    """Both CLIs train one epoch with --save_dir (the same losses), then
    resume with --epochs 2: the port from JAX's checkpoint converted. The
    resume line, the start epoch, the resumed epoch's losses and lines
    and the checkpoint lines equal JAX's."""
    extra = ["--max_steps", "4", "--window", "4"] if resident else \
        ["--max_steps", "4"]
    jm, params = tcr._params("sage", fanout, BATCH, DIM)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")

    def argv(epochs, save_dir, resume=False):
        return _argv(fanout, resident=resident, extra=extra + [
            "--epochs", str(epochs), "--save_dir", save_dir]
            + (["--resume"] if resume else []))

    def jax_run(a):
        if resident:
            return _run_jax_resident(cli.parse_args(a), jm, params,
                                     monkeypatch)[0]
        return _run_jax_host(a, jm, params, monkeypatch)[0]

    want0 = jax_run(argv(1, jdir))
    jax_out0 = capsys.readouterr().out
    run, _ = _port(argv(1, pdir), params)
    got0 = cli.train(run)["losses"]
    out0 = capsys.readouterr().out
    np.testing.assert_allclose(got0, want0, **(TOL if resident
                                               else HOST_TOL))
    assert tcr._lines(out0, "checkpoint saved") == [
        f"checkpoint saved to {pdir}"]
    assert jax_ckpt.latest_step(jdir) == ckpt.latest_step(pdir) == 4

    shared = str(tmp_path / "shared")
    run, _ = _port(argv(2, shared, True), params)
    assert _to_port_checkpoint(jdir, shared, run, params) == 4
    capsys.readouterr()
    want1 = jax_run(argv(2, jdir, True))
    jax_out1 = capsys.readouterr().out
    run, _ = _port(argv(2, shared, True), params)
    start = cli.resume(run)
    got1 = cli.train(run)["losses"]
    out1 = capsys.readouterr().out
    assert start == 1 and run.epoch == 2
    assert tcr._lines(out1, "resumed from") == \
        tcr._lines(jax_out1, "resumed from") == \
        ["resumed from step 4 -> starting at epoch 1"]
    np.testing.assert_allclose(got1, want1, **(TOL if resident
                                               else HOST_TOL))
    _same_lines(out1, jax_out1, ("Cache hit ratio",))
    assert len(tcr._lines(out1, "checkpoint saved")) == \
        len(tcr._lines(jax_out1, "checkpoint saved")) == 1
    assert ckpt.latest_step(shared) == jax_ckpt.latest_step(jdir) == 8


def test_resident_resume_equals_uninterrupted_run(fanout, tmp_path, capsys):
    """The port's resident loop: a run resumed from epoch 1's checkpoint
    trains epochs 1-2 exactly as the uninterrupted 3-epoch run did (its
    streams continue from the restored step), and its restored state is
    the file's, bitwise."""
    jm, params = tcr._params("sage", fanout, BATCH, DIM)
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    extra = ["--max_steps", "4", "--window", "2", "--epochs", "3"]
    run, _ = _port(_argv(fanout, extra=extra + ["--save_dir", full]), params)
    ref = cli.train(run)["losses"]
    assert sorted(os.listdir(full)) == ["step_12", "step_4", "step_8"]
    shutil.copytree(os.path.join(full, "step_4"),
                    os.path.join(part, "step_4"))
    run, _ = _port(_argv(fanout, extra=extra + ["--save_dir", part,
                                                "--resume"]), params)
    assert cli.resume(run) == 1 and run.step == 4 and not run.fresh
    saved = torch.load(os.path.join(part, "step_4", ckpt.FILE),
                       weights_only=True)
    for k, v in run.model.state_dict().items():
        assert torch.equal(v, saved["model"][k])
    got = cli.train(run)["losses"]
    assert got.shape == (8,)
    np.testing.assert_array_equal(got, ref[4:])
    out = capsys.readouterr().out
    assert "resumed from step 4 -> starting at epoch 1" in out


@pytest.mark.parametrize("kind", ["sage", "rgat"])
def test_nbr_cap_resident_matches_jax(fanout, kind, capsys, monkeypatch):
    """--nbr_cap = fanout (every row whole) on the resident CLI: JAX's
    losses, lines and pipeline line (with its table size), SAGE with Adam
    and RGAT (the relation table) with SGD (test_torch_cli_resident.py's
    reason: under Adam the last layer's ``attn_r`` gradient is rounding
    noise)."""
    argv = _argv(fanout, kind, extra=["--window", "4", "--max_steps", "6",
                                      "--nbr_cap", str(fanout)])
    jm, params = tcr._params(kind, fanout, BATCH, DIM)
    sgd = kind == "rgat"
    want, jcache, _ = _run_jax_resident(
        cli.parse_args(argv), jm, params, monkeypatch,
        optax.sgd(0.01) if sgd else None)
    jax_out = capsys.readouterr().out
    run, _ = _port(argv, params)
    if sgd:
        run.optimizer = torch.optim.SGD(run.model.parameters(), lr=0.01)
    assert run.trainer.g.nbr_table is not None
    assert (run.trainer.g.rel_table is not None) == (kind == "rgat")
    got = cli.train(run)
    out = capsys.readouterr().out
    np.testing.assert_allclose(got["losses"], want, **TOL)
    assert tcr._lines(out, "pipeline") == tcr._lines(jax_out, "pipeline") \
        == [f"pipeline: device-resident (seeds-only upload, padded table "
            f"P={fanout})"]
    _same_lines(out, jax_out, ("Cache hit ratio",))
    tcr._state_equal(run.cache, jcache)


@pytest.mark.parametrize("flags,match", [
    (["--nbr_cap", "8"], "--nbr_cap 8"),
    (["--resume"], "--save_dir"),
    (["--color_dir", "colors"], "--color_dir"),
    (["--distribution", "node_color"], "--color_dir"),
    (["--pipeline", "resident", "--cache_size", "1", "--nbr_cap", "2",
      "--fan_out", "4,3"], "nbr_cap=2 < max fanout 4"),
])
def test_cli_refuses_flags_jax_ignores(flags, match):
    """--nbr_cap on the host pipeline, --resume without --save_dir and
    --color_dir without node_color raise ValueError (JAX's CLI ignores
    them there); node_color without --color_dir names the flag it needs;
    a table narrower than the fanout raises the trainer's ValueError."""
    with pytest.raises(ValueError, match=match):
        cli.main(["--device", "cpu", "--num_nodes", "300", "--feature_dim",
                  "8", "--batch_size", "8", "--hidden_channels", "8",
                  "--max_steps", "1"] + flags)
