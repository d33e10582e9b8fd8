"""The trainer CLI's ``--pipeline resident`` (``coala_gnn_tpu_torch.train``:
``build`` / ``train`` / ``evaluate`` on ``--device cpu``) against the JAX
CLI's own resident loop, ``examples/train.py``'s ``_run_resident``, driven
with the same flags on JAX's ShardedResidentTrainer over a one-device mesh:
the scheduler's seed grids, the window clamp, the run's first step taken
per step, fused windows or the per-step path with one ``begin`` ahead, the
``--mask_tail`` step and the eval.

Both start from one flax init (the JAX loop's ``model.init`` hands it
out, the port's model loads it converted), with dropout 0 and fanout =
max in-degree, so neither loop depends on its random draws.
Every step's loss agrees at 1e-5: SAGE with the CLI's Adam, GAT and
RGAT with SGD (under Adam the last layer's ``attn_r`` gradient is rounding
noise that Adam turns into lr-sized steps, tests/test_torch_resident.py);
the printed hit-ratio, sampled-edge and test-accuracy lines, the eval counts
and the cache state are JAX's exactly. The flags the slice does not port
still raise, naming their ROADMAP.md item."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.cache.host_tier import HostFeatureStore as JaxStore
from coala_gnn_tpu.distribution import DistributionScheduler as JaxScheduler
from coala_gnn_tpu.distribution import SeedDistributor as JaxDistributor
from coala_gnn_tpu.graph.datasets import synthetic_graph as jax_synthetic
from coala_gnn_tpu.models import hetero as jh
from coala_gnn_tpu.models import make_model as jax_make_model
from coala_gnn_tpu.models.layers import DeviceBlock as JBlock
from coala_gnn_tpu.parallel.mesh import make_mesh
from coala_gnn_tpu.parallel.sharded_cache import \
    ShardedFeatureCache as JaxCache
from coala_gnn_tpu.parallel.sharded_resident import \
    ShardedResidentTrainer as JaxTrainer
from coala_gnn_tpu.sampling.neighbor import block_capacities
from coala_gnn_tpu_torch import train as cli
from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
from coala_gnn_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_cli():
    """``examples/train.py`` as a module (its ``_run_resident``)."""
    spec = importlib.util.spec_from_file_location(
        "jax_cli", os.path.join(ROOT, "examples", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _FixedInit:
    """A flax model whose ``init`` returns the given params."""

    def __init__(self, model, params):
        self._model, self._params = model, params

    def init(self, *args, **kwargs):
        return self._params

    def apply(self, *args, **kwargs):
        return self._model.apply(*args, **kwargs)


def _flags(n, dim, batch, fanout, kind, extra):
    return ["--num_nodes", str(n), "--avg_degree", "4", "--feature_dim",
            str(dim), "--num_classes", "4", "--seed", "0", "--batch_size",
            str(batch), "--fan_out", f"{fanout},{fanout}",
            "--hidden_channels", "8", "--num_heads", "2", "--learning_rate",
            "0.01", "--cache_size", "1", "--pipeline", "resident",
            "--model_type", kind] + extra


def _params(kind, fanout, batch, dim):
    """(flax model with dropout 0, its params at the contiguous layout)."""
    caps = block_capacities(batch, [fanout, fanout])
    if kind.startswith("r"):
        jm = jh.make_hetero_model(kind, hidden=8, num_classes=4, num_rels=3,
                                  num_layers=2, num_heads=2, dropout=0.0)
        blocks = [jh.DeviceHeteroBlock(
            adj=None, mask=jnp.ones((caps[l][0], fanout)),
            rel=jnp.zeros((caps[l][0], fanout), jnp.int32))
            for l in range(2)]
    else:
        jm = jax_make_model(kind, hidden=8, num_classes=4, num_layers=2,
                            num_heads=2, dropout=0.0)
        blocks = [JBlock(adj=None, mask=jnp.ones((caps[l][0], fanout)))
                  for l in range(2)]
    return jm, jm.init(jax.random.key(0), blocks,
                       jnp.zeros((caps[0][1], dim), jnp.float32))


def _run_jax(args, jm, params, tx, monkeypatch):
    """``_run_resident`` with ``args`` on one device and optimizer ``tx``;
    -> (step losses, eval counts, cache). Its trainer's steps are recorded
    as they run."""
    jcli = _jax_cli()
    ds = jax_synthetic(num_nodes=args.num_nodes, avg_degree=args.avg_degree,
                       feature_dim=args.feature_dim,
                       num_classes=args.num_classes, seed=args.seed)
    if args.model_type.startswith("r"):
        ds.graph.edge_types = np.random.default_rng(args.seed).integers(
            0, 3, ds.graph.num_edges).astype(np.int32)
        ds.graph.num_edge_types = 3
    B = args.batch_size
    fanouts = [int(f) for f in args.fan_out.split(",")]
    mesh = make_mesh(jax.devices()[:1])
    cache = JaxCache(cfg=jfc.make_config(cache_mb=args.cache_size,
                                         dim=ds.feature_dim, num_shards=1,
                                         quantize=args.quantize),
                     mesh=mesh)
    sched = JaxScheduler(JaxDistributor(
        ds.train_idx, batch_size=B, local_size=1, num_parts=1,
        mode="baseline", shuffle_seed=args.seed,
        drop_tail=not (args.keep_tail or args.mask_tail)), part_id=0,
        local_rank=0, refresh_counter=args.refresh_counter)
    sched.meta_fn = cache.local_color_meta
    losses, evals = [], []
    step, window, ev = (JaxTrainer.train_step, JaxTrainer.train_window,
                        JaxTrainer.eval_step)

    def rec_step(self, *a, **k):
        out = step(self, *a, **k)
        losses.append(float(out[2]))
        return out

    def rec_window(self, *a, **k):
        out = window(self, *a, **k)
        losses.extend(np.asarray(out[2]).tolist())
        return out

    def rec_eval(self, *a, **k):
        evals.append(ev(self, *a, **k))
        return evals[-1]

    monkeypatch.setattr(JaxTrainer, "train_step", rec_step)
    monkeypatch.setattr(JaxTrainer, "train_window", rec_window)
    monkeypatch.setattr(JaxTrainer, "eval_step", rec_eval)
    jcli._run_resident(args, ds, None, cache, JaxStore(ds.features),
                       _FixedInit(jm, params), tx, sched, fanouts, B, 1, jax)
    return np.asarray(losses), evals, cache


def _state_equal(port_cache, jax_cache):
    n = port_cache.cfg.num_sets
    s, js = port_cache.state, jax_cache.state
    for got, want in ((s.base.tags[:n], js.tags), (s.base.data[:n], js.data),
                      (s.base.rr, js.rr), (s.line_colors[:n], js.line_colors),
                      (s.base.color_counts, js.color_counts)):
        assert got.numpy().tobytes() == np.asarray(want)[0].tobytes()


def _lines(out, prefix):
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def _counted(line):
    """An epoch line without its times: loss, batch acc, sampled nodes."""
    parts = line.split(" | ")
    return [p for p in parts if not ("Time" in p or "agg time" in p)]


CASES = {
    # kind, nodes, feature dim (1 MB of lines holds every row of 800 nodes;
    # 1,500 nodes of 256-wide rows evict), batch, flags. Batch 44 makes 11
    # iterations of 480 train nodes, the last one wrapped: the window
    # before the masked tail step is cut to one step.
    "sage-window4-full-mask_tail": ("sage", 800, 256, 44, [
        "--window", "4", "--mask_tail", "--eval"]),
    "sage-window1-evicts": ("sage", 1500, 256, 16, [
        "--window", "1", "--max_steps", "6", "--epochs", "2"]),
    "gat-window4-evicts-clamped": ("gat", 1500, 256, 16, [
        "--window", "4", "--refresh_counter", "3", "--max_steps", "8"]),
    "rgat-window4-full": ("rgat", 800, 64, 32, [
        "--window", "4", "--max_steps", "6", "--eval"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_resident_matches_jax_run_resident(name, capsys, monkeypatch):
    kind, n, dim, batch, extra = CASES[name]
    probe = synthetic_graph(num_nodes=n, avg_degree=4, feature_dim=8,
                            num_classes=4, seed=0)
    fanout = int(probe.graph.in_degrees().max())
    argv = _flags(n, dim, batch, fanout, kind, extra)
    jm, params = _params(kind, fanout, batch, dim)
    sgd = kind != "sage"
    want, want_eval, jcache = _run_jax(
        cli.parse_args(argv), jm, params,
        optax.sgd(0.01) if sgd else optax.adam(0.01), monkeypatch)
    jax_out = capsys.readouterr().out

    args = cli.parse_args(["--device", "cpu"] + argv)
    cli.refuse_unported(args)
    run = cli.build(args)
    run.model.dropout = 0.0
    run.model.load_state_dict(params_from_flax(jax.device_get(params)))
    if sgd:
        run.optimizer = torch.optim.SGD(run.model.parameters(), lr=0.01)
    got = cli.train(run)
    if args.eval:
        correct, total = cli.evaluate(run)
        assert correct == sum(want_eval) and total == len(run.ds.test_idx)
    out = capsys.readouterr().out

    assert got["losses"].shape == want.shape and np.isfinite(want).all()
    np.testing.assert_allclose(got["losses"], want, **TOL)
    for prefix in ("Cache hit ratio", "Test accuracy", "note: clamping",
                   "pipeline: device-resident"):
        assert _lines(out, prefix) == _lines(jax_out, prefix), prefix
    ours, theirs = _lines(out, "Epoch"), _lines(jax_out, "Epoch")
    assert len(ours) == len(theirs) == args.epochs
    for a, b in zip(ours, theirs):
        a, b = _counted(a), _counted(b)
        assert a[1:] == b[1:]                       # batch acc, sampled
        assert float(a[0].split()[-1]) == pytest.approx(
            float(b[0].split()[-1]), abs=2e-4)       # the 4-decimal loss
    _state_equal(run.cache, jcache)
    if "mask_tail" in name:
        assert run.scheduler.d.num_iters == len(want) == 11


def test_cli_resident_runs_every_model_on_cpu(capsys):
    """The CPU command of README: SAGE, GAT and RGAT, fused windows on an
    8 MB cache, eval: JAX's lines, finite losses."""
    for kind in ("sage", "gat", "rgat"):
        cli.main(["--device", "cpu", "--pipeline", "resident",
                  "--cache_size", "8", "--window", "4", "--max_steps", "8",
                  "--eval", "--num_nodes", "2000", "--feature_dim", "16",
                  "--batch_size", "32", "--fan_out", "4,3",
                  "--hidden_channels", "16", "--model_type", kind])
        out = capsys.readouterr().out
        assert "pipeline: device-resident" in out
        losses = [float(ln.split("| loss ")[1].split()[0])
                  for ln in _lines(out, "Epoch")]
        assert len(losses) == 1 and np.isfinite(losses).all()
        assert len(_lines(out, "Cache hit ratio")) == 1
        assert "(400 nodes)" in _lines(out, "Test accuracy")[0]


@pytest.mark.parametrize("flags,error,match", [
    (["--model_type", "rgcn", "--devices", "2"], NotImplementedError,
     "multi-GPU"),
    (["--shard_topology"], NotImplementedError, "multi-GPU"),
    (["--distribution", "node_color"], ValueError, "--color_dir"),
    (["--nbr_cap", "2", "--fan_out", "4,3"], ValueError,
     "nbr_cap=2 < max fanout 4"),
    (["--resume"], ValueError, "--save_dir"),
    (["--data", "igb"], NotImplementedError, "the real datasets"),
    (["--rng_impl", "rbg"], NotImplementedError, "Not ported"),
    (["--profile_dir", "trace"], ValueError, "--profile_dir"),
])
def test_cli_resident_refuses_what_it_does_not_run(flags, error, match):
    with pytest.raises(error, match=match):
        cli.main(["--device", "cpu", "--pipeline", "resident",
                  "--cache_size", "1"] + flags)


def test_cli_resident_needs_a_cache_and_window_needs_it():
    with pytest.raises(SystemExit, match="--cache_size"):
        cli.main(["--device", "cpu", "--pipeline", "resident"])
    with pytest.raises(ValueError, match="--window 4"):
        cli.main(["--device", "cpu", "--window", "4"])


def test_cli_profile_dir_traces_the_host_epoch(tmp_path, capsys):
    """``--profile_dir`` on the host pipeline writes a torch.profiler trace
    of epoch 0 (JAX: a jax.profiler trace)."""
    cli.main(["--device", "cpu", "--num_nodes", "600", "--feature_dim", "8",
              "--batch_size", "16", "--fan_out", "3,2", "--hidden_channels",
              "8", "--max_steps", "2", "--epochs", "2", "--profile_dir",
              str(tmp_path)])
    assert "profiler trace written to" in capsys.readouterr().out
    traces = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(traces) == 1 and os.path.getsize(tmp_path / traces[0]) > 0
