"""The trainer CLI's ``--devices 2 --pipeline resident`` (one spawned gloo
rank per device running the CLI's rank body with the weights swapped in,
tests/torch_multigpu_ranks.py's ``cli_runs``) against ``examples/train.py``'s
``main`` with ``--devices 2 --pipeline resident`` on a mesh of 2 of the 8
virtual CPU devices (its ``_run_resident`` over JAX's
``ShardedResidentTrainer``), with and without ``--shard_topology``.

Both start from one flax init (tests/test_torch_cli_resident.py's
harness) with dropout 0 and fanout = max in-degree, so no draw of either
side matters. Every step's loss (the global mean over the ranks) agrees
at 1e-5; the per-epoch hit and miss counts (summed over the ranks) and
the test accuracy lines are JAX's exactly. The cases run fused windows
with eval, per-step steps with one ``begin`` ahead on a cache that evicts
over two epochs, and the sharded topology with node_local and the masked
tail step."""

import functools

import numpy as np
import pytest
import torch

import test_torch_cli_resident as tcr
import test_torch_multigpu_cli as tmcli
import torch_multigpu_ranks as ranks
from coala_gnn_tpu.parallel.sharded_resident import \
    ShardedResidentTrainer as JaxTrainer
from coala_gnn_tpu_torch import train as cli
from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
from coala_gnn_tpu_torch.parallel.multihost import launch
from coala_gnn_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

CASES = {
    # name: (nodes, feature dim, batch, flags); 1 MB of lines holds every
    # row of 800 nodes at dim 16, and evicts at dim 256
    "window4-eval": (800, 16, 16, ["--window", "4", "--max_steps", "9",
                                   "--eval"]),
    "window1-evicts-2-epochs": (1500, 256, 16, [
        "--window", "1", "--max_steps", "4", "--epochs", "2", "--eval"]),
    "shard_topology-node_local-mask_tail": (800, 16, 44, [
        "--shard_topology", "--cache_backend", "node_local", "--window",
        "4", "--mask_tail", "--eval"]),
}


@functools.lru_cache(maxsize=None)
def _fanout(n):
    return int(synthetic_graph(num_nodes=n, avg_degree=4, feature_dim=8,
                               num_classes=4, seed=0
                               ).graph.in_degrees().max())


def _argv(name):
    n, dim, batch, extra = CASES[name]
    return tcr._flags(n, dim, batch, _fanout(n), "sage", extra)


@functools.lru_cache(maxsize=None)
def _params(name):
    n, dim, batch, _ = CASES[name]
    return tcr._params("sage", _fanout(n), batch, dim)


@functools.lru_cache(maxsize=None)
def _port():
    runs = [dict(args=cli.parse_args(["--device", "cpu", "--devices", "2"]
                                     + _argv(name)),
                 state_dict=params_from_flax(__import__("jax").device_get(
                     _params(name)[1])))
            for name in sorted(CASES)]
    return launch(ranks.cli_runs, 2, ["cpu"] * 2, "gloo", threads=1,
                  args=(runs,), timeout=300)


def _jax_run(name, monkeypatch, capsys):
    """``examples/train.py``'s ``main`` with ``--devices 2``: (every step's
    loss, its eval counts, its printed lines)."""
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
    jm, params = _params(name)
    _, out = tmcli._jax_main(_argv(name), 2, jm, params, False, monkeypatch,
                             capsys)
    return np.asarray(losses), evals, out


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_devices_resident_matches_jax(name, monkeypatch, capsys):
    args = cli.parse_args(["--device", "cpu", "--devices", "2"]
                          + _argv(name))
    cli.refuse_unported(args)
    want, want_eval, jax_out = _jax_run(name, monkeypatch, capsys)
    assert "pipeline: device-resident" in jax_out
    assert ("sharded topology" in jax_out) == args.shard_topology
    i = sorted(CASES).index(name)
    got = [r[i] for r in _port()]
    assert len(want) > 0 and np.isfinite(want).all()
    for g in got:
        np.testing.assert_allclose(g["losses"], want, **tcr.TOL)
        assert [tmcli._hit_line(s) for s in g["stats"]] == \
            tcr._lines(jax_out, "Cache hit ratio")
        c, t = g["eval"]
        assert c == sum(want_eval)
        assert [f"Test accuracy: {c / t:.4f} ({t} nodes)"] == \
            tcr._lines(jax_out, "Test accuracy")
        led = g["ledger"]["handed"]
        assert ("topology" in led) == args.shard_topology
        assert g["edges"] > 0
