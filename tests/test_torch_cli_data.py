"""The trainer CLI on datasets read from disk (``--data`` / ``--path`` /
``--dataset_size``) against the JAX CLI, ``examples/train.py``'s ``main``,
on the same files: IGB's homogeneous layout and its preprocessed
``csc_*.npy`` layout (``examples/make_igb_fixture.py --csc``) and
IGB-hetero's (4 node types, 8 relations with the reverses). With the
harness of tests/test_torch_cli_flags.py: the JAX CLI's model ``init``
hands out fixed params and its steps are recorded, dropout 0 and fanout
= max in-degree, so neither side depends on its random draws. Losses at
1e-5 on the resident loop, at rtol 2e-3 / atol 2e-4 on the host loop; the
printed dataset and hit-ratio lines are JAX's; a typed graph from the
files trains on its own relations."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_cli_flags as tcf
import test_torch_cli_resident as tcr
from coala_gnn_tpu.graph.datasets import load_dataset as jax_load
from coala_gnn_tpu.models import hetero as jh
from coala_gnn_tpu.models import make_model as jax_make_model
from coala_gnn_tpu.models.layers import DeviceBlock as JBlock
from coala_gnn_tpu.parallel.sharded_resident import \
    ShardedResidentTrainer as JaxTrainer
from coala_gnn_tpu.sampling.neighbor import block_capacities
from coala_gnn_tpu_torch import generate_colors
from coala_gnn_tpu_torch import train as cli

sys.path.insert(0, os.path.join(tcr.ROOT, "examples"))

from make_igb_fixture import (write_igb_fixture,  # noqa: E402
                              write_igb_hetero_fixture)

TOL, HOST_TOL = tcr.TOL, tcf.HOST_TOL
BATCH, DIM = 32, 16


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{"igb": IGB root (with preprocessed/), "igbh": IGB-hetero root}."""
    igb = str(tmp_path_factory.mktemp("igb"))
    write_igb_fixture(igb, num_nodes=900, dim=DIM, avg_degree=4, seed=2,
                      csc=True)
    igbh = str(tmp_path_factory.mktemp("igbh"))
    # 150 papers: max in-degree 22 with the reverses (a reversed citation
    # hub's in-degree grows with the paper count)
    write_igb_hetero_fixture(igbh, num_paper=150, dim=DIM, avg_degree=2,
                             seed=3)
    return {"igb": igb, "igbh": igbh}


def _data_flags(roots, data):
    path = {"igb": roots["igb"], "igb-hetero": roots["igbh"],
            "preprocessed": os.path.join(roots["igb"], "preprocessed")}[data]
    return ["--data", data, "--path", path, "--dataset_size", "tiny",
            "--num_classes", "19"]


def _argv(roots, data, kind, extra):
    flags = _data_flags(roots, data)
    ds = jax_load(data, path=flags[3], dataset_size="tiny", num_classes=19)
    f = int(np.diff(ds.graph.indptr).max())
    return flags + [
        "--seed", "0", "--batch_size", str(BATCH), "--fan_out", f"{f},{f}",
        "--hidden_channels", "8", "--num_heads", "2", "--learning_rate",
        "0.01", "--cache_size", "1", "--model_type", kind] + extra, ds, f


def _params(kind, f, num_rels):
    caps = block_capacities(BATCH, [f, f])
    if kind.startswith("r"):
        jm = jh.make_hetero_model(kind, hidden=8, num_classes=19,
                                  num_rels=num_rels, num_layers=2,
                                  num_heads=2, dropout=0.0)
        blocks = [jh.DeviceHeteroBlock(
            adj=None, mask=jnp.ones((caps[l][0], f)),
            rel=jnp.zeros((caps[l][0], f), jnp.int32)) for l in range(2)]
    else:
        jm = jax_make_model(kind, hidden=8, num_classes=19, num_layers=2,
                            num_heads=2, dropout=0.0)
        blocks = [JBlock(adj=None, mask=jnp.ones((caps[l][0], f)))
                  for l in range(2)]
    return jm, jm.init(jax.random.key(0), blocks,
                       jnp.zeros((caps[0][1], DIM), jnp.float32))


def _run_jax(argv, jm, params, monkeypatch, resident):
    """``examples/train.py``'s ``main`` with ``argv``; its host steps
    (tests/test_torch_cli_flags.py's harness) or, with ``--pipeline
    resident``, its trainer's steps and windows recorded."""
    if not resident:
        monkeypatch.setattr(jh, "make_hetero_model",
                            lambda *a, **k: tcr._FixedInit(jm, params))
        return tcf._run_jax_host(argv, jm, params, monkeypatch)[:2]
    import coala_gnn_tpu.models as jmodels
    import coala_gnn_tpu.utils.jaxconfig as jconfig

    monkeypatch.setattr(jconfig, "setup", lambda *a, **k: None)
    monkeypatch.setattr(jmodels, "make_model",
                        lambda *a, **k: tcr._FixedInit(jm, params))
    monkeypatch.setattr(jh, "make_hetero_model",
                        lambda *a, **k: tcr._FixedInit(jm, params))
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
    tcr._jax_cli().main(argv + ["--devices", "1"])
    return np.asarray(losses), None


CASES = {
    # data, model, flags
    "igb-sage-host": ("igb", "sage", ["--max_steps", "6"]),
    "igb-sage-resident": ("igb", "sage", [
        "--pipeline", "resident", "--window", "4", "--max_steps", "8"]),
    "preprocessed-sage-resident": ("preprocessed", "sage", [
        "--pipeline", "resident", "--window", "4", "--max_steps", "8"]),
    "igb-hetero-rgcn-host": ("igb-hetero", "rgcn", ["--epochs", "3"]),
    "igb-hetero-rsage-resident": ("igb-hetero", "rsage", [
        "--pipeline", "resident", "--window", "2", "--epochs", "2"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_on_files_matches_jax(roots, name, capsys, monkeypatch):
    data, kind, extra = CASES[name]
    argv, jds, f = _argv(roots, data, kind, extra)
    resident = "resident" in extra
    jm, params = _params(kind, f, jds.graph.num_edge_types)
    want, jcache = _run_jax(argv, jm, params, monkeypatch, resident)
    jax_out = capsys.readouterr().out
    run, _ = tcf._port(argv, params)
    got = cli.train(run)
    out = capsys.readouterr().out
    assert len(want) and np.isfinite(want).all()
    np.testing.assert_allclose(got["losses"], want,
                               **(TOL if resident else HOST_TOL))
    assert tcr._lines(out, "dataset") == tcr._lines(jax_out, "dataset")
    assert tcr._lines(out, "Cache hit ratio") == \
        tcr._lines(jax_out, "Cache hit ratio")
    if kind.startswith("r"):
        # the files' relations: IGB-hetero's 4 and their reverses
        assert run.ds.graph.num_edge_types == 8
        assert run.ds.graph.edge_types is not None
        np.testing.assert_array_equal(run.ds.graph.edge_types,
                                      jds.graph.edge_types)
        assert "8 edge types" in out
    if jcache is not None:
        tcr._state_equal(run.cache, jcache)


def test_cli_trains_every_layout_with_eval(roots, capsys):
    """The CPU commands of README: each layout trains, evaluates and
    prints JAX's lines; the features stay a memory map of the file."""
    for data, kind, extra in (("igb", "sage", []),
                              ("preprocessed", "gcn",
                               ["--pipeline", "resident", "--window", "4"]),
                              ("igb-hetero", "rgat", [])):
        argv = ["--device", "cpu"] + _data_flags(roots, data) + [
            "--batch_size", "32", "--fan_out", "4,3", "--hidden_channels",
            "8", "--max_steps", "4", "--cache_size", "1", "--eval",
            "--model_type", kind] + extra
        args = cli.parse_args(argv)
        cli.refuse_unported(args)
        run = cli.build(args)
        # the hetero loader builds its flattened table in RAM, as JAX's
        assert isinstance(run.ds.features, np.memmap) == (kind != "rgat")
        got = cli.train(run)
        cli.evaluate(run)
        out = capsys.readouterr().out
        assert np.isfinite(got["losses"]).all()
        assert "Test accuracy" in out and f"dataset {run.ds.name}" in out


def test_generate_colors_reads_the_files(roots, tmp_path):
    from coala_gnn_tpu.coloring import generate_color_metadata as jcolors

    flags = _data_flags(roots, "igb")
    meta = generate_colors.main(flags + ["--out", str(tmp_path)])
    jds = jax_load("igb", path=roots["igb"], dataset_size="tiny",
                   num_classes=19)
    want = jcolors(jds.graph, jds.train_idx)
    for name in ("color", "topk", "score", "hop"):
        np.testing.assert_array_equal(getattr(meta, name),
                                      getattr(want, name))
    assert os.path.exists(tmp_path / "color.npy")


def test_unknown_and_ogbn_data_raise(roots):
    with pytest.raises(NotImplementedError, match="Not ported"):
        cli.build(cli.parse_args(["--device", "cpu", "--data",
                                  "ogbn-arxiv"]))
    with pytest.raises(ValueError, match="unknown dataset"):
        cli.build(cli.parse_args(["--device", "cpu", "--data", "cora"]))
