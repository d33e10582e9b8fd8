"""coala_gnn_tpu_torch/utils/checkpoint.py and the optax Adam state
converter of utils/convert.py: the save / ``latest_step`` / restore round
trip of tests/test_utils.py:25-42 (the JAX package's orbax checkpoint, the
same ``step_<n>`` naming), a restore onto a model on the CPU, and an optax
Adam / AdamW state carried into ``torch.optim.Adam`` / ``AdamW`` whose next
step matches optax's (1e-5). A save cut short (a stale ``step_<n>.tmp-*``
sibling, or a ``step_<n>/`` without ``state.pt``) leaves the last complete
checkpoint the latest, as orbax's temporary directory does for JAX, and the
CLI's ``--resume`` then resumes from it. ``hetero_blocks_to_device`` takes
no default device."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from coala_gnn_tpu.models import make_model as jax_make_model
from coala_gnn_tpu.models.layers import DeviceBlock as JBlock
from coala_gnn_tpu.sampling.neighbor import block_capacities
from coala_gnn_tpu.utils import checkpoint as jax_ckpt
from coala_gnn_tpu_torch.models.gnn import make_model
from coala_gnn_tpu_torch import train as cli
from coala_gnn_tpu_torch.models import hetero as th
from coala_gnn_tpu_torch.utils import checkpoint as ckpt
from coala_gnn_tpu_torch.utils.convert import (adam_state_from_optax,
                                               params_from_flax)

torch.set_num_threads(1)


def _trained(steps=3, lr=1e-2):
    """A small SAGE and its Adam after ``steps`` updates on random data."""
    model = make_model("sage", 8, 8, 4, 2, dropout=0.0)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    gen = torch.Generator().manual_seed(0)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    return model, opt


def _same(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        if torch.is_tensor(a[k]):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        elif isinstance(a[k], dict):
            _same(a[k], b[k])
        else:
            assert a[k] == b[k], k


def test_checkpoint_roundtrip(tmp_path):
    """save -> latest_step -> restore into fresh objects: params and the
    whole optimizer state bitwise, the step back; the JAX package's naming
    and latest_step on the same directory; None without a checkpoint."""
    model, opt = _trained()
    path = str(tmp_path / "ck")
    assert ckpt.restore(path, model, opt) is None
    assert ckpt.latest_step(path) is None
    ckpt.save(path, model, opt, step=7)
    ckpt.save(path, model, opt, step=3)
    assert sorted(os.listdir(path)) == ["step_3", "step_7"]
    assert ckpt.latest_step(path) == jax_ckpt.latest_step(path) == 7
    fresh, fopt = _trained(steps=1)
    assert ckpt.restore(path, fresh, fopt) == 7
    _same(fresh.state_dict(), model.state_dict())
    _same(fopt.state_dict()["state"], opt.state_dict()["state"])
    assert fopt.state_dict()["param_groups"] == \
        opt.state_dict()["param_groups"]
    assert ckpt.restore(path, fresh, fopt, step=3) == 3
    # training continues from the restored state exactly as from the saved
    for m, o in ((model, opt), (fresh, fopt)):
        for p in m.parameters():
            p.grad = torch.ones_like(p)
        o.step()
    _same(fresh.state_dict(), model.state_dict())


def test_restore_onto_a_cpu_model(tmp_path):
    """Restored tensors land on the model's device (the CPU here) and the
    Adam step counts on the host, as a fresh Adam keeps them; the file
    loads with weights_only=True."""
    model, opt = _trained()
    ckpt.save(str(tmp_path), model, opt, step=2)
    state = torch.load(tmp_path / "step_2" / ckpt.FILE, weights_only=True)
    assert state["step"] == 2 and set(state) == {"model", "optimizer",
                                                "step"}
    fresh, fopt = _trained(steps=0)
    assert ckpt.restore(str(tmp_path), fresh, fopt) == 2
    assert all(p.device.type == "cpu" for p in fresh.parameters())
    for st in fopt.state.values():
        assert st["step"].device.type == "cpu"
        assert st["exp_avg"].device.type == "cpu"


@pytest.mark.parametrize("adamw", [False, True])
def test_optax_adam_state_carries_over(adamw):
    """Three optax updates on a flax SAGE, its params and Adam (AdamW)
    state converted into the port's model and torch optimizer: the next
    update from the same gradients matches optax's at 1e-5."""
    fanouts, B = [3, 2], 8
    jm = jax_make_model("sage", hidden=8, num_classes=4, num_layers=2,
                        dropout=0.0)
    caps = block_capacities(B, fanouts)
    blocks = [JBlock(adj=None, mask=jnp.ones((caps[l][0], fanouts[l])))
              for l in range(2)]
    params = jm.init(jax.random.key(0), blocks,
                     jnp.zeros((caps[0][1], 8), jnp.float32))
    tx = (optax.adamw(1e-2, weight_decay=0.1) if adamw
          else optax.adam(1e-2))
    state = tx.init(params)
    rng = np.random.default_rng(1)

    def grads():
        return jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape).astype(np.float32)), params)

    for _ in range(3):
        updates, state = tx.update(grads(), state, params)
        params = optax.apply_updates(params, updates)
    model = make_model("sage", 8, 8, 4, 2, dropout=0.0)
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    opt = (torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=0.1)
           if adamw else torch.optim.Adam(model.parameters(), lr=1e-2))
    adam_state_from_optax(jax.device_get(state), model, opt)
    for st in opt.state.values():
        assert float(st["step"]) == 3.0
    g = grads()
    updates, _ = tx.update(g, state, params)
    want = params_from_flax(jax.device_get(optax.apply_updates(params,
                                                               updates)))
    tg = params_from_flax(jax.device_get(g))
    for name, p in model.named_parameters():
        p.grad = tg[name].clone()
    opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="Adam state"):
        adam_state_from_optax(optax.sgd(0.1).init(params), model, opt)


def _interrupt(path, step, how):
    """What a save to ``step`` leaves when it is killed before its end:
    its temporary sibling directory with a partial file (this module's
    save), or, as the port's save did before it wrote into a sibling,
    ``step_<step>/`` holding only the temporary file."""
    if how == "tmp_dir":
        tmp = os.path.join(path, f"step_{step}.tmp-123")
        os.makedirs(tmp)
        with open(os.path.join(tmp, ckpt.FILE), "wb") as fh:
            fh.write(b"PK partial")
    else:
        out = os.path.join(path, f"step_{step}")
        os.makedirs(out)
        with open(os.path.join(out, f"{ckpt.FILE}.123.tmp"), "wb") as fh:
            fh.write(b"PK partial")


@pytest.mark.parametrize("how", ["tmp_dir", "tmp_file"])
def test_interrupted_save_leaves_the_last_complete_step(tmp_path, how):
    """After save(d, m, o, 4), a save to step 8 cut short: latest_step
    stays 4 and restore loads step 4's state bitwise; JAX's latest_step
    agrees where the cut save left a temporary sibling. A later complete
    save to step 8 replaces what the cut one left and removes its
    temporary sibling."""
    model, opt = _trained()
    path = str(tmp_path)
    ckpt.save(path, model, opt, step=4)
    _interrupt(path, 8, how)
    assert ckpt.latest_step(path) == 4
    if how == "tmp_dir":
        assert jax_ckpt.latest_step(path) == 4
    fresh, fopt = _trained(steps=1)
    assert ckpt.restore(path, fresh, fopt) == 4
    _same(fresh.state_dict(), model.state_dict())
    _same(fopt.state_dict()["state"], opt.state_dict()["state"])
    ckpt.save(path, fresh, fopt, step=8)
    assert ckpt.latest_step(path) == 8
    assert os.listdir(os.path.join(path, "step_8")) == [ckpt.FILE]
    assert sorted(os.listdir(path)) == ["step_4", "step_8"]


def test_save_replaces_an_existing_step(tmp_path):
    """A second save to the same step replaces the first whole, and leaves
    no temporary directory behind."""
    model, opt = _trained(steps=1)
    other, oopt = _trained(steps=3)
    ckpt.save(str(tmp_path), model, opt, step=5)
    ckpt.save(str(tmp_path), other, oopt, step=5)
    assert os.listdir(tmp_path) == ["step_5"]
    fresh, fopt = _trained(steps=0)
    assert ckpt.restore(str(tmp_path), fresh, fopt) == 5
    _same(fresh.state_dict(), other.state_dict())


def test_save_removes_what_killed_saves_left(tmp_path):
    """A run killed between a re-save's two renames leaves its step only
    as ``step_8.old-<pid>`` (and another run's temporary sibling may
    remain): latest_step skips it and takes step 4, and the next save to
    step 8 removes every such sibling."""
    model, opt = _trained()
    path = str(tmp_path)
    ckpt.save(path, model, opt, step=4)
    ckpt.save(path, model, opt, step=8)
    os.replace(os.path.join(path, "step_8"),
               os.path.join(path, "step_8.old-99"))
    _interrupt(path, 8, "tmp_dir")
    assert ckpt.latest_step(path) == 4
    ckpt.save(path, model, opt, step=8)
    assert sorted(os.listdir(path)) == ["step_4", "step_8"]
    fresh, fopt = _trained(steps=1)
    assert ckpt.restore(path, fresh, fopt) == 8
    _same(fresh.state_dict(), model.state_dict())


@pytest.mark.parametrize("how", ["tmp_dir", "tmp_file"])
def test_resume_after_an_interrupted_save(tmp_path, capsys, how):
    """The CLI's --resume on the resident loop after a save to step 8 was
    cut short: it resumes from step 4 and trains epochs 1-2 exactly as the
    uninterrupted 3-epoch run did (test_torch_cli_flags.py's
    test_resident_resume_equals_uninterrupted_run, the cut save added)."""
    import test_torch_cli_flags as tcf

    fanout = int(tcf.synthetic_graph(num_nodes=tcf.N, avg_degree=4,
                                     feature_dim=8, num_classes=4, seed=0
                                     ).graph.in_degrees().max())
    _, params = tcf.tcr._params("sage", fanout, tcf.BATCH, tcf.DIM)
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    extra = ["--max_steps", "4", "--window", "2", "--epochs", "3"]
    run, _ = tcf._port(tcf._argv(fanout, extra=extra + ["--save_dir", full]),
                       params)
    ref = cli.train(run)["losses"]
    shutil.copytree(os.path.join(full, "step_4"),
                    os.path.join(part, "step_4"))
    _interrupt(part, 8, how)
    run, _ = tcf._port(tcf._argv(fanout, extra=extra + ["--save_dir", part,
                                                        "--resume"]), params)
    assert cli.resume(run) == 1 and run.step == 4 and not run.fresh
    got = cli.train(run)["losses"]
    np.testing.assert_array_equal(got, ref[4:])
    assert "resumed from step 4 -> starting at epoch 1" in \
        capsys.readouterr().out
    assert ckpt.latest_step(part) == 12


def test_hetero_blocks_to_device_needs_a_device():
    """No default device: the caller names it (as ``to_device_graph``)."""
    with pytest.raises(TypeError):
        th.hetero_blocks_to_device([])
