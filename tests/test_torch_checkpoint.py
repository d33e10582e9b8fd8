"""coala_gnn_tpu_torch/utils/checkpoint.py and the optax Adam state
converter of utils/convert.py: the save / ``latest_step`` / restore round
trip of tests/test_utils.py:25-42 (the JAX package's orbax checkpoint, the
same ``step_<n>`` naming), a restore onto a model on the CPU, and an optax
Adam / AdamW state carried into ``torch.optim.Adam`` / ``AdamW`` whose next
step matches optax's (1e-5)."""

import os

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
