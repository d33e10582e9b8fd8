"""The data-parallel steps over 2 and 4 ranks (``parallel/train.py``:
``make_sharded_train_step`` masked and unmasked, ``make_sharded_eval_step``
with the count and per slot) against the JAX package's on a mesh of as
many of the 8 virtual CPU devices, and the gradient all-reduce's bytes.

Every rank gets its row of the same sampled batches (the port's host
sampler, numpy, fanouts [4, 3]); the models start from the JAX params,
converted, with dropout 0. SAGE trains with Adam; GAT with SGD, since the
softmax over its slots leaves the last layer's attn_r gradient at rounding
noise, which Adam turns into steps of random sign
(tests/test_torch_resident.py). The masked step's last batch has a third
of every rank's seeds invalid. Losses and accuracies (the same on every
rank), and the parameters after the steps, agree with JAX's within 1e-5;
the eval counts and per-slot grids are equal. The port's ranks run in
spawned gloo processes (tests/torch_multigpu_ranks.py), one spawn per
world size."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_multigpu_ranks as ranks
from coala_gnn_tpu.models import make_model as jax_make_model
from coala_gnn_tpu.models.layers import DeviceBlock as JBlock
from coala_gnn_tpu.parallel import train as jtrain
from coala_gnn_tpu.parallel.mesh import make_mesh
from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
from coala_gnn_tpu_torch.parallel import comm_model
from coala_gnn_tpu_torch.parallel.multihost import launch
from coala_gnn_tpu_torch.sampling.neighbor import NeighborSampler
from coala_gnn_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B, FANOUTS, DIM, HIDDEN, CLASSES, STEPS, LR = 16, [4, 3], 16, 8, 4, 4, 0.01
KINDS = [("sage", False), ("sage", True), ("gat", False), ("gat", True)]
PARAMS = [(n, k, m) for n in (2, 4) for k, m in KINDS]


@functools.lru_cache(maxsize=None)
def _batches(n: int) -> list:
    """STEPS steps of n rows each: (blocks [(adj, mask) [n, ...]], x [n,
    cap_src, dim], labels [n, B], valid [n, B]), the last step's valid a
    third false."""
    ds = synthetic_graph(num_nodes=1500, avg_degree=6, feature_dim=DIM,
                         num_classes=CLASSES, seed=4)
    sampler = NeighborSampler(ds.graph, FANOUTS, B, seed=2,
                              use_native=False)
    steps = []
    for s in range(STEPS):
        rows = [sampler.sample(ds.train_idx[(s * n + d) * B:
                                            (s * n + d + 1) * B])
                for d in range(n)]
        blocks = [(np.stack([b.blocks[l].adj for b in rows]),
                   np.stack([b.blocks[l].mask for b in rows]))
                  for l in range(len(FANOUTS))]
        valid = np.ones((n, B), bool)
        if s == STEPS - 1:
            valid[:, ::3] = False
        steps.append((blocks, np.stack([ds.features[b.input_ids]
                                        for b in rows]),
                      np.stack([ds.labels[b.seeds] for b in rows]
                               ).astype(np.int32), valid))
    return steps


@functools.lru_cache(maxsize=None)
def _init(kind: str):
    jm = jax_make_model(kind, hidden=HIDDEN, num_classes=CLASSES,
                        num_layers=2, num_heads=2, dropout=0.0)
    blocks, x, _, _ = _batches(2)[0]
    params = jm.init(jax.random.key(0),
                     [JBlock(adj=jnp.asarray(a[0]), mask=jnp.asarray(m[0]))
                      for a, m in blocks], jnp.asarray(x[0]))
    return jm, params


def _cases(n: int) -> list:
    out = []
    for kind, masked in KINDS:
        _, params = _init(kind)
        out.append(dict(
            make=functools.partial(ranks.port_model, kind, DIM, HIDDEN,
                                   CLASSES,
                                   params_from_flax(jax.device_get(params))),
            opt=torch.optim.SGD if kind == "gat" else torch.optim.Adam,
            lr=LR, batch=B, masked=masked, steps=_batches(n)))
    return out


@functools.lru_cache(maxsize=None)
def _port(n: int) -> list:
    return launch(ranks.step_cases, n, ["cpu"] * n, "gloo", threads=1,
                  args=(_cases(n),))


def _jax_blocks(blocks):
    return [JBlock(adj=jnp.asarray(a), mask=jnp.asarray(m))
            for a, m in blocks]


@pytest.mark.parametrize("n,kind,masked", PARAMS)
def test_sharded_steps_match_jax(n, kind, masked):
    jm, params = _init(kind)
    tx = optax.sgd(LR) if kind == "gat" else optax.adam(LR)
    opt_state = tx.init(params)
    mesh = make_mesh(jax.devices()[:n])
    jstep = jtrain.make_sharded_train_step(jm, tx, mesh, B, masked=masked)
    key = jax.random.key(5)
    losses, accs = [], []
    for blocks, x, labels, valid in _batches(n):
        extra = (jnp.asarray(valid),) if masked else ()
        params, opt_state, loss, acc = jstep(
            params, opt_state, key, _jax_blocks(blocks), jnp.asarray(x),
            jnp.asarray(labels), *extra)
        losses.append(float(loss))
        accs.append(float(acc))
    i = KINDS.index((kind, masked))
    want = params_from_flax(jax.device_get(params))
    blocks, x, labels, _ = _batches(n)[0]
    jcount = jtrain.make_sharded_eval_step(jm, mesh, B)(
        params, _jax_blocks(blocks), jnp.asarray(x), jnp.asarray(labels))
    jslots = jtrain.make_sharded_eval_step(jm, mesh, B, per_slot=True)(
        params, _jax_blocks(blocks), jnp.asarray(x), jnp.asarray(labels))
    for r in range(n):
        got = _port(n)[r][i]
        np.testing.assert_allclose(got["losses"], losses, **TOL)
        np.testing.assert_allclose(got["accs"], accs, atol=1e-6)
        assert set(got["params"]) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got["params"][k], v.numpy(), **TOL,
                                       err_msg=k)
        assert got["count"] == int(jcount)
        np.testing.assert_array_equal(got["slots"][0],
                                      np.asarray(jslots)[r])
    assert len(set(_port(n)[r][i]["losses"][-1] for r in range(n))) == 1


@pytest.mark.parametrize("n", [2, 4])
def test_gradient_all_reduce_bytes(n):
    """One all-reduce per step of every parameter's gradient (f32) with the
    loss and the accuracy appended; the masked step adds one 4-byte
    all-reduce of its seed count. ``comm_model.grad_psum_bytes`` models
    the same payload as a ring."""
    for i, (kind, masked) in enumerate(KINDS):
        for r in range(n):
            got = _port(n)[r][i]
            pb = got["param_bytes"]
            led = got["ledger"]
            assert led["calls"]["grad"] == STEPS
            assert led["handed"]["grad"] == STEPS * (pb + 8)
            assert led["handed"].get("control", 0) == (4 * STEPS if masked
                                                       else 0)
            model = comm_model.step_traffic("sharded", 64, n_dev=n, local=n,
                                            dim=DIM, param_bytes=pb)
            assert model["grad_psum"]["off_device"] == int(
                2 * (n - 1) / n * pb)
