"""The port's entry points (``coala_gnn_tpu_torch.entry``) against
``__graft_entry__.py``: ``entry()``'s sampled batch bitwise JAX's and its
logits JAX's at 1e-5 with JAX's params carried across by
``utils/convert.py``; ``dryrun_multichip(1)`` on the CPU, its host path's
cache counters equal to the JAX dry run's at one device with the same
cache and global batch (64 sets, 64 seeds a step: what JAX's 8-device run
spreads over its devices), whose sharded-topology leg cannot run on one
device; ``dryrun_multichip(2)`` and ``(4)`` on spawned CPU ranks over gloo,
each leg with JAX's checks (the sharded topology and node_local too), and
JAX's dry run with the same shapes on a mesh of 2 virtual devices passing
its own (rank r > 0 samples from a stream of its own, where JAX
samples every device from one, so the counters are not compared)."""

import os
import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from coala_gnn_tpu_torch import entry
from coala_gnn_tpu_torch.utils.convert import params_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def test_entry_logits_match_jax():
    fn, (params, blocks, x) = entry.entry("cpu")
    jfn, (jparams, jblocks, jx) = jentry.entry()
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    for b, jb in zip(blocks, jblocks):
        np.testing.assert_array_equal(b.adj.numpy(), np.asarray(jb.adj))
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(jb.mask))
    converted = params_from_flax(jax.device_get(jparams))
    assert set(converted) == set(params)
    got = fn(converted, blocks, x)
    want = np.asarray(jax.jit(jfn)(jparams, jblocks, jx))
    assert got.shape == want.shape == (32, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the model's own parameters give finite logits of the same shape
    own = fn(params, blocks, x)
    assert own.shape == (32, 8) and torch.isfinite(own).all()


def _jax_dryrun_one_device():
    """``__graft_entry__.dryrun_multichip`` at one device with the port's
    cache and batch (its source with the two constants replaced)."""
    with open(os.path.join(ROOT, "__graft_entry__.py")) as f:
        src = f.read()
    src, n = re.subn(r"num_sets=8,", f"num_sets={entry.DRYRUN_SETS},", src)
    assert n == 1
    src, n = re.subn(r"B, fanouts, dim = 8,",
                     f"B, fanouts, dim = {entry.DRYRUN_BATCH},", src)
    assert n == 1
    ns = {"__name__": "jax_dryrun", "__file__": jentry.__file__}
    exec(compile(src, jentry.__file__, "exec"), ns)
    return ns["dryrun_multichip"]


def test_dryrun_one_device_matches_jax_host_path(capsys):
    got = entry.dryrun_multichip(1, device="cpu")
    out = capsys.readouterr().out
    assert "host path: ok" in out and "resident path: ok" in out
    assert "legs need more than one rank" in out
    assert got["host"]["hit_ratio"] > 0.5 and got["window"]["hit_ratio"] > 0.5
    assert np.isfinite(got["window_losses"]).all()
    assert 0 <= got["eval_correct"] <= entry.DRYRUN_BATCH

    # JAX's dry run at one device: the same host-path counters (the host
    # sampler, the distributor and the cache are bitwise the port's); its
    # resident path passes too, its sharded-topology leg has nothing to
    # shard on one device
    with pytest.raises(IndexError):
        _jax_dryrun_one_device()(1)
    jout = capsys.readouterr().out
    host = re.search(r"host path: ok.*cache (\{.*\})", jout).group(1)
    assert eval(host)["hits"] == got["host"]["hits"]
    assert eval(host)["misses"] == got["host"]["misses"]
    assert "resident path: ok" in jout


def _jax_dryrun(n):
    """``__graft_entry__.dryrun_multichip`` with the port's shapes at ``n``
    ranks (its source with the two constants replaced)."""
    per = max(1, 8 // n)
    with open(os.path.join(ROOT, "__graft_entry__.py")) as f:
        src = f.read()
    src, k = re.subn(r"num_sets=8, ways",
                     f"num_sets={entry.DRYRUN_SETS // 8 * per}, ways", src)
    assert k == 1
    src, k = re.subn(r"B, fanouts, dim = 8,",
                     f"B, fanouts, dim = {entry.DRYRUN_BATCH // 8 * per},",
                     src)
    assert k == 1
    ns = {"__name__": "jax_dryrun", "__file__": jentry.__file__}
    exec(compile(src, jentry.__file__, "exec"), ns)
    return ns["dryrun_multichip"]


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_over_ranks(n, capsys):
    """All four legs on n CPU ranks (the node_local leg over two hosts of
    n / 2), each with JAX's checks; at n = 2 JAX's dry run at the same
    shapes on 2 virtual devices passes its four legs too."""
    got = entry.dryrun_multichip(n, device="cpu", timeout=120)
    assert got["host"]["hit_ratio"] > 0.5 and got["window"]["hit_ratio"] > 0.5
    assert got["node_local"]["hit_ratio"] == 1.0
    assert got["edges_per_rank"] < 12000
    assert np.isfinite(got["topology_window_losses"]).all()
    assert 0 <= got["eval_correct"] <= entry.DRYRUN_BATCH
    if n != 2:
        return
    capsys.readouterr()
    _jax_dryrun(n)(n)
    jout = capsys.readouterr().out
    for leg in ("host path", "resident path", "sharded-topology path",
                "node_local path"):
        assert f"dryrun_multichip({n}) {leg}: ok" in jout


def test_entry_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry.entry()
