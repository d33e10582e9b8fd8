"""The trainer CLI's host loop data-parallel (``--devices N``: one spawned
gloo rank per device, the CLI's rank body with the weights and optimizer
swapped in, tests/torch_multigpu_ranks.py's ``cli_runs``) against
``examples/train.py`` on a mesh of as many of the 8 virtual CPU devices,
and node_color over two hosts of two ranks against the JAX pieces wired as
JAX's multi-host run wires them. Every port-side run of one world size
shares one spawn.

Both sides start from the same params (tests/test_torch_cli_resident.py's
harness: the JAX CLI's ``model.init`` hands them out, the port loads them
converted) with dropout 0 and fanout = max in-degree, so no draw of either
side's sampler or dropout stream matters (rank r samples from a stream of
its own, where JAX samples every device from one; ROADMAP.md section C).
Per step the losses agree within 1e-5; the per-epoch hit and miss counts
(summed over the ranks) and the test accuracy lines are equal. GAT trains
with SGD on both sides (tests/test_torch_multigpu_steps.py says why)."""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

import test_torch_cli_resident as tcr
import torch_multigpu_ranks as ranks
from coala_gnn_tpu.cache import feature_cache as jfc
from coala_gnn_tpu.cache.host_tier import HostFeatureStore as JaxStore
from coala_gnn_tpu.coloring import generate_color_metadata as jax_colors
from coala_gnn_tpu.coloring import load_color_metadata as jax_load_colors
from coala_gnn_tpu.coloring import save_color_metadata as jax_save_colors
from coala_gnn_tpu.data.loader import CoalaDataLoader as JaxLoader
from coala_gnn_tpu.distribution import DistributionScheduler as JaxScheduler
from coala_gnn_tpu.distribution import SeedDistributor as JaxDistributor
from coala_gnn_tpu.graph.datasets import clustered_graph as jax_clustered
from coala_gnn_tpu.models.layers import DeviceBlock as JBlock
from coala_gnn_tpu.parallel import train as jtrain
from coala_gnn_tpu.parallel.mesh import make_mesh
from coala_gnn_tpu.parallel.sharded_cache import \
    ShardedFeatureCache as JaxCache
from coala_gnn_tpu.sampling.neighbor import NeighborSampler as JaxSampler
from coala_gnn_tpu_torch import train as cli
from coala_gnn_tpu_torch.graph.datasets import clustered_graph
from coala_gnn_tpu_torch.parallel.multihost import launch
from coala_gnn_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(1)

TOL = tcr.TOL
N_NODES, DIM, BATCH, FANOUT = 800, 16, 16, 12   # FANOUT: max in-degree
NC_STEPS, NC_REFRESH = 8, 2       # the node_color run's steps and refresh

CASES = {
    # name: (ranks, model, flags)
    "sage-2-sharded": (2, "sage", ["--epochs", "2", "--max_steps", "3",
                                   "--eval"]),
    # node_local over the one host's 4 ranks (JAX's group of the local
    # devices); sharded over 2 hosts of 2 ranks is the node_color run's
    "sage-4-node_local-int8-mask_tail": (4, "sage", [
        "--cache_backend", "node_local", "--quantize", "--mask_tail",
        "--batch_size", "20", "--max_steps", "5", "--eval"]),
    "gat-2-isolated": (2, "gat", ["--cache_backend", "isolated",
                                  "--max_steps", "3"]),
}


def _argv(kind, extra):
    argv = tcr._flags(N_NODES, DIM, BATCH, FANOUT, kind, extra)
    i = argv.index("--pipeline")
    return argv[:i] + argv[i + 2:]


def _jax_main(argv, n, jm, params, sgd, monkeypatch, capsys):
    """``examples/train.py``'s ``main`` with ``--devices n`` on the CPU
    mesh, its model's ``init`` handing out ``params`` and its steps
    recorded. -> (losses, printed lines)."""
    import coala_gnn_tpu.models as jmodels
    import coala_gnn_tpu.utils.jaxconfig as jconfig

    jcli = tcr._jax_cli()
    monkeypatch.setattr(jconfig, "setup", lambda *a, **k: None)
    monkeypatch.setattr(jmodels, "make_model",
                        lambda *a, **k: tcr._FixedInit(jm, params))
    if sgd:
        sgd_fn = optax.sgd
        monkeypatch.setattr(optax, "adam", lambda lr, **k: sgd_fn(lr))
    losses = []
    make_step = jtrain.make_sharded_train_step

    def recorded_step(*a, **k):
        fn = make_step(*a, **k)

        def run(*aa, **kk):
            out = fn(*aa, **kk)
            losses.append(float(out[2]))
            return out
        return run

    monkeypatch.setattr(jtrain, "make_sharded_train_step", recorded_step)
    capsys.readouterr()
    jcli.main(argv + ["--devices", str(n)])
    out = capsys.readouterr().out
    monkeypatch.undo()
    return np.asarray(losses), out


def _hit_line(s):
    return (f"Cache hit ratio: {s['hit_ratio']:.3f} ({s['hits']} hits / "
            f"{s['misses']} misses)")


@functools.lru_cache(maxsize=None)
def _params(kind):
    return tcr._params(kind, FANOUT, BATCH, DIM)


def _state(kind):
    return params_from_flax(jax.device_get(_params(kind)[1]))


def _names(n):
    return [c for c in sorted(CASES) if CASES[c][0] == n]


def _cli_args(name):
    n, kind, extra = CASES[name]
    return cli.parse_args(["--device", "cpu"] + _argv(kind, extra)
                          + ["--devices", str(n)])


def _node_color_args(path):
    return cli.parse_args([
        "--device", "cpu", "--devices", "4", "--feature_dim", str(DIM),
        "--num_classes", "4", "--batch_size", str(BATCH), "--fan_out",
        f"{FANOUT},{FANOUT}", "--hidden_channels", "8", "--learning_rate",
        "0.01", "--cache_size", "1", "--max_steps", str(NC_STEPS),
        "--distribution", "node_color", "--color_dir", path,
        "--refresh_counter", str(NC_REFRESH)])


@pytest.fixture(scope="module")
def clustered(tmp_path_factory):
    """The clustered graph (both packages' copies) and the JAX package's
    color metadata of it."""
    kw = dict(num_nodes=2000, num_communities=8, avg_degree=4,
              feature_dim=DIM, num_classes=4, seed=0)
    ds, jds = clustered_graph(**kw), jax_clustered(**kw)
    path = str(tmp_path_factory.mktemp("colors"))
    jax_save_colors(jax_colors(jds.graph, jds.train_idx), path)
    return ds, jds, path


@pytest.fixture(scope="module")
def port(clustered):
    """fn(n) -> [rank] -> [run] records of the port's runs on ``n``
    spawned gloo ranks: the CASES of world ``n`` in ``_names(n)``'s order,
    at 4 ranks then the node_color run (hosts of 2 ranks, the loader in
    the caller's thread). One spawn per world size, made at first use."""
    done = {}

    def get(n):
        if n not in done:
            runs = [dict(args=_cli_args(name),
                         state_dict=_state(CASES[name][1]),
                         optimizer=functools.partial(torch.optim.SGD,
                                                     lr=0.01)
                         if CASES[name][1] == "gat" else None)
                    for name in _names(n)]
            if n == 4:
                ds, _, path = clustered
                runs.append(dict(args=_node_color_args(path),
                                 state_dict=_state("sage"), local_size=2,
                                 prefetch=0, ds=ds))
            done[n] = launch(ranks.cli_runs, n, ["cpu"] * n, "gloo",
                             threads=1, args=(runs,))
        return done[n]

    return get


@pytest.mark.parametrize("name", sorted(CASES))
def test_cli_devices_matches_jax(name, port, monkeypatch, capsys):
    n, kind, extra = CASES[name]
    args = _cli_args(name)
    cli.refuse_unported(args)
    assert cli.rank_devices(args) == ["cpu"] * n
    jm, params = _params(kind)
    want, jax_out = _jax_main(_argv(kind, extra), n, jm, params,
                              kind == "gat", monkeypatch, capsys)
    i = _names(n).index(name)
    got = [r[i] for r in port(n)]
    assert [g["rank"] for g in got] == list(range(n))
    assert len(want) > 0 and np.isfinite(want).all()
    for g in got:
        np.testing.assert_allclose(g["losses"], want, **TOL)
        assert [_hit_line(s) for s in g["stats"]] == \
            tcr._lines(jax_out, "Cache hit ratio")
        if args.eval:
            c, t = g["eval"]
            assert [f"Test accuracy: {c / t:.4f} ({t} nodes)"] == \
                tcr._lines(jax_out, "Test accuracy")
        # every rank trained on its own blocks through the data-parallel
        # step (the gradient all-reduce once a step)
        assert g["ledger"]["calls"]["grad"] == len(want)
        assert g["edges"] > 0
    if "mask_tail" in name:
        # 480 train nodes in global batches of 80: no tail; the flag runs
        # the masked step on every step all the same
        assert all(g["ledger"]["calls"]["control"] >= len(want) for g in got)


class _AllParts(JaxScheduler):
    """A JAX scheduler that hands out every part's slice of an iteration
    (part-major: device d = part d // 2, its rank d % 2), as two JAX host
    processes together would train it."""

    def _distribute(self, it):
        out, valid = self.d.distribute(it, self._meta, return_valid=True)
        self._next_domain = out.reshape(-1)
        self._next_valid = valid.reshape(-1)


def _jax_two_hosts(jds, path, jm, params, steps, rc):
    """The JAX pieces of examples/train.py's host loop on 2 hosts x 2
    devices: node_color over 2 parts, each host's cache-meta the sum of its
    devices' color counters; one loader for all 4 devices, prefetch 0."""
    meta = jax_load_colors(path)
    mesh = make_mesh(jax.devices()[:4])
    cache = JaxCache(cfg=jfc.make_config(cache_mb=1, dim=DIM,
                                         num_colors=meta.num_colors,
                                         num_shards=4), mesh=mesh)
    dist = JaxDistributor(jds.train_idx, batch_size=BATCH, local_size=2,
                          num_parts=2, mode="node_color", color=meta.color,
                          topk_colors=meta.topk, affinity=meta.score,
                          shuffle_seed=0)
    c1 = meta.num_colors + 1
    sched = _AllParts(dist, part_id=0, local_rank=0,
                      meta_fn=lambda: np.asarray(cache.state.color_counts),
                      meta_exchange_fn=lambda m: m.reshape(2, 2, c1).sum(1),
                      refresh_counter=rc)
    loader = JaxLoader(scheduler=sched, sampler=JaxSampler(
        jds.graph, [FANOUT, FANOUT], BATCH, seed=0), labels=jds.labels,
        local_size=4, prefetch=0)
    tx = optax.adam(0.01)
    opt_state = tx.init(params)
    step = jtrain.make_sharded_train_step(jm, tx, mesh, BATCH)
    store = JaxStore(jds.features)
    losses, domains = [], []
    for _, hb in zip(range(steps), loader):
        domains.append(hb.seeds.reshape(2, 2 * BATCH))
        blocks = [JBlock(adj=a, mask=m) for a, m in zip(hb.adjs, hb.masks)]
        x = cache.fetch(hb.input_ids, hb.num_input, store.fetch,
                        colors=meta.color)
        params, opt_state, loss, _ = step(params, opt_state,
                                          jax.random.key(0), blocks, x,
                                          hb.labels)
        losses.append(float(loss))
    return np.asarray(losses), cache.stats(), domains, dist


def test_node_color_two_hosts_matches_jax(clustered, port):
    """--distribution node_color on 2 hosts of 2 ranks (``local_size`` 2):
    each host's part is scored against the sum of its ranks' color
    counters, exchanged every ``--refresh_counter`` steps over the gloo
    meta group; the sharded cache spans all 4 ranks. The loaders run in
    the caller's thread (prefetch 0) on both sides, so the counters are
    read at the same step; losses 1e-5, hit counts equal, and the seed
    split leaves the plain striping once the counters fill."""
    ds, jds, path = clustered
    jm, params = _params("sage")
    want, jstats, jdomains, jdist = _jax_two_hosts(jds, path, jm, params,
                                                   NC_STEPS, NC_REFRESH)
    for g in (r[-1] for r in port(4)):
        np.testing.assert_allclose(g["losses"], want, **TOL)
        assert g["stats"][-1] == jstats
        assert g["ledger"]["calls"]["meta"] == -(-NC_STEPS // NC_REFRESH)
    window = [jdist.items[i * jdist.global_batch:(i + 1) * jdist.global_batch]
              .reshape(2, -1) for i in range(NC_STEPS)]
    assert any(not np.array_equal(np.sort(a, 1), np.sort(b, 1))
               for a, b in zip(jdomains, window))
