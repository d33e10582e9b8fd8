"""The harness on the CPU, at tiny sizes: it finds cells, configurations,
traffic mixes and metric readers by name; the program's first steps agree
with the plain reference; a cell, configuration, traffic mix and metric
added as files alone run and report; and ``correct`` comes out false for
the control and for each fault the cells can have."""

import json
import os
import time

import pytest
import torch

from gnnbench import cell as C
from gnnbench import registry
from gnnbench.reference import check

SEED = 2**31 + 977


def run(root, name, seconds=0.2, traced=False, seed=SEED):
    out = C.run_cell(registry.load_cell(name, root), seed, seconds, traced,
                     "cpu", time.perf_counter())
    assert out is not None
    return out[0]


def test_cells_and_their_files_are_found_by_name():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        cell = registry.load_cell(w["name"])
        assert cell.cfg["name"] == w["config"]
        assert cell.traffic["window"] >= 1
        assert cell.limits, f"{w['name']} has no limits file"
        for trace in (False, True):
            for name, reader in cell.readers(trace).items():
                assert callable(reader.read), name
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names
        assert any(n.startswith("train_edges_per_s_per_chip") for n in names)
        assert cell.per_layer
    with pytest.raises(KeyError):
        registry.load_cell("no-such-cell")


@pytest.mark.parametrize("name", ["sage-igbm-c4g", "gat-igbm4m-c16g"])
def test_first_steps_agree_with_the_reference(tiny_root, name):
    result = run(tiny_root, name)
    assert result["correct"], result["compared"]
    cmp = result["compared"]
    for exact in check.EXACT:
        assert cmp[exact]["value"] == 0
    for near in ("loss_first", "grad_median", "update"):
        assert cmp[near]["value"] < 1e-5
    assert list(result)[-1] == "compared"
    assert result["attempted"] > 0 and result["failed"] == 0
    metrics = result["metrics"]
    rate = [v["value"] for k, v in metrics.items()
            if k.startswith("train_edges_per_s_per_chip")]
    assert len(rate) == 1 and rate[0] > 0
    assert metrics["setup_s"]["value"] > 0


def test_the_checked_steps_are_the_first_whole_window(tiny_root):
    cell = registry.load_cell("sage-igbm-c4g", tiny_root)
    bench = C.Bench(cell, SEED, torch.device("cpu"))
    bench.setup(warmup=False)
    K = int(cell.traffic["window"])
    assert K > check.CHANGE_STEPS
    assert len(bench.program["ids"]) == len(bench.program["loss"]) == K
    assert len(bench.program["digest"]) == K and bench.step == K
    assert check.first_keys(cell.traffic) == [(0, k) for k in range(K)]


def test_traced_run_reports_the_host_metrics(tiny_root):
    result = run(tiny_root, "sage-igbm-c4g", traced=True)
    assert result["correct"]
    m = result["metrics"]
    assert 0 < m["cache_hit_ratio"]["value"] < 1
    for name in ("window_ms_p95.staged", "host_gather_ms_per_window",
                 "stage_rows_per_window", "offer_ms_per_window",
                 "step_mfu_pct.staged"):
        assert m[name]["value"] > 0, name
    # no device, so nothing to read from the trace
    assert "gather_spmm_roofline.staged" not in m
    assert "device_idle_share.staged" not in m
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_regime_metric_falls_back_to_its_base_reader(tmp_path):
    m = tmp_path / "gnnbench" / "metrics"
    m.mkdir(parents=True)
    (m / "rate.py").write_text("def read(ctx):\n    return 1.0\n")
    root = str(tmp_path)
    assert registry.reader_path(root, "rate.staged") == str(m / "rate.py")
    (m / "rate.staged.py").write_text("def read(ctx):\n    return 2.0\n")
    assert registry.reader_path(root, "rate.staged") == str(
        m / "rate.staged.py")
    with pytest.raises(FileNotFoundError):
        registry.load_reader(root, "other.staged")


def test_a_cell_added_as_files_alone_runs(tiny_root, tmp_path):
    """A new configuration, traffic mix, per-layer metric and cell: new
    files and new BENCHMARK.json entries, no file edited."""
    import shutil
    root = str(tmp_path)
    shutil.copytree(os.path.join(tiny_root, "gnnbench"),
                    os.path.join(root, "gnnbench"))
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    g = os.path.join(root, "gnnbench")
    with open(os.path.join(g, "configs", "sage-igbm.json")) as f:
        cfg = json.load(f)
    cfg.update(name="sage-small", hidden_channels=8)
    with open(os.path.join(g, "configs", "sage-small.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(g, "traffic", "c4g.json")) as f:
        tr = json.load(f)
    tr.update(batch=8, fanout=[3, 2, 2])
    with open(os.path.join(g, "traffic", "small.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(g, "metrics", "steps_per_window.py"), "w") as f:
        f.write("def read(ctx):\n"
                "    return sum(w.steps for w in ctx.windows) / "
                "len(ctx.windows)\n")
    shutil.copy(os.path.join(g, "limits", "sage-igbm-c4g.json"),
                os.path.join(g, "limits", "sage-small-c1.json"))
    bench["configs"].append({"name": "sage-small",
                             "file": "gnnbench/configs/sage-small.json"})
    bench["workloads"].append({"name": "sage-small-c1",
                               "config": "sage-small", "traffic": "small",
                               "chips": 1})
    bench["per_layer"].append({"name": "steps_per_window", "unit": "steps",
                               "workloads": ["sage-small-c1"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    result = run(root, "sage-small-c1", traced=True)
    assert result["correct"], result["compared"]
    assert result["metrics"]["steps_per_window"]["value"] == tr["window"]


def _break_step(monkeypatch, how):
    """Plant a fault in the program's timed path."""
    import torch.nn.functional as F

    from coala_gnn_tpu_torch.parallel.resident import ResidentBase

    if how == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif how == "half_batch":
        def learn(self, blocks, x, y, generator):
            logits = self.model(blocks, x, train=True,
                                generator=generator)[:self.batch_size]
            half = self.batch_size // 2
            loss = F.cross_entropy(logits[:half], y[:half])
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            self.optimizer.step()
            return loss.detach(), logits.detach()
        monkeypatch.setattr(ResidentBase, "_learn", learn)
    elif how == "row_altered":
        frontier = ResidentBase._frontier

        def altered(self, *a, **kw):
            feats, n_hit, n_unres = frontier(self, *a, **kw)
            feats = feats.clone()
            feats[0] += 1.0
            return feats, n_hit, n_unres
        monkeypatch.setattr(ResidentBase, "_frontier", altered)
    elif how == "slot_altered":
        sample = ResidentBase._sample

        def altered(self, *a, **kw):
            blocks, ids, valid, safe = sample(self, *a, **kw)
            ids = ids.clone()
            ids[-1] = 0
            return blocks, ids, valid, torch.where(valid, ids, 0 * ids)
        monkeypatch.setattr(ResidentBase, "_sample", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "row_altered", "slot_altered"])
@pytest.mark.parametrize("name", ["sage-igbm-c4g", "gat-igbm4m-c16g"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, name,
                                            fault):
    _break_step(monkeypatch, fault)
    result = run(tiny_root, name, seconds=0.1)
    assert not result["correct"], (fault, result["compared"])


@pytest.mark.parametrize("name", ["sage-igbm-c4g", "gat-igbm4m-c16g"])
def test_the_control_is_not_correct(wide_root, name):
    """The reference with its matmuls in TF32, in the program's place, at
    the cells' widths, fails the cell's limits; the reference in f32
    against itself passes them."""
    cell = registry.load_cell(name, wide_root)
    bench = C.Bench(cell, SEED, torch.device("cpu"))
    bench.setup(warmup=False)
    bench.free_program()
    n, full = int(cell.cfg["num_nodes"]), cell.traffic["fill"] == "all"
    ref = check.follow(cell.cfg, cell.traffic, bench.data, bench.seed,
                       bench.vec, "cpu")
    same = check.numbers(check.as_program(ref), ref, n, False)
    assert check.compare(same, cell.limits)[0]
    assert check.compare(check.numbers(bench.program, ref, n, full),
                         cell.limits)[0]
    control = check.as_program(check.follow(
        cell.cfg, cell.traffic, bench.data, bench.seed, bench.vec, "cpu",
        precision="tf32"))
    ok, rows = check.compare(check.numbers(control, ref, n, False),
                             cell.limits)
    assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sage-igbm-c4g", "gat-igbm4m-c16g"])
def test_the_control_is_not_correct_on_a_card(wide_root, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = registry.load_cell(name, wide_root)
    dev = torch.device("cuda", 0)
    bench = C.Bench(cell, SEED, dev)
    bench.setup(warmup=False)
    bench.free_program()
    n = int(cell.cfg["num_nodes"])
    ref = check.follow(cell.cfg, cell.traffic, bench.data, bench.seed,
                       bench.vec, dev)
    control = check.as_program(check.follow(
        cell.cfg, cell.traffic, bench.data, bench.seed, bench.vec, dev,
        precision="tf32"))
    ok, rows = check.compare(check.numbers(control, ref, n, False),
                             cell.limits)
    assert not ok, rows
