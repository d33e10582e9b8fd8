"""The harness on the CPU, at tiny sizes: it finds cells, configurations,
traffic mixes, metric readers and models by name; the program's first
steps agree with the plain reference; a cell, configuration, traffic mix
and metric added as files alone run and report, and so do relational
models on a typed graph; and ``correct`` comes out false for the control,
for each fault the cells can have and for a slot's relation altered."""

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
        assert callable(cell.model.layer)
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


#: relational models the port trains (``models/hetero.py``), written as a
#: later configuration would bring them: plain torch, one file each
RSAGE = '''"""RSAGE, plain, after the port's ``RelSAGEConv``: fc_self(h_dst)
plus, for each relation r in order, fc_neigh_r{r} of the mean of the rows
of the slots live in r (``mask * (rel == r)``). Departure: the relations'
plane sums in a loop (the port's contiguous layout does the same)."""
import torch
from gnnbench.reference import model as M

TRANSFORM_ROWS = "dst"


def rels(cfg):
    return int(cfg["graph"]["num_edge_types"])


def param_shapes(cfg):
    shapes = {}
    for layer, (d_in, d_out) in enumerate(M.dims(cfg)):
        p = f"layer_{layer}."
        shapes[p + "fc_self.weight"] = (d_out, d_in)
        shapes[p + "fc_self.bias"] = (d_out,)
        for r in range(rels(cfg)):
            shapes[p + f"fc_neigh_r{r}.weight"] = (d_out, d_in)
    return shapes


def layer(p, pre, h, block, precision):
    cap_dst, f = block.mask.shape
    out = (M.matmul(h[:cap_dst], p[pre + "fc_self.weight"].T, precision)
           + p[pre + "fc_self.bias"])
    r = 0
    while pre + f"fc_neigh_r{r}.weight" in p:
        m = block.mask * (block.rel == r)
        s = (M.planes(h, cap_dst, f) * m.T[:, :, None]).sum(0)
        mean = s / m.sum(1).clamp(min=1.0)[:, None]
        out = out + M.matmul(mean, p[pre + f"fc_neigh_r{r}.weight"].T,
                             precision)
        r += 1
    return out


def readout(h):
    return h


def flags(cfg):
    return []


def step_flops(cfg, rows):
    return sum((1 + rels(cfg)) * (2 if layer == 0 else 3) * 2 * n * a * b
               for layer, ((a, b), n) in enumerate(zip(M.dims(cfg), rows)))
'''

RGAT = '''"""RGAT, plain, after the port's ``RelGATConv``: per relation r,
feat_r = fc_r{r}(h) [n, H, F]; e = leaky_relu(<feat_src, attn_l_r{r}> +
<feat_dst, attn_r_r{r}>, 0.2) over the slots live in r, a softmax over
them, alpha times the mask; the slots' feat_r summed with alpha, the heads
meaned in the layer; the relations summed in order. Departures: the
scores as dots with feat (the port folds attn into fc's weight), and the
relations in a loop (the port stacks them in one gather-SpMM launch)."""
import torch
from gnnbench.reference import model as M

TRANSFORM_ROWS = "src"


def rels(cfg):
    return int(cfg["graph"]["num_edge_types"])


def param_shapes(cfg):
    heads, shapes = int(cfg["num_heads"]), {}
    for layer, (d_in, d_out) in enumerate(M.dims(cfg)):
        p = f"layer_{layer}."
        for r in range(rels(cfg)):
            shapes[p + f"fc_r{r}.weight"] = (heads * d_out, d_in)
            shapes[p + f"attn_l_r{r}"] = (heads, d_out)
            shapes[p + f"attn_r_r{r}"] = (heads, d_out)
    return shapes


def layer(p, pre, h, block, precision):
    cap_dst, f = block.mask.shape
    out, r = 0, 0
    while pre + f"fc_r{r}.weight" in p:
        heads, d_out = p[pre + f"attn_l_r{r}"].shape
        feat = M.matmul(h, p[pre + f"fc_r{r}.weight"].T, precision).view(
            h.shape[0], heads, d_out)
        el = (feat * p[pre + f"attn_l_r{r}"]).sum(-1)
        er = (feat[:cap_dst] * p[pre + f"attn_r_r{r}"]).sum(-1)
        e = torch.nn.functional.leaky_relu(
            M.planes(el, cap_dst, f).permute(1, 0, 2) + er[:, None, :], 0.2)
        m = (block.mask * (block.rel == r))[:, :, None]
        e = torch.where(m > 0, e, torch.full_like(e, -1e9))
        alpha = torch.softmax(e, dim=1) * m
        nbr = M.planes(feat, cap_dst, f)
        out = out + (alpha.permute(1, 0, 2)[..., None] * nbr).sum(0).mean(1)
        r += 1
    return out


def readout(h):
    return h


def flags(cfg):
    return ["--num_heads", str(cfg["num_heads"])]


def step_flops(cfg, rows):
    heads = int(cfg["num_heads"])
    return sum(rels(cfg) * (2 if layer == 0 else 3) * 2 * n * a * heads * b
               for layer, ((a, b), n) in enumerate(zip(M.dims(cfg), rows)))
'''

TYPED_GRAPH = '''"""graphgen's graph, each edge given one of the
configuration's ``graph.num_edge_types`` relations, drawn from the seed."""
import torch
from gnnbench import graphgen

TYPES = 5           # a generator stream of its own


def make_dataset(cfg, seed, device):
    out = graphgen.make_dataset(cfg, seed, device)
    n = int(cfg["graph"]["num_edge_types"])
    gen = graphgen.generator(seed, TYPES, device)
    out["edge_types"] = torch.randint(
        n, (out["indices"].size,), generator=gen, device=device,
        dtype=torch.int32).cpu().numpy()
    out["num_edge_types"] = n
    return out
'''

#: (model, the real cell whose traffic, limits and metrics it takes) of
#: the typed cells: one under cache pressure, one at full coverage
TYPED = {"rgat-typed-c4g": ("rgat", "sage-igbm-c4g"),
         "rsage-typed-c16g": ("rsage", "gat-igbm4m-c16g")}


@pytest.fixture(scope="module")
def typed_root(tiny_root, tmp_path_factory):
    """``tiny_root`` with typed cells added as files alone: model modules,
    a graph module, configurations, traffic mixes, limits and
    BENCHMARK.json entries. Two relations and fanouts of 6 give each
    relation's softmax enough live slots that no attention vector's first
    gradient is at rounding level (with fanouts 4,3,2 and three relations
    some are, and Adam turns their rounding into steps of +-lr)."""
    import shutil
    root = str(tmp_path_factory.mktemp("typed"))
    g = os.path.join(root, "gnnbench")
    shutil.copytree(os.path.join(tiny_root, "gnnbench"), g)
    with open(os.path.join(tiny_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, text in (("models/rsage", RSAGE), ("models/rgat", RGAT),
                       ("graphs/typed", TYPED_GRAPH)):
        os.makedirs(os.path.dirname(os.path.join(g, name)), exist_ok=True)
        with open(os.path.join(g, name + ".py"), "w") as f:
            f.write(text)
    with open(os.path.join(g, "configs", "sage-igbm.json")) as f:
        base = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    for cell, (model, like) in TYPED.items():
        cfg = dict(base, name=model + "-typed", model=model, num_heads=2)
        cfg["graph"] = dict(base["graph"], generator="typed",
                            num_edge_types=2)
        with open(os.path.join(g, "configs", model + ".json"), "w") as f:
            json.dump(cfg, f)
        with open(os.path.join(g, "traffic",
                               cells[like]["traffic"] + ".json")) as f:
            tr = json.load(f)
        with open(os.path.join(g, "traffic", cell + ".json"), "w") as f:
            json.dump(dict(tr, fanout=[6, 6, 6]), f)
        shutil.copy(os.path.join(g, "limits", like + ".json"),
                    os.path.join(g, "limits", cell + ".json"))
        bench["configs"].append({"name": cfg["name"],
                                 "file": f"gnnbench/configs/{model}.json"})
        bench["workloads"].append({"name": cell, "config": cfg["name"],
                                   "traffic": cell, "chips": 1})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.mark.parametrize("name", sorted(TYPED))
def test_a_typed_cell_added_as_files_alone_runs(typed_root, name):
    """A relational model on a typed graph, brought as new files only,
    trains through the program and agrees with the plain reference, its
    slots' relations compared exactly."""
    cell = registry.load_cell(name, typed_root)
    assert cell.dataset.__name__.startswith("gnnbench_graphs_")
    result = run(typed_root, name, traced=True)
    assert result["correct"], result["compared"]
    cmp = result["compared"]
    for exact in check.EXACT:
        assert cmp[exact]["value"] == 0
    for near in ("loss_first", "grad_median", "update"):
        assert cmp[near]["value"] < 1e-5
    assert result["metrics"]["step_mfu_pct" + (
        ".staged" if name.endswith("c4g") else "")]["value"] > 0


def test_a_relation_altered_in_a_sampled_block_is_not_correct(
        typed_root, monkeypatch):
    from coala_gnn_tpu_torch.parallel.resident import ResidentBase

    sample = ResidentBase._sample

    def altered(self, *a, **kw):
        blocks, ids, valid, safe = sample(self, *a, **kw)
        b = blocks[0]
        i, k = (b.mask > 0).nonzero()[0].tolist()
        rel = b.rel.clone()
        rel[i, k] = 1 - rel[i, k]
        return [b._replace(rel=rel), *blocks[1:]], ids, valid, safe
    monkeypatch.setattr(ResidentBase, "_sample", altered)
    result = run(typed_root, "rgat-typed-c4g", seconds=0.1)
    assert result["compared"]["blocks"]["value"] > 0
    assert not result["correct"]


def test_an_unknown_model_is_named_by_its_path(tiny_root, tmp_path):
    import shutil
    root = str(tmp_path)
    shutil.copytree(os.path.join(tiny_root, "gnnbench"),
                    os.path.join(root, "gnnbench"))
    shutil.copy(os.path.join(tiny_root, "BENCHMARK.json"), root)
    path = os.path.join(root, "gnnbench", "configs", "sage-igbm.json")
    with open(path) as f:
        cfg = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(cfg, model="nope"), f)
    with pytest.raises(FileNotFoundError,
                       match=os.path.join("gnnbench", "models", "nope.py")):
        registry.load_cell("sage-igbm-c4g", root)


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
    ref = check.follow(cell, bench.data, bench.seed, bench.vec, "cpu")
    same = check.numbers(check.as_program(ref), ref, n, False)
    assert check.compare(same, cell.limits)[0]
    assert check.compare(check.numbers(bench.program, ref, n, full),
                         cell.limits)[0]
    control = check.as_program(check.follow(
        cell, bench.data, bench.seed, bench.vec, "cpu", precision="tf32"))
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
    ref = check.follow(cell, bench.data, bench.seed, bench.vec, dev)
    control = check.as_program(check.follow(
        cell, bench.data, bench.seed, bench.vec, dev, precision="tf32"))
    ok, rows = check.compare(check.numbers(control, ref, n, False),
                             cell.limits)
    assert not ok, rows
