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


def readout(p, h):
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


def readout(p, h):
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

def write_modules(root, modules):
    """``{path under gnnbench/ without .py: source}`` written into
    ``root``."""
    for path, text in modules.items():
        path = os.path.join(root, "gnnbench", path + ".py")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)


def add_cell(root, name, cfg, like, **traffic):
    """Cell ``name`` added to ``root`` as files: ``cfg`` as its
    configuration, ``like``'s traffic mix with ``traffic``'s keys changed,
    ``like``'s limits, its entries in BENCHMARK.json, and in every metric
    that ``like`` reports."""
    import shutil
    g = os.path.join(root, "gnnbench")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    config = f"gnnbench/configs/{cfg['name']}.json"
    with open(os.path.join(root, config), "w") as f:
        json.dump(cfg, f)
    mix = next(w["traffic"] for w in bench["workloads"] if w["name"] == like)
    with open(os.path.join(g, "traffic", mix + ".json")) as f:
        tr = json.load(f)
    with open(os.path.join(g, "traffic", name + ".json"), "w") as f:
        json.dump(dict(tr, **traffic), f)
    shutil.copy(os.path.join(g, "limits", like + ".json"),
                os.path.join(g, "limits", name + ".json"))
    bench["configs"].append({"name": cfg["name"], "file": config})
    bench["workloads"].append({"name": name, "config": cfg["name"],
                               "traffic": name, "chips": 1})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


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
    shutil.copy(os.path.join(tiny_root, "BENCHMARK.json"), root)
    write_modules(root, {"models/rsage": RSAGE, "models/rgat": RGAT,
                         "graphs/typed": TYPED_GRAPH})
    with open(os.path.join(g, "configs", "sage-igbm.json")) as f:
        base = json.load(f)
    for cell, (model, like) in TYPED.items():
        cfg = dict(base, name=model + "-typed", model=model, num_heads=2)
        cfg["graph"] = dict(base["graph"], generator="typed",
                            num_edge_types=2)
        add_cell(root, cell, cfg, like, fanout=[6, 6, 6])
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


# -- a model's own activation, a readout with parameters, node types --------

def _old_forward(model, cfg, p, x0, blocks, gen, batch, readout):
    """The layer loop as it stood before a model could give ``activate``
    and before ``readout`` took the parameters: ReLU between layers, the
    old ``readout(h)``."""
    rate, h = float(cfg["dropout"]), x0
    for layer, block in enumerate(blocks):
        h = model.layer(p, f"layer_{layer}.", h, block, "float32")
        if layer == len(blocks) - 1:
            return readout(h)[:batch]
        h = torch.relu(h.reshape(h.shape[0], -1))
        keep = torch.rand(h.shape, generator=gen) < 1.0 - rate
        h = torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))


#: the readouts of ``models/sage.py`` and ``models/gat.py`` as ``readout(h)``
OLD_READOUT = {"sage-igbm-c4g": lambda h: h,
               "gat-igbm4m-c16g": lambda h: h.mean(1)}


@pytest.mark.parametrize("name", sorted(OLD_READOUT))
def test_relu_by_default_by_name_and_the_old_loop_agree_bitwise(
        tiny_root, name):
    """A module without ``activate``, the same module declaring
    ``activate = torch.relu``, and the old loop with ``readout(h)`` give
    the same logits and first gradients, bit for bit."""
    import types

    from gnnbench.reference import model as M
    from gnnbench.reference import sampler as S

    cell = registry.load_cell(name, tiny_root)
    cfg, tr, model = cell.cfg, cell.traffic, cell.model
    assert not hasattr(model, "activate")
    relu = types.SimpleNamespace(**vars(model), activate=torch.relu)
    data = cell.dataset.make_dataset(cfg, SEED, "cpu")
    B, n = int(tr["batch"]), int(cfg["num_nodes"])
    seeds = torch.from_numpy(data["order"][:B])
    ids, masks, rels, _ = S.sample(
        torch.from_numpy(data["indptr"]), torch.from_numpy(data["indices"]),
        n, seeds, tr["fanout"], B, S.stream(SEED, 0, 0, S.SAMPLE, "cpu"))
    x0 = check.rows_of(data["features"], ids, n, "cpu")
    blocks = [M.Block(m, r) for m, r in zip(masks, rels)]
    labels = torch.from_numpy(data["labels"]).long()[seeds.long()]
    p0 = M.init_params(model, cfg, SEED, "cpu")

    def step(forward):
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        logits = forward(p, S.stream(SEED, 0, 0, S.DROPOUT, "cpu"))
        loss = M.loss_fn(logits, labels)
        return logits.detach(), torch.autograd.grad(loss, list(p.values()))

    runs = [step(lambda p, g, m=m: M.forward(m, cfg, p, x0, blocks, g, B))
            for m in (model, relu)]
    runs.append(step(lambda p, g: _old_forward(
        model, cfg, p, x0, blocks, g, B, OLD_READOUT[name])))
    for logits, grads in runs[1:]:
        assert torch.equal(logits, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][1]))


#: RGAT as the port's ``RelGATConv`` trains it, with what the published
#: R-GAT adds switched by the constants ``@BIAS@`` and ``@ACTIVATE@``
RGAT_TYPED = '''"""RGAT after the port's ``RelGATConv`` (as ``rgat.py``), each
relation r reaching only the destinations of its destination type
(``block.ntype == block.rel_dst[r]``, as PyG's ``HeteroConv`` sums into a
type only the relations that end there); with ``BIAS`` a bias per
relation, ``layer_{l}.bias_r{r}``, added to every destination of its type
(the port has none); ``activate`` between layers."""
import torch
from gnnbench.reference import model as M

TRANSFORM_ROWS = "src"
BIAS = @BIAS@
activate = @ACTIVATE@


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
            if BIAS:
                shapes[p + f"bias_r{r}"] = (d_out,)
    return shapes


def layer(p, pre, h, block, precision):
    cap_dst, f = block.mask.shape
    out, r = 0, 0
    while pre + f"fc_r{r}.weight" in p:
        into = (block.ntype == block.rel_dst[r]).float()
        heads, d_out = p[pre + f"attn_l_r{r}"].shape
        feat = M.matmul(h, p[pre + f"fc_r{r}.weight"].T, precision).view(
            h.shape[0], heads, d_out)
        el = (feat * p[pre + f"attn_l_r{r}"]).sum(-1)
        er = (feat[:cap_dst] * p[pre + f"attn_r_r{r}"]).sum(-1)
        e = torch.nn.functional.leaky_relu(
            M.planes(el, cap_dst, f).permute(1, 0, 2) + er[:, None, :], 0.2)
        m = (block.mask * (block.rel == r) * into[:, None])[:, :, None]
        e = torch.where(m > 0, e, torch.full_like(e, -1e9))
        alpha = torch.softmax(e, dim=1) * m
        nbr = M.planes(feat, cap_dst, f)
        out = out + (alpha.permute(1, 0, 2)[..., None] * nbr).sum(0).mean(1)
        if BIAS:
            out = out + into[:, None] * p[pre + f"bias_r{r}"]
        r += 1
    return out


def readout(p, h):
    return h


def flags(cfg):
    return ["--num_heads", str(cfg["num_heads"])]


def step_flops(cfg, rows):
    heads = int(cfg["num_heads"])
    return sum(rels(cfg) * (2 if layer == 0 else 3) * 2 * n * a * heads * b
               for layer, ((a, b), n) in enumerate(zip(M.dims(cfg), rows)))
'''

#: the stand-ins of RGAT_TYPED, each ``models/rgat.py`` of a root of its
#: own (the module's name is the program's ``--model_type``): (BIAS,
#: ACTIVATE)
RGAT_FORMS = {"relu": ("False", "torch.relu"),
              "leaky": ("False", "lambda h: torch.nn.functional."
                                 "leaky_relu(h, 0.01)"),
              "bias": ("True", "torch.relu")}
#: the cell of a root of ``forms_roots``
NODES_CELL = "rgat-nodes-c4g"

TYPED_NODES_GRAPH = '''"""graphgen's graph with typed nodes: the
configuration's ``graph.node_type_shares`` cut the ids into contiguous
ranges, the predict type first; each edge takes, drawn from the seed, one
of the relations whose destination type (``graph.relation_dst_type``) is
its destination's type."""
import numpy as np
import torch
from gnnbench import graphgen

TYPES = 5           # a generator stream of its own


def make_dataset(cfg, seed, device):
    out = graphgen.make_dataset(cfg, seed, device)
    g, n = cfg["graph"], int(cfg["num_nodes"])
    shares = np.cumsum(g["node_type_shares"], dtype=np.float64)
    offsets = np.zeros(shares.size + 1, np.int64)
    offsets[1:] = np.round(shares / shares[-1] * n)
    rel_dst = np.asarray(g["relation_dst_type"], np.int32)
    into = [np.flatnonzero(rel_dst == t) for t in range(shares.size)]
    table = np.array([np.resize(r, len(rel_dst)) for r in into])
    counts = np.array([len(r) for r in into])
    dst = np.repeat(np.arange(n), np.diff(out["indptr"]))
    t = np.searchsorted(offsets, dst, side="right") - 1
    gen = graphgen.generator(seed, TYPES, device)
    u = torch.rand(dst.size, generator=gen, device=device,
                   dtype=torch.float64).cpu().numpy()
    out["edge_types"] = table[t, (u * counts[t]).astype(np.int64)].astype(
        np.int32)
    out.update(num_edge_types=rel_dst.size, node_type_offsets=offsets,
               relation_dst_type=rel_dst)
    return out
'''

#: a schema of two node types (the predict type 0 on 65% of the ids) and
#: three relations, two of them into type 0
SCHEMA = {"node_type_shares": [0.65, 0.35], "relation_dst_type": [0, 1, 0]}


def add_typed_nodes_cell(root, name, text, schema, like="sage-igbm-c4g",
                         **traffic):
    """Cell ``name`` added to ``root`` as files (``add_cell``):
    ``models/rgat.py`` (``text``) on the ``typed_nodes`` graph of
    ``schema``."""
    write_modules(root, {"models/rgat": text,
                         "graphs/typed_nodes": TYPED_NODES_GRAPH})
    with open(os.path.join(root, "gnnbench", "configs",
                           "sage-igbm.json")) as f:
        base = json.load(f)
    cfg = dict(base, name=name, model="rgat", num_heads=2)
    cfg["graph"] = dict(base["graph"], generator="typed_nodes",
                        num_edge_types=len(schema["relation_dst_type"]),
                        **schema)
    add_cell(root, name, cfg, like, **traffic)


@pytest.fixture(scope="module")
def forms_roots(tiny_root, tmp_path_factory):
    """{form: a copy of ``tiny_root`` with the cell NODES_CELL of that
    form of RGAT_FORMS on the ``typed_nodes`` graph of SCHEMA, added as
    files alone}."""
    import shutil
    roots = {}
    for form, (bias, act) in RGAT_FORMS.items():
        root = roots[form] = str(tmp_path_factory.mktemp(form))
        shutil.copytree(os.path.join(tiny_root, "gnnbench"),
                        os.path.join(root, "gnnbench"))
        shutil.copy(os.path.join(tiny_root, "BENCHMARK.json"), root)
        text = RGAT_TYPED.replace("@BIAS@", bias).replace("@ACTIVATE@", act)
        add_typed_nodes_cell(root, NODES_CELL, text, SCHEMA,
                             fanout=[6, 6, 6])
    return roots


def test_destination_types_follow_the_offsets(forms_roots):
    """Each layer's destination types are ``searchsorted(offsets, ids,
    right=True) - 1``, -1 on a padded destination; untyped data gives
    None; ``check.follow`` hands them and the relations' destination
    types to every layer."""
    import dataclasses
    import types

    from gnnbench.reference import sampler as S

    root = forms_roots["relu"]
    cell = registry.load_cell(NODES_CELL, root)
    cfg, tr = cell.cfg, cell.traffic
    data = cell.dataset.make_dataset(cfg, SEED, "cpu")
    n, B, fanouts = int(cfg["num_nodes"]), int(tr["batch"]), tr["fanout"]
    offsets = torch.from_numpy(data["node_type_offsets"])
    assert offsets[0] == 0 and offsets[-1] == n and offsets.numel() == 3
    graph = (torch.from_numpy(data["indptr"]),
             torch.from_numpy(data["indices"]), n)
    seeds = torch.from_numpy(data["order"][:B - 3])     # 3 padded seeds
    ids, masks, _, ntypes = S.sample(
        *graph, seeds, fanouts, B, S.stream(SEED, 0, 0, S.SAMPLE, "cpu"),
        torch.from_numpy(data["edge_types"]), offsets)
    for (cap_dst, _), t in zip(S.capacities(B, fanouts), ntypes):
        dst = ids[:cap_dst]
        want = torch.searchsorted(offsets, dst, right=True) - 1
        want[dst == n] = -1
        assert t.dtype == torch.int32 and torch.equal(t.long(), want)
    assert (ntypes[-1][B - 3:] == -1).all() and (ntypes[-1][:B - 3] == 0).all()
    assert all((t >= 0).sum() < t.numel() for t in ntypes)
    untyped = S.sample(*graph, seeds, fanouts, B,
                       S.stream(SEED, 0, 0, S.SAMPLE, "cpu"))
    assert untyped[3] == [None] * len(fanouts)
    assert all(torch.equal(a, b) for a, b in zip(untyped[1], masks))
    assert check.node_types({}, n, "cpu") == (None, None)
    for key in ("node_type_offsets", "relation_dst_type"):
        with pytest.raises(ValueError, match="both keys or neither"):
            check.node_types({k: v for k, v in data.items() if k != key},
                             n, "cpu")

    seen = []

    def spied(c):
        def layer(p, pre, h, block, precision):
            seen.append(block)
            return c.model.layer(p, pre, h, block, precision)
        return dataclasses.replace(c, model=types.SimpleNamespace(
            **{**vars(c.model), "layer": layer}))

    for c, typed in ((cell, True),
                     (registry.load_cell("sage-igbm-c4g", root), False)):
        seen.clear()
        check.follow(spied(c), c.dataset.make_dataset(c.cfg, SEED, "cpu"),
                     SEED, torch.zeros(int(c.cfg["feature_dim"]),
                                       dtype=torch.float64), "cpu")
        assert len(seen) == len(c.traffic["fanout"]) * c.traffic["window"]
        for b in seen:
            if typed:
                assert b.ntype.shape == b.mask.shape[:1]
                assert b.rel_dst.tolist() == SCHEMA["relation_dst_type"]
            else:
                assert b.ntype is None and b.rel_dst is None


def test_a_model_that_declares_relu_and_uses_node_types_is_correct(
        forms_roots):
    """RGAT_TYPED with ``activate = torch.relu`` and no leaf the program
    lacks trains through the port's RGAT and agrees with the reference."""
    result = run(forms_roots["relu"], NODES_CELL)
    assert result["correct"], result["compared"]
    for near in ("loss_first", "grad_median", "update"):
        assert result["compared"][near]["value"] < 1e-5


def test_a_model_that_declares_leaky_relu_is_not_correct(forms_roots):
    """The reference's forward applies the module's own activation: leaky
    ReLU against the program's ReLU is over a limit."""
    result = run(forms_roots["leaky"], NODES_CELL, seconds=0.1)
    assert not result["correct"]
    cmp = result["compared"]
    assert any(cmp[n]["value"] > cmp[n]["limit"]
               for n in ("loss_first", "grad_median")), cmp


def test_a_leaf_the_program_lacks_stops_the_set_up(forms_roots):
    """A per-relation bias in ``param_shapes`` that the port's RGAT has
    not: loading the benchmark's weights into the program fails at
    set-up, naming the leaf."""
    with pytest.raises(RuntimeError, match=r"layer_0\.bias_r0"):
        run(forms_roots["bias"], NODES_CELL, seconds=0.1)


HEAD = '''"""A mean aggregator of width ``hidden_channels`` at every
layer, then a classifier head: ``head.weight`` [classes, hidden],
``head.bias``."""
import torch
from gnnbench.reference import model as M

TRANSFORM_ROWS = "dst"


def param_shapes(cfg):
    d, h = int(cfg["feature_dim"]), int(cfg["hidden_channels"])
    shapes = {}
    for layer in range(int(cfg["num_layers"])):
        shapes[f"layer_{layer}.fc.weight"] = (h, h if layer else d)
    shapes["head.weight"] = (int(cfg["num_classes"]), h)
    shapes["head.bias"] = (int(cfg["num_classes"]),)
    return shapes


def layer(p, pre, h, block, precision):
    cap_dst, f = block.mask.shape
    s = (M.planes(h, cap_dst, f) * block.mask.T[:, :, None]).sum(0)
    mean = s / block.mask.sum(1).clamp(min=1.0)[:, None]
    return M.matmul(h[:cap_dst] + mean, p[pre + "fc.weight"].T, precision)


def readout(p, h):
    return h @ p["head.weight"].T + p["head.bias"]


def flags(cfg):
    return []


def step_flops(cfg, rows):
    return 0
'''


def test_a_readout_head_is_drawn_and_compared_like_every_leaf(tiny_root,
                                                              tmp_path):
    """A head's leaves get the init rule (weights normal with std
    sqrt(1 / fan_in), biases zero), reach ``readout(p, h)``, and are
    compared like every leaf: a program record without them is not
    correct."""
    import dataclasses
    import shutil

    from gnnbench.reference import model as M

    root = str(tmp_path)
    shutil.copytree(os.path.join(tiny_root, "gnnbench"),
                    os.path.join(root, "gnnbench"))
    with open(os.path.join(root, "gnnbench", "models", "head.py"), "w") as f:
        f.write(HEAD)
    plain = registry.load_cell("sage-igbm-c4g", tiny_root)
    cell = dataclasses.replace(plain, model=registry.load_module(
        root, "models", "head"))
    cfg = cell.cfg
    p = M.init_params(cell.model, cfg, SEED, "cpu")
    hidden = int(cfg["hidden_channels"])
    assert p["head.weight"].shape == (int(cfg["num_classes"]), hidden)
    assert torch.equal(p["head.bias"], torch.zeros(int(cfg["num_classes"])))
    assert abs(float(p["head.weight"].std()) * hidden ** 0.5 - 1) < 0.25
    data = cell.dataset.make_dataset(cfg, SEED, "cpu")
    ref = check.follow(cell, data, SEED, torch.zeros(
        int(cfg["feature_dim"]), dtype=torch.float64), "cpu")
    for leaf in ("head.weight", "head.bias"):
        assert ref["grad"][leaf] > 0 and ref["update"][leaf] > 0
        assert leaf in check.moved(ref)
    n = int(cfg["num_nodes"])
    same = check.as_program(ref)
    assert check.compare(check.numbers(same, ref, n, False), cell.limits)[0]
    headless = dict(same)
    for k in ("grad", "update"):
        headless[k] = {leaf: v for leaf, v in same[k].items()
                       if not leaf.startswith("head.")}
    ok, rows = check.compare(check.numbers(headless, ref, n, False),
                             cell.limits)
    assert not ok and {k: v for k, v, _ in rows}["update"] > 0.1
