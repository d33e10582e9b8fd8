"""CPU tests of the benchmark: tiny cells written into a temporary root
(its own BENCHMARK.json, configurations, traffic mixes and limits, with
the real metric readers and model modules), run through the harness on
the CPU. Tests marked ``cuda`` need a card and skip without one."""

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped without one")


#: the tiny stand-ins of the real cells: the cells' names, configurations
#: and traffic cut to a CPU's size, the real widths kept where ``wide``
TINY = {"sage-igbm-c4g": ("sage-igbm", "c4g", (1, 4), "degree_top"),
        "gat-igbm4m-c16g": ("gat-igbm4m", "c16g", (8, 128), "all")}


def make_root(path: str, wide: bool = False, num_nodes: int = 6000) -> str:
    """A benchmark root at ``path`` holding the real cells' tiny stand-ins
    and the real metric readers, model modules and limits."""
    src = os.path.join(REPO, "gnnbench")
    dst = os.path.join(path, "gnnbench")
    for d in ("metrics", "limits", "models"):
        shutil.copytree(os.path.join(src, d), os.path.join(dst, d))
    os.makedirs(os.path.join(dst, "configs"))
    os.makedirs(os.path.join(dst, "traffic"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for cell, (config, traffic, mb, fill) in TINY.items():
        with open(os.path.join(src, "configs", config + ".json")) as f:
            c = json.load(f)
        c.update(num_nodes=num_nodes, num_edges=12 * num_nodes)
        if not wide:
            c.update(feature_dim=64, hidden_channels=16, num_heads=2)
        c["graph"]["community_size"] = 256
        with open(os.path.join(dst, "configs", config + ".json"), "w") as f:
            json.dump(c, f)
        with open(os.path.join(src, "traffic", traffic + ".json")) as f:
            t = json.load(f)
        t.update(batch=16, cache_mb=mb[wide], fill=fill)
        if not wide:
            t.update(fanout=[4, 3, 2])
        with open(os.path.join(dst, "traffic", traffic + ".json"), "w") as f:
            json.dump(t, f)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="module")
def wide_root(tmp_path_factory):
    """The tiny cells at the real widths (dim 1024, hidden 128, 4 GAT
    heads, fanout 10,5,5), on few nodes and a batch of 16."""
    return make_root(str(tmp_path_factory.mktemp("wide")), wide=True,
                     num_nodes=3000)
