"""No module that the benchmark loads has a top-level name of ``jax``,
``jaxlib``, ``flax`` or ``coala_gnn_tpu``, compared whole (the port's
name, ``coala_gnn_tpu_torch``, begins with the last). A child process
blocks those names, loads the harness, every metric reader and the
program, runs a tiny cell on the CPU, and lists what it loaded."""

import json
import subprocess
import sys
import textwrap

from gnnbench.cell import FORBIDDEN, forbidden_modules

SCRIPT = textwrap.dedent("""
    import importlib.abc, json, sys, time
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, {tests!r})
    BLOCKED = {blocked!r}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    from conftest import make_root
    from gnnbench import cell, registry
    root = make_root({root!r})
    for traced in (False, True):
        c = registry.load_cell("sage-igbm-c4g", root)
        out = cell.run_cell(c, 5, 0.1, traced, "cpu", time.perf_counter())
        assert out is not None and out[0]["correct"], out
    import gnnbench.calibrate, gnnbench.run  # noqa: F401
    for w in registry.benchmark()["workloads"]:
        for t in (False, True):
            registry.load_cell(w["name"]).readers(t)
    print(json.dumps(sorted(sys.modules)))
""")


def test_the_match_is_of_whole_top_level_names():
    sys.modules.setdefault("coala_gnn_tpu_torch_probe", sys)
    try:
        assert "coala_gnn_tpu_torch_probe" not in forbidden_modules()
    finally:
        sys.modules.pop("coala_gnn_tpu_torch_probe", None)


def test_a_run_loads_no_jax(tmp_path):
    import os
    tests = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(tests))
    code = SCRIPT.format(repo=repo, tests=tests, blocked=FORBIDDEN,
                         root=str(tmp_path / "root"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "coala_gnn_tpu_torch" in loaded
    assert not [m for m in loaded if m.split(".")[0] in FORBIDDEN]
