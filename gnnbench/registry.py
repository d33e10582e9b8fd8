"""Everything a cell needs, found by name from ``BENCHMARK.json``.

- a cell is one entry of ``workloads`` (its ``config``, ``traffic`` and
  ``chips``);
- a configuration is the ``file`` its ``configs`` entry names (under
  ``gnnbench/configs/``);
- a traffic mix is ``gnnbench/traffic/<traffic>.json``;
- every metric, end to end or per layer, is read by
  ``gnnbench/metrics/<name>.py``, whose ``read(ctx)`` returns a number or
  None (nothing to read: the metric is left out of the line); a name
  ``<base>.<regime>`` without a file of its own is read by
  ``<base>.py`` (the same reading, a metric of its own per regime);
- the limits of the comparison that decides ``correct`` are
  ``gnnbench/limits/<cell>.json``;
- a configuration's model is ``gnnbench/models/<model>.py``, by its
  ``model`` key, which is also the program's ``--model_type``: its
  parameter shapes under the port's names (a readout's included), its
  layer, its ``readout(p, h)``, optionally its ``activate(h)`` between
  layers, its own CLI flags and its dense FLOPs (``reference/model.py``
  says what each takes and gives);
- a configuration whose ``graph`` group names a ``generator`` gets its
  dataset from ``gnnbench/graphs/<generator>.py`` (its
  ``make_dataset(cfg, seed, device)``: ``graphgen.make_dataset``'s dict,
  plus ``edge_types`` int32 [E] in CSC order and ``num_edge_types`` on a
  typed graph, and where its nodes are typed ``node_type_offsets`` int64
  [T + 1] (types as contiguous id ranges, the predict type first) and
  ``relation_dst_type`` int32 [R], which reach the model's layers as each
  destination's type and each relation's destination type); one that
  names none, from ``gnnbench/graphgen.py``.

A metric applies to a cell when its ``workloads`` list names the cell, or
when it has no such list. Adding a cell, configuration, traffic mix or
metric, model or graph is adding its files and its ``BENCHMARK.json``
entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    chips: int
    cfg: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict
    root: str
    model: object       # the configuration's model module
    dataset: object     # the module whose ``make_dataset`` makes its data

    def readers(self, trace: bool) -> Dict[str, object]:
        """name -> loaded reader module of the metrics this cell reports
        (per-layer with ``trace``, else end to end)."""
        return {m["name"]: load_reader(self.root, m["name"])
                for m in (self.per_layer if trace else self.end_to_end)}


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json; KeyError if it has
    none of that name."""
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has: "
                       f"{', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _json(os.path.join(root, "gnnbench", "traffic",
                                 w["traffic"] + ".json"))
    limits_path = os.path.join(root, "gnnbench", "limits", name + ".json")
    limits = _json(limits_path) if os.path.exists(limits_path) else {}
    generator = cfg.get("graph", {}).get("generator")
    if generator is None:
        from gnnbench import graphgen as dataset
    else:
        dataset = load_module(root, "graphs", generator)
    return Cell(name=name, config_name=w["config"], chips=int(w["chips"]),
                cfg=cfg, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                limits=limits, root=root,
                model=load_module(root, "models", cfg["model"]),
                dataset=dataset)


_MODULES: Dict[str, object] = {}


def _load(path: str, prefix: str):
    """The module of the file ``path`` (loaded once per process)."""
    if path not in _MODULES:
        mod_name = prefix + re.sub(r"\W", "_", os.path.basename(path)[:-3])
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def load_module(root: str, kind: str, name: str):
    """The module ``gnnbench/<kind>/<name>.py`` under ``root`` (``kind``
    ``models`` or ``graphs``); FileNotFoundError naming the path where it
    is missing."""
    path = os.path.join(root, "gnnbench", kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{kind[:-1]} {name!r} has no module {path}")
    return _load(path, f"gnnbench_{kind}_")


def reader_path(root: str, name: str) -> str:
    """``gnnbench/metrics/<name>.py``, or, where ``name`` is
    ``<base>.<regime>`` and has no file of its own, ``<base>.py``."""
    metrics = os.path.join(root, "gnnbench", "metrics")
    path = os.path.join(metrics, name + ".py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(metrics, name.rsplit(".", 1)[0] + ".py")
    return path


def load_reader(root: str, name: str):
    """The reader module of metric ``name`` (``reader_path``; loaded once
    per process)."""
    path = reader_path(root, name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"metric {name!r} has no reader {path}")
    return _load(path, "gnnbench_metric_")
