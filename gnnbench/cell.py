"""One run of one cell: the data from the seed, the program built through
the CLI's ``build``, the cache filled, the first window checked, the measured
windows, the traced span, and the comparison with the plain reference.

The entry the window drives is the program's own:
``coala_gnn_tpu_torch.train.build(args, ds=...)`` with ``--pipeline
resident``, then ``run.trainer.train_window(grid, seed, window=step)``, one
window of K steps a call, as the CLI's resident loop calls it, keyed by
the step it starts at. The seeds of step t are the batch t of the run's
seed order (``order`` of the cell's data; ``graphgen.make_split``).

Set-up (``setup``): data (``make_dataset`` of the cell's graph module,
``registry``), build, the benchmark's initial weights loaded into the
program's model, the cache filled through the program's API
(``fill``: every node, then ``full_coverage``; or the highest in-degree
nodes up to capacity), the first window of K steps through
``train_window``, as every window is run (``first_window`` records what
its steps produced), then ``warmup_windows`` windows of K steps. Everything after
the set-up reads the clock for the end-to-end metrics (``measure``) or,
with tracing, for the per-layer ones (``measure_traced``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import resource
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from gnnbench import graphgen, trace
from gnnbench.reference import model as ref_model

FORBIDDEN = ("jax", "jaxlib", "flax", "coala_gnn_tpu")
#: rows of a frontier digested at a time (bounds the f64 copy)
DIGEST_ROWS = 1 << 16


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot), compared
    whole, is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Window:
    start: int                      # the step it starts at: its key
    seconds: float
    edges: int
    steps: int
    nonfinite: int


@dataclasses.dataclass
class Context:
    """What the metric readers read (``gnnbench/metrics/*.py``)."""

    cell: object
    run: object = None              # the program's Run
    data: Optional[dict] = None     # the benchmark's data (make_dataset)
    seed: int = 0
    windows: List[Window] = dataclasses.field(default_factory=list)
    wall: float = 0.0               # seconds of ``windows``, to the sync
    setup_s: float = 0.0
    timers: Dict[str, float] = dataclasses.field(default_factory=dict)
    tallies: Dict[str, float] = dataclasses.field(default_factory=dict)
    stats: Optional[dict] = None    # the trainer's hits and misses
    trace: Optional[trace.Trace] = None
    probes: dict = dataclasses.field(default_factory=dict)
    device: Optional[torch.device] = None

    @property
    def trainer(self):
        return self.run.trainer


def grid(order: np.ndarray, step: int, k: int, batch: int) -> np.ndarray:
    """The seed grid int32 [1, k, batch] of steps step .. step + k - 1."""
    idx = np.arange(step * batch, (step + k) * batch) % order.size
    return order[idx].reshape(1, k, batch)


def program_flags(cell, seed: int, device,
                  num_edge_types: int = 1) -> List[str]:
    """The CLI's flags: the shared ones, ``--num_edge_types`` on a typed
    graph, then the model module's own (``flags``)."""
    cfg, tr = cell.cfg, cell.traffic
    flags = ["--device", str(device), "--model_type", cfg["model"],
             "--fan_out", ",".join(str(f) for f in tr["fanout"]),
             "--batch_size", str(tr["batch"]),
             "--num_layers", str(cfg["num_layers"]),
             "--hidden_channels", str(cfg["hidden_channels"]),
             "--learning_rate", str(cfg["learning_rate"]),
             "--num_classes", str(cfg["num_classes"]),
             "--dtype", cfg["dtype"],
             "--cache_size", str(tr["cache_mb"]),
             "--pipeline", "resident", "--window", str(tr["window"]),
             "--distribution", tr["distribution"],
             "--seed", str(seed % (1 << 31))]
    if num_edge_types > 1:
        flags += ["--num_edge_types", str(num_edge_types)]
    return flags + cell.model.flags(cfg)


def build_program(cell, data: dict, seed: int, device):
    """The program's ``Run`` on the benchmark's dataset (its graph typed
    where the data has ``edge_types``), through the CLI's ``parse_args``
    and ``build``; its prints go to standard error."""
    from coala_gnn_tpu_torch import train as cli
    from coala_gnn_tpu_torch.graph.csc import CSCGraph
    from coala_gnn_tpu_torch.graph.datasets import Dataset

    num_edge_types = int(data.get("num_edge_types", 1))
    args = cli.parse_args(program_flags(cell, seed, device, num_edge_types))
    cli.refuse_unported(args)
    graph = CSCGraph(data["indptr"], data["indices"],
                     edge_types=data.get("edge_types"),
                     num_edge_types=num_edge_types)
    ds = Dataset(graph=graph,
                 features=data["features"], labels=data["labels"],
                 train_idx=data["train_idx"], val_idx=data["val_idx"],
                 test_idx=data["test_idx"],
                 num_classes=int(cell.cfg["num_classes"]),
                 name=cell.config_name)
    with contextlib.redirect_stdout(sys.stderr):
        run = cli.build(args, ds=ds)
    rt = run.trainer
    if run.model.dropout != float(cell.cfg["dropout"]):
        raise RuntimeError(f"the program's dropout {run.model.dropout} is "
                           f"not the configuration's {cell.cfg['dropout']}")
    if rt.stage_transport != cell.traffic["stage_transport"]:
        raise RuntimeError(f"stage transport {rt.stage_transport}, the "
                           f"traffic states {cell.traffic['stage_transport']}")
    if run.window != int(cell.traffic["window"]):
        raise RuntimeError(f"the CLI clamped the window to {run.window}")
    return run


def fill(cell, run, num_nodes: int) -> None:
    """The cache filled through the program's API, as the traffic states."""
    how = cell.traffic["fill"]
    if how == "all":
        run.cache.prewarm(np.arange(num_nodes, dtype=np.int32),
                          run.store.fetch)
        run.trainer.full_coverage = True
    elif how == "degree_top":
        run.cache.prewarm_by_degree(run.ds.graph, run.store.fetch)
    else:
        raise ValueError(f"unknown fill {how!r}")


class Capture:
    """What the first window produced, recorded from the benchmark's side:
    each window step's sampled frontier ids, masks and (where a block has
    them) relations (``_sample`` called from ``_window``), a digest of the
    layer-0 rows it trained on (``_layer0``): each row's dot with ``vec``,
    in f64), and after
    Adam's first and ``check.CHANGE_STEPS``-th updates (by its own step
    count, so a replayed window records its replay) the first gradient
    (``first_grad``) and the parameters' change."""

    def __init__(self, run, vec: torch.Tensor, change_at: int):
        self.run, self.rt, self.vec = run, run.trainer, vec
        self.change_at = change_at
        self.ids, self.masks, self.rels, self.digest = [], [], [], []
        self.grad = self.update = None
        self.params0 = {k: v.detach().clone()
                        for k, v in run.model.named_parameters()}
        self._in_window = False

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        p = self._stack.enter_context
        p(trace.patched(self.rt, "_window", self._window))
        p(trace.patched(self.rt, "_sample", self._sample))
        p(trace.patched(self.rt, "_layer0", self._layer0))
        p(trace.patched(self.run.optimizer, "step", self._step))
        return self

    def __exit__(self, *exc):
        self._stack.close()

    def _window(self, fn):
        def inner(*a, **kw):
            self._in_window = True
            try:
                return fn(*a, **kw)
            finally:
                self._in_window = False
        return inner

    def _sample(self, fn):
        def inner(*a, **kw):
            out = fn(*a, **kw)
            if self._in_window:
                blocks, ids = out[0], out[1]
                self.ids.append(ids.long().cpu())
                self.masks.append([b.mask.cpu() for b in blocks])
                self.rels.append([_rel(b) for b in blocks])
            return out
        return inner

    def _layer0(self, fn):
        def inner(feats):
            self.digest.append(torch.cat([
                feats[i:i + DIGEST_ROWS].double() @ self.vec
                for i in range(0, feats.shape[0], DIGEST_ROWS)]).cpu())
            return fn(feats)
        return inner

    def _step(self, fn):
        def inner(*a, **kw):
            out = fn(*a, **kw)
            n = adam_steps(self.run.optimizer)
            if n == 1:
                self.grad = _norms(first_grad(self.run))
            if n == self.change_at:
                self.update = _norms(changes(self.run, self.params0))
            return out
        return inner


def _rel(block) -> Optional[torch.Tensor]:
    rel = getattr(block, "rel", None)
    return None if rel is None else rel.cpu()


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def adam_steps(opt) -> int:
    """The most steps Adam has counted on any parameter (0 without state)."""
    return max((int(st["step"]) for st in opt.state.values()
                if "step" in st), default=0)


def changes(run, params0: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    return {k: v.detach() - params0[k]
            for k, v in run.model.named_parameters()}


def first_grad(run) -> Dict[str, torch.Tensor]:
    """Each parameter's first gradient as Adam got it, from its state after
    one step: exp_avg / (1 - beta1); zeros where Adam holds no state."""
    opt = run.optimizer
    beta1 = opt.param_groups[0]["betas"][0]
    out = {}
    for name, p in run.model.named_parameters():
        m = opt.state.get(p, {}).get("exp_avg")
        out[name] = (torch.zeros_like(p) if m is None
                     else m.detach() / (1.0 - beta1))
    return out


def first_window(cell, run, order: np.ndarray, seed: int,
                 vec: torch.Tensor) -> dict:
    """The first window of K steps through ``train_window`` (key 0, as
    ``run_windows`` runs every window), and what it produced (see
    ``Capture``; where Adam never counted a step, the first gradient and
    the change as the window left them)."""
    from gnnbench.reference import check

    rt, B = run.trainer, int(cell.traffic["batch"])
    K = int(cell.traffic["window"])
    with Capture(run, vec, min(check.CHANGE_STEPS, K)) as cap:
        losses, edges = rt.train_window(grid(order, 0, K, B), seed,
                                        window=0)
    stats = rt.stats()
    return {"loss": losses.double().cpu().tolist(),
            "edges": [int(x) for x in edges.cpu().tolist()],
            "hits": int(stats["hits"]), "misses": int(stats["misses"]),
            "ids": cap.ids, "masks": cap.masks, "rels": cap.rels,
            "digest": cap.digest,
            "grad": cap.grad or _norms(first_grad(run)),
            "update": cap.update or _norms(changes(run, cap.params0))}


def run_windows(rt, order: np.ndarray, seed: int, step: int, k: int,
                batch: int, seconds: float = 0.0, count: int = 0,
                sync=None) -> tuple:
    """Windows of ``k`` steps from ``step`` on, until ``seconds`` have
    passed (the window in flight completed) or ``count`` windows ran.
    -> (records, the next step, wall seconds ending in a sync)."""
    records: List[Window] = []
    t0 = trace.now()
    while True:
        ta = trace.now()
        with torch.profiler.record_function(trace.WINDOW):
            losses, edges = rt.train_window(grid(order, step, k, batch),
                                            seed, window=step)
            e, bad = torch.stack([edges.double().sum(),
                                  (~torch.isfinite(losses)).double().sum()
                                  ]).tolist()
        records.append(Window(step, trace.now() - ta, int(e), k, int(bad)))
        step += k
        if (count and len(records) >= count) or \
                (not count and trace.now() - t0 >= seconds):
            break
    if sync is not None:
        sync()
    return records, step, trace.now() - t0


@dataclasses.dataclass
class Bench:
    """One run of a cell (see the module docstring)."""

    cell: object
    seed: int
    device: torch.device
    data: Optional[dict] = None
    run: object = None
    program: Optional[dict] = None
    step: int = 0
    vec: Optional[torch.Tensor] = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self, warmup: bool = True) -> None:
        """The set-up of the module docstring (``warmup`` False: up to the
        first window)."""
        cell, dev = self.cell, self.device
        self.data = cell.dataset.make_dataset(cell.cfg, self.seed, dev)
        self.run = build_program(cell, self.data, self.seed, dev)
        params = ref_model.init_params(cell.model, cell.cfg, self.seed, dev)
        self.run.model.load_state_dict(params, strict=True)
        del params
        fill(cell, self.run, int(cell.cfg["num_nodes"]))
        self.vec = torch.randn(
            int(cell.cfg["feature_dim"]), dtype=torch.float64, device=dev,
            generator=graphgen.generator(self.seed, graphgen.DIGEST, dev))
        self.program = first_window(cell, self.run, self.data["order"],
                                    self.seed, self.vec)
        self.step = int(cell.traffic["window"])
        if warmup:
            self.windows(count=int(cell.traffic["warmup_windows"]))

    def windows(self, seconds: float = 0.0, count: int = 0) -> tuple:
        tr = self.cell.traffic
        records, self.step, wall = run_windows(
            self.run.trainer, self.data["order"], self.seed, self.step,
            int(tr["window"]), int(tr["batch"]), seconds, count, self.sync)
        return records, wall

    def measure(self, ctx: Context, seconds: float) -> None:
        """The measured windows; ``ctx.timers`` and ``ctx.tallies`` get
        what the trainer's phase timers added over them."""
        timers = self.run.trainer.timers
        before = dict(timers.totals), dict(timers.tallies)
        ctx.windows, ctx.wall = self.windows(seconds=seconds)
        ctx.timers = {k: v - before[0].get(k, 0.0)
                      for k, v in timers.totals.items()}
        ctx.tallies = {k: v - before[1].get(k, 0.0)
                       for k, v in timers.tallies.items()}

    def measure_traced(self, ctx: Context, seconds: float,
                       readers: dict) -> None:
        """An unprofiled stretch of ``seconds`` (the windows, and the
        trainer's phase timers and counters over it), then
        ``trace_windows`` windows under the profiler (each reader's
        ``span_probe``)."""
        rt = self.run.trainer
        rt.timers.reset()
        rt.stats()
        ctx.windows, ctx.wall = self.windows(seconds=seconds)
        ctx.timers = dict(rt.timers.totals)
        ctx.tallies = dict(rt.timers.tallies)
        ctx.stats = rt.stats()
        n = int(self.cell.traffic["trace_windows"])
        with contextlib.ExitStack() as stack:
            for r in readers.values():
                if hasattr(r, "span_probe"):
                    stack.enter_context(r.span_probe(ctx))
            stack.enter_context(trace.labelled(rt))
            _, ctx.trace = trace.profile(
                lambda: self.windows(count=n)[0])

    def free_program(self) -> None:
        """Drop the program's state and return its device memory."""
        self.run = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             t_start: float):
    """One run of ``cell``: set-up, the measured window (with ``traced``,
    the unprofiled stretch and the profiled span), the metrics, then the
    program freed and its first window compared with the reference. ->
    (the result's JSON object, the report lines: each number compared
    beside its limit, last; the window's start and end in epoch
    seconds), or None where a module of JAX or of the JAX
    package was loaded once the window closed."""
    from gnnbench.reference import check

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    cuda = device.type == "cuda"
    seed = int(seed) % (1 << 63)
    readers = cell.readers(traced)
    bench = Bench(cell, seed, device)
    bench.setup()
    ctx = Context(cell=cell, run=bench.run, data=bench.data, seed=seed,
                  device=device)
    ctx.setup_s = trace.now() - t_start
    epoch0 = time.time()
    if traced:
        bench.measure_traced(ctx, seconds, readers)
    else:
        bench.measure(ctx, seconds)
    epoch = (epoch0, time.time())
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    report = []
    found = forbidden_modules()
    if found:
        print(f"loaded once the window closed: {', '.join(found)}",
              file=sys.stderr)
        return None
    units = {m["name"]: m["unit"]
             for m in (cell.per_layer if traced else cell.end_to_end)}
    metrics = {}
    for name, reader in readers.items():
        value = reader.read(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": card,
           "count": cell.chips, "memory_peak_bytes": peak}
    breakdown = None
    if traced:
        dev.update(busy_s=ctx.trace.busy_s, window_s=ctx.trace.window_s)
        report.append("profiled windows: their last device operation ends "
                      "this many s before their end: " + ", ".join(
                          f"{g:.6f}" for g in ctx.trace.tail_gaps))
        breakdown = {"device_ops": ctx.trace.device_ops(),
                     "idle_gaps": ctx.trace.idle_gaps()}
    steps = sum(w.steps for w in ctx.windows)
    failed = sum(w.nonfinite for w in ctx.windows)
    report.append("window seconds " + ", ".join(
        f"{w.seconds:.3f}" for w in ctx.windows) + "; phases over them: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(ctx.timers.items()))
        + "; " + ", ".join(f"{k} {v:.0f}" for k, v in ctx.tallies.items()))
    report.append(f"setup_s {ctx.setup_s!r}; {len(ctx.windows)} windows of "
                  f"{cell.traffic['window']} steps in {ctx.wall!r} s, "
                  f"{failed} steps with a non-finite loss; host peak rss "
                  f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} KiB")
    ctx = None
    bench.free_program()
    t_ref = trace.now()
    ref = check.follow(cell, bench.data, seed, bench.vec, device)
    t_ref = trace.now() - t_ref
    nums = check.numbers(bench.program, ref, int(cell.cfg["num_nodes"]),
                         cell.traffic["fill"] == "all")
    correct, rows = check.compare(nums, cell.limits)
    report.append(f"losses of the first window {bench.program['loss']!r}, "
                  f"reference {ref['loss']!r} ({t_ref:.1f} s)")
    found = forbidden_modules()
    if found:
        print(f"loaded: {', '.join(found)}", file=sys.stderr)
        return None
    judged = {name for name, _, _ in rows}
    report.append("not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in nums.items() if k not in judged))
    report += [f"compared {name}: {value!r} (limit {limit!r})"
               for name, value, limit in rows]
    result = {"correct": bool(correct), "attempted": steps,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {name: {"value": value, "limit": limit}
                          for name, value, limit in rows}
    return result, report, epoch
