"""The gather-SpMM kernels' share of their roofline over the profiled
span: the sum of each launch's bound (``arith.bound`` of its own
arguments: each distinct live input row read once, each output written
once, over 3.35 TB/s; ``arith.forward_work`` / ``grad_w_work`` /
``grad_x_work`` / ``transpose_work``) over the sum of those launches'
device time in the profiler's trace.

The launches are observed from the benchmark's side by wrapping the
entries of ``coala_gnn_tpu_torch/ops/gather_spmm.py`` for the span, and
matched in order, kind by kind, to the device operations whose names
``KINDS`` gives. An entry no longer found, or launches and device
operations that do not pair up, fail the run rather than report a stale
share."""

import contextlib

from gnnbench import arith, trace

NAME = "gather_spmm_roofline"
#: device operation name (a part of it) -> kind of launch
KINDS = (("gather_spmm_kernel", "forward"), ("grad_w_narrow_kernel", "grad_w"),
         ("grad_w_kernel", "grad_w"), ("grad_x_kernel", "grad_x"),
         ("transpose_one_block_kernel", "transpose"),
         ("transpose_grid_kernel", "transpose"))
#: kind -> the entry of ops/gather_spmm.py that launches it
ENTRIES = {"forward": "_forward", "grad_w": "gather_spmm_grad_w",
           "grad_x": "gather_spmm_grad_x", "transpose": "adj_transpose"}


def _kind(name: str):
    for part, kind in KINDS:
        if part in name:
            return kind
    return None


@contextlib.contextmanager
def span_probe(ctx):
    from coala_gnn_tpu_torch.ops import gather_spmm as gs

    missing = [e for e in ENTRIES.values() if not hasattr(gs, e)]
    if missing:
        raise RuntimeError(f"ops/gather_spmm.py no longer has {missing}")
    seen = ctx.probes.setdefault(NAME, [])

    def forward(fn):
        def inner(x, adj, w, scale, *rest, **kw):
            out = fn(x, adj, w, scale, *rest, **kw)
            if x.is_cuda:
                # the table's shape only: holding it would hold its memory
                rows, d, eb = x.shape[0], x.shape[1], x.element_size()
                scaled = scale is not None
                seen.append(("forward", lambda: arith.forward_work(
                    rows, d, eb, scaled, adj, w)))
            return out
        return inner

    def grad_w(fn):
        def inner(x, adj, g, *rest, **kw):
            out = fn(x, adj, g, *rest, **kw)
            if x.is_cuda:
                d, eb, gn = x.shape[1], x.element_size(), g.numel()
                seen.append(("grad_w", lambda: arith.grad_w_work(
                    d, eb, adj, gn)))
            return out
        return inner

    def grad_x(fn):
        def inner(adj, w, g, s, *rest, **kw):
            out = fn(adj, w, g, s, *rest, **kw)
            if g.is_cuda:
                d = g.shape[1]
                seen.append(("grad_x", lambda: arith.grad_x_work(
                    adj, w, d, s)))
            return out
        return inner

    def transpose(fn):
        def inner(adj, s, *rest, **kw):
            out = fn(adj, s, *rest, **kw)
            if adj.is_cuda:
                seen.append(("transpose", lambda: arith.transpose_work(
                    adj, s)))
            return out
        return inner

    wraps = {"forward": forward, "grad_w": grad_w, "grad_x": grad_x,
             "transpose": transpose}
    with contextlib.ExitStack() as stack:
        for kind, entry in ENTRIES.items():
            stack.enter_context(trace.patched(gs, entry, wraps[kind]))
        yield


def read(ctx):
    launches = ctx.probes.get(NAME)
    if not launches or ctx.trace is None:
        return None
    times = {}
    for name, a, b in sorted(ctx.trace.device, key=lambda e: e[1]):
        kind = _kind(name)
        if kind is not None:
            times.setdefault(kind, []).append(b - a)
    counts = {}
    for kind, _ in launches:
        counts[kind] = counts.get(kind, 0) + 1
    for kind in set(counts) | set(times):
        if counts.get(kind, 0) != len(times.get(kind, [])):
            raise RuntimeError(
                f"{counts.get(kind, 0)} {kind} launches against "
                f"{len(times.get(kind, []))} such device operations in the "
                "trace")
    bound = sum(arith.bound(*work()) for _, work in launches)
    spent = sum(sum(t) for t in times.values())
    return 100.0 * bound / spent if spent > 0 else None
