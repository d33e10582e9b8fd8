"""The whole step's share of the chip's dense peak: the dense-transform
FLOPs that the sampled blocks of every window step of the traced run's
unprofiled stretch need (the model module's ``step_flops`` over the
distinct nodes of each layer's block that its transforms run on, its
``TRANSFORM_ROWS``, counted by ``arith.distinct``), over the stretch's
wall time times the published dense peak of the configuration's dtype
(``arith.DENSE_PEAK``).

Nothing runs on the timed path: the stretch's windows are known by the
steps they start at, and once the stretch has closed each step's blocks
are drawn again by the plain sampler (``reference/sampler.py``) from the
benchmark's graph, the step's seeds and its sampling stream, which the
comparison that decides ``correct`` holds equal to the program's."""

import numpy as np
import torch

from gnnbench import arith
from gnnbench.reference import sampler as S

#: a block's (dst, src) nodes, as ``S.capacities`` orders them
SIDES = ("dst", "src")


def read(ctx):
    if not ctx.windows or ctx.wall <= 0 or ctx.data is None:
        return None
    cfg, tr, data = ctx.cell.cfg, ctx.cell.traffic, ctx.data
    model, L = ctx.cell.model, int(cfg["num_layers"])
    B, fanouts = int(tr["batch"]), list(tr["fanout"])
    caps = S.capacities(B, fanouts)
    n = int(cfg["num_nodes"])
    side = SIDES.index(model.TRANSFORM_ROWS)
    dev = ctx.device
    indptr = torch.from_numpy(data["indptr"]).to(dev)
    indices = torch.from_numpy(data["indices"]).to(dev)
    order = data["order"]
    flops = 0.0
    for w in ctx.windows:
        for k in range(w.steps):
            s = w.start + k
            seeds = torch.from_numpy(
                order[np.arange(s * B, (s + 1) * B) % order.size]).to(dev)
            ids = S.sample(indptr, indices, n, seeds, fanouts, B,
                           S.stream(ctx.seed, w.start, k, S.SAMPLE, dev))[0]
            flops += model.step_flops(cfg, [
                arith.distinct(ids, n, caps[layer][side])
                for layer in range(L)])
    return 100.0 * flops / (ctx.wall * arith.DENSE_PEAK[cfg["dtype"]])
