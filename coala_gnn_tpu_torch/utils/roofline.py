"""Per-step roofline of the resident training step (port of
``coala_gnn_tpu/utils/roofline.py``, with the same arithmetic and keys).

From shapes alone the model gives a step's unavoidable work in three
classes and divides each by the card's measured peak for it
(``bench_ops.py``, written to ``BENCH_OPS_h100.json`` and read by
``op_peaks``):

  rand   random row-gather bytes: the frontier's cache lines, one per
         frontier id, and the topology reads (CSR: an 8-byte indptr pair
         and 4 bytes per sampled index; the padded ``nbr_cap`` table: one
         row of ``nbr_cap`` int32 per dst), judged against the measured
         random row-gather rate ("plain row gather": whole rows moved
         as 8-byte words, so a narrow line is not timed at its element
         width);
  stream streaming aggregation and activation bytes (each src row read
         once, each dst row written once per layer; twice that for the
         backward), judged against the measured rate of one pass that
         reads F + 1 slot planes and writes their sum ("stream plane
         sum": the same traffic, each byte moved once; the port's eager
         ``agg_sum`` over those planes, JAX's "contig agg_sum" row, moves
         several times its counted bytes, so it is no peak here);
  mm     model matmul FLOPs (forward, input gradient and weight gradient:
         3x the forward), judged against the measured 4096^3 matmul rate.

The bound assumes the classes overlap perfectly: t_bound = max over the
classes of work / peak. Sampling is not a class (no hardware lower bound),
so the bound is optimistic; the per-class milliseconds itemise the gap.
GAT's ``hidden`` is per head and its heads flatten between layers, so its
hidden layers are ``heads`` times wider than SAGE's at the same flag.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

from coala_gnn_tpu_torch.sampling.neighbor import block_capacities

#: the port's peak file at the repository root (``bench_ops.py --json``)
PEAKS_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "BENCH_OPS_h100.json")

#: (class, element bytes) -> the ``bench_ops.py`` row that measures its
#: peak: bench.py's name map, but for the stream rows (see the module
#: docstring)
PEAK_ROWS = {
    ("rand", 4): "plain row gather f32",
    ("rand", 2): "plain row gather bf16",
    ("rand", 1): "plain row gather int8",
    ("stream", 4): "stream plane sum f32",
    ("stream", 2): "stream plane sum bf16",
    ("mm", 4): "f32 4096^3 matmul",
    ("mm", 2): "bf16 4096^3 matmul",
}


def layer_dims(dim: int, hidden: int, num_classes: int,
               num_layers: int) -> List[tuple]:
    """[(d_in, d_out)] per layer, input-most first: hidden for all but the
    last layer, which maps to num_classes."""
    dims = []
    d_in = dim
    for layer in range(num_layers):
        d_out = num_classes if layer == num_layers - 1 else hidden
        dims.append((d_in, d_out))
        d_in = d_out
    return dims


def step_cost(batch: int, fanouts: Sequence[int], dim: int, hidden: int,
              num_classes: int, *, model: str = "sage", heads: int = 4,
              line_bytes: int = 4, model_bytes: int = 4,
              nbr_cap: Optional[int] = None) -> dict:
    """A training step's work: {"rand_bytes", "stream_bytes", "flops"}.
    ``line_bytes``: the cache line's element width (4 f32, 2 bf16, 1
    int8); ``model_bytes``: the activations' and matmuls' (4 f32, 2
    bf16). SAGE's two fcs run on the dst rows (GCN shares the entry);
    GAT's fc runs on every src row, its attention adds 4 FLOPs per src
    element."""
    caps = block_capacities(batch, list(fanouts))
    n_frontier = caps[0][1]
    num_layers = len(fanouts)

    rand = n_frontier * dim * line_bytes
    for (cap_dst, _), f in zip(caps, fanouts):
        rand += cap_dst * (nbr_cap * 4 if nbr_cap else 8 + f * 4)

    if model == "gat":
        dims, d_in = [], dim
        for layer in range(num_layers):
            last = layer == num_layers - 1
            d_out = heads * (num_classes if last else hidden)
            dims.append((d_in, d_out))
            d_in = d_out
    else:
        dims = layer_dims(dim, hidden, num_classes, num_layers)
    stream = 0
    flops = 0
    for (cap_dst, cap_src), (d_in, d_out), f in zip(caps, dims, fanouts):
        if model == "gat":
            flops += 2 * cap_src * d_in * d_out + 4 * cap_src * d_out
            stream += (cap_src * d_in + cap_src * d_out
                       + cap_dst * d_out) * model_bytes
        else:
            flops += 2 * 2 * cap_dst * d_in * d_out
            stream += (cap_src * d_in + cap_dst * d_out) * model_bytes
    # training: the matmuls three times (forward, input and weight
    # gradients); the streams twice, the backward's lower bound
    flops *= 3
    stream *= 2

    return {"rand_bytes": int(rand), "stream_bytes": int(stream),
            "flops": int(flops)}


def bound(cost: dict, peaks: dict) -> dict:
    """The bound of a step's cost against peaks {"rand_gbps",
    "stream_gbps", "mm_tflops"} (the rows of the config's dtypes): the
    per-class ms, the binding class and t_bound ms."""
    t_rand = cost["rand_bytes"] / (peaks["rand_gbps"] * 1e9) * 1e3
    t_stream = cost["stream_bytes"] / (peaks["stream_gbps"] * 1e9) * 1e3
    t_mm = cost["flops"] / (peaks["mm_tflops"] * 1e12) * 1e3
    comp = {"rand_ms": t_rand, "stream_ms": t_stream, "mm_ms": t_mm}
    binding = max(comp, key=comp.get)
    return {"components_ms": {k: round(v, 4) for k, v in comp.items()},
            "binding": binding.replace("_ms", ""),
            "t_bound_ms": round(comp[binding], 4)}


def report(cost: dict, peaks: dict, ms_step: float) -> dict:
    """``bound`` with the measured ms/step and the bound's share of it in
    percent (``roofline_pct``)."""
    b = bound(cost, peaks)
    b["ms_step_measured"] = round(ms_step, 4)
    b["roofline_pct"] = round(100.0 * b["t_bound_ms"] / ms_step, 1) \
        if ms_step > 0 else None
    b["peaks"] = peaks
    return b


def op_peaks(path: str = PEAKS_FILE) -> dict:
    """The card's measured peaks from ``bench_ops.py``'s JSON at ``path``:
    {(class, element bytes): GB/s or TFLOP/s, "source": file name,
    "device": the card as the file names it}. {} when the file, one of
    ``PEAK_ROWS`` or its rate is missing: the roofline is then left out,
    not guessed. Reads only that file (the JAX package's
    ``BENCH_OPS_r*.json`` are another chip's)."""
    try:
        with open(path) as f:
            doc = json.load(f)
        rows = {r["name"]: r for r in doc["results"]}
    except (OSError, ValueError, KeyError, TypeError):
        return {}
    peaks = {}
    for key, name in PEAK_ROWS.items():
        rate = rows.get(name, {}).get("gb_per_s") or \
            rows.get(name, {}).get("tflop_per_s")
        if not rate:
            return {}
        peaks[key] = rate
    peaks["source"] = os.path.basename(path)
    peaks["device"] = doc.get("device")
    return peaks


def class_peaks(peaks: dict, line_bytes: int, model_bytes: int
                ) -> Optional[dict]:
    """``bound``'s peaks for a config's dtypes from ``op_peaks``' map, or
    None where one is missing."""
    need = {"rand_gbps": ("rand", line_bytes),
            "stream_gbps": ("stream", model_bytes),
            "mm_tflops": ("mm", model_bytes)}
    if any(k not in peaks for k in need.values()):
        return None
    return {name: peaks[k] for name, k in need.items()}
