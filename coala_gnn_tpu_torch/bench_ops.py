"""Op-level microbenchmarks: the card's per-class peaks that
``utils/roofline.py`` divides a step's work by (port of
``examples/bench_ops.py``, with its row names, so ``roofline.op_peaks``
reads them unchanged).

    python -m coala_gnn_tpu_torch.bench_ops --json BENCH_OPS_h100.json
    python -m coala_gnn_tpu_torch.bench_ops --device cpu --json out.json

Rows (S source rows, N dst rows, F fanout, D width; ``--n_src`` ...):
  - ``gather_sum_loop`` / ``gather_sum_dense`` f32 and bf16: the port's
    ``ops/aggregate.py`` neighbour sums over a random adj (the loop is the
    gather-SpMM kernel on a card);
  - ``contig agg_sum`` f32 and bf16: ``agg_sum(x, None, w)``, the
    slot-major planes (the port's eager plane loop: it moves several
    times the bytes it is credited with, so it is no peak);
  - ``stream plane sum`` f32 and bf16: one reduction that reads F + 1
    planes of a table of at least 4x L2 once and writes their sum (the
    stream peak: each byte of the stream class moved once);
  - ``sddmm_gat`` gather and contig, f32 and bf16: GAT's scores, softmax
    and combine in torch ops;
  - ``gather_spmm`` f32, bf16 and int8: the gather-SpMM kernel
    (``ops/gather_spmm.py``) at the same shape, beside its plain version
    (``plain_ms``), held to it at 1e-5 (``max_abs_err``); the f32 row
    also times ``embedding_bag`` (``library_ms``), the one PyTorch call
    that computes the f32 forward's function (the port never calls it);
  - ``plain row gather`` f32, bf16 and int8: N * F distinct random rows
    of a table of at least 4x the card's L2, each row moved whole by
    ``row_gather`` (``csrc/row_gather.cu``: 16-byte words, several loads
    in flight a thread; the rand peak), held bitwise to the indexing;
  - ``torch index row gather`` f32, bf16 and int8: the same rows through
    PyTorch's indexing (``x.view(int64)[idx]``), which moves a fixed
    number of rows per second whatever their width, so it is no peak;
  - ``f32 4096^3 matmul`` (TF32 off, the precision the models run in) and
    ``bf16 4096^3 matmul`` (the mm peak), of ``--mm`` squared (4096 on a
    card; the names stay at the CPU's size);
  - with ``--cache_gather``: a window's K frontier gathers from a
    ``--table_rows`` table, per step (f32, bf16, int8 + dequantise) and
    restaged (the window's unique rows gathered once, then K gathers from
    them).

Timing on a card: the median of ``--iters`` single calls, each timed by
CUDA events after a write of at least 4x L2 (the cache flushed, as a
step finds its rows cold), after ``--warmup`` calls. Bytes are a lower
bound: each distinct table row read once, each index, weight and output
written or read once; so no reading can pass HBM, and one that passes
1.05 x 3.35 TB/s (or a matmul past 1.05 x the card's dense peak for its
dtype) fails the run. On the CPU the tool runs at a tiny size and writes
the same schema: no peak comes from it.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import statistics
import subprocess
import time
from typing import Callable, List, Optional

import torch

from coala_gnn_tpu_torch.cache.feature_cache import quantize_rows
from coala_gnn_tpu_torch.ops import aggregate
from coala_gnn_tpu_torch.ops.gather_spmm import (gather_spmm,
                                                 gather_spmm_reference)
from coala_gnn_tpu_torch.utils.build import load_library

#: NVIDIA H100 SXM published peaks (dense, at its 700 W limit): the
#: ceiling above which a reading is impossible
HBM_GBPS = 3350.0
DENSE_TFLOPS = {"f32": 67.0, "bf16": 989.0}
IMPOSSIBLE = 1.05          # a reading past 1.05x the ceiling fails
KERNEL_TOL = 1e-5          # gather_spmm vs its plain version, rtol = atol

#: sizes on a card (examples/bench_ops.py's) and on the CPU (schema only)
CARD = dict(n_src=65536, n_dst=32768, fanout=10, dim=256, mm=4096,
            table_rows=200_000, window=8, n_req=67584)
CPU = dict(n_src=512, n_dst=128, fanout=4, dim=16, mm=64, table_rows=2000,
           window=2, n_req=256)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}

#: the rand peak's row-copy kernel
ROW_GATHER_SOURCE = "row_gather.cu"


@functools.lru_cache(maxsize=None)
def _row_gather_library() -> ctypes.CDLL:
    """Build (at first use), load and type the row copy's C interface."""
    lib = load_library(ROW_GATHER_SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.row_gather_16b.argtypes = [ptr, ptr, ptr, i64, i64, ptr]
    lib.row_gather_16b.restype = ctypes.c_int
    lib.row_gather_error_string.argtypes = [ctypes.c_int]
    lib.row_gather_error_string.restype = ctypes.c_char_p
    return lib


def row_gather(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``words[idx]`` for a table of int64 words [S, W] (rows of a multiple
    of 16 bytes) and int64 ids [n]: on a card ``csrc/row_gather.cu``, on
    the CPU its plain version, the indexing."""
    if words.device.type == "cpu":
        return words[idx]
    if (words.dtype != torch.int64 or idx.dtype != torch.int64
            or words.dim() != 2 or words.shape[1] % 2
            or not words.is_contiguous() or not idx.is_contiguous()):
        raise ValueError("row_gather: needs a contiguous int64 [S, W] table "
                         "with W even and contiguous int64 ids")
    out = torch.empty(idx.numel(), words.shape[1], dtype=torch.int64,
                      device=words.device)
    lib = _row_gather_library()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        err = lib.row_gather_16b(words.data_ptr(), idx.data_ptr(),
                                 out.data_ptr(), idx.numel(),
                                 words.shape[1] // 2, stream)
    if err:
        raise RuntimeError("row_gather kernel launch failed: "
                           f"{lib.row_gather_error_string(err).decode()}")
    return out


class Bench:
    """The rows of one run on ``device``, timed as the module says."""

    def __init__(self, device: torch.device, iters: int, warmup: int):
        self.device = device
        self.iters = iters
        self.warmup = warmup
        self.results: List[dict] = []
        self.flush = None
        self.l2_bytes = 0
        if device.type == "cuda":
            props = torch.cuda.get_device_properties(device)
            self.l2_bytes = int(getattr(props, "L2_cache_size", 50 << 20))
            self.flush = torch.empty(max(4 * self.l2_bytes, 256 << 20) // 4,
                                     dtype=torch.float32, device=device)

    def time_ms(self, fn: Callable) -> float:
        """Median ms of ``iters`` single calls after ``warmup`` calls."""
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.iters):
            if self.flush is None:
                t0 = time.perf_counter()
                fn()
                times.append(1e3 * (time.perf_counter() - t0))
                continue
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def record(self, name: str, fn: Callable, nbytes: Optional[int] = None,
               flops: Optional[int] = None, **extra) -> dict:
        ms = self.time_ms(fn)
        row = {"name": name, "ms": ms}
        if nbytes is not None:
            row["bytes"] = int(nbytes)
            row["gb_per_s"] = nbytes / ms / 1e6
        if flops is not None:
            row["flops"] = int(flops)
            row["tflop_per_s"] = flops / ms / 1e9
        row.update(extra)
        rate = (f"{row['gb_per_s']:10.1f} GB/s" if nbytes is not None
                else f"{row['tflop_per_s']:10.1f} TFLOP/s")
        print(f"{name:34s} {ms:9.4f} ms {rate}")
        self.results.append(row)
        return row


def _rows(adj: torch.Tensor) -> int:
    return int(torch.unique(adj).numel())


def _gat_sddmm(x, adj, a_s, a_d, n, f):
    """GAT's scores (the SDDMM), fanout softmax and combine over the
    block's neighbour rows (the contiguous planes where ``adj`` is None)."""
    nbr = aggregate.neighbor_view(x, adj, (n, f))          # [N, F, D]
    s = torch.nn.functional.leaky_relu(
        x[:n] @ a_d[:, None] + nbr @ a_s, 0.2)
    alpha = torch.softmax(s, dim=1)
    return torch.einsum("nfd,nf->nd", nbr, alpha.to(x.dtype))


def check_rates(results: List[dict]) -> None:
    """Fail on a reading no H100 can give."""
    bad = []
    for r in results:
        if r.get("gb_per_s", 0) > IMPOSSIBLE * HBM_GBPS:
            bad.append(f"{r['name']}: {r['gb_per_s']:.1f} GB/s")
        kind = "bf16" if "bf16" in r["name"] else "f32"
        if r.get("tflop_per_s", 0) > IMPOSSIBLE * DENSE_TFLOPS[kind]:
            bad.append(f"{r['name']}: {r['tflop_per_s']:.1f} TFLOP/s")
    if bad:
        raise RuntimeError("bench_ops: impossible readings (past "
                           f"{IMPOSSIBLE}x the H100's peak): {bad}")


def smi_string() -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0]


def run(device="cuda", iters: int = 20, warmup: int = 3,
        cache_gather: bool = False, seed: int = 0, **sizes) -> dict:
    """Every row on ``device`` -> the JSON document ``--json`` writes.
    ``sizes`` override ``CARD`` (a card) or ``CPU``."""
    device = torch.device(device)
    cfg = dict(CPU if device.type == "cpu" else CARD)
    cfg.update({k: v for k, v in sizes.items() if v is not None})
    S, N, F, D = cfg["n_src"], cfg["n_dst"], cfg["fanout"], cfg["dim"]
    gen = torch.Generator(device=device).manual_seed(seed)
    bench = Bench(device, iters, warmup)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    x32 = randn(S, D)
    xs = {"f32": x32, "bf16": x32.to(torch.bfloat16)}
    adj = torch.randint(0, S, (N, F), generator=gen, device=device,
                        dtype=torch.int32)
    w = torch.rand(N, F, generator=gen, device=device)
    rows = _rows(adj)
    idx_bytes = N * F * 8                       # adj and w, 4 bytes each
    try:
        for kind in ("f32", "bf16"):
            bpp = xs[kind].element_size()
            nbytes = rows * D * bpp + idx_bytes + N * D * bpp
            for name, fn in (("gather_sum_loop", aggregate.padded_gather_sum),
                             ("gather_sum_dense",
                              aggregate.padded_gather_sum_dense)):
                bench.record(f"{name} {kind}",
                             lambda fn=fn, x=xs[kind]: fn(x, adj, w), nbytes)

        xc32 = randn(N * (1 + F), D)
        xcs = {"f32": xc32, "bf16": xc32.to(torch.bfloat16)}
        for kind, xc in xcs.items():
            bpp = xc.element_size()
            bench.record(f"contig agg_sum {kind}",
                         lambda xc=xc: aggregate.agg_sum(xc, None, w),
                         (N * F * D + N * D) * bpp + N * F * 4)

        # the stream peak: F + 1 planes past 4x L2 summed in one pass
        plane_rows = {}
        for kind in ("f32", "bf16"):
            bpp = DTYPES[kind].itemsize
            n_s = max(N, -(-4 * bench.l2_bytes // ((1 + F) * D * bpp)))
            plane_rows[kind] = n_s
            planes = randn(1 + F, n_s, D).to(DTYPES[kind])
            bench.record(f"stream plane sum {kind}",
                         lambda p=planes: p.sum(0),
                         (2 + F) * n_s * D * bpp)
            del planes

        a_s, a_d = randn(D), randn(D)
        gat_rows = int(torch.unique(torch.cat([
            adj.reshape(-1), torch.arange(N, device=device,
                                          dtype=torch.int32)])).numel())
        for kind in ("f32", "bf16"):
            x, xc = xs[kind], xcs[kind]
            dt = x.dtype
            bpp = x.element_size()
            bench.record(f"sddmm_gat gather {kind}",
                         lambda x=x, dt=dt: _gat_sddmm(
                             x, adj, a_s.to(dt), a_d.to(dt), N, F),
                         gat_rows * D * bpp + N * F * 4 + N * D * bpp)
            bench.record(f"sddmm_gat contig {kind}",
                         lambda xc=xc, dt=dt: _gat_sddmm(
                             xc, None, a_s.to(dt), a_d.to(dt), N, F),
                         (N * F * D + 2 * N * D) * bpp)

        q8, scale = quantize_rows(x32)
        tables = {"f32": (x32, None), "bf16": (xs["bf16"], None),
                  "int8": (q8, scale)}
        for kind, (x, sc) in tables.items():
            out = gather_spmm(x, adj, w, sc)
            ref = gather_spmm_reference(x, adj, w, sc)
            if not torch.allclose(out, ref, rtol=KERNEL_TOL,
                                  atol=KERNEL_TOL):
                raise RuntimeError(f"bench_ops: gather_spmm {kind} differs "
                                   "from its plain version")
            plain_ms = bench.time_ms(
                lambda x=x, sc=sc: gather_spmm_reference(x, adj, w, sc))
            library = {} if kind != "f32" else {
                "library_ms": bench.time_ms(
                    lambda x=x: torch.nn.functional.embedding_bag(
                        adj, x, per_sample_weights=w, mode="sum"))}
            bench.record(
                f"gather_spmm {kind}", lambda x=x, sc=sc: gather_spmm(
                    x, adj, w, sc),
                rows * (D * x.element_size() + (4 if sc is not None else 0))
                + idx_bytes + N * D * 4, plain_ms=plain_ms,
                max_abs_err=float((out - ref).abs().max()), **library)

        # the rand peak: N * F distinct rows of a table past 4x L2
        peak_rows = {}
        for kind, dt in DTYPES.items():
            bpp = torch.empty((), dtype=dt).element_size()
            s_peak = max(S, N * F, -(-4 * bench.l2_bytes // (D * bpp)))
            peak_rows[kind] = s_peak
            table = (randn(s_peak, D).to(dt) if kind != "int8" else
                     torch.randint(-127, 128, (s_peak, D), generator=gen,
                                   device=device, dtype=torch.int8))
            idx = torch.randperm(s_peak, generator=gen,
                                 device=device)[:N * F]
            words = table.view(torch.int64)      # whole rows, 8-byte words
            nbytes = 2 * N * F * D * bpp + N * F * 8
            if not torch.equal(row_gather(words, idx), words[idx]):
                raise RuntimeError(f"bench_ops: row_gather {kind} differs "
                                   "from the indexing")
            bench.record(f"plain row gather {kind}",
                         lambda t=words, i=idx: row_gather(t, i), nbytes)
            bench.record(f"torch index row gather {kind}",
                         lambda t=words, i=idx: t[i], nbytes)
            del words
            del table

        n = cfg["mm"]        # the rows keep their names at any size
        for kind in ("bf16", "f32"):
            a = randn(n, n).to(DTYPES[kind])
            bench.record(f"{kind} 4096^3 matmul", lambda a=a: a @ a,
                         flops=2 * n ** 3)
        if cache_gather:
            _cache_gather(bench, cfg, gen, randn)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if device.type == "cuda":
        check_rates(bench.results)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"backend": device.type, "device": name,
            "smi": smi_string() if device.type == "cuda" else None,
            "torch": torch.__version__,
            "config": dict(cfg, iters=iters, warmup=warmup,
                           l2_bytes=bench.l2_bytes,
                           plain_row_gather_table_rows=peak_rows,
                           plain_row_gather_kernel=(
                               "csrc/row_gather.cu (16-byte words)"
                               if device.type == "cuda" else "indexing"),
                           stream_plane_sum_shape={
                               k: [1 + F, v, D]
                               for k, v in plane_rows.items()},
                           tf32=False),
            "timing": ("median of iters single calls after warmup calls; "
                       "on a card CUDA events around each call, L2 flushed "
                       "before it; on the CPU the host clock"),
            "traffic_model": ("lower-bound bytes: each distinct table row "
                              "read once, each index, weight and output "
                              "read or written once"),
            "results": bench.results}


def _cache_gather(bench: Bench, cfg: dict, gen, randn) -> None:
    """A window's frontier gathers from the cache table: per step (K
    gathers of ``n_req`` rows each; f32, bf16, int8 + dequantise) and
    restaged (the window's unique rows gathered once, then K gathers from
    that stage)."""
    device = bench.device
    n_tab, K, n_req, D = (cfg["table_rows"], cfg["window"], cfg["n_req"],
                          cfg["dim"])
    tab32 = randn(n_tab, D)
    tab16 = tab32.to(torch.bfloat16)
    tab8, scale = quantize_rows(tab32)
    cats = torch.randint(0, n_tab, (K, n_req), generator=gen, device=device)
    uniq, inv = torch.unique(cats, return_inverse=True)
    U = int(uniq.numel())
    print(f"cache gather: table {n_tab} x {D}, window K={K}, n_req {n_req}, "
          f"unique per window {U} ({U / (K * n_req):.2f})")

    def per_step(tab):
        acc = torch.zeros(D, device=device)
        for k in range(K):
            acc += tab[cats[k]].sum(0, dtype=torch.float32)
        return acc

    def per_step_i8():
        acc = torch.zeros(D, device=device)
        for k in range(K):
            ids = cats[k]
            acc += (tab8[ids].float() * scale[ids][:, None]).sum(0)
        return acc

    def restage(tab):
        stage = tab[uniq]
        acc = torch.zeros(D, device=device)
        for k in range(K):
            acc += stage[inv[k]].sum(0, dtype=torch.float32)
        return acc

    idx = K * n_req * 8
    for name, fn, bpp, extra in (
            ("cache gather/step f32", lambda: per_step(tab32), 4, 0),
            ("cache gather/step bf16", lambda: per_step(tab16), 2, 0),
            ("cache gather/step int8+deq", per_step_i8, 1, 4),
            ("cache restage window f32", lambda: restage(tab32), 4, 0),
            ("cache restage window bf16", lambda: restage(tab16), 2, 0)):
        row = bench.record(f"{name} (K={K})", fn,
                           U * (D * bpp + extra) + idx + D * 4)
        row["ms_per_step"] = row["ms"] / K


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    for key in CARD:
        p.add_argument(f"--{key}", type=int, default=None)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cache_gather", action="store_true")
    p.add_argument("--json", default="",
                   help="write the rows to this JSON file (the port's "
                        "peaks: BENCH_OPS_h100.json)")
    args = p.parse_args(argv)
    sizes = {k: getattr(args, k) for k in CARD}
    doc = run(args.device, args.iters, args.warmup, args.cache_gather,
              args.seed, **sizes)
    print(f"device {doc['device']}; {doc['smi']}; config "
          f"{json.dumps(doc['config'])}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {args.json}")
    return doc


if __name__ == "__main__":
    main()
