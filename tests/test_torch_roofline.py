"""The port's roofline (``coala_gnn_tpu_torch/utils/roofline.py``) against
the JAX package's ``coala_gnn_tpu/utils/roofline.py``, and the peaks it
reads: ``step_cost``, ``bound`` and ``report`` equal JAX's exactly
(integers and floats) for SAGE, GCN and GAT, the CSR and the padded
topology, and every pair of line and model widths; ``op_peaks`` reads the
named JSON through bench.py's row names (the stream class through the
port's single-pass "stream plane sum" rows) and gives {} for a missing
file or row; ``bench_ops`` at a tiny CPU size writes every row
``op_peaks`` maps, with its kernel rows equal to their plain versions and
its peak rows computing what they are credited with."""

import json
import os
import re

import pytest
import torch

import bench
from coala_gnn_tpu.utils import roofline as jr
from coala_gnn_tpu_torch import bench_ops
from coala_gnn_tpu_torch.utils import roofline as tr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = [(1024, [10, 5], 256, 256, 16), (512, [15, 10, 5], 128, 64, 47),
           (64, [4, 3], 1024, 32, 19)]
PEAKS = {"rand_gbps": 1873.25, "stream_gbps": 905.5, "mm_tflops": 51.125}


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
@pytest.mark.parametrize("nbr_cap", [None, 32])
@pytest.mark.parametrize("line_bytes,model_bytes",
                         [(4, 4), (2, 4), (1, 4), (4, 2), (2, 2), (1, 2)])
def test_step_cost_bound_report_equal_jax(model, nbr_cap, line_bytes,
                                          model_bytes):
    for batch, fanouts, dim, hidden, classes in CONFIGS:
        kw = dict(model=model, heads=4, line_bytes=line_bytes,
                  model_bytes=model_bytes, nbr_cap=nbr_cap)
        cost = tr.step_cost(batch, fanouts, dim, hidden, classes, **kw)
        want = jr.step_cost(batch, fanouts, dim, hidden, classes, **kw)
        assert cost == want
        assert all(type(v) is int for v in cost.values())
        assert tr.bound(cost, PEAKS) == jr.bound(want, PEAKS)
        for ms in (0.0, 0.25, 3.1875, 41.7):
            assert tr.report(cost, dict(PEAKS), ms) == \
                jr.report(want, dict(PEAKS), ms)
    assert tr.layer_dims(256, 64, 16, 3) == jr.layer_dims(256, 64, 16, 3)


def _doc(rows):
    return {"device": "NVIDIA H100 80GB HBM3", "results": rows}


def test_op_peaks_reads_the_named_file(tmp_path):
    """The rows of BENCH_OPS_r05.json (the JAX tool's schema, used here
    only as a fixture; its "contig agg_sum" rows copied under the port's
    stream row names) under another name give the values bench.py's
    ``_op_peaks`` reads from it, keyed alike."""
    with open(os.path.join(ROOT, "BENCH_OPS_r05.json")) as f:
        rows = json.load(f)["results"]
    by_name = {r["name"]: r for r in rows}
    for kind, b in (("f32", 4), ("bf16", 2)):
        assert tr.PEAK_ROWS[("stream", b)] not in by_name
        rows.append(dict(by_name[f"contig agg_sum {kind}"],
                         name=tr.PEAK_ROWS[("stream", b)]))
    path = tmp_path / "peaks.json"
    path.write_text(json.dumps(_doc(rows)))
    got = tr.op_peaks(str(path))
    want = bench._op_peaks()
    assert want["source"] == "BENCH_OPS_r05.json"
    assert {k: v for k, v in got.items() if k not in ("source", "device")} \
        == {k: v for k, v in want.items() if k != "source"}
    assert got["source"] == "peaks.json"
    assert got["device"] == "NVIDIA H100 80GB HBM3"
    assert set(tr.PEAK_ROWS) <= set(got)
    # the class peaks of a config's dtypes, as bench.py's _roofline_row
    # picks them
    assert tr.class_peaks(got, 1, 2) == {
        "rand_gbps": got[("rand", 1)], "stream_gbps": got[("stream", 2)],
        "mm_tflops": got[("mm", 2)]}
    # the default is the port's own file at the repository root, never a
    # BENCH_OPS_r*.json
    assert tr.PEAKS_FILE == os.path.join(ROOT, "BENCH_OPS_h100.json")


def test_op_peaks_missing_file_or_row(tmp_path):
    assert tr.op_peaks(str(tmp_path / "absent.json")) == {}
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert tr.op_peaks(str(bad)) == {}
    rows = [{"name": n, "gb_per_s": 100.0} for n in tr.PEAK_ROWS.values()]
    full = tmp_path / "full.json"
    full.write_text(json.dumps(_doc(rows)))
    assert len([k for k in tr.op_peaks(str(full)) if k in tr.PEAK_ROWS]) \
        == len(tr.PEAK_ROWS)
    for drop in tr.PEAK_ROWS.values():
        part = tmp_path / "part.json"
        part.write_text(json.dumps(_doc([r for r in rows
                                         if r["name"] != drop])))
        assert tr.op_peaks(str(part)) == {}, drop
    zero = [dict(r, gb_per_s=0.0) if r["name"] == tr.PEAK_ROWS[("stream", 4)]
            else r for r in rows]
    part.write_text(json.dumps(_doc(zero)))
    assert tr.op_peaks(str(part)) == {}
    assert tr.class_peaks({("rand", 4): 1.0}, 4, 4) is None


def test_bench_ops_cpu_schema(tmp_path):
    """A tiny CPU run writes every row op_peaks maps (the schema only: no
    peak comes from the CPU), the kernel rows held to their plain
    versions; the roofline reads it."""
    path = tmp_path / "ops.json"
    doc = bench_ops.main(["--device", "cpu", "--iters", "2", "--warmup",
                          "1", "--cache_gather", "--json", str(path)])
    names = [r["name"] for r in doc["results"]]
    assert set(tr.PEAK_ROWS.values()) <= set(names)
    for kind in ("f32", "bf16", "int8"):
        row = next(r for r in doc["results"]
                   if r["name"] == f"gather_spmm {kind}")
        assert row["max_abs_err"] <= bench_ops.KERNEL_TOL
        assert row["plain_ms"] > 0 and row["gb_per_s"] > 0
    for prefix in ("gather_sum_loop", "gather_sum_dense", "sddmm_gat gather",
                   "sddmm_gat contig", "cache gather/step f32",
                   "cache restage window bf16"):
        assert any(n.startswith(prefix) for n in names), prefix
    assert doc["backend"] == "cpu" and doc["device"] == "cpu"
    assert doc["config"]["tf32"] is False
    with open(path) as f:
        assert json.load(f)["results"] == doc["results"]
    peaks = tr.op_peaks(str(path))
    assert peaks["device"] == "cpu"
    cost = tr.step_cost(1024, [10, 5], 256, 256, 16)
    rep = tr.report(cost, tr.class_peaks(peaks, 4, 4), 3.0)
    assert rep["binding"] in ("rand", "stream", "mm")
    assert rep["roofline_pct"] > 0


def test_check_rates_refuses_impossible_readings():
    ok = [{"name": "plain row gather f32", "gb_per_s": 3000.0},
          {"name": "bf16 4096^3 matmul", "tflop_per_s": 700.0},
          {"name": "f32 4096^3 matmul", "tflop_per_s": 50.0}]
    bench_ops.check_rates(ok)
    for bad in ({"name": "plain row gather int8", "gb_per_s": 3600.0},
                {"name": "f32 4096^3 matmul", "tflop_per_s": 80.0},
                {"name": "bf16 4096^3 matmul", "tflop_per_s": 1100.0}):
        with pytest.raises(RuntimeError, match=re.escape(bad["name"])):
            bench_ops.check_rates(ok + [bad])


def test_bench_ops_peak_rows_move_what_they_count(monkeypatch):
    """The peak rows compute the function their bytes are counted for: the
    stream row sums the F + 1 planes in one reduction (no plane loop),
    and each row gather moves whole rows as 8-byte words."""
    seen = {}
    record = bench_ops.Bench.record

    def keep(self, name, fn, *args, **kwargs):
        if name.startswith(("stream plane sum", "plain row gather",
                            "torch index row gather")):
            seen[name] = fn()
        return record(self, name, fn, *args, **kwargs)

    monkeypatch.setattr(bench_ops.Bench, "record", keep)
    doc = bench_ops.run("cpu", iters=1, warmup=0)
    cfg = doc["config"]
    F, D = cfg["fanout"], cfg["dim"]
    for kind in ("f32", "bf16"):
        shape = cfg["stream_plane_sum_shape"][kind]
        assert shape[0] == 1 + F and shape[2] == D
        out = seen[f"stream plane sum {kind}"]
        assert tuple(out.shape) == (shape[1], D)
        assert out.dtype == bench_ops.DTYPES[kind]
        row = next(r for r in doc["results"]
                   if r["name"] == f"stream plane sum {kind}")
        assert row["bytes"] == (2 + F) * shape[1] * D * out.element_size()
    for kind, dt in bench_ops.DTYPES.items():
        out = seen[f"plain row gather {kind}"]
        bpp = torch.empty((), dtype=dt).element_size()
        assert out.dtype == torch.int64
        assert tuple(out.shape) == (cfg["n_dst"] * F, D * bpp // 8)
        assert torch.equal(out, seen[f"torch index row gather {kind}"])
    assert cfg["plain_row_gather_kernel"] == "indexing"


def test_row_gather_plain_version_and_checks():
    """``row_gather`` on the CPU is the indexing (its plain version)."""
    g = torch.Generator().manual_seed(0)
    words = torch.randint(-2**62, 2**62, (50, 6), generator=g,
                          dtype=torch.int64)
    idx = torch.randperm(50, generator=g)[:17]
    assert torch.equal(bench_ops.row_gather(words, idx), words[idx])
    assert bench_ops.row_gather(words, idx[:0]).shape == (0, 6)
