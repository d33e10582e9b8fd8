"""The CUDA gather-SpMM kernels (f32, bf16 and int8 forward, the f32 and
int8 tables read as bf16, grad_w, grad_x and adj's transpose) against
their plain versions, on a card.

Needs a CUDA card and nvcc; skipped without a card. This file imports no
JAX, so it runs on a machine that has none:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: tests/conftest.py sets JAX up.) Forward tolerance
1e-5: both sides widen (or dequantise) the table rows exactly as the plain
version does and sum them in the same slot order, apart only by fused vs
separate multiply-add. The backward kernels sum in another order than
their plain versions on the card; they are held to the f32 error bound of
those sums (``grad_w_error_bound``, ``grad_x_error_bound``), and grad_x is
exact where no table row is referenced twice. The transpose is held to its
plain version exactly."""

import pytest
import torch

from coala_gnn_tpu_torch.ops.gather_spmm import (
    LAUNCHES, adj_transpose, adj_transpose_reference, gather_spmm,
    gather_spmm_grad_w, gather_spmm_grad_w_reference, gather_spmm_grad_x,
    gather_spmm_grad_x_reference, gather_spmm_reference, grad_w_error_bound,
    grad_x_error_bound, transpose_scratch)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, dtype):
    name = f"gather_spmm[{str(dtype).split('.')[-1]}]"
    for S, N, F, D in SHAPES:
        x = torch.randn(S, D, generator=cuda, device="cuda").to(dtype)
        adj, w = _adj_w(cuda, S, N, F)
        before = LAUNCHES[name]
        out = gather_spmm(x, adj, w)
        torch.cuda.synchronize()
        assert LAUNCHES[name] == before + 1
        torch.testing.assert_close(out, gather_spmm_reference(x, adj, w),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_int8_kernel_matches_plain(cuda):
    from coala_gnn_tpu_torch.cache.feature_cache import quantize_rows

    for S, N, F, D in SHAPES:
        q, scale = quantize_rows(
            torch.randn(S, D, generator=cuda, device="cuda"))
        adj, w = _adj_w(cuda, S, N, F)
        before = LAUNCHES["gather_spmm[int8]"]
        out = gather_spmm(q, adj, w, scale)
        torch.cuda.synchronize()
        assert LAUNCHES["gather_spmm[int8]"] == before + 1
        torch.testing.assert_close(
            out, gather_spmm_reference(q, adj, w, scale), rtol=1e-5,
            atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("stored", ["float32", "int8"])
def test_bf16_read_kernels_match_plain(cuda, stored):
    """The f32 and int8 tables read as bf16 (each element rounded to bf16,
    ties to even, after the int8 dequantising multiply) at every shape of
    SHAPES (odd widths 100 and 1 among them), masked slots (w == 0), rows
    at bf16 ties, and out-of-range slots giving NaN rows; one launch each
    on its own counter."""
    from coala_gnn_tpu_torch.cache.feature_cache import quantize_rows

    name = f"gather_spmm[{stored}_as_bf16]"
    for S, N, F, D in SHAPES:
        base = torch.randn(S, D, generator=cuda, device="cuda") * 10
        bits = base.view(torch.int32)
        bits[0] = (bits[0] & -65536) | 0x8000          # ties to even
        x, scale = (quantize_rows(base) if stored == "int8"
                    else (base, None))
        adj, w = _adj_w(cuda, S, N, F)
        before = LAUNCHES[name]
        out = gather_spmm(x, adj, w, scale, read_as=torch.bfloat16)
        torch.cuda.synchronize()
        assert LAUNCHES[name] == before + 1
        want = gather_spmm_reference(x, adj, w, scale, read_as=torch.bfloat16)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
        one = torch.zeros(N, 1, dtype=torch.int32, device="cuda")
        rows = gather_spmm(x, one, torch.ones(N, 1, device="cuda"), scale,
                           read_as=torch.bfloat16)
        assert torch.equal(rows, gather_spmm_reference(
            x, one, torch.ones(N, 1, device="cuda"), scale,
            read_as=torch.bfloat16))               # a single read: exact
        bad = adj.clone()
        bad[0, F - 1], bad[N - 1, 0] = S, -1
        out = gather_spmm(x, bad, w + 1, scale, read_as=torch.bfloat16)
        torch.cuda.synchronize()
        assert out[0].isnan().all() and out[N - 1].isnan().all()
        if N > 2:
            assert not out[1:N - 1].isnan().any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_kernels_match_plain(cuda, dtype):
    """grad_w (every slot, w == 0 included) and grad_x, on random adj
    (repeated rows: within the bound) and on a permutation (each table row
    referenced once: grad_x exact); then grad_w at every width of
    GRAD_W_WIDTHS (rows narrower than a warp's vectors take a lane group
    per slot, wider ones a warp per dst row), out-of-range slots giving
    NaN."""
    for D in GRAD_W_WIDTHS:
        S, N, F = 700, 300, 5
        x = torch.randn(S, D, generator=cuda, device="cuda").to(dtype)
        g = torch.randn(N, D, generator=cuda, device="cuda")
        adj, w = _adj_w(cuda, S, N, F)
        adj[3, 1], adj[7, 4], adj[N - 1, 0] = -1, S, 2**30
        bad = (adj < 0) | (adj >= S)
        before = LAUNCHES[GRAD_W[dtype]]
        gw = gather_spmm_grad_w(x, adj, g)
        torch.cuda.synchronize()
        assert LAUNCHES[GRAD_W[dtype]] == before + 1
        assert gw[bad].isnan().all() and not gw[~bad].isnan().any()
        ok = torch.where(bad, torch.zeros_like(adj), adj)
        err = (gw - gather_spmm_grad_w_reference(x, ok, g)).abs()
        assert (err <= grad_w_error_bound(x, ok, g))[~bad].all(), D
        assert (gw[(w == 0) & ~bad] != 0).any()
    for S, N, F, D in SHAPES:
        x = torch.randn(S, D, generator=cuda, device="cuda").to(dtype)
        g = torch.randn(N, D, generator=cuda, device="cuda")
        for unique in (False, True):
            if unique and S < N * F:
                continue
            adj, w = _adj_w(cuda, S, N, F)
            if unique:
                adj = torch.randperm(S, generator=cuda, device="cuda")[
                    :N * F].view(N, F).to(torch.int32)
            xr = x.requires_grad_(dtype == torch.float32)
            wr = w.clone().requires_grad_()
            counts = dict(LAUNCHES)
            gather_spmm(xr, adj, wr).backward(g)
            torch.cuda.synchronize()
            assert LAUNCHES[GRAD_W[dtype]] == counts[GRAD_W[dtype]] + 1
            assert LAUNCHES["gather_spmm_grad_x"] == \
                counts["gather_spmm_grad_x"] + (dtype == torch.float32)
            gw_ref = gather_spmm_grad_w_reference(x.detach(), adj, g)
            assert ((wr.grad - gw_ref).abs()
                    <= grad_w_error_bound(x.detach(), adj, g)).all()
            assert (wr.grad[w == 0] != 0).any()
            if dtype == torch.float32:
                gx_ref = gather_spmm_grad_x_reference(adj, w, g, S)
                if unique:
                    assert torch.equal(xr.grad, gx_ref)
                else:
                    assert ((xr.grad - gx_ref).abs()
                            <= grad_x_error_bound(adj, w, g, S)).all()
                xr.grad = None


GRAD_W = {torch.float32: "gather_spmm_grad_w",
          torch.bfloat16: "gather_spmm_grad_w[bfloat16]"}
SHAPES = [(100, 40, 5, 128), (64, 300, 3, 256), (50, 17, 10, 128),
          (1000, 6144, 10, 256), (9, 3, 1, 8), (60, 20, 5, 100),
          (2000, 50, 7, 100), (300, 40, 5, 16), (61, 7, 3, 1)]
GRAD_W_WIDTHS = [1, 2, 3, 8, 16, 31, 32, 64, 128, 256]


def _adj_w(gen, S, N, F):
    """Random adj with ~20% of slots masked (w = 0)."""
    adj = torch.randint(0, S, (N, F), generator=gen, device="cuda",
                        dtype=torch.int32)
    w = torch.rand(N, F, generator=gen, device="cuda")
    w[torch.rand(N, F, generator=gen, device="cuda") < 0.2] = 0.0
    w[:, 0] = 0.0
    return adj, w


@pytest.mark.cuda
def test_gat_training_on_card(cuda):
    """A small GAT run on the card: 6 kernel launches per step (forward,
    grad_w and grad_x on each of 2 layers), 2 transposes in the run (one
    per layer, kept for the later steps) and the same losses as the CPU
    port (dropout 0; the CPU port is held to JAX by the CPU tests)."""
    import numpy as np

    from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
    from coala_gnn_tpu_torch.cache import feature_cache as fc
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.ops.gather_spmm import reset_launches
    from coala_gnn_tpu_torch.parallel.resident import ResidentTrainer

    ds = synthetic_graph(num_nodes=500, avg_degree=6, feature_dim=12,
                         num_classes=4, seed=2)
    fan = int(ds.graph.in_degrees().max())  # every in-edge: no random draw
    rng = np.random.default_rng(1)
    grids = np.stack([np.stack([rng.choice(ds.train_idx, 32, replace=False)
                                for _ in range(3)])
                      for _ in range(2)]).astype(np.int32)
    out = {}
    for device in ("cuda", "cpu"):
        model = make_model("gat", 12, 8, 4, 2, num_heads=2, dropout=0.0,
                           seed=3).to(device)
        rt = ResidentTrainer(
            graph=ds.graph, host_fetch=HostFeatureStore(ds.features).fetch,
            labels=ds.labels, cache_cfg=fc.make_config(8, 12), model=model,
            optimizer=torch.optim.Adam(model.parameters(), lr=1e-2),
            fanouts=[fan, fan], batch_size=32, device=device)
        rt.prewarm(np.arange(500, dtype=np.int32))
        reset_launches()
        losses, _ = rt.train_windows(grids, seed=4)
        out[device] = (losses.cpu(), dict(LAUNCHES))
    steps = grids.shape[0] * grids.shape[1]
    launches = out["cuda"][1]
    assert launches["gather_spmm[float32]"] == 2 * steps
    assert launches["gather_spmm_grad_w"] == 2 * steps
    assert launches["gather_spmm_grad_x"] == 2 * steps
    assert launches["adj_transpose"] == 2     # once per layer's shape
    assert not any(out["cpu"][1].values())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=2e-3,
                               atol=2e-4)


@pytest.mark.cuda
def test_forward_at_training_shapes(cuda):
    """Every table form at the training step's layer-0 shape (200,001-row
    table, 6,144 dst rows, 10 slots, D = 256, ~20% masked slots pointing at
    row 0), GAT layer 1's combine (D = 16: eight dst rows per warp), and
    dst counts around the grids that fit the card in one wave at 4 or only
    at 2 slots per batch (the launch picks between the two)."""
    from coala_gnn_tpu_torch.cache.feature_cache import quantize_rows

    for S, N, F, D in [(200_001, 6144, 10, 256), (24_576, 4096, 5, 16),
                       (200_001, 2400, 10, 256), (200_001, 8000, 10, 256),
                       (200_001, 12_000, 10, 256)]:
        adj, w = _adj_w(cuda, S, N, F)
        adj[w == 0] = 0
        base = torch.randn(S, D, generator=cuda, device="cuda")
        for x, scale in ((base, None), (base.to(torch.bfloat16), None),
                         quantize_rows(base)):
            out = gather_spmm(x, adj, w, scale)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                out, gather_spmm_reference(x, adj, w, scale), rtol=1e-5,
                atol=1e-5)


def _form(s: int, nf: int, device) -> str:
    """The transpose's form on ``device`` for this shape: one-block where
    it takes no scratch, else the cooperative grid."""
    return "one-block" if transpose_scratch(s, nf, device) == 0 else "grid"


def _one_block_limit(device) -> int:
    """The largest S + N * F (S = a third of it) whose transpose takes the
    one-block form on ``device`` (the C side's shared-memory limit, found
    by bisection)."""
    lo, hi = 1, 2**22                 # fits(lo), not fits(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        fits = _form(mid // 3, mid - mid // 3, device) == "one-block"
        lo, hi = (mid, hi) if fits else (lo, mid)
    return lo


@pytest.mark.cuda
def test_transpose_kernel_equals_plain(cuda):
    """Both forms of the transpose equal the plain version bit for bit, in
    one device operation per call: the main path's shapes (a sampled layer
    1's per-step adj, masked slots naming their own dst row; GAT's layers 1
    and 0, head-stacked; RGAT's stacked layers 0 and 1 with dead slots at
    their own row; GAT layer 0 on the host sampler's layout, its padded
    rows' slots all naming row 0, and the same without them; GAT layer
    0's shape with 20% of its slots at row 0), the one-block limit and
    one past it in S and in N * F (with out-of-range entries and
    without), N * F = 0, every slot naming one row (longer than a warp,
    and over many of the long-row bitmap's windows), out-of-range entries
    and rows named by no slot. Each small case runs
    again over S + the one-block limit rows (never named), which takes the
    grid form."""
    import chip_smoke as cs
    from coala_gnn_tpu_torch.models.layers import head_stacked_adj

    dev = torch.device("cuda")
    one = _one_block_limit(dev)
    assert 48 * 1024 // 4 < one < 232_448 // 4 + 1

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=cuda, device="cuda",
                             dtype=torch.int32)

    packed = ints(0, 6144, (1024, 5))
    own = torch.arange(1024, device="cuda", dtype=torch.int32)[:, None]
    packed = torch.where(torch.rand(1024, 5, generator=cuda, device="cuda")
                         < 0.2, own.expand(1024, 5), packed)
    cases = [(packed, 6144, "one-block"),
             (head_stacked_adj(None, 6144, (1024, 5), 4, "cuda"), 6144 * 4,
              "one-block"),
             (*cs.rgat_stacked_adj(torch, cuda, 1), "grid"),
             (*cs.rgat_stacked_adj(torch, cuda, 0), "grid"),
             (head_stacked_adj(None, 67_584, (6144, 10), 4, "cuda"),
              67_584 * 4, "grid"),
             (*cs.gat_host_adj(torch, cuda), "grid"),
             (*cs.gat_host_adj(torch, cuda, padded=0.0), "grid")]
    s_lim = one // 3
    nf_lim = one - s_lim
    cases += [(ints(-3, s_lim + 3, (nf_lim, 1)), s_lim, "one-block"),
              (ints(-3, s_lim + 3, (nf_lim + 1, 1)), s_lim, "grid"),
              (ints(-3, s_lim + 3, (nf_lim, 1)), s_lim + 1, "grid"),
              (ints(0, s_lim, (nf_lim, 1)), s_lim + 1, "grid")]
    small = [(ints(0, 50, (300, 7)), 50),                   # repeated rows
             (ints(900, 910, (40, 3)), 5000),               # unnamed rows
             (ints(-5, 105, (64, 9)), 100),                 # out of range
             (torch.zeros(0, 5, device="cuda", dtype=torch.int32), 100),
             (torch.full((600, 5), 17, device="cuda", dtype=torch.int32),
              50)]                                          # one long row
    cases += [(adj, s, "one-block") for adj, s in small]
    cases += [(adj, s + one, "grid") for adj, s in small]
    spread = torch.full((400_000, 5), 7, device="cuda", dtype=torch.int32)
    spread[::3] = ints(0, 1000, (spread[::3].shape[0], 5))
    cases.append((spread, 1000, "grid"))        # rows over many windows
    skew, _ = _adj_w(cuda, 270_336, 24_576, 10)    # GAT layer 0's shape,
    skew[torch.rand(skew.shape, generator=cuda, device="cuda") < 0.2] = 0
    cases.append((skew, 270_336, "grid"))          # 20% of slots at row 0
    for adj, s, form in cases:
        nf = adj.numel()
        got_form = _form(s, nf, adj.device)
        assert got_form == form, (s, nf, got_form)
        before = LAUNCHES["adj_transpose"]
        got = adj_transpose(adj, s)
        torch.cuda.synchronize()
        assert LAUNCHES["adj_transpose"] == before + 1
        want = adj_transpose_reference(adj, s)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            (s, nf, got_form)
    for adj, s, form in cases[:7]:
        assert len(cs.device_ops(torch, lambda: adj_transpose(adj, s))) == 1


@pytest.mark.cuda
def test_grad_x_at_gat_combine_shapes(cuda):
    """GAT's two head-stacked combine shapes at the flagship config (4
    heads; layer 0: 67,584 src x 6,144 dst rows, F 10, D 256; layer 1:
    6,144 x 1,024, F 5, D 16): exact against the plain version with the
    transpose handed in (no transpose launch) and without it; with
    repeated rows within the f32 sum bound."""
    from coala_gnn_tpu_torch.models.layers import head_stacked_adj

    for cap_src, cap_dst, F, D in [(67_584, 6144, 10, 256),
                                   (6144, 1024, 5, 16)]:
        S, N = cap_src * 4, cap_dst * 4
        adj = head_stacked_adj(None, cap_src, (cap_dst, F), 4, "cuda")
        _, w = _adj_w(cuda, S, N, F)
        g = torch.randn(N, D, generator=cuda, device="cuda")
        adj_t = adj_transpose(adj, S)
        counts = dict(LAUNCHES)
        gx = gather_spmm_grad_x(adj, w, g, S, adj_t)
        torch.cuda.synchronize()
        assert LAUNCHES["adj_transpose"] == counts["adj_transpose"]
        want = gather_spmm_grad_x_reference(adj, w, g, S)
        assert torch.equal(gx, want)
        assert torch.equal(gather_spmm_grad_x(adj, w, g, S), want)
        rand_adj, _ = _adj_w(cuda, S, N, F)
        gx = gather_spmm_grad_x(rand_adj, w, g, S)
        torch.cuda.synchronize()
        err = (gx - gather_spmm_grad_x_reference(rand_adj, w, g, S)).abs()
        assert (err <= grad_x_error_bound(rand_adj, w, g, S)).all()


@pytest.mark.cuda
def test_out_of_range_index_gives_nan_row(cuda):
    x = torch.randn(10, 128, generator=cuda, device="cuda")
    adj = torch.tensor([[1, 2], [3, 10], [-1, 0]], dtype=torch.int32,
                       device="cuda")
    w = torch.ones(3, 2, device="cuda")
    out = gather_spmm(x, adj, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[0], x[1] + x[2])
    assert out[1:].isnan().all()


@pytest.mark.cuda
def test_staged_window_on_card(cuda):
    """A small staged run on the card (set-associative cache far below the
    graph, degree priorities): one kernel launch per step, real misses, no
    replay, and the same losses as a flat full-coverage run on the same
    seeds and streams."""
    import numpy as np

    from coala_gnn_tpu_torch.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu_torch.graph.datasets import synthetic_graph
    from coala_gnn_tpu_torch.cache import feature_cache as fc
    from coala_gnn_tpu_torch.models.gnn import make_model
    from coala_gnn_tpu_torch.parallel.resident import ResidentTrainer

    ds = synthetic_graph(num_nodes=3000, avg_degree=8, feature_dim=32,
                         num_classes=8, seed=21)
    store = HostFeatureStore(ds.features)
    rng = np.random.default_rng(0)
    grids = np.stack([np.stack([rng.choice(ds.train_idx, 64, replace=False)
                                for _ in range(4)])
                      for _ in range(3)]).astype(np.int32)

    def run(cache_mb, **kw):
        model = make_model("sage", 32, 32, 8, 2, dropout=0.5,
                           seed=1).to("cuda")
        rt = ResidentTrainer(
            graph=ds.graph, host_fetch=store.fetch, labels=ds.labels,
            cache_cfg=fc.make_config(cache_mb, 32), model=model,
            optimizer=torch.optim.Adam(model.parameters(), lr=1e-2),
            fanouts=[5, 4], batch_size=64, device="cuda", **kw)
        rt.prewarm(np.arange(min(rt.cache_cfg.capacity, 3000),
                             dtype=np.int32))
        before = LAUNCHES["gather_spmm[float32]"]
        losses, _ = rt.train_windows(grids, seed=9)
        torch.cuda.synchronize()
        return rt, losses.cpu(), LAUNCHES["gather_spmm[float32]"] - before

    staged, l_staged, launches = run(0, priorities="degree")
    assert not staged.direct and staged.cache_cfg.capacity < 3000
    assert launches == grids.shape[0] * grids.shape[1]
    s = staged.stats()
    assert s["misses"] > 0 and s["hits"] > 0
    assert "replay" not in staged.timers.totals
    assert staged.cache.base.data.is_cuda
    flat, l_flat, _ = run(64)
    assert flat.direct and flat.full_coverage
    assert torch.isfinite(l_staged).all()
    torch.testing.assert_close(l_staged, l_flat, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_padded_mean_with_adj_launches_the_kernel(cuda):
    """The dedup layout's aggregation (``ops.aggregate.padded_mean`` with
    an adj, the host pipeline's SAGE layers) goes through the kernel on the
    card: one forward launch, and for an input that needs a gradient one
    transpose and one grad_x; the result and the gradient into x agree
    with the CPU plain version (the slot-order loop and its autograd)."""
    from coala_gnn_tpu_torch.ops import gather_spmm as ops
    from coala_gnn_tpu_torch.ops.aggregate import padded_mean

    S, N, F, D = 6144, 1024, 5, 256
    adj, w = _adj_w(cuda, S, N, F)
    mask = (w > 0).float()
    x = torch.randn(S, D, generator=cuda, device="cuda", requires_grad=True)
    g = torch.randn(N, D, generator=cuda, device="cuda")
    ops.reset_launches()
    out = padded_mean(x, adj, mask)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {**{k: 0 for k in LAUNCHES},
                              "gather_spmm[float32]": 1, "adj_transpose": 1,
                              "gather_spmm_grad_x": 1}
    x_cpu = x.detach().cpu().requires_grad_(True)
    ref = padded_mean(x_cpu, adj.cpu(), mask.cpu())
    (ref * g.cpu()).sum().backward()
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-5)
    count = mask.sum(dim=1).clamp_min(1.0)
    bound = grad_x_error_bound(adj, mask / count[:, None], g, S)
    assert ((x.grad.cpu() - x_cpu.grad).abs() <= bound.cpu() + 1e-6).all()


def _cli_args(*extra):
    from coala_gnn_tpu_torch import train as cli

    return cli.parse_args(["--num_nodes", "3000", "--feature_dim", "32",
                           "--hidden_channels", "32", "--batch_size", "64",
                           "--fan_out", "5,5", "--cache_size", "1",
                           "--max_steps", "6", "--epochs", "2"] + list(extra))


@pytest.mark.cuda
def test_nccl_world_one_is_the_one_card_path(cuda, tmp_path):
    """The trainer CLI's host loop in an NCCL process group of one rank
    (the data-parallel step's all-reduce, the miss decision's, the summed
    stats) gives the one-card path's losses, hit counts and cache state,
    bitwise. Whole epochs (7 steps of 256 seeds each): an epoch cut short
    by ``--max_steps`` leaves the sampler's stream wherever the loader's
    worker stopped, which depends on timing (ROADMAP.md section C)."""
    import torch.distributed as dist

    from coala_gnn_tpu_torch import train as cli
    from coala_gnn_tpu_torch.parallel import multihost
    from coala_gnn_tpu_torch.parallel.mesh import make_mesh

    args = _cli_args("--max_steps", "0", "--batch_size", "256")
    runs = []
    for grouped in (False, True):
        if grouped:
            multihost.initialize_distributed(
                "nccl", f"file://{tmp_path / 'store'}", 1, 0)
        try:
            mesh = make_mesh("cuda:0")
            run = cli.build(args, mesh=mesh)
            out = cli.train(run)
            state = run.cache.state.base
            runs.append((out["losses"], out["stats"], state.tags.cpu(),
                         state.data.cpu(), mesh.ledger.snapshot()))
        finally:
            if grouped:
                dist.destroy_process_group()
    (la, sa, ta, da, _), (lb, sb, tb, db, ledger) = runs
    assert la.tobytes() == lb.tobytes() and sa == sb
    assert torch.equal(ta, tb) and torch.equal(da, db)
    assert ledger["calls"]["grad"] == len(lb) == 14


@pytest.mark.cuda
def test_gloo_two_ranks_on_one_card_match_the_cpu(cuda):
    """Two ranks on the one card over gloo (its CUDA collectives stage
    through the host) train, in each cache mode, the losses of the same
    two ranks on the CPU (2e-3 / 2e-4), dropout 0; whole epochs, as in
    ``test_nccl_world_one_is_the_one_card_path``."""
    import torch_multigpu_ranks as ranks
    from coala_gnn_tpu_torch.parallel.multihost import launch

    for mode in ("sharded", "node_local", "isolated"):
        runs = [dict(args=_cli_args("--cache_backend", mode, "--devices",
                                    "2", "--max_steps", "0",
                                    "--batch_size", "256"))]
        got = [[r[0] for r in launch(ranks.cli_runs, 2, devices, "gloo",
                                     args=(runs,))]
               for devices in (["cuda:0", "cuda:0"], ["cpu", "cpu"])]
        for card, cpu in zip(*got):
            torch.testing.assert_close(torch.from_numpy(card["losses"]),
                                       torch.from_numpy(cpu["losses"]),
                                       rtol=2e-3, atol=2e-4)
            assert card["stats"] == cpu["stats"]
            assert card["launches"]["gather_spmm[float32]"] > 0
