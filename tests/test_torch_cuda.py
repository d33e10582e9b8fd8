"""The CUDA gather-SpMM kernels (f32, bf16 and int8 forward, grad_w,
grad_x) against their plain versions, on a card.

Needs a CUDA card and nvcc; skipped without a card. This file imports no
JAX, so it runs on a machine that has none:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: tests/conftest.py sets JAX up.) Forward tolerance
1e-5: both sides widen (or dequantise) the table rows exactly as the plain
version does and sum them in the same slot order, apart only by fused vs
separate multiply-add. The backward kernels sum in another order than
their plain versions; they are held to the f32 error bound of those sums
(``grad_w_error_bound``, ``grad_x_error_bound``), and grad_x is exact where
no table row is referenced twice."""

import pytest
import torch

from coala_gnn_tpu_torch.ops.gather_spmm import (
    LAUNCHES, gather_spmm, gather_spmm_grad_w_reference,
    gather_spmm_grad_x_reference, gather_spmm_reference, grad_w_error_bound,
    grad_x_error_bound)

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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_kernels_match_plain(cuda, dtype):
    """grad_w (every slot, w == 0 included) and grad_x, on random adj
    (repeated rows: within the bound) and on a permutation (each table row
    referenced once: grad_x exact)."""
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
            assert LAUNCHES["gather_spmm_grad_w"] == \
                counts["gather_spmm_grad_w"] + 1
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


SHAPES = [(100, 40, 5, 128), (64, 300, 3, 256), (50, 17, 10, 128),
          (1000, 6144, 10, 256), (9, 3, 1, 8), (60, 20, 5, 100),
          (2000, 50, 7, 100), (300, 40, 5, 16), (61, 7, 3, 1)]


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
    grad_w and grad_x on each of 2 layers) and the same losses as the CPU
    port (dropout 0; the CPU port is held to JAX by the CPU tests)."""
    import numpy as np

    from coala_gnn_tpu.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu.graph.datasets import synthetic_graph
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
    assert not any(out["cpu"][1].values())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=2e-3,
                               atol=2e-4)


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

    from coala_gnn_tpu.cache.host_tier import HostFeatureStore
    from coala_gnn_tpu.graph.datasets import synthetic_graph
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
