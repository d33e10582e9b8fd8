"""The CUDA gather-SpMM kernel against its plain version, on a card.

Needs a CUDA card and nvcc; skipped without a card. This file imports no
JAX, so it runs on a machine that has none:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: tests/conftest.py sets JAX up.) Tolerance 1e-5: both
sides widen the table rows exactly to f32 and sum them in the same slot
order, apart only by fused vs separate multiply-add."""

import pytest
import torch

from coala_gnn_tpu_torch.ops.gather_spmm import (gather_spmm,
                                                 gather_spmm_reference)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, dtype):
    for S, N, F, D in [(100, 40, 5, 128), (64, 300, 3, 256),
                       (50, 17, 10, 128), (1000, 6144, 10, 256), (9, 3, 1, 8)]:
        x = torch.randn(S, D, generator=cuda, device="cuda").to(dtype)
        adj = torch.randint(0, S, (N, F), generator=cuda, device="cuda",
                            dtype=torch.int32)
        w = torch.rand(N, F, generator=cuda, device="cuda")
        w[:, 0] = 0.0                                   # masked slots
        before = gather_spmm.launches
        out = gather_spmm(x, adj, w)
        torch.cuda.synchronize()
        assert gather_spmm.launches == before + 1
        torch.testing.assert_close(out, gather_spmm_reference(x, adj, w),
                                   rtol=1e-5, atol=1e-5)


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
        before = gather_spmm.launches
        losses, _ = rt.train_windows(grids, seed=9)
        torch.cuda.synchronize()
        return rt, losses.cpu(), gather_spmm.launches - before

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
