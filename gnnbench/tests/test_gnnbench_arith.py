"""The counting arithmetic, checked by hand on small blocks."""

import pytest
import torch

from gnnbench import arith
from gnnbench.reference.sampler import capacities


def test_busy_is_the_union_of_intervals():
    assert arith.busy_s([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert arith.busy_s([]) == 0.0


def test_forward_work_counts_each_distinct_live_row_once():
    # rows 1 and 2 live (row 1 twice), row 3 dead (w 0), 9 out of range
    adj = torch.tensor([[1, 1], [2, 3], [9, 2]], dtype=torch.int32)
    w = torch.tensor([[1.0, 1.0], [1.0, 0.0], [1.0, 1.0]])
    nbytes, ops = arith.forward_work(4, 8, 4, False, adj, w)
    # 2 rows x 8 x 4 B, adj + w 6 x 8 B, out 3 x 8 x 4 B
    assert nbytes == 2 * 32 + 6 * 8 + 3 * 32
    assert ops == 4 * 8 * 2          # 4 live slots in range
    nbytes8, ops8 = arith.forward_work(4, 8, 1, True, adj, w)
    assert nbytes8 == 2 * (8 + 4) + 6 * 8 + 3 * 32
    assert ops8 == 4 * 8 * 3


def test_backward_and_transpose_work():
    adj = torch.tensor([[0, 1], [1, 1]], dtype=torch.int32)
    w = torch.tensor([[1.0, 0.0], [0.0, 0.0]])
    assert arith.grad_w_work(16, 4, adj, 2 * 16) == (
        2 * 16 * 4 + 32 * 4 + 4 * 8, 2 * 4 * 16)
    # one g row live, 3 table rows written
    assert arith.grad_x_work(adj, w, 16, 3) == (
        4 * 4 + 4 * 8 + 1 * 16 * 4 + 3 * 16 * 4, 2 * 1 * 16)
    assert arith.transpose_work(adj, 3) == (4 * 8 + 4 * 4, 0)


def test_bound_is_the_larger_of_bytes_and_operations():
    assert arith.bound(3.35e12, 0) == pytest.approx(1.0)
    assert arith.bound(0, 67e12) == pytest.approx(1.0)
    assert arith.bound(3.35e9, 134e12) == pytest.approx(2.0)


def test_step_flops_by_hand():
    dims = arith.layer_dims("sage", 8, 4, 3, 2)
    assert dims == [(8, 4), (4, 3)]
    # SAGE: two fcs; layer 0 forward + weight gradient; layer 1 also the
    # input gradient
    assert arith.step_flops("sage", dims, [5, 2]) == (
        2 * 2 * 2 * 5 * 8 * 4 + 2 * 3 * 2 * 2 * 4 * 3)
    gdims = arith.layer_dims("gat", 8, 4, 3, 2, heads=2)
    assert gdims == [(8, 8), (8, 6)]
    assert arith.step_flops("gat", gdims, [7, 3]) == (
        2 * 2 * 7 * 8 * 8 + 3 * 2 * 3 * 8 * 6)


def test_distinct_rows_of_a_frontier():
    ids = torch.tensor([3, 1, 3, 9, 2, 1, 9])      # 9 = padding
    assert arith.distinct(ids, 9) == 3
    assert arith.distinct(ids, 9, n=3) == 2
    caps = capacities(2, [3, 2])
    assert caps == [(6, 24), (2, 6)]


def test_a_trace_that_stops_short_of_a_window_end_is_found():
    from gnnbench import trace
    wins = [(0.0, 1.0), (1.0, 2.0)]
    whole = [("k", 0.1, 0.5), ("DtoH", 0.99, 0.995), ("k", 1.1, 1.5),
             ("DtoH", 1.99, 1.999)]
    gaps = trace.tail_gaps(whole, wins)
    assert max(gaps) <= trace.TAIL_S
    # the profiler stopped 0.5 s into the second window
    cut = whole[:3]
    assert trace.tail_gaps(cut, wins)[1] == pytest.approx(0.5)
    # nothing of the second window at all: its whole length
    assert trace.tail_gaps(whole[:2], wins)[1] == pytest.approx(1.0)
