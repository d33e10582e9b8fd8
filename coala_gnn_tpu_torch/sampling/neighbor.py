"""Static block capacities of fanout sampling (port of
``coala_gnn_tpu/sampling/neighbor.py:block_capacities``)."""

from __future__ import annotations

from typing import List, Sequence, Tuple


def block_capacities(batch_size: int, fanouts: Sequence[int]
                     ) -> List[Tuple[int, int]]:
    """[(cap_dst, cap_src)] per layer, input-most first:
    cap_dst[l] = B * prod_{j>l}(f_j + 1), cap_src[l] = cap_dst[l] * (f_l + 1).
    The output layer has cap_dst = B."""
    caps = []
    cap_dst = batch_size
    for f in reversed(fanouts):  # output-most -> input-most
        caps.append((cap_dst, cap_dst * (f + 1)))
        cap_dst = cap_dst * (f + 1)
    return list(reversed(caps))
