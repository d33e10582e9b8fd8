"""Host -> device batch packing (port of ``coala_gnn_tpu/data/packing.py``).

A whole batch crosses to the device as ONE int32 buffer, one transfer per
step:

- the fanout mask is folded into the adjacency's sign: invalid slots
  become -1, so ``mask = adj >= 0`` on the device;
- labels ride in the same buffer;
- the request form puts ``[num_input | input_ids]`` in front, so the same
  buffer serves the cache probe and the train step;
- the contiguous (slot-major) form carries ``[num_input | ids | labels]``
  only: the adjacency is implicit in the layout and masks follow from
  ``ids != sentinel``.

The ``pack_*`` functions are numpy and byte-identical to the JAX
package's. The ``unpack_*`` functions are torch functions on the buffer's
device (slices and views, no host round trip); labels come back int32.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from coala_gnn_tpu_torch.models.layers import DeviceBlock

Layout = Tuple[Tuple[int, int], ...]   # ((cap_dst, fanout), ...) per layer


def batch_layout(caps: Sequence[Tuple[int, int]],
                 fanouts: Sequence[int]) -> Layout:
    """Layout from the sampler's capacities: [(cap_dst, fanout)] per
    layer."""
    return tuple((cap_dst, f) for (cap_dst, _), f in zip(caps, fanouts))


def packed_size(layout: Layout, batch_size: int) -> int:
    """Entries of ``pack_batch``'s buffer."""
    return sum(cd * f for cd, f in layout) + batch_size


def request_size(n_req: int, layout: Layout, batch_size: int) -> int:
    """Entries of ``pack_request``'s buffer."""
    return 1 + n_req + packed_size(layout, batch_size)


def request_size_contig(n_req: int, batch_size: int) -> int:
    """Entries of ``pack_request_contig``'s buffer."""
    return 1 + n_req + batch_size


def pack_batch(adjs: Sequence[np.ndarray], masks: Sequence[np.ndarray],
               labels: np.ndarray) -> np.ndarray:
    """int32 [sum(cap_dst * fanout) + B]; adjs / masks per layer
    [cap_dst, fanout] (one device)."""
    parts = [np.where(mask > 0, adj, -1).astype(np.int32).reshape(-1)
             for adj, mask in zip(adjs, masks)]
    parts.append(np.ascontiguousarray(labels, dtype=np.int32))
    return np.concatenate(parts)


def unpack_batch(buf: torch.Tensor, layout: Layout, batch_size: int,
                 offset: int = 0) -> Tuple[List[DeviceBlock], torch.Tensor]:
    """buffer -> (blocks, labels int32 [B])."""
    blocks = []
    off = offset
    for cap_dst, fanout in layout:
        n = cap_dst * fanout
        enc = buf[off:off + n].view(cap_dst, fanout)
        off += n
        blocks.append(DeviceBlock(adj=enc.clamp_min(0),
                                  mask=(enc >= 0).to(torch.float32)))
    return blocks, buf[off:off + batch_size]


def pack_request(input_ids: np.ndarray, num_input: int,
                 adjs: Sequence[np.ndarray], masks: Sequence[np.ndarray],
                 labels: np.ndarray) -> np.ndarray:
    """[num_input | input_ids | pack_batch(...)] int32."""
    head = np.empty(1 + input_ids.shape[0], dtype=np.int32)
    head[0] = num_input
    head[1:] = input_ids
    return np.concatenate([head, pack_batch(adjs, masks, labels)])


def unpack_request_ids(buf: torch.Tensor, n_req: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids int32 [n_req], num_valid int32 []) of a request buffer."""
    return buf[1:1 + n_req], buf[0]


def unpack_request_batch(buf: torch.Tensor, n_req: int, layout: Layout,
                         batch_size: int
                         ) -> Tuple[List[DeviceBlock], torch.Tensor]:
    return unpack_batch(buf, layout, batch_size, offset=1 + n_req)


def pack_request_contig(input_ids: np.ndarray, num_input: int,
                        labels: np.ndarray) -> np.ndarray:
    """[num_input | ids (slot-major, sentinel-marked) | labels] int32."""
    n_req = input_ids.shape[0]
    out = np.empty(1 + n_req + labels.shape[0], dtype=np.int32)
    out[0] = num_input
    out[1:1 + n_req] = input_ids
    out[1 + n_req:] = labels
    return out


def unpack_request_contig(buf: torch.Tensor, n_req: int, layout: Layout,
                          batch_size: int, sentinel: int
                          ) -> Tuple[List[DeviceBlock], torch.Tensor]:
    """[num_input | ids | labels] -> (blocks with adj=None, labels int32
    [B]): layer l's mask compares its slot segment of the ids, viewed
    [fanout, cap_dst] and transposed, with the sentinel."""
    ids = buf[1:1 + n_req]
    blocks = []
    for cap_dst, fanout in layout:
        seg = ids[cap_dst:cap_dst + cap_dst * fanout]
        mask = (seg.view(fanout, cap_dst).T != sentinel).to(torch.float32)
        blocks.append(DeviceBlock(adj=None, mask=mask.contiguous()))
    return blocks, buf[1 + n_req:1 + n_req + batch_size]
