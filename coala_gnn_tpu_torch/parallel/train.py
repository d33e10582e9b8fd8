"""Train and eval steps of the host pipeline (port of
``coala_gnn_tpu/parallel/train.py``, one device).

Each ``make_*`` returns a plain function over the ``model`` and
``optimizer`` it was made with: a train step runs the forward, the mean
softmax cross-entropy over the first ``batch_size`` output rows (the seeds;
padded dst rows beyond them carry no gradient), the backward and the
optimizer step, updating both in place where JAX returns new params and
optimizer state, and returns ``(loss, accuracy)`` as device scalars (no
host sync). Dropout draws from the ``generator`` the caller passes, one
per step (``utils/rng.py``); ``None`` is fine without dropout. Labels may
be int32, as the packed buffers carry them.

The request forms read blocks and labels out of the step's one request
buffer (``data/packing.py``). The ``sharded`` forms take inputs with the
JAX steps' leading device axis; more than one device raises (ROADMAP.md
queue A, "multi-GPU").
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from coala_gnn_tpu_torch.data.packing import (Layout, unpack_batch,
                                              unpack_request_batch,
                                              unpack_request_contig)
from coala_gnn_tpu_torch.models.layers import DeviceBlock


def _learn(model: nn.Module, optimizer: torch.optim.Optimizer,
           blocks: List[DeviceBlock], x, labels: torch.Tensor,
           batch_size: int, generator: Optional[torch.Generator],
           weights: Optional[torch.Tensor] = None):
    """One update -> (loss, accuracy). ``weights`` (f32 [B]): the masked
    mean, sum(ce * w) / max(sum(w), 1), and accuracy over the weighted
    seeds."""
    logits = model(blocks, x, train=True, generator=generator)[:batch_size]
    y = labels.long()
    if weights is None:
        loss = F.cross_entropy(logits, y)
    else:
        n = weights.sum().clamp_min(1.0)
        loss = (F.cross_entropy(logits, y, reduction="none") * weights
                ).sum() / n
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    ok = (logits.detach().argmax(-1) == y).float()
    acc = ok.mean() if weights is None else (ok * weights).sum() / n
    return loss.detach(), acc


def _one_row(buf: torch.Tensor) -> torch.Tensor:
    """A request buffer [L], or the single-device grid [1, L]."""
    return buf[0] if buf.dim() == 2 else buf


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    batch_size: int) -> Callable:
    """step(blocks, x, labels, generator=None) -> (loss, acc)."""
    def step(blocks, x, labels, generator=None):
        return _learn(model, optimizer, blocks, x, labels, batch_size,
                      generator)
    return step


def make_packed_train_step(model: nn.Module,
                           optimizer: torch.optim.Optimizer,
                           batch_size: int, layout: Layout) -> Callable:
    """step(packed, x, generator=None): blocks and labels unpacked from
    one ``pack_batch`` buffer on the device."""
    def step(packed, x, generator=None):
        blocks, labels = unpack_batch(packed, layout, batch_size)
        return _learn(model, optimizer, blocks, x, labels, batch_size,
                      generator)
    return step


def make_request_train_step(model: nn.Module,
                            optimizer: torch.optim.Optimizer,
                            batch_size: int, layout: Layout,
                            n_req: int) -> Callable:
    """step(buf, x, generator=None) on the request buffer the cache probe
    read (``pack_request``)."""
    def step(buf, x, generator=None):
        blocks, labels = unpack_request_batch(_one_row(buf), n_req, layout,
                                              batch_size)
        return _learn(model, optimizer, blocks, x, labels, batch_size,
                      generator)
    return step


def make_contig_train_step(model: nn.Module,
                           optimizer: torch.optim.Optimizer,
                           batch_size: int, layout: Layout, n_req: int,
                           sentinel: int) -> Callable:
    """step(buf, x, generator=None) on the contiguous request buffer
    ``[n_valid | ids | labels]`` (``pack_request_contig``): masks from
    ``ids != sentinel``, adjacency implicit."""
    def step(buf, x, generator=None):
        blocks, labels = unpack_request_contig(_one_row(buf), n_req, layout,
                                               batch_size, sentinel)
        return _learn(model, optimizer, blocks, x, labels, batch_size,
                      generator)
    return step


def _one_device(devices: Sequence) -> None:
    if len(devices) != 1:
        raise NotImplementedError(
            f"a data-parallel step over {len(devices)} devices is not "
            "ported yet: ROADMAP.md queue A, \"multi-GPU\"")


def _squeeze(blocks: Sequence[DeviceBlock]) -> List[DeviceBlock]:
    """Blocks with the leading device axis -> this device's blocks, of the
    same type (a ``DeviceHeteroBlock`` keeps its ``rel``)."""
    return [b._replace(**{f: None if getattr(b, f) is None else
                          getattr(b, f)[0] for f in b._fields})
            for b in blocks]


def make_sharded_train_step(model: nn.Module,
                            optimizer: torch.optim.Optimizer,
                            devices: Sequence, batch_size: int,
                            masked: bool = False) -> Callable:
    """step(blocks, x, labels, valid=None, generator=None) -> (loss, acc)
    on inputs with a leading device axis: blocks' leaves [1, ...], x [1,
    cap_src, dim], labels [1, B]. ``masked=True``: ``valid`` bool [1, B]
    (``SeedDistributor.distribute(return_valid=True)``) weights the loss,
    so wrapped tail duplicates give no gradient; an all-true mask gives
    the unmasked mean."""
    _one_device(devices)

    def step(blocks, x, labels, valid=None, generator=None):
        weights = None
        if masked:
            if valid is None:
                raise ValueError("the masked step needs valid")
            weights = valid[0].to(torch.float32)
        return _learn(model, optimizer, _squeeze(blocks), x[0], labels[0],
                      batch_size, generator, weights)
    return step


def make_sharded_eval_step(model: nn.Module, devices: Sequence,
                           batch_size: int,
                           per_slot: bool = False) -> Callable:
    """step(blocks, x, labels) on inputs with the leading device axis ->
    the correct count (int64 []), or with ``per_slot`` the correctness
    grid bool [1, B], so the caller can leave out wrapped seeds."""
    _one_device(devices)

    @torch.no_grad()
    def step(blocks, x, labels):
        logits = model(_squeeze(blocks), x[0], train=False)[:batch_size]
        ok = logits.argmax(-1) == labels[0].long()
        return ok[None] if per_slot else ok.sum()
    return step


def make_eval_step(model: nn.Module, batch_size: int) -> Callable:
    """step(blocks, x, labels) -> (correct int64 [], number of labels)."""
    @torch.no_grad()
    def step(blocks, x, labels):
        logits = model(blocks, x, train=False)[:batch_size]
        return (logits.argmax(-1) == labels.long()).sum(), labels.shape[0]
    return step
