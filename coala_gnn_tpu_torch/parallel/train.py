"""Train and eval steps of the host pipeline (port of
``coala_gnn_tpu/parallel/train.py``).

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
buffer (``data/packing.py``). The ``sharded`` forms are the data-parallel
steps: they take a ``Mesh`` (``parallel/mesh.py``; a list of one device is
a card on its own) and inputs with the JAX steps' leading device axis, [1,
...], this rank's slice. Each rank runs its own forward and backward, then
one ``all_reduce`` (SUM) of a flat f32 buffer of every gradient with the
loss and the accuracy appended, over all ranks; the unmasked step divides
it by the world size (JAX's ``pmean``). The masked step optimises the
global masked mean, ``sum(ce * w) / n_glob`` with ``n_glob`` from a first
``all_reduce`` of ``w.sum()``, and sums the gradients (JAX's ``psum``).
Every rank then applies the same update to its copy of the parameters.
The collectives are explicit (not ``DistributedDataParallel``): the masked
step needs the psum, and the steps update in place. A mesh with no process
group (a card on its own) runs no collective; a process group of one rank
runs them, which leaves every value as it is.
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
from coala_gnn_tpu_torch.parallel.mesh import Mesh, as_mesh


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


def _squeeze(blocks: Sequence[DeviceBlock]) -> List[DeviceBlock]:
    """Blocks with the leading device axis -> this device's blocks, of the
    same type (a ``DeviceHeteroBlock`` keeps its ``rel``)."""
    return [b._replace(**{f: None if getattr(b, f) is None else
                          getattr(b, f)[0] for f in b._fields})
            for b in blocks]


def _learn_sharded(mesh: Mesh, model: nn.Module,
                   optimizer: torch.optim.Optimizer,
                   blocks: List[DeviceBlock], x, labels: torch.Tensor,
                   batch_size: int, generator: Optional[torch.Generator],
                   weights: Optional[torch.Tensor] = None):
    """``_learn`` over the mesh's ranks (module docstring) -> (loss,
    accuracy), both the global values."""
    if weights is not None:
        n_glob = mesh.all_reduce(weights.sum().reshape(1)).clamp_min(1.0)[0]
    logits = model(blocks, x, train=True, generator=generator)[:batch_size]
    y = labels.long()
    if weights is None:
        loss = F.cross_entropy(logits, y)
    else:
        loss = (F.cross_entropy(logits, y, reduction="none") * weights
                ).sum() / n_glob
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    ok = (logits.detach().argmax(-1) == y).float()
    acc = ok.mean() if weights is None else (ok * weights).sum()
    params = [p for p in model.parameters() if p.requires_grad]
    flat = torch.cat([p.grad.reshape(-1).float() if p.grad is not None
                      else torch.zeros(p.numel(), device=acc.device)
                      for p in params]
                     + [loss.detach().reshape(1).float(), acc.reshape(1)])
    mesh.all_reduce(flat, phase="grad")
    if weights is None:
        flat /= mesh.world
    at = 0
    for p in params:
        g = flat[at:at + p.numel()].view_as(p).to(p.dtype)
        p.grad = g
        at += p.numel()
    optimizer.step()
    loss, acc = flat[-2], flat[-1]
    return loss, acc if weights is None else acc / n_glob


def make_sharded_train_step(model: nn.Module,
                            optimizer: torch.optim.Optimizer,
                            devices, batch_size: int,
                            masked: bool = False) -> Callable:
    """step(blocks, x, labels, valid=None, generator=None) -> (loss, acc)
    on this rank's inputs with the leading device axis: blocks' leaves [1,
    ...], x [1, cap_src, dim], labels [1, B]; the data-parallel step over
    ``devices`` (a ``Mesh``, or a list of one device). ``masked=True``:
    ``valid`` bool [1, B] (``SeedDistributor.distribute(return_valid=
    True)``) weights the loss, so wrapped tail duplicates give no
    gradient; an all-true mask gives the unmasked mean. ``generator``:
    this rank's dropout stream."""
    mesh = as_mesh(devices)
    learn = _learn if not mesh.distributed else \
        (lambda *a: _learn_sharded(mesh, *a))

    def step(blocks, x, labels, valid=None, generator=None):
        weights = None
        if masked:
            if valid is None:
                raise ValueError("the masked step needs valid")
            weights = valid[0].to(torch.float32)
        return learn(model, optimizer, _squeeze(blocks), x[0], labels[0],
                     batch_size, generator, weights)
    return step


def make_sharded_eval_step(model: nn.Module, devices,
                           batch_size: int,
                           per_slot: bool = False) -> Callable:
    """step(blocks, x, labels) on this rank's inputs with the leading
    device axis -> the correct count over every rank (int64 [], one
    ``all_reduce``), or with ``per_slot`` this rank's correctness grid
    bool [1, B], so the caller can leave out wrapped seeds."""
    mesh = as_mesh(devices)

    @torch.no_grad()
    def step(blocks, x, labels):
        logits = model(_squeeze(blocks), x[0], train=False)[:batch_size]
        ok = logits.argmax(-1) == labels[0].long()
        if per_slot:
            return ok[None]
        n = ok.sum()
        if mesh.distributed:
            n = mesh.all_reduce(n.reshape(1))[0]
        return n
    return step


def make_eval_step(model: nn.Module, batch_size: int) -> Callable:
    """step(blocks, x, labels) -> (correct int64 [], number of labels)."""
    @torch.no_grad()
    def step(blocks, x, labels):
        logits = model(blocks, x, train=False)[:batch_size]
        return (logits.argmax(-1) == labels.long()).sum(), labels.shape[0]
    return step
