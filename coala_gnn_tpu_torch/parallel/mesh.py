"""The ranks that train together (port of ``coala_gnn_tpu/parallel/mesh.py``).

The JAX package runs one process per host with every local device on one
mesh axis. The port runs one process per card, as the reference COALA-GNN
does: a ``Mesh`` is this rank's place among the ranks of a
``torch.distributed`` process group (its device, rank, world size and the
host it belongs to; hosts are contiguous blocks of ``local_size`` ranks,
as JAX's mesh lays hosts out) and the process groups its collectives run
over. The JAX module's ``replicated`` / ``data_sharded`` shardings have no
counterpart: every rank holds its own copy of the parameters and its own
slice of the batch.

A ``Mesh`` without a process group is one card on its own (world 1); its
steps and its cache run no collective at all. Once a group is initialised
(``multihost.initialize_distributed``) every collective goes through the
wrappers here, which count the bytes each rank hands over, by phase, in
the mesh's ``CommLedger``: ``comm_model.step_traffic`` is held against
those counts.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
from typing import Dict, Optional

import torch
import torch.distributed as dist


class CommLedger:
    """Bytes this rank handed to collectives since the last ``reset``, by
    phase: ``handed`` the payload of each call, ``kept`` the part of an
    all-to-all payload addressed to the rank itself (so ``handed - kept``
    is what leaves the rank), ``calls`` the number of calls. The meta
    exchange adds from the scheduler's thread, hence the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.handed: Dict[str, int] = collections.Counter()
        self.kept: Dict[str, int] = collections.Counter()
        self.calls: Dict[str, int] = collections.Counter()

    def add(self, phase: str, handed: int, kept: int = 0) -> None:
        with self._lock:
            self.handed[phase] += handed
            self.kept[phase] += kept
            self.calls[phase] += 1

    def snapshot(self) -> dict:
        return {"handed": dict(self.handed), "kept": dict(self.kept),
                "calls": dict(self.calls)}


@dataclasses.dataclass
class Mesh:
    """This rank's place among the training ranks. ``group`` is None for
    a card on its own (no process group); ``host_group`` holds this rank's
    host block, ``meta_group`` all ranks over gloo, for the cache-meta
    exchange that the scheduler runs in a thread of its own."""

    device: torch.device
    rank: int = 0
    world: int = 1
    local_size: int = 1
    group: Optional[object] = None
    host_group: Optional[object] = None
    meta_group: Optional[object] = None
    ledger: CommLedger = dataclasses.field(default_factory=CommLedger)
    _blocks: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def num_hosts(self) -> int:
        return self.world // self.local_size

    @property
    def host_id(self) -> int:
        return self.rank // self.local_size

    @property
    def local_rank(self) -> int:
        return self.rank % self.local_size

    def block_group(self, size: int):
        """The process group of this rank's block of ``size`` contiguous
        ranks (the whole world's group when ``size`` is the world). Every
        rank must ask for the same sizes in the same order: each block's
        group is made on all ranks, as ``dist.new_group`` requires."""
        if size == self.world:
            return self.group
        if self.world % size:
            raise ValueError(f"a block of {size} ranks does not divide the "
                             f"world of {self.world}")
        if size not in self._blocks:
            mine = None
            for b in range(self.world // size):
                g = dist.new_group(list(range(b * size, (b + 1) * size)))
                if b == self.rank // size:
                    mine = g
            self._blocks[size] = mine
        return self._blocks[size]

    # -- collectives, counted ------------------------------------------------

    def all_to_all(self, t: torch.Tensor, group, size: int,
                   phase: str) -> torch.Tensor:
        """``all_to_all_single`` of ``t`` [size, ...] over ``group``: row j
        goes to the group's rank j, and row j of the result came from it."""
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        self.ledger.add(phase, t.nbytes, t.nbytes // size)
        return out

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM, group=None,
                   phase: str = "control") -> torch.Tensor:
        """In-place ``all_reduce`` of ``t`` over ``group`` (default: every
        rank)."""
        dist.all_reduce(t, op=op, group=self.group if group is None
                        else group)
        self.ledger.add(phase, t.nbytes)
        return t

    def all_gather(self, t: torch.Tensor, phase: str) -> torch.Tensor:
        """Every rank's ``t`` [n, ...] stacked in rank order into one tensor
        [world * n, ...]. The rank hands its ``t`` to each rank (itself
        included), as the meta exchange counts it."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t, group=self.group)
        self.ledger.add(phase, t.nbytes * self.world, t.nbytes)
        return torch.cat(parts)

    def reduce_scatter(self, t: torch.Tensor, phase: str) -> torch.Tensor:
        """The sum over the ranks of ``t`` [world * n, ...], block r of it to
        rank r: [n, ...]. One ``all_to_all_single`` and a sum over the
        source axis (gloo has no reduce-scatter of CUDA tensors); exact
        where at most one rank's contribution to an entry is not zero, as
        in the sharded sampler's integer grids."""
        w = self.world
        got = self.all_to_all(t.reshape((w, -1) + tuple(t.shape[1:])),
                              self.group, w, phase)
        return got.sum(0, dtype=t.dtype)


def make_mesh(device, local_size: int = 0) -> Mesh:
    """This process's ``Mesh`` on ``device``. Without an initialised
    process group: one card on its own. With one: the group's rank and
    world, hosts of ``local_size`` ranks (default: ``LOCAL_WORLD_SIZE`` as
    torchrun sets it, else the whole world on one host), the host groups
    and a gloo group for the meta exchange. Collective: every rank calls
    it, in the same order as its other group-making calls."""
    device = _card(device)
    if not dist.is_initialized():
        if local_size > 1:
            raise ValueError(f"local_size {local_size} needs a process group "
                             "(multihost.initialize_distributed)")
        return Mesh(device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    local_size = local_size or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local_size < 1 or world % local_size:
        raise ValueError(f"{local_size} ranks per host do not divide the "
                         f"world of {world}")
    mesh = Mesh(device=device, rank=rank, world=world, local_size=local_size,
                group=dist.group.WORLD)
    mesh.host_group = mesh.block_group(local_size)
    # its own group even over gloo: the scheduler's thread runs it while
    # the main thread runs the exchange, and one group's calls must come
    # in the same order on every rank
    mesh.meta_group = dist.new_group(backend="gloo")
    return mesh


def _card(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def as_mesh(devices) -> Mesh:
    """A ``Mesh``, or a list of one device (a card on its own). More than
    one device in one process is not the port's layout: one process
    drives one card."""
    if isinstance(devices, Mesh):
        return devices
    devices = list(devices)
    if len(devices) != 1:
        raise ValueError(
            f"got {len(devices)} devices: the port runs one process per "
            "card; start the ranks with multihost.launch (or torchrun) and "
            "pass each rank's Mesh (mesh.make_mesh)")
    return Mesh(device=_card(devices[0]))
