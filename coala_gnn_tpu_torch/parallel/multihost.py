"""Process topology: start the ranks, join them in a process group, and
the cross-host control-plane collective (port of
``coala_gnn_tpu/parallel/multihost.py``).

The JAX package runs one process per host (``jax.distributed``); the port
runs one process per card over ``torch.distributed``, the reference
COALA-GNN's layout: NCCL for CUDA tensors, gloo for CPU tensors. A
"part" of the seed distributor is a host, a contiguous block of
``local_size`` ranks, and each rank serves its own slice of its host's
part. JAX's ``put_local`` / ``read_*`` have no counterpart: a rank only
ever holds its own slice.

- ``initialize_distributed``: the process group, from explicit arguments,
  from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``) or from the JAX
  package's ``COALA_COORDINATOR`` / ``COALA_NUM_PROCS`` /
  ``COALA_PROC_ID``; a no-op at world 1 without them.
- ``launch``: ``world`` ranks on this machine, spawned, joined through a
  file store in a fresh temporary directory (no port to collide on), each
  running ``fn(mesh, ...)`` (the call handed over as a file there);
  returns what each rank's ``fn`` returned.
- ``make_meta_exchange_fn``: every host's cache color counters (the sum
  over its ranks), gathered to ``[num_hosts, C + 1]`` on every rank.

The backend is always named by the caller (``backend_for`` gives the
default of a device): nothing switches to another backend when one fails.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import os
import shutil
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from coala_gnn_tpu_torch.parallel.mesh import Mesh, make_mesh


def backend_for(device) -> str:
    """The process group backend for tensors on ``device``: nccl on a
    card, else ``COALA_CPU_COLLECTIVES`` (default gloo), the JAX
    package's switch for its CPU collectives."""
    if torch.device(device).type == "cuda":
        return "nccl"
    return os.environ.get("COALA_CPU_COLLECTIVES", "gloo")


def initialize_distributed(backend: str, init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           timeout: Optional[float] = None) -> bool:
    """Join the process group over ``backend``. Without ``world_size`` the
    environment says: torchrun's ``WORLD_SIZE`` / ``RANK`` (rendezvous
    ``env://``), else ``COALA_NUM_PROCS`` / ``COALA_PROC_ID`` with
    ``tcp://$COALA_COORDINATOR``; with neither, nothing happens (one card
    on its own). ``timeout``: seconds a collective may wait for the other
    ranks before it fails (default: torch's). Returns whether a group is
    up."""
    env = os.environ
    if world_size is None:
        if "WORLD_SIZE" in env:
            world_size, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
            init_method = init_method or "env://"
        elif env.get("COALA_COORDINATOR"):
            world_size = int(env.get("COALA_NUM_PROCS", 1))
            rank = int(env.get("COALA_PROC_ID", 0))
            init_method = init_method or f"tcp://{env['COALA_COORDINATOR']}"
        else:
            return False
    if rank is None or init_method is None:
        raise ValueError("initialize_distributed needs rank and init_method "
                         "with an explicit world_size")
    kw = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    return True


def topology(mesh: Optional[Mesh] = None):
    """(num_hosts, host_id, local_size, rank) of ``mesh`` (default: the
    process group, hosts of ``LOCAL_WORLD_SIZE`` ranks) — the reference
    comm manager's num_nodes / node_id / local_size, and the rank."""
    if mesh is None:
        if not dist.is_initialized():
            return 1, 0, 1, 0
        world, rank = dist.get_world_size(), dist.get_rank()
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        return world // local, rank // local, local, rank
    return mesh.num_hosts, mesh.host_id, mesh.local_size, mesh.rank


def make_meta_exchange_fn(mesh: Mesh, num_colors: int
                          ) -> Callable[[np.ndarray], np.ndarray]:
    """fn(this rank's color counters int32 [C + 1]) -> every host's
    counters int32 [num_hosts, C + 1], the sum over each host's ranks
    (the reference's gather_cache_meta: a per-node reduce, then a gather
    across nodes), as one ``all_gather`` over the mesh's gloo meta group.
    It runs in the scheduler's thread. Every rank calls it at the same
    refreshes."""
    if not mesh.distributed:
        return lambda local: np.asarray(local, np.int32)[None, :]

    def fn(local: np.ndarray) -> np.ndarray:
        t = torch.from_numpy(np.ascontiguousarray(local, dtype=np.int32))
        parts = [torch.empty_like(t) for _ in range(mesh.world)]
        dist.all_gather(parts, t, group=mesh.meta_group)
        mesh.ledger.add("meta", t.nbytes * mesh.world, t.nbytes)
        per_rank = torch.stack(parts).numpy().astype(np.int64)
        return per_rank.reshape(mesh.num_hosts, mesh.local_size,
                                num_colors + 1).sum(1).astype(np.int32)

    return fn


def launch(fn: Callable, world: int, devices: Sequence, backend: str,
           local_size: int = 0, args: tuple = (),
           kwargs: Optional[dict] = None, threads: int = 0,
           timeout: Optional[float] = None) -> list:
    """Run ``fn(mesh, *args, **kwargs)`` on ``world`` spawned ranks, rank
    r on ``devices[r]`` over ``backend``, hosts of ``local_size`` ranks
    (default: all on one host), and return each rank's result (its
    ``fn``'s return value, which must pickle; tensors on the CPU).
    ``fn`` must be importable by name from a module that the ranks can
    import. Ranks other than 0 print nothing. A CPU rank takes
    ``threads`` intra-op threads (default: this machine's cores over
    ``world``). ``timeout``: the process group's, in seconds (a rank that
    waits longer on a collective fails, so a hang ends). If a rank raises,
    the others are stopped and the error is raised here."""
    import torch.multiprocessing as mp

    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices, got "
                         f"{len(devices)}")
    tmp = tempfile.mkdtemp(prefix="coala_ranks_")
    try:
        # the call goes to the ranks as one file, not through the spawn
        # pipe, which would move every tensor into shared memory one by one
        torch.save((fn, args, kwargs or {}), os.path.join(tmp, "call.pt"))
        mp.start_processes(
            _rank_main, args=(world, [str(d) for d in devices], backend,
                              local_size, threads, tmp, timeout),
            nprocs=world, start_method="spawn", join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main(rank: int, world: int, devices: list, backend: str,
               local_size: int, threads: int, tmp: str,
               timeout: Optional[float]) -> None:
    fn, args, kwargs = torch.load(os.path.join(tmp, "call.pt"),
                                  weights_only=False)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(threads or max(1, (os.cpu_count() or 1)
                                             // world))
    initialize_distributed(backend, f"file://{os.path.join(tmp, 'store')}",
                           world, rank, timeout)
    try:
        mesh = make_mesh(device, local_size)
        quiet = (contextlib.redirect_stdout(io.StringIO()) if rank
                 else contextlib.nullcontext())
        with quiet:
            out = fn(mesh, *args, **kwargs)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
