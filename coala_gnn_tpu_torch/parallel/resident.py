"""Device-resident training pipeline, single device (port of
coala_gnn_tpu/parallel/resident.py).

Topology, labels and the feature cache live in device memory. Per step
the device samples the blocks, reads the input frontier's features, runs
the model's forward and backward and the optimizer update. The trainer is
model-agnostic (any ``models.gnn.make_model`` output): SAGE's and GCN's
layer-0 neighbour sums and GAT's attention combine of every layer go
through the gather-SpMM kernel, GAT's backward through its two backward
kernels.

The cache holds f32, bf16 or int8 rows (``cfg.quantize``, both tiers).
The flat tier hands its table to the model as it is stored
(``TableInput(table, ids, scale, cfg.dtype)``); an int8 table is read by
the kernel's int8 form, which dequantises each row as it reads it (and
rounds it to bf16 where ``cfg.dtype`` or the model's dtype is bf16). The
model may compute in f32 or bf16 (``models.gnn.make_model(dtype=...)``):
every schedule below hands it rows in ``cfg.dtype`` and it casts them, as
JAX's model does.

Two cache tiers, picked as in JAX (``direct``): the flat table when it
holds every node, the set-associative cache otherwise. Three window
schedules in ``train_windows``:

- full coverage (flat tier, every row admitted): windows dispatch back to
  back; layer 0 reads the table in place (``TableInput``);
- flat prefill (flat tier, partial coverage): a presample probe reports
  window w's misses, the host inserts them before the window runs (the
  flat tier never evicts), then the full-coverage window runs;
- staged (set-associative tier under capacity pressure, the regime COALA
  exists for): the probe's miss ids are gathered on the host once per
  window, uploaded as a sideband *stage*, and the window overlays stage
  rows onto cache misses through a per-window position map. Priority
  admission then offers the stage to the cache. Serial order per window
  is window(w) -> insert(stage w) -> probe(w+1); with ``stage_overlap``
  probe(w+1) runs before window w and the insert reports what it evicted,
  which the host patches into stage w+1.

The staged window is exact only if the probe samples exactly the ids the
window samples. Each step therefore draws from two generators of its own,
one for sampling and one for dropout, both derived from the window's seed
(``utils/rng.py``): the probe rebuilds the sampling streams and never
touches the dropout streams. (The other valid design, sampling once and
handing the blocks to both, would hold every step's blocks of a window in
memory at once.) A window whose counters show a row served by neither
cache nor stage is replayed step by step from a snapshot of model and
optimizer (the safety net; unreachable while probes run in stream order).

Where the JAX trainer carries ``(params, opt_state)`` through pure
functions, this one holds a ``model`` and an ``optimizer`` and updates them
in place, and so does the cache. The JAX ``lax.scan`` window is a Python
loop over the window's steps (a CUDA-graph window is queued in ROADMAP.md).
Host syncs of the serial staged schedule: one probe readback per window
(into pinned memory, waited on by a CUDA event) and the final counter
fold; stages upload from pinned buffers without blocking.

The machinery of the windows lives in ``ResidentBase``, which
``parallel/sharded_resident.py``'s ``ShardedResidentTrainer`` shares.

``nbr_cap=P`` samples every path (windows, probes, per-step) from the
padded neighbour table (``sampling/device_sampler.py``), exact for nodes
of degree <= P. ``dedup=True`` changes only the per-step ``begin`` /
``resolve`` path, as in JAX: its frontier is deduplicated, valid below the
sampler's count, and its blocks carry a local ``adj``, so both layers'
neighbour sums run through the gather-SpMM kernel on that ``adj``; the
windows and their probes keep ``dedup=False``. A heterogeneous graph
raises ``NotImplementedError``: the JAX package trains hetero models
resident only in its ``ShardedResidentTrainer``, and so does the port.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coala_gnn_tpu_torch.cache import feature_cache as fc
from coala_gnn_tpu_torch.models.layers import DeviceBlock, TableInput
from coala_gnn_tpu_torch.native import lib as native_lib
from coala_gnn_tpu_torch.sampling.device_sampler import (
    sample_blocks_device, to_device_graph)
from coala_gnn_tpu_torch.sampling.neighbor import block_capacities
from coala_gnn_tpu_torch.sampling.sharded_topology import (
    ShardedTopology, sample_blocks_sharded)
from coala_gnn_tpu_torch.utils.rng import DROPOUT, SAMPLE, step_generators
from coala_gnn_tpu_torch.utils.timers import PhaseTimers

INT32_MAX = np.iinfo(np.int32).max

#: host buffer dtype of each stage transport (bf16 travels as its bits)
_TRANSPORT_DTYPE = {"float32": torch.float32, "bfloat16": torch.int16,
                    "int8": torch.int8}


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def stage_cap(n: int) -> int:
    """Stage-buffer capacity for n miss rows: pow2 up to 8192, then
    multiples of 8192 (few distinct shapes, at most 8191 padding rows)."""
    n = max(int(n), 1)
    if n <= 8192:
        return _pow2(n)
    return -(-n // 8192) * 8192


@functools.lru_cache(maxsize=None)
def _native() -> Optional[object]:
    """The native host library, or None where it cannot be built (tried
    once per process)."""
    try:
        return native_lib.get()
    except (OSError, RuntimeError):
        return None


def encode_stage_rows(rows: np.ndarray, transport: str):
    """Host-side transport encoding of staged miss rows: f32 rows [n, dim]
    -> (encoded rows, scales or None). bfloat16 comes back as its uint16
    bit pattern (round to nearest even; numpy has no bf16 type). int8 is
    symmetric per-row absmax, the format of ``fc.quantize_rows``. Both run
    in the native library where it builds."""
    if transport == "float32":
        return rows.astype(np.float32, copy=False), None
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    lib = _native()
    if transport == "bfloat16":
        if lib is None:
            return torch.from_numpy(rows).to(torch.bfloat16).view(
                torch.int16).numpy().view(np.uint16), None
        return native_lib.encode_bf16(lib, rows), None
    if transport == "int8":
        if lib is None:
            q, scale = fc.quantize_rows(torch.from_numpy(rows))
            return q.numpy(), scale.numpy()
        return native_lib.quantize_rows(lib, rows)
    raise ValueError(f"unknown stage transport {transport!r}")


def merge_evicted_patch(mids: np.ndarray, gathered: np.ndarray,
                        evicted_ids: np.ndarray, host_fetch):
    """Merge a previous insert's evicted ids into a probe-miss stage as
    PATCH rows (overlapped schedule): included in the window overlay (the
    probe ran before the insert and could not see these evictions) but not
    offered to the cache (re-admitting rows no window asked for evicts
    useful lines). Returns (mids, gathered, offer bool [n]), id-sorted for
    the position map."""
    offer = np.ones(mids.size, bool)
    ev = np.unique(evicted_ids[evicted_ids >= 0]).astype(np.int32)
    ev = ev[np.isin(ev, mids, assume_unique=True, invert=True)]
    if ev.size:
        ev_rows = host_fetch(ev.astype(np.int64)).astype(np.float32,
                                                         copy=False)
        order = np.argsort(np.concatenate([mids, ev]), kind="stable")
        mids = np.concatenate([mids, ev])[order]
        gathered = np.concatenate([gathered, ev_rows])[order]
        offer = np.concatenate([offer, np.zeros(ev.size, bool)])[order]
    return mids, gathered, offer


class HostScratch:
    """Rotating (2-deep) pool of host buffers, pinned when the device is a
    card. ``get`` hands out buffer i of a name, ``upload`` copies a buffer
    to the device without blocking and records a CUDA event; the next
    ``get`` of that buffer (two windows later) waits on the event before
    the host may write it again. A buffer grows when a request outgrows it,
    to 1/8 more than the request (pinning a 1.3 GB stage buffer takes ~0.2
    s, and a window's stage varies by a few percent), and is otherwise
    reused, so steady windows allocate nothing."""

    def __init__(self, pin_memory: bool):
        self._pin = pin_memory
        self._bufs: dict = {}    # (name, dtype) -> [buffer, buffer]
        self._flip: dict = {}
        self._fence: dict = {}   # buffer address -> event of its upload

    def get(self, name: str, shape: tuple,
            dtype: torch.dtype) -> torch.Tensor:
        key = (name, dtype)
        pair = self._bufs.setdefault(key, [None, None])
        i = self._flip[key] = 1 - self._flip.get(key, 1)
        buf = pair[i]
        n = math.prod(shape)
        if buf is not None:
            ev = self._fence.pop(buf.data_ptr(), None)
            if ev is not None:
                ev.synchronize()
        if buf is None or buf.numel() < n:
            buf = pair[i] = torch.empty(n + n // 8, dtype=dtype,
                                        pin_memory=self._pin)
        return buf[:n].view(shape)

    def upload(self, buf: torch.Tensor, device: torch.device
               ) -> torch.Tensor:
        out = buf.to(device, non_blocking=True, copy=True)
        if out.is_cuda:
            ev = torch.cuda.Event()
            ev.record()
            self._fence[buf.untyped_storage().data_ptr()] = ev
        return out


Probe = Tuple[str, torch.Tensor, Optional["torch.cuda.Event"]]


class ResidentBase:
    """What the two resident trainers share (this module's
    ``ResidentTrainer`` and ``parallel/sharded_resident.py``'s
    ``ShardedResidentTrainer``): sampling on the device, the presample
    probe and the stage, the fused window over the flat table or the
    set-associative lookup, the replay net and ``train_windows``'
    schedules.

    A subclass sets the attributes that ``_setup`` lists and calls it from
    its ``__post_init__``, and provides ``_eng_lookup``, ``_eng_probe``,
    ``_offer_stage``, and the per-step ``begin`` / ``resolve`` /
    ``train_step`` that the replay net runs (the flat tier also
    ``_repair_from_probe``).

    The rank hooks (``parallel/sharded_resident.py`` over a ``Mesh`` of
    more than one rank; none of them runs on a card on its own): the
    topology is the replicated ``DeviceGraph`` or this rank's
    ``ShardedTopology`` (``_place_graph``), and ``_sample`` draws from the
    one it holds; every step draws from this rank's streams
    (``utils/rng.py``); the window probe takes the node-bitmap form and
    the ranks' bitmaps are combined by a MAX ``all_reduce``, so every rank
    stages the same sorted union; the windows' hit, miss, unresolved and
    edge counts are summed over the ranks in one ``all_reduce``, so the
    replay decision reads the global unresolved count and every rank takes
    it alike; ``_learn`` is the subclass's (the data-parallel step)."""

    #: ``_stage_from_mids`` keeps the f32 rows it gathered, on the host
    #: (``stage[6]``), for an offer that inserts them from there
    _offer_host_rows = False
    #: the ranks the trainer spans (``parallel/mesh.Mesh``); None: one card
    mesh = None

    @property
    def _rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    @property
    def _multi(self) -> bool:
        """More than one rank: the collective hooks run."""
        return self.mesh is not None and self.mesh.world > 1

    def _place_graph(self):
        """The topology on the device: the replicated ``DeviceGraph``."""
        return to_device_graph(self.graph, self.device, nbr_cap=self.nbr_cap)

    def _offered(self, gid: np.ndarray) -> np.ndarray:
        """The stage ids (int64, -1 pads) whose f32 rows the offer inserts
        here, the others -1 (gathered as zero rows): all of them."""
        return gid

    def _setup(self) -> None:
        """The state the shared methods read, from the subclass's
        ``graph``, ``host_fetch``, ``labels``, ``fanouts``, ``batch_size``,
        ``device``, ``cache_cfg``, ``colors``, ``stage_transport``,
        ``nbr_cap``, ``direct`` and ``_use_prio``."""
        cfg = self.cache_cfg
        if self.stage_transport == "auto":
            self.stage_transport = "int8" if cfg.quantize else "float32"
        if self.stage_transport not in _TRANSPORT_DTYPE:
            raise ValueError(
                f"unknown stage transport {self.stage_transport!r}")
        if self.nbr_cap is not None and self.nbr_cap < max(self.fanouts):
            raise ValueError(
                f"nbr_cap={self.nbr_cap} < max fanout {max(self.fanouts)}: "
                "the padded row could not honor the take-all-in-order "
                "slot semantics for deg <= fanout")
        self.g = self._place_graph()
        self.labels_dev = torch.as_tensor(
            np.asarray(self.labels, np.int64)).to(self.device)
        self._cap0 = block_capacities(self.batch_size,
                                      list(self.fanouts))[0][1]
        # layer 0 of a window that builds its frontier features reads them
        # through the kernel at these slot positions (TableInput); the
        # relational layers of a typed graph take the features as they are
        self._slots = torch.arange(self._cap0, dtype=torch.int32,
                                   device=self.device)
        self._typed = self.g.edge_types is not None
        self.timers = PhaseTimers()
        self.hits = self.misses = 0
        self.full_coverage = False
        # fused host gather + encode when a native HostFeatureStore sits
        # behind host_fetch
        self._store = getattr(self.host_fetch, "__self__", None)
        if not getattr(self._store, "_native_ok", False):
            self._store = None
        self._scratch = HostScratch(pin_memory=self.device.type == "cuda")

    def _layer0(self, feats: torch.Tensor):
        """The model's input for a step's frontier features [cap0, dim]:
        read through the kernel at the slot positions (``TableInput``),
        or as they are on a typed graph."""
        return feats if self._typed else TableInput(feats, self._slots)

    def _sample(self, seeds: torch.Tensor, generator: torch.Generator,
                dedup: bool = False):
        """(blocks, ids, valid, safe): ``safe`` is ``ids`` with the invalid
        entries at 0. A deduplicated frontier is valid below its count.
        Collective over the ranks on a sharded topology."""
        if isinstance(self.g, ShardedTopology):
            blocks, ids, num = sample_blocks_sharded(
                self.g, self.mesh, seeds, self.fanouts, self.batch_size,
                generator)
        else:
            blocks, ids, num = sample_blocks_device(
                self.g, seeds, self.fanouts, self.batch_size, generator,
                dedup=dedup)
        if dedup:
            valid = torch.arange(ids.shape[0], device=ids.device) < num
        else:
            valid = ids != self.g.num_nodes
        safe = torch.where(valid, ids, torch.zeros_like(ids))
        return blocks, ids, valid, safe

    def _learn(self, blocks: List[DeviceBlock], x, y: torch.Tensor,
               generator: torch.Generator
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Forward, mean softmax cross-entropy, backward, optimizer step.
        Returns (loss, logits), both detached."""
        logits = self.model(blocks, x, train=True,
                            generator=generator)[:self.batch_size]
        loss = F.cross_entropy(logits, y)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), logits.detach()

    def _readback(self, t: torch.Tensor, name: str):
        """Start a device->host copy of ``t`` into a scratch buffer;
        returns (host tensor, CUDA event to wait on, or None)."""
        host = self._scratch.get(name, tuple(t.shape), t.dtype)
        host.copy_(t, non_blocking=True)
        if not t.is_cuda:
            return host, None
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    # ---- probe / stage plumbing --------------------------------------
    def _probe_steps(self, seeds_grid: torch.Tensor, seed: int,
                     window: int):
        """The window's sampling streams replayed: per step, (ids, miss
        bool) of its frontier."""
        for seeds, gen in zip(seeds_grid, step_generators(
                seed, window, seeds_grid.shape[0], SAMPLE, self.device,
                self._rank)):
            _, ids, valid, safe = self._sample(seeds, gen)
            yield ids, valid & ~self._eng_probe(safe, valid)

    def presample(self, seeds_grid: torch.Tensor, seed: int,
                  window: int) -> torch.Tensor:
        """Miss ids of a window, flat: int32 [K * cap0], -1 = hit or pad."""
        return torch.cat([torch.where(miss, ids, torch.full_like(ids, -1))
                          for ids, miss in self._probe_steps(seeds_grid, seed,
                                                             window)])

    def presample_bitmap(self, seeds_grid: torch.Tensor, seed: int,
                         window: int) -> torch.Tensor:
        """Miss flags of a window: uint8 [num_nodes + 1] (last = trash)."""
        sentinel = self.g.num_nodes
        bm = torch.zeros(sentinel + 1, dtype=torch.uint8, device=self.device)
        for ids, miss in self._probe_steps(seeds_grid, seed, window):
            bm[torch.where(miss, ids,
                           torch.full_like(ids, sentinel)).long()] = 1
        return bm

    def _probe_window(self, seeds_grid: torch.Tensor, seed: int,
                      window: int) -> Probe:
        """Dispatch the presample probe and start its readback (no host
        wait). The node bitmap when it is smaller than the flat
        [K * cap0] int32 array, and always over more than one rank, whose
        bitmaps a MAX ``all_reduce`` unites."""
        K = seeds_grid.shape[0]
        with self.timers.time("probe_dispatch"):
            if self._multi or self.graph.num_nodes + 1 <= 4 * K * self._cap0:
                fmt, out = "bitmap", self.presample_bitmap(seeds_grid, seed,
                                                           window)
                if self._multi:
                    self.mesh.all_reduce(out, torch.distributed.ReduceOp.MAX,
                                         phase="probe")
            else:
                fmt, out = "flat", self.presample(seeds_grid, seed, window)
            return (fmt, *self._readback(out, "probe"))

    def _probe_miss_ids(self, probe: Probe) -> np.ndarray:
        """Wait for a probe's readback -> sorted unique miss ids. The flat
        form is deduplicated through a node bitmap on the host, O(ids +
        nodes): ``np.unique``'s hash took 1.36 s of a 1.57 s window on 2.2M
        ids at 10M nodes (PERF.md)."""
        fmt, host, ev = probe
        with self.timers.time("probe_wait"):
            if ev is not None:
                ev.synchronize()
        with self.timers.time("probe_ids"):
            arr = host.numpy()
            if fmt == "bitmap":
                seen = arr[:self.graph.num_nodes]
            else:
                seen = np.zeros(self.graph.num_nodes, bool)
                seen[arr[arr >= 0]] = True
            return np.flatnonzero(seen).astype(np.int32)

    def _build_stage(self, probe: Probe, evicted=None):
        """Probe readback -> host gather of the unique miss rows -> stage on
        the device (upload not waited on)."""
        return self._stage_from_mids(self._probe_miss_ids(probe), evicted)

    def _gather_encoded(self, gid: np.ndarray, enc: torch.Tensor,
                        scale: Optional[torch.Tensor]) -> None:
        """Fused native gather + encode straight into the (pinned) stage
        buffers; ids < 0 give zero rows (scale 1)."""
        enc = enc.numpy()
        self._store.fetch_encoded(
            gid, self.stage_transport,
            enc_out=enc.view(np.uint16) if enc.dtype == np.int16 else enc,
            scale_out=None if scale is None else scale.numpy())

    def _stage_from_mids(self, mids: np.ndarray, evicted=None):
        """Host gather + transport encode + upload for a known miss-id set.
        Returns (ids, rows, scale or None, colors, prios, offer) on the
        device, then ``host``: (miss ids, their f32 rows, offer) on the
        host where the trainer offers the stage from there
        (``_offer_host_rows``), else None. Stage pads carry id INT32_MAX.

        ``evicted`` (overlapped schedule): the readback handle of the
        previous insert's evicted ids, patched in after the main gather.
        Without it and with a native store, the fused gather + encode
        writes each row once, at transport width, into a pinned buffer
        (and, for a host offer of a narrower transport, a second gather
        reads the f32 rows)."""
        dim, tr = self.cache_cfg.dim, self.stage_transport
        tdt = _TRANSPORT_DTYPE[tr]
        gathered = None
        if self._store is not None and evicted is None:
            n = mids.size
            u_cap = stage_cap(n)
            gid = np.full(u_cap, -1, np.int64)
            gid[:n] = mids
            with self.timers.time("stage_alloc"):
                enc = self._scratch.get("enc", (u_cap, dim), tdt)
                scale = (self._scratch.get("scale", (u_cap,), torch.float32)
                         if tr == "int8" else None)
            with self.timers.time("host_gather"):
                self._gather_encoded(gid, enc, scale)
                if self._offer_host_rows:
                    rows32 = enc
                    if tr != "float32":
                        rows32 = self._scratch.get("rows", (u_cap, dim),
                                                   torch.float32)
                        self._store.fetch(self._offered(gid),
                                          out=rows32.numpy())
                    gathered = rows32.numpy()[:n]
            offer = np.ones(n, bool)
        else:
            gathered = np.zeros((mids.size, dim), np.float32)
            with self.timers.time("host_gather"):
                if mids.size:
                    gathered = self.host_fetch(mids.astype(np.int64)) \
                        .astype(np.float32, copy=False)
            offer = np.ones(mids.size, bool)
            if evicted is not None:
                host, ev = evicted
                with self.timers.time("evict_patch"):
                    if ev is not None:
                        ev.synchronize()
                    mids, gathered, offer = merge_evicted_patch(
                        mids, gathered, host.numpy(), self.host_fetch)
            n = mids.size
            u_cap = stage_cap(n)
            with self.timers.time("stage_encode"):
                enc_r, scale_r = encode_stage_rows(gathered, tr)
                enc = self._scratch.get("enc", (u_cap, dim), tdt)
                e = enc.numpy()
                e[:n] = enc_r.view(e.dtype)
                e[n:] = 0
                scale = None
                if scale_r is not None:
                    scale = self._scratch.get("scale", (u_cap,),
                                              torch.float32)
                    scale.numpy()[:n] = scale_r
                    scale.numpy()[n:] = 1.0
        ids_p = self._scratch.get("ids", (u_cap,), torch.int32)
        ids_p.numpy()[:] = INT32_MAX
        ids_p.numpy()[:n] = mids
        colors_p = self._scratch.get("colors", (u_cap,), torch.int32)
        colors_p.numpy()[:] = 0
        if self.colors is not None and n:
            colors_p.numpy()[:n] = np.asarray(self.colors)[mids]
        prios_p = self._scratch.get("prios", (u_cap,), torch.float32)
        prios_p.numpy()[:] = 0
        if self._use_prio and n:
            prios_p.numpy()[:n] = self.priorities[mids]
        offer_p = self._scratch.get("offer", (u_cap,), torch.bool)
        offer_p.numpy()[:] = False
        offer_p.numpy()[:n] = offer
        with self.timers.time("stage_upload"):
            up = self._scratch.upload
            rows = up(enc, self.device)
            if tr == "bfloat16":
                rows = rows.view(torch.bfloat16)
            stage = (up(ids_p, self.device), rows,
                     None if scale is None else up(scale, self.device),
                     up(colors_p, self.device), up(prios_p, self.device),
                     up(offer_p, self.device),
                     (mids, gathered, offer) if self._offer_host_rows
                     else None)
        self.timers.tally("stage_rows", float(n))
        return stage

    # ---- fused windows ---------------------------------------------------
    def _pos_map(self, stage_ids: torch.Tensor) -> torch.Tensor:
        """Per-window position map, int64 [num_nodes + 1]: one scatter per
        window, then a single gather per step (pads map to the trash
        slot)."""
        sentinel = self.g.num_nodes
        pos_map = torch.zeros(sentinel + 1, dtype=torch.int64,
                              device=self.device)
        pos_map[stage_ids.clamp(max=sentinel).long()] = torch.arange(
            stage_ids.shape[0], device=self.device)
        return pos_map

    def _frontier(self, safe: torch.Tensor, valid: torch.Tensor, stage,
                  pos_map: Optional[torch.Tensor]):
        """One step's frontier features on the set-associative tier: cache
        lookup, stage rows overlaid where it misses. -> (feats [cap0, dim]
        in cfg.dtype, hits, rows served by neither), counts int32 on the
        device."""
        feats, hit = self._eng_lookup(safe, valid, count_stats=False)
        n_hit = hit.sum(dtype=torch.int32)
        n_unres = valid.sum(dtype=torch.int32) - n_hit
        if stage is not None:
            stage_ids, stage_rows, stage_scale = stage[:3]
            pos = pos_map[safe.long()]
            found = (stage_ids[pos] == safe) & valid & ~hit
            srows = stage_rows[pos]
            if stage_scale is not None:
                srows = fc.dequantize_rows(srows, stage_scale[pos],
                                           dtype=feats.dtype)
            feats = torch.where(found[:, None], srows.to(feats.dtype), feats)
            n_unres = n_unres - found.sum(dtype=torch.int32)
        return feats, n_hit, n_unres

    def _window(self, seeds_grid: torch.Tensor, seed: int, window: int,
                stage=None):
        """K steps of one window. Returns per-step (losses, misses, hits,
        unresolved, edges), each [K] on the device.

        Flat tier: layer 0 reads the table in place and every valid id
        counts as a hit (full coverage or prefilled). Set-associative
        tier: the frontier's features come from a lookup, overlaid with
        ``stage`` rows where the cache misses; ``unresolved`` counts rows
        served by neither, which sends the window to the replay net.
        Stage-served rows count as misses (they came from the backing
        store, the reference's semantics)."""
        K = seeds_grid.shape[0]
        pos_map = None if stage is None else self._pos_map(stage[0])
        cols = [[] for _ in range(5)]
        for seeds, g_sample, g_drop in zip(
                seeds_grid,
                step_generators(seed, window, K, SAMPLE, self.device,
                                self._rank),
                step_generators(seed, window, K, DROPOUT, self.device,
                                self._rank)):
            blocks, _, valid, safe = self._sample(seeds, g_sample)
            n_valid = valid.sum(dtype=torch.int32)
            if self.direct:
                x = TableInput(self.cache.data, safe, self.cache.scale,
                               self.cache_cfg.dtype)
                n_hit, n_unres = n_valid, torch.zeros_like(n_valid)
            else:
                feats, n_hit, n_unres = self._frontier(safe, valid, stage,
                                                       pos_map)
                x = self._layer0(feats)
            loss, _ = self._learn(blocks, x, self.labels_dev[seeds], g_drop)
            for col, v in zip(cols, (loss, n_valid - n_hit, n_hit, n_unres,
                                     sum(b.mask.sum() for b in blocks))):
                col.append(v)
        return tuple(torch.stack(c) for c in cols)

    def _snapshot(self):
        return (copy.deepcopy(self.model.state_dict()),
                copy.deepcopy(self.optimizer.state_dict()))

    def _replay_window(self, seeds_grid: np.ndarray, seed: int,
                       window: int):
        """The safety net: the window step by step through the per-step
        miss repair, on the window's own streams. -> (losses, edges)."""
        losses, edges = [], []
        K = seeds_grid.shape[0]
        for seeds, g_sample, g_drop in zip(
                seeds_grid,
                step_generators(seed, window, K, SAMPLE, self.device,
                                self._rank),
                step_generators(seed, window, K, DROPOUT, self.device,
                                self._rank)):
            resolved = self.resolve(self.begin(seeds, g_sample))
            loss, _ = self.train_step(resolved, g_drop)
            losses.append(loss)
            edges.append(sum(b.mask.sum() for b in resolved[0]))
        return torch.stack(losses), torch.stack(edges)

    def train_window(self, seeds_grid: np.ndarray, seed: int,
                     window: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """K fused steps, seeds_grid int [K, B]: window ``window`` of
        ``seed``."""
        return self.train_windows(np.asarray(seeds_grid)[None], seed,
                                  first_window=window)

    def train_windows(self, seeds_grids: np.ndarray, seed: int,
                      first_window: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """M windows of K steps, seeds_grids int [M, K, B]; window w draws
        from the streams (seed, first_window + w, step) of
        ``utils/rng.py``. Returns (losses [M*K], edges [M*K]) on the
        device.

        Full coverage: windows dispatch back to back with no host wait.
        Flat prefill: probe(w) -> repair insert -> probe(w+1) dispatched
        -> window(w). Staged: window(w) -> insert(stage w) -> probe(w+1),
        one host wait per window (the probe readback); with
        ``stage_overlap`` probe(w+1) is read before window w and the
        insert's evictions are patched into stage w+1. The counters of all
        windows come back in one transfer at the end."""
        M = seeds_grids.shape[0]
        seeds_dev = torch.as_tensor(
            np.ascontiguousarray(seeds_grids, np.int32)).to(self.device)
        staged = not self.full_coverage and not self.direct
        prefill = not self.full_coverage and self.direct
        losses_out: list = [None] * M
        edges_out: list = [None] * M
        counters: list = [None] * M
        snaps: list = [None] * M

        stage = probe = None
        if staged:
            stage = self._build_stage(self._probe_window(seeds_dev[0], seed,
                                                         first_window))
        elif prefill:
            probe = self._probe_window(seeds_dev[0], seed, first_window)
        for w in range(M):
            win = first_window + w
            if not self.direct:      # the flat window cannot go unresolved
                with self.timers.time("snapshot"):
                    snaps[w] = self._snapshot()
            if staged:
                mids_next = None
                if self.stage_overlap and w + 1 < M:
                    # probe(w+1) sees the pre-insert state window w reads;
                    # read it now, while the stream is short
                    mids_next = self._probe_miss_ids(self._probe_window(
                        seeds_dev[w + 1], seed, win + 1))
                with self.timers.time("window_dispatch"):
                    out = self._window(seeds_dev[w], seed, win, stage)
                evicted = None
                if self.stage_admit:
                    with self.timers.time("insert_dispatch"):
                        if mids_next is not None:
                            evicted = self._readback(
                                self._offer_stage(stage, True), "evicted")
                        else:
                            self._offer_stage(stage)
                if w + 1 < M:
                    if mids_next is not None:
                        stage = self._stage_from_mids(mids_next, evicted)
                    else:
                        stage = self._build_stage(self._probe_window(
                            seeds_dev[w + 1], seed, win + 1))
            else:
                if prefill:
                    self._repair_from_probe(probe)
                    if w + 1 < M:
                        probe = self._probe_window(seeds_dev[w + 1], seed,
                                                   win + 1)
                with self.timers.time("window_dispatch"):
                    out = self._window(seeds_dev[w], seed, win)
            losses, miss, hits, unres, edges = out
            losses_out[w], edges_out[w] = losses, edges
            counters[w] = torch.stack([miss.sum(), hits.sum(), unres.sum()])
        counts = torch.stack(counters)
        if self._multi:
            # the ranks' counts and edges summed in one all_reduce: every
            # rank reads the same unresolved count and replays alike
            both = self.mesh.all_reduce(torch.cat([
                counts.reshape(-1).long(),
                torch.stack(edges_out).reshape(-1).long()]), phase="control")
            counts = both[:3 * M].view(M, 3)
            edges_out = list(both[3 * M:].view(M, -1).float())
        folded = counts.cpu().numpy()                   # ONE d2h transfer
        self.misses += int(folded[:, 0].sum())
        self.hits += int(folded[:, 1].sum())
        bad = np.flatnonzero(folded[:, 2])
        if bad.size:
            # replay the first window with unresolved rows and every window
            # after it (they consumed post-miss state); the replayed steps
            # count again through the device counters
            w0 = int(bad[0])
            self.misses -= int(folded[w0:, 0].sum())
            self.hits -= int(folded[w0:, 1].sum())
            model_sd, opt_sd = snaps[w0]
            self.model.load_state_dict(model_sd)
            self.optimizer.load_state_dict(opt_sd)
            with self.timers.time("replay"):
                for w in range(w0, M):
                    losses_out[w], edges_out[w] = self._replay_window(
                        seeds_grids[w], seed, first_window + w)
                if self._multi:
                    edges_out[w0:] = list(self.mesh.all_reduce(torch.stack(
                        edges_out[w0:]), phase="control"))
        return torch.cat(losses_out), torch.cat(edges_out)


@dataclasses.dataclass
class ResidentTrainer(ResidentBase):
    graph: object                        # host CSCGraph
    host_fetch: Callable                 # host tier fn(int64 ids) -> f32 rows
    labels: np.ndarray                   # [num_nodes]
    cache_cfg: fc.CacheConfig
    model: nn.Module                     # on ``device``
    optimizer: torch.optim.Optimizer     # over ``model``'s parameters
    fanouts: Sequence[int]
    batch_size: int
    device: torch.device
    colors: Optional[np.ndarray] = None  # int [num_nodes] for color counts
    dedup: bool = False                  # per-step path: deduplicated
                                         # frontier, blocks with adj
    direct: Optional[bool] = None        # None: flat tier iff the cache
                                         # capacity covers every node
    priorities: Union[None, str, np.ndarray] = None
                                         # f32 [num_nodes] admission priority
                                         # of the set-associative tier, or
                                         # "degree" (in-degree of the graph)
    stage_transport: str = "auto"        # miss-row encoding across the host
                                         # link: float32 | bfloat16 | int8;
                                         # auto = int8 for int8 lines, else
                                         # float32
    stage_admit: bool = True             # offer staged rows to the cache
                                         # after each window
    stage_overlap: bool = False          # overlapped staged schedule
    nbr_cap: Optional[int] = None        # padded neighbour table of P
                                         # slots per node, P >= max fanout

    def __post_init__(self):
        if getattr(self.graph, "edge_types", None) is not None:
            raise NotImplementedError(
                "ResidentTrainer reads layer 0 off the table, which the "
                "relational layers do not take: on a heterogeneous graph "
                "train with parallel/sharded_resident.py's "
                "ShardedResidentTrainer, as the JAX package does")
        cfg = self.cache_cfg
        if isinstance(self.priorities, str):
            if self.priorities != "degree":
                raise ValueError(f"unknown priorities {self.priorities!r}")
            self.priorities = np.diff(
                np.asarray(self.graph.indptr)).astype(np.float32)
        self.device = torch.device(self.device)
        n = self.graph.num_nodes
        if self.direct is None:
            self.direct = cfg.capacity >= n
        self._use_prio = self.priorities is not None and not self.direct
        if self.direct:
            self.cache = fc.flat_init(cfg, n, self.device)
        else:
            self.cache = fc.init_colored_state(cfg, self.device,
                                               track_prio=self._use_prio)
        self._setup()

    # ---- engine dispatch: flat table or set-associative cache ---------
    def _eng_lookup(self, ids: torch.Tensor, valid: torch.Tensor,
                    count_stats: bool = True):
        """(feats [n, dim] in cfg.dtype, hit bool [n])."""
        if self.direct:
            _, feats, hit = fc.flat_lookup(self.cache, ids, valid,
                                           dtype=self.cache_cfg.dtype)
        else:
            _, feats, hit = fc.lookup(self.cache_cfg, self.cache.base, ids,
                                      valid, count_stats=count_stats)
        return feats, hit

    def _eng_probe(self, ids: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
        if self.direct:
            return fc.flat_probe(self.cache, ids, valid)
        return fc.probe(self.cache_cfg, self.cache.base, ids, valid)

    def _eng_insert(self, ids, rows, valid, colors, prios=None) -> None:
        """In place; ``prios`` is None unless priorities are in use."""
        if self.direct:
            fc.flat_insert(self.cache_cfg, self.cache, ids, rows, valid,
                           colors)
        else:
            fc.insert_with_colors(self.cache_cfg, self.cache, ids, rows,
                                  valid, colors, prios=prios)

    # ------------------------------------------------------------------
    def _colors(self, ids: np.ndarray) -> torch.Tensor:
        c = (np.zeros(ids.shape[0], np.int32) if self.colors is None
             else np.asarray(self.colors, np.int32)[ids])
        return torch.as_tensor(c).to(self.device)

    def _prios(self, ids: np.ndarray) -> Optional[torch.Tensor]:
        if not self._use_prio:
            return None
        return torch.as_tensor(self.priorities[ids]).to(self.device)

    def _insert_host_rows(self, ids: np.ndarray, rows: np.ndarray) -> None:
        ids_dev = torch.as_tensor(ids).to(self.device)
        self._eng_insert(ids_dev,
                         torch.as_tensor(np.asarray(rows, np.float32)).to(
                             self.device),
                         torch.ones_like(ids_dev, dtype=torch.bool),
                         self._colors(ids), self._prios(ids))

    # ---- per-step path -------------------------------------------------
    def begin(self, seeds, generator: torch.Generator) -> tuple:
        """Sample and look up one step (counters on the device). ``seeds``
        int [batch] on the host."""
        seeds_dev = torch.as_tensor(np.asarray(seeds, np.int32)).to(
            self.device)
        blocks, ids, valid, safe = self._sample(seeds_dev, generator,
                                                self.dedup)
        feats, hit = self._eng_lookup(safe, valid)
        n_miss = (valid & ~hit).sum(dtype=torch.int32)
        return blocks, ids, valid, feats, hit, n_miss, \
            self.labels_dev[seeds_dev]

    def resolve(self, handle) -> tuple:
        """(blocks, feats, labels) with misses fetched from the host tier,
        merged into feats and admitted to the cache."""
        blocks, ids, valid, feats, hit, n_miss, y = handle
        if int(n_miss) == 0:
            return blocks, feats, y
        pos = torch.nonzero(valid & ~hit).squeeze(1)
        miss_ids = ids[pos]
        miss_np = miss_ids.cpu().numpy()
        with self.timers.time("host_gather"):
            rows = self.host_fetch(miss_np.astype(np.int64))
        rows = torch.as_tensor(np.asarray(rows, np.float32)).to(self.device)
        feats = feats.clone()
        feats[pos] = rows.to(feats.dtype)
        self._eng_insert(miss_ids, rows,
                         torch.ones_like(miss_ids, dtype=torch.bool),
                         self._colors(miss_np), self._prios(miss_np))
        return blocks, feats, y

    def train_step(self, resolved, generator: torch.Generator
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One update on resolved dense inputs -> (loss, accuracy)."""
        blocks, feats, y = resolved
        loss, logits = self._learn(blocks, feats, y, generator)
        return loss, (logits.argmax(-1) == y).float().mean()

    def eval_step(self, resolved) -> int:
        """Correct predictions among the batch's seeds."""
        blocks, feats, y = resolved
        with torch.no_grad():
            logits = self.model(blocks, feats,
                                train=False)[:self.batch_size]
        return int((logits.argmax(-1) == y).sum())

    def _offer_stage(self, stage, return_evicted: bool = False):
        """Offer a window's staged rows to the set-associative cache
        (priority admission filters them; without priorities this is the
        reference's mandatory miss insert). Evicted-patch rows are not
        offered. With ``return_evicted``: the evicted ids, int32 [u_cap]."""
        ids_p, rows, scale, colors_p, prios_p, offer = stage[:6]
        rows = (fc.dequantize_rows(rows, scale) if scale is not None
                else rows.float())
        valid = (ids_p != INT32_MAX) & offer
        out = fc.insert_with_colors(
            self.cache_cfg, self.cache,
            torch.where(valid, ids_p, torch.zeros_like(ids_p)), rows, valid,
            colors_p, prios=prios_p if self._use_prio else None,
            return_evicted=return_evicted)
        return out[1] if return_evicted else None

    def _repair_from_probe(self, probe: Probe) -> None:
        """Flat prefill: read a probe's miss ids and insert their rows, so
        the window that follows only hits."""
        mids = self._probe_miss_ids(probe)
        if mids.size == 0:
            return
        with self.timers.time("host_gather"):
            rows = self.host_fetch(mids.astype(np.int64))
        self._insert_host_rows(mids, rows)

    # ------------------------------------------------------------------
    def prewarm(self, ids: np.ndarray, chunk: int = 65536) -> None:
        """Admit the rows of ``ids`` from the host tier, in chunks; full
        coverage when the cache holds every node and ``ids`` are every
        node."""
        ids = np.unique(np.asarray(ids, np.int32))
        n = self.graph.num_nodes
        self.full_coverage = (self.cache_cfg.capacity >= n
                              and ids.size >= n)
        for lo in range(0, ids.size, chunk):
            part = ids[lo:lo + chunk]
            self._insert_host_rows(part,
                                   self.host_fetch(part.astype(np.int64)))
        self._counters().hits.zero_()
        self._counters().misses.zero_()
        self.hits = self.misses = 0

    def _counters(self):
        return self.cache if self.direct else self.cache.base

    def stats(self) -> dict:
        """Device counters (per-step path) + host accumulators (windows),
        reset on read."""
        c = self._counters()
        h, m = (int(v) for v in torch.stack([c.hits, c.misses]).tolist())
        c.hits.zero_()
        c.misses.zero_()
        h += self.hits
        m += self.misses
        self.hits = self.misses = 0
        return {"hits": h, "misses": m,
                "hit_ratio": h / (h + m) if (h + m) else 0.0}
