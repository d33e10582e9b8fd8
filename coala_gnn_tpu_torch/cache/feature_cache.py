"""Device feature cache, both tiers of coala_gnn_tpu/cache/feature_cache.py.

- The flat (direct-mapped) table, the top tier when device memory holds
  every feature row: a flat [num_nodes + 1, dim] table needs one gather per
  request and never evicts; the trailing row is scratch for invalid
  inserts.
- The set-associative cache for capacity pressure: sets of 32 ways, tags
  compared per set, round-robin or priority-aware eviction, per-color
  occupancy counters, the reference's geometry (see the JAX module).

The JAX functions are pure; here inserts and the counters of the lookups
update the state's tensors in place (the tables are hundreds of MB at the
flagship size, so a copy per insert would double their footprint) and
return the same state. Torch has no ``mode="drop"`` scatter, so each
set-associative state carries one scratch set (row ``num_sets`` of
``tags``, ``data``, ``line_colors`` and ``line_prio``) that takes the
writes JAX drops; no lookup ever reads it. Sorts pass ``stable=True``
(``jnp.argsort`` is stable, ``torch.argsort`` is not by default) and
first-match ``argmax`` runs over an integer cast of the match, so the
state stays bitwise equal to JAX's. Nothing here reads a device value
back to the host (no ``nonzero``, no boolean indexing) apart from
``stats``.

int8 lines (``quantize=True``), in both tiers as in JAX: each row is
stored as int8 with one f32 absmax scale (``quantize_rows``), quantised
on the device at insert and dequantised to ``cfg.dtype`` at lookup. The
flat tier's int8 table is also read in place by the gather-SpMM kernel's
int8 form (``models.layers.TableInput`` with ``scale``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

WAYS = 32  # reference: ssd_gnn_cache.cuh:61


def assert_ids_fit_int32(num_nodes: int) -> None:
    """Node ids live on the device as int32; refuse graphs past 2^31-1."""
    if num_nodes > np.iinfo(np.int32).max:
        raise ValueError(
            f"{num_nodes} nodes exceeds the int32 node-id domain "
            "(2^31-1); shard the node space before building device state")


def round_cache_dim(dim: int) -> int:
    """Feature dim -> cache line dim {128, 256, 512, 1024}, then multiples
    of 128."""
    for d in (128, 256, 512, 1024):
        if dim <= d:
            return d
    return ((dim + 127) // 128) * 128


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    num_sets: int
    ways: int
    dim: int            # true feature dim
    cache_dim: int      # padded line dim
    num_colors: int     # 0 disables color tracking
    dtype: torch.dtype = torch.float32
    quantize: bool = False  # int8 lines + a per-line f32 absmax scale
    num_shards: int = 1     # ranks the distributed cache spans (1 = private)

    @property
    def capacity(self) -> int:
        return self.num_sets * self.ways

    @property
    def line_bytes(self) -> int:
        if self.quantize:
            return self.cache_dim + 4        # int8 row + f32 scale
        return self.cache_dim * self.dtype.itemsize

    @property
    def data_dtype(self) -> torch.dtype:
        """The stored row type: int8 when quantised, else ``dtype``."""
        return torch.int8 if self.quantize else self.dtype

    @property
    def size_mb(self) -> float:
        return self.capacity * self.line_bytes / 2**20


def make_config(cache_mb: int, dim: int, num_colors: int = 0,
                dtype: torch.dtype = torch.float32,
                quantize: bool = False, num_shards: int = 1) -> CacheConfig:
    """``cache_mb`` MB of lines per rank; ``num_shards`` ranks share the
    id space (the distributed set index)."""
    cache_dim = round_cache_dim(dim)
    page = cache_dim + 4 if quantize else cache_dim * dtype.itemsize
    num_pages = max(int(cache_mb) * 2**20 // page, WAYS)
    return CacheConfig(num_sets=num_pages // WAYS, ways=WAYS, dim=dim,
                       cache_dim=cache_dim, num_colors=num_colors,
                       dtype=dtype, quantize=quantize, num_shards=num_shards)


@dataclasses.dataclass
class FlatState:
    data: torch.Tensor          # cfg.data_dtype [num_nodes + 1, dim] (+1
                                # scratch row)
    admitted: torch.Tensor      # uint8 [num_nodes + 1]
    color_counts: torch.Tensor  # int32 [num_colors + 1]
    hits: torch.Tensor          # int32 [] since the last stats reset
    misses: torch.Tensor        # int32 []
    scale: Optional[torch.Tensor] = None   # f32 [num_nodes + 1] (int8 rows)


def flat_init(cfg: CacheConfig, num_nodes: int, device) -> FlatState:
    def zeros(*shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return FlatState(data=zeros(num_nodes + 1, cfg.dim, dtype=cfg.data_dtype),
                     admitted=zeros(num_nodes + 1, dtype=torch.uint8),
                     color_counts=zeros(cfg.num_colors + 1,
                                        dtype=torch.int32),
                     hits=zeros(dtype=torch.int32),
                     misses=zeros(dtype=torch.int32),
                     scale=(torch.ones(num_nodes + 1, dtype=torch.float32,
                                       device=device)
                            if cfg.quantize else None))


def flat_lookup(state: FlatState, ids: torch.Tensor, valid: torch.Tensor,
                dtype: torch.dtype = torch.float32
                ) -> Tuple[FlatState, torch.Tensor, torch.Tensor]:
    """(state, rows [n, dim], hit bool [n]); rows that miss read zero; int8
    rows come back dequantised to ``dtype`` (pass cfg.dtype, as JAX's
    trainer does). The hit and miss counters add on the device; nothing is
    read back. (The JAX function's ``assume_hit`` / ``count_stats=False``
    form, used by its full-coverage window, has no caller here: the port's
    window reads the table in place, see models/layers.TableInput.)"""
    hit = (state.admitted[ids] > 0) & valid
    feats = state.data[ids]
    if state.scale is not None:
        feats = dequantize_rows(feats, state.scale[ids], dtype=dtype)
    feats = torch.where(hit[:, None], feats,
                        torch.zeros((), dtype=feats.dtype,
                                    device=feats.device))
    n_hit = hit.sum(dtype=torch.int32)
    state.hits += n_hit
    state.misses += valid.sum(dtype=torch.int32) - n_hit
    return state, feats, hit


def flat_probe(state: FlatState, ids: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    return (state.admitted[ids] > 0) & valid


def _dedup_valid(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``valid`` with repeats of an id within the batch reduced to the
    first occurrence."""
    key = torch.where(valid, ids.to(torch.int64),
                      torch.full_like(ids, np.iinfo(np.int32).max,
                                      dtype=torch.int64))
    order = torch.argsort(key, stable=True)
    sk = key[order]
    first_sorted = torch.ones_like(sk, dtype=torch.bool)
    first_sorted[1:] = sk[1:] != sk[:-1]
    is_first = torch.empty_like(first_sorted)
    is_first[order] = first_sorted
    return valid & is_first


def flat_insert(cfg: CacheConfig, state: FlatState, ids: torch.Tensor,
                feats: torch.Tensor, valid: torch.Tensor,
                colors: torch.Tensor) -> FlatState:
    """Admit rows in place (no eviction; re-admission refreshes the row;
    int8 rows are quantised here, on the device). Color occupancy counts
    first admissions only."""
    n_nodes = state.data.shape[0] - 1
    slot = torch.where(valid, ids.to(torch.int64),
                       torch.full_like(ids, n_nodes, dtype=torch.int64))
    if cfg.num_colors > 0:
        newly = _dedup_valid(ids, valid) & (state.admitted[slot] == 0)
    else:
        newly = valid
    if state.scale is not None:
        q, row_scale = quantize_rows(feats)
        state.data[slot] = q
        state.scale[slot] = row_scale
    else:
        state.data[slot] = feats.to(state.data.dtype)
    state.admitted[slot] = 1
    state.admitted[n_nodes] = 0
    inc = torch.where(newly & (colors > 0), colors.to(torch.int64),
                      torch.zeros_like(colors, dtype=torch.int64))
    state.color_counts.index_add_(
        0, inc, torch.ones_like(inc, dtype=torch.int32))
    state.color_counts[0] = 0
    return state



# ---- set-associative tier ------------------------------------------------

@dataclasses.dataclass
class CacheState:
    tags: torch.Tensor          # int32 [num_sets + 1, ways], -1 = empty
    data: torch.Tensor          # cfg.data_dtype [num_sets + 1, ways,
                                # cache_dim]
    rr: torch.Tensor            # int32 [num_sets] round-robin cursor
    color_counts: torch.Tensor  # int32 [num_colors + 1] occupancy by color
    hits: torch.Tensor          # int32 [] since the last stats reset
    misses: torch.Tensor        # int32 []
    scales: Optional[torch.Tensor] = None  # f32 [num_sets + 1, ways] (int8)


@dataclasses.dataclass
class ColoredCacheState:
    """CacheState + the per-line color side table; ``line_prio`` (f32) is
    the per-line admission priority of priority-aware eviction, None keeps
    the reference's round-robin policy."""
    base: CacheState
    line_colors: torch.Tensor                  # int32 [num_sets + 1, ways]
    line_prio: Optional[torch.Tensor] = None   # f32 [num_sets + 1, ways]


#: priority value of empty ways: any real priority admits over them
EMPTY_PRIO = -3.0e38


def init_state(cfg: CacheConfig, device) -> CacheState:
    s, w = cfg.num_sets + 1, cfg.ways
    return CacheState(
        tags=torch.full((s, w), -1, dtype=torch.int32, device=device),
        data=torch.zeros((s, w, cfg.cache_dim), dtype=cfg.data_dtype,
                         device=device),
        rr=torch.zeros(cfg.num_sets, dtype=torch.int32, device=device),
        color_counts=torch.zeros(cfg.num_colors + 1, dtype=torch.int32,
                                 device=device),
        hits=torch.zeros((), dtype=torch.int32, device=device),
        misses=torch.zeros((), dtype=torch.int32, device=device),
        scales=(torch.ones((s, w), dtype=torch.float32, device=device)
                if cfg.quantize else None))


def init_colored_state(cfg: CacheConfig, device,
                       track_prio: bool = False) -> ColoredCacheState:
    shape = (cfg.num_sets + 1, cfg.ways)
    return ColoredCacheState(
        base=init_state(cfg, device),
        line_colors=torch.zeros(shape, dtype=torch.int32, device=device),
        line_prio=(torch.full(shape, EMPTY_PRIO, dtype=torch.float32,
                              device=device) if track_prio else None))


def _set_index(cfg: CacheConfig, ids: torch.Tensor) -> torch.Tensor:
    """int64 set of each id (for indexing): private, id % num_sets;
    distributed over ``num_shards`` owners (owner = id % num_shards),
    (id // num_shards) % num_sets."""
    ids = ids.to(torch.int64)
    if cfg.num_shards > 1:
        return (ids // cfg.num_shards) % cfg.num_sets
    return ids % cfg.num_sets


def quantize_rows(rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """rows [..., dim] float -> (int8 rows, f32 per-row scales). Symmetric
    absmax: q = round(x / (absmax / 127)), ties to even; dequant = q *
    scale. The divisor 127 is a tensor made on the rows' device (no host
    copy, no wait): PyTorch's CUDA division by a Python number multiplies
    by its reciprocal, which is an ulp off the host quantizer's scale
    (``csrc/host_native.cpp``) on some rows, so a stage row and the cache
    line of the same node differed."""
    r = rows.float()
    absmax = r.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / absmax.new_full((), 127.0),
                        torch.ones_like(absmax))
    q = torch.round(r / scale[..., None]).clamp_(-127, 127).to(torch.int8)
    return q, scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def _to_lines(cfg: CacheConfig, feats: torch.Tensor
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Feature rows [n, dim] -> (cache lines [n, cache_dim] in the stored
    type, their f32 scales when quantised, else None)."""
    row_scales = None
    if cfg.quantize:
        feats, row_scales = quantize_rows(feats)
    pad = torch.zeros(feats.shape[0], cfg.cache_dim - cfg.dim,
                      dtype=cfg.data_dtype, device=feats.device)
    return torch.cat([feats.to(cfg.data_dtype), pad], dim=1), row_scales


def _write_lines(cfg: CacheConfig, state: "CacheState", sets: torch.Tensor,
                 way: torch.Tensor, feats: torch.Tensor) -> None:
    """Rows (and their scales) into (set, way); ``sets`` = num_sets (the
    scratch set) for rows that must not land."""
    lines, row_scales = _to_lines(cfg, feats)
    state.data[sets, way] = lines
    if row_scales is not None:
        state.scales[sets, way] = row_scales


def _first_match(match: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1 (0 where none)."""
    return match.to(torch.int32).argmax(dim=1)


def lookup(cfg: CacheConfig, state: CacheState, ids: torch.Tensor,
           valid: torch.Tensor, count_stats: bool = True
           ) -> Tuple[CacheState, torch.Tensor, torch.Tensor]:
    """(state, feats [n, dim] in cfg.dtype, hit bool [n]) for ids int32
    [n]; ``valid`` masks padding. Rows that miss read zero; int8 lines are
    dequantised. The counters add on the device."""
    sets = _set_index(cfg, ids)
    match = state.tags[sets] == ids[:, None]
    hit = match.any(dim=1) & valid
    way = _first_match(match)
    feats = state.data[sets, way, :cfg.dim]
    if state.scales is not None:
        feats = dequantize_rows(feats, state.scales[sets, way])
    feats = torch.where(hit[:, None], feats,
                        torch.zeros((), dtype=feats.dtype,
                                    device=feats.device)).to(cfg.dtype)
    if count_stats:
        n_hit = hit.sum(dtype=torch.int32)
        state.hits += n_hit
        state.misses += valid.sum(dtype=torch.int32) - n_hit
    return state, feats, hit


def lookup_quantized(cfg: CacheConfig, state: CacheState, ids: torch.Tensor,
                     valid: torch.Tensor, count_stats: bool = True
                     ) -> Tuple[CacheState, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """``lookup`` of an int8 cache without the dequantisation: (state, q
    int8 [n, dim], scales f32 [n], hit bool [n]), missed rows zero with
    scale 1, so the exchange can send the lines as they are stored
    (dim + 4 bytes a row) and the requester dequantises."""
    sets = _set_index(cfg, ids)
    match = state.tags[sets] == ids[:, None]
    hit = match.any(dim=1) & valid
    way = _first_match(match)
    q = torch.where(hit[:, None], state.data[sets, way, :cfg.dim],
                    torch.zeros((), dtype=torch.int8, device=ids.device))
    sc = torch.where(hit, state.scales[sets, way],
                     torch.ones((), dtype=torch.float32, device=ids.device))
    if count_stats:
        n_hit = hit.sum(dtype=torch.int32)
        state.hits += n_hit
        state.misses += valid.sum(dtype=torch.int32) - n_hit
    return state, q, sc, hit


def probe(cfg: CacheConfig, state: CacheState, ids: torch.Tensor,
          valid: torch.Tensor) -> torch.Tensor:
    """Residency only: hit bool [n], no data gather, no counters."""
    sets = _set_index(cfg, ids)
    return (state.tags[sets] == ids[:, None]).any(dim=1) & valid


def _within_set_rank(sort_key: torch.Tensor,
                     order: torch.Tensor) -> torch.Tensor:
    """Rank of each row within its run of equal ``sort_key`` in the
    (stable) ``order``: int64 [n]."""
    n = sort_key.shape[0]
    sorted_key = sort_key[order]
    first_of_run = torch.searchsorted(sorted_key, sorted_key, side="left")
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=order.device) - first_of_run
    return rank


def _placement(cfg: CacheConfig, state: CacheState, ids, valid, sets,
               prios=None, line_prio=None):
    """Where each row goes: the JAX insert's placement and one-writer
    rule. Returns (way, is_new, valid): ``way`` int64 [n] in the row's
    set, ``is_new`` the admitted new arrivals, ``valid`` the rows that
    write (admitted arrivals and surviving refreshes)."""
    valid = _dedup_valid(ids, valid)
    match = state.tags[sets] == ids[:, None]
    already = match.any(dim=1)
    match_way = _first_match(match).to(torch.int64)
    is_new = valid & ~already
    # within-set occurrence rank among new arrivals; with priorities the
    # rank orders arrivals by descending priority (stable lexsort: by
    # -prio, then by set) so the strongest arrival meets the weakest victim
    sort_key = torch.where(is_new, sets, torch.full_like(sets, cfg.num_sets))
    if line_prio is not None:
        o1 = torch.argsort(torch.where(is_new, -prios,
                                       torch.full_like(prios, float("inf"))),
                           stable=True)
        order = o1[torch.argsort(sort_key[o1], stable=True)]
    else:
        order = torch.argsort(sort_key, stable=True)
    rank = _within_set_rank(sort_key, order)
    is_new = is_new & (rank < cfg.ways)          # no cursor wrap
    if line_prio is not None:
        # victim of the rank-th arrival: the set's rank-th lowest-prio way
        way_prio = line_prio[sets]
        way_order = torch.argsort(way_prio, dim=1, stable=True)
        rank_c = rank.clamp(0, cfg.ways - 1)[:, None]
        new_way = torch.gather(way_order, 1, rank_c)[:, 0]
        victim_prio = torch.gather(way_prio, 1, new_way[:, None])[:, 0]
        is_new = is_new & (prios > victim_prio)  # admission
    else:
        new_way = (state.rr[sets].to(torch.int64) + rank) % cfg.ways
    way = torch.where(already, match_way, new_way)
    # one writer per (set, way): a same-batch refresh whose way a new
    # arrival claims is dropped (the new line evicts it)
    claimed = torch.zeros(cfg.num_sets + 1, cfg.ways, dtype=torch.bool,
                          device=ids.device)
    claimed[torch.where(is_new, sets, cfg.num_sets), way] = True
    clobbered = valid & already & claimed[sets, way]
    valid = valid & ~clobbered & (is_new | already)
    return way, is_new, valid


def _advance_cursors(cfg: CacheConfig, state: CacheState, sets, is_new):
    per_set = torch.zeros(cfg.num_sets + 1, dtype=torch.int32,
                          device=sets.device)
    per_set.index_add_(0, torch.where(is_new, sets, cfg.num_sets),
                       torch.ones_like(sets, dtype=torch.int32))
    state.rr.add_(per_set[:cfg.num_sets]).remainder_(cfg.ways)


def insert(cfg: CacheConfig, state: CacheState, ids: torch.Tensor,
           feats: torch.Tensor, valid: torch.Tensor) -> CacheState:
    """Admit rows in place: a resident id refreshes its way, new ids claim
    ways round-robin from the set cursor. ids int32 [n], feats [n, dim],
    valid bool [n]. Every (set, way) is written by at most one row (the
    JAX function's rule): more than ``ways`` arrivals to one set keep the
    first ``ways`` ranks, and a refresh that a new arrival clobbers is
    dropped."""
    sets = _set_index(cfg, ids)
    way, is_new, valid = _placement(cfg, state, ids, valid, sets)
    drop_sets = torch.where(valid, sets, cfg.num_sets)
    state.tags[drop_sets, way] = ids.to(torch.int32)
    _write_lines(cfg, state, drop_sets, way, feats)
    _advance_cursors(cfg, state, sets, is_new)
    return state


def insert_with_colors(cfg: CacheConfig, cstate: ColoredCacheState,
                       ids: torch.Tensor, feats: torch.Tensor,
                       valid: torch.Tensor, colors: torch.Tensor,
                       prios: Optional[torch.Tensor] = None,
                       return_evicted: bool = False):
    """insert() + color occupancy, in place. ``colors`` int32 [n] are
    1-based (0 = uncolored).

    With ``prios`` (f32 [n]; the state needs ``track_prio=True``) a new
    row's victim is its set's lowest-priority way, and the row is admitted
    only if it outranks that victim. ``return_evicted=True`` also returns
    int32 [n], the id row i evicted (-1 where it evicted nothing). Every
    victim tag, color and priority is read before any is written."""
    state = cstate.base
    if prios is not None and cstate.line_prio is None:
        raise ValueError(
            "insert_with_colors got prios but the state was built without "
            "track_prio=True — priority-aware eviction would be silently "
            "lost; pass track_prio=True to init_colored_state")
    line_prio = cstate.line_prio if prios is not None else None
    if prios is not None:
        prios = prios.to(torch.float32)
    sets = _set_index(cfg, ids)
    way, is_new, valid = _placement(cfg, state, ids, valid, sets, prios,
                                    line_prio)
    victim_color = cstate.line_colors[sets, way]
    evicted = None
    if return_evicted:
        victim_tag = state.tags[sets, way]
        evicted = torch.where(is_new & valid & (victim_tag >= 0),
                              victim_tag, torch.full_like(victim_tag, -1))

    drop_sets = torch.where(valid, sets, cfg.num_sets)
    new_sets = torch.where(is_new, sets, cfg.num_sets)
    state.tags[drop_sets, way] = ids.to(torch.int32)
    _write_lines(cfg, state, drop_sets, way, feats)
    cstate.line_colors[new_sets, way] = colors.to(torch.int32)
    if line_prio is not None:
        line_prio[drop_sets, way] = prios
    _advance_cursors(cfg, state, sets, is_new)

    # occupancy: -victim color (only where a new line replaced it),
    # +incoming color; slot 0 (uncolored) is scratch
    zero = torch.zeros_like(sets)
    colors = colors.to(torch.int64)
    dec = torch.where(is_new & (victim_color > 0),
                      victim_color.to(torch.int64), zero)
    inc = torch.where(is_new & (colors > 0), colors, zero)
    cc = state.color_counts
    cc.index_add_(0, dec, torch.full_like(dec, -1, dtype=torch.int32))
    cc.index_add_(0, inc, torch.ones_like(inc, dtype=torch.int32))
    cc[0] = 0
    return (cstate, evicted) if return_evicted else cstate


def stats(state: CacheState) -> Tuple[CacheState, dict]:
    """Read and reset the hit/miss counters (the reference resets on every
    stats print)."""
    h, m = (int(v) for v in torch.stack([state.hits, state.misses]).tolist())
    state.hits.zero_()
    state.misses.zero_()
    ratio = h / (h + m) if (h + m) else 0.0
    return state, {"hits": h, "misses": m, "hit_ratio": ratio}
