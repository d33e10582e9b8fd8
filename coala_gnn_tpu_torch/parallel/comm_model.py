"""Per-step byte accounting of the cache exchange (port of
``coala_gnn_tpu/parallel/comm_model.py``, the same arithmetic).

The exchange's traffic is determined by shapes: every
``all_to_all_single`` ships its whole fixed-size buckets, padding
included, so the bytes of a step are exact functions of (n_req,
bucket_cap, ranks, dim, dtype). This module writes them down once, splits
them into intra-host (NVLink) and cross-host (network) shares per cache
mode, and projects the scaling from one host to two.

Every count is PER RANK PER STEP unless noted. "off-device" counts the
bytes that leave a rank: of each all_to_all bucket grid only the rows for
the other ranks of the group leave (the rank's own row stays). The ranks
count what they hand to the collectives (``parallel/mesh.CommLedger``);
tests/test_torch_multigpu_steps.py holds ``step_traffic`` against those
counts. The gradient all-reduce is modelled as a ring (2 (D-1)/D of the
payload leaves each rank), which depends on how the backend runs it: the
ranks count its payload, not its wire bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from coala_gnn_tpu_torch.parallel.sizing import (
    ceil_pow2, fill_bucket_cap, lookup_bucket_cap as bucket_cap)


@dataclasses.dataclass(frozen=True)
class ExchangeShape:
    """Static shapes of one exchange step (``sharded_cache.exchange_lookup``).

    n_req      : request slots per rank
    bucket_cap : slots per (requester, owner) bucket
    n_dev      : ranks in the whole job
    group      : ranks per exchange group (n_dev for sharded, the host's
                 ranks for node_local, 1 for isolated)
    local      : ranks per host
    dim        : feature dim
    feat_bytes : bytes per feature element of the response (4 f32, 2 bf16)
    int8_response : response rows travel as int8 lines + an f32 scale
    """
    n_req: int
    bucket_cap: int
    n_dev: int
    group: int
    local: int
    dim: int
    feat_bytes: int = 4
    int8_response: bool = False

    @property
    def row_resp_bytes(self) -> int:
        """Bytes per response slot of the feature all_to_all alone (int8
        responses send their scales in a second [G, c] f32 all_to_all,
        counted in ``exchange_step_bytes``)."""
        return self.dim if self.int8_response \
            else self.dim * self.feat_bytes


def exchange_step_bytes(s: ExchangeShape) -> dict:
    """Bytes leaving one rank in one ``exchange_lookup``, by phase and by
    link class. In a group of G a rank sends G - 1 peer rows; a peer is
    cross-host only when the group spans hosts."""
    G = s.group
    if G <= 1:
        z = {"request": 0, "response": 0, "hitbits": 0, "total": 0}
        return {"off_device": dict(z), "cross_host": dict(z),
                "intra_host": dict(z)}
    peers = G - 1
    # group members are contiguous ranks: G - local of them sit on another
    # host when the group spans hosts (sharded), none when it fits one
    cross_peers = max(G - s.local, 0)
    c = s.bucket_cap

    def phase(row_bytes):
        per_peer = c * row_bytes
        return {"off": peers * per_peer, "cross": cross_peers * per_peer}

    req = phase(4)                       # int32 ids
    resp = phase(s.row_resp_bytes)       # feature rows
    if s.int8_response:
        # scales ride a second [G, c] f32 all_to_all
        resp = {k: v + phase(4)[k] for k, v in resp.items()}
    hits = phase(1)                      # bool hit bits

    def pack(key):
        d = {"request": req[key], "response": resp[key],
             "hitbits": hits[key]}
        d["total"] = sum(d.values())
        return d

    off, cross = pack("off"), pack("cross")
    intra = {k: off[k] - cross[k] for k in off}
    return {"off_device": off, "cross_host": cross, "intra_host": intra}


def fill_step_bytes(s: ExchangeShape, fill_cap: int,
                    feat_bytes: Optional[int] = None) -> dict:
    """Bytes of one miss fill (ids + rows + colors to their owners); only
    steps with misses run it."""
    G = s.group
    if G <= 1:
        return {"off_device": 0, "cross_host": 0}
    fb = s.dim * (feat_bytes or s.feat_bytes)
    per_peer = fill_cap * (4 + fb + 4)
    return {"off_device": (G - 1) * per_peer,
            "cross_host": max(G - s.local, 0) * per_peer}


def grad_psum_bytes(param_bytes: int, n_dev: int, local: int) -> dict:
    """Ring all-reduce of the gradients: each rank moves 2 (D-1)/D of the
    parameter bytes; the cross-host share is the fraction of ring hops that
    cross hosts (H of D)."""
    if n_dev <= 1:
        return {"off_device": 0, "cross_host": 0}
    hosts = max(n_dev // local, 1)
    off = int(2 * (n_dev - 1) / n_dev * param_bytes)
    cross_frac = (hosts if hosts > 1 else 0) / n_dev
    return {"off_device": off, "cross_host": int(2 * cross_frac * param_bytes)}


def meta_allgather_bytes(num_colors: int, hosts: int) -> int:
    """Cross-host cache-meta exchange per refresh, int32 [C + 1] from
    every other host; PER HOST."""
    if hosts <= 1:
        return 0
    return (num_colors + 1) * 4 * (hosts - 1)


def step_traffic(mode: str, n_req: int, n_dev: int, local: int, dim: int,
                 num_colors: int = 0, param_bytes: int = 0,
                 feat_bytes: int = 4, int8_response: bool = False,
                 refresh_counter: int = 8, slack: float = 2.0,
                 misses: int = 0) -> dict:
    """Per-rank per-step traffic of a cache mode: the all-hit step's
    exchange phases, the gradient all-reduce and the amortised cache meta;
    the fill's bytes only when ``misses`` (the largest miss count of any
    rank on a miss step) is given, since its buckets are sized from
    ``ceil_pow2(misses)``."""
    group = {"sharded": n_dev, "node_local": min(local, n_dev),
             "isolated": 1}[mode]
    s = ExchangeShape(n_req=n_req, bucket_cap=bucket_cap(n_req, group, slack),
                      n_dev=n_dev, group=group, local=local, dim=dim,
                      feat_bytes=feat_bytes, int8_response=int8_response)
    ex = exchange_step_bytes(s)
    ps = grad_psum_bytes(param_bytes, n_dev, local)
    hosts = max(n_dev // local, 1)
    meta_host = meta_allgather_bytes(num_colors, hosts)
    meta = meta_host / max(refresh_counter, 1) / max(local, 1)
    if misses > 0:
        fill = fill_step_bytes(
            s, fill_cap=fill_bucket_cap(ceil_pow2(misses), group, slack))
    else:
        fill = {"off_device": 0, "cross_host": 0}
    return {
        "mode": mode, "group": group, "bucket_cap": s.bucket_cap,
        "exchange": ex,
        "grad_psum": ps,
        "meta_per_step": meta,       # cross-host, amortised, per rank
        "meta_host_per_refresh": meta_host,
        "fill_miss_step": fill,
        "cross_host_total": ex["cross_host"]["total"] + ps["cross_host"]
                            + meta,
        "off_device_total": ex["off_device"]["total"] + ps["off_device"]
                            + meta,
    }


def step_time(step_compute_s: float, traffic: dict, cross_gbps: float,
              intra_gbps: float) -> dict:
    """Serialised step time: compute + intra-host bytes + cross-host bytes
    at the given link rates (GB/s), with no credit for overlap."""
    intra = (traffic["exchange"]["intra_host"]["total"]
             + traffic["grad_psum"]["off_device"]
             - traffic["grad_psum"]["cross_host"])
    cross = traffic["cross_host_total"]
    t_intra = intra / (intra_gbps * 1e9)
    t_cross = cross / (cross_gbps * 1e9)
    return {"t_compute_s": step_compute_s, "t_ici_s": t_intra,
            "t_dcn_s": t_cross,
            "t_step_s": step_compute_s + t_intra + t_cross}


def efficiency_1_to_2_hosts(mode: str, step_compute_s: float, n_req: int,
                            local: int, dim: int, cross_gbps: float,
                            intra_gbps: float, num_colors: int = 0,
                            param_bytes: int = 0, feat_bytes: int = 4,
                            int8_response: bool = False) -> dict:
    """Weak scaling from one host to two, modelled: the step time at one
    host over the step time at two, the same work per rank."""
    kw = dict(n_req=n_req, local=local, dim=dim, num_colors=num_colors,
              param_bytes=param_bytes, feat_bytes=feat_bytes,
              int8_response=int8_response)
    t1 = step_time(step_compute_s,
                   step_traffic(mode, n_dev=local, **kw),
                   cross_gbps, intra_gbps)
    t2 = step_time(step_compute_s,
                   step_traffic(mode, n_dev=2 * local, **kw),
                   cross_gbps, intra_gbps)
    return {"t_1host": t1, "t_2hosts": t2,
            "efficiency": t1["t_step_s"] / t2["t_step_s"]}


def project_efficiency(step_compute_s: float, cross_bytes: int,
                       intra_bytes: int, cross_gbps: float,
                       intra_gbps: float) -> dict:
    """Compute share of one serialised step at the given link rates."""
    t_intra = intra_bytes / (intra_gbps * 1e9)
    t_cross = cross_bytes / (cross_gbps * 1e9)
    t = step_compute_s + t_intra + t_cross
    return {"t_compute_s": step_compute_s, "t_ici_s": t_intra,
            "t_dcn_s": t_cross,
            "efficiency": step_compute_s / t if t > 0 else 1.0}
