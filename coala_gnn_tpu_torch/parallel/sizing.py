"""Buffer sizing of the cache exchange (port of
``coala_gnn_tpu/parallel/sizing.py``): one definition of the bucket sizes
that both the exchange (``parallel/sharded_cache.py``) and the byte model
(``parallel/comm_model.py``) use, so the model's bytes are the bytes the
ranks hand to ``all_to_all_single``."""

from __future__ import annotations


def lookup_bucket_cap(n_req: int, group: int, slack: float = 2.0) -> int:
    """Slots per (requester, owner) bucket of a lookup or probe over
    ``group`` ranks: ``slack`` times the uniform share, plus one, at most
    ``n_req``. Requests past it overflow and are served from the host
    tier."""
    if group <= 1:
        return n_req
    return min(n_req, int(slack * n_req / group) + 1)


def fill_bucket_cap(m_cap: int, group: int, slack: float = 2.0) -> int:
    """Slots per owner bucket of the miss fill. ``m_cap`` is the
    ``ceil_pow2`` of the largest miss count of any rank; the + 128 absorbs
    owner skew in small miss batches."""
    if group <= 1:
        return m_cap
    return min(m_cap, int(slack * m_cap / group) + 128)


def ceil_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1). The miss-fill buffers round up to
    it, so the fill sees O(log) distinct shapes, and the cache state stays
    bitwise the JAX package's."""
    p = 1
    while p < x:
        p <<= 1
    return p
