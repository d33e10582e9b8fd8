"""Buffer sizing (port of ``coala_gnn_tpu/parallel/sizing.py``: the part
the one-device cache uses). The multi-device exchange's bucket sizes
(``lookup_bucket_cap``, ``fill_bucket_cap``) come with multi-GPU
(ROADMAP.md queue A, "multi-GPU")."""

from __future__ import annotations


def ceil_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1). The miss-fill buffers round up to
    it, so the fill sees O(log) distinct shapes, and the cache state stays
    bitwise the JAX package's."""
    p = 1
    while p < x:
        p <<= 1
    return p
