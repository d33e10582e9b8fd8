"""Host-RAM feature tier (port of ``coala_gnn_tpu/cache/host_tier.py``):
the node features in host memory, served to the cache's miss path by the
native parallel row gather, or by numpy where that library does not
build or is not asked for."""

from __future__ import annotations

import concurrent.futures
from typing import Optional

import numpy as np

from coala_gnn_tpu_torch.native import lib as native_lib


class HostFeatureStore:
    """``features`` [num_nodes, dim] (may be a memory map). With
    ``use_native`` and a C-contiguous f32 matrix, gathers run in the native
    library (``_native_ok``); ``ResidentTrainer`` then fuses the staged
    miss path's gather and transport encode (``fetch_encoded``)."""

    def __init__(self, features: np.ndarray, use_native: bool = True):
        self.features = features
        self.dim = int(features.shape[1])
        self._lib = None
        self._native_ok = False
        self._pool = None
        if use_native and features.dtype == np.float32:
            try:
                self._lib = native_lib.get()
            except (OSError, RuntimeError):
                return
            self._native_ok = bool(features.flags["C_CONTIGUOUS"])

    def fetch_async(self, ids: np.ndarray) -> concurrent.futures.Future:
        """``fetch`` of a copy of ``ids`` on one of two worker threads
        (started at the first call); the future's result is the rows."""
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="host-tier")
        return self._pool.submit(self.fetch, np.array(ids, copy=True))

    def fetch(self, ids: np.ndarray, out: Optional[np.ndarray] = None
              ) -> np.ndarray:
        """out[i] = features[ids[i]] (float32); ids < 0 -> zero rows."""
        ids = np.asarray(ids, dtype=np.int64)
        if self._native_ok:
            return native_lib.gather_rows(self._lib, self.features, ids,
                                          out=out)
        if out is None:
            out = np.zeros((ids.shape[0], self.dim), dtype=np.float32)
        else:
            out[:] = 0
        ok = ids >= 0
        out[ok] = np.asarray(self.features[ids[ok]], dtype=np.float32)
        return out

    def fetch_encoded(self, ids: np.ndarray, transport: str,
                      enc_out: Optional[np.ndarray] = None,
                      scale_out: Optional[np.ndarray] = None):
        """The gather fused with the stage transport's encode, each row read
        once: (rows, None) for float32, (bf16 bits as uint16, None) for
        bfloat16, (int8 rows, f32 scales) for int8; ids < 0 give zero rows
        (scale 1). None without the native library. Another transport
        raises ``ValueError`` (the JAX store returns None for it; ROADMAP.md
        section C)."""
        if transport not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"unknown stage transport {transport!r}")
        if not self._native_ok:
            return None
        ids = np.asarray(ids, dtype=np.int64)
        if transport == "float32":
            return self.fetch(ids, out=enc_out), None
        if transport == "bfloat16":
            return native_lib.gather_rows_bf16(self._lib, self.features, ids,
                                               out=enc_out), None
        return native_lib.gather_quantize_rows(
            self._lib, self.features, ids, q_out=enc_out, scale_out=scale_out)
