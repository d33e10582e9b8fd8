"""ctypes bindings of the port's native host library
(``csrc/host_native.cpp``), built with g++ at first use into
``coala_gnn_tpu_torch/_build/`` (``utils/build.py``).

Port of the five row functions of ``coala_gnn_tpu/native/lib.py`` that the
staged miss path calls. bf16 comes back as its uint16 bit pattern (numpy
has no bf16 type, and the card's machine has no ``ml_dtypes``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

from coala_gnn_tpu_torch.utils.build import load_library

SOURCE = "host_native.cpp"

_i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(dtype=np.uint16, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(dtype=np.int8, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def get() -> ctypes.CDLL:
    """Build (at first use), load and type the library; raises
    ``RuntimeError`` (no g++, or it failed) or ``OSError`` (load)."""
    lib = load_library(SOURCE)
    lib.cg_gather_rows_f32.argtypes = [_f32p, _i64, _i64p, _i64, _f32p]
    lib.cg_quantize_rows.argtypes = [_f32p, _i64, _i64, _i8p, _f32p]
    lib.cg_encode_bf16.argtypes = [_f32p, _i64, _u16p]
    lib.cg_gather_rows_bf16.argtypes = [_f32p, _i64, _i64p, _i64, _u16p]
    lib.cg_gather_quantize_rows.argtypes = [_f32p, _i64, _i64p, _i64, _i8p,
                                            _f32p]
    for name in ("cg_gather_rows_f32", "cg_quantize_rows", "cg_encode_bf16",
                 "cg_gather_rows_bf16", "cg_gather_quantize_rows"):
        getattr(lib, name).restype = None
    return lib


def gather_rows(lib: ctypes.CDLL, features: np.ndarray, ids: np.ndarray,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """out[i] = features[ids[i]] f32; ids < 0 -> zero rows."""
    if features.dtype != np.float32 or features.ndim != 2:
        raise TypeError("features must be float32 [n, dim]")
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if out is None:
        out = np.empty((ids.shape[0], features.shape[1]), dtype=np.float32)
    lib.cg_gather_rows_f32(features, features.shape[1], ids, ids.shape[0], out)
    return out


def quantize_rows(lib: ctypes.CDLL, rows: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """rows f32 [n, dim] -> (q int8 [n, dim], scale f32 [n])."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    n, dim = rows.shape
    q = np.empty((n, dim), np.int8)
    scale = np.empty(n, np.float32)
    lib.cg_quantize_rows(rows, n, dim, q, scale)
    return q, scale


def encode_bf16(lib: ctypes.CDLL, rows: np.ndarray,
                out: Optional[np.ndarray] = None) -> np.ndarray:
    """f32 rows -> their bf16 bit patterns (uint16, same shape)."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    if out is None:
        out = np.empty(rows.shape, np.uint16)
    lib.cg_encode_bf16(rows.reshape(-1), rows.size, out.reshape(-1))
    return out


def gather_rows_bf16(lib: ctypes.CDLL, features: np.ndarray,
                     ids: np.ndarray, out: Optional[np.ndarray] = None
                     ) -> np.ndarray:
    """out[i] = bf16 bits of features[ids[i]] (uint16); ids < 0 -> zero
    rows."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    if out is None:
        out = np.empty((ids.shape[0], features.shape[1]), np.uint16)
    lib.cg_gather_rows_bf16(features, features.shape[1], ids, ids.shape[0],
                            out)
    return out


def gather_quantize_rows(lib: ctypes.CDLL, features: np.ndarray,
                         ids: np.ndarray,
                         q_out: Optional[np.ndarray] = None,
                         scale_out: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """The gather fused with ``quantize_rows`` -> (q int8 [n, dim], scale
    f32 [n]); ids < 0 -> zero rows with scale 1."""
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    n, dim = ids.shape[0], features.shape[1]
    if q_out is None:
        q_out = np.empty((n, dim), np.int8)
    if scale_out is None:
        scale_out = np.empty(n, np.float32)
    lib.cg_gather_quantize_rows(features, dim, ids, n, q_out, scale_out)
    return q_out, scale_out
