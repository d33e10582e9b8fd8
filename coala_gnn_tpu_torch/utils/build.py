"""Build a C++ or CUDA source of the port into a shared library at first
use.

Two sources, two compilers, one route: a library with a plain C
interface, loaded with ``ctypes``. ``csrc/*.cu`` (the kernels) go through
``nvcc`` for sm_90a (seconds to build, where an extension that includes
PyTorch's headers takes minutes); ``csrc/*.cpp`` (the host tier's row
functions) through ``g++ -O3 -march=native -fopenmp``. A library is named
by a hash of its source and flags and lives in ``coala_gnn_tpu_torch/_build/``
(gitignored), so a changed source rebuilds and an unchanged one loads at
once. A build writes to a temporary name and renames, so concurrent first
uses in several processes never load a half-written file.

Nothing here runs at import: a machine without a CUDA card (where the
CPU tests run) needs no ``nvcc``, and the CPU paths never build a ``.cu``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-std=c++17")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the port's CUDA kernels are built with it")
    return nvcc


def find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH; the port's native host "
                           "library is built with it")
    return gxx


def _toolchain(source: str) -> tuple:
    """(compiler finder, flags) for a source by its extension."""
    return {".cu": (find_nvcc, NVCC_FLAGS),
            ".cpp": (find_gxx, GXX_FLAGS)}[os.path.splitext(source)[1]]


def library_path(source: str) -> str:
    """Where the library built from ``source`` (a file in csrc/) lives."""
    flags = _toolchain(source)[1]
    with open(os.path.join(CSRC_DIR, source), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(flags).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")


def build(source: str) -> str:
    """Compile csrc/``source`` unless its library exists; returns its path.
    The compiler's report (for nvcc ``-Xptxas -v``: registers, spills) is
    kept beside the library as ``<library>.log``."""
    out = library_path(source)
    if os.path.exists(out):
        return out
    find, flags = _toolchain(source)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find(), *flags, "-o", tmp, os.path.join(CSRC_DIR, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed on {source} "
                           f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    with open(out + ".log", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load_library(source: str) -> ctypes.CDLL:
    """Build (at first use) and load the library of csrc/``source``; the
    caller keeps the handle."""
    return ctypes.CDLL(build(source))
