"""ELL gather-SpMM: ``out[i, :] = sum_k w[i, k] * x[adj[i, k], :]``.

Port of both Pallas kernels of the JAX package, which share this contract:
``ell_spmm_pallas`` (coala_gnn_tpu/ops/pallas_spmm.py, f32 table) and
``gather_sum_vmem`` (coala_gnn_tpu/ops/pallas_gather.py, f32 or bf16
table). On Hopper both become one hand-written CUDA kernel,
``csrc/gather_spmm.cu``, instantiated for f32, bf16 and int8 tables (the
int8 form takes a per-row f32 ``scale`` and dequantises each row as it
reads it); see the note there for what bounds it and how its design
answers that.

``gather_spmm`` is differentiable in ``x`` and ``w`` (a
``torch.autograd.Function``). Its backward is two more kernels of the same
source: ``grad_w[n, k] = <g[n], x[adj[n, k]]>`` for every slot (w == 0
included) and ``grad_x[adj[n, k]] += w[n, k] * g[n]`` by atomics into a
zeroed table. Only the kernels whose input needs a gradient launch. An
int8 table is constant: a call that would need its backward is refused.

On the training step the forward computes layer 0's neighbour sum straight
off the flat cache table (``x`` = table, ``adj`` = the sampled frontier
ids, ``w`` = the block mask), and GAT's attention combine on every layer
(heads stacked as rows, ``w`` = the attention), where the backward runs.

Dispatch goes by the tensors' device: CPU tensors take the plain versions
(``gather_spmm_reference``, ``gather_spmm_grad_w_reference``,
``gather_spmm_grad_x_reference``); CUDA tensors launch the kernels or
raise. There is no fallback from a kernel to its plain version.
``LAUNCHES`` counts kernel launches per entry.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from coala_gnn_tpu_torch.utils.cuda_build import load_library

SOURCE = "gather_spmm.cu"
_ENTRY = {torch.float32: "gather_spmm_f32", torch.bfloat16: "gather_spmm_bf16",
          torch.int8: "gather_spmm_i8"}
_GRAD_W_ENTRY = {torch.float32: "gather_spmm_grad_w_f32",
                 torch.bfloat16: "gather_spmm_grad_w_bf16"}

#: kernel launches per entry; only a launch on the card adds one
LAUNCHES = {"gather_spmm[float32]": 0, "gather_spmm[bfloat16]": 0,
            "gather_spmm[int8]": 0, "gather_spmm_grad_w": 0,
            "gather_spmm_grad_x": 0}


def _fwd_name(dtype: torch.dtype) -> str:
    return f"gather_spmm[{str(dtype).split('.')[-1]}]"


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _rows(x: torch.Tensor, idx: torch.Tensor,
          scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Rows ``x[idx]`` widened to f32 (int8: times their scale, the order
    of ``dequantize_rows``)."""
    rows = x[idx].float()
    return rows if scale is None else rows * scale[idx][..., None]


def gather_spmm_reference(x: torch.Tensor, adj: torch.Tensor,
                          w: torch.Tensor,
                          scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain version: an explicit k loop in the kernel's order (k = 0..F-1,
    f32 accumulation). Returns f32 [N, D]."""
    acc = torch.zeros(adj.shape[0], x.shape[1], dtype=torch.float32,
                      device=x.device)
    for k in range(adj.shape[1]):
        acc = acc + _rows(x, adj[:, k], scale) * w[:, k, None]
    return acc


def gather_spmm_grad_w_reference(x: torch.Tensor, adj: torch.Tensor,
                                 g: torch.Tensor) -> torch.Tensor:
    """Plain ``grad_w``: the row dot ``<g[n], x[adj[n, k]]>`` for every
    slot -> f32 [N, F]."""
    return torch.einsum("nfd,nd->nf", x[adj.long()].float(), g)


def gather_spmm_grad_x_reference(adj: torch.Tensor, w: torch.Tensor,
                                 g: torch.Tensor, s: int) -> torch.Tensor:
    """Plain ``grad_x``: ``index_add_`` of ``w[n, k] * g[n]`` into row
    ``adj[n, k]`` of a zeroed f32 [s, D]."""
    d = g.shape[1]
    gx = torch.zeros(s, d, dtype=torch.float32, device=g.device)
    return gx.index_add_(0, adj.reshape(-1).long(),
                         (w[..., None] * g[:, None, :]).reshape(-1, d))


_UNIT_ROUNDOFF = 2.0 ** -24   # of f32


def grad_w_error_bound(x: torch.Tensor, adj: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """How far the grad_w kernel may lie from its plain version, per entry
    [N, F]: each sums the D products of a row dot in f32, in its own order,
    and so lies within D * u * sum_d |g x| of the exact dot; the two differ
    by at most twice that."""
    d = x.shape[1]
    return 2 * d * _UNIT_ROUNDOFF * gather_spmm_grad_w_reference(
        x.abs(), adj, g.abs())


def grad_x_error_bound(adj: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                       s: int) -> torch.Tensor:
    """The same for grad_x, per entry [S, D]: a table row referenced m
    times sums m products in an order that the atomics (or index_add_)
    choose, within m * u * sum |w g| of the exact sum. m = 1 (every slot
    row referenced once, the contiguous layout) makes both sides exact."""
    m = torch.bincount(adj.reshape(-1).long(), minlength=s)
    return 2 * m[:, None] * _UNIT_ROUNDOFF * gather_spmm_grad_x_reference(
        adj, w.abs(), g.abs(), s)


def _check(x: torch.Tensor, adj: torch.Tensor, w: torch.Tensor,
           scale: Optional[torch.Tensor]) -> None:
    if x.dtype not in _ENTRY:
        raise TypeError(f"gather_spmm: x must be float32, bfloat16 or int8, "
                        f"got {x.dtype}")
    if (x.dtype == torch.int8) != (scale is not None):
        raise TypeError("gather_spmm: an int8 table needs its f32 row "
                        "scales (scale=...), and only an int8 table takes "
                        "them")
    if adj.dtype != torch.int32:
        raise TypeError(f"gather_spmm: adj must be int32, got {adj.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"gather_spmm: w must be float32, got {w.dtype}")
    if x.dim() != 2 or adj.dim() != 2 or w.shape != adj.shape:
        raise ValueError(f"gather_spmm: need x [S, D], adj [N, F] and w "
                         f"[N, F]; got {tuple(x.shape)}, {tuple(adj.shape)}, "
                         f"{tuple(w.shape)}")
    tensors = [x, adj, w]
    if scale is not None:
        if scale.dtype != torch.float32 or scale.shape != x.shape[:1]:
            raise ValueError(f"gather_spmm: scale must be float32 [S], got "
                             f"{scale.dtype} {tuple(scale.shape)}")
        tensors.append(scale)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gather_spmm: x, adj, w and scale must be "
                         "contiguous")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"gather_spmm: tensors on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_spmm: unsupported device {x.device}")


def _check_grad(adj: torch.Tensor, g: torch.Tensor, **others) -> None:
    """The backward entries' inputs: adj int32 [N, F], g f32 [N, D], and
    x [S, D] (f32 or bf16) or w f32 [N, F]; contiguous, on one device."""
    tensors = [adj, g, *others.values()]
    if adj.dtype != torch.int32 or adj.dim() != 2:
        raise TypeError("gather_spmm backward: adj must be int32 [N, F]")
    if g.dtype != torch.float32 or g.dim() != 2 or g.shape[0] != adj.shape[0]:
        raise ValueError(f"gather_spmm backward: g must be float32 "
                         f"[N, D], got {g.dtype} {tuple(g.shape)}")
    x, w = others.get("x"), others.get("w")
    if x is not None and (x.dtype not in _GRAD_W_ENTRY or
                          x.shape[1:] != g.shape[1:]):
        raise ValueError(f"gather_spmm backward: x must be float32 or "
                         f"bfloat16 [S, D], got {x.dtype} {tuple(x.shape)}")
    if w is not None and (w.dtype != torch.float32 or w.shape != adj.shape):
        raise ValueError("gather_spmm backward: w must be float32 [N, F]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gather_spmm backward: inputs must be contiguous")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("gather_spmm backward: tensors on different "
                         "devices")


def _launch(entry: str, counter: str, device: torch.device, *args) -> None:
    """Call a C entry point on the current stream of ``device``; raise if
    the launch failed, else count it."""
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err:
        raise RuntimeError(f"{entry} kernel launch failed: "
                           f"{lib.gather_spmm_error_string(err).decode()}")
    LAUNCHES[counter] += 1


def _forward(x: torch.Tensor, adj: torch.Tensor, w: torch.Tensor,
             scale: Optional[torch.Tensor]) -> torch.Tensor:
    if x.device.type == "cpu":
        return gather_spmm_reference(x, adj, w, scale)
    n, f = adj.shape
    s, d = x.shape
    out = torch.empty(n, d, dtype=torch.float32, device=x.device)
    ptrs = [x.data_ptr()] + ([] if scale is None else [scale.data_ptr()])
    _launch(_ENTRY[x.dtype], _fwd_name(x.dtype), x.device, *ptrs,
            adj.data_ptr(), w.data_ptr(), out.data_ptr(), s, n, f, d)
    return out


def gather_spmm_grad_w(x: torch.Tensor, adj: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """grad_w [N, F] f32 of a forward on x [S, D] f32|bf16 for the upstream
    gradient g [N, D] f32 (contiguous): the plain version on the CPU, the
    kernel on the card."""
    _check_grad(adj, g, x=x)
    if x.device.type == "cpu":
        return gather_spmm_grad_w_reference(x, adj, g)
    n, f = adj.shape
    s, d = x.shape
    gw = torch.empty(n, f, dtype=torch.float32, device=x.device)
    _launch(_GRAD_W_ENTRY[x.dtype], "gather_spmm_grad_w", x.device,
            x.data_ptr(), adj.data_ptr(), g.data_ptr(), gw.data_ptr(), s, n,
            f, d)
    return gw


def gather_spmm_grad_x(adj: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                       s: int) -> torch.Tensor:
    """grad_x [s, D] f32 for the upstream gradient g [N, D] f32
    (contiguous): the plain version on the CPU, on the card the kernel's
    atomics into a table zeroed here."""
    _check_grad(adj, g, w=w)
    if g.device.type == "cpu":
        return gather_spmm_grad_x_reference(adj, w, g, s)
    n, f = adj.shape
    d = g.shape[1]
    gx = torch.zeros(s, d, dtype=torch.float32, device=g.device)
    _launch("gather_spmm_grad_x", "gather_spmm_grad_x", g.device,
            adj.data_ptr(), w.data_ptr(), g.data_ptr(), gx.data_ptr(), s, n,
            f, d)
    return gx


class _GatherSpmm(torch.autograd.Function):
    """The f32 / bf16 table forms with their backward kernels."""

    @staticmethod
    def forward(ctx, x, adj, w):
        ctx.save_for_backward(x, adj, w)
        return _forward(x, adj, w, None)

    @staticmethod
    def backward(ctx, g):
        x, adj, w = ctx.saved_tensors
        g = g.contiguous()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = gather_spmm_grad_x(adj, w, g, x.shape[0]).to(x.dtype)
        if ctx.needs_input_grad[2]:
            gw = gather_spmm_grad_w(x, adj, g)
        return gx, None, gw


def gather_spmm(x: torch.Tensor, adj: torch.Tensor, w: torch.Tensor,
                scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [S, D] f32|bf16|int8 (int8 with ``scale`` f32 [S]), adj int32
    [N, F] (entries in [0, S)), w f32 [N, F] (0 makes a slot a no-op in
    the forward) -> f32 [N, D]. Any D.

    CPU tensors: the plain versions. CUDA tensors: the kernels, on the
    current stream, without synchronising. On the kernel path a dst row
    whose slots hold an index outside [0, S) comes out NaN (the plain
    version raises instead). Differentiable in ``x`` and ``w`` for f32 and
    bf16 tables; with an int8 table a ``w`` or ``scale`` that requires
    grad is refused."""
    _check(x, adj, w, scale)
    if scale is None:
        return _GatherSpmm.apply(x, adj, w)
    if torch.is_grad_enabled() and (w.requires_grad or scale.requires_grad):
        raise ValueError("gather_spmm: an int8 table is constant; its form "
                         "has no backward (w and scale must not require "
                         "grad)")
    return _forward(x, adj, w, scale)


# The JAX package's second kernel (VMEM-resident table, f32 or bf16) has the
# same contract; on Hopper it is the same kernel's bf16/f32 instantiations.
gather_sum_vmem = gather_spmm


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (at first use), load and type the kernels' C interface."""
    lib = load_library(SOURCE)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    sizes = [i64, i32, i32, i32, ptr]                 # s, n, f, d, stream
    for name in ("gather_spmm_f32", "gather_spmm_bf16",
                 *_GRAD_W_ENTRY.values(), "gather_spmm_grad_x"):
        getattr(lib, name).argtypes = [ptr] * 4 + sizes
    lib.gather_spmm_i8.argtypes = [ptr] * 5 + sizes
    for name in (*_ENTRY.values(), *_GRAD_W_ENTRY.values(),
                 "gather_spmm_grad_x"):
        getattr(lib, name).restype = ctypes.c_int
    lib.gather_spmm_error_string.argtypes = [ctypes.c_int]
    lib.gather_spmm_error_string.restype = ctypes.c_char_p
    return lib
