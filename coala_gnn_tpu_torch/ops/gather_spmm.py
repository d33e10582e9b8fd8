"""ELL gather-SpMM: ``out[i, :] = sum_k w[i, k] * x[adj[i, k], :]``.

Port of both Pallas kernels of the JAX package, which share this contract:
``ell_spmm_pallas`` (coala_gnn_tpu/ops/pallas_spmm.py, f32 table) and
``gather_sum_vmem`` (coala_gnn_tpu/ops/pallas_gather.py, f32 or bf16
table). On Hopper both become one hand-written CUDA kernel,
``csrc/gather_spmm.cu``, instantiated for f32, bf16 and int8 tables (the
int8 form takes a per-row f32 ``scale`` and dequantises each row as it
reads it); see the note there for what bounds it and how its design
answers that. ``read_as=torch.bfloat16`` reads an f32 or int8 table as a
bf16 model's layer 0 sees it: each element (int8: ``q * scale`` in f32
first) rounded to bf16, ties to even, before its multiply-add; two more
instantiations, ``gather_spmm_f32_as_bf16`` and
``gather_spmm_i8_as_bf16``. A bf16 table read as bf16 is the bf16 form.

``gather_spmm`` is differentiable in ``x`` and ``w`` (a
``torch.autograd.Function``). Its backward is more kernels of the same
source: ``grad_w[n, k] = <g[n], x[adj[n, k]]>`` for every slot (w == 0
included), and ``grad_x[s] = sum of w[n, k] * g[n] over the slots with
adj[n, k] = s`` in slot order, a gather over the transpose of ``adj``
(``adj_transpose``: ``row_ptr`` [S + 1], ``slot`` [N * F]) that writes
every table row once. A caller whose ``adj`` is fixed (GAT's contiguous
layout) builds the transpose once and hands it in (``adj_t``); otherwise
the backward builds it. Only the kernels whose input needs a gradient
launch. An int8 table, and a table read as bf16 that is not stored so, is
constant: a call that would need its backward is refused.

On the training step the forward computes layer 0's neighbour sum straight
off the flat cache table (``x`` = table, ``adj`` = the sampled frontier
ids, ``w`` = the block mask), and GAT's attention combine on every layer
(heads stacked as rows, ``w`` = the attention), where the backward runs.

Dispatch goes by the tensors' device: CPU tensors take the plain versions
(``gather_spmm_reference``, ``gather_spmm_grad_w_reference``,
``gather_spmm_grad_x_reference``, ``adj_transpose_reference``); CUDA
tensors launch the kernels or raise. There is no fallback from a kernel to
its plain version. ``LAUNCHES`` counts kernel launches per entry.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from coala_gnn_tpu_torch.utils.build import load_library

SOURCE = "gather_spmm.cu"
#: forward form (``_form``) -> C entry; the counter of a form is
#: ``gather_spmm[<form>]``
_ENTRY = {"float32": "gather_spmm_f32", "bfloat16": "gather_spmm_bf16",
          "int8": "gather_spmm_i8",
          "float32_as_bf16": "gather_spmm_f32_as_bf16",
          "int8_as_bf16": "gather_spmm_i8_as_bf16"}
_GRAD_W_ENTRY = {torch.float32: "gather_spmm_grad_w_f32",
                 torch.bfloat16: "gather_spmm_grad_w_bf16"}
_GRAD_W_COUNTER = {torch.float32: "gather_spmm_grad_w",
                   torch.bfloat16: "gather_spmm_grad_w[bfloat16]"}

#: kernel launches per entry; only a launch on the card adds one
LAUNCHES = {**{f"gather_spmm[{form}]": 0 for form in _ENTRY},
            **{name: 0 for name in _GRAD_W_COUNTER.values()},
            "gather_spmm_grad_x": 0, "adj_transpose": 0}

#: the transpose of an adj [N, F] over S table rows: (row_ptr int32
#: [S + 1], slot int32 [N * F]); row s's slots n * F + k (adj[n, k] = s) in
#: ascending order at slot[row_ptr[s]:row_ptr[s + 1]], -1 past row_ptr[S]
Transpose = Tuple[torch.Tensor, torch.Tensor]


def _form(x: torch.Tensor, read_as: Optional[torch.dtype]) -> str:
    """The forward form of a table of ``x.dtype`` read as ``read_as``
    (None: as stored, widened to f32)."""
    stored = str(x.dtype).split(".")[-1]
    if read_as == torch.bfloat16 and x.dtype != torch.bfloat16:
        return f"{stored}_as_bf16"
    return stored


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _rows(x: torch.Tensor, idx: torch.Tensor,
          scale: Optional[torch.Tensor],
          read_as: Optional[torch.dtype] = None) -> torch.Tensor:
    """Rows ``x[idx]`` widened to f32 (int8: times their scale, the order
    of ``dequantize_rows``); with ``read_as=torch.bfloat16`` each element
    then rounded to bf16 (ties to even) and widened back."""
    rows = x[idx].float()
    if scale is not None:
        rows = rows * scale[idx][..., None]
    if read_as == torch.bfloat16:
        rows = rows.to(torch.bfloat16).float()
    return rows


def gather_spmm_reference(x: torch.Tensor, adj: torch.Tensor,
                          w: torch.Tensor,
                          scale: Optional[torch.Tensor] = None,
                          read_as: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Plain version: an explicit k loop in the kernel's order (k = 0..F-1,
    f32 accumulation) over the rows as ``_rows`` reads them. Returns f32
    [N, D]."""
    acc = torch.zeros(adj.shape[0], x.shape[1], dtype=torch.float32,
                      device=x.device)
    for k in range(adj.shape[1]):
        acc = acc + _rows(x, adj[:, k], scale, read_as) * w[:, k, None]
    return acc


def gather_spmm_grad_w_reference(x: torch.Tensor, adj: torch.Tensor,
                                 g: torch.Tensor) -> torch.Tensor:
    """Plain ``grad_w``: the row dot ``<g[n], x[adj[n, k]]>`` for every
    slot -> f32 [N, F]."""
    return torch.einsum("nfd,nd->nf", x[adj.long()].float(), g)


def gather_spmm_grad_x_reference(adj: torch.Tensor, w: torch.Tensor,
                                 g: torch.Tensor, s: int) -> torch.Tensor:
    """Plain ``grad_x``: ``index_add_`` of ``w[n, k] * g[n]`` into row
    ``adj[n, k]`` of a zeroed f32 [s, D]. On the CPU ``index_add_`` adds
    in slot order, each product rounded before its sum."""
    d = g.shape[1]
    gx = torch.zeros(s, d, dtype=torch.float32, device=g.device)
    return gx.index_add_(0, adj.reshape(-1).long(),
                         (w[..., None] * g[:, None, :]).reshape(-1, d))


def adj_transpose_reference(adj: torch.Tensor, s: int) -> Transpose:
    """Plain transpose of ``adj`` [N, F] over ``s`` table rows (see
    ``Transpose``): a bincount, a cumsum and a stable argsort. Indices
    outside [0, s) are left out."""
    flat = adj.reshape(-1).long()
    ok = (flat >= 0) & (flat < s)
    rows = flat[ok]
    row_ptr = torch.zeros(s + 1, dtype=torch.int32, device=adj.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=s), 0)
    slot = torch.full((flat.numel(),), -1, dtype=torch.int32,
                      device=adj.device)
    order = torch.argsort(rows, stable=True)
    slot[:rows.numel()] = torch.nonzero(ok).reshape(-1)[order].to(
        torch.int32)
    return row_ptr, slot


def gather_spmm_grad_x_transposed_reference(
        adj_t: Transpose, w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain form of the grad_x kernel's algorithm: for every table row,
    ``acc = acc + w[n, k] * g[n]`` over its slots in the transpose's
    (slot) order, one slot position at a time across all rows. Equal bit
    for bit to the CPU ``gather_spmm_grad_x_reference``."""
    row_ptr, slot = adj_t
    f = w.shape[1]
    s = row_ptr.numel() - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    gx = torch.zeros(s, g.shape[1], dtype=torch.float32, device=g.device)
    w_flat = w.reshape(-1)
    for p in range(int(counts.max()) if s else 0):
        rows = torch.nonzero(counts > p).reshape(-1)
        j = slot[row_ptr[rows].long() + p].long()
        gx[rows] = gx[rows] + w_flat[j, None] * g[j // f]
    return gx


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
    times sums m products, the kernel in slot order, the plain version on
    the card in the order its atomics meet, each within m * u * sum |w g|
    of the exact sum. m = 1 (every slot row referenced once, the
    contiguous layout) makes both sides exact."""
    m = torch.bincount(adj.reshape(-1).long(), minlength=s)
    return 2 * m[:, None] * _UNIT_ROUNDOFF * gather_spmm_grad_x_reference(
        adj, w.abs(), g.abs(), s)


def _check(x: torch.Tensor, adj: torch.Tensor, w: torch.Tensor,
           scale: Optional[torch.Tensor],
           read_as: Optional[torch.dtype] = None) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise TypeError(f"gather_spmm: x must be float32, bfloat16 or int8, "
                        f"got {x.dtype}")
    if read_as not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"gather_spmm: read_as must be None, float32 or "
                        f"bfloat16, got {read_as}")
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


def _check_transpose(adj_t: Transpose, adj: torch.Tensor, s: int) -> None:
    """A transpose handed to grad_x: int32 row_ptr [s + 1] and slot
    [N * F], contiguous, on adj's device (its contents are trusted)."""
    if not (isinstance(adj_t, tuple) and len(adj_t) == 2):
        raise TypeError("gather_spmm: adj_t must be (row_ptr, slot)")
    row_ptr, slot = adj_t
    if (row_ptr.dtype != torch.int32 or slot.dtype != torch.int32 or
            row_ptr.shape != (s + 1,) or slot.shape != (adj.numel(),)):
        raise ValueError(f"gather_spmm: adj_t must be int32 row_ptr [{s + 1}]"
                         f" and slot [{adj.numel()}], got "
                         f"{row_ptr.dtype} {tuple(row_ptr.shape)}, "
                         f"{slot.dtype} {tuple(slot.shape)}")
    if not (row_ptr.is_contiguous() and slot.is_contiguous()):
        raise ValueError("gather_spmm: adj_t must be contiguous")
    if row_ptr.device != adj.device or slot.device != adj.device:
        raise ValueError("gather_spmm: adj_t on another device than adj")


def _check_int32_rows(s: int, nf: int) -> None:
    if max(s, nf) > torch.iinfo(torch.int32).max:
        raise ValueError(f"gather_spmm: transpose of {nf} slots over {s} "
                         "rows exceeds int32")


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
             scale: Optional[torch.Tensor],
             read_as: Optional[torch.dtype] = None) -> torch.Tensor:
    if x.device.type == "cpu":
        return gather_spmm_reference(x, adj, w, scale, read_as)
    n, f = adj.shape
    s, d = x.shape
    out = torch.empty(n, d, dtype=torch.float32, device=x.device)
    ptrs = [x.data_ptr()] + ([] if scale is None else [scale.data_ptr()])
    form = _form(x, read_as)
    _launch(_ENTRY[form], f"gather_spmm[{form}]", x.device, *ptrs,
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
    _launch(_GRAD_W_ENTRY[x.dtype], _GRAD_W_COUNTER[x.dtype], x.device,
            x.data_ptr(), adj.data_ptr(), g.data_ptr(), gw.data_ptr(), s, n,
            f, d)
    return gw


def transpose_scratch(s: int, nf: int, device: torch.device) -> int:
    """int32 scratch words the card's transpose of ``nf`` slots over ``s``
    rows needs on ``device`` (the C side decides, by the shape and the
    device's capacity): 0 for the one-block form, which needs none; for the
    cooperative grid form count [s], the blocks' totals, the long-row list
    and placed [nf]."""
    lib = _library()
    with torch.cuda.device(device):
        words = lib.gather_spmm_transpose_scratch(s, nf)
    if words < 0:
        raise RuntimeError("gather_spmm_transpose_scratch: the card's limits "
                           "could not be read")
    return words


def adj_transpose(adj: torch.Tensor, s: int) -> Transpose:
    """The transpose of int32 ``adj`` [N, F] over ``s`` table rows (see
    ``Transpose``): the plain version on the CPU, on the card one launch
    (one block where ``transpose_scratch`` is 0, else the cooperative
    grid)."""
    if adj.dtype != torch.int32 or adj.dim() != 2 or not adj.is_contiguous():
        raise TypeError("adj_transpose: adj must be contiguous int32 [N, F]")
    _check_int32_rows(s, adj.numel())
    if adj.device.type == "cpu":
        return adj_transpose_reference(adj, s)
    nf = adj.numel()
    words = transpose_scratch(s, nf, adj.device)
    row_ptr = torch.empty(s + 1, dtype=torch.int32, device=adj.device)
    slot = torch.empty(nf, dtype=torch.int32, device=adj.device)
    scratch = (torch.empty(words, dtype=torch.int32, device=adj.device)
               if words else None)
    _launch("gather_spmm_adj_transpose", "adj_transpose", adj.device,
            adj.data_ptr(), row_ptr.data_ptr(), slot.data_ptr(),
            None if scratch is None else scratch.data_ptr(), s, nf)
    return row_ptr, slot


def gather_spmm_grad_x(adj: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                       s: int, adj_t: Optional[Transpose] = None
                       ) -> torch.Tensor:
    """grad_x [s, D] f32 for the upstream gradient g [N, D] f32
    (contiguous): the plain version on the CPU; on the card the gather over
    the transpose ``adj_t`` of adj (built here, one more launch, when not
    given), which writes every row once."""
    _check_grad(adj, g, w=w)
    if adj_t is not None:
        _check_transpose(adj_t, adj, s)
    if g.device.type == "cpu":
        return gather_spmm_grad_x_reference(adj, w, g, s)
    if adj_t is None:
        adj_t = adj_transpose(adj, s)
    f, d = adj.shape[1], g.shape[1]
    gx = torch.empty(s, d, dtype=torch.float32, device=g.device)
    _launch("gather_spmm_grad_x", "gather_spmm_grad_x", g.device,
            adj_t[0].data_ptr(), adj_t[1].data_ptr(), w.data_ptr(),
            g.data_ptr(), gx.data_ptr(), s, f, d)
    return gx


class _GatherSpmm(torch.autograd.Function):
    """The f32 / bf16 table forms with their backward kernels."""

    @staticmethod
    def forward(ctx, x, adj, w, adj_t):
        ctx.save_for_backward(x, adj, w)
        ctx.adj_t = adj_t
        return _forward(x, adj, w, None)

    @staticmethod
    def backward(ctx, g):
        x, adj, w = ctx.saved_tensors
        g = g.contiguous()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = gather_spmm_grad_x(adj, w, g, x.shape[0],
                                    ctx.adj_t).to(x.dtype)
        if ctx.needs_input_grad[2]:
            gw = gather_spmm_grad_w(x, adj, g)
        return gx, None, gw, None


def gather_spmm(x: torch.Tensor, adj: torch.Tensor, w: torch.Tensor,
                scale: Optional[torch.Tensor] = None,
                adj_t: Optional[Transpose] = None,
                read_as: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [S, D] f32|bf16|int8 (int8 with ``scale`` f32 [S]), adj int32
    [N, F] (entries in [0, S)), w f32 [N, F] (0 makes a slot a no-op in
    the forward) -> f32 [N, D]. Any D. ``adj_t``: the transpose of adj
    (``adj_transpose(adj, S)``) for the backward's grad_x, where the caller
    keeps one. ``read_as``: None (or float32) reads each element as
    stored, widened to f32; ``torch.bfloat16`` rounds each widened (int8:
    dequantised) element to bf16 first, the rows a bf16 model reads.

    CPU tensors: the plain versions. CUDA tensors: the kernels, on the
    current stream, without synchronising. On the kernel path a dst row
    whose slots hold an index outside [0, S) comes out NaN (the plain
    version raises instead). Differentiable in ``x`` and ``w`` for f32 and
    bf16 tables read as stored; the int8 forms and an f32 table read as
    bf16 are constant, and an input of theirs that requires grad is
    refused."""
    _check(x, adj, w, scale, read_as)
    if adj_t is not None:
        _check_transpose(adj_t, adj, x.shape[0])
    form = _form(x, read_as)
    if form in ("float32", "bfloat16"):
        return _GatherSpmm.apply(x, adj, w, adj_t)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, scale)):
        raise ValueError(f"gather_spmm: the {form} form reads a constant "
                         "table and has no backward (x, w and scale must "
                         "not require grad)")
    return _forward(x, adj, w, scale, read_as)


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
                 "gather_spmm_f32_as_bf16", *_GRAD_W_ENTRY.values()):
        getattr(lib, name).argtypes = [ptr] * 4 + sizes
    for name in ("gather_spmm_i8", "gather_spmm_i8_as_bf16"):
        getattr(lib, name).argtypes = [ptr] * 5 + sizes
    lib.gather_spmm_adj_transpose.argtypes = [ptr] * 4 + [i64, i64, ptr]
    lib.gather_spmm_transpose_scratch.argtypes = [i64, i64]
    lib.gather_spmm_transpose_scratch.restype = i64
    lib.gather_spmm_grad_x.argtypes = [ptr] * 5 + [i64, i32, i32, ptr]
    for name in (*_ENTRY.values(), *_GRAD_W_ENTRY.values(),
                 "gather_spmm_adj_transpose", "gather_spmm_grad_x"):
        getattr(lib, name).restype = ctypes.c_int
    lib.gather_spmm_error_string.argtypes = [ctypes.c_int]
    lib.gather_spmm_error_string.restype = ctypes.c_char_p
    return lib
