"""Times this checkout's gather-SpMM kernels against another checkout's on
one CUDA card, in one process, in turns: other, this, this, other.

    python3 chip_compare.py OTHER_CHECKOUT

Builds OTHER_CHECKOUT/coala_gnn_tpu_torch/csrc/gather_spmm.cu with this
checkout's nvcc flags (into this checkout's coala_gnn_tpu_torch/_build/)
beside this checkout's own (both nvcc runs at once), and times with
``chip_smoke.median_ms`` (L2 flushed, median of 25, after a warm-up) on
the same inputs:

  - the forward, f32, bf16 and int8 (+ row scales) tables at the training
    step's layer-0 shape, and f32 at GAT layer 1's combine (D = 16);
  - grad_x at GAT's two head-stacked combine shapes: a checkout whose
    library has ``gather_spmm_adj_transpose`` runs its gather over the
    transpose (built once beforehand, as the GAT layer keeps it); an older
    one zeroes the table and adds into it (its wrapper's fill included);
  - grad_w at GAT's two combine shapes (f32 table; layer 0 on a bf16 one
    too), at RGAT's stacked layer 0 on the host CLI's layout (3 relations,
    dead slots at their own dst row) and on the resident CLI's contiguous
    layout, and at IGB-hetero's stacked layer 0 (8 relations, the host
    layout), the stacked shapes on f32 and bf16 tables, each with its
    bound (bytes over 3.35 TB/s, ``chip_smoke.grad_w_work``) and share;
  - adj's transpose at the host-packed step's layer-1 shape, at GAT's
    two combine shapes, at RGAT's stacked layers 0 and 1 (the host CLI's
    step) and at GAT layer 0 on the host sampler's layout with its padded
    rows at row 0, each checkout allocating as its wrapper does (row_ptr,
    slot and, where its form needs it, scratch), and the device
    operations one call issues (``chip_smoke.device_ops``: the nodes of a
    CUDA graph that captures the call), counted after every timing.

Checks that both checkouts' forward outputs are equal bit for bit, their
grad_w within its f32 bound of the plain version (and reports whether the
two are equal bit for bit), their grad_x and transposes equal to the
plain versions (so to each other, bit for bit). Prints one line per entry
and a JSON line; needs one card, and exits with a non-zero code without
one.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

SOURCE = os.path.join("coala_gnn_tpu_torch", "csrc", "gather_spmm.cu")


def build(src: str) -> tuple:
    """Start building ``src`` with this checkout's nvcc flags unless built
    -> (library path, the build's process or None)."""
    from coala_gnn_tpu_torch.utils.build import BUILD_DIR, NVCC_FLAGS, find_nvcc

    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"libcompare_{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    return out, subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-o", out, src],
                                 stdout=subprocess.DEVNULL,
                                 stderr=subprocess.PIPE, text=True)


def load(path: str, proc) -> ctypes.CDLL:
    """Wait for ``build``'s process, then load and type the library."""
    if proc is not None and proc.wait():
        raise RuntimeError(f"nvcc failed for {path}: "
                           f"{proc.stderr.read()[-2000:]}")
    lib = ctypes.CDLL(path)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    sizes = [i64, i32, i32, i32, ptr]
    for name in ("gather_spmm_f32", "gather_spmm_bf16",
                 "gather_spmm_grad_w_f32", "gather_spmm_grad_w_bf16"):
        getattr(lib, name).argtypes = [ptr] * 4 + sizes
    lib.gather_spmm_i8.argtypes = [ptr] * 5 + sizes
    lib.transposed = hasattr(lib, "gather_spmm_adj_transpose")
    lib.gather_spmm_grad_x.argtypes = ([ptr] * 5 + [i64, i32, i32, ptr]
                                       if lib.transposed else [ptr] * 4 + sizes)
    if lib.transposed:
        lib.gather_spmm_adj_transpose.argtypes = [ptr] * 4 + [i64, i64, ptr]
    for name, args in (("gather_spmm_transpose_scratch", [i64, i64]),
                       ("gather_spmm_transpose_tiles", [i64])):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i64
    return lib


def form_of(lib, s: int, nf: int) -> str:
    """The transpose's form in ``lib`` for this shape: one-block where it
    takes no scratch, else above one block (this checkout's grid form)."""
    if lib.gather_spmm_transpose_scratch(s, nf) == 0:
        return "one-block"
    return "above one block"


def forward(torch, lib, x, scale, adj, w):
    """One forward launch through ``lib``'s C entry -> f32 [N, D]."""
    entry = {torch.float32: lib.gather_spmm_f32,
             torch.bfloat16: lib.gather_spmm_bf16,
             torch.int8: lib.gather_spmm_i8}[x.dtype]
    (s, d), (n, f) = x.shape, adj.shape
    out = torch.empty(n, d, device="cuda")
    ptrs = [x.data_ptr()] + ([] if scale is None else [scale.data_ptr()])
    err = entry(*ptrs, adj.data_ptr(), w.data_ptr(), out.data_ptr(), s, n, f,
                d, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"forward launch failed ({err})")
    return out


def grad_x(torch, lib, adj, adj_t, w, g, s):
    """grad_x [s, D] through ``lib``: over the transpose, or into a table
    zeroed here (the older checkout's wrapper)."""
    (n, f), d = adj.shape, g.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    if lib.transposed:
        gx = torch.empty(s, d, device="cuda")
        args = (adj_t[0].data_ptr(), adj_t[1].data_ptr(), w.data_ptr(),
                g.data_ptr(), gx.data_ptr(), s, f, d, stream)
    else:
        gx = torch.zeros(s, d, device="cuda")
        args = (adj.data_ptr(), w.data_ptr(), g.data_ptr(), gx.data_ptr(), s,
                n, f, d, stream)
    if lib.gather_spmm_grad_x(*args):
        raise RuntimeError("grad_x launch failed")
    return gx


def grad_w(torch, lib, x, adj, g):
    """grad_w [N, F] of an f32 or bf16 table through ``lib``."""
    (s, d), (n, f) = x.shape, adj.shape
    gw = torch.empty(n, f, device="cuda")
    entry = {torch.float32: lib.gather_spmm_grad_w_f32,
             torch.bfloat16: lib.gather_spmm_grad_w_bf16}[x.dtype]
    if entry(x.data_ptr(), adj.data_ptr(), g.data_ptr(), gw.data_ptr(), s, n,
             f, d, torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("grad_w launch failed")
    return gw


def transpose(torch, lib, adj, s):
    """adj's transpose (row_ptr, slot) through ``lib``, allocated as that
    checkout's wrapper does: a library that can say how much scratch a
    shape takes gets that much (none for the one-block form), an older
    one always s + nf + its scan tiles."""
    nf = adj.numel()
    if hasattr(lib, "gather_spmm_transpose_scratch"):
        words = lib.gather_spmm_transpose_scratch(s, nf)
        if words < 0:
            raise RuntimeError("gather_spmm_transpose_scratch failed")
    else:
        words = s + nf + lib.gather_spmm_transpose_tiles(s)
    row_ptr = torch.empty(s + 1, dtype=torch.int32, device="cuda")
    slot = torch.empty(nf, dtype=torch.int32, device="cuda")
    scratch = (torch.empty(words, dtype=torch.int32, device="cuda")
               if words else None)
    if lib.gather_spmm_adj_transpose(
            adj.data_ptr(), row_ptr.data_ptr(), slot.data_ptr(),
            None if scratch is None else scratch.data_ptr(), s, nf,
            torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("transpose launch failed")
    return row_ptr, slot


def bits(torch, t):
    """A float tensor's bit patterns (NaNs and signed zeros compared as
    bits)."""
    return t.view(torch.int32)


def turns(torch, median_ms, other, this) -> dict:
    """other, this, this, other -> the four medians and each side's mean."""
    t = [median_ms(torch, fn) for fn in (other, this, this, other)]
    return {"other_ms": [t[0], t[3]], "this_ms": [t[1], t[2]],
            "other": statistics.mean((t[0], t[3])),
            "this": statistics.mean((t[1], t[2]))}


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("chip_compare: needs a CUDA card and OTHER_CHECKOUT",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from coala_gnn_tpu_torch.models.layers import head_stacked_adj
    from coala_gnn_tpu_torch.ops.gather_spmm import (
        adj_transpose_reference, gather_spmm_grad_w_reference,
        gather_spmm_grad_x_reference, grad_w_error_bound)

    smi = cs.smi_string()
    built = {"other": build(os.path.join(sys.argv[1], SOURCE)),
             "this": build(SOURCE)}
    libs = {k: load(*v) for k, v in built.items()}
    cs.warm_up(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    layer0 = (cs.N_NODES + 1, 6 * cs.BATCH, cs.FANOUTS[0], cs.DIM)
    gat = cs.gat_combine_shapes()
    res = {}
    cases = [(f"forward[{str(dt).split('.')[-1]}] {layer0}", layer0, dt)
             for dt in (torch.float32, torch.bfloat16, torch.int8)]
    cases.append(("forward[float32] GAT layer 1 (%d, %d, %d, %d)"
                  % gat[1][:4], gat[1][:4], torch.float32))
    for name, shape, dt in cases:
        x, scale, adj, w = cs.kernel_inputs(torch, *shape, dt, gen)
        outs = [forward(torch, libs[k], x, scale, adj, w) for k in libs]
        cs.require(bool(torch.equal(*outs)), f"{name}: outputs differ")
        res[name] = turns(torch, cs.median_ms,
                          *(lambda lib=libs[k]: forward(torch, lib, x, scale,
                                                        adj, w)
                            for k in libs))
    for layer, (S, N, F, D, cap_src, cap_dst) in enumerate(gat):
        adj = head_stacked_adj(None, cap_src, (cap_dst, F), cs.HEADS, "cuda")
        _, w = cs.masked_slots(torch, S, N, F, gen)
        g = torch.randn(N, D, generator=gen, device="cuda")
        adj_t = adj_transpose_reference(adj, S)
        want = gather_spmm_grad_x_reference(adj, w, g, S)
        name = f"grad_x GAT layer {layer} ({S}, {N}, {F}, {D})"
        for k in libs:
            cs.require(bool(torch.equal(grad_x(torch, libs[k], adj, adj_t, w,
                                               g, S), want)),
                       f"{name}: {k} differs from the plain version")
        res[name] = turns(torch, cs.median_ms,
                          *(lambda lib=libs[k]: grad_x(torch, lib, adj, adj_t,
                                                       w, g, S)
                            for k in libs))
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for layer, (S, N, F, D, cap_src, cap_dst) in enumerate(gat):
        adj = head_stacked_adj(None, cap_src, (cap_dst, F), cs.HEADS, "cuda")
        for dt in (f32, bf16) if layer == 0 else (f32,):
            cases.append((f"GAT layer {layer}", adj, S, D, dt))
    _, _, F, D, cap_src, cap_dst = gat[0]
    contiguous = head_stacked_adj(None, cap_src, (cap_dst, F), cs.HEADS,
                                  "cuda", 3)
    for label, adj, S in (
            ("RGAT stacked layer 0, host layout",
             *cs.rgat_stacked_adj(torch, gen, 0)),
            ("RGAT stacked layer 0, contiguous layout", contiguous,
             3 * cap_src * cs.HEADS),
            ("IGB-hetero RGAT stacked layer 0 (8 relations), host layout",
             *cs.rgat_stacked_adj(torch, gen, 0, rels=8))):
        cases += [(label, adj, S, D, dt) for dt in (f32, bf16)]
    for label, adj, S, D, dt in cases:
        N, F = adj.shape
        x = torch.randn(S, D, generator=gen, device="cuda").to(dt)
        g = torch.randn(N, D, generator=gen, device="cuda")
        name = (f"grad_w[{str(dt).split('.')[-1]}] {label} ({S}, {N}, {F}, "
                f"{D})")
        outs = [grad_w(torch, libs[k], x, adj, g) for k in libs]
        bound = grad_w_error_bound(x, adj, g)
        want = gather_spmm_grad_w_reference(x, adj, g)
        for k, out in zip(libs, outs):
            cs.require(bool(((out - want).abs() <= bound).all()),
                       f"{name}: {k} outside the f32 bound of the plain "
                       "version")
        res[name] = turns(torch, cs.median_ms,
                          *(lambda lib=libs[k]: grad_w(torch, lib, x, adj, g)
                            for k in libs))
        res[name].update(cs.bound(*cs.grad_w_work(torch, x, adj, g)))
        res[name]["share"] = res[name]["bound_ms"] / res[name]["this"]
        res[name]["bitwise_equal"] = bool(torch.equal(
            *(bits(torch, o) for o in outs)))
        print(f"{name}: outputs bitwise equal between the checkouts: "
              f"{res[name]['bitwise_equal']}; other / this "
              f"{res[name]['other'] / res[name]['this']:.3f}x; bound "
              f"{res[name]['bound_ms']:.4f} ms, share of this "
              f"{res[name]['share']:.3f}")
        del x, g, outs, bound, want
    packed, s_packed = cs.host_packed_adj(torch, gen)
    counted = []
    shapes = [("adj_transpose host-packed layer 1", packed, s_packed),
              *((f"adj_transpose GAT layer {layer}",
                 head_stacked_adj(None, cap_src, (cap_dst, F), cs.HEADS,
                                  "cuda"), S)
                for layer, (S, N, F, D, cap_src, cap_dst) in enumerate(gat)),
              ("adj_transpose RGAT layer 0",
               *cs.rgat_stacked_adj(torch, gen, 0)),
              ("adj_transpose RGAT layer 1",
               *cs.rgat_stacked_adj(torch, gen, 1)),
              ("adj_transpose GAT layer 0 host layout, padded rows at row 0",
               *cs.gat_host_adj(torch, gen))]
    for name, adj, s in shapes:
        name += (f" (S {s}, N*F {adj.numel()}, other: "
                 f"{form_of(libs['other'], s, adj.numel())}, this: "
                 f"{form_of(libs['this'], s, adj.numel())})")
        want = adj_transpose_reference(adj, s)
        for k in libs:
            got = transpose(torch, libs[k], adj, s)
            cs.require(bool(torch.equal(got[0], want[0]) and
                            torch.equal(got[1], want[1])),
                       f"{name}: {k} differs from the plain version")
        res[name] = turns(torch, cs.median_ms,
                          *(lambda lib=libs[k]: transpose(torch, lib, adj, s)
                            for k in libs))
        counted.append((name, adj, s))
    for name, adj, s in counted:
        res[name]["device_ops"] = {
            k: len(cs.device_ops(torch, lambda lib=libs[k]: transpose(
                torch, lib, adj, s))) for k in libs}
    for name, r in res.items():
        print(f"{name}: other {r['other_ms'][0]:.4f} {r['other_ms'][1]:.4f}, "
              f"this {r['this_ms'][0]:.4f} {r['this_ms'][1]:.4f} ms "
              f"(median of 25 each, L2 flushed; {smi})"
              + (f"; device operations per call {r['device_ops']}"
                 if "device_ops" in r else ""))
    print(json.dumps({"card": smi, "entries": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
