"""What every model of the reference shares, plain: the layer loop, the
initial weights, the loss, Adam and the TF32 control; the reference
training step on the blocks of ``reference/sampler.py``.

A model is a module ``gnnbench/models/<model>.py``, found by the
configuration's ``model`` key (``registry.load_module``). It gives:

- ``param_shapes(cfg)``: {name: shape} under the names the port's modules
  give their parameters, a readout's leaves included, so that the
  benchmark can hand the same initial weights to both sides
  (``init_params``), in the order they are drawn; optionally its own
  ``init_params(cfg, seed, device)``;
- ``layer(p, prefix, h, block, precision) -> h``: layer ``prefix``
  (``layer_{l}.``) on the layer input ``h`` (its destinations' rows, then
  its slots', slot-major) and a ``Block``;
- ``readout(p, h)``: the logits from the last layer's output, with the
  parameters ``p`` (a classifier head's leaves among them);
- optionally ``activate(h)``: the activation between layers, on the
  layer's output flattened to [rows, features]; ReLU where it gives none;
- ``flags(cfg)``: its own flags of the program's CLI, beyond the shared
  ones that ``cell.program_flags`` builds;
- ``TRANSFORM_ROWS`` (``"dst"`` or ``"src"``): the nodes of a block its
  dense transforms run on, and ``step_flops(cfg, rows)``: the dense FLOPs
  of one training step, ``rows[l]`` the distinct such nodes of layer l.

Between layers: the activation, then dropout at the configuration's
``dropout`` rate drawn as ``torch.rand(h.shape) < 1 - rate`` from the
step's dropout stream, kept values divided by ``1 - rate``. The loss is
the mean softmax cross-entropy of the batch's seeds (the first ``batch``
rows of the last layer). Everything is float32 with TF32 off, unless a
``precision`` of ``"tf32"`` asks for the matmuls in TF32 (the control).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from gnnbench.graphgen import WEIGHTS, generator


class Block(NamedTuple):
    """One sampled layer as a model's layer takes it: ``mask`` f32
    [cap_dst, fanout] (1 on live slots); on a typed graph ``rel`` int32
    [cap_dst, fanout] (each slot's relation, 0 on dead slots); where the
    data types its nodes, ``ntype`` int32 [cap_dst] (each destination's
    node type, -1 on a padded one) and ``rel_dst`` int32 [R] (each
    relation's destination type). None where the data has no such key."""

    mask: torch.Tensor
    rel: Optional[torch.Tensor] = None
    ntype: Optional[torch.Tensor] = None
    rel_dst: Optional[torch.Tensor] = None


def dims(cfg: dict, widen: int = 1) -> List[tuple]:
    """[(d_in, d_out)] per layer, input-most first; a layer's input is the
    previous output times ``widen`` (GAT's flattened heads)."""
    out, d_in = [], int(cfg["feature_dim"])
    L = int(cfg["num_layers"])
    for layer in range(L):
        d_out = (int(cfg["num_classes"]) if layer == L - 1
                 else int(cfg["hidden_channels"]))
        out.append((d_in, d_out))
        d_in = d_out * widen
    return out


def init_params(model, cfg: dict, seed: int, device
                ) -> Dict[str, torch.Tensor]:
    """Initial weights of ``model``'s parameters from the seed: the module's
    own ``init_params`` where it gives one, else in two draws on the
    device, in the order of its ``param_shapes``: linear weights (names
    ending in ``weight``) normal with std sqrt(1 / fan_in), attention
    vectors (names holding ``attn``) uniform on +-sqrt(6 / (heads +
    d_out)), the rest (biases) zero."""
    own = getattr(model, "init_params", None)
    if own is not None:
        return own(cfg, seed, device)
    gen = generator(seed, WEIGHTS, device)
    shapes = model.param_shapes(cfg)
    n_normal = sum(math.prod(s) for k, s in shapes.items()
                   if k.endswith("weight"))
    n_uniform = sum(math.prod(s) for k, s in shapes.items()
                    if "attn" in k)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(max(n_uniform, 1), generator=gen, device=device)
    out, a, b = {}, 0, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        if name.endswith("weight"):
            out[name] = (normal[a:a + n].view(shape)
                         * math.sqrt(1.0 / shape[1])).clone()
            a += n
        elif "attn" in name:
            lim = math.sqrt(6.0 / (shape[0] + shape[1]))
            out[name] = ((uniform[b:b + n].view(shape) * 2 - 1) * lim).clone()
            b += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits (nearest, ties to even)."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """a @ b with the operands of the product and of both its gradients
    rounded to TF32 (the CPU's stand-in for the card's TF32 path)."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = _round_tf32(a), _round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round_tf32(g)
        return g @ b.T, a.T @ g


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in f32 (TF32 off), or with ``precision="tf32"`` in TF32:
    on a card its TF32 tensor-core path (under ``precision_mode``), on the
    CPU with the operands rounded to TF32."""
    if precision != "tf32" or a.is_cuda:
        return a @ b
    return _Tf32Matmul.apply(a, b)


@contextlib.contextmanager
def precision_mode(precision: str):
    """TF32 matmuls on the card while the control runs; f32 otherwise."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def planes(h: torch.Tensor, cap_dst: int, f: int) -> torch.Tensor:
    """[f, cap_dst, ...] slot rows of a layer input (slot-major)."""
    return h[cap_dst:cap_dst * (1 + f)].view(f, cap_dst, *h.shape[1:])


def forward(model, cfg: dict, p: dict, x0: torch.Tensor,
            blocks: Sequence[Block],
            dropout_gen: Optional[torch.Generator], batch: int,
            precision: str = "float32") -> torch.Tensor:
    """``model``'s logits [batch, classes] of the seeds (the first
    ``batch`` rows); ``dropout_gen`` None: no dropout (evaluation)."""
    rate = float(cfg["dropout"])
    activate = getattr(model, "activate", torch.relu)
    h, L = x0, len(blocks)
    for layer, block in enumerate(blocks):
        h = model.layer(p, f"layer_{layer}.", h, block, precision)
        if layer == L - 1:
            h = model.readout(p, h)
            break
        h = activate(h.reshape(h.shape[0], -1))
        if dropout_gen is not None and rate > 0:
            keep = torch.rand(h.shape, generator=dropout_gen,
                              device=h.device) < 1.0 - rate
            h = torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))
    return h[:batch]


def loss_fn(logits: torch.Tensor, y: torch.Tensor,
            rows: Optional[int] = None) -> torch.Tensor:
    """Mean softmax cross-entropy over the first ``rows`` seeds (all of
    them by default)."""
    if rows is not None:
        logits, y = logits[:rows], y[:rows]
    nll = torch.logsumexp(logits, 1) - logits.gather(1, y[:, None])[:, 0]
    return nll.mean()


class Adam:
    """Adam (Kingma and Ba, 2015) with bias correction, over a dict of
    parameters; ``m`` and ``v`` are the first and second moments."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            params[k] = params[k] - self.lr * (self.m[k] / c1) / (
                torch.sqrt(self.v[k] / c2) + self.eps)
