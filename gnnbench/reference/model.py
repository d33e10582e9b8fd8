"""GraphSAGE (mean) and GAT, their loss and Adam, plain: the reference
training step on the blocks of ``reference/sampler.py``.

Parameters are a dict of named tensors, under the names the port's modules
give them, so that the benchmark can hand the same initial weights to both
sides (``init_params``):

- SAGE layer l: ``layer_{l}.fc_self.weight`` [d_out, d_in],
  ``layer_{l}.fc_self.bias`` [d_out], ``layer_{l}.fc_neigh.weight``;
  ``fc_self(h_dst) + fc_neigh(mean of the live slots' rows)`` (Hamilton et
  al., 2017, the mean aggregator);
- GAT layer l: ``layer_{l}.fc.weight`` [heads * d_out, d_in] (no bias),
  ``layer_{l}.attn_l``, ``layer_{l}.attn_r`` [heads, d_out]; per head,
  ``e = leaky_relu(<feat_src, attn_l> + <feat_dst, attn_r>, 0.2)`` over a
  destination's live slots, softmax over them, the slots' features summed
  with those weights (Velickovic et al., 2018), no self edge; heads
  flattened between layers and averaged at the output.

Between layers: ReLU, then dropout 0.5 drawn as ``torch.rand(h.shape) <
0.5`` from the step's dropout stream, kept values doubled. The loss is the
mean softmax cross-entropy of the batch's seeds (the first ``batch`` rows
of the last layer). Everything is float32 with TF32 off, unless a
``precision`` of ``"tf32"`` asks for the matmuls in TF32 (the control).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch

from gnnbench.graphgen import WEIGHTS, generator


def dims(cfg: dict) -> List[tuple]:
    """[(d_in, d_out per head)] per layer, input-most first."""
    heads = int(cfg.get("num_heads", 1)) if cfg["model"] == "gat" else 1
    out, d_in = [], int(cfg["feature_dim"])
    L = int(cfg["num_layers"])
    for layer in range(L):
        d_out = (int(cfg["num_classes"]) if layer == L - 1
                 else int(cfg["hidden_channels"]))
        out.append((d_in, d_out))
        d_in = d_out * heads
    return out


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    shapes = {}
    heads = int(cfg.get("num_heads", 1))
    for layer, (d_in, d_out) in enumerate(dims(cfg)):
        p = f"layer_{layer}."
        if cfg["model"] == "gat":
            shapes[p + "fc.weight"] = (heads * d_out, d_in)
            shapes[p + "attn_l"] = (heads, d_out)
            shapes[p + "attn_r"] = (heads, d_out)
        else:
            shapes[p + "fc_self.weight"] = (d_out, d_in)
            shapes[p + "fc_self.bias"] = (d_out,)
            shapes[p + "fc_neigh.weight"] = (d_out, d_in)
    return shapes


def init_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Initial weights from the seed, in two draws on the device: linear
    weights normal with std sqrt(1 / fan_in), attention vectors uniform on
    +-sqrt(6 / (heads + d_out)), biases zero."""
    gen = generator(seed, WEIGHTS, device)
    shapes = param_shapes(cfg)
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


def _planes(h: torch.Tensor, cap_dst: int, f: int) -> torch.Tensor:
    """[f, cap_dst, ...] slot rows of a layer input (slot-major)."""
    return h[cap_dst:cap_dst * (1 + f)].view(f, cap_dst, *h.shape[1:])


def sage_layer(p: dict, pre: str, h: torch.Tensor, mask: torch.Tensor,
               precision: str) -> torch.Tensor:
    cap_dst, f = mask.shape
    nbr = _planes(h, cap_dst, f)
    s = (nbr * mask.T[:, :, None]).sum(0)
    mean = s / mask.sum(1).clamp(min=1.0)[:, None]
    return (matmul(h[:cap_dst], p[pre + "fc_self.weight"].T, precision)
            + p[pre + "fc_self.bias"]
            + matmul(mean, p[pre + "fc_neigh.weight"].T, precision))


def gat_layer(p: dict, pre: str, h: torch.Tensor, mask: torch.Tensor,
              precision: str) -> torch.Tensor:
    cap_dst, f = mask.shape
    heads, d_out = p[pre + "attn_l"].shape
    feat = matmul(h, p[pre + "fc.weight"].T, precision).view(
        h.shape[0], heads, d_out)
    el = (feat * p[pre + "attn_l"]).sum(-1)
    er = (feat[:cap_dst] * p[pre + "attn_r"]).sum(-1)
    e = torch.nn.functional.leaky_relu(
        _planes(el, cap_dst, f).permute(1, 0, 2) + er[:, None, :], 0.2)
    m = mask[:, :, None]
    e = torch.where(m > 0, e, torch.full_like(e, -1e9))
    alpha = torch.softmax(e, dim=1) * m                 # [cap_dst, f, H]
    nbr = _planes(feat, cap_dst, f)                     # [f, cap_dst, H, F]
    return (alpha.permute(1, 0, 2)[..., None] * nbr).sum(0)


def forward(cfg: dict, p: dict, x0: torch.Tensor,
            masks: Sequence[torch.Tensor],
            dropout_gen: Optional[torch.Generator], batch: int,
            precision: str = "float32") -> torch.Tensor:
    """Logits [batch, classes] of the seeds (the first ``batch`` rows);
    ``dropout_gen`` None: no dropout (evaluation)."""
    gat = cfg["model"] == "gat"
    layer_fn = gat_layer if gat else sage_layer
    rate = float(cfg["dropout"])
    h, L = x0, len(masks)
    for layer, mask in enumerate(masks):
        h = layer_fn(p, f"layer_{layer}.", h, mask, precision)
        if layer == L - 1:
            h = h.mean(1) if gat else h
            break
        h = torch.relu(h.reshape(h.shape[0], -1))
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
