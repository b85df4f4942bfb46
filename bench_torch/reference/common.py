"""Plain PyTorch building blocks of the references, in float32.

Nothing here imports the program or JAX.  `Ops(lowp=True)` is the control
of the correctness check: every matrix product's operands rounded to TF32
(10 mantissa bits, round to nearest) before an fp32 product, the nearest
precision below the fp32-with-TF32-off that the configurations state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

Tensor = torch.Tensor
Spec = List[Tuple[str, Tuple[int, ...], str]]


def tf32_round(x: Tensor) -> Tensor:
    """`x` (fp32) rounded to the nearest TF32 value (low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """a @ b with every product's operands rounded to TF32, the backward's
    products too (as TF32 tensor cores would compute both).  `b` is 2-D, or
    has `a`'s batch dimensions."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ra, rb, rg = tf32_round(a), tf32_round(b), tf32_round(g)
        ga = rg @ rb.transpose(-1, -2)
        if b.dim() == 2:
            gb = ra.reshape(-1, a.shape[-1]).t() @ rg.reshape(-1, g.shape[-1])
        else:
            gb = ra.transpose(-1, -2) @ rg
        return ga, gb


class Ops:
    """The matrix products of a reference: fp32, or with `lowp` at TF32."""

    def __init__(self, lowp: bool = False):
        self.lowp = lowp

    def linear(self, x: Tensor, w: Tensor, b: Optional[Tensor] = None) -> Tensor:
        y = self.matmul(x, w.t())
        return y if b is None else y + b

    def matmul(self, a: Tensor, b: Tensor) -> Tensor:
        return _Tf32Matmul.apply(a, b) if self.lowp else a @ b


def layer_norm(x: Tensor, w: Tensor, b: Tensor, eps: float = 1e-5) -> Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def attention(ops: Ops, q: Tensor, k: Tensor, v: Tensor, n_head: int,
              allowed: Tensor) -> Tensor:
    """Softmax attention of token-major q (N, Tq, C), k/v (N, Tk, C) over
    `n_head` heads; `allowed` (N, Tq, Tk) bool marks the keys a query sees."""
    N, Tq, C = q.shape
    Tk, hs = k.shape[1], C // n_head

    def heads(t):
        return t.reshape(N, t.shape[1], n_head, hs).transpose(1, 2)

    s = ops.matmul(heads(q), heads(k).transpose(-1, -2)) / math.sqrt(hs)
    s = s.masked_fill(~allowed[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return ops.matmul(p, heads(v)).transpose(1, 2).reshape(N, Tq, C)


def gelu_exact(x: Tensor) -> Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gelu_tanh(x: Tensor) -> Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def sinusoidal(t: Tensor, dim: int, max_positions: float = 10000.0) -> Tensor:
    """[sin(t f_i), cos(t f_i)], f_i = max_positions^(-i / (dim/2 - 1))."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(max_positions) / (half - 1)))
    args = t.to(torch.float32)[..., None] * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def linear_spec(name: str, n_in: int, n_out: int, bias: bool = True) -> Spec:
    spec = [(f"{name}.weight", (n_out, n_in), "matrix")]
    return spec + ([(f"{name}.bias", (n_out,), "bias")] if bias else [])


def ln_spec(name: str, n: int) -> Spec:
    return [(f"{name}.weight", (n,), "ln_weight"), (f"{name}.bias", (n,), "bias")]


def block_spec(name: str, width: int, inner: int, qk_layernorm: bool, n_head: int) -> Spec:
    spec = ln_spec(f"{name}.ln1", width) + linear_spec(f"{name}.attn.c_attn", width, 3 * width)
    if qk_layernorm:
        hs = width // n_head
        spec += ln_spec(f"{name}.attn.q_layernorm", hs) + ln_spec(f"{name}.attn.k_layernorm", hs)
    return (spec + linear_spec(f"{name}.attn.c_proj", width, width) + ln_spec(f"{name}.ln2", width)
            + linear_spec(f"{name}.ffw.c_fc", width, inner)
            + linear_spec(f"{name}.ffw.c_proj", inner, width))


def block(ops: Ops, p: Dict[str, Tensor], name: str, x: Tensor, n_head: int,
          allowed: Tensor, qk_layernorm: bool, act) -> Tensor:
    """Pre-LN residual block: x + Attn(LN(x)); x + MLP(LN(x))."""
    h = layer_norm(x, p[f"{name}.ln1.weight"], p[f"{name}.ln1.bias"])
    q, k, v = ops.linear(h, p[f"{name}.attn.c_attn.weight"],
                         p[f"{name}.attn.c_attn.bias"]).chunk(3, dim=-1)
    if qk_layernorm:
        N, T, C = q.shape
        hs = C // n_head
        q = layer_norm(q.reshape(N, T, n_head, hs), p[f"{name}.attn.q_layernorm.weight"],
                       p[f"{name}.attn.q_layernorm.bias"]).reshape(N, T, C)
        k = layer_norm(k.reshape(N, T, n_head, hs), p[f"{name}.attn.k_layernorm.weight"],
                       p[f"{name}.attn.k_layernorm.bias"]).reshape(N, T, C)
    y = attention(ops, q, k, v, n_head, allowed)
    x = x + ops.linear(y, p[f"{name}.attn.c_proj.weight"], p[f"{name}.attn.c_proj.bias"])
    h = layer_norm(x, p[f"{name}.ln2.weight"], p[f"{name}.ln2.bias"])
    h = act(ops.linear(h, p[f"{name}.ffw.c_fc.weight"], p[f"{name}.ffw.c_fc.bias"]))
    return x + ops.linear(h, p[f"{name}.ffw.c_proj.weight"], p[f"{name}.ffw.c_proj.bias"])


def adam_steps(params: Dict[str, Tensor], grads: Dict[str, Tensor], state: Dict,
               lr: float, clip: float, betas=(0.9, 0.999), eps: float = 1e-8) -> Dict[str, Tensor]:
    """One update of `params` (in place): clip the gradients by their global
    L2 norm (scaled by clip / norm only when the norm exceeds clip), then
    Adam with bias correction, eps outside the square root.  Returns the
    clipped gradients."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
    scale = torch.clamp(clip / norm, max=1.0)
    state["t"] = state.get("t", 0) + 1
    t = state["t"]
    clipped = {}
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name] * scale
            clipped[name] = g
            m = state.setdefault(("m", name), torch.zeros_like(p))
            v = state.setdefault(("v", name), torch.zeros_like(p))
            m.mul_(betas[0]).add_(g, alpha=1 - betas[0])
            v.mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
            m_hat = m / (1 - betas[0] ** t)
            v_hat = v / (1 - betas[1] ** t)
            p.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
    return clipped
