"""Plain reference of KinFormer with its Lund-plane pair bias
(`use_pairwise`), the encoder of the CFM system: fp32 `torch`, one jet a
row, no packing, no chunks, no cache.

The architecture of dfaroughy/Multimodal-flows
(`networks/ParticleTransformers.py:315-432`) as the port states it:
- the kinematics embedded by Linear -> exact GELU -> Linear, then a
  LayerNorm, plus the sinusoidal time embedding;
- the pair bias: the Lund observables (log kT, log dR) of every pair of
  the destandardized kinematics, each pair's two values normalised over
  the pair; Dense(2 -> E), exact GELU, LayerNorm (eps 1e-6),
  symmetrised as 0.5 (f(U) + f(U^T)); Dense(E -> E), GELU, Dense(E -> H);
  times the learned `lambda_u`, added to the scores of every block;
- pre-LN blocks with a qk-LayerNorm over the head size shared by the
  heads, the time embedding added after every block, `ln2` over the sum
  with the skip, and the Linear -> GELU -> Linear drift head.

Departures from the upstream code, each the port's too:
- the logarithms are eps-regularised: log(dR + 1e-8), and log kT's
  argument min(pt_i, pt_j) dR^2 / (pt_i pt_j + 1e-12), clamped at 0, plus
  1e-8 (upstream takes log(0) on the self-pairs and 0/0 on pad pairs,
  which turn the bias into NaN);
- the upstream symmetrises again after the second stage; that second
  symmetrisation is the identity on a symmetric input, so it is left out;
- pads: the upstream adds a (B, H, D, D) pad-pair mask of -1e9 to the
  bias; here a pad key is left out of the softmax, which gives the same
  probabilities;
- `lambda_u` is drawn from the seed (`draw_weights`): its published
  initial value 0 switches the mechanism off.

The pair MLP runs over every pair of a jet, pads included (masked as keys
afterwards), in blocks of jets of at most `PAIR_BUDGET` pairs so that it
fits.  Parameter names are the program's state-dict names, so one set of
weights drawn from the seed loads into both.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from bench_torch import weights
from bench_torch.counts import block_flops
from bench_torch.reference.common import (
    Ops, Spec, block_spec, gelu_exact, layer_norm, linear_spec, ln_spec, sinusoidal,
)

Tensor = torch.Tensor
#: pairs of one block of the pair MLP (a (pairs, E) fp32 hidden tensor is
#: 1 GiB at E = 256)
PAIR_BUDGET = 1 << 20
#: the rule of `lambda_u`: 1 + LAMBDA_SPREAD z, z the seed's normal for it
LAMBDA_SPREAD = 0.25


def param_spec(cfg: Dict) -> Spec:
    n, inner, H = cfg["n_embd"], cfg["n_inner"], cfg["n_head"]
    dc, bias = cfg["dim_continuous"], cfg.get("bias", True)
    spec = [("lambda_u", (), "embedding")]
    spec += linear_spec("wue_fc", 2, n) + ln_spec("wue_ln", n)
    spec += linear_spec("wue_proj_fc", n, n, bias) + linear_spec("wue_proj_out", n, H, bias)
    spec += linear_spec("wxe.fc", dc, n, bias) + linear_spec("wxe.proj", n, n, bias)
    spec += ln_spec("ln1", n)
    for i in range(cfg["n_layer"]):
        spec += block_spec(f"block_{i}", n, inner, cfg["qk_layernorm"], H)
    spec += ln_spec("ln2", n)
    return spec + linear_spec("head.fc", n, inner, bias) + linear_spec("head.proj", inner, dc, bias)


def draw_weights(cfg: Dict, seed: int, device: torch.device) -> Dict[str, Tensor]:
    """`weights.draw`, and `lambda_u` = 1 + LAMBDA_SPREAD z from its normal z."""
    p = weights.draw(param_spec(cfg), seed, device)
    p["lambda_u"] = 1.0 + LAMBDA_SPREAD * p["lambda_u"]
    return p


def dense_flops(cfg: Dict) -> int:
    """Dense FLOPs of one real particle (`bench_torch/counts.py`); the
    pair MLP is counted a pair (`pair_flops`)."""
    n, inner, dc = cfg["n_embd"], cfg["n_inner"], cfg["dim_continuous"]
    embed = 2 * (dc * n + n * n)
    head = 2 * (n * inner + inner * dc)
    return embed + cfg["n_layer"] * block_flops(n, inner) + head


def attention_layers(cfg: Dict) -> List[Tuple[int, int]]:
    """[(width, layers)] of the self-attention calls of one forward."""
    return [(cfg["n_embd"], cfg["n_layer"])]


def pair_flops(cfg: Dict) -> int:
    """FLOPs of the pair MLP for one real (query, key) pair: the first
    Dense once (f(U^T) is f(U) transposed), then E -> E and E -> H."""
    n = cfg["n_embd"]
    return 2 * (2 * n + n * n + n * cfg["n_head"])


def lund_logs(cfg: Dict, cont: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """(log kT, log dR), each (N, D, D), of every pair of the
    destandardized kinematics, pads zeroed."""
    meta = cfg.get("metadata") or {}
    dim = cont.shape[-1]
    mu = torch.tensor(meta.get("mean", [0.0] * dim), dtype=torch.float32, device=cont.device)
    sig = torch.tensor(meta.get("std", [1.0] * dim), dtype=torch.float32, device=cont.device)
    kin = (cont.float() * sig + mu) * mask[..., None]
    pt, eta, phi = kin[..., 0], kin[..., 1], kin[..., 2]
    deta = eta[:, :, None] - eta[:, None, :]
    dphi = torch.remainder(phi[:, :, None] - phi[:, None, :] + math.pi, 2 * math.pi) - math.pi
    dr = torch.sqrt(deta ** 2 + dphi ** 2)
    log_dr = torch.log(dr + 1e-8)
    pt_i, pt_j = pt[:, :, None], pt[:, None, :]
    kt = torch.minimum(pt_i, pt_j) * dr ** 2 / (pt_i * pt_j + 1e-12)
    log_kt = torch.log(torch.clamp(kt, min=0.0) + 1e-8)
    return log_kt, log_dr


def lund_observables(cfg: Dict, cont: Tensor, mask: Tensor) -> Tensor:
    """(N, D, D, 2): (log kT, log dR) of every pair, each pair normalised
    over its two values (population std).  Two values normalised so are
    +-(1, -1) by the sign of log kT - log dR, but within about 1e-8 of
    equality: the pair bias steps there."""
    u = torch.stack(lund_logs(cfg, cont, mask), dim=-1)
    mean = u.mean(dim=-1, keepdim=True)
    std = torch.sqrt(((u - mean) ** 2).mean(dim=-1, keepdim=True))
    return (u - mean) / (std + 1e-8)


def pair_mlp(ops: Ops, p: Dict[str, Tensor], u: Tensor) -> Tensor:
    """(N, D, D, H) of the pair MLP on the observables `u` (N, D, D, 2),
    symmetrised after its first stage."""
    def stage1(v):
        h = gelu_exact(ops.linear(v, p["wue_fc.weight"], p["wue_fc.bias"]))
        return layer_norm(h, p["wue_ln.weight"], p["wue_ln.bias"], eps=1e-6)

    h = 0.5 * (stage1(u) + stage1(u.transpose(1, 2)))
    h = gelu_exact(ops.linear(h, p["wue_proj_fc.weight"], p.get("wue_proj_fc.bias")))
    return ops.linear(h, p["wue_proj_out.weight"], p.get("wue_proj_out.bias"))


def lund_bias(ops: Ops, p: Dict[str, Tensor], cfg: Dict, cont: Tensor, mask: Tensor) -> Tensor:
    """lambda_u * pair-MLP(Lund observables), (N, H, D, D), in blocks of
    jets of at most PAIR_BUDGET pairs."""
    N, D = cont.shape[0], cont.shape[1]
    per = max(1, PAIR_BUDGET // (D * D))
    out = [pair_mlp(ops, p, lund_observables(cfg, cont[a:a + per], mask[a:a + per]))
           for a in range(0, N, per)]
    return p["lambda_u"] * torch.cat(out).permute(0, 3, 1, 2)


def attention(ops: Ops, q: Tensor, k: Tensor, v: Tensor, n_head: int, bias: Tensor,
              allowed: Tensor) -> Tensor:
    """softmax(q k^T / sqrt(hs) + bias) v over `n_head` heads, token-major
    q/k/v (N, T, C), bias (N, H, T, T), `allowed` (N, T, T) the keys a
    query sees."""
    N, T, C = q.shape
    hs = C // n_head

    def heads(t):
        return t.reshape(N, T, n_head, hs).transpose(1, 2)

    s = ops.matmul(heads(q), heads(k).transpose(-1, -2)) / math.sqrt(hs) + bias
    s = s.masked_fill(~allowed[:, None], float("-inf"))
    return ops.matmul(torch.softmax(s, dim=-1), heads(v)).transpose(1, 2).reshape(N, T, C)


def block(ops: Ops, p: Dict[str, Tensor], name: str, x: Tensor, cfg: Dict, bias: Tensor,
          allowed: Tensor) -> Tensor:
    """Pre-LN residual block with the pair bias in its attention."""
    H = cfg["n_head"]
    h = layer_norm(x, p[f"{name}.ln1.weight"], p[f"{name}.ln1.bias"])
    q, k, v = ops.linear(h, p[f"{name}.attn.c_attn.weight"],
                         p.get(f"{name}.attn.c_attn.bias")).chunk(3, dim=-1)
    if cfg["qk_layernorm"]:
        N, T, C = q.shape
        q = layer_norm(q.reshape(N, T, H, C // H), p[f"{name}.attn.q_layernorm.weight"],
                       p[f"{name}.attn.q_layernorm.bias"]).reshape(N, T, C)
        k = layer_norm(k.reshape(N, T, H, C // H), p[f"{name}.attn.k_layernorm.weight"],
                       p[f"{name}.attn.k_layernorm.bias"]).reshape(N, T, C)
    y = attention(ops, q, k, v, H, bias, allowed)
    x = x + ops.linear(y, p[f"{name}.attn.c_proj.weight"], p.get(f"{name}.attn.c_proj.bias"))
    h = layer_norm(x, p[f"{name}.ln2.weight"], p[f"{name}.ln2.bias"])
    h = gelu_exact(ops.linear(h, p[f"{name}.ffw.c_fc.weight"], p.get(f"{name}.ffw.c_fc.bias")))
    return x + ops.linear(h, p[f"{name}.ffw.c_proj.weight"], p.get(f"{name}.ffw.c_proj.bias"))


def forward(ops: Ops, p: Dict[str, Tensor], cfg: Dict, cont: Tensor, mask: Tensor,
            time: Tensor) -> Tensor:
    """Drift (N, D, Fc) of N jets, one a row: `cont` (N, D, Fc)
    standardized kinematics, `mask` (N, D) bool (real particles), `time`
    (N,) per jet."""
    n = cfg["n_embd"]
    allowed = mask[:, None, :] & torch.ones_like(mask)[:, :, None]     # keys: real particles
    bias = (lund_bias(ops, p, cfg, cont, mask) if cfg.get("use_pairwise")
            else torch.zeros((), device=cont.device))
    temb = sinusoidal(time, n)[:, None, :]
    h = gelu_exact(ops.linear(cont, p["wxe.fc.weight"], p.get("wxe.fc.bias")))
    x = layer_norm(ops.linear(h, p["wxe.proj.weight"], p.get("wxe.proj.bias")),
                   p["ln1.weight"], p["ln1.bias"])
    h = x + temb
    skip = h
    for i in range(cfg["n_layer"]):
        h = block(ops, p, f"block_{i}", h, cfg, bias, allowed) + temb
    h = layer_norm(h + skip, p["ln2.weight"], p["ln2.bias"])
    h = gelu_exact(ops.linear(h, p["head.fc.weight"], p.get("head.fc.bias")))
    return ops.linear(h, p["head.proj.weight"], p.get("head.proj.bias"))


def euler(ops: Ops, p: Dict[str, Tensor], cfg: Dict, x: Tensor, mask: Tensor,
          steps: int) -> Tensor:
    """The CFM system's Euler sampler from the source `x`: times
    linspace(eps, 1 - eps, steps) in fp32, dt = (t_last - t_first) /
    (steps - 1), x <- x + v dt."""
    eps = cfg["time_eps"]
    ts = torch.linspace(eps, 1.0 - eps, steps, dtype=torch.float32, device=x.device)
    dt = (ts[-1] - ts[0]) / (steps - 1)
    with torch.no_grad():
        for i in range(steps):
            x = x + forward(ops, p, cfg, x, mask, ts[i].expand(len(x))) * dt
    return x
