"""Plain reference of ParticleFormer, the flagship MMF's encoder, with the
time-weighted multitask loss head of the MMF system.

The architecture of dfaroughy/Multimodal-flows as the port states it: two
half-width stacks (kinematics x, flavor tokens y) of pre-LN blocks with a
qk-LayerNorm over the head size shared by the heads, the sinusoidal time
embedding added after every block, then full-width fused blocks on their
concatenation with the time embedding projected to the full width, split
back with skip connections into a drift head (x) and a logit head (y).
One jet a row, its pads masked out as keys: the program's packed rows
attend within a jet only, so the two compute the same function of each
jet.  Parameter names are the program's state-dict names, so one set of
weights drawn from the seed loads into both.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench_torch import weights
from bench_torch.counts import block_flops
from bench_torch.reference.common import (
    Ops, Spec, block, block_spec, gelu_exact, layer_norm, linear_spec, ln_spec, sinusoidal,
)

Tensor = torch.Tensor


def param_spec(cfg: Dict) -> Spec:
    n, half, inner = cfg["n_embd"], cfg["n_embd"] // 2, cfg["n_inner"]
    dc, V, H = cfg["dim_continuous"], cfg["vocab_size"], cfg["n_head"]
    e = "encoder"
    spec = (linear_spec(f"{e}.wxe.fc", dc, n) + linear_spec(f"{e}.wxe.proj", n, half)
            + ln_spec(f"{e}.ln1_x", half)
            + [(f"{e}.wye.embed.weight", (V, n), "embedding")]
            + linear_spec(f"{e}.wye.proj", n, half) + ln_spec(f"{e}.ln1_y", half))
    for s in ("x", "y"):
        for i in range(cfg["n_layer"]):
            spec += block_spec(f"{e}.block_{s}_{i}", half, inner, True, H)
    spec += ln_spec(f"{e}.ln2_x", half) + ln_spec(f"{e}.ln2_y", half)
    spec += linear_spec(f"{e}.time_expand", half, n)
    for i in range(cfg["n_layer_fused"]):
        spec += block_spec(f"{e}.block_fuse_{i}", n, inner, True, H)
    spec += ln_spec(f"{e}.ln3_x", half) + ln_spec(f"{e}.ln3_y", half)
    spec += linear_spec(f"{e}.head_x.fc", half, inner) + linear_spec(f"{e}.head_x.proj", inner, dc)
    spec += linear_spec(f"{e}.head_y.fc", half, inner) + linear_spec(f"{e}.head_y.proj", inner, V)
    spec += linear_spec("multitask.c_fc", n, n) + linear_spec("multitask.c_proj", n, 2)
    return spec


def draw_weights(cfg: Dict, seed: int, device: torch.device) -> Dict[str, Tensor]:
    return weights.draw(param_spec(cfg), seed, device)


def dense_flops(cfg: Dict) -> int:
    """Dense FLOPs of one real particle (`bench_torch/counts.py`)."""
    n, half, inner = cfg["n_embd"], cfg["n_embd"] // 2, cfg["n_inner"]
    dc, v = cfg["dim_continuous"], cfg["vocab_size"]
    embed = 2 * (dc * n + n * half) + 2 * n * half      # wxe (fc, proj), wye (proj)
    stacks = 2 * cfg["n_layer"] * block_flops(half, inner)
    fused = cfg["n_layer_fused"] * block_flops(n, inner)
    heads = 2 * (half * inner + inner * dc) + 2 * (half * inner + inner * v)
    return embed + stacks + fused + heads


def attention_layers(cfg: Dict) -> List[Tuple[int, int]]:
    """[(width, layers)] of the self-attention calls of one forward."""
    return [(cfg["n_embd"] // 2, 2 * cfg["n_layer"]), (cfg["n_embd"], cfg["n_layer_fused"])]


def _ln(p, name, x):
    return layer_norm(x, p[f"{name}.weight"], p[f"{name}.bias"])


def forward(ops: Ops, p: Dict[str, Tensor], cfg: Dict, cont: Tensor, tokens: Tensor,
            mask: Tensor, time: Tensor) -> Tuple[Tensor, Tensor]:
    """(drift (N, D, Fc), logits (N, D, V)) of N jets, one a row: `cont`
    (N, D, Fc), `tokens` (N, D) int, `mask` (N, D) bool (real particles),
    `time` (N,) per jet."""
    e, H = "encoder", cfg["n_head"]
    half = cfg["n_embd"] // 2
    allowed = (mask[:, None, :] & torch.ones_like(mask)[:, :, None])   # keys: real particles
    temb = sinusoidal(time, half)[:, None, :]                           # (N, 1, half)

    h = gelu_exact(ops.linear(cont, p[f"{e}.wxe.fc.weight"], p[f"{e}.wxe.fc.bias"]))
    x = _ln(p, f"{e}.ln1_x", ops.linear(h, p[f"{e}.wxe.proj.weight"], p[f"{e}.wxe.proj.bias"]))
    x = x + temb
    x_skip = x
    for i in range(cfg["n_layer"]):
        x = block(ops, p, f"{e}.block_x_{i}", x, H, allowed, True, gelu_exact) + temb
    x = _ln(p, f"{e}.ln2_x", x + x_skip)

    h = gelu_exact(p[f"{e}.wye.embed.weight"][tokens.long()])
    y = _ln(p, f"{e}.ln1_y", ops.linear(h, p[f"{e}.wye.proj.weight"], p[f"{e}.wye.proj.bias"]))
    y = y + temb
    y_skip = y
    for i in range(cfg["n_layer"]):
        y = block(ops, p, f"{e}.block_y_{i}", y, H, allowed, True, gelu_exact) + temb
    y = _ln(p, f"{e}.ln2_y", y + y_skip)

    temb2 = ops.linear(temb, p[f"{e}.time_expand.weight"], p[f"{e}.time_expand.bias"])
    z = torch.cat([x, y], dim=-1) + temb2
    for i in range(cfg["n_layer_fused"]):
        z = block(ops, p, f"{e}.block_fuse_{i}", z, H, allowed, True, gelu_exact) + temb2
    x, y = z.split(half, dim=-1)
    x = _ln(p, f"{e}.ln3_x", x + x_skip)
    y = _ln(p, f"{e}.ln3_y", y + y_skip)

    def head(name, t):
        t = gelu_exact(ops.linear(t, p[f"{name}.fc.weight"], p[f"{name}.fc.bias"]))
        return ops.linear(t, p[f"{name}.proj.weight"], p[f"{name}.proj.bias"])

    return head(f"{e}.head_x", x), head(f"{e}.head_y", y)


def multitask_loss(ops: Ops, p: Dict[str, Tensor], cfg: Dict, loss_mse: Tensor,
                   loss_ce: Tensor, time: Tensor) -> Tensor:
    """Per-jet time-weighted combination: u = MLP(sinusoidal(t)), w = e^-u,
    0.5 (u1 + w1 mse) + 0.5 (u2 + w2 ce)."""
    h = gelu_exact(ops.linear(sinusoidal(time, cfg["n_embd"]), p["multitask.c_fc.weight"],
                              p["multitask.c_fc.bias"]))
    u = ops.linear(h, p["multitask.c_proj.weight"], p["multitask.c_proj.bias"])
    u1, u2 = u[:, 0], u[:, 1]
    return 0.5 * (u1 + torch.exp(-u1) * loss_mse) + 0.5 * (u2 + torch.exp(-u2) * loss_ce)
