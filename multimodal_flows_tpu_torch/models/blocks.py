"""Shared network blocks (PyTorch port of `multimodal_flows_tpu/models/blocks.py`).

MLP (fc -> exact GELU -> proj -> dropout), LayerNorm with optional bias
and fp32 statistics, `Dropout` with an explicit generator, the sinusoidal
timestep embedding, the compact additive key mask and the additive pair
mask.  `init_weights` reproduces the JAX
initialisation: Linear and Embedding weights N(0, 0.02), biases zero,
LayerNorm scale 1 and bias 0.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


class Dropout(nn.Module):
    """Dropout whose mask comes from an explicit generator: active in
    train mode (`module.train()`), the identity in eval mode.  The keep
    mask is drawn from `dropout_generator` on the input's device (from
    torch's default generator while it is None) and the kept values are
    scaled by 1 / (1 - p).  `set_dropout_generator` sets the generator of
    every dropout site of a module."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.dropout_generator: Optional[torch.Generator] = None

    def forward(self, x: Tensor) -> Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.dropout_generator, dtype=x.dtype,
                          device=x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Give every dropout site of `module` (the `Dropout` layers and the
    attention-probability dropout of the attention modules) the generator
    its masks are drawn from; it must live on the module's device."""
    for m in module.modules():
        if hasattr(m, "dropout_generator"):
            m.dropout_generator = generator


class MLP(nn.Module):
    """fc -> exact GELU -> proj -> dropout (flax names `c_fc`, `c_proj`)."""

    def __init__(self, n_embd: int, n_inner: int, n_out: Optional[int] = None,
                 bias: bool = True, dropout: float = 0.0):
        super().__init__()
        self.c_fc = nn.Linear(n_embd, n_inner, bias=bias)
        self.c_proj = nn.Linear(n_inner, n_out if n_out is not None else n_embd, bias=bias)
        self.drop = Dropout(dropout)

    def forward(self, x: Tensor) -> Tensor:
        return self.drop(self.c_proj(F.gelu(self.c_fc(x))))


class LayerNorm(nn.Module):
    """LayerNorm over the last dim, eps 1e-5, optional bias, fp32 stats."""

    def __init__(self, n: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n)) if bias else None

    def forward(self, x: Tensor) -> Tensor:
        return F.layer_norm(x.to(torch.float32), self.weight.shape, self.weight,
                            self.bias, 1e-5).to(x.dtype)


@torch.no_grad()
def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """N(0, 0.02) Linear/Embedding weights, zero biases, unit LayerNorm
    scales, drawn from `generator` in module order."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
            if getattr(m, "bias", None) is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, LayerNorm):
            nn.init.ones_(m.weight)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def timestep_embedding(timesteps: Tensor, embedding_dim: int,
                       max_positions: int = 10000) -> Tensor:
    """Sinusoidal time embedding of any leading shape: (B,) -> (B, E),
    (B, T) -> (B, T, E).  Odd widths pad one zero column."""
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                   device=timesteps.device) * -emb)
    args = timesteps.to(torch.float32)[..., None] * freqs
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def time_token_embedding(time: Tensor, embedding_dim: int) -> Tensor:
    """Per-jet (B,) time -> (B, 1, E); per-token (B, T) time -> (B, T, E)."""
    emb = timestep_embedding(time, embedding_dim)
    return emb[:, None, :] if time.ndim == 1 else emb


def key_mask_bias(mask: Tensor, neg: float = -1e9) -> Tensor:
    """(B, D, 1) pad mask -> additive float32 key mask (B, D): 0 on real
    keys, `neg` on pad keys.  Rows of pad queries come out as garbage that
    every consumer masks."""
    return torch.where(mask[..., 0] > 0, 0.0, neg).to(torch.float32)


def pair_mask_bias(mask: Tensor, neg: float = -1e9) -> Tensor:
    """(B, D, 1) pad mask -> additive float32 pair bias (B, 1, D, D): 0 on
    real pairs, `neg` otherwise, so learned pairwise biases compose with
    hard masking.  A pad query row is `neg` (+ bias) throughout and
    softmaxes to finite attention; its output is masked downstream."""
    m = mask[..., 0] > 0
    pair = m[:, None, :, None] & m[:, None, None, :]
    return torch.where(pair, 0.0, neg).to(torch.float32)
