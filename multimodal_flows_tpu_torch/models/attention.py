"""Self and cross attention over padded or packed particle sets (PyTorch
port of `multimodal_flows_tpu/models/attention.py`).

Pre-LN residual blocks around fused-QKV multi-head attention with a
qk-LayerNorm over the head size, applied in token layout (B, T, H, hs)
with its parameters shared across heads.  Masking and learned pairwise
terms enter as an additive key mask (B, T), an additive bias
broadcastable to (B, H|1, T, T) and (B, T) segment ids.  Self attention
goes through `ops.attention.multihead_attention_btc` (on CUDA: K2 with a
bias, K1 without); `CrossAttention` goes head-major through
`ops.attention.multihead_attention` (K2 on CUDA).

Dropout follows `module.train()` / `module.eval()`: in train mode with
`dropout > 0` the attention probabilities are dropped (the call then takes
the plain attention on every device, as the JAX package sends it to XLA and
never to a Pallas kernel) and the projected output goes through a residual
`Dropout`; in eval mode, and at `dropout == 0`, nothing changes and the
kernels run.  The masks come from `dropout_generator`
(`models.blocks.set_dropout_generator`).  The KV-cache decode branch is
not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodal_flows_tpu_torch.models.blocks import MLP, Dropout, LayerNorm
from multimodal_flows_tpu_torch.ops.attention import (
    multihead_attention,
    multihead_attention_btc,
)

Tensor = torch.Tensor


class SelfAttention(nn.Module):
    """Fused-QKV multi-head self attention with qk-LayerNorm.  `dropout`
    is both the probability dropout of the attention and the residual
    dropout after `c_proj`."""

    def __init__(self, n_embd: int, n_head: int, bias: bool = True,
                 qk_layernorm: bool = True, dropout: float = 0.0):
        super().__init__()
        if n_embd % n_head:
            raise ValueError(f"n_embd={n_embd} is not a multiple of n_head={n_head}")
        self.n_embd, self.n_head = n_embd, n_head
        hs = n_embd // n_head
        self.c_attn = nn.Linear(n_embd, 3 * n_embd, bias=bias)
        self.q_layernorm = LayerNorm(hs, bias) if qk_layernorm else None
        self.k_layernorm = LayerNorm(hs, bias) if qk_layernorm else None
        self.c_proj = nn.Linear(n_embd, n_embd, bias=bias)
        self.dropout = float(dropout)
        self.dropout_generator: Optional[torch.Generator] = None
        self.resid_drop = Dropout(dropout)

    def forward(self, x: Tensor, attn_bias: Optional[Tensor] = None,
                key_mask: Optional[Tensor] = None,
                segments: Optional[Tensor] = None) -> Tensor:
        B, T, C = x.shape
        H, hs = self.n_head, C // self.n_head
        q, k, v = self.c_attn(x).split(self.n_embd, dim=-1)
        if self.q_layernorm is not None:
            q = self.q_layernorm(q.reshape(B, T, H, hs)).reshape(B, T, C)
            k = self.k_layernorm(k.reshape(B, T, H, hs)).reshape(B, T, C)
        y = multihead_attention_btc(q.contiguous(), k.contiguous(), v.contiguous(), H,
                                    attn_bias, key_mask,
                                    dropout_rate=self.dropout if self.training else 0.0,
                                    generator=self.dropout_generator, segments=segments)
        return self.resid_drop(self.c_proj(y))


class CrossAttention(nn.Module):
    """Query from x, keys and values from z, in head layout
    (B, H, T, hs), with qk-LayerNorm there.  `dropout` is the residual
    dropout after `c_proj`; the probabilities are not dropped, as in the
    JAX package."""

    def __init__(self, n_embd: int, n_head: int, bias: bool = True,
                 qk_layernorm: bool = True, dropout: float = 0.0):
        super().__init__()
        if n_embd % n_head:
            raise ValueError(f"n_embd={n_embd} is not a multiple of n_head={n_head}")
        self.n_embd, self.n_head = n_embd, n_head
        hs = n_embd // n_head
        self.c_query = nn.Linear(n_embd, n_embd, bias=bias)
        self.c_attn = nn.Linear(n_embd, 2 * n_embd, bias=bias)
        self.q_layernorm = LayerNorm(hs, bias) if qk_layernorm else None
        self.k_layernorm = LayerNorm(hs, bias) if qk_layernorm else None
        self.c_proj = nn.Linear(n_embd, n_embd, bias=bias)
        self.resid_drop = Dropout(dropout)

    def forward(self, x: Tensor, z: Tensor, attn_bias: Optional[Tensor] = None) -> Tensor:
        B, T, C = x.shape
        H, hs = self.n_head, C // self.n_head

        def heads(t):
            return t.reshape(B, -1, H, hs).transpose(1, 2)

        q = heads(self.c_query(x))
        k, v = (heads(t) for t in self.c_attn(z).split(self.n_embd, dim=-1))
        if self.q_layernorm is not None:
            q = self.q_layernorm(q)
            k = self.k_layernorm(k)
        y = multihead_attention(q, k, v, attn_bias)
        return self.resid_drop(self.c_proj(y.transpose(1, 2).reshape(B, T, C)))


class SelfAttnBlock(nn.Module):
    """Pre-LN residual block: x + Attn(LN(x)); x + MLP(LN(x))."""

    def __init__(self, n_embd: int, n_head: int, n_inner: Optional[int] = None,
                 bias: bool = True, qk_layernorm: bool = True, dropout: float = 0.0):
        super().__init__()
        self.ln1 = LayerNorm(n_embd, bias)
        self.attn = SelfAttention(n_embd, n_head, bias, qk_layernorm, dropout)
        self.ln2 = LayerNorm(n_embd, bias)
        self.ffw = MLP(n_embd, n_inner if n_inner is not None else 4 * n_embd, bias=bias,
                       dropout=dropout)

    def forward(self, x: Tensor, attn_bias: Optional[Tensor] = None,
                key_mask: Optional[Tensor] = None,
                segments: Optional[Tensor] = None) -> Tensor:
        x = x + self.attn(self.ln1(x), attn_bias, key_mask, segments)
        return x + self.ffw(self.ln2(x))
