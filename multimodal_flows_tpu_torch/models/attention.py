"""Self and cross attention over padded or packed particle sets, and the
causal self attention of the GPT baseline (PyTorch port of
`multimodal_flows_tpu/models/attention.py`).

Pre-LN residual blocks around fused-QKV multi-head attention with an
optional qk-LayerNorm over the head size, applied in token layout
(B, T, H, hs) with its parameters shared across heads.  Masking and
learned pairwise terms enter as an additive key mask (B, T), an additive
bias broadcastable to (B, H|1, T, T) and (B, T) segment ids.  Self
attention goes through `ops.attention.multihead_attention_btc` (on CUDA:
K2 with a bias or a query shorter than its keys, K2's causal form for a
`causal` call, K1 otherwise);
`CrossAttention` goes head-major through `ops.attention.multihead_attention`
(K2 on CUDA).

Dropout follows `module.train()` / `module.eval()`: in train mode with
`attn_dropout > 0` the attention probabilities are dropped (the call then
takes the plain attention on every device, as the JAX package sends it to
XLA and never to a Pallas kernel), and with `dropout > 0` the projected
output goes through a residual `Dropout`; in eval mode, and at rate 0,
nothing changes and the kernels run.  `attn_dropout` defaults to `dropout`
(the set encoders); the GPT baseline sets the two apart.  The masks come
from `dropout_generator` (`models.blocks.set_dropout_generator`).

KV-cache decode (`kv_cache=(k_cache, v_cache, pos, key_mask)`, the GPT
baseline's generation): x is the one token at position `pos`, a (1,) int64
tensor on the device; its k and v are written into the preallocated
(B, seq_len, C) caches in place at that index (the JAX package returns
updated copies; the port saves the copies) and its query attends to the
cached positions <= pos under the additive (B, seq_len) causal key mask,
which `FlavorSeqGPT.decode` builds once a step for every layer.  The call
returns (y, kv_cache).

Compute dtype (`dtype`, the encoders' `Config.compute_dtype`): `c_attn`,
`c_query`, `c_proj`, the qk-LayerNorm and the MLP compute in it
(`models.blocks.Dense`), so in bf16 the attention gets bf16 q, k and v
(K1 and K2 in bf16 on CUDA) and returns bf16.  The KV-cache branch is the
GPT baseline's, which is fp32 as in the JAX package.

Under a mesh the probability-dropout mask is drawn at the global shape
(`ops.attention.dropout_keep`): a data-parallel rank keeps its rows
(`dropout_rows`, set with the generator), a tensor-parallel rank its
heads, so the ranks drop what one device would.

Tensor parallelism (`parallel.tensor_parallel.tp_sharding`) leaves each
rank `n_head` of the heads: `c_attn` yields their q, k and v, the attention
and the qk-LayerNorm (per head) run on them alone, and the row-parallel
`c_proj` all-reduces the heads' partial outputs and adds its bias once.
`CrossAttention`'s `c_query` stays replicated and its output is cut to the
rank's heads after `copy_to_region`, so its gradient is summed over the
model group.  The forwards read the head count and size from the module,
never from `n_embd`, so the same code runs whole and sharded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from multimodal_flows_tpu_torch.models.blocks import MLP, Dense, Dropout, LayerNorm
from multimodal_flows_tpu_torch.ops.attention import (
    multihead_attention,
    multihead_attention_btc,
)

Tensor = torch.Tensor


class SelfAttention(nn.Module):
    """Fused-QKV multi-head self attention with qk-LayerNorm.  `dropout`
    is the residual dropout after `c_proj`; `attn_dropout` (None: the same
    rate) the probability dropout of the attention; `dtype` the compute
    dtype of the projections and the qk-LayerNorm."""

    def __init__(self, n_embd: int, n_head: int, bias: bool = True,
                 qk_layernorm: bool = True, dropout: float = 0.0,
                 attn_dropout: Optional[float] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        if n_embd % n_head:
            raise ValueError(f"n_embd={n_embd} is not a multiple of n_head={n_head}")
        self.n_embd, self.n_head = n_embd, n_head
        self.head_size = hs = n_embd // n_head
        self.tp_group = None  # the model group once sharded (tp_sharding)
        self.c_attn = Dense(n_embd, 3 * n_embd, bias=bias, dtype=dtype)
        self.q_layernorm = LayerNorm(hs, bias, dtype) if qk_layernorm else None
        self.k_layernorm = LayerNorm(hs, bias, dtype) if qk_layernorm else None
        self.c_proj = Dense(n_embd, n_embd, bias=bias, dtype=dtype)
        self.attn_dropout = float(dropout if attn_dropout is None else attn_dropout)
        self.dropout_generator: Optional[torch.Generator] = None
        self.dropout_rows: Optional[Tuple[slice, int]] = None
        self.resid_drop = Dropout(dropout)

    def _dropout_heads(self) -> Optional[Tuple[slice, int]]:
        """Under tensor parallelism, this rank's heads of all of them."""
        if self.tp_group is None:
            return None
        r = torch.distributed.get_rank(self.tp_group)
        H = self.n_head
        return slice(r * H, (r + 1) * H), H * torch.distributed.get_world_size(self.tp_group)

    def forward(self, x: Tensor, attn_bias: Optional[Tensor] = None,
                key_mask: Optional[Tensor] = None,
                segments: Optional[Tensor] = None, kv_cache: Optional[tuple] = None,
                causal: bool = False):
        B, T, _ = x.shape
        H, hs = self.n_head, self.head_size
        C = H * hs  # the width of this rank's heads
        q, k, v = self.c_attn(x).split(C, dim=-1)
        if self.q_layernorm is not None:
            q = self.q_layernorm(q.reshape(B, T, H, hs)).reshape(B, T, C)
            k = self.k_layernorm(k.reshape(B, T, H, hs)).reshape(B, T, C)
        if kv_cache is not None:
            k_cache, v_cache, pos, key_mask = kv_cache
            k_cache.index_copy_(1, pos, k)
            v_cache.index_copy_(1, pos, v)
            y = multihead_attention_btc(q.contiguous(), k_cache, v_cache, H, None, key_mask)
            return self.c_proj(y), kv_cache
        rate = self.attn_dropout if self.training else 0.0
        y = multihead_attention_btc(q.contiguous(), k.contiguous(), v.contiguous(), H,
                                    attn_bias, key_mask, dropout_rate=rate,
                                    generator=self.dropout_generator, segments=segments,
                                    dropout_rows=self.dropout_rows,
                                    dropout_heads=self._dropout_heads() if rate > 0 else None,
                                    causal=causal)
        return self.resid_drop(self.c_proj(y))


class CrossAttention(nn.Module):
    """Query from x, keys and values from z, in head layout
    (B, H, T, hs), with qk-LayerNorm there.  `dropout` is the residual
    dropout after `c_proj`; the probabilities are not dropped, as in the
    JAX package.  `dtype` is the compute dtype of the projections and the
    qk-LayerNorm."""

    def __init__(self, n_embd: int, n_head: int, bias: bool = True,
                 qk_layernorm: bool = True, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if n_embd % n_head:
            raise ValueError(f"n_embd={n_embd} is not a multiple of n_head={n_head}")
        self.n_embd, self.n_head = n_embd, n_head
        self.head_size = hs = n_embd // n_head
        self.tp_group = None  # the model group once sharded (tp_sharding)
        self.c_query = Dense(n_embd, n_embd, bias=bias, dtype=dtype)
        self.c_attn = Dense(n_embd, 2 * n_embd, bias=bias, dtype=dtype)
        self.q_layernorm = LayerNorm(hs, bias, dtype) if qk_layernorm else None
        self.k_layernorm = LayerNorm(hs, bias, dtype) if qk_layernorm else None
        self.c_proj = Dense(n_embd, n_embd, bias=bias, dtype=dtype)
        self.resid_drop = Dropout(dropout)

    def forward(self, x: Tensor, z: Tensor, attn_bias: Optional[Tensor] = None) -> Tensor:
        B, T, _ = x.shape
        H, hs = self.n_head, self.head_size

        def heads(t):
            return t.reshape(B, t.shape[1], H, hs).transpose(1, 2)

        q = self.c_query(x)
        if self.tp_group is not None:
            from multimodal_flows_tpu_torch.parallel.tensor_parallel import copy_to_region

            r = torch.distributed.get_rank(self.tp_group)
            q = copy_to_region(q, self.tp_group)[..., r * H * hs:(r + 1) * H * hs]
        q = heads(q)
        k, v = (heads(t) for t in self.c_attn(z).split(H * hs, dim=-1))
        if self.q_layernorm is not None:
            q = self.q_layernorm(q)
            k = self.k_layernorm(k)
        y = multihead_attention(q, k, v, attn_bias)
        return self.resid_drop(self.c_proj(y.transpose(1, 2).reshape(B, T, H * hs)))


class SelfAttnBlock(nn.Module):
    """Pre-LN residual block: x + Attn(LN(x)); x + MLP(LN(x)).

    `attn_dropout` and `activation` exist for the GPT baseline's GPT2
    semantics (attn_pdrop apart from resid_pdrop, `gelu_new`); the set
    encoders keep the defaults and pass their compute `dtype`.  With
    `kv_cache` the block returns (x, kv_cache), as `SelfAttention` does;
    `causal` makes it a causal self-attention with no `attn_bias` (GPT's
    full forward, see `ops.attention.multihead_attention_btc`)."""

    def __init__(self, n_embd: int, n_head: int, n_inner: Optional[int] = None,
                 bias: bool = True, qk_layernorm: bool = True, dropout: float = 0.0,
                 attn_dropout: Optional[float] = None, activation: str = "gelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln1 = LayerNorm(n_embd, bias, dtype)
        self.attn = SelfAttention(n_embd, n_head, bias, qk_layernorm, dropout, attn_dropout,
                                  dtype)
        self.ln2 = LayerNorm(n_embd, bias, dtype)
        self.ffw = MLP(n_embd, n_inner if n_inner is not None else 4 * n_embd, bias=bias,
                       dropout=dropout, activation=activation, dtype=dtype)

    def forward(self, x: Tensor, attn_bias: Optional[Tensor] = None,
                key_mask: Optional[Tensor] = None,
                segments: Optional[Tensor] = None, kv_cache: Optional[tuple] = None,
                causal: bool = False):
        if kv_cache is not None:
            y, kv_cache = self.attn(self.ln1(x), kv_cache=kv_cache)
            x = x + y
            return x + self.ffw(self.ln2(x)), kv_cache
        x = x + self.attn(self.ln1(x), attn_bias, key_mask, segments, causal=causal)
        return x + self.ffw(self.ln2(x))
