"""The flagship set encoder (PyTorch port of
`multimodal_flows_tpu/models/particle_transformers.py:56-95,133-219`).

ParticleFormer returns (vt (B,D,Fc), logits (B,D,V)).  Module names
mirror the flax parameter tree (`block_x_0`, `ln1_x`, `head_y`, ...) so
`convert.params_from_flax` is a rename.  The forward is the deterministic
(inference) forward: dropout, co-occurrence bias and bf16 compute are not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.models.attention import SelfAttnBlock
from multimodal_flows_tpu_torch.models.blocks import (
    LayerNorm,
    key_mask_bias,
    time_token_embedding,
)

Tensor = torch.Tensor


class _EmbedMLP(nn.Module):
    """Linear/Embed -> exact GELU -> Linear feature embedder."""

    def __init__(self, n_hidden: int, n_out: int, *, n_in: Optional[int] = None,
                 vocab_size: Optional[int] = None, bias: bool = True):
        super().__init__()
        if vocab_size is not None:
            self.embed = nn.Embedding(vocab_size, n_hidden)
        else:
            self.fc = nn.Linear(n_in, n_hidden, bias=bias)
        self.proj = nn.Linear(n_hidden, n_out, bias=bias)

    def forward(self, x: Tensor) -> Tensor:
        h = self.embed(x.long()) if hasattr(self, "embed") else self.fc(x)
        return self.proj(F.gelu(h))


class _Head(nn.Module):
    """Linear -> exact GELU -> Linear output head, projection in fp32."""

    def __init__(self, n_embd: int, n_inner: int, n_out: int, bias: bool = True):
        super().__init__()
        self.fc = nn.Linear(n_embd, n_inner, bias=bias)
        self.proj = nn.Linear(n_inner, n_out, bias=bias)

    def forward(self, x: Tensor) -> Tensor:
        return self.proj(F.gelu(self.fc(x)).to(torch.float32))


class ParticleFormer(nn.Module):
    """Dual-stream multimodal transformer: per-modality half-width stacks
    with the time embedding re-added after every block, concatenated into
    full-width fused blocks, split back with modality skip connections
    into drift and logit heads."""

    def __init__(self, config: Config):
        super().__init__()
        cfg = config
        if cfg.use_coocurrence:
            raise NotImplementedError(
                "use_coocurrence needs the biased attention K2 (ROADMAP.md Queue 1 item 17)")
        if cfg.compute_dtype != "float32":
            raise NotImplementedError("bf16 compute is not ported yet (ROADMAP.md Queue 2)")
        self.config = cfg
        half = cfg.n_embd // 2
        head_inner = cfg.n_inner or 4 * half

        self.wxe = _EmbedMLP(cfg.n_embd, half, n_in=cfg.dim_continuous, bias=cfg.bias)
        self.ln1_x = LayerNorm(half)
        self.wye = _EmbedMLP(cfg.n_embd, half, vocab_size=cfg.vocab_size, bias=cfg.bias)
        self.ln1_y = LayerNorm(half)
        for s in ("x", "y"):
            for i in range(cfg.n_layer):
                self.add_module(f"block_{s}_{i}", SelfAttnBlock(
                    half, cfg.n_head, cfg.n_inner, cfg.bias, cfg.qk_layernorm))
        self.ln2_x = LayerNorm(half)
        self.ln2_y = LayerNorm(half)
        self.time_expand = nn.Linear(half, cfg.n_embd)
        for i in range(cfg.n_layer_fused):
            self.add_module(f"block_fuse_{i}", SelfAttnBlock(
                cfg.n_embd, cfg.n_head, cfg.n_inner, cfg.bias, cfg.qk_layernorm))
        self.ln3_x = LayerNorm(half)
        self.ln3_y = LayerNorm(half)
        self.head_x = _Head(half, head_inner, cfg.dim_continuous, cfg.bias)
        self.head_y = _Head(half, head_inner, cfg.vocab_size, cfg.bias)

    def _blocks(self, prefix: str, n: int):
        return [getattr(self, f"{prefix}_{i}") for i in range(n)]

    def forward(self, state: MultiModal, segments: Optional[Tensor] = None):
        """`segments` (B, T) int ids of packed multi-jet rows (pads -1)
        replace the key mask: attention is restricted to same-segment
        pairs, which subsumes pad masking."""
        cfg = self.config
        half = cfg.n_embd // 2
        if segments is not None:
            key_mask, segments = None, segments.to(torch.int32).contiguous()
        else:
            key_mask = key_mask_bias(state.mask)

        time_emb = time_token_embedding(state.time, half)            # (B,1|T,half)

        x = self.ln1_x(self.wxe(state.continuous.to(torch.float32))) + time_emb
        x_skip = x
        for blk in self._blocks("block_x", cfg.n_layer):
            x = blk(x, key_mask, segments) + time_emb
        x = self.ln2_x(x + x_skip)

        y = self.ln1_y(self.wye(state.discrete[..., 0])) + time_emb
        y_skip = y
        for blk in self._blocks("block_y", cfg.n_layer):
            y = blk(y, key_mask, segments) + time_emb
        y = self.ln2_y(y + y_skip)

        z = torch.cat([x, y], dim=-1)
        time_emb2 = self.time_expand(time_emb)
        z = z + time_emb2
        for blk in self._blocks("block_fuse", cfg.n_layer_fused):
            z = blk(z, key_mask, segments) + time_emb2

        x, y = z.split(half, dim=-1)
        x = self.ln3_x(x + x_skip)
        y = self.ln3_y(y + y_skip)
        return self.head_x(x), self.head_y(y)
