"""Autoregressive flavor-sequence GPT baseline (PyTorch port of
`multimodal_flows_tpu/models/gpt.py`).

A small decoder-only causal transformer built from the same
`SelfAttnBlock` as the set encoders (pre-LN, fused QKV, no qk-LayerNorm)
with learned positional embeddings.  Two paths share the parameters:
`forward` (teacher-forced, the whole sequence under a causal bias: K2's
causal form on CUDA, which computes the bias in the kernel and skips the
key tiles past each query tile) and `decode` (one position against
per-layer KV caches: K2's key-mask form on CUDA).

Vocabulary layout: flavor tokens 1..V-1, plus BOS = V+1, EOS = V+2,
PAD = V+3, over sequences of max_seq_length + 2.  Module names mirror the
flax tree (`wte`, `wpe`, `block_{i}`, `ln_f`, `lm_head`), so
`convert.load_flax_params` loads a JAX `FlavorSeqGPT` tree strictly.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.models.attention import SelfAttnBlock
from multimodal_flows_tpu_torch.models.blocks import Dropout, LayerNorm

Tensor = torch.Tensor


class FlavorSeqGPT(nn.Module):
    """Decoder-only causal transformer over flavor-token sequences.  GPT2
    dropout semantics: `dropout_emb` on the embeddings, `dropout_att` on
    the attention probabilities, `dropout_res` after the attention and MLP
    projections; `activation` in the MLP."""

    def __init__(self, config: Config):
        super().__init__()
        cfg = self.config = config
        self.seq_len = cfg.max_seq_length + 2        # BOS + tokens + EOS
        self.full_vocab = cfg.vocab_size + 4         # + BOS / EOS / PAD
        self.wte = nn.Embedding(self.full_vocab, cfg.n_embd)
        self.wpe = nn.Embedding(self.seq_len, cfg.n_embd)
        self.drop_emb = Dropout(cfg.dropout_emb)
        for i in range(cfg.n_layer):
            self.add_module(f"block_{i}", SelfAttnBlock(
                cfg.n_embd, cfg.n_head, cfg.n_inner, cfg.bias, qk_layernorm=False,
                dropout=cfg.dropout_res, attn_dropout=cfg.dropout_att,
                activation=cfg.activation))
        self.ln_f = LayerNorm(cfg.n_embd)
        self.lm_head = nn.Linear(cfg.n_embd, self.full_vocab, bias=False)

    @property
    def blocks(self) -> List[SelfAttnBlock]:
        return [getattr(self, f"block_{i}") for i in range(self.config.n_layer)]

    def forward(self, input_ids: Tensor) -> Tensor:
        """Teacher-forced logits (B, T, V + 4) of token ids (B, T <= seq_len)."""
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        h = self.drop_emb(self.wte(input_ids) + self.wpe(pos)[None])
        for block in self.blocks:
            h = block(h, causal=True)
        return self.lm_head(self.ln_f(h))

    def init_cache(self, batch_size: int) -> List[Tuple[Tensor, Tensor]]:
        """Per-layer (k, v) caches of shape (B, seq_len, width of the
        attention's heads: n_embd, or this rank's share under tensor
        parallelism), zeros."""
        attn = self.blocks[0].attn
        shape = (batch_size, self.seq_len, attn.n_head * attn.head_size)
        device = self.wte.weight.device
        return [(torch.zeros(shape, device=device), torch.zeros(shape, device=device))
                for _ in range(self.config.n_layer)]

    def decode(self, token: Tensor, pos, caches):
        """One autoregressive step: token (B,) at position `pos`, an int or a
        0-d integer tensor on the module's device (read on the device, so a
        captured step needs nothing from the host); returns (logits (B, V + 4),
        caches), the caches written in place at `pos`.  The causal key mask
        over the cache, 0.0 at the positions <= pos and -1e9 past them, is
        built once here for every layer."""
        device = self.wpe.weight.device
        pos = torch.as_tensor(pos, dtype=torch.long, device=device).reshape(1)
        B, Tc = token.shape[0], self.seq_len
        key_mask = torch.where((torch.arange(Tc, device=device) <= pos).expand(B, Tc), 0.0, -1e9)
        h = self.wte(token[:, None]) + self.wpe.weight.index_select(0, pos)[None]
        for block, (kc, vc) in zip(self.blocks, caches):
            h, _ = block(h, kv_cache=(kc, vc, pos, key_mask))
        return self.lm_head(self.ln_f(h))[:, 0], caches
