"""Masked set attention over token-major (B, T, C) tensors (PyTorch port of
`multimodal_flows_tpu/ops/attention.py:139-234`).

- `attention_btc_reference` is the plain PyTorch twin of
  `_xla_attention_btc` in its exact-softmax, bias-free, dropout-free form.
  It is the CPU path and the oracle the K1 kernel is held to.
- `multihead_attention_btc` dispatches on the tensors' device: CUDA
  tensors go to the hand-written K1 kernel (`ops/btc_attention.py`), CPU
  tensors to the reference.

The JAX sampler's clamped unnormalized softmax is a TPU shortcut and is
not ported: both paths compute the exact max-subtracted softmax.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def attention_btc_reference(q: Tensor, k: Tensor, v: Tensor, n_head: int,
                            key_mask: Optional[Tensor] = None,
                            segments: Optional[Tensor] = None) -> Tensor:
    """softmax(q k^T / sqrt(hs) + key_mask) v per head, heads packed in C.

    key_mask (B, T) is additive (0 / -1e9).  segments (B, T) int ids (pads
    -1) restrict attention to same-segment pairs: a cross-segment score is
    replaced by -1e9, after the key mask is added.
    """
    B, T, C = q.shape
    Tk = k.shape[1]
    hs = C // n_head
    scale = 1.0 / float(hs) ** 0.5
    q4 = q.reshape(B, T, n_head, hs)
    k4 = k.reshape(B, Tk, n_head, hs)
    v4 = v.reshape(B, Tk, n_head, hs)
    scores = torch.einsum("bqhd,bkhd->bhqk", q4, k4).to(torch.float32) * scale
    if key_mask is not None:
        scores = scores + key_mask[:, None, None, :].to(scores.dtype)
    if segments is not None:
        same = segments[:, None, :, None] == segments[:, None, None, :]
        scores = torch.where(same, scores, -1e9)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v4)
    return out.reshape(B, T, C)


def multihead_attention_btc(q: Tensor, k: Tensor, v: Tensor, n_head: int,
                            bias: Optional[Tensor] = None,
                            key_mask: Optional[Tensor] = None, *,
                            dropout_rate: float = 0.0,
                            segments: Optional[Tensor] = None) -> Tensor:
    """Attention over token-major (B, T, C) q/k/v with heads packed in C:
    the K1 kernel on CUDA tensors, the reference on CPU tensors."""
    if bias is not None:
        raise NotImplementedError(
            "biased attention is kernel K2, not ported yet (ROADMAP.md Queue 2)")
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout comes with training (ROADMAP.md Queue 1 item 14)")
    if q.device.type == "cuda":
        from multimodal_flows_tpu_torch.ops.btc_attention import btc_attention

        return btc_attention(q, k, v, n_head, key_mask, segments)
    if q.device.type == "cpu":
        return attention_btc_reference(q, k, v, n_head, key_mask, segments)
    raise ValueError(f"no attention path for device {q.device}")
