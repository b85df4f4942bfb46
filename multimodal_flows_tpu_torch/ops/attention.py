"""Masked set attention (PyTorch port of
`multimodal_flows_tpu/ops/attention.py:83-234`).

- `attention_reference` is the plain PyTorch twin of `_xla_attention` /
  `_xla_reference` (head-major (B, H, T, Dh), key mask and bias) and
  `attention_btc_reference` that of `_xla_attention_btc` (token-major
  (B, T, C), key mask, bias and segments), both with the exact softmax
  and the optional dropout of the attention probabilities.  They are the
  CPU paths and the oracles the kernels are held to.
- `multihead_attention` (head-major) and `multihead_attention_btc`
  (token-major) dispatch on the tensors' device.  CUDA tensors go to a
  hand-written kernel: K2 (`ops/set_attention.py`) for head-major calls,
  for every biased call and for every token-major call whose query length
  differs from its key length (the GPT baseline's KV-cache decode: one
  query against the cache under a causal key mask); K1
  (`ops/btc_attention.py`) for the other token-major calls (bias-free,
  Tq == Tk).  CPU tensors go to the plain versions.
- A call with `dropout_rate > 0` (a train-mode forward with
  `Config.dropout`) goes to the plain version on every device, by design:
  the JAX package sends attention with probability dropout to its XLA
  path, never to a Pallas kernel, and the kernels here have no dropout.
  `PLAIN_DROPOUT_CALLS` counts those calls.

The JAX sampler's clamped unnormalized softmax is a TPU shortcut and is
not ported: every path computes the exact max-subtracted softmax.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

#: calls that took the plain version because of probability dropout
PLAIN_DROPOUT_CALLS = {"head_major": 0, "token_major": 0}


def reset_plain_dropout_calls() -> None:
    for form in PLAIN_DROPOUT_CALLS:
        PLAIN_DROPOUT_CALLS[form] = 0


def _prob_dropout(probs: Tensor, dropout_rate: float,
                  generator: Optional[torch.Generator]) -> Tensor:
    """Bernoulli(1 - rate) keep mask on the softmax output, drawn from
    `generator` on the tensor's device, with inverted scaling."""
    keep = torch.rand(probs.shape, generator=generator, dtype=probs.dtype,
                      device=probs.device) >= dropout_rate
    return probs * keep.to(probs.dtype) / (1.0 - dropout_rate)


def attention_reference(q: Tensor, k: Tensor, v: Tensor,
                        key_mask: Optional[Tensor] = None,
                        bias: Optional[Tensor] = None, dropout_rate: float = 0.0,
                        generator: Optional[torch.Generator] = None) -> Tensor:
    """softmax(q k^T / sqrt(Dh) + key_mask + bias) v over head-major
    q (B, H, Tq, Dh), k/v (B, H, Tk, Dh); key_mask (B, Tk) additive, bias
    additive and broadcastable to (B, H, Tq, Tk).  With `dropout_rate` > 0
    the probabilities are dropped with a mask from `generator`."""
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    if key_mask is not None:
        scores = scores + key_mask[:, None, None, :].to(torch.float32)
    if bias is not None:
        scores = scores + bias.to(torch.float32)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        probs = _prob_dropout(probs, dropout_rate, generator)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)


def attention_btc_reference(q: Tensor, k: Tensor, v: Tensor, n_head: int,
                            key_mask: Optional[Tensor] = None,
                            segments: Optional[Tensor] = None,
                            bias: Optional[Tensor] = None, dropout_rate: float = 0.0,
                            generator: Optional[torch.Generator] = None) -> Tensor:
    """softmax(q k^T / sqrt(hs) + key_mask + bias) v per head, heads packed
    in C.

    key_mask (B, Tk) is additive (0 / -1e9); bias is additive and
    broadcastable to (B, H, T, Tk).  segments (B, T) int ids (pads -1)
    restrict attention to same-segment pairs: a cross-segment score is
    replaced by -1e9, after the key mask and the bias are added.  With
    `dropout_rate` > 0 the probabilities are dropped with a mask from
    `generator`.
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
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    if segments is not None:
        same = segments[:, None, :, None] == segments[:, None, None, :]
        scores = torch.where(same, scores, -1e9)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        probs = _prob_dropout(probs, dropout_rate, generator)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v4)
    return out.reshape(B, T, C)


def multihead_attention(q: Tensor, k: Tensor, v: Tensor,
                        bias: Optional[Tensor] = None,
                        key_mask: Optional[Tensor] = None, *,
                        dropout_rate: float = 0.0,
                        generator: Optional[torch.Generator] = None) -> Tensor:
    """Attention over head-major (B, H, T, Dh) q/k/v with an additive key
    mask and bias: the K2 kernel on CUDA tensors, the reference on CPU
    tensors; the reference on both when `dropout_rate` > 0."""
    if dropout_rate > 0.0:
        PLAIN_DROPOUT_CALLS["head_major"] += 1
        return attention_reference(q, k, v, key_mask, bias, dropout_rate, generator)
    if q.device.type == "cuda":
        from multimodal_flows_tpu_torch.ops.set_attention import set_attention

        return set_attention(q, k, v, key_mask, bias)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, key_mask, bias)
    raise ValueError(f"no attention path for device {q.device}")


def multihead_attention_btc(q: Tensor, k: Tensor, v: Tensor, n_head: int,
                            bias: Optional[Tensor] = None,
                            key_mask: Optional[Tensor] = None, *,
                            dropout_rate: float = 0.0,
                            generator: Optional[torch.Generator] = None,
                            segments: Optional[Tensor] = None) -> Tensor:
    """Attention over token-major q (B, Tq, C), k/v (B, Tk, C) with heads
    packed in C: on CUDA tensors the K2 kernel with a bias or with Tq !=
    Tk, the K1 kernel otherwise; on CPU tensors the reference; the
    reference on both when `dropout_rate` > 0."""
    if dropout_rate > 0.0:
        PLAIN_DROPOUT_CALLS["token_major"] += 1
        return attention_btc_reference(q, k, v, n_head, key_mask, segments, bias,
                                       dropout_rate, generator)
    if q.device.type == "cuda":
        if bias is not None or k.shape[1] != q.shape[1]:
            from multimodal_flows_tpu_torch.ops.set_attention import set_attention_btc

            return set_attention_btc(q, k, v, n_head, key_mask, bias, segments)
        from multimodal_flows_tpu_torch.ops.btc_attention import btc_attention

        return btc_attention(q, k, v, n_head, key_mask, segments)
    if q.device.type == "cpu":
        return attention_btc_reference(q, k, v, n_head, key_mask, segments, bias)
    raise ValueError(f"no attention path for device {q.device}")
