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
  Tq == Tk).  A causal call (`causal=True`, the GPT baseline's full
  forward) takes no bias: it goes to K2's causal form, which computes the
  causal bias in the kernel, and the plain versions add `causal_bias`.
  CPU tensors go to the plain versions.
- A call with `dropout_rate > 0` (a train-mode forward with
  `Config.dropout`) goes to the plain version on every device, by design:
  the JAX package sends attention with probability dropout to its XLA
  path, never to a Pallas kernel, and the kernels here have no dropout.
  `attn.plain_dropout.<layout>` counts those calls.  The keep mask is
  drawn in fp32 (`dropout_keep`), at the global shape under a mesh: the
  rows of a data-parallel rank and the heads of a tensor-parallel rank are
  cut from the mask one device would draw.
- bf16 (the encoders' `compute_dtype="bfloat16"`): q, k and v in bf16, as
  `_xla_attention` / `_xla_attention_btc` take them.  The scores are
  accumulated in fp32 from the bf16 products (`preferred_element_type=
  float32`), the key mask, the bias (fp32 or bf16) and the softmax are
  fp32, the probabilities are rounded to bf16 for the product with v,
  which accumulates in fp32 and returns bf16.  CUDA tensors go to the bf16
  forms of K1 and K2.  At fp32 the casts are no-ops.

The JAX sampler's clamped unnormalized softmax is a TPU shortcut and is
not ported: every path computes the exact max-subtracted softmax.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from multimodal_flows_tpu_torch.utils.profiling import count, declare

Tensor = torch.Tensor

declare("attn.plain_dropout", "head_major", "token_major")


@functools.lru_cache(maxsize=None)
def causal_bias(T: int, device: torch.device) -> Tensor:
    """The (1, 1, T, T) additive causal bias, 0 on and below the diagonal
    and -1e9 above (the JAX package's `models/gpt.py:71-72`), built once
    per (T, device): the port's only construction of it."""
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=device))
    return torch.where(causal, 0.0, -1e9)[None, None]


def dropout_keep(shape, rate: float, generator: Optional[torch.Generator], device,
                 rows: Optional[Tuple[slice, int]] = None,
                 heads: Optional[Tuple[slice, int]] = None) -> Tensor:
    """Bernoulli(1 - rate) keep mask (bool) of `shape`, from fp32 uniforms
    drawn from `generator` on `device`.  Under a mesh the uniforms are drawn
    at the global shape and this rank's share is kept: `rows` (its slice of
    dim 0, the global size of dim 0) for a data-parallel rank, `heads` (its
    slice of dim 1, the global size of dim 1) for a tensor-parallel rank's
    attention probabilities.  So every rank consumes the generator as one
    device does, and the ranks together drop what one device drops."""
    full = list(shape)
    if rows is not None:
        full[0] = rows[1]
    if heads is not None:
        full[1] = heads[1]
    u = torch.rand(full, generator=generator, dtype=torch.float32, device=device)
    if rows is not None:
        u = u[rows[0]]
    if heads is not None:
        u = u[:, heads[0]]
    return u >= rate


def _prob_dropout(probs: Tensor, dropout_rate: float,
                  generator: Optional[torch.Generator],
                  rows: Optional[Tuple[slice, int]] = None,
                  heads: Optional[Tuple[slice, int]] = None) -> Tensor:
    """The keep mask of `dropout_keep` on the softmax output, with inverted
    scaling."""
    keep = dropout_keep(probs.shape, dropout_rate, generator, probs.device, rows, heads)
    return probs * keep.to(probs.dtype) / (1.0 - dropout_rate)


def attention_reference(q: Tensor, k: Tensor, v: Tensor,
                        key_mask: Optional[Tensor] = None,
                        bias: Optional[Tensor] = None, dropout_rate: float = 0.0,
                        generator: Optional[torch.Generator] = None) -> Tensor:
    """softmax(q k^T / sqrt(Dh) + key_mask + bias) v over head-major
    q (B, H, Tq, Dh), k/v (B, H, Tk, Dh); key_mask (B, Tk) additive, bias
    additive and broadcastable to (B, H, Tq, Tk).  With `dropout_rate` > 0
    the probabilities are dropped with a mask from `generator`.  bf16 q/k/v
    give fp32 scores and a bf16 output (see the module docstring)."""
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        scores = scores + key_mask[:, None, None, :].to(torch.float32)
    if bias is not None:
        scores = scores + bias.to(torch.float32)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        probs = _prob_dropout(probs, dropout_rate, generator)
    return torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype).float(), v.float()).to(v.dtype)


def attention_btc_reference(q: Tensor, k: Tensor, v: Tensor, n_head: int,
                            key_mask: Optional[Tensor] = None,
                            segments: Optional[Tensor] = None,
                            bias: Optional[Tensor] = None, dropout_rate: float = 0.0,
                            generator: Optional[torch.Generator] = None, *,
                            dropout_rows: Optional[Tuple[slice, int]] = None,
                            dropout_heads: Optional[Tuple[slice, int]] = None) -> Tensor:
    """softmax(q k^T / sqrt(hs) + key_mask + bias) v per head, heads packed
    in C.

    key_mask (B, Tk) is additive (0 / -1e9); bias is additive and
    broadcastable to (B, H, T, Tk).  segments (B, T) int ids (pads -1)
    restrict attention to same-segment pairs: a cross-segment score is
    replaced by -1e9, after the key mask and the bias are added.  With
    `dropout_rate` > 0 the probabilities are dropped with a mask from
    `generator` (`dropout_keep`: `dropout_rows` / `dropout_heads` under a
    mesh).  bf16 q/k/v give fp32 scores and a bf16 output (see the module
    docstring).
    """
    B, T, C = q.shape
    Tk = k.shape[1]
    hs = C // n_head
    scale = 1.0 / float(hs) ** 0.5
    q4 = q.reshape(B, T, n_head, hs)
    k4 = k.reshape(B, Tk, n_head, hs)
    v4 = v.reshape(B, Tk, n_head, hs)
    scores = torch.einsum("bqhd,bkhd->bhqk", q4.float(), k4.float()) * scale
    if key_mask is not None:
        scores = scores + key_mask[:, None, None, :].to(scores.dtype)
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    if segments is not None:
        same = segments[:, None, :, None] == segments[:, None, None, :]
        scores = torch.where(same, scores, -1e9)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        probs = _prob_dropout(probs, dropout_rate, generator, dropout_rows, dropout_heads)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v4.float())
    return out.reshape(B, T, C).to(v.dtype)


def multihead_attention(q: Tensor, k: Tensor, v: Tensor,
                        bias: Optional[Tensor] = None,
                        key_mask: Optional[Tensor] = None, *,
                        dropout_rate: float = 0.0,
                        generator: Optional[torch.Generator] = None) -> Tensor:
    """Attention over head-major (B, H, T, Dh) q/k/v (fp32 or bf16) with an
    additive key mask and bias: the K2 kernel on CUDA tensors, the reference on CPU
    tensors; the reference on both when `dropout_rate` > 0."""
    if dropout_rate > 0.0:
        count("attn.plain_dropout.head_major")
    elif q.device.type == "cuda":
        from multimodal_flows_tpu_torch.ops.set_attention import set_attention

        return set_attention(q, k, v, key_mask, bias)
    elif q.device.type != "cpu":
        raise ValueError(f"no attention path for device {q.device}")
    return attention_reference(q, k, v, key_mask, bias, dropout_rate, generator)


def multihead_attention_btc(q: Tensor, k: Tensor, v: Tensor, n_head: int,
                            bias: Optional[Tensor] = None,
                            key_mask: Optional[Tensor] = None, *,
                            dropout_rate: float = 0.0,
                            generator: Optional[torch.Generator] = None,
                            segments: Optional[Tensor] = None,
                            dropout_rows: Optional[Tuple[slice, int]] = None,
                            dropout_heads: Optional[Tuple[slice, int]] = None,
                            causal: bool = False) -> Tensor:
    """Attention over token-major q (B, Tq, C), k/v (B, Tk, C) with heads
    packed in C, fp32 or bf16: on CUDA tensors the K2 kernel with a bias or
    with Tq != Tk, the K1 kernel otherwise; on CPU tensors the reference;
    the reference on both when `dropout_rate` > 0 (its mask cut from the
    global one by `dropout_rows` / `dropout_heads`).

    `causal` marks a causal self-attention (key j > query i masked by
    -1e9, Tq == Tk), GPT's full forward, and takes no `bias`: on CUDA
    without dropout K2's causal form computes it in the kernel, the plain
    paths add `causal_bias`."""
    if causal and bias is not None:
        raise ValueError("a causal call takes no bias: the causal bias is built here")
    if dropout_rate > 0.0:
        count("attn.plain_dropout.token_major")
    elif q.device.type == "cuda":
        if causal or bias is not None or k.shape[1] != q.shape[1]:
            from multimodal_flows_tpu_torch.ops.set_attention import set_attention_btc

            return set_attention_btc(q, k, v, n_head, key_mask, bias, segments, causal=causal)
        from multimodal_flows_tpu_torch.ops.btc_attention import btc_attention

        return btc_attention(q, k, v, n_head, key_mask, segments)
    elif q.device.type != "cpu":
        raise ValueError(f"no attention path for device {q.device}")
    if causal:
        bias = causal_bias(q.shape[1], q.device)
    return attention_btc_reference(q, k, v, n_head, key_mask, segments, bias, dropout_rate,
                                   generator, dropout_rows=dropout_rows,
                                   dropout_heads=dropout_heads)
