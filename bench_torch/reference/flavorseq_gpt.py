"""Plain reference of the GPT baseline (a GPT-2 decoder, as the reference
repository's `model/GPT.py` wraps `GPT2LMHeadModel`): token and learned
position embeddings, pre-LN blocks with fused QKV and no qk-LayerNorm,
causal softmax attention, the tanh GELU (`gelu_new`), a final LayerNorm
and an unbiased LM head over the flavor vocabulary plus BOS, EOS and PAD.
Always the full causal forward over whole sequences: no KV cache.
Parameter names are the program's state-dict names.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench_torch import weights
from bench_torch.counts import block_flops
from bench_torch.reference.common import (
    Ops, Spec, block, block_spec, gelu_tanh, layer_norm, linear_spec, ln_spec,
)

Tensor = torch.Tensor


def seq_len(cfg: Dict) -> int:
    return cfg["max_seq_length"] + 2


def full_vocab(cfg: Dict) -> int:
    return cfg["vocab_size"] + 4


def special_tokens(cfg: Dict):
    """(BOS, EOS, PAD)."""
    V = cfg["vocab_size"]
    return V + 1, V + 2, V + 3


def param_spec(cfg: Dict) -> Spec:
    n = cfg["n_embd"]
    spec = [("wte.weight", (full_vocab(cfg), n), "embedding"),
            ("wpe.weight", (seq_len(cfg), n), "embedding")]
    for i in range(cfg["n_layer"]):
        spec += block_spec(f"block_{i}", n, cfg["n_inner"], False, cfg["n_head"])
    return spec + ln_spec("ln_f", n) + linear_spec("lm_head", n, full_vocab(cfg), bias=False)


def draw_weights(cfg: Dict, seed: int, device: torch.device) -> Dict[str, Tensor]:
    """The seed's weights (`weights.draw`) with the output bias the
    configuration assumes (`assumed.output_bias`), which sets how long the
    sequences run.  The head has no bias, so channel 0 of the final
    LayerNorm is held at 1 (scale 0, shift 1) and column 0 of the head
    carries the bias.  EOS's row is its bias `eos` alone, so EOS has that
    logit at every step, against the flavors' logits of order one: the
    lengths are about geometric.  The ids no sequence holds inside (0, the
    id past the flavors, BOS, PAD) get the bias `unused`, the flavors 0."""
    p = weights.draw(param_spec(cfg), seed, device)
    spec = cfg["assumed"]["output_bias"]
    V = cfg["vocab_size"]
    bos, eos, pad = special_tokens(cfg)
    bias = torch.zeros(full_vocab(cfg), device=device)
    bias[[0, V, bos, pad]] = spec["unused"]
    bias[eos] = spec["eos"]
    p["ln_f.weight"][0] = 0.0
    p["ln_f.bias"][0] = 1.0
    p["lm_head.weight"][eos] = 0.0          # EOS's logit is its bias alone, at every step
    p["lm_head.weight"][:, 0] = bias
    return p


def dense_flops(cfg: Dict) -> int:
    """Dense FLOPs of one real position (`bench_torch/counts.py`)."""
    n = cfg["n_embd"]
    return cfg["n_layer"] * block_flops(n, cfg["n_inner"]) + 2 * n * full_vocab(cfg)


def attention_layers(cfg: Dict) -> List[Tuple[int, int]]:
    """[(width, layers)] of the self-attention calls of one forward."""
    return [(cfg["n_embd"], cfg["n_layer"])]


def forward(ops: Ops, p: Dict[str, Tensor], cfg: Dict, ids: Tensor) -> Tensor:
    """Logits (N, T, V + 4) of token ids (N, T)."""
    N, T = ids.shape
    pos = torch.arange(T, device=ids.device)
    h = p["wte.weight"][ids.long()] + p["wpe.weight"][pos][None]
    allowed = (pos[None, :] <= pos[:, None])[None].expand(N, T, T)
    for i in range(cfg["n_layer"]):
        h = block(ops, p, f"block_{i}", h, cfg["n_head"], allowed, False, gelu_tanh)
    h = layer_norm(h, p["ln_f.weight"], p["ln_f.bias"])
    return ops.linear(h, p["lm_head.weight"])


def jet_set_to_seq(tokens, vocab_size: int):
    """Flavor sets (N, D) (0 = no particle) as BOS, tokens, EOS, PAD
    sequences (N, D + 2), numpy."""
    import numpy as np

    bos, eos, pad = vocab_size + 1, vocab_size + 2, vocab_size + 3
    n = tokens.shape[0]
    body = np.where(tokens == 0, pad, tokens).astype(np.int64)
    seq = np.concatenate([np.full((n, 1), bos), body, np.full((n, 1), pad)], axis=1)
    seq[np.arange(n), (seq != pad).sum(axis=1)] = eos
    return seq
