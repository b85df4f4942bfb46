"""Shared network blocks (PyTorch port of `multimodal_flows_tpu/models/blocks.py`).

The named activations (`ACTIVATIONS`, `activation_fn`), MLP (fc ->
activation, exact GELU by default -> proj -> dropout), LayerNorm with
optional bias and fp32 statistics, `Dropout` with an explicit generator, the sinusoidal
timestep embedding, the toy model's log-spaced Fourier time features, the
compact additive key mask and the additive pair mask.  `init_weights` reproduces the JAX
initialisation: Linear and Embedding weights N(0, 0.02), biases zero,
LayerNorm scale 1 and bias 0.

Compute dtype (`Config.compute_dtype`, flax's `dtype=`): parameters stay
fp32 and each layer casts at use.  `Dense` casts its input, weight and
bias to its dtype, rounds the product to it and then adds the bias in it,
as flax's `Dense(dtype=)` does; `embed` gathers from the table cast to the
dtype (flax's `Embed(dtype=)`); `LayerNorm` normalises in fp32 and returns
its dtype; `gelu` in bf16 rounds after each operation of JAX's
`0.5 x erfc(-x sqrt(1/2))`.  At fp32 every one of them is the plain fp32
layer.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_flows_tpu_torch.ops.attention import dropout_keep

Tensor = torch.Tensor

#: sqrt(1/2) rounded to bf16, the constant of JAX's exact GELU in bf16
_SQRT_HALF_BF16 = 0.70703125


def compute_dtype(name: str) -> torch.dtype:
    """`Config.compute_dtype` ("float32" or "bfloat16") as a torch dtype."""
    if name not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {name!r}")
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def gelu(x: Tensor) -> Tensor:
    """Exact GELU.  In fp32 `F.gelu`; in bf16 JAX's `0.5 x erfc(-x
    sqrt(1/2))` rounded to bf16 after each operation, as the JAX package's
    bf16 forward computes it (a single rounding differs in the last bit on
    about 40% of the values)."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    return (0.5 * x) * torch.special.erfc(x * -_SQRT_HALF_BF16)


#: named activations (the GPT baseline's `activation`; GPT2's `gelu_new` is
#: the tanh approximation of GELU)
ACTIVATIONS = {
    "gelu": gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "tanh": torch.tanh,
}


def activation_fn(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}; one of {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


class Dropout(nn.Module):
    """Dropout whose mask comes from an explicit generator: active in
    train mode (`module.train()`), the identity in eval mode.  The keep
    mask is drawn in fp32 from `dropout_generator` on the input's device
    (from torch's default generator while it is None), at the global
    batch's shape when `dropout_rows` (this rank's rows, the global row
    count) is set, and the kept values are scaled by 1 / (1 - p) in the
    input's dtype.  `set_dropout_generator` sets both for every dropout
    site of a module."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.dropout_generator: Optional[torch.Generator] = None
        self.dropout_rows: Optional[Tuple[slice, int]] = None

    def forward(self, x: Tensor) -> Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = dropout_keep(x.shape, self.p, self.dropout_generator, x.device,
                            self.dropout_rows)
        return x * keep.to(x.dtype) / (1.0 - self.p)


def set_dropout_generator(module: nn.Module, generator: Optional[torch.Generator],
                          rows: Optional[Tuple[slice, int]] = None) -> None:
    """Give every dropout site of `module` (the `Dropout` layers and the
    attention-probability dropout of the attention modules) the generator
    its masks are drawn from; it must live on the module's device.  `rows`
    (this rank's slice of the batch, the global row count) makes every site
    draw its mask at the global batch's shape and keep this rank's rows, so
    that data-parallel ranks drop what one device would; None: the local
    shape is the global one."""
    for m in module.modules():
        if hasattr(m, "dropout_generator"):
            m.dropout_generator = generator
            m.dropout_rows = rows


class Dense(nn.Linear):
    """`nn.Linear` computing in `dtype` (flax's `Dense(dtype=)`): fp32
    parameters; the input, weight and bias cast at use; the product
    rounded to `dtype` before the bias is added in it.  At fp32 it is
    `nn.Linear` (on an input cast to fp32)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        return dense(x, self.weight, self.bias, self.compute_dtype)


def dense(x: Tensor, weight: Tensor, bias: Optional[Tensor], dtype: torch.dtype) -> Tensor:
    """x W^T + b computed in `dtype` as `Dense` does."""
    if dtype == torch.float32:
        return F.linear(x.to(dtype), weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


def embed(table: nn.Embedding, ids: Tensor, dtype: torch.dtype = torch.float32) -> Tensor:
    """Rows `ids` of the embedding table cast to `dtype` (flax's
    `Embed(dtype=)`: the table is cast, then gathered)."""
    if dtype == torch.float32:
        return table(ids.long())
    return F.embedding(ids.long(), table.weight.to(dtype))


class MLP(nn.Module):
    """fc -> activation (exact GELU unless named) -> proj -> dropout (flax
    names `c_fc`, `c_proj`)."""

    def __init__(self, n_embd: int, n_inner: int, n_out: Optional[int] = None,
                 bias: bool = True, dropout: float = 0.0, activation: str = "gelu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c_fc = Dense(n_embd, n_inner, bias=bias, dtype=dtype)
        self.act = activation_fn(activation)
        self.c_proj = Dense(n_inner, n_out if n_out is not None else n_embd, bias=bias,
                            dtype=dtype)
        self.drop = Dropout(dropout)

    def forward(self, x: Tensor) -> Tensor:
        return self.drop(self.c_proj(self.act(self.c_fc(x))))


class LayerNorm(nn.Module):
    """LayerNorm over the last dim, eps 1e-5 unless given, optional bias,
    computed in fp32 and returned in `dtype` (None: the input's), as
    flax's `LayerNorm(dtype=, param_dtype=float32)` does."""

    def __init__(self, n: int, bias: bool = True, dtype: Optional[torch.dtype] = None,
                 eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n)) if bias else None
        self.dtype, self.eps = dtype, eps

    def forward(self, x: Tensor) -> Tensor:
        return F.layer_norm(x.to(torch.float32), self.weight.shape, self.weight,
                            self.bias, self.eps).to(self.dtype or x.dtype)


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


def time_token_embedding(time: Tensor, embedding_dim: int,
                         dtype: torch.dtype = torch.float32) -> Tensor:
    """Per-jet (B,) time -> (B, 1, E); per-token (B, T) time -> (B, T, E),
    computed in fp32 and cast to `dtype`."""
    emb = timestep_embedding(time, embedding_dim).to(dtype)
    return emb[:, None, :] if time.ndim == 1 else emb


class TimeFourierEmbedding(nn.Module):
    """Log-spaced Fourier features of scalar t: (B,) or (B, 1) -> (B, dim),
    [sin(t f_i), cos(t f_i)] with f_i = max_freq^(-i / (dim/2 - 1)).  No
    parameters (the toy tutorial's model uses it)."""

    def __init__(self, dim: int, max_freq: float = 10.0):
        super().__init__()
        self.dim = int(dim)
        self.max_freq = float(max_freq)

    def forward(self, t: Tensor) -> Tensor:
        half = self.dim // 2
        inv_freq = 1.0 / (self.max_freq ** (torch.arange(half, dtype=torch.float32,
                                                         device=t.device) / (half - 1)))
        if t.ndim == 1:
            t = t[:, None]
        x = t.to(torch.float32) * inv_freq[None, :]
        return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


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
