"""The set encoders (PyTorch port of
`multimodal_flows_tpu/models/particle_transformers.py`).

  ParticleFormer: (vt (B,D,Fc), logits (B,D,V)), optional token
                  co-occurrence bias (`use_coocurrence`)
  FusedParticleFormer: the same heads from one full-width stream
  FlavorFormer:   logits (B,D,V), optional learned positions and
                  lambda_u-gated co-occurrence bias (`use_pairwise`)
  KinFormer:      vt (B,D,Fc), optional lambda_u-gated Lund bias
                  (`use_pairwise`)

`KinFormer._lund_bias` is the span `kinformer.lund_bias`, and while
tracing is on (`utils/profiling.py`) it counts `lund.pairs`, the pair
rows fed through its pair MLP (B T T a forward), and `lund.forwards`; the
pair MLP (`ops/lund_pair_mlp.py`) counts its forwards by route
(`lund_mlp.kernel`, `lund_mlp.plain`).

Module names mirror the flax parameter tree (`block_x_0`, `ln1_x`,
`coocc/wue`, `lambda_u`, ...) so `convert.params_from_flax` is a rename.
The pad mask enters as a compact key mask, as (B, T) segment ids on
packed rows, or, with a pairwise bias, folded into that bias as the
additive pair mask.  `Config.dropout` acts in train mode only
(`module.train()`): on the embeddings here, and inside the blocks on the
attention probabilities, the attention output and the MLP output.

`Config.compute_dtype="bfloat16"` runs every layer in bf16 where the JAX
package's `dtype=` does (`models.blocks`: `Dense`, `embed`, `LayerNorm`,
`gelu`): the input kinematics are cast at the input, the time embedding
is cast after its fp32 sines, the attention takes bf16 q/k/v (K1 and K2 in
bf16 on CUDA) and the pairwise biases come out fp32 as in JAX.  Parameters
stay fp32.  The heads' final `proj` computes in fp32, so the drift and the
logits that reach the solver and the losses are fp32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.models.attention import SelfAttnBlock
from multimodal_flows_tpu_torch.models.blocks import (
    Dense,
    Dropout,
    LayerNorm,
    compute_dtype,
    embed,
    gelu,
    key_mask_bias,
    pair_mask_bias,
    time_token_embedding,
)
from multimodal_flows_tpu_torch.ops.lund_pair_mlp import PairMLP, lund_pair_mlp, plain_pair_bias
from multimodal_flows_tpu_torch.utils.profiling import count, declare, spanned, tracing

Tensor = torch.Tensor

declare("lund", "pairs", "forwards")   # while tracing is on


class _EmbedMLP(nn.Module):
    """Linear/Embed -> exact GELU -> Linear feature embedder, in `dtype`."""

    def __init__(self, n_hidden: int, n_out: int, *, n_in: Optional[int] = None,
                 vocab_size: Optional[int] = None, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if vocab_size is not None:
            self.embed = nn.Embedding(vocab_size, n_hidden)
        else:
            self.fc = Dense(n_in, n_hidden, bias=bias, dtype=dtype)
        self.proj = Dense(n_hidden, n_out, bias=bias, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        h = embed(self.embed, x, self.dtype) if hasattr(self, "embed") else self.fc(x)
        return self.proj(gelu(h))


class _Head(nn.Module):
    """Linear (in `dtype`) -> exact GELU -> Linear output head, the final
    projection in fp32 whatever `dtype` is (the JAX package's `_Head`)."""

    def __init__(self, n_embd: int, n_inner: int, n_out: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = Dense(n_embd, n_inner, bias=bias, dtype=dtype)
        self.proj = Dense(n_inner, n_out, bias=bias, dtype=torch.float32)

    def forward(self, x: Tensor) -> Tensor:
        return self.proj(gelu(self.fc(x)))


class _CoOccurrenceBias(nn.Module):
    """Symmetric token co-occurrence bias via triangle-number pair ids.
    The (n_pairs, E) table is projected to the H heads first (45 rows at
    V = 9), then gathered: no (B, D, D, E) tensor.  The table and its
    projection compute in `dtype`; the bias is returned as (B, H, D, D)
    fp32, as in JAX, a view whose key axis has stride 1 (what K2 reads
    along).  Under tensor parallelism `wue_proj` is column-parallel over
    the heads, so H is this rank's share and the bias comes out
    contiguous."""

    def __init__(self, vocab_size: int, n_embd: int, n_head: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n_pairs = vocab_size * (vocab_size + 1) // 2
        self.wue = nn.Embedding(n_pairs, n_embd)
        self.wue_proj = Dense(n_embd, n_head, dtype=dtype)

    def forward(self, tokens: Tensor) -> Tensor:                      # tokens (B, D)
        i, j = tokens[:, :, None].long(), tokens[:, None, :].long()
        lo, hi = torch.minimum(i, j), torch.maximum(i, j)
        pair_idx = hi * (hi + 1) // 2 + lo                             # (B, D, D)
        table = self.wue_proj(self.wue.weight.to(self.wue_proj.compute_dtype))
        table = table.to(torch.float32)                                # (P, H)
        return table.t()[:, pair_idx].transpose(0, 1)                  # (B, H, D, D)


def _blocks(module: nn.Module, prefix: str, n: int):
    return [getattr(module, f"{prefix}_{i}") for i in range(n)]


def _mask_inputs(state: MultiModal, segments: Optional[Tensor], bias: Optional[Tensor]):
    """(attn_bias, key_mask, segments) for the blocks.  Segments (packed
    rows) replace every pad mask; a pairwise bias takes the pad pair mask
    in (then there is no key mask); else the compact key mask."""
    if segments is not None:
        return bias, None, segments.to(torch.int32).contiguous()
    if bias is not None:
        return pair_mask_bias(state.mask) + bias, None, None
    return None, key_mask_bias(state.mask), None


class ParticleFormer(nn.Module):
    """Dual-stream multimodal transformer: per-modality half-width stacks
    with the time embedding re-added after every block, concatenated into
    full-width fused blocks, split back with modality skip connections
    into drift and logit heads."""

    #: takes packed multi-jet rows (segment ids), through its attention's
    #: block-diagonal segment mask
    packable = True

    def __init__(self, config: Config):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dt = compute_dtype(cfg.compute_dtype)
        half = cfg.n_embd // 2
        head_inner = cfg.n_inner or 4 * half

        if cfg.use_coocurrence:
            self.coocc = _CoOccurrenceBias(cfg.vocab_size, cfg.n_embd, cfg.n_head, dt)
        self.wxe = _EmbedMLP(cfg.n_embd, half, n_in=cfg.dim_continuous, bias=cfg.bias, dtype=dt)
        self.ln1_x = LayerNorm(half, dtype=dt)
        self.wye = _EmbedMLP(cfg.n_embd, half, vocab_size=cfg.vocab_size, bias=cfg.bias,
                             dtype=dt)
        self.ln1_y = LayerNorm(half, dtype=dt)
        for s in ("x", "y"):
            for i in range(cfg.n_layer):
                self.add_module(f"block_{s}_{i}", _block(cfg, half, dt))
        self.ln2_x = LayerNorm(half, dtype=dt)
        self.ln2_y = LayerNorm(half, dtype=dt)
        self.time_expand = Dense(half, cfg.n_embd, dtype=dt)
        self.drop = Dropout(cfg.dropout)
        for i in range(cfg.n_layer_fused):
            self.add_module(f"block_fuse_{i}", _block(cfg, cfg.n_embd, dt))
        self.ln3_x = LayerNorm(half, dtype=dt)
        self.ln3_y = LayerNorm(half, dtype=dt)
        self.head_x = _Head(half, head_inner, cfg.dim_continuous, cfg.bias, dt)
        self.head_y = _Head(half, head_inner, cfg.vocab_size, cfg.bias, dt)

    def forward(self, state: MultiModal, segments: Optional[Tensor] = None,
                num_segments: Optional[int] = None):  # num_segments: EPiC only
        """`segments` (B, T) int ids of packed multi-jet rows (pads -1)
        replace the pad masks: attention is restricted to same-segment
        pairs, which subsumes pad masking."""
        cfg = self.config
        half = cfg.n_embd // 2
        coocc = self.coocc(state.discrete[..., 0]) if cfg.use_coocurrence else None
        bias, key_mask, segments = _mask_inputs(state, segments, coocc)

        time_emb = time_token_embedding(state.time, half, self.dtype)  # (B,1|T,half)

        x = self.drop(self.ln1_x(self.wxe(state.continuous.to(self.dtype))) + time_emb)
        x_skip = x
        for blk in _blocks(self, "block_x", cfg.n_layer):
            x = blk(x, bias, key_mask, segments) + time_emb
        x = self.ln2_x(x + x_skip)

        y = self.drop(self.ln1_y(self.wye(state.discrete[..., 0])) + time_emb)
        y_skip = y
        for blk in _blocks(self, "block_y", cfg.n_layer):
            y = blk(y, bias, key_mask, segments) + time_emb
        y = self.ln2_y(y + y_skip)

        z = torch.cat([x, y], dim=-1)
        time_emb2 = self.time_expand(time_emb)
        z = self.drop(z + time_emb2)
        for blk in _blocks(self, "block_fuse", cfg.n_layer_fused):
            z = blk(z, bias, key_mask, segments) + time_emb2

        x, y = z.split(half, dim=-1)
        x = self.ln3_x(x + x_skip)
        y = self.ln3_y(y + y_skip)
        return self.head_x(x), self.head_y(y)


class FusedParticleFormer(nn.Module):
    """Single-stream variant: both modalities are embedded at half width,
    concatenated and run through `n_layer` full-width blocks, then split
    into the two heads.  It has no pairwise bias, so on CUDA every block's
    attention is K1: its key-mask form on padded jets, its segment form on
    packed rows."""

    #: takes packed multi-jet rows (segment ids), through its attention's
    #: block-diagonal segment mask
    packable = True

    def __init__(self, config: Config):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dt = compute_dtype(cfg.compute_dtype)
        half = cfg.n_embd // 2
        head_inner = cfg.n_inner or 2 * cfg.n_embd
        self.wxe = _EmbedMLP(cfg.n_embd, half, n_in=cfg.dim_continuous, bias=cfg.bias, dtype=dt)
        self.ln1_x = LayerNorm(half, dtype=dt)
        self.wye = _EmbedMLP(cfg.n_embd, half, vocab_size=cfg.vocab_size, bias=cfg.bias,
                             dtype=dt)
        self.ln1_y = LayerNorm(half, dtype=dt)
        self.drop = Dropout(cfg.dropout)
        for i in range(cfg.n_layer):
            self.add_module(f"block_{i}", _block(cfg, cfg.n_embd, dt))
        self.ln2 = LayerNorm(cfg.n_embd, dtype=dt)
        self.head_x = _Head(half, head_inner, cfg.dim_continuous, cfg.bias, dt)
        self.head_y = _Head(half, head_inner, cfg.vocab_size, cfg.bias, dt)

    def forward(self, state: MultiModal, segments: Optional[Tensor] = None,
                num_segments: Optional[int] = None):  # num_segments: EPiC only
        cfg = self.config
        _, key_mask, segments = _mask_inputs(state, segments, None)
        x = self.ln1_x(self.wxe(state.continuous.to(self.dtype)))
        y = self.ln1_y(self.wye(state.discrete[..., 0]))
        time_emb = time_token_embedding(state.time, cfg.n_embd, self.dtype)
        z = self.drop(torch.cat([x, y], dim=-1) + time_emb)
        z_skip = z
        for blk in _blocks(self, "block", cfg.n_layer):
            z = blk(z, None, key_mask, segments) + time_emb
        x, y = self.ln2(z + z_skip).split(cfg.n_embd // 2, dim=-1)
        return self.head_x(x), self.head_y(y)


def _pos_embedding(wpe: nn.Embedding, width: int, dtype: torch.dtype) -> Tensor:
    """Rows 0..width-1 of the learned position table in `dtype`: slots are
    first-n filled, so they are the right rows at any (bucket) width."""
    return wpe.weight[:width][None, :, :].to(dtype)


def _block(cfg: Config, width: int, dtype: torch.dtype) -> SelfAttnBlock:
    return SelfAttnBlock(width, cfg.n_head, cfg.n_inner, cfg.bias, cfg.qk_layernorm,
                         cfg.dropout, dtype=dtype)


class FlavorFormer(nn.Module):
    """Discrete-only encoder for MJB, with optional learned positional
    embedding and lambda_u-gated co-occurrence bias."""

    #: takes packed multi-jet rows (segment ids), through its attention's
    #: block-diagonal segment mask
    packable = True

    def __init__(self, config: Config):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dt = compute_dtype(cfg.compute_dtype)
        if cfg.use_pairwise:
            self.lambda_u = nn.Parameter(torch.zeros(()))
            self.pairwise = _CoOccurrenceBias(cfg.vocab_size, cfg.n_embd, cfg.n_head, dt)
        self.wte = _EmbedMLP(cfg.n_embd, cfg.n_embd, vocab_size=cfg.vocab_size, bias=cfg.bias,
                             dtype=dt)
        self.ln1 = LayerNorm(cfg.n_embd, dtype=dt)
        if cfg.use_pos_emb:
            self.wpe = nn.Embedding(cfg.max_num_particles, cfg.n_embd)
        for i in range(cfg.n_layer):
            self.add_module(f"block_{i}", _block(cfg, cfg.n_embd, dt))
        self.ln2 = LayerNorm(cfg.n_embd, dtype=dt)
        self.drop = Dropout(cfg.dropout)
        self.head = _Head(cfg.n_embd, cfg.n_inner or 4 * cfg.n_embd, cfg.vocab_size, cfg.bias,
                          dt)

    def forward(self, state: MultiModal, segments: Optional[Tensor] = None,
                num_segments: Optional[int] = None) -> Tensor:  # num_segments: EPiC only
        cfg = self.config
        if segments is not None and cfg.use_pos_emb:
            raise ValueError("packed rows (segments) are incompatible with "
                             "learned positional embeddings")
        tokens = state.discrete[..., 0]
        u_bias = self.lambda_u * self.pairwise(tokens) if cfg.use_pairwise else None
        bias, key_mask, segments = _mask_inputs(state, segments, u_bias)

        tok = self.ln1(self.wte(tokens))
        time_emb = time_token_embedding(state.time, cfg.n_embd, self.dtype)
        if cfg.use_pos_emb:
            tok = tok + _pos_embedding(self.wpe, tok.shape[1], self.dtype)
        f = self.drop(tok + time_emb)
        for blk in _blocks(self, "block", cfg.n_layer):
            f = blk(f, bias, key_mask, segments) + time_emb
        f = self.ln2(f + tok)
        return self.head(f)


def lund_observables(state: MultiModal, mu: Sequence[float], sig: Sequence[float]) -> Tensor:
    """Pairwise Lund-plane observables (log kT, log dR) (B, D, D, 2) from
    standardized kinematics: destandardized with the dataset metadata,
    pads masked, each pair normalized over its two observables (population
    std).  Eps-regularized as in JAX: log(dR + 1e-8) on the self-pair
    diagonal, a guarded pt_i pt_j denominator on pad pairs."""
    kin = state.continuous.to(torch.float32)
    dim = kin.shape[-1]
    mu = torch.as_tensor(mu, dtype=torch.float32, device=kin.device).reshape(1, 1, dim)
    sig = torch.as_tensor(sig, dtype=torch.float32, device=kin.device).reshape(1, 1, dim)
    kin = (kin * sig + mu) * state.mask

    pt_i, pt_j = kin[..., 0][:, :, None], kin[..., 0][:, None, :]
    eta_i, eta_j = kin[..., 1][:, :, None], kin[..., 1][:, None, :]
    phi_i, phi_j = kin[..., 2][:, :, None], kin[..., 2][:, None, :]

    deta = eta_i - eta_j
    dphi = torch.remainder(phi_i - phi_j + math.pi, 2 * math.pi) - math.pi
    dR = torch.sqrt(deta ** 2 + dphi ** 2)
    log_dR = torch.log(dR + 1e-8)
    kt_arg = torch.minimum(pt_i, pt_j) * dR ** 2 / (pt_i * pt_j + 1e-12)
    log_kt = torch.log(torch.clamp(kt_arg, min=0.0) + 1e-8)
    U = torch.stack([log_kt, log_dR], dim=-1)
    return ((U - U.mean(dim=-1, keepdim=True))
            / (U.std(dim=-1, keepdim=True, correction=0) + 1e-8))


class KinFormer(nn.Module):
    """Continuous-only encoder for CFM, with optional lambda_u-gated Lund
    pairwise bias.  The pair MLP (`ops/lund_pair_mlp.py`) runs as one fused
    kernel on fp32 CUDA tensors; elsewhere in query-row chunks of
    `pair_chunk` (peak pair-hidden memory chunk/D of the unchunked form),
    each chunk symmetrized as 0.5 (f(U) + f(U^T)) rows: exactly the
    unchunked form.  The kernel takes n_embd 256 and at most 4 heads, and
    raises on others."""

    #: takes packed multi-jet rows (segment ids), through its attention's
    #: block-diagonal segment mask
    packable = True

    def __init__(self, config: Config):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dt = compute_dtype(cfg.compute_dtype)
        if cfg.use_pairwise:
            self.lambda_u = nn.Parameter(torch.zeros(()))
            self.wue_fc = Dense(2, cfg.n_embd, dtype=dt)
            # flax's bare nn.LayerNorm: eps 1e-6
            self.wue_ln = LayerNorm(cfg.n_embd, dtype=dt, eps=1e-6)
            self.wue_proj_fc = Dense(cfg.n_embd, cfg.n_embd, bias=cfg.bias, dtype=dt)
            self.wue_proj_out = Dense(cfg.n_embd, cfg.n_head, bias=cfg.bias, dtype=dt)
        self.wxe = _EmbedMLP(cfg.n_embd, cfg.n_embd, n_in=cfg.dim_continuous, bias=cfg.bias,
                             dtype=dt)
        self.ln1 = LayerNorm(cfg.n_embd, dtype=dt)
        if cfg.use_pos_emb:
            self.wpe = nn.Embedding(cfg.max_num_particles, cfg.n_embd)
        for i in range(cfg.n_layer):
            self.add_module(f"block_{i}", _block(cfg, cfg.n_embd, dt))
        self.ln2 = LayerNorm(cfg.n_embd, dtype=dt)
        self.drop = Dropout(cfg.dropout)
        self.head = _Head(cfg.n_embd, cfg.n_inner or 4 * cfg.n_embd, cfg.dim_continuous,
                          cfg.bias, dt)

    @spanned("kinformer.lund_bias")
    def _lund_bias(self, state: MultiModal) -> Tensor:
        """lambda_u * pair-MLP(Lund observables), (B, H, D, D).  In fp32
        through `ops/lund_pair_mlp.py` (the fused kernel on CUDA tensors,
        the plain version on the CPU); in bf16, or under a tensor-parallel
        layout (`wue_proj_out` cut over the heads, its layer doing a
        collective the kernel does not), the plain version over the
        model's own layers.  The plain version runs in chunks of
        `pair_chunk` query rows."""
        cfg = self.config
        meta = cfg.metadata or {}
        U = lund_observables(state, meta.get("mean", [0.0] * cfg.dim_continuous),
                             meta.get("std", [1.0] * cfg.dim_continuous))
        if tracing():
            count("lund.pairs", U.shape[0] * U.shape[1] ** 2)
            count("lund.forwards")
        if self.dtype == torch.float32 and not hasattr(self.wue_proj_out.weight, "tp_split"):
            fc, ln, proj, out = self.wue_fc, self.wue_ln, self.wue_proj_fc, self.wue_proj_out
            return lund_pair_mlp(U, PairMLP(fc.weight, fc.bias, ln.weight, ln.bias, proj.weight,
                                            proj.bias, out.weight, out.bias, self.lambda_u,
                                            ln.eps), cfg.pair_chunk)
        return plain_pair_bias(U.to(self.dtype), lambda u: self.wue_ln(gelu(self.wue_fc(u))),
                               lambda x: self.wue_proj_out(gelu(self.wue_proj_fc(x))),
                               self.lambda_u, cfg.pair_chunk)

    def forward(self, state: MultiModal, segments: Optional[Tensor] = None,
                num_segments: Optional[int] = None) -> Tensor:  # num_segments: EPiC only
        cfg = self.config
        if segments is not None and cfg.use_pos_emb:
            raise ValueError("packed rows (segments) are incompatible with "
                             "learned positional embeddings")
        lund = self._lund_bias(state) if cfg.use_pairwise else None
        bias, key_mask, segments = _mask_inputs(state, segments, lund)

        x = self.ln1(self.wxe(state.continuous.to(self.dtype)))
        time_emb = time_token_embedding(state.time, cfg.n_embd, self.dtype)
        if cfg.use_pos_emb:
            x = x + _pos_embedding(self.wpe, x.shape[1], self.dtype)
        h = self.drop(x + time_emb)
        h_skip = h
        for blk in _blocks(self, "block", cfg.n_layer):
            h = blk(h, bias, key_mask, segments) + time_emb
        h = self.ln2(h + h_skip)
        return self.head(h)
