"""The set encoders (PyTorch port of
`multimodal_flows_tpu/models/particle_transformers.py`).

  ParticleFormer: (vt (B,D,Fc), logits (B,D,V)), optional token
                  co-occurrence bias (`use_coocurrence`)
  FusedParticleFormer: the same heads from one full-width stream
  FlavorFormer:   logits (B,D,V), optional learned positions and
                  lambda_u-gated co-occurrence bias (`use_pairwise`)
  KinFormer:      vt (B,D,Fc), optional lambda_u-gated Lund bias
                  (`use_pairwise`)

Module names mirror the flax parameter tree (`block_x_0`, `ln1_x`,
`coocc/wue`, `lambda_u`, ...) so `convert.params_from_flax` is a rename.
The pad mask enters as a compact key mask, as (B, T) segment ids on
packed rows, or, with a pairwise bias, folded into that bias as the
additive pair mask.  `Config.dropout` acts in train mode only
(`module.train()`): on the embeddings here, and inside the blocks on the
attention probabilities, the attention output and the MLP output.  bf16
compute is not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.models.attention import SelfAttnBlock
from multimodal_flows_tpu_torch.models.blocks import (
    Dropout,
    LayerNorm,
    key_mask_bias,
    pair_mask_bias,
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


class _CoOccurrenceBias(nn.Module):
    """Symmetric token co-occurrence bias via triangle-number pair ids.
    The (n_pairs, E) table is projected to the H heads first (45 rows at
    V = 9), then gathered: no (B, D, D, E) tensor.  Returns (B, H, D, D)
    fp32, a view whose key axis has stride 1 (what K2 reads along)."""

    def __init__(self, vocab_size: int, n_embd: int, n_head: int):
        super().__init__()
        n_pairs = vocab_size * (vocab_size + 1) // 2
        self.wue = nn.Embedding(n_pairs, n_embd)
        self.wue_proj = nn.Linear(n_embd, n_head)

    def forward(self, tokens: Tensor) -> Tensor:                      # tokens (B, D)
        i, j = tokens[:, :, None].long(), tokens[:, None, :].long()
        lo, hi = torch.minimum(i, j), torch.maximum(i, j)
        pair_idx = hi * (hi + 1) // 2 + lo                             # (B, D, D)
        table = self.wue_proj(self.wue.weight).to(torch.float32)       # (P, H)
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

    def __init__(self, config: Config):
        super().__init__()
        cfg = config
        if cfg.compute_dtype != "float32":
            raise NotImplementedError("bf16 compute is not ported yet (ROADMAP.md Queue 2)")
        self.config = cfg
        half = cfg.n_embd // 2
        head_inner = cfg.n_inner or 4 * half

        if cfg.use_coocurrence:
            self.coocc = _CoOccurrenceBias(cfg.vocab_size, cfg.n_embd, cfg.n_head)
        self.wxe = _EmbedMLP(cfg.n_embd, half, n_in=cfg.dim_continuous, bias=cfg.bias)
        self.ln1_x = LayerNorm(half)
        self.wye = _EmbedMLP(cfg.n_embd, half, vocab_size=cfg.vocab_size, bias=cfg.bias)
        self.ln1_y = LayerNorm(half)
        for s in ("x", "y"):
            for i in range(cfg.n_layer):
                self.add_module(f"block_{s}_{i}", SelfAttnBlock(
                    half, cfg.n_head, cfg.n_inner, cfg.bias, cfg.qk_layernorm, cfg.dropout))
        self.ln2_x = LayerNorm(half)
        self.ln2_y = LayerNorm(half)
        self.time_expand = nn.Linear(half, cfg.n_embd)
        self.drop = Dropout(cfg.dropout)
        for i in range(cfg.n_layer_fused):
            self.add_module(f"block_fuse_{i}", SelfAttnBlock(
                cfg.n_embd, cfg.n_head, cfg.n_inner, cfg.bias, cfg.qk_layernorm, cfg.dropout))
        self.ln3_x = LayerNorm(half)
        self.ln3_y = LayerNorm(half)
        self.head_x = _Head(half, head_inner, cfg.dim_continuous, cfg.bias)
        self.head_y = _Head(half, head_inner, cfg.vocab_size, cfg.bias)

    def forward(self, state: MultiModal, segments: Optional[Tensor] = None,
                num_segments: Optional[int] = None):  # num_segments: EPiC only
        """`segments` (B, T) int ids of packed multi-jet rows (pads -1)
        replace the pad masks: attention is restricted to same-segment
        pairs, which subsumes pad masking."""
        cfg = self.config
        half = cfg.n_embd // 2
        coocc = self.coocc(state.discrete[..., 0]) if cfg.use_coocurrence else None
        bias, key_mask, segments = _mask_inputs(state, segments, coocc)

        time_emb = time_token_embedding(state.time, half)            # (B,1|T,half)

        x = self.drop(self.ln1_x(self.wxe(state.continuous.to(torch.float32))) + time_emb)
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

    def __init__(self, config: Config):
        super().__init__()
        cfg = config
        if cfg.compute_dtype != "float32":
            raise NotImplementedError("bf16 compute is not ported yet (ROADMAP.md Queue 2)")
        self.config = cfg
        half = cfg.n_embd // 2
        head_inner = cfg.n_inner or 2 * cfg.n_embd
        self.wxe = _EmbedMLP(cfg.n_embd, half, n_in=cfg.dim_continuous, bias=cfg.bias)
        self.ln1_x = LayerNorm(half)
        self.wye = _EmbedMLP(cfg.n_embd, half, vocab_size=cfg.vocab_size, bias=cfg.bias)
        self.ln1_y = LayerNorm(half)
        self.drop = Dropout(cfg.dropout)
        for i in range(cfg.n_layer):
            self.add_module(f"block_{i}", SelfAttnBlock(
                cfg.n_embd, cfg.n_head, cfg.n_inner, cfg.bias, cfg.qk_layernorm, cfg.dropout))
        self.ln2 = LayerNorm(cfg.n_embd)
        self.head_x = _Head(half, head_inner, cfg.dim_continuous, cfg.bias)
        self.head_y = _Head(half, head_inner, cfg.vocab_size, cfg.bias)

    def forward(self, state: MultiModal, segments: Optional[Tensor] = None,
                num_segments: Optional[int] = None):  # num_segments: EPiC only
        cfg = self.config
        _, key_mask, segments = _mask_inputs(state, segments, None)
        x = self.ln1_x(self.wxe(state.continuous.to(torch.float32)))
        y = self.ln1_y(self.wye(state.discrete[..., 0]))
        time_emb = time_token_embedding(state.time, cfg.n_embd)
        z = self.drop(torch.cat([x, y], dim=-1) + time_emb)
        z_skip = z
        for blk in _blocks(self, "block", cfg.n_layer):
            z = blk(z, None, key_mask, segments) + time_emb
        x, y = self.ln2(z + z_skip).split(cfg.n_embd // 2, dim=-1)
        return self.head_x(x), self.head_y(y)


def _pos_embedding(wpe: nn.Embedding, width: int) -> Tensor:
    """Rows 0..width-1 of the learned position table: slots are first-n
    filled, so they are the right rows at any (bucket) width."""
    return wpe.weight[:width][None, :, :]


class FlavorFormer(nn.Module):
    """Discrete-only encoder for MJB, with optional learned positional
    embedding and lambda_u-gated co-occurrence bias."""

    def __init__(self, config: Config):
        super().__init__()
        cfg = config
        if cfg.compute_dtype != "float32":
            raise NotImplementedError("bf16 compute is not ported yet (ROADMAP.md Queue 2)")
        self.config = cfg
        if cfg.use_pairwise:
            self.lambda_u = nn.Parameter(torch.zeros(()))
            self.pairwise = _CoOccurrenceBias(cfg.vocab_size, cfg.n_embd, cfg.n_head)
        self.wte = _EmbedMLP(cfg.n_embd, cfg.n_embd, vocab_size=cfg.vocab_size, bias=cfg.bias)
        self.ln1 = LayerNorm(cfg.n_embd)
        if cfg.use_pos_emb:
            self.wpe = nn.Embedding(cfg.max_num_particles, cfg.n_embd)
        for i in range(cfg.n_layer):
            self.add_module(f"block_{i}", SelfAttnBlock(
                cfg.n_embd, cfg.n_head, cfg.n_inner, cfg.bias, cfg.qk_layernorm, cfg.dropout))
        self.ln2 = LayerNorm(cfg.n_embd)
        self.drop = Dropout(cfg.dropout)
        self.head = _Head(cfg.n_embd, cfg.n_inner or 4 * cfg.n_embd, cfg.vocab_size, cfg.bias)

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
        time_emb = time_token_embedding(state.time, cfg.n_embd)
        if cfg.use_pos_emb:
            tok = tok + _pos_embedding(self.wpe, tok.shape[1])
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
    pairwise bias.  The pair MLP runs in query-row chunks of `pair_chunk`
    (peak pair-hidden memory chunk/D of the unchunked form), each chunk
    symmetrized as 0.5 (f(U) + f(U^T)) rows: exactly the unchunked form."""

    def __init__(self, config: Config):
        super().__init__()
        cfg = config
        if cfg.compute_dtype != "float32":
            raise NotImplementedError("bf16 compute is not ported yet (ROADMAP.md Queue 2)")
        self.config = cfg
        if cfg.use_pairwise:
            self.lambda_u = nn.Parameter(torch.zeros(()))
            self.wue_fc = nn.Linear(2, cfg.n_embd)
            self.wue_ln = nn.LayerNorm(cfg.n_embd, eps=1e-6)  # flax nn.LayerNorm's eps
            self.wue_proj_fc = nn.Linear(cfg.n_embd, cfg.n_embd, bias=cfg.bias)
            self.wue_proj_out = nn.Linear(cfg.n_embd, cfg.n_head, bias=cfg.bias)
        self.wxe = _EmbedMLP(cfg.n_embd, cfg.n_embd, n_in=cfg.dim_continuous, bias=cfg.bias)
        self.ln1 = LayerNorm(cfg.n_embd)
        if cfg.use_pos_emb:
            self.wpe = nn.Embedding(cfg.max_num_particles, cfg.n_embd)
        for i in range(cfg.n_layer):
            self.add_module(f"block_{i}", SelfAttnBlock(
                cfg.n_embd, cfg.n_head, cfg.n_inner, cfg.bias, cfg.qk_layernorm, cfg.dropout))
        self.ln2 = LayerNorm(cfg.n_embd)
        self.drop = Dropout(cfg.dropout)
        self.head = _Head(cfg.n_embd, cfg.n_inner or 4 * cfg.n_embd, cfg.dim_continuous,
                          cfg.bias)

    def _lund_bias(self, state: MultiModal) -> Tensor:
        """lambda_u * pair-MLP(Lund observables), (B, H, D, D)."""
        cfg = self.config
        meta = cfg.metadata or {}
        U = lund_observables(state, meta.get("mean", [0.0] * cfg.dim_continuous),
                             meta.get("std", [1.0] * cfg.dim_continuous))

        def stage1(u):
            return self.wue_ln(F.gelu(self.wue_fc(u)))

        D = U.shape[1]
        c = cfg.pair_chunk if cfg.pair_chunk and cfg.pair_chunk > 0 else D
        Ut = U.transpose(1, 2)
        outs = [self.wue_proj_out(F.gelu(self.wue_proj_fc(
                    0.5 * (stage1(U[:, a:a + c]) + stage1(Ut[:, a:a + c])))))
                for a in range(0, D, c)]
        u = torch.cat(outs, dim=1)                                     # (B, D, D, H)
        return self.lambda_u * u.permute(0, 3, 1, 2).to(torch.float32).contiguous()

    def forward(self, state: MultiModal, segments: Optional[Tensor] = None,
                num_segments: Optional[int] = None) -> Tensor:  # num_segments: EPiC only
        cfg = self.config
        if segments is not None and cfg.use_pos_emb:
            raise ValueError("packed rows (segments) are incompatible with "
                             "learned positional embeddings")
        lund = self._lund_bias(state) if cfg.use_pairwise else None
        bias, key_mask, segments = _mask_inputs(state, segments, lund)

        x = self.ln1(self.wxe(state.continuous.to(torch.float32)))
        time_emb = time_token_embedding(state.time, cfg.n_embd)
        if cfg.use_pos_emb:
            x = x + _pos_embedding(self.wpe, x.shape[1])
        h = self.drop(x + time_emb)
        h_skip = h
        for blk in _blocks(self, "block", cfg.n_layer):
            h = blk(h, bias, key_mask, segments) + time_emb
        h = self.ln2(h + h_skip)
        return self.head(h)
