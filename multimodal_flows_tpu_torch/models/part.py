"""The Particle Transformer (ParT) of Qu, Li and Qian, "Particle Transformer
for Jet Tagging" (arXiv:2202.03772; weaver-core's
`nn/model/ParticleTransformer.py`: `Embed`, `PairEmbed`, `Block`,
`pairwise_lv_fts`), as a per-particle encoder of the CFM system.

With E = `n_embd`, H = `n_head` (head size E / H), L = `n_layer`,
F = `n_inner`, the pair widths `PAIR_EMBED_DIMS` and `PAIR_FEATURES`
observables (module constants at the published values: `Config` has no
field for them), on standardized kinematics s (B, T, 3), the pad mask m
and the time t:

1. particle embedding (`Embed`): h = BN_in(s); three times
   h = GELU(Linear(LN(h))), widths 3 -> E -> F -> E; x = h m + tau(t);
2. pair observables (`pairwise_lv_fts`, 4 outputs, eps 1e-8) of every slot
   pair, from the destandardized kinematics (`Config.metadata`) as
   massless four-vectors, pads zeroed, self-pairs kept:
   [ln max(ptmin delta, eps), ln max(ptmin / max(pt_i + pt_j, eps), eps),
   ln max(delta, eps), ln max(2 pt_i pt_j (cosh d_eta - cos d_phi), eps)],
   delta = sqrt(d_eta^2 + d_phi^2), d_phi wrapped into [-pi, pi);
3. pair embedding (`PairEmbed`, mode sum, pre-activation output):
   u = BN_p(obs); three times u = GELU(BN(Linear(u))), 4 -> 64 -> 64 -> 64;
   U = BN(Linear(u)), 64 -> H, added unscaled to head h's scores in every
   block;
4. L NormFormer blocks (`Block`): a = MHA(LN(x); U, key mask, segments);
   x = LN(permute(a c_attn)) + x, where head h of a is scaled by
   c_attn[h] and channel d H + h of the result is a[h hs + d] c_attn[h]
   (the published `einsum('tbhd,h->tbdh')`);
   x = Linear_2(LN_F(GELU(Linear_1(LN(x))))) + w_resid x; x = x + tau(t);
5. v = Head(LN_final(x)), the repo's Linear -> GELU -> Linear drift head.

Departures from the published model: (1) the two class-attention blocks and
the classifier are left out (a CFM drift is per particle; those blocks pool
a jet into one token): `LN_final` and the drift head take their place;
(2) the time enters as the repo's CFM encoders take it, the sinusoidal
tau(t) after the embedding and after every block; (3) the particle
features are the flow state's 3 standardized kinematics, and the pair
observables come from them destandardized, as massless four-vectors;
(4) m^2 of a pair is the massless closed form, equal to upstream's
E^2 - |p|^2 in exact arithmetic without its fp32 cancellation;
(5) every BatchNorm is in its inference form, fixed running statistics
(buffers, never trained) and a trained affine, in training too, so a
step's gradients depend neither on pads nor on which jets share a row;
(6) no dropout.

The pad mask enters as the key mask folded into the pair bias on padded
jets, or as (B, T) segment ids on packed rows, where pad slots and other
jets' keys are masked out.  The attention goes through the port's
`SelfAttention` (no qk-LayerNorm), so K2's bias (+ segments) form on CUDA.
The pair embedding is the span `part.pair_embed`, one a forward, and while
tracing is on it counts `part.pairs` (B T^2 a forward) and
`part.forwards`.  fp32 only: other compute dtypes, dropout and learned
positions raise.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.models.attention import SelfAttention
from multimodal_flows_tpu_torch.models.blocks import LayerNorm, time_token_embedding
from multimodal_flows_tpu_torch.models.particle_transformers import _Head, _mask_inputs
from multimodal_flows_tpu_torch.utils.profiling import count, declare, spanned, tracing

Tensor = torch.Tensor

declare("part", "pairs", "forwards")   # while tracing is on

#: the published pair-embedding widths, before the last layer's one output a head
PAIR_EMBED_DIMS = (64, 64, 64)
#: the pair observables (lnkt, lnz, lndelta, lnm2)
PAIR_FEATURES = 4
#: the floor of every logarithm's argument (`pairwise_lv_fts`)
PAIR_EPS = 1e-8
#: BatchNorm's eps (torch's default, as published; LayerNorm's is the same)
NORM_EPS = 1e-5


class BatchNorm(nn.Module):
    """BatchNorm over the last axis in its inference form: (x - running_mean)
    / sqrt(running_var + eps) * weight + bias, in training too.  The
    statistics are buffers and are not trained."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: Tensor) -> Tensor:
        flat = x.reshape(-1, x.shape[-1])
        return F.batch_norm(flat, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=NORM_EPS).reshape(x.shape)


def pair_observables(state: MultiModal, mu, sig) -> Tensor:
    """(B, T, T, 4) [lnkt, lnz, lndelta, lnm2] of every slot pair, from the
    standardized kinematics destandardized with `mu` / `sig` (pads zeroed)
    taken as massless four-vectors (pt, eta, phi)."""
    kin = state.continuous.to(torch.float32)
    dim = kin.shape[-1]
    mu = torch.as_tensor(mu, dtype=torch.float32, device=kin.device).reshape(1, 1, dim)
    sig = torch.as_tensor(sig, dtype=torch.float32, device=kin.device).reshape(1, 1, dim)
    kin = (kin * sig + mu) * state.mask
    pt, eta, phi = kin[..., 0], kin[..., 1], kin[..., 2]
    pt_i, pt_j = pt[:, :, None], pt[:, None, :]
    d_eta = eta[:, :, None] - eta[:, None, :]
    d_phi = torch.remainder(phi[:, :, None] - phi[:, None, :] + math.pi, 2 * math.pi) - math.pi
    delta = torch.sqrt(d_eta ** 2 + d_phi ** 2)
    ptmin = torch.minimum(pt_i, pt_j)
    lnkt = torch.log((ptmin * delta).clamp(min=PAIR_EPS))
    lnz = torch.log((ptmin / (pt_i + pt_j).clamp(min=PAIR_EPS)).clamp(min=PAIR_EPS))
    lndelta = torch.log(delta.clamp(min=PAIR_EPS))
    m2 = 2.0 * pt_i * pt_j * (torch.cosh(d_eta) - torch.cos(d_phi))
    lnm2 = torch.log(m2.clamp(min=PAIR_EPS))
    return torch.stack([lnkt, lnz, lndelta, lnm2], dim=-1)


class _Embed(nn.Module):
    """ParT's `Embed`: BN_in, then LN -> Linear -> GELU for each width."""

    def __init__(self, n_in: int, widths):
        super().__init__()
        self.input_bn = BatchNorm(n_in)
        self.n = len(widths)
        for i, w in enumerate(widths):
            self.add_module(f"ln_{i}", LayerNorm(n_in))
            self.add_module(f"fc_{i}", nn.Linear(n_in, w))
            n_in = w

    def forward(self, x: Tensor) -> Tensor:
        h = self.input_bn(x)
        for i in range(self.n):
            h = F.gelu(getattr(self, f"fc_{i}")(getattr(self, f"ln_{i}")(h)))
        return h


class _PairEmbed(nn.Module):
    """ParT's `PairEmbed` (mode sum, pre-activation output): BN_p, then
    Linear -> BN -> GELU for each width, the last layer without its GELU."""

    def __init__(self, n_in: int, widths):
        super().__init__()
        self.input_bn = BatchNorm(n_in)
        self.n = len(widths)
        for k, w in enumerate(widths):
            self.add_module(f"fc_{k}", nn.Linear(n_in, w))
            self.add_module(f"bn_{k}", BatchNorm(w))
            n_in = w

    def forward(self, obs: Tensor) -> Tensor:
        u = self.input_bn(obs)
        for k in range(self.n):
            u = getattr(self, f"bn_{k}")(getattr(self, f"fc_{k}")(u))
            if k < self.n - 1:
                u = F.gelu(u)
        return u


class _Block(nn.Module):
    """ParT's particle-attention `Block` with every NormFormer scale on:
    post-attention and post-FC LayerNorms, per-head output scales
    `c_attn` and the residual scale `w_resid`."""

    def __init__(self, n_embd: int, n_head: int, n_inner: int):
        super().__init__()
        self.n_head = n_head
        self.pre_attn_norm = LayerNorm(n_embd)
        self.attn = SelfAttention(n_embd, n_head, bias=True, qk_layernorm=False)
        self.post_attn_norm = LayerNorm(n_embd)
        self.pre_fc_norm = LayerNorm(n_embd)
        self.fc1 = nn.Linear(n_embd, n_inner)
        self.post_fc_norm = LayerNorm(n_inner)
        self.fc2 = nn.Linear(n_inner, n_embd)
        self.c_attn = nn.Parameter(torch.ones(n_head))
        self.w_resid = nn.Parameter(torch.ones(n_embd))

    def forward(self, x: Tensor, bias: Optional[Tensor], key_mask: Optional[Tensor],
                segments: Optional[Tensor]) -> Tensor:
        B, T, E = x.shape
        H = self.n_head
        a = self.attn(self.pre_attn_norm(x), bias, key_mask, segments)
        # head h scaled by c_attn[h], channels laid out as (head size, H)
        a = (a.view(B, T, H, E // H) * self.c_attn[:, None]).transpose(2, 3).reshape(B, T, E)
        x = self.post_attn_norm(a) + x
        f = self.fc2(self.post_fc_norm(F.gelu(self.fc1(self.pre_fc_norm(x)))))
        return f + self.w_resid * x


class ParticleTransformer(nn.Module):
    """Continuous-only encoder for CFM: ParT's particle embedding, pair
    embedding and NormFormer blocks, the drift head on every particle."""

    #: takes packed multi-jet rows (segment ids), through its attention's
    #: block-diagonal segment mask and its pair embedding's cross-jet keys
    packable = True

    def __init__(self, config: Config):
        super().__init__()
        cfg = config
        unsupported = {"compute_dtype": cfg.compute_dtype != "float32",
                       "dropout": cfg.dropout > 0, "use_pos_emb": cfg.use_pos_emb}
        for name, bad in unsupported.items():
            if bad:
                raise ValueError(f"ParticleTransformer: {name}={getattr(cfg, name)!r} is not "
                                 "supported (fp32, no dropout, no learned positions)")
        self.config = cfg
        E, inner = cfg.n_embd, cfg.n_inner or 4 * cfg.n_embd
        self.embed = _Embed(cfg.dim_continuous, (E, inner, E))
        self.pair_embed = _PairEmbed(PAIR_FEATURES, PAIR_EMBED_DIMS + (cfg.n_head,))
        for i in range(cfg.n_layer):
            self.add_module(f"block_{i}", _Block(E, cfg.n_head, inner))
        self.norm = LayerNorm(E)
        self.head = _Head(E, inner, cfg.dim_continuous, True)

    @spanned("part.pair_embed")
    def _pair_bias(self, state: MultiModal) -> Tensor:
        """U (B, H, T, T): the pair embedding of every slot pair's
        observables."""
        cfg = self.config
        meta = cfg.metadata or {}
        obs = pair_observables(state, meta.get("mean", [0.0] * cfg.dim_continuous),
                               meta.get("std", [1.0] * cfg.dim_continuous))
        if tracing():
            count("part.pairs", obs.shape[0] * obs.shape[1] ** 2)
            count("part.forwards")
        return self.pair_embed(obs).permute(0, 3, 1, 2).contiguous()

    def forward(self, state: MultiModal, segments: Optional[Tensor] = None,
                num_segments: Optional[int] = None) -> Tensor:  # num_segments: EPiC only
        cfg = self.config
        bias, key_mask, segments = _mask_inputs(state, segments, self._pair_bias(state))
        time_emb = time_token_embedding(state.time, cfg.n_embd)
        x = self.embed(state.continuous.to(torch.float32)) * state.mask + time_emb
        for i in range(cfg.n_layer):
            x = getattr(self, f"block_{i}")(x, bias, key_mask, segments) + time_emb
        return self.head(self.norm(x))
