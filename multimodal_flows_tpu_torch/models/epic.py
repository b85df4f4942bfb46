"""EPiC: equivariant point-cloud encoder (PyTorch port of
`multimodal_flows_tpu/models/epic.py`).

A local particle stream and a global jet stream coupled by masked
mean+sum pooling and global -> local broadcast, with weight-normalized
linear layers and local / global skip connections.  Continuous-only (a
drift head).  It has no attention, so it launches no kernel.

With `segments` and a static `num_segments` (the most jets a packed row
holds) the pooling is per jet (`ops.pooling.segment_meansum_pool`) and the
global stream carries one vector per (row, jet slot): several jets share a
row without mixing.

`WNLinear` is flax's `nn.WeightNorm(nn.Dense)`, which is not
`torch.nn.utils.parametrizations.weight_norm`: flax keeps the raw kernel
and a separate per-output-feature `scale` initialised to ones, and
normalises with an epsilon under the root.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.models.blocks import Dropout, timestep_embedding
from multimodal_flows_tpu_torch.ops.pooling import (
    masked_meansum_pool,
    segment_gather,
    segment_meansum_pool,
)

Tensor = torch.Tensor


class WNLinear(nn.Linear):
    """y = x W^T + b with W = v * scale / sqrt(sum_in v^2 + eps): `weight`
    is the raw kernel v (out, in), `scale` (out,) starts at ones, eps
    1e-12.  `init_weights` treats it as a Linear (v ~ N(0, 0.02))."""

    def __init__(self, n_in: int, n_out: int, eps: float = 1e-12):
        super().__init__(n_in, n_out)
        self.scale = nn.Parameter(torch.ones(n_out))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        v = self.weight
        w = v * torch.rsqrt((v * v).sum(dim=1, keepdim=True) + self.eps) * self.scale[:, None]
        return F.linear(x, w, self.bias)


def _broadcast_global(x_global: Tensor, num_particles: int) -> Tensor:
    return x_global[:, None, :].expand(-1, num_particles, -1)


class EPiCProjection(nn.Module):
    """Input projection into the (local, global) streams; `pool` is the
    per-row or the per-segment pooling."""

    def __init__(self, n_time: int, n_in: int, dim_hid_loc: int, dim_hid_glob: int):
        super().__init__()
        self.local_fc1 = WNLinear(n_time + n_in, dim_hid_loc)
        self.local_fc2 = WNLinear(dim_hid_loc, dim_hid_loc)
        self.global_fc1 = WNLinear(2 * dim_hid_loc + n_time, dim_hid_loc)
        self.global_fc2 = WNLinear(dim_hid_loc, dim_hid_glob)

    def forward(self, time: Tensor, x_local: Tensor, x_global: Tensor, pool: Callable):
        h = F.gelu(self.local_fc1(torch.cat([time, x_local], dim=-1)))
        h = F.gelu(self.local_fc2(h))
        g = F.gelu(self.global_fc1(pool(h, x_global)))
        g = F.gelu(self.global_fc2(g))
        return h, g


class EPiCLayer(nn.Module):
    """One equivariant layer: pool -> global MLP (+skip) -> broadcast ->
    local MLP (+skip); `pool` / `bcast` are the per-row or the per-segment
    topology."""

    def __init__(self, n_time: int, dim_loc: int, dim_hid_loc: int, dim_hid_glob: int,
                 dropout: float = 0.0):
        super().__init__()
        self.fc_glob1 = WNLinear(2 * dim_hid_loc + dim_hid_glob, dim_loc)
        self.fc_glob2 = WNLinear(dim_loc, dim_hid_glob)
        self.fc_loc1 = WNLinear(n_time + dim_hid_loc + dim_hid_glob, dim_hid_loc)
        self.fc_loc2 = WNLinear(dim_hid_loc, dim_hid_loc)
        self.drop = Dropout(dropout)

    def forward(self, time: Tensor, x_local: Tensor, x_global: Tensor, pool: Callable,
                bcast: Callable):
        g_hidden = F.leaky_relu(self.fc_glob1(pool(x_local, x_global)))
        x_global = x_global + self.fc_glob2(g_hidden)
        g_out = self.drop(F.leaky_relu(x_global))

        l_hidden = torch.cat([time, x_local, bcast(x_global)], dim=-1)
        l_hidden = F.leaky_relu(self.fc_loc1(l_hidden))
        x_local = x_local + self.fc_loc2(l_hidden)
        l_out = self.drop(F.leaky_relu(x_local))
        return l_out, g_out


class EPiC(nn.Module):
    """The EPiC drift network: vt (B, D, Fc)."""

    def __init__(self, config: Config):
        super().__init__()
        cfg = config
        self.config = cfg
        E, G = cfg.n_embd, cfg.n_embd_glob
        self.wxe = nn.Linear(cfg.dim_continuous, E)
        self.proj = EPiCProjection(E, E, E, G)
        for i in range(cfg.n_layer):
            self.add_module(f"layer_{i}", EPiCLayer(E, E, E, G, cfg.dropout))
        self.head = nn.Linear(E + E + G, cfg.dim_continuous)

    def forward(self, state: MultiModal, segments: Optional[Tensor] = None,
                num_segments: Optional[int] = None) -> Tensor:
        cfg = self.config
        mask = state.mask.to(torch.float32)
        D = state.continuous.shape[1]

        if segments is None:
            # one jet per row: per-row pooling
            def pool(h, g):
                return masked_meansum_pool(mask, h, g)

            def bcast(g):
                return _broadcast_global(g, D)

            time_glob = timestep_embedding(state.time, cfg.n_embd)      # (B, E)
            time_local = _broadcast_global(time_glob, D)                # (B, D, E)
        else:
            # packed rows: per-jet pooling over the segment ids; the global
            # stream is (B, J, *), one slot per jet of the row
            if num_segments is None:
                raise ValueError("EPiC with segments needs num_segments (the most jets a "
                                 "packed row holds)")
            J = num_segments

            def pool(h, g):
                return segment_meansum_pool(segments, h, g, num_segments=J)

            def bcast(g):
                return segment_gather(g, segments)

            # per-token time (packed training: each jet its own t); the
            # per-jet time is the segment mean (all tokens of a jet share
            # t; empty slots get 0 and are never gathered back)
            t_tok = state.time
            if t_tok.ndim == 1:
                t_tok = t_tok[:, None].expand(segments.shape)
            t_jets = segment_meansum_pool(segments, t_tok[..., None].to(torch.float32),
                                          num_segments=J)[..., 0]       # (B, J)
            time_glob = timestep_embedding(t_jets, cfg.n_embd)          # (B, J, E)
            time_local = timestep_embedding(t_tok, cfg.n_embd)          # (B, D, E)

        x_emb = self.wxe(state.continuous.to(torch.float32))
        x_local, x_global = self.proj(time_local, x_emb, time_glob, pool)
        x_local_skip, x_global_skip = x_local, x_global
        for i in range(cfg.n_layer):
            x_local, x_global = getattr(self, f"layer_{i}")(time_local, x_local, x_global,
                                                            pool, bcast)
            x_local = x_local + x_local_skip
            x_global = x_global + x_global_skip
        return self.head(torch.cat([time_local, x_local, bcast(x_global)], dim=-1))
