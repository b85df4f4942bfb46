"""Toy MLP for the 2D tutorial workload (PyTorch port of
`multimodal_flows_tpu/models/toy.py`): Fourier time embedding, the
concatenation [x, one-hot(k), t_emb], a shared trunk of `fc{i}` layers with
exact GELU, and the drift / logit heads `head_x`, `head_y`.  It works on
single-particle clouds (B, 1, F) and has no attention, so it launches no
kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.models.blocks import TimeFourierEmbedding


class ToyMLP(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        self.vocab_size = config.vocab_size
        self.time_embedding = TimeFourierEmbedding(config.n_embd)
        width = config.n_inner or 128
        n_in = config.dim_continuous + config.vocab_size + 2 * (config.n_embd // 2)
        for i in range(max(config.n_layer, 1)):
            self.add_module(f"fc{i}", nn.Linear(n_in if i == 0 else width, width))
        self.n_fc = max(config.n_layer, 1)
        self.head_x = nn.Linear(width, config.dim_continuous)
        self.head_y = nn.Linear(width, config.vocab_size)

    def forward(self, state: MultiModal, segments=None, num_segments=None):
        """(vt (B, D, Fc), logits (B, D, V)); `segments` must be None: a
        per-point model has nothing to pack."""
        if segments is not None:
            raise ValueError("ToyMLP takes no packed rows")
        B, D, _ = state.continuous.shape
        t_emb = self.time_embedding(state.time)[:, None, :].expand(B, D, -1)
        k_onehot = F.one_hot(state.discrete[..., 0].long(), self.vocab_size).to(torch.float32)
        h = torch.cat([state.continuous, k_onehot, t_emb], dim=-1)
        for i in range(self.n_fc):
            h = F.gelu(getattr(self, f"fc{i}")(h))
        return self.head_x(h), self.head_y(h)
