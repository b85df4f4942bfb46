"""Masked set pooling (PyTorch port of `multimodal_flows_tpu/ops/pooling.py`),
the global stream of EPiC: masked mean and scaled sum over the particle
axis, per row or per jet of a packed row, concatenated with any global
features.  Plain PyTorch on every device: the JAX package computes these
in XLA, outside any Pallas kernel.  On CUDA `index_add_` sums by atomics,
so the per-jet sums change in the last bits from run to run.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def masked_meansum_pool(mask: Tensor, x_local: Tensor, *x_global: Tensor,
                        scale: float = 0.01) -> Tensor:
    """mask: (B, D, 1); x_local: (B, D, F); x_global: any number of (B, G).

    Returns (B, 2F + sum(G)): [masked mean, masked sum * scale, *globals].
    The sum is scaled by 0.01 as in EPiC-GAN to keep magnitudes comparable.
    """
    m = mask.to(x_local.dtype)
    x_sum = (x_local * m).sum(dim=1)                         # (B, F)
    x_mean = x_sum / m.sum(dim=1)                            # (B, 1) counts
    return torch.cat([x_mean, x_sum * scale, *x_global], dim=-1)


def segment_meansum_pool(segments: Tensor, x_local: Tensor, *x_global: Tensor,
                         num_segments: int, scale: float = 0.01) -> Tensor:
    """Per-jet mean+sum pooling over packed multi-jet rows: the segment
    twin of `masked_meansum_pool`.

    segments: (B, W) within-row jet ids (pad slots -1, routed to an
    overflow slot and dropped); x_local: (B, W, F); x_global: any number
    of (B, J, G) per-jet globals.  Returns (B, J, 2F + sum(G)); an empty
    slot pools to 0.  One flattened `index_add_` per call.
    """
    B, W = segments.shape
    J = num_segments
    slot = torch.where(segments >= 0, segments, J).long()
    gid = (torch.arange(B, device=segments.device)[:, None] * (J + 1) + slot).reshape(-1)
    flat = x_local.reshape(B * W, -1)
    ones = torch.ones((B * W, 1), dtype=x_local.dtype, device=x_local.device)
    pooled = torch.zeros((B * (J + 1), flat.shape[1] + 1), dtype=x_local.dtype,
                         device=x_local.device)
    pooled.index_add_(0, gid, torch.cat([flat, ones], dim=-1))
    pooled = pooled.reshape(B, J + 1, -1)[:, :J]
    x_sum, counts = pooled[..., :-1], pooled[..., -1:]
    x_mean = x_sum / counts.clamp(min=1.0)                   # empty slots -> 0
    return torch.cat([x_mean, x_sum * scale, *x_global], dim=-1)


def segment_gather(x_global: Tensor, segments: Tensor) -> Tensor:
    """Broadcast per-jet globals (B, J, G) back to tokens (B, W, G) through
    the segment ids (pad slots get jet 0's global; their outputs are
    masked downstream)."""
    slot = segments.clamp(0, x_global.shape[1] - 1).long()
    return torch.gather(x_global, 1, slot[..., None].expand(-1, -1, x_global.shape[-1]))
