"""Masked losses and the multitask combination (PyTorch port of
`multimodal_flows_tpu/train/losses.py`).

- `masked_mse` / `masked_ce`: per-jet losses normalised by the jet's
  particle count; pad targets (token 0) are weighted out of the CE.
- `packed_masked_mse` / `packed_masked_ce`: the same per-jet losses over
  packed multi-jet rows, the per-jet sums recovered from the segment ids
  with one `index_add_` over the flattened (row, slot) ids.
- `global_masked_mse` / `global_masked_ce`: the CFM and MJB losses,
  normalised over the whole batch (`multimodal_flows_tpu/train/systems.py`
  computes them inline).

Data parallelism: a rank holds a share of the global batch, and packed
rows carry unequal numbers of jets, so the mean of per-rank weighted means
is not the global weighted mean.  The weighted means therefore take the
denominator `total` from the caller: the global weight (or count) times
the rank's share of the rows, so that the ranks' mean of the returned
losses, and of their gradients, is exactly the global weighted mean.
- `MultiTaskLoss`: `sum`, `weighted` (a learned (2,) log-variance) and
  `time-weighted` (an MLP over the sinusoidal time embedding emits
  per-jet log-variances).  Its parameters sit in the trained module, so
  the optimizer and the checkpoints carry them with the encoder.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_flows_tpu_torch.models.blocks import timestep_embedding

Tensor = torch.Tensor


def masked_mse(pred: Tensor, target: Tensor, mask: Tensor) -> Tensor:
    """pred/target (B, D, F), mask (B, D, 1) -> (B,): the squared error
    summed over particles and features, over the particle count (not
    count * F)."""
    se = (pred - target) ** 2 * mask
    return se.sum(dim=(1, 2)) / mask.sum(dim=(1, 2)).to(se.dtype).clamp(min=1.0)


def _token_nll(logits: Tensor, targets: Tensor, mask: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-token NLL weighted by mask * (target != 0), and the float mask."""
    if targets.dim() == 3:
        targets = targets[..., 0]
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, targets.long().unsqueeze(-1))[..., 0]
    m = mask[..., 0].to(torch.float32)
    return nll * (m * (targets != 0)), m


def masked_ce(logits: Tensor, targets: Tensor, mask: Tensor) -> Tensor:
    """logits (B, D, V), targets (B, D) or (B, D, 1) int, mask (B, D, 1)
    -> (B,): the NLL of real non-pad targets over the particle count."""
    nll, m = _token_nll(logits, targets, mask)
    return nll.sum(dim=1) / m.sum(dim=1).clamp(min=1.0)


def _per_jet_sums(values: Tensor, segments: Tensor, num_slots: int) -> Tensor:
    """Sum per-token `values` (B, W) into per-(row, jet-slot) sums (B, J).

    `segments` (B, W) holds within-row jet ids 0..J-1, pads -1; a pad's
    value goes to an overflow slot that is dropped.  On CUDA `index_add_`
    sums with atomics, so the order of the sum is not fixed."""
    B = segments.shape[0]
    slot = torch.where(segments >= 0, segments, num_slots).long()
    gid = torch.arange(B, device=segments.device)[:, None] * (num_slots + 1) + slot
    sums = values.new_zeros(B * (num_slots + 1))
    sums.index_add_(0, gid.reshape(-1), values.reshape(-1))
    return sums.reshape(B, num_slots + 1)[:, :num_slots]


def packed_masked_mse(pred: Tensor, target: Tensor, mask: Tensor, segments: Tensor,
                      num_slots: int) -> Tensor:
    """`masked_mse` per jet over packed rows: pred/target (B, W, F), mask
    (B, W, 1), segments (B, W) -> (B, J)."""
    se = ((pred - target) ** 2 * mask).sum(dim=-1).to(torch.float32)
    per_jet = _per_jet_sums(se, segments, num_slots)
    counts = _per_jet_sums(mask[..., 0].to(torch.float32), segments, num_slots)
    return per_jet / counts.clamp(min=1.0)


def packed_masked_ce(logits: Tensor, targets: Tensor, mask: Tensor, segments: Tensor,
                     num_slots: int) -> Tensor:
    """`masked_ce` per jet over packed rows: logits (B, W, V), targets
    (B, W) or (B, W, 1), mask (B, W, 1) -> (B, J)."""
    nll, m = _token_nll(logits, targets, mask)
    per_jet = _per_jet_sums(nll, segments, num_slots)
    return per_jet / _per_jet_sums(m, segments, num_slots).clamp(min=1.0)


def global_masked_mse(pred: Tensor, target: Tensor, mask: Tensor,
                      total: Optional[Tensor] = None) -> Tensor:
    """The CFM loss: the squared error over the whole batch, over its
    particle count (clamped to 1, so a batch of empty rows gives 0), or over
    `total` when given (a rank's share of the global count)."""
    se = (pred - target) ** 2 * mask
    return se.sum() / (mask.sum().to(se.dtype).clamp(min=1.0) if total is None else total)


def global_masked_ce(logits: Tensor, targets: Tensor, mask: Tensor,
                     total: Optional[Tensor] = None) -> Tensor:
    """The MJB loss: the NLL of real non-pad targets over the whole batch,
    over its particle count (clamped to 1), or over `total` when given."""
    nll, m = _token_nll(logits, targets, mask)
    return nll.sum() / (m.sum().clamp(min=1.0) if total is None else total)


def _wmean(x: Tensor, weights: Optional[Tensor], total: Optional[Tensor] = None) -> Tensor:
    """sum(x w) / sum(w) (sum(w) clamped to 1), or sum(x w) / `total`."""
    if weights is None:
        return x.mean()
    w = weights.to(torch.float32)
    return (x * w).sum() / (w.sum().clamp(min=1.0) if total is None else total)


class MultiTaskLoss(nn.Module):
    """Combine the MSE and CE tasks.  `forward` returns (loss, loss_1
    mean, loss_2 mean, w1, w2); the w's are zeros in `sum` mode.  Optional
    `weights` (the per-jet losses' shape) exclude entries from every mean:
    packed rows pass the jet-slot validity, so empty slots do not dilute
    the loss; `total` replaces sum(weights) as the means' denominator (a
    rank's share of the global batch's).

    Flax names: `loss_weights` (weighted), `c_fc` / `c_proj`
    (time-weighted, `c_proj`'s bias zero-initialised so training starts
    from the balanced sum)."""

    def __init__(self, mode: str, n_embd: int):
        super().__init__()
        if mode not in ("sum", "weighted", "time-weighted"):
            raise ValueError(f"unknown multitask_loss mode {mode!r}")
        self.mode, self.n_embd = mode, n_embd
        if mode == "weighted":
            self.loss_weights = nn.Parameter(torch.zeros(2))
        elif mode == "time-weighted":
            self.c_fc = nn.Linear(n_embd, n_embd)
            self.c_proj = nn.Linear(n_embd, 2)

    def forward(self, loss_1: Tensor, loss_2: Tensor, time: Optional[Tensor] = None,
                weights: Optional[Tensor] = None, total: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
        def mean(x):
            return _wmean(x, weights, total)

        if self.mode == "sum":
            zero = loss_1.new_zeros(())
            return mean(loss_1 + loss_2), mean(loss_1), mean(loss_2), zero, zero
        if self.mode == "weighted":
            u1, u2 = self.loss_weights[0], self.loss_weights[1]
        else:
            if time is None:
                raise ValueError("the time-weighted multitask loss needs the time")
            h = F.gelu(self.c_fc(timestep_embedding(time, self.n_embd)))
            uu = self.c_proj(h)                                         # (B, 2)
            u1, u2 = uu[..., 0], uu[..., 1]
        w1, w2 = torch.exp(-u1), torch.exp(-u2)
        loss = 0.5 * (u1 + w1 * loss_1) + 0.5 * (u2 + w2 * loss_2)
        if self.mode == "weighted":
            return mean(loss), mean(loss_1), mean(loss_2), w1, w2
        return mean(loss), mean(loss_1), mean(loss_2), mean(w1), mean(w2)
