"""Exponential moving average of the parameters (port of
`multimodal_flows_tpu/train/ema.py`), in place on the EMA tensors."""

from __future__ import annotations

from typing import Sequence

import torch


@torch.no_grad()
def ema_update(ema_params: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
               decay: float) -> None:
    """ema <- decay * ema + (1 - decay) * params, for each pair of tensors."""
    ema_params, params = list(ema_params), list(params)
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1.0 - decay)
