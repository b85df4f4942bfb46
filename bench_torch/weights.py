"""Weights from the seed, made on the device in one call.

The reference of the configuration lists every parameter (name, shape,
kind); one `randn` on a generator of the run's device draws them all, and
each kind is scaled so that activations stay of order one: matrices
N(0, 1/fan_in), embeddings N(0, 1), biases N(0, 0.1^2), LayerNorm scales
1 + N(0, 0.1^2).  The biases and LayerNorm terms are not zero, so the
comparison with the reference covers them too.  The same tensors load into
the program (by state-dict name, strictly) and feed the reference.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from bench_torch.reference.common import Spec


def draw(spec: Spec, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape, _ in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        z = flat[at:at + n].view(shape)
        at += n
        if kind == "matrix":
            out[name] = z / math.sqrt(shape[1])
        elif kind == "embedding":
            out[name] = z
        elif kind == "ln_weight":
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = 0.1 * z
    return out
