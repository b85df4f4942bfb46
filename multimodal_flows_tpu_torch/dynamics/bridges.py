"""Generative bridges, sampling half (PyTorch port of
`multimodal_flows_tpu/dynamics/bridges.py`).

- `UniformFlow` — linear-interpolant flow-matching bridge for continuous
  features (constructor and source).
- `RandomTelegraphBridge` — multivariate random-telegraph Markov jump
  bridge for discrete tokens (source, conditional probability and the
  model-guided jump rate).

Randomness comes from explicit `torch.Generator`s.  Bridge math is fp32:
the rate divides by (1 - w_t), which loses precision in low precision near
the time endpoints.  `transition_probability` and `sample` come with
training.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from multimodal_flows_tpu_torch.dynamics.thermostats import ConstantThermostat, Thermostat

Tensor = torch.Tensor


def _bcast_time(t: Tensor, ndim: int) -> Tensor:
    """Right-pad time with singleton dims: (B,) -> (B, 1, ..., 1);
    per-token (B, D) -> (B, D, 1, ...)."""
    return t.reshape(t.shape + (1,) * (ndim - t.ndim))


class UniformFlow:
    """Conditional OT flow matching: xt = t x1 + (1 - t) x0 + sigma z."""

    def __init__(self, sigma: float):
        self.sigma = float(sigma)

    def draw_source(self, generator: Optional[torch.Generator], x1: Tensor,
                    mask: Tensor) -> Tensor:
        """Masked standard-normal source."""
        x0 = torch.randn(x1.shape, generator=generator, dtype=torch.float32,
                         device=x1.device)
        return x0 * mask


class RandomTelegraphBridge:
    """Multivariate random-telegraph bridge over a vocabulary of size S:
    P(x_t = i | x_{t0}) = 1/S + w_{t0,t}(delta_{i,x_{t0}} - 1/S)."""

    def __init__(self, beta: float, vocab_size: int,
                 thermostat: Optional[Thermostat] = None):
        self.beta = float(beta)
        self.vocab_size = int(vocab_size)
        self.thermostat = thermostat or ConstantThermostat(beta, vocab_size)

    def draw_source(self, generator: Optional[torch.Generator], shape: Tuple[int, ...],
                    mask: Tensor) -> Tensor:
        """Uniform random tokens in {1..S-1}, masked."""
        k0 = torch.randint(1, self.vocab_size, shape, generator=generator,
                           dtype=torch.int32, device=mask.device)
        return k0 * mask.to(torch.int32)

    def conditional_probability(self, t_in, t_out, k_in: Tensor, k_out: Tensor) -> Tensor:
        """P(x(t_out) = k_out | x(t_in) = k_in); times are scalars, per-jet
        (B,) or per-token (B, D)."""
        wt = self.thermostat.w_ts(t_in, t_out)
        kron = (k_out == k_in).to(torch.float32)
        wt = _bcast_time(wt.to(kron.device), kron.ndim)
        return 1.0 / self.vocab_size + wt * (kron - 1.0 / self.vocab_size)

    def rate(self, t: Tensor, k: Tensor, probs: Tensor) -> Tensor:
        """Model-guided jump rate at sampling time:

        rate = 1 + (w_t S / (1 - w_t)) * q_x + w_t * q_y

        t: (B,), k: (B, D) or (B, D, 1) current tokens, probs: (B, D, S)
        model posterior q_x.  Diverges as t -> 1; callers use a time grid
        ending at 1 - time_eps.
        """
        if k.ndim == 3:
            k = k[..., 0]
        qx = probs
        qy = torch.gather(qx, -1, k.long().unsqueeze(-1))              # (B,D,1)
        wt = self.thermostat.w_ts(t.to(torch.float32), 1.0)           # (B,)
        bc = (wt * self.vocab_size) / (1.0 - wt)
        return 1.0 + bc[:, None, None] * qx + wt[:, None, None] * qy
