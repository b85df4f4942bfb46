"""Generative bridges (PyTorch port of
`multimodal_flows_tpu/dynamics/bridges.py`).

- `UniformFlow` — linear-interpolant flow-matching bridge for continuous
  features: source, interpolant sample and conditional drift.
- `RandomTelegraphBridge` — multivariate random-telegraph Markov jump
  bridge for discrete tokens: source, conditional and posterior
  (transition) probabilities, posterior sample, and the model-guided jump
  rate.

Times are per jet (B,) or, on packed training rows, per token (B, W).
Randomness comes from explicit `torch.Generator`s.  Bridge math is fp32:
the posterior divides by p(k1 | k0) and the rate by (1 - w_t), which lose
precision in low precision near the time endpoints.
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

    def sample(self, generator: Optional[torch.Generator], t: Tensor, x0: Tensor,
               x1: Tensor) -> Tensor:
        """Interpolant state xt at time t, (B,) or (B, W)."""
        tb = _bcast_time(t.to(torch.float32), x1.dim())
        xt = tb * x1 + (1.0 - tb) * x0
        z = torch.randn(xt.shape, generator=generator, dtype=xt.dtype, device=xt.device)
        return xt + self.sigma * z

    def conditional_drift(self, xt: Tensor, x0: Tensor, x1: Tensor) -> Tensor:
        """u_t(x | x0, x1) = x1 - x0."""
        return x1 - x0


class RandomTelegraphBridge:
    """Multivariate random-telegraph bridge over a vocabulary of size S:
    P(x_t = i | x_{t0}) = 1/S + w_{t0,t}(delta_{i,x_{t0}} - 1/S)."""

    def __init__(self, beta: float, vocab_size: int,
                 thermostat: Optional[Thermostat] = None, top_k: Optional[int] = None):
        if top_k is not None:
            raise NotImplementedError("top_k filtering of the bridge posterior is not "
                                      "ported yet (ROADMAP.md Queue 1 item 19)")
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

    def transition_probability(self, t: Tensor, k0: Tensor, k1: Tensor) -> Tensor:
        """Posterior P(x_t = k | x0 = k0, x1 = k1) over all k, (B, D, S),
        by Bayes."""
        B, D = k0.shape[0], k0.shape[1]
        k_grid = torch.arange(self.vocab_size, dtype=torch.int32,
                              device=k0.device).expand(B, D, self.vocab_size)
        k0b, k1b = k0.reshape(B, D, 1), k1.reshape(B, D, 1)
        # 0-d times on the device: two Python floats would make a CPU
        # tensor, and its copy to the card waits for the stream
        zero = torch.zeros((), dtype=torch.float32, device=k0.device)
        p_k_to_k1 = self.conditional_probability(t, 1.0, k_grid, k1b)    # (B,D,S)
        p_k0_to_k = self.conditional_probability(0.0, t, k0b, k_grid)    # (B,D,S)
        p_k0_to_k1 = self.conditional_probability(zero, 1.0, k0b, k1b)   # (B,D,1)
        return (p_k_to_k1 * p_k0_to_k) / p_k0_to_k1

    def sample(self, generator: Optional[torch.Generator], t: Tensor, k0: Tensor,
               k1: Tensor) -> Tensor:
        """Draw k_t from the posterior by inverting its CDF at one uniform
        per site; returns (B, D, 1) int32."""
        probs = self.transition_probability(t, k0, k1)
        cdf = probs.cumsum(dim=-1)
        u = torch.rand(cdf.shape[:-1] + (1,), generator=generator, dtype=cdf.dtype,
                       device=cdf.device) * cdf[..., -1:]
        kt = (cdf <= u).sum(dim=-1).clamp(max=self.vocab_size - 1)
        return kt.to(torch.int32)[..., None]

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
