"""Generative bridges (PyTorch port of
`multimodal_flows_tpu/dynamics/bridges.py`).

- `UniformFlow` — linear-interpolant flow-matching bridge for continuous
  features: source, interpolant sample and conditional drift.
- `RandomTelegraphBridge` — multivariate random-telegraph Markov jump
  bridge for discrete tokens: source, conditional and posterior
  (transition) probabilities, posterior sample (optionally top-k
  filtered), and the model-guided jump rate.
- `top_k_filter`, `top_p_filter` — the probability filters of the bridge
  and the solvers.

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

    def diffusion(self, xt: Tensor) -> float:
        return 0.0


class RandomTelegraphBridge:
    """Multivariate random-telegraph bridge over a vocabulary of size S:
    P(x_t = i | x_{t0}) = 1/S + w_{t0,t}(delta_{i,x_{t0}} - 1/S)."""

    def __init__(self, beta: float, vocab_size: int,
                 thermostat: Optional[Thermostat] = None, top_k: Optional[int] = None):
        self.beta = float(beta)
        self.vocab_size = int(vocab_size)
        self.thermostat = thermostat or ConstantThermostat(beta, vocab_size)
        self.top_k = top_k

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
        """Draw k_t from the posterior (top-k filtered when the bridge has
        a `top_k`); returns (B, D, 1) int32."""
        probs = self.transition_probability(t, k0, k1)
        if self.top_k is not None:
            probs = top_k_filter(probs, self.top_k)
        return sample_categorical(generator, probs).to(torch.int32)[..., None]

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


def sample_categorical(generator: Optional[torch.Generator], probs: Tensor,
                       u: Optional[Tensor] = None) -> Tensor:
    """Draw one class per site from unnormalised `probs` (..., S) by
    inverting the CDF at one uniform per site: `u` (...,) in [0, 1), drawn
    from `generator` on the device of `probs` when not given.  Returns
    (...,) int64.  A class of probability 0 is never drawn."""
    cdf = probs.cumsum(dim=-1)
    if u is None:
        u = torch.rand(cdf.shape[:-1], generator=generator, dtype=cdf.dtype,
                       device=cdf.device)
    u = u[..., None] * cdf[..., -1:]
    return (cdf <= u).sum(dim=-1).clamp(max=probs.shape[-1] - 1)


def top_k_filter(probs: Tensor, k: int) -> Tensor:
    """Keep the top-k entries along the last axis and renormalize.  Every
    entry >= the k-th largest value is kept, so ties at the threshold keep
    more than k."""
    if k >= probs.shape[-1]:
        return probs
    thresh = torch.topk(probs, k, dim=-1).values[..., -1:]
    kept = torch.where(probs >= thresh, probs, 0.0)
    return kept / (kept.sum(dim=-1, keepdim=True) + 1e-8)


def top_p_filter(probs: Tensor, p: float) -> Tensor:
    """Nucleus filtering: keep the longest prefix of the descending-sorted
    probs whose cumulative mass is <= p (the argmax always), zero the
    rest, renormalize."""
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    keep_sorted = sorted_probs.cumsum(dim=-1) <= p
    keep_sorted[..., 0] = True
    num_keep = keep_sorted.sum(dim=-1, keepdim=True)
    thresh = torch.gather(sorted_probs, -1, num_keep - 1)          # smallest kept value
    kept = torch.where(probs >= thresh, probs, 0.0)
    return kept / (kept.sum(dim=-1, keepdim=True) + 1e-8)
