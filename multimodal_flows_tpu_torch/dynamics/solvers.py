"""Sampling-time integrators (PyTorch port of
`multimodal_flows_tpu/dynamics/solvers.py`).

- `HybridSolver` (MMF), tau-leap: model forward -> telegraph rates ->
  Poisson tau-leap on the tokens + Euler on the kinematics;
- `ContinuousSolver` (CFM), euler;
- `DiscreteSolver` (MJB), tauleap-poisson (`Config.markov_jump_solver`'s
  default).

`simulate` runs the time loop eagerly in Python; capturing the step in a
CUDA graph is ROADMAP Queue 1 item 10.  Top-k/top-p filtering, the hybrid
euler step, euler_maruyama and the other discrete modes are ROADMAP
Queue 1 item 19 and raise here.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.dynamics.bridges import RandomTelegraphBridge

Tensor = torch.Tensor

_NOT_PORTED = "not ported yet (ROADMAP.md Queue 1 item 19)"


def _filtered_probs(logits: Tensor, temperature: float) -> Tensor:
    """softmax(logits / T) in fp32 (top-k/top-p filtering is not ported)."""
    return torch.softmax(logits.to(torch.float32) / temperature, dim=-1)


def _poisson_tauleap_tokens(u: Tensor, k: Tensor, rates: Tensor, dt: Tensor,
                            vocab_size: int) -> Tensor:
    """Poisson tau-leap with at-most-one-jump gating, via one uniform per
    site (the JAX docstring derives the exact law).

    u: (B, D) uniforms in [0,1), k: (B, D) int tokens, rates: (B, D, S),
    dt scalar.  With R = sum_j r_j, the site stays with probability
    e^{-R dt} + P(sum N >= 2) and moves to class j with probability
    r_j dt e^{-R dt}: u is compared with the cumulative thresholds
    c_j = e^{-R dt} (1 + sum_{i<=j} r_i dt).
    """
    rdt = rates.to(torch.float32) * dt                                  # (B,D,S)
    total = rdt.sum(dim=-1, keepdim=True)                               # (B,D,1)
    base = torch.exp(-total)                                            # P(N_tot = 0)
    cum = base * (1.0 + torch.cumsum(rdt, dim=-1))                      # c_j
    u = u[..., None]                                                    # (B,D,1)
    # u < base -> stay; u in [c_{j-1}, c_j) -> move to j; u >= c_{S-1}
    # (the >= 2 jumps tail) -> stay
    jumped = (u >= base) & (u < cum[..., -1:])
    dest = (u >= cum).sum(dim=-1, dtype=k.dtype)                        # (B,D)
    return torch.where(jumped[..., 0], dest, k)


class HybridSolver:
    """Joint continuous + discrete step: Euler ODE on the kinematics,
    Poisson tau-leap on the tokens (`method="tauleap"` only)."""

    #: the step's only randomness is one uniform per (jet, site)
    uses_single_uniform = True

    def __init__(self, apply_fn: Callable, bridge_discrete: RandomTelegraphBridge,
                 vocab_size: int, temperature: float = 1.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 method: str = "tauleap"):
        if method != "tauleap":
            raise NotImplementedError(f"hybrid method {method!r} is {_NOT_PORTED}")
        if top_k is not None or top_p is not None:
            raise NotImplementedError(f"top-k/top-p filtering is {_NOT_PORTED}")
        self.apply_fn = apply_fn
        self.bridge = bridge_discrete
        self.vocab_size = int(vocab_size)
        self.temperature = temperature

    def fwd_step_u(self, u: Tensor, state: MultiModal, dt: Tensor
                   ) -> Tuple[MultiModal, Tensor]:
        """One step with the uniforms `u` (B, D); returns (state, rates)."""
        vt, logits = self.apply_fn(state)
        probs = _filtered_probs(logits, self.temperature)
        k = state.discrete[..., 0]
        rates = self.bridge.rate(state.time, k, probs)                  # (B,D,S)
        k_new = _poisson_tauleap_tokens(u, k, rates, dt, self.vocab_size)
        x_new = state.continuous + vt.to(state.continuous.dtype) * dt
        return state.replace(continuous=x_new, discrete=k_new[..., None]), rates


class ContinuousSolver:
    """Euler for pure CFM (`method="euler"` only)."""

    uses_single_uniform = False

    def __init__(self, apply_fn: Callable, method: str = "euler"):
        if method != "euler":
            raise NotImplementedError(f"continuous method {method!r} is {_NOT_PORTED}")
        self.apply_fn = apply_fn

    def fwd_step(self, state: MultiModal, dt: Tensor) -> MultiModal:
        vt = self.apply_fn(state)
        return state.replace(continuous=state.continuous + vt * dt)


class DiscreteSolver:
    """Poisson tau-leap for pure MJB (`method="tauleap-poisson"` only)."""

    uses_single_uniform = True

    def __init__(self, apply_fn: Callable, bridge_discrete: RandomTelegraphBridge,
                 vocab_size: int, temperature: float = 1.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 method: str = "tauleap-poisson"):
        if method != "tauleap-poisson":
            raise NotImplementedError(f"discrete method {method!r} is {_NOT_PORTED}")
        if top_k is not None or top_p is not None:
            raise NotImplementedError(f"top-k/top-p filtering is {_NOT_PORTED}")
        self.apply_fn = apply_fn
        self.bridge = bridge_discrete
        self.vocab_size = int(vocab_size)
        self.temperature = temperature

    def fwd_step_u(self, u: Tensor, state: MultiModal, dt: Tensor
                   ) -> Tuple[MultiModal, Tensor]:
        """One step with the uniforms `u` (B, D); returns (state, rates)."""
        logits = self.apply_fn(state)
        probs = _filtered_probs(logits, self.temperature)
        k = state.discrete[..., 0]
        rates = self.bridge.rate(state.time, k, probs)                  # (B,D,S)
        k_new = _poisson_tauleap_tokens(u, k, rates, dt, self.vocab_size)
        return state.replace(discrete=k_new[..., None]), rates


def time_grid(time_eps: float, num_timesteps: int, device=None):
    """linspace(eps, 1-eps, steps) and the uniform dt (a 0-d tensor)."""
    ts = torch.linspace(time_eps, 1.0 - time_eps, num_timesteps,
                        dtype=torch.float32, device=device)
    dt = (ts[-1] - ts[0]) / (num_timesteps - 1)
    return ts, dt


@torch.no_grad()
def simulate(solver, source: MultiModal, num_timesteps: int,
             time_eps: float, *, generator: Optional[torch.Generator] = None,
             uniforms: Optional[Tensor] = None,
             use_final_max_rates: bool = False) -> MultiModal:
    """Roll a solver (hybrid, continuous or discrete) over the time grid.

    For the tau-leap solvers the whole trajectory's uniforms (steps, B, D)
    are drawn in one call from `generator`, or taken from `uniforms`
    (tests inject the same noise into the JAX and the PyTorch sampler).
    `use_final_max_rates` replaces the final tokens by the argmax of the
    last step's rates.
    """
    B, D = len(source), source.num_particles
    device = source.mask.device
    ts, dt = time_grid(time_eps, num_timesteps, device)
    if solver.uses_single_uniform and uniforms is None:
        uniforms = torch.rand((num_timesteps, B, D), generator=generator,
                              dtype=torch.float32, device=device)
    state, rates = source, None
    for i in range(num_timesteps):
        state = state.replace(time=ts[i].expand(B))
        if solver.uses_single_uniform:
            state, rates = solver.fwd_step_u(uniforms[i], state, dt)
        else:
            state = solver.fwd_step(state, dt)
    if use_final_max_rates:
        if rates is None:
            raise ValueError("use_final_max_rates needs a solver with token rates")
        state = state.replace(discrete=rates.argmax(dim=2).to(torch.int32)[..., None])
    return state
