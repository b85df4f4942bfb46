"""Sampling-time integrators (PyTorch port of
`multimodal_flows_tpu/dynamics/solvers.py`).

- `HybridSolver` (MMF): model forward -> telegraph rates -> a token step
  (`tauleap`: Poisson tau-leap; `euler`: one-step transition matrix, with
  the per-class temperature when `class_freqs` is set) + Euler on the
  kinematics;
- `ContinuousSolver` (CFM): `euler`, `euler_maruyama`;
- `DiscreteSolver` (MJB): `tauleap-poisson`, `tauleap-bernouilli`, `euler`,
  `jump_or_stay` (`Config.markov_jump_solver`).

Every token step is a deterministic core that returns probabilities (the
jump probabilities, the (B, D, S) transition matrix, the leave probability
and the destination distribution) and a draw from them.  The draw takes
its uniforms as an argument; a solver's `step_noise` draws them from an
explicit `torch.Generator` on the state's device.  So tests hold the cores
against the JAX package exactly and the draws in distribution, and a run
on two devices can share the noise.

`simulate` runs the time loop eagerly in Python with the time and dt as
device scalars and every draw on the device, so a step makes no host sync;
capturing the step in a CUDA graph is ROADMAP Queue 4 item 5.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.dynamics.bridges import (
    RandomTelegraphBridge,
    sample_categorical,
    top_k_filter,
    top_p_filter,
)
from multimodal_flows_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


def _filtered_probs(logits: Tensor, temperature: float, top_k: Optional[int] = None,
                    top_p: Optional[float] = None) -> Tensor:
    """softmax(logits / T) in fp32 with optional top-k / top-p filtering."""
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    if top_k is not None:
        probs = top_k_filter(probs, top_k)
    if top_p is not None:
        probs = top_p_filter(probs, top_p)
    return probs


#: per-class temperature frequencies of the reference implementation:
#: photons and hadrons cooled (0.85), leptons heated (1.2)
REFERENCE_CLASS_FREQS = (0.85, 0.85, 0.85, 0.85, 0.85, 1.2, 1.2, 1.2, 1.2)


def _per_class_temperature(logits: Tensor, temperature, class_freqs) -> Tensor:
    """logits / (T * freqs + 1e-8), the frequencies broadcast per class as
    (1, 1, S)."""
    freqs = torch.as_tensor(class_freqs, dtype=torch.float32,
                            device=logits.device)[None, None, :]
    return logits.to(torch.float32) / (temperature * freqs + 1e-8)


def _uniform(generator: Optional[torch.Generator], shape, like: Tensor) -> Tensor:
    return torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                      device=like.device)


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


def _bernoulli_tauleap_probs(rates: Tensor, dt: Tensor) -> Tensor:
    """(B, D, S) probability of a jump to each class in one step."""
    return torch.clamp(rates * dt, max=1.0)


def _bernoulli_tauleap_tokens(u: Tensor, k: Tensor, rates: Tensor, dt: Tensor,
                              vocab_size: int) -> Tensor:
    """Bernoulli tau-leap: an independent jump indicator per (site, class),
    `u` (B, D, S) < the jump probability; the net displacement is applied
    modulo the vocabulary (non-negative, as Python's %)."""
    delta_n = (u < _bernoulli_tauleap_probs(rates, dt)).to(k.dtype)
    diff = torch.arange(vocab_size, dtype=k.dtype, device=k.device)[None, None, :] - k[:, :, None]
    net_jumps = (delta_n * diff).sum(dim=-1, dtype=k.dtype)
    return torch.remainder(k + net_jumps, vocab_size)


def _euler_transition_probs(k: Tensor, rates: Tensor, dt: Tensor, top_k: Optional[int],
                            top_p: Optional[float], vocab_size: int) -> Tensor:
    """(B, D, S) one-step transition matrix: rates * dt off the diagonal,
    the remaining mass on it, then the filters."""
    delta_p = torch.clamp(rates * dt, max=1.0)                          # (B,D,S)
    onehot = F.one_hot(k.long(), vocab_size).to(delta_p.dtype)
    delta_p = delta_p * (1.0 - onehot)                                  # zero diagonal
    diag = torch.clamp(1.0 - delta_p.sum(dim=-1, keepdim=True), min=0.0)
    delta_p = delta_p + diag * onehot
    if top_k is not None:
        delta_p = top_k_filter(delta_p, top_k)
    if top_p is not None:
        delta_p = top_p_filter(delta_p, top_p)
    return delta_p


def _euler_transition_tokens(u: Tensor, k: Tensor, rates: Tensor, dt: Tensor,
                             top_k: Optional[int], top_p: Optional[float],
                             vocab_size: int) -> Tensor:
    """A categorical draw from the one-step transition matrix, one uniform
    `u` (B, D) per site.  JAX draws from log(clip(p, 1e-30)): a class the
    filters removed keeps a probability of 1e-30 there, 0 here."""
    delta_p = _euler_transition_probs(k, rates, dt, top_k, top_p, vocab_size)
    return sample_categorical(None, delta_p, u).to(k.dtype)


def _jump_or_stay_probs(k: Tensor, rates: Tensor, probs: Tensor, dt: Tensor,
                        vocab_size: int) -> Tuple[Tensor, Tensor]:
    """(p_leave (B, D), dest_probs (B, D, S)): the probability of leaving
    the current class, and the model's distribution over the other
    classes."""
    rate_leave = torch.gather(rates, -1, k.long()[..., None])[..., 0]   # (B,D)
    p_leave = torch.clamp(rate_leave * dt, max=1.0)
    onehot = F.one_hot(k.long(), vocab_size).to(probs.dtype)
    dest_probs = probs * (1.0 - onehot)
    dest_probs = dest_probs / torch.clamp(dest_probs.sum(dim=-1, keepdim=True), min=1e-8)
    return p_leave, dest_probs


def _jump_or_stay_tokens(u: Tensor, k: Tensor, rates: Tensor, probs: Tensor, dt: Tensor,
                         vocab_size: int) -> Tensor:
    """Bernoulli leave decision, then a categorical destination among the
    other classes; `u` (B, D, 2) holds the two uniforms of a site."""
    p_leave, dest_probs = _jump_or_stay_probs(k, rates, probs, dt, vocab_size)
    jump = u[..., 0] < p_leave
    dest = sample_categorical(None, dest_probs, u[..., 1])
    return torch.where(jump, dest.to(k.dtype), k)


class HybridSolver:
    """Joint continuous + discrete step: Euler ODE on the kinematics and,
    on the tokens, `method="tauleap"` (Poisson tau-leap) or `"euler"` (the
    transition matrix; with `class_freqs` the logits take the per-class
    temperature instead of the scalar one)."""

    def __init__(self, apply_fn: Callable, bridge_discrete: RandomTelegraphBridge,
                 vocab_size: int, temperature: float = 1.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 method: str = "tauleap", class_freqs=None):
        if method not in ("tauleap", "euler"):
            raise ValueError(f"unknown hybrid method {method!r}")
        self.apply_fn = apply_fn
        self.bridge = bridge_discrete
        self.vocab_size = int(vocab_size)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.method = method
        self.class_freqs = class_freqs

    @property
    def uses_single_uniform(self) -> bool:
        """True when the step's only randomness is one uniform per (jet,
        site): `simulate` then draws the whole trajectory's in one call."""
        return self.method == "tauleap"

    def step_noise(self, generator: Optional[torch.Generator], state: MultiModal,
                   n_rows: Optional[int] = None) -> Tensor:
        """The uniforms (B, D) of one step, B = `n_rows` when given."""
        B, D = state.discrete.shape[:2]
        return _uniform(generator, (n_rows or B, D), state.discrete)

    def fwd_step_u(self, u: Tensor, state: MultiModal, dt: Tensor
                   ) -> Tuple[MultiModal, Tensor]:
        """One step with the uniforms `u` (B, D); returns (state, rates)."""
        vt, logits = self.apply_fn(state)
        if self.method == "euler" and self.class_freqs is not None:
            logits = _per_class_temperature(logits, self.temperature, self.class_freqs)
            probs = _filtered_probs(logits, 1.0, self.top_k, self.top_p)
        else:
            probs = _filtered_probs(logits, self.temperature, self.top_k, self.top_p)
        k = state.discrete[..., 0]
        rates = self.bridge.rate(state.time, k, probs)                  # (B,D,S)
        if self.method == "tauleap":
            k_new = _poisson_tauleap_tokens(u, k, rates, dt, self.vocab_size)
        else:
            k_new = _euler_transition_tokens(u, k, rates, dt, self.top_k, self.top_p,
                                             self.vocab_size)
        x_new = state.continuous + vt.to(state.continuous.dtype) * dt
        return state.replace(continuous=x_new, discrete=k_new[..., None]), rates


class ContinuousSolver:
    """`euler`, or `euler_maruyama` (x + v dt + diffusion * dw with
    dw ~ N(0, 1), as in the JAX package) for pure CFM."""

    uses_single_uniform = False

    def __init__(self, apply_fn: Callable, diffusion_fn: Optional[Callable] = None,
                 method: str = "euler"):
        if method not in ("euler", "euler_maruyama"):
            raise ValueError(f"unknown continuous method {method!r}")
        self.apply_fn = apply_fn
        self.diffusion_fn = diffusion_fn
        self.method = method

    def step_noise(self, generator: Optional[torch.Generator], state: MultiModal,
                   n_rows: Optional[int] = None) -> Optional[Tensor]:
        """The normals (B, D, Fc) of one euler_maruyama step, B = `n_rows`
        when given; euler takes none."""
        if self.method == "euler":
            return None
        x = state.continuous
        return torch.randn((n_rows or x.shape[0],) + tuple(x.shape[1:]), generator=generator,
                           dtype=x.dtype, device=x.device)

    def fwd_step_u(self, dw: Optional[Tensor], state: MultiModal, dt: Tensor) -> MultiModal:
        vt = self.apply_fn(state)
        x = state.continuous + vt * dt
        if self.method == "euler_maruyama":
            diffusion = self.diffusion_fn(state) if self.diffusion_fn else 0.0
            x = x + diffusion * dw
        return state.replace(continuous=x)


class DiscreteSolver:
    """Pure-MJB steps, selected by `markov_jump_solver`."""

    METHODS = ("tauleap-poisson", "tauleap-bernouilli", "euler", "jump_or_stay")

    def __init__(self, apply_fn: Callable, bridge_discrete: RandomTelegraphBridge,
                 vocab_size: int, temperature: float = 1.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 method: str = "tauleap-poisson"):
        if method not in self.METHODS:
            raise ValueError(f"unknown discrete method {method!r}")
        self.apply_fn = apply_fn
        self.bridge = bridge_discrete
        self.vocab_size = int(vocab_size)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.method = method

    @property
    def uses_single_uniform(self) -> bool:
        return self.method == "tauleap-poisson"

    def step_noise(self, generator: Optional[torch.Generator], state: MultiModal,
                   n_rows: Optional[int] = None) -> Tensor:
        """The uniforms of one step: (B, D), (B, D, S) for the Bernoulli
        tau-leap, (B, D, 2) for jump_or_stay; B = `n_rows` when given."""
        tail = {"tauleap-bernouilli": (self.vocab_size,), "jump_or_stay": (2,)}
        B, D = state.discrete.shape[:2]
        return _uniform(generator, (n_rows or B, D) + tail.get(self.method, ()),
                        state.discrete)

    def fwd_step_u(self, u: Tensor, state: MultiModal, dt: Tensor
                   ) -> Tuple[MultiModal, Tensor]:
        """One step with the uniforms `u`; returns (state, rates)."""
        logits = self.apply_fn(state)
        probs = _filtered_probs(logits, self.temperature, self.top_k, self.top_p)
        k = state.discrete[..., 0]
        rates = self.bridge.rate(state.time, k, probs)                  # (B,D,S)
        V = self.vocab_size
        if self.method == "tauleap-poisson":
            k_new = _poisson_tauleap_tokens(u, k, rates, dt, V)
        elif self.method == "tauleap-bernouilli":  # the reference's spelling
            k_new = _bernoulli_tauleap_tokens(u, k, rates, dt, V)
        elif self.method == "euler":
            k_new = _euler_transition_tokens(u, k, rates, dt, self.top_k, self.top_p, V)
        else:
            k_new = _jump_or_stay_tokens(u, k, rates, probs, dt, V)
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
             return_trajectory: bool = False,
             use_final_max_rates: bool = False,
             draw_rows: Optional[Tuple[int, slice]] = None):
    """Roll a solver (hybrid, continuous or discrete) over the time grid.

    For the tau-leap solvers (one uniform per site) the whole trajectory's
    uniforms (steps, B, D) are drawn in one call from `generator`; the
    other methods draw each step's noise from `generator` on the device,
    inside the loop.  `uniforms` (steps, ...) replaces the draws of either
    kind with given noise (the normals, for euler_maruyama): tests inject
    the same noise into two samplers.  `use_final_max_rates` replaces the
    final tokens by the argmax of the last step's rates.

    `draw_rows` = (n, rows): `source` is the rows `rows` of a batch of n
    (a data-parallel rank's share); every draw is made at the batch's
    shape and the rank keeps its rows, so the sharded trajectory is the
    unsharded one's.

    Returns the final state, or with `return_trajectory` the pair (final,
    trajectory): the trajectory is a `MultiModal` stacked on a leading
    steps axis, entry i the state after step i with the `time` of that
    step (the `use_final_max_rates` override is applied to the final state
    only).
    """
    B, D = len(source), source.num_particles
    device = source.mask.device
    ts, dt = time_grid(time_eps, num_timesteps, device)
    n_rows, rows = draw_rows if draw_rows is not None else (B, slice(None))
    if solver.uses_single_uniform and uniforms is None:
        uniforms = torch.rand((num_timesteps, n_rows, D), generator=generator,
                              dtype=torch.float32, device=device)[:, rows]
    state, rates, trajectory = source, None, []
    for i in range(num_timesteps):
        with span("solver.step"):
            state = state.replace(time=ts[i].expand(B))
            if uniforms is not None:
                noise = uniforms[i]
            else:
                noise = solver.step_noise(generator, state, n_rows)
                noise = None if noise is None else noise[rows]
            out = solver.fwd_step_u(noise, state, dt)
            state, rates = out if isinstance(out, tuple) else (out, None)
        if return_trajectory:
            trajectory.append(state)
    if use_final_max_rates:
        if rates is None:
            raise ValueError("use_final_max_rates needs a solver with token rates")
        state = state.replace(discrete=rates.argmax(dim=2).to(torch.int32)[..., None])
    if return_trajectory:
        return state, MultiModal.stack(trajectory)
    return state
