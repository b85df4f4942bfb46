"""The systems, sampling half (PyTorch port of
`multimodal_flows_tpu/train/systems.py:65-78,105-453`).

- MMF: CFM kinematics + telegraph flavor tokens, hybrid tau-leap solver;
- CFM: kinematics only, euler;
- MJB: flavor tokens only, Poisson tau-leap.

Each takes its weights from `generator` and lives on `device`.  The losses
(`loss_fn`, `packed_loss_fn`) and the `multitask` loss parameters come
with training (ROADMAP.md Queue 1 items 9, 11 and 14).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.dynamics.bridges import RandomTelegraphBridge, UniformFlow
from multimodal_flows_tpu_torch.dynamics.solvers import (
    ContinuousSolver,
    DiscreteSolver,
    HybridSolver,
    simulate,
)
from multimodal_flows_tpu_torch.dynamics.thermostats import ConstantThermostat
from multimodal_flows_tpu_torch.models.blocks import init_weights
from multimodal_flows_tpu_torch.models.registry import build_model

Tensor = torch.Tensor


def _placed(module: nn.Module, device: torch.device,
            generator: Optional[torch.Generator]) -> nn.Module:
    """Initialise the weights from `generator` (a CPU generator, so a seed
    gives the same weights on every device); move to `device`, eval mode."""
    init_weights(module, generator)
    return module.to(device).eval()


class MMFModel(nn.Module):
    """Holds the encoder (flax subtree `params['encoder']`)."""

    def __init__(self, config: Config):
        super().__init__()
        self.encoder = build_model(config)

    def forward(self, state: MultiModal, segments: Optional[Tensor] = None):
        return self.encoder(state, segments)


class MMF:
    """MultiModal Flow Bridge with the hybrid tau-leap sampler.

    The weights are drawn from `generator` (a CPU generator, so a seed
    gives the same weights on every device) and the module is moved to
    `device` in eval mode."""

    name = "MMF"

    def __init__(self, config: Config, device="cpu",
                 generator: Optional[torch.Generator] = None):
        self.config = config
        self.device = torch.device(device)
        self.module = _placed(MMFModel(config), self.device, generator)
        thermostat = ConstantThermostat(config.beta, config.vocab_size)
        self.bridge_continuous = UniformFlow(config.sigma)
        self.bridge_discrete = RandomTelegraphBridge(config.beta, config.vocab_size, thermostat)

    def make_solver(self, temperature: Optional[float] = None, top_k=None, top_p=None,
                    segments: Optional[Tensor] = None) -> HybridSolver:
        """Hybrid solver over the encoder; `segments` (fixed for the whole
        trajectory) selects block-diagonal attention over packed rows."""
        cfg = self.config
        return HybridSolver(
            lambda s: self.module(s, segments),
            self.bridge_discrete,
            cfg.vocab_size,
            temperature=cfg.temperature if temperature is None else temperature,
            top_k=cfg.top_k if top_k is None else top_k,
            top_p=cfg.top_p if top_p is None else top_p,
            method=cfg.hybrid_solver,
        )

    def simulate(self, source: MultiModal, num_timesteps: int, temperature: float = 1.0,
                 top_k=None, top_p=None, use_final_max_rates: bool = False,
                 segments: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[Tensor] = None) -> MultiModal:
        solver = self.make_solver(temperature, top_k, top_p, segments)
        return simulate(solver, source, num_timesteps, self.config.time_eps,
                        generator=generator, uniforms=uniforms,
                        use_final_max_rates=use_final_max_rates)


class CFM:
    """Continuous-only conditional flow matching, euler sampler.  The
    module is the encoder itself (flax tree `params`)."""

    name = "CFM"

    def __init__(self, config: Config, device="cpu",
                 generator: Optional[torch.Generator] = None):
        self.config = config
        self.device = torch.device(device)
        self.module = _placed(build_model(config), self.device, generator)
        self.bridge_continuous = UniformFlow(config.sigma)

    def simulate(self, source: MultiModal, num_timesteps: int, method: str = "euler",
                 segments: Optional[Tensor] = None, **_ignored) -> MultiModal:
        """Euler integration.  The hybrid-only keyword arguments
        (temperature, top_k, generator, ...) are accepted and ignored, so
        the generation drivers run any system."""
        solver = ContinuousSolver(lambda s: self.module(s, segments), method=method)
        return simulate(solver, source, num_timesteps, self.config.time_eps)


class MJB:
    """Discrete-only Markov jump bridge, Poisson tau-leap sampler.  The
    module is the encoder itself (flax tree `params`)."""

    name = "MJB"

    def __init__(self, config: Config, device="cpu",
                 generator: Optional[torch.Generator] = None):
        self.config = config
        self.device = torch.device(device)
        self.module = _placed(build_model(config), self.device, generator)
        thermostat = ConstantThermostat(config.beta, config.vocab_size)
        self.bridge_discrete = RandomTelegraphBridge(config.beta, config.vocab_size, thermostat)

    def simulate(self, source: MultiModal, num_timesteps: int, temperature: float = 1.0,
                 top_k=None, top_p=None, segments: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[Tensor] = None, **_ignored) -> MultiModal:
        """Tau-leap over the tokens; `use_final_max_rates` is accepted and
        ignored, as in the JAX package."""
        solver = DiscreteSolver(lambda s: self.module(s, segments), self.bridge_discrete,
                                self.config.vocab_size, temperature=temperature,
                                top_k=top_k, top_p=top_p,
                                method=self.config.markov_jump_solver)
        return simulate(solver, source, num_timesteps, self.config.time_eps,
                        generator=generator, uniforms=uniforms)


SYSTEM_REGISTRY = {"MMF": MMF, "CFM": CFM, "MJB": MJB}


def build_system(config: Config, kind: str = "MMF", device="cpu",
                 generator: Optional[torch.Generator] = None):
    """The `kind` system on `device`, weights from `generator`."""
    if kind == "GPT":
        raise KeyError("the GPT baseline is not ported yet (ROADMAP.md Queue 1 item 20)")
    return SYSTEM_REGISTRY[kind](config, device=device, generator=generator)
