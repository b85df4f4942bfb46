"""The MMF system, sampling half (PyTorch port of
`multimodal_flows_tpu/train/systems.py:65-78,105-240`).

MMF = CFM kinematics + telegraph flavor tokens, sampled with the hybrid
tau-leap solver.  The losses (`loss_fn`, `packed_loss_fn`) and the
`multitask` loss parameters come with training (ROADMAP.md Queue 1 items
9, 11 and 14).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.dynamics.bridges import RandomTelegraphBridge, UniformFlow
from multimodal_flows_tpu_torch.dynamics.solvers import HybridSolver, simulate
from multimodal_flows_tpu_torch.dynamics.thermostats import ConstantThermostat
from multimodal_flows_tpu_torch.models.blocks import init_weights
from multimodal_flows_tpu_torch.models.registry import build_model

Tensor = torch.Tensor


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
        module = MMFModel(config)
        init_weights(module, generator)
        self.module = module.to(self.device).eval()
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
