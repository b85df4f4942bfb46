"""The trainable systems (PyTorch port of `multimodal_flows_tpu/train/systems.py`).

- MMF: CFM kinematics + telegraph flavor tokens, the multitask loss, the
  hybrid tau-leap solver;
- CFM: kinematics only, global masked MSE, euler;
- MJB: flavor tokens only, global masked CE, Poisson tau-leap.

Each takes its weights from `generator` and lives on `device`, CUDA
unless the caller asks for the CPU; without CUDA the default raises.

`loss_fn(batch, generator, train, module)` takes a `DataCoupling` or
packed rows (`PackedJets`) on the system's device, draws t, the sources
and the bridge states from `generator` (on the same device), and returns
(loss, metrics) of `module` (the system's own, or e.g. its EMA copy).  The
deterministic cores that follow the draws, `MMFModel.training_loss` /
`packed_training_loss` and the global CFM / MJB losses, are what the
tests hold against the JAX package on shared states.

Dropout: with `train` and `Config.dropout > 0` the loss runs its forward
in train mode (`module.train()`), every dropout mask drawn from
`generator`; with `train=False`, and at `dropout == 0`, the forward is the
deterministic one.  The attention of a dropout forward takes the plain
path by design (`ops/attention.py`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.packing import PackedJets
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.dynamics.bridges import RandomTelegraphBridge, UniformFlow
from multimodal_flows_tpu_torch.dynamics.solvers import (
    ContinuousSolver,
    DiscreteSolver,
    HybridSolver,
    simulate,
)
from multimodal_flows_tpu_torch.dynamics.thermostats import ConstantThermostat
from multimodal_flows_tpu_torch.models.blocks import init_weights, set_dropout_generator
from multimodal_flows_tpu_torch.models.registry import build_model
from multimodal_flows_tpu_torch.train.losses import (
    MultiTaskLoss,
    global_masked_ce,
    global_masked_mse,
    masked_ce,
    masked_mse,
    packed_masked_ce,
    packed_masked_mse,
)

Tensor = torch.Tensor


def _device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device must exist (the entry
    points never fall back to the CPU on their own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is false); "
                           "pass device='cpu' to run on the CPU")
    return device


def _placed(module: nn.Module, device: torch.device,
            generator: Optional[torch.Generator]) -> nn.Module:
    """Initialise the weights from `generator` (a CPU generator, so a seed
    gives the same weights on every device); move to `device`, eval mode."""
    init_weights(module, generator)
    return module.to(device).eval()


@contextlib.contextmanager
def _dropout_mode(module: nn.Module, config: Config, train: bool,
                  generator: Optional[torch.Generator]):
    """The forward inside runs with dropout when `train and config.dropout
    > 0` (train mode, the masks from `generator`) and without it otherwise
    (eval mode); the module's mode is restored after.  At `dropout == 0`
    the mode makes no difference and is left alone."""
    if config.dropout <= 0:
        yield
        return
    was_training = module.training
    set_dropout_generator(module, generator)
    module.train(train)
    try:
        yield
    finally:
        module.train(was_training)


def _sample_time(generator: Optional[torch.Generator], shape, eps: float,
                 device: torch.device) -> Tensor:
    """t = eps + (1 - eps) U[0, 1): (B,) for plain batches, (B, J) for
    packed rows (one t per jet slot)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return eps + (1.0 - eps) * u


def _token_time(t_jets: Tensor, segments: Tensor) -> Tensor:
    """Per-jet times (B, J) to per-token times (B, W) through the segment
    ids; pads take slot 0's t (their outputs are masked)."""
    slot = segments.clamp(0, t_jets.shape[1] - 1).long()
    return torch.gather(t_jets, 1, slot)


def _mmf_metrics(out) -> Tuple[Tensor, Dict[str, Tensor]]:
    loss, l_mse, l_ce, w_mse, w_ce = out
    return loss, {"loss": loss, "loss_mse": l_mse, "loss_ce": l_ce,
                  "weight_mse": w_mse, "weight_ce": w_ce}


class MMFModel(nn.Module):
    """The encoder (flax subtree `params['encoder']`) and the multitask
    loss parameters (`params['multitask']`)."""

    def __init__(self, config: Config):
        super().__init__()
        self.encoder = build_model(config)
        self.multitask = MultiTaskLoss(config.multitask_loss, config.n_embd)

    def forward(self, state: MultiModal, segments: Optional[Tensor] = None,
                num_segments: Optional[int] = None):
        return self.encoder(state, segments, num_segments)

    def training_loss(self, state: MultiModal, drift_target: Tensor, target_tokens: Tensor):
        """(loss, loss_mse, loss_ce, weight_mse, weight_ce) of padded jets
        at the bridge state `state` (per-jet time)."""
        vt, logits = self.encoder(state)
        return self.multitask(masked_mse(vt, drift_target, state.mask),
                              masked_ce(logits, target_tokens, state.mask), state.time)

    def packed_training_loss(self, state: MultiModal, drift_target: Tensor,
                             target_tokens: Tensor, t_jets: Tensor, segments: Tensor,
                             jet_valid: Tensor):
        """`training_loss` over packed rows: per-token time in `state`,
        per-jet times `t_jets` (B, J), the per-jet normalisation recovered
        through the segment ids, empty slots weighted out by `jet_valid`."""
        J = jet_valid.shape[1]
        vt, logits = self.encoder(state, segments, J)
        loss_mse = packed_masked_mse(vt, drift_target, state.mask, segments, J).reshape(-1)
        loss_ce = packed_masked_ce(logits, target_tokens, state.mask, segments, J).reshape(-1)
        return self.multitask(loss_mse, loss_ce, t_jets.reshape(-1),
                              weights=jet_valid.reshape(-1))


class MMF:
    """MultiModal Flow Bridge: the multitask loss and the hybrid tau-leap
    sampler.  The weights are drawn from `generator` (a CPU generator, so
    a seed gives the same weights on every device) and the module is moved
    to `device` in eval mode."""

    name = "MMF"

    def __init__(self, config: Config, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.config = config
        self.device = _device(device)
        self.module = _placed(MMFModel(config), self.device, generator)
        thermostat = ConstantThermostat(config.beta, config.vocab_size)
        self.bridge_continuous = UniformFlow(config.sigma)
        self.bridge_discrete = RandomTelegraphBridge(config.beta, config.vocab_size, thermostat)

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None, train: bool = True,
                module: Optional[nn.Module] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
        if isinstance(batch, PackedJets):
            return self.packed_loss_fn(batch, generator, train, module)
        module = module or self.module
        target, mask = batch.target, batch.target.mask
        t = _sample_time(generator, (len(target),), self.config.time_eps, mask.device)
        x0 = batch.source.continuous
        if x0 is None:
            x0 = self.bridge_continuous.draw_source(generator, target.continuous, mask)
        k0 = batch.source.discrete
        if k0 is None:
            k0 = self.bridge_discrete.draw_source(generator, target.discrete.shape, mask)
        xt = self.bridge_continuous.sample(generator, t, x0, target.continuous)
        kt = self.bridge_discrete.sample(generator, t, k0, target.discrete)
        state = MultiModal(time=t, continuous=xt, discrete=kt, mask=mask)
        drift = self.bridge_continuous.conditional_drift(xt, x0, target.continuous)
        with _dropout_mode(module, self.config, train, generator):
            return _mmf_metrics(module.training_loss(state, drift, target.discrete))

    def packed_loss_fn(self, batch: PackedJets, generator: Optional[torch.Generator] = None,
                       train: bool = True, module: Optional[nn.Module] = None
                       ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """The loss over packed rows: each jet draws its own t, the bridges
        take per-token time."""
        module = module or self.module
        mask = batch.mask
        t_jets = _sample_time(generator, batch.jet_valid.shape, self.config.time_eps,
                              mask.device)
        t_tok = _token_time(t_jets, batch.segments)
        x1, k1 = batch.continuous, batch.discrete
        x0 = self.bridge_continuous.draw_source(generator, x1, mask)
        k0 = self.bridge_discrete.draw_source(generator, k1.shape, mask)
        xt = self.bridge_continuous.sample(generator, t_tok, x0, x1)
        kt = self.bridge_discrete.sample(generator, t_tok, k0, k1)
        state = MultiModal(time=t_tok, continuous=xt, discrete=kt, mask=mask)
        drift = self.bridge_continuous.conditional_drift(xt, x0, x1)
        with _dropout_mode(module, self.config, train, generator):
            return _mmf_metrics(module.packed_training_loss(
                state, drift, k1, t_jets, batch.segments, batch.jet_valid))

    def make_solver(self, temperature: Optional[float] = None, top_k=None, top_p=None,
                    segments: Optional[Tensor] = None,
                    num_segments: Optional[int] = None) -> HybridSolver:
        """Hybrid solver over the encoder; `segments` (fixed for the whole
        trajectory) selects block-diagonal attention over packed rows, and
        `num_segments` (the most jets a row holds) sizes EPiC's per-jet
        global stream."""
        cfg = self.config
        return HybridSolver(
            lambda s: self.module(s, segments, num_segments),
            self.bridge_discrete,
            cfg.vocab_size,
            temperature=cfg.temperature if temperature is None else temperature,
            top_k=cfg.top_k if top_k is None else top_k,
            top_p=cfg.top_p if top_p is None else top_p,
            method=cfg.hybrid_solver,
            class_freqs=cfg.class_freqs,
        )

    def simulate(self, source: MultiModal, num_timesteps: int, temperature: float = 1.0,
                 top_k=None, top_p=None, use_final_max_rates: bool = False,
                 segments: Optional[Tensor] = None, num_segments: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[Tensor] = None) -> MultiModal:
        solver = self.make_solver(temperature, top_k, top_p, segments, num_segments)
        return simulate(solver, source, num_timesteps, self.config.time_eps,
                        generator=generator, uniforms=uniforms,
                        use_final_max_rates=use_final_max_rates)


class CFM:
    """Continuous-only conditional flow matching, euler sampler.  The
    module is the encoder itself (flax tree `params`)."""

    name = "CFM"

    def __init__(self, config: Config, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.config = config
        self.device = _device(device)
        self.module = _placed(build_model(config), self.device, generator)
        self.bridge_continuous = UniformFlow(config.sigma)

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None, train: bool = True,
                module: Optional[nn.Module] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Masked MSE over the whole batch; on packed rows each jet draws
        its own t.  The normalisation counts the same real tokens packed
        or not."""
        module = module or self.module
        segments = num_segments = None
        if isinstance(batch, PackedJets):
            mask, x1, x0, segments = batch.mask, batch.continuous, None, batch.segments
            num_segments = batch.jet_valid.shape[1]
            t = _token_time(_sample_time(generator, batch.jet_valid.shape,
                                         self.config.time_eps, mask.device), segments)
        else:
            mask, x1, x0 = batch.target.mask, batch.target.continuous, batch.source.continuous
            t = _sample_time(generator, (len(batch.target),), self.config.time_eps,
                             mask.device)
        if x0 is None:
            x0 = self.bridge_continuous.draw_source(generator, x1, mask)
        xt = self.bridge_continuous.sample(generator, t, x0, x1)
        with _dropout_mode(module, self.config, train, generator):
            vt = module(MultiModal(time=t, continuous=xt, mask=mask), segments, num_segments)
        loss = global_masked_mse(vt, self.bridge_continuous.conditional_drift(xt, x0, x1), mask)
        return loss, {"loss": loss, "loss_mse": loss}

    def simulate(self, source: MultiModal, num_timesteps: int, method: str = "euler",
                 segments: Optional[Tensor] = None, num_segments: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 normals: Optional[Tensor] = None, **_ignored) -> MultiModal:
        """Euler or Euler-Maruyama integration (the latter draws its
        normals from `generator`, or takes `normals` (steps, B, D, Fc)).
        The hybrid-only keyword arguments (temperature, top_k, ...) are
        accepted and ignored, so `generate_packed` runs any system."""
        solver = ContinuousSolver(
            lambda s: self.module(s, segments, num_segments),
            diffusion_fn=lambda s: self.bridge_continuous.diffusion(s.continuous),
            method=method)
        return simulate(solver, source, num_timesteps, self.config.time_eps,
                        generator=generator, uniforms=normals)


class MJB:
    """Discrete-only Markov jump bridge, Poisson tau-leap sampler.  The
    module is the encoder itself (flax tree `params`)."""

    name = "MJB"

    def __init__(self, config: Config, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.config = config
        self.device = _device(device)
        self.module = _placed(build_model(config), self.device, generator)
        thermostat = ConstantThermostat(config.beta, config.vocab_size)
        self.bridge_discrete = RandomTelegraphBridge(config.beta, config.vocab_size, thermostat)

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None, train: bool = True,
                module: Optional[nn.Module] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Masked CE over the whole batch; on packed rows each jet draws its
        own t."""
        module = module or self.module
        segments = num_segments = None
        if isinstance(batch, PackedJets):
            mask, k1, k0, segments = batch.mask, batch.discrete, None, batch.segments
            num_segments = batch.jet_valid.shape[1]
            t = _token_time(_sample_time(generator, batch.jet_valid.shape,
                                         self.config.time_eps, mask.device), segments)
        else:
            mask, k1, k0 = batch.target.mask, batch.target.discrete, batch.source.discrete
            t = _sample_time(generator, (len(batch.target),), self.config.time_eps,
                             mask.device)
        if k0 is None:
            k0 = self.bridge_discrete.draw_source(generator, k1.shape, mask)
        kt = self.bridge_discrete.sample(generator, t, k0, k1)
        with _dropout_mode(module, self.config, train, generator):
            logits = module(MultiModal(time=t, discrete=kt, mask=mask), segments, num_segments)
        loss = global_masked_ce(logits, k1, mask)
        return loss, {"loss": loss, "loss_ce": loss}

    def simulate(self, source: MultiModal, num_timesteps: int, temperature: float = 1.0,
                 top_k=None, top_p=None, segments: Optional[Tensor] = None,
                 num_segments: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[Tensor] = None, **_ignored) -> MultiModal:
        """The token steps of `Config.markov_jump_solver`;
        `use_final_max_rates` is accepted and ignored, as in the JAX
        package."""
        solver = DiscreteSolver(lambda s: self.module(s, segments, num_segments),
                                self.bridge_discrete,
                                self.config.vocab_size, temperature=temperature,
                                top_k=top_k, top_p=top_p,
                                method=self.config.markov_jump_solver)
        return simulate(solver, source, num_timesteps, self.config.time_eps,
                        generator=generator, uniforms=uniforms)


SYSTEM_REGISTRY = {"MMF": MMF, "CFM": CFM, "MJB": MJB}


def build_system(config: Config, kind: str = "MMF", device="cuda",
                 generator: Optional[torch.Generator] = None):
    """The `kind` system on `device` (CUDA unless the caller asks for the
    CPU), weights from `generator`."""
    if kind == "GPT":
        raise KeyError("the GPT baseline is not ported yet (ROADMAP.md Queue 1 item 20)")
    return SYSTEM_REGISTRY[kind](config, device=device, generator=generator)
