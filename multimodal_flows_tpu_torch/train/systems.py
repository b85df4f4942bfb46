"""The trainable systems (PyTorch port of `multimodal_flows_tpu/train/systems.py`).

- MMF: CFM kinematics + telegraph flavor tokens, the multitask loss, the
  hybrid tau-leap solver;
- CFM: kinematics only, global masked MSE, euler;
- MJB: flavor tokens only, global masked CE, Poisson tau-leap.

Each takes its weights from `generator` and lives on `device`, CUDA
unless the caller asks for the CPU; without CUDA the default raises.

`loss_fn(batch, generator, train, module, rows)` takes a `DataCoupling`
or packed rows (`PackedJets`) on the system's device, draws t, the sources
and the bridge states from `generator` (on the same device), and returns
(loss, metrics) of `module` (the system's own, or e.g. its EMA copy).  It
is two calls: `loss_draws(batch, generator)`, every draw of the loss in
the order it has always made them (a dict of raw uniforms, normals and
tokens at the batch's shapes), then `loss_from_draws(batch, draws, ...)`,
which draws nothing but the dropout masks of a train-mode forward at
`dropout_rate > 0`.  So the trainer can make the draws before a captured
step and feed them to it (`train/trainer.py`); a seed gives the same draws
on either route.
Under data parallelism every rank holds the whole global batch and makes
every draw at its shape, then runs the forward on its `rows` alone, with
the loss's denominator taken over the global batch (`train/losses.py`):
the ranks' mean of the loss and of its gradients is then the loss and the
gradients of one device on the whole batch.  The
deterministic cores that follow the draws, `MMFModel.training_loss` /
`packed_training_loss` and the global CFM / MJB losses, are what the
tests hold against the JAX package on shared states.

Dropout: with `train` and `Config.dropout > 0` the loss runs its forward
in train mode (`module.train()`), every dropout mask drawn from
`generator`; with `train=False`, and at `dropout == 0`, the forward is the
deterministic one.  With `rows` every mask is drawn at the global batch's
shape and cut to the rank's rows (`models.blocks.set_dropout_generator`),
so the ranks drop what one device drops on the whole batch.  The
attention of a dropout forward takes the plain path by design
(`ops/attention.py`).

The losses and the solvers see fp32 whatever `Config.compute_dtype` is:
the encoders' heads project in fp32.
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
def _dropout_mode(module: nn.Module, rate: float, train: bool,
                  generator: Optional[torch.Generator], rows: Optional[slice] = None,
                  n: int = 0):
    """The forward inside runs with dropout when `train and rate > 0` (train
    mode, the masks from `generator`) and without it otherwise (eval mode);
    the module's mode is restored after.  At `rate == 0` the mode makes no
    difference and is left alone.  `rate` is the largest dropout rate of
    the module (`Config.dropout` for the flow systems).  With `rows` (this
    rank's rows of a global batch of `n`) the masks are drawn at the global
    shape and cut to those rows."""
    if rate <= 0:
        yield
        return
    was_training = module.training
    set_dropout_generator(module, generator, None if rows is None else (rows, n))
    module.train(train)
    try:
        yield
    finally:
        module.train(was_training)


def _time_uniforms(generator: Optional[torch.Generator], shape, device: torch.device) -> Tensor:
    """The uniforms of `_sample_time`."""
    return torch.rand(shape, generator=generator, dtype=torch.float32, device=device)


def _sample_time(generator: Optional[torch.Generator], shape, eps: float,
                 device: torch.device, u: Optional[Tensor] = None) -> Tensor:
    """t = eps + (1 - eps) U[0, 1): (B,) for plain batches, (B, J) for
    packed rows (one t per jet slot); `u` the uniforms (`_time_uniforms`),
    drawn from `generator` when not given."""
    if u is None:
        u = _time_uniforms(generator, shape, device)
    return eps + (1.0 - eps) * u


def _token_time(t_jets: Tensor, segments: Tensor) -> Tensor:
    """Per-jet times (B, J) to per-token times (B, W) through the segment
    ids; pads take slot 0's t (their outputs are masked)."""
    slot = segments.clamp(0, t_jets.shape[1] - 1).long()
    return torch.gather(t_jets, 1, slot)


def _rank_total(weight_sum: Tensor, rows: Optional[slice], n: int) -> Optional[Tensor]:
    """A rank's denominator of a weighted mean over a global batch of n
    rows: the global weight (clamped to 1) times the rank's share of the
    rows; None (the local weight) without `rows`."""
    if rows is None:
        return None
    return weight_sum.to(torch.float32).clamp(min=1.0) * ((rows.stop - rows.start) / n)


def _take(rows: Optional[slice], *tensors):
    return tensors if rows is None else tuple(t[rows] for t in tensors)


def _fields(batch):
    """(x1, k1, mask, x0, k0, the shape of t's draw) of padded jets (a
    `DataCoupling`, its sources where it holds them: None where the loss
    draws them) or of packed rows (the loss draws every source)."""
    if isinstance(batch, PackedJets):
        return (batch.continuous, batch.discrete, batch.mask, None, None,
                tuple(batch.jet_valid.shape))
    target, source = batch.target, batch.source
    return (target.continuous, target.discrete, target.mask, source.continuous,
            source.discrete, (len(target),))


def _segments(batch) -> Tuple[Optional[Tensor], Optional[int]]:
    """The segment ids and the most jets a row holds of packed rows; (None,
    None) for padded jets."""
    if isinstance(batch, PackedJets):
        return batch.segments, batch.jet_valid.shape[1]
    return None, None


class _BridgeLoss:
    """The flow systems' loss, split into its draws and the computation
    that takes them (`loss_draws`, `loss_from_draws`); `loss_fn` is both.
    A system has `bridge_continuous`, `bridge_discrete` or both."""

    @property
    def dropout_rate(self) -> float:
        """The largest dropout rate of a train-mode forward."""
        return self.config.dropout

    def loss_draws(self, batch, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Tensor]:
        """Every draw of the loss, from `generator` on the batch's device,
        in this order: t's uniforms ("t": (B,) a jet, (B, J) a packed
        slot), the sources the batch does not hold (the kinematic normals
        "x0", the token source's unmasked tokens "k0"), the interpolant's
        normals ("xt") and one uniform a site for the token bridge's draw
        ("kt"), each for the bridges the system has."""
        x1, k1, mask, x0, k0, t_shape = _fields(batch)
        cont, disc = self._bridges()
        draws = {"t": _time_uniforms(generator, t_shape, mask.device)}
        if cont is not None and x0 is None:
            draws["x0"] = cont.noise(generator, x1)
        if disc is not None and k0 is None:
            draws["k0"] = disc.source_tokens(generator, k1.shape, mask.device)
        if cont is not None:
            draws["xt"] = cont.noise(generator, x1)
        if disc is not None:
            draws["kt"] = disc.site_uniforms(generator, k1)
        return draws

    def loss_fn(self, batch, generator: Optional[torch.Generator] = None, train: bool = True,
                module: Optional[nn.Module] = None, rows: Optional[slice] = None
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """`loss_from_draws` at the draws `loss_draws` makes from
        `generator`, which then gives the dropout masks."""
        return self.loss_from_draws(batch, self.loss_draws(batch, generator), train, module,
                                    rows, generator)

    def _bridges(self) -> Tuple[Optional[UniformFlow], Optional[RandomTelegraphBridge]]:
        return getattr(self, "bridge_continuous", None), getattr(self, "bridge_discrete", None)

    def _bridge_states(self, batch, draws: Dict[str, Tensor]):
        """(t, time, x0, xt, kt) of the batch at the draws: t a jet, or a
        jet slot on packed rows; the time the bridges and the model take (t,
        or t a token on packed rows); the kinematic source and state, and
        the token state (None for a bridge the system lacks)."""
        x1, k1, mask, x0, k0, t_shape = _fields(batch)
        t = _sample_time(None, t_shape, self.config.time_eps, mask.device, draws["t"])
        time = _token_time(t, batch.segments) if isinstance(batch, PackedJets) else t
        cont, disc = self._bridges()
        xt = kt = None
        if cont is not None:
            if x0 is None:
                x0 = cont.draw_source(None, x1, mask, draws["x0"])
            xt = cont.sample(None, time, x0, x1, draws["xt"])
        if disc is not None:
            if k0 is None:
                k0 = disc.draw_source(None, k1.shape, mask, draws["k0"])
            kt = disc.sample(None, time, k0, k1, draws["kt"])
        return t, time, x0, xt, kt


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
                             jet_valid: Tensor, total: Optional[Tensor] = None):
        """`training_loss` over packed rows: per-token time in `state`,
        per-jet times `t_jets` (B, J), the per-jet normalisation recovered
        through the segment ids, empty slots weighted out by `jet_valid`;
        `total` replaces the jet count as the denominator of the means."""
        J = jet_valid.shape[1]
        vt, logits = self.encoder(state, segments, J)
        loss_mse = packed_masked_mse(vt, drift_target, state.mask, segments, J).reshape(-1)
        loss_ce = packed_masked_ce(logits, target_tokens, state.mask, segments, J).reshape(-1)
        return self.multitask(loss_mse, loss_ce, t_jets.reshape(-1),
                              weights=jet_valid.reshape(-1), total=total)


class MMF(_BridgeLoss):
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

    def loss_from_draws(self, batch, draws: Dict[str, Tensor], train: bool = True,
                        module: Optional[nn.Module] = None, rows: Optional[slice] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """The multitask loss of `module` at the draws of `loss_draws`.  On
        packed rows each jet has its own t and the bridges take per-token
        time.  With `rows`, the forward runs on those rows: the plain mean
        of padded jets (equal shares), the means of packed rows divided by
        their share of the batch's jet count."""
        module = module or self.module
        x1, k1, mask, _, _, _ = _fields(batch)
        t, time, x0, xt, kt = self._bridge_states(batch, draws)
        state = MultiModal(time=time, continuous=xt, discrete=kt, mask=mask)
        drift = self.bridge_continuous.conditional_drift(xt, x0, x1)
        dropout = _dropout_mode(module, self.dropout_rate, train, generator, rows, len(batch))
        if not isinstance(batch, PackedJets):
            if rows is not None:
                state, drift, k1 = state[rows], drift[rows], k1[rows]
            with dropout:
                return _mmf_metrics(module.training_loss(state, drift, k1))
        total = _rank_total(batch.jet_valid.sum(), rows, len(batch))
        segments, jet_valid = batch.segments, batch.jet_valid
        if rows is not None:
            state = state[rows]
            drift, k1, t, segments, jet_valid = _take(rows, drift, k1, t, segments, jet_valid)
        with dropout:
            return _mmf_metrics(module.packed_training_loss(
                state, drift, k1, t, segments, jet_valid, total))

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
                 return_trajectory: bool = False,
                 segments: Optional[Tensor] = None, num_segments: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[Tensor] = None, draw_rows=None):
        """The final state, or (final, trajectory) with `return_trajectory`
        (`dynamics.solvers.simulate`, which takes `draw_rows`)."""
        solver = self.make_solver(temperature, top_k, top_p, segments, num_segments)
        return simulate(solver, source, num_timesteps, self.config.time_eps,
                        generator=generator, uniforms=uniforms,
                        return_trajectory=return_trajectory,
                        use_final_max_rates=use_final_max_rates, draw_rows=draw_rows)


class CFM(_BridgeLoss):
    """Continuous-only conditional flow matching, euler sampler.  The
    module is the encoder itself (flax tree `params`)."""

    name = "CFM"

    def __init__(self, config: Config, device="cuda",
                 generator: Optional[torch.Generator] = None):
        self.config = config
        self.device = _device(device)
        self.module = _placed(build_model(config), self.device, generator)
        self.bridge_continuous = UniformFlow(config.sigma)

    def loss_from_draws(self, batch, draws: Dict[str, Tensor], train: bool = True,
                        module: Optional[nn.Module] = None, rows: Optional[slice] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Masked MSE over the whole batch at the draws of `loss_draws`; on
        packed rows each jet has its own t.  The normalisation counts the
        same real tokens packed or not.  With `rows`, the forward runs on
        those rows and the sum divides by their share of the batch's
        count."""
        module = module or self.module
        x1, _, mask, _, _, _ = _fields(batch)
        _, t, x0, xt, _ = self._bridge_states(batch, draws)
        segments, num_segments = _segments(batch)
        drift = self.bridge_continuous.conditional_drift(xt, x0, x1)
        n = len(mask)
        total = _rank_total(mask.sum(), rows, n)
        t, xt, mask, drift = _take(rows, t, xt, mask, drift)
        if segments is not None:
            (segments,) = _take(rows, segments)
        with _dropout_mode(module, self.dropout_rate, train, generator, rows, n):
            vt = module(MultiModal(time=t, continuous=xt, mask=mask), segments, num_segments)
        loss = global_masked_mse(vt, drift, mask, total)
        return loss, {"loss": loss, "loss_mse": loss}

    def simulate(self, source: MultiModal, num_timesteps: int, method: str = "euler",
                 return_trajectory: bool = False,
                 segments: Optional[Tensor] = None, num_segments: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 normals: Optional[Tensor] = None, temperature: float = 1.0,
                 top_k=None, top_p=None, use_final_max_rates: bool = False, draw_rows=None):
        """Euler or Euler-Maruyama integration (the latter draws its
        normals from `generator`, or takes `normals` (steps, B, D, Fc)).
        The token arguments that `generate_packed` passes (`temperature`,
        `top_k`, `top_p`, `use_final_max_rates`) are named so that it runs
        any system; they have no effect without tokens.  Any other keyword
        raises."""
        solver = ContinuousSolver(
            lambda s: self.module(s, segments, num_segments),
            diffusion_fn=lambda s: self.bridge_continuous.diffusion(s.continuous),
            method=method)
        return simulate(solver, source, num_timesteps, self.config.time_eps,
                        generator=generator, uniforms=normals,
                        return_trajectory=return_trajectory, draw_rows=draw_rows)


class MJB(_BridgeLoss):
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

    def loss_from_draws(self, batch, draws: Dict[str, Tensor], train: bool = True,
                        module: Optional[nn.Module] = None, rows: Optional[slice] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Masked CE over the whole batch at the draws of `loss_draws`; on
        packed rows each jet has its own t.  With `rows`, as
        `CFM.loss_from_draws`."""
        module = module or self.module
        _, k1, mask, _, _, _ = _fields(batch)
        _, t, _, _, kt = self._bridge_states(batch, draws)
        segments, num_segments = _segments(batch)
        n = len(mask)
        total = _rank_total(mask.sum(), rows, n)
        t, kt, mask, k1 = _take(rows, t, kt, mask, k1)
        if segments is not None:
            (segments,) = _take(rows, segments)
        with _dropout_mode(module, self.dropout_rate, train, generator, rows, n):
            logits = module(MultiModal(time=t, discrete=kt, mask=mask), segments, num_segments)
        loss = global_masked_ce(logits, k1, mask, total)
        return loss, {"loss": loss, "loss_ce": loss}

    def simulate(self, source: MultiModal, num_timesteps: int, temperature: float = 1.0,
                 top_k=None, top_p=None, return_trajectory: bool = False,
                 segments: Optional[Tensor] = None, num_segments: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 uniforms: Optional[Tensor] = None, use_final_max_rates: bool = False,
                 draw_rows=None):
        """The token steps of `Config.markov_jump_solver`.  The
        `use_final_max_rates` that `generate_packed` passes is named and
        has no effect, as in the JAX package; any other keyword raises."""
        solver = DiscreteSolver(lambda s: self.module(s, segments, num_segments),
                                self.bridge_discrete,
                                self.config.vocab_size, temperature=temperature,
                                top_k=top_k, top_p=top_p,
                                method=self.config.markov_jump_solver)
        return simulate(solver, source, num_timesteps, self.config.time_eps,
                        generator=generator, uniforms=uniforms,
                        return_trajectory=return_trajectory, draw_rows=draw_rows)


SYSTEM_REGISTRY = {"MMF": MMF, "CFM": CFM, "MJB": MJB}


def build_system(config: Config, kind: str = "MMF", device="cuda",
                 generator: Optional[torch.Generator] = None):
    """The `kind` system ("MMF", "CFM", "MJB" or "GPT") on `device` (CUDA
    unless the caller asks for the CPU), weights from `generator`."""
    if kind == "GPT":
        from multimodal_flows_tpu_torch.train.gpt import GPT

        return GPT(config, device=device, generator=generator)
    return SYSTEM_REGISTRY[kind](config, device=device, generator=generator)
