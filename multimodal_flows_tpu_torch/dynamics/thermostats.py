r"""Thermostat schedules beta(r) for the telegraph bridge (PyTorch port of
`multimodal_flows_tpu/dynamics/thermostats.py`).

w_{t0,t1} = exp(-S * beta * \int_{t0}^{t1} beta_shape(r) dr), in fp32.
Times may be Python floats or tensors; the result is a float32 tensor on
the device of the tensor argument.  `InverseThermostat` takes
log(t1 / t0) and `InverseSquareThermostat` divides by t1 * t0: both
diverge at t0 = 0, as in the JAX package, and nothing clamps them.
"""

from __future__ import annotations

import torch


def _as_f32(t, like=None) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.to(torch.float32)
    device = like.device if isinstance(like, torch.Tensor) else None
    # a fill on the device: `torch.tensor` would copy from the host and wait
    # for the stream
    return torch.full((), float(t), dtype=torch.float32, device=device)


class Thermostat:
    """Base thermostat: subclasses define the integral of beta_shape(r)."""

    def __init__(self, beta: float, vocab_size: int = 8):
        self.beta = float(beta)
        self.vocab_size = int(vocab_size)

    def _integral(self, t0, t1):
        raise NotImplementedError

    def w_ts(self, t0, t1) -> torch.Tensor:
        """w_{t0,t1} = exp(-S * beta * integral(t0, t1))."""
        t0, t1 = _as_f32(t0, t1), _as_f32(t1, t0)
        return torch.exp(-self.vocab_size * self.beta * self._integral(t0, t1))

    def wt_0(self, t) -> torch.Tensor:
        wt = self.w_ts(t, 1.0)
        return wt * self.vocab_size / (1.0 - wt)

    def wt_1(self, t) -> torch.Tensor:
        return self.w_ts(t, 1.0)


class ConstantThermostat(Thermostat):
    """beta(r) = const (the schedule the MMF system uses)."""

    def _integral(self, t0, t1):
        return t1 - t0


class InverseThermostat(Thermostat):
    """beta(r) = 1/r."""

    def _integral(self, t0, t1):
        return torch.log(t1 / t0)


class LinearThermostat(Thermostat):
    """beta(r) = r."""

    def _integral(self, t0, t1):
        return (t1 ** 2 - t0 ** 2) / 2.0


class InverseSquareThermostat(Thermostat):
    """beta(r) = -1/r^2."""

    def _integral(self, t0, t1):
        return (t1 - t0) / (t1 * t0)


class SigmoidThermostat(Thermostat):
    """beta(r) = 1/(1+r) (tanh-integral form, as in the JAX package)."""

    def _integral(self, t0, t1):
        return torch.tanh(t1 / 2.0) - torch.tanh(t0 / 2.0)


THERMOSTAT_REGISTRY = {
    "constant": ConstantThermostat,
    "inverse": InverseThermostat,
    "linear": LinearThermostat,
    "inverse_square": InverseSquareThermostat,
    "sigmoid": SigmoidThermostat,
}
