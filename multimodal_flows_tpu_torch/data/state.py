"""Multimodal particle-cloud state and the (source, target, context)
coupling (PyTorch port of `multimodal_flows_tpu/data/state.py`).

`MultiModal` is a plain dataclass of tensors (or, in the host-side
datasets, numpy arrays); every field may be None:
  time:       (B,)        float32 — bridge time per jet
  continuous: (B, D, Fc)  float32 — particle kinematics (pt, eta_rel, phi_rel)
  discrete:   (B, D, 1)   int     — flavor tokens in {0..V-1}, 0 = pad
  mask:       (B, D, 1)   int     — 1 for real particles

`save_to` writes the same HDF5 datasets as the JAX package, so files
written by either package load in both.  `h5py` is imported where it is
used: the GPU machine may not have it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

Tensor = torch.Tensor

_MODES = ("time", "continuous", "discrete", "mask")


@dataclasses.dataclass
class MultiModal:
    time: Optional[Tensor] = None
    continuous: Optional[Tensor] = None
    discrete: Optional[Tensor] = None
    mask: Optional[Tensor] = None

    def __len__(self) -> int:
        for m in reversed(_MODES):
            v = getattr(self, m)
            if v is not None:
                return int(v.shape[0])
        return 0

    @property
    def ndim(self) -> int:
        """Dimensions of the last available mode (mask excluded), 0 when
        there is none."""
        modes = self.available_modes()
        return getattr(self, modes[-1]).ndim if modes else 0

    @property
    def shape(self):
        """Shape of the last available mode (mask excluded) without its
        feature axis: (B, D) of a particle cloud; None when there is none."""
        modes = self.available_modes()
        return tuple(getattr(self, modes[-1]).shape[:-1]) if modes else None

    @property
    def num_particles(self) -> Optional[int]:
        """Max number of particles D (None for per-point states)."""
        for m in ("continuous", "discrete", "mask"):
            v = getattr(self, m)
            if v is not None and v.ndim >= 2:
                return int(v.shape[1])
        return None

    def available_modes(self, include_mask: bool = False) -> List[str]:
        modes = [m for m in ("time", "continuous", "discrete") if getattr(self, m) is not None]
        if include_mask and self.mask is not None:
            modes.append("mask")
        return modes

    @property
    def has_continuous(self) -> bool:
        return self.continuous is not None

    @property
    def has_discrete(self) -> bool:
        return self.discrete is not None

    def map(self, fn: Callable[[Tensor], Tensor]) -> "MultiModal":
        """Apply `fn` to every non-None field."""
        return MultiModal(**{m: None if getattr(self, m) is None else fn(getattr(self, m))
                             for m in _MODES})

    def replace(self, **kw) -> "MultiModal":
        return dataclasses.replace(self, **kw)

    def __getitem__(self, index) -> "MultiModal":
        return self.map(lambda a: a[index])

    def to(self, device) -> "MultiModal":
        """Tensors on `device` (numpy fields are converted)."""
        return self.map(lambda a: torch.as_tensor(a, device=device))

    def apply_mask(self, condition: Optional[Tensor] = None) -> "MultiModal":
        """Zero out padded entries; discrete is cast to int32."""
        cond = self.mask if condition is None else condition
        continuous, discrete = self.continuous, self.discrete
        if continuous is not None:
            continuous = continuous * cond
        if discrete is not None:
            discrete = (discrete * cond).to(torch.int32)
        return self.replace(continuous=continuous, discrete=discrete)

    @staticmethod
    def concat(states: Sequence["MultiModal"], dim: int = 0) -> "MultiModal":
        def cat(name):
            parts = [getattr(s, name) for s in states if getattr(s, name) is not None]
            return torch.cat(parts, dim=dim) if parts else None

        return MultiModal(**{m: cat(m) for m in _MODES})

    @staticmethod
    def stack(states: Sequence["MultiModal"], dim: int = 0) -> "MultiModal":
        def stack_field(name):
            parts = [getattr(s, name) for s in states if getattr(s, name) is not None]
            return torch.stack(parts, dim=dim) if parts else None

        return MultiModal(**{m: stack_field(m) for m in _MODES})

    # -------------------------------------------------------------- HDF5 I/O

    def save_to(self, path: str) -> None:
        """Write the fields to an HDF5 file, atomically (tmp file + rename)."""
        import h5py

        tmp = path + ".tmp"
        with h5py.File(tmp, "w") as f:
            for mode in _MODES:
                v = getattr(self, mode)
                if v is not None:
                    f.create_dataset(mode, data=v.detach().cpu().numpy())
        os.replace(tmp, path)

    @classmethod
    def load_from(cls, path: str, transform=None) -> "MultiModal":
        """Load the fields of an HDF5 file as CPU tensors.

        `transform` is applied to the numpy arrays before they become
        tensors: a callable goes over every field, a dict of per-field
        callables over the fields it names."""
        import h5py

        with h5py.File(path, "r") as f:
            arrays = {m: np.asarray(f[m]) if m in f else None for m in _MODES}
        if callable(transform):
            arrays = {m: None if a is None else transform(a) for m, a in arrays.items()}
        elif isinstance(transform, dict):
            for m, fn in transform.items():
                if arrays.get(m) is not None and callable(fn):
                    arrays[m] = fn(arrays[m])
        return cls(**{m: None if a is None else torch.as_tensor(np.asarray(a))
                      for m, a in arrays.items()})


@dataclasses.dataclass
class DataCoupling:
    """(source, target, context) triple: the unit training batches are
    cut from.  An empty `MultiModal` stands for an absent member."""

    source: MultiModal = dataclasses.field(default_factory=MultiModal)
    target: MultiModal = dataclasses.field(default_factory=MultiModal)
    context: MultiModal = dataclasses.field(default_factory=MultiModal)

    def __len__(self) -> int:
        n = len(self.target)
        return n if n else len(self.source)

    @property
    def shape(self):
        return self.target.shape

    @property
    def has_source(self) -> bool:
        return bool(self.source.available_modes(include_mask=True))

    @property
    def has_target(self) -> bool:
        return bool(self.target.available_modes(include_mask=True))

    @property
    def has_context(self) -> bool:
        return bool(self.context.available_modes(include_mask=True))

    def map(self, fn: Callable) -> "DataCoupling":
        """Apply `fn` to every field of every member."""
        return DataCoupling(self.source.map(fn), self.target.map(fn), self.context.map(fn))

    def __getitem__(self, index) -> "DataCoupling":
        return self.map(lambda a: a[index])

    def to(self, device) -> "DataCoupling":
        return self.map(lambda a: torch.as_tensor(a, device=device))
