"""Network registry (PyTorch port of `multimodal_flows_tpu/models/registry.py`).
ToyMLP is not ported yet (ROADMAP.md Queue 1 item 21)."""

from __future__ import annotations

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.models.epic import EPiC
from multimodal_flows_tpu_torch.models.particle_transformers import (
    FlavorFormer,
    FusedParticleFormer,
    KinFormer,
    ParticleFormer,
)

MODEL_REGISTRY = {
    "ParticleFormer": ParticleFormer,
    "FusedParticleFormer": FusedParticleFormer,
    "FlavorFormer": FlavorFormer,
    "KinFormer": KinFormer,
    "EPiC": EPiC,
}

_NOT_PORTED = {"ToyMLP": 21}


def build_model(config: Config):
    """Instantiate the configured encoder."""
    try:
        cls = MODEL_REGISTRY[config.model]
    except KeyError:
        if config.model in _NOT_PORTED:
            raise KeyError(f"model {config.model!r} is not ported yet (ROADMAP.md Queue 1 "
                           f"item {_NOT_PORTED[config.model]}); available: "
                           f"{sorted(MODEL_REGISTRY)}") from None
        raise KeyError(f"unknown model {config.model!r}; available: "
                       f"{sorted(MODEL_REGISTRY)}") from None
    return cls(config)
