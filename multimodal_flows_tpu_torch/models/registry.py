"""Network registry (PyTorch port of `multimodal_flows_tpu/models/registry.py`)."""

from __future__ import annotations

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.models.epic import EPiC
from multimodal_flows_tpu_torch.models.part import ParticleTransformer
from multimodal_flows_tpu_torch.models.particle_transformers import (
    FlavorFormer,
    FusedParticleFormer,
    KinFormer,
    ParticleFormer,
)
from multimodal_flows_tpu_torch.models.toy import ToyMLP

MODEL_REGISTRY = {
    "ParticleFormer": ParticleFormer,
    "FusedParticleFormer": FusedParticleFormer,
    "FlavorFormer": FlavorFormer,
    "KinFormer": KinFormer,
    "EPiC": EPiC,
    # the port's own: the Particle Transformer (models/part.py), no JAX twin
    "ParticleTransformer": ParticleTransformer,
    "ToyMLP": ToyMLP,
}


def build_model(config: Config):
    """Instantiate the configured encoder."""
    try:
        cls = MODEL_REGISTRY[config.model]
    except KeyError:
        raise KeyError(f"unknown model {config.model!r}; available: "
                       f"{sorted(MODEL_REGISTRY)}") from None
    return cls(config)
