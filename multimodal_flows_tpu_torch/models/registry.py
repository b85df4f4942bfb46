"""Network registry (PyTorch port of `multimodal_flows_tpu/models/registry.py`).
Only the flagship ParticleFormer is ported; the other encoders are
ROADMAP.md Queue 1 items 17, 18, 20 and 21."""

from __future__ import annotations

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.models.particle_transformers import ParticleFormer

MODEL_REGISTRY = {"ParticleFormer": ParticleFormer}


def build_model(config: Config):
    """Instantiate the configured encoder."""
    try:
        cls = MODEL_REGISTRY[config.model]
    except KeyError:
        raise KeyError(
            f"model {config.model!r} is not ported yet (ROADMAP.md Queue 1 items "
            f"17-21); available: {sorted(MODEL_REGISTRY)}") from None
    return cls(config)
