"""Flax -> PyTorch parameter conversion at the flagship configuration, and
the port's Config against the JAX package's."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.config import Config as JaxConfig
from multimodal_flows_tpu.train.systems import MMF as JaxMMF
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.convert import load_flax_params, params_from_flax
from multimodal_flows_tpu_torch.models.registry import build_model
from multimodal_flows_tpu_torch.train.systems import MMFModel

torch.set_num_threads(2)

FLAGSHIP = dict(model="ParticleFormer", n_embd=256, n_inner=512, n_layer=5, n_layer_fused=6,
                n_head=4, vocab_size=9, dim_continuous=3, max_num_particles=150,
                multitask_loss="time-weighted")


@pytest.fixture(scope="module")
def flagship_encoder_tree():
    """The flagship's flax encoder subtree as numpy arrays (shapes only
    are traced: `eval_shape` initialises nothing)."""
    shapes = jax.eval_shape(JaxMMF(JaxConfig(**FLAGSHIP)).init_params, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32),
                        shapes["params"]["encoder"])


def test_flagship_conversion_maps_every_leaf(flagship_encoder_tree):
    leaves = jax.tree.leaves(flagship_encoder_tree)
    converted = params_from_flax(flagship_encoder_tree)
    assert len(leaves) == len(converted) == 285
    encoder = MMFModel(Config(**FLAGSHIP)).encoder
    load_flax_params(encoder, flagship_encoder_tree)
    assert sum(p.numel() for p in encoder.parameters()) == 5_390_092
    kernel = flagship_encoder_tree["block_fuse_0"]["attn"]["c_attn"]["kernel"]
    np.testing.assert_array_equal(encoder.block_fuse_0.attn.c_attn.weight.detach().numpy(),
                                  kernel.T)
    np.testing.assert_array_equal(
        encoder.block_x_0.attn.q_layernorm.weight.detach().numpy(),
        flagship_encoder_tree["block_x_0"]["attn"]["q_layernorm"]["LayerNorm_0"]["scale"])


def test_unknown_leaf_or_unset_parameter_raises(flagship_encoder_tree):
    with pytest.raises(KeyError, match="no conversion rule"):
        params_from_flax({"ln1_x": {"LayerNorm_0": {"gamma": np.ones(128, np.float32)}}})
    encoder = build_model(Config(**FLAGSHIP))
    extra = dict(flagship_encoder_tree, extra={"kernel": np.ones((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="extra.weight"):
        load_flax_params(encoder, extra)
    missing = {k: v for k, v in flagship_encoder_tree.items() if k != "head_y"}
    with pytest.raises(RuntimeError, match="head_y"):
        load_flax_params(encoder, missing)


def test_config_fields_and_defaults_match_jax():
    assert ([f.name for f in dataclasses.fields(Config)]
            == [f.name for f in dataclasses.fields(JaxConfig)])
    assert Config().to_dict() == JaxConfig().to_dict()


def test_config_yaml_round_trips_between_packages(tmp_path):
    Config(**FLAGSHIP, experiment_id="abc").save(str(tmp_path / "port"))
    assert JaxConfig.load(str(tmp_path / "port")).to_dict() == Config(
        **FLAGSHIP, experiment_id="abc").to_dict()
    JaxConfig(n_embd=64, tags=["a"]).save(str(tmp_path / "jax"))
    assert Config.load(str(tmp_path / "jax")) == Config(n_embd=64, tags=["a"])


def test_unported_model_raises_with_roadmap_pointer():
    """Every model of the JAX registry builds, ToyMLP included; an unknown
    name raises without a ROADMAP pointer.  bf16 compute no longer raises:
    a bf16 config of each transformer encoder builds, and the flagship's
    and the FusedParticleFormer's bf16 trees (fp32 parameters, as flax's
    `param_dtype`) convert by the same rules and load strictly into fp32
    parameters."""
    small = dict(n_embd=16, n_inner=32, n_layer=1, n_head=2, max_num_particles=6)
    assert type(build_model(Config(model="FusedParticleFormer", **small))).__name__ == \
        "FusedParticleFormer"
    assert type(build_model(Config(model="EPiC", **small))).__name__ == "EPiC"
    from multimodal_flows_tpu.models.registry import MODEL_REGISTRY as JAX_MODELS
    from multimodal_flows_tpu_torch.models.registry import MODEL_REGISTRY

    # the JAX registry's models, and the port's own Particle Transformer
    assert set(MODEL_REGISTRY) == set(JAX_MODELS) | {"ParticleTransformer"}
    assert type(build_model(Config(model="ToyMLP", **small))).__name__ == "ToyMLP"
    with pytest.raises(KeyError, match="unknown model 'NoSuchFormer'") as raised:
        build_model(Config(model="NoSuchFormer"))
    assert "ROADMAP" not in str(raised.value)
    for model in ("ParticleFormer", "FusedParticleFormer", "FlavorFormer", "KinFormer"):
        assert type(build_model(Config(model=model, compute_dtype="bfloat16", **small))
                    ).__name__ == model
    for model in ("ParticleFormer", "FusedParticleFormer"):
        cfg = dict(FLAGSHIP, model=model, compute_dtype="bfloat16")
        tree = _shape_tree(JaxMMF(JaxConfig(**cfg)))["encoder"]
        assert {a.dtype for a in jax.tree.leaves(tree)} == {np.dtype(np.float32)}
        encoder = build_model(Config(**cfg))
        load_flax_params(encoder, tree)
        assert {p.dtype for p in encoder.parameters()} == {torch.float32}
        assert len(list(encoder.parameters())) == len(jax.tree.leaves(tree))


def _shape_tree(system):
    """A system's flax tree with random values (`eval_shape` initialises
    nothing)."""
    shapes = jax.eval_shape(system.init_params, jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(1)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("kind,cfg_kw,leaves,numel", [
    # the training CLI's widths: n_embd 256, n_inner 512, n_layer 5, 4 heads
    ("MMF", dict(FLAGSHIP, model="FusedParticleFormer"), 101 + 4, 2_845_196 + 66_306),
    # n_embd 256, n_embd_glob 16, n_layer 5; 24 WeightNorm layers with a
    # kernel, a bias and a separate scale, `wxe` and `head`
    ("CFM", dict(model="EPiC", n_embd=256, n_embd_glob=16, n_layer=5, dim_continuous=3,
                 max_num_particles=150), 24 * 3 + 4, 2_109_171)],
    ids=["fused_mmf", "epic_cfm"])
def test_fused_and_epic_trees_convert_leaf_for_leaf(kind, cfg_kw, leaves, numel):
    """Every leaf of the FusedParticleFormer MMF tree and of the CFM + EPiC
    tree is consumed by exactly one torch parameter, the strict load
    passes, and the parameter counts agree with flax's."""
    from multimodal_flows_tpu.train.systems import SYSTEM_REGISTRY as JAX_SYSTEMS
    from multimodal_flows_tpu_torch.train.systems import build_system

    tree = _shape_tree(JAX_SYSTEMS[kind](JaxConfig(**cfg_kw)))
    flat = jax.tree.leaves(tree)
    converted = params_from_flax(tree)
    system = build_system(Config(**cfg_kw), kind, device="cpu")
    load_flax_params(system.module, tree)
    named = dict(system.module.named_parameters())
    assert len(flat) == len(converted) == len(named) == leaves
    total = sum(a.size for a in flat)
    assert total == sum(p.numel() for p in named.values())
    assert total == numel
    for name, p in named.items():       # every value arrived where its name says
        assert torch.equal(p.detach(), converted[name]), name
