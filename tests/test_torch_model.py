"""The port's network blocks and ParticleFormer against the JAX package,
with the flax parameters converted (`convert.params_from_flax`) and the
inputs made from numpy: LayerNorm, MLP and the timestep embedding, then
the whole encoder on its key-mask path and on its packed segment path.
Only real tokens are compared (rows of pad queries are garbage by design,
multimodal_flows_tpu/models/blocks.py:120-129)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.config import Config as JaxConfig
from multimodal_flows_tpu.data.packing import build_packed_rows, pack_jets
from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
from multimodal_flows_tpu.models import blocks as jblocks
from multimodal_flows_tpu.train.systems import MMF as JaxMMF
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.convert import load_flax_params
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.models import blocks
from multimodal_flows_tpu_torch.train.systems import MMF

torch.set_num_threads(2)

# fp32 on both sides, same op order up to the sums inside the matmuls
ATOL = 1e-5

SMALL = dict(model="ParticleFormer", n_embd=32, n_inner=64, n_layer=2, n_layer_fused=1,
             n_head=4, vocab_size=9, dim_continuous=3, max_num_particles=12)


def _randomize(tree, seed):
    """Random values for every leaf (LayerNorm scales around 1), so the
    conversion of every bias and scale is exercised."""
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(tree)

    def draw(path, leaf):
        noise = rng.normal(size=leaf.shape).astype(np.float32) * 0.1
        return noise + 1.0 if path[-1].key == "scale" else noise

    return jax.tree_util.tree_unflatten(flat[1], [draw(p, l) for p, l in flat[0]])


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def test_layernorm_matches_flax():
    x = np.random.default_rng(0).normal(size=(4, 7, 16)).astype(np.float32) * 3 + 1
    mod = jblocks.LayerNorm()
    params = _randomize(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    ref = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    ln = blocks.LayerNorm(16)
    load_flax_params(ln, _to_numpy(params))
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(), ref, atol=ATOL)


def test_mlp_matches_flax():
    x = np.random.default_rng(0).normal(size=(4, 7, 16)).astype(np.float32)
    mod = jblocks.MLP(n_inner=24)
    params = _randomize(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
    ref = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    mlp = blocks.MLP(16, 24)
    load_flax_params(mlp, _to_numpy(params))
    np.testing.assert_allclose(mlp(torch.from_numpy(x)).detach().numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("width", [16, 17])
@pytest.mark.parametrize("shape", [(5,), (3, 4)])
def test_timestep_embedding_matches_jax(width, shape):
    t = np.random.default_rng(0).uniform(size=shape).astype(np.float32)
    ref = np.asarray(jblocks.timestep_embedding(jnp.asarray(t), width))
    out = blocks.timestep_embedding(torch.from_numpy(t), width).numpy()
    assert out.shape == shape + (width,)
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_key_mask_bias_matches_jax():
    mask = (np.arange(6)[None, :] < np.array([3, 6, 0])[:, None]).astype(np.int32)[..., None]
    ref = np.asarray(jblocks.key_mask_bias(jnp.asarray(mask)))
    out = blocks.key_mask_bias(torch.from_numpy(mask))
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


def _jets(N, D, mults, seed=0):
    rng = np.random.default_rng(seed)
    mask = (np.arange(D)[None, :] < np.asarray(mults)[:, None]).astype(np.int32)[..., None]
    x = (rng.normal(size=(N, D, 3)) * mask).astype(np.float32)
    k = (rng.integers(1, 9, size=(N, D, 1)) * mask).astype(np.int32)
    return x, k, mask


@pytest.fixture(scope="module")
def systems():
    """The JAX encoder's jitted apply with random parameters, and the
    port's MMF holding the same parameters."""
    jsys = JaxMMF(JaxConfig(**SMALL))
    params = jax.jit(jsys.init_params)(jax.random.PRNGKey(0))["params"]
    params = {"encoder": _randomize(params["encoder"], 3), "multitask": params["multitask"]}
    tsys = MMF(Config(**SMALL), device="cpu")
    load_flax_params(tsys.module.encoder, _to_numpy(params["encoder"]))
    apply = jax.jit(lambda state, segments=None: jsys.module.apply(
        {"params": params}, state, segments=segments))
    return apply, tsys


def _packed(x, k, mask, W):
    mults = mask[..., 0].sum(1)
    row_of, offset_of, n_rows = pack_jets(mults, W)
    row_mask, row_seg = build_packed_rows(mask, row_of, offset_of, n_rows, W)
    px = np.zeros((n_rows, W, 3), np.float32)
    pk = np.zeros((n_rows, W, 1), np.int32)
    for j, m in enumerate(mults):
        r, o = row_of[j], offset_of[j]
        px[r, o:o + m], pk[r, o:o + m] = x[j, :m], k[j, :m]
    return px, pk, row_mask.astype(np.int32), row_seg, row_of, offset_of


def test_particleformer_matches_jax_key_mask_path(systems):
    apply, tsys = systems
    mults = [5, 12, 3, 9, 7, 1]
    x, k, mask = _jets(6, 12, mults)
    t = np.linspace(0.1, 0.9, 6).astype(np.float32)
    ref = apply(JaxMultiModal(time=jnp.asarray(t), continuous=jnp.asarray(x),
                              discrete=jnp.asarray(k), mask=jnp.asarray(mask)))
    with torch.no_grad():
        out = tsys.module(MultiModal(time=torch.from_numpy(t), continuous=torch.from_numpy(x),
                                     discrete=torch.from_numpy(k), mask=torch.from_numpy(mask)))
    real = mask[..., 0] > 0
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy()[real], np.asarray(r)[real], atol=ATOL)


def test_particleformer_matches_jax_segments_path(systems):
    apply, tsys = systems
    x, k, mask = _jets(7, 12, [5, 4, 3, 7, 2, 6, 1])
    px, pk, row_mask, row_seg, _, _ = _packed(x, k, mask, 12)
    t = np.full(len(px), 0.37, np.float32)
    ref = apply(JaxMultiModal(time=jnp.asarray(t), continuous=jnp.asarray(px),
                              discrete=jnp.asarray(pk), mask=jnp.asarray(row_mask)),
                segments=jnp.asarray(row_seg))
    with torch.no_grad():
        out = tsys.module(MultiModal(time=torch.from_numpy(t), continuous=torch.from_numpy(px),
                                     discrete=torch.from_numpy(pk),
                                     mask=torch.from_numpy(row_mask)),
                          torch.from_numpy(row_seg))
    real = row_seg >= 0
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy()[real], np.asarray(r)[real], atol=ATOL)


def test_packed_forward_equals_unpacked_per_jet():
    """Within the port (mirrors tests/test_packing.py:82-104): the packed
    segment forward equals the per-jet key-mask forward."""
    tsys = MMF(Config(**SMALL), device="cpu", generator=torch.Generator().manual_seed(0))
    mults = [5, 9, 3, 7, 12, 4]
    x, k, mask = _jets(6, 12, mults, seed=1)
    px, pk, row_mask, row_seg, row_of, offset_of = _packed(x, k, mask, 12)
    with torch.no_grad():
        ref = tsys.module(MultiModal(time=torch.full((6,), 0.37), continuous=torch.from_numpy(x),
                                     discrete=torch.from_numpy(k), mask=torch.from_numpy(mask)))
        out = tsys.module(MultiModal(time=torch.full((len(px),), 0.37),
                                     continuous=torch.from_numpy(px),
                                     discrete=torch.from_numpy(pk),
                                     mask=torch.from_numpy(row_mask)),
                          torch.from_numpy(row_seg))
    for o, r in zip(out, ref):
        for j, m in enumerate(mults):
            ro, of = row_of[j], offset_of[j]
            np.testing.assert_allclose(o[ro, of:of + m].numpy(), r[j, :m].numpy(),
                                       rtol=2e-4, atol=2e-5)
