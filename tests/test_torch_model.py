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


# ------------------------------------------------------ FusedParticleFormer

FUSED = dict(SMALL, model="FusedParticleFormer")
# gradients relative to the largest entry of each tensor, with a floor for
# gradients that are zero in exact arithmetic (as tests/test_torch_training.py)
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-9


@pytest.fixture(scope="module")
def fused():
    """The JAX MMF on FusedParticleFormer with random parameters, and the
    port's holding the same (the whole tree: encoder + multitask)."""
    jsys = JaxMMF(JaxConfig(**FUSED))
    params = jax.jit(jsys.init_params)(jax.random.PRNGKey(0))["params"]
    params = {"encoder": _randomize(params["encoder"], 5), "multitask": params["multitask"]}
    tsys = MMF(Config(**FUSED), device="cpu")
    load_flax_params(tsys.module, _to_numpy(params))
    return jsys, params, tsys


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_fused_particleformer_matches_jax(fused, packed):
    """Both heads against flax (atol 1e-5, real tokens): padded jets with
    per-jet times (the key-mask form) and packed rows (the segment form)."""
    jsys, params, tsys = fused
    x, k, mask = _jets(7, 12, [5, 4, 3, 7, 2, 6, 12], seed=2)
    seg = None
    if packed:
        x, k, mask, seg, _, _ = _packed(x, k, mask, 12)
        t = np.full(len(x), 0.37, np.float32)
        real = seg >= 0
    else:
        t = np.linspace(0.1, 0.9, 7).astype(np.float32)
        real = mask[..., 0] > 0
    ref = jax.jit(lambda s, g: jsys.module.apply({"params": params}, s, segments=g))(
        JaxMultiModal(time=jnp.asarray(t), continuous=jnp.asarray(x), discrete=jnp.asarray(k),
                      mask=jnp.asarray(mask)), None if seg is None else jnp.asarray(seg))
    with torch.no_grad():
        out = tsys.module(MultiModal(time=torch.from_numpy(t), continuous=torch.from_numpy(x),
                                     discrete=torch.from_numpy(k), mask=torch.from_numpy(mask)),
                          None if seg is None else torch.from_numpy(seg))
    assert out[0].shape == x.shape and out[1].shape == x.shape[:2] + (9,)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy()[real], np.asarray(r)[real], atol=ATOL)


def test_fused_particleformer_packed_equals_unpacked_per_jet(fused):
    _, _, tsys = fused
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


def test_fused_particleformer_loss_and_grads_match_jax(fused):
    """The multitask training loss (rtol 1e-6) and every parameter
    gradient (1e-4 of each tensor's largest entry) vs jax.value_and_grad."""
    from multimodal_flows_tpu_torch.convert import params_from_flax

    jsys, params, tsys = fused
    x, k, mask = _jets(6, 12, [5, 12, 3, 11, 8, 1], seed=3)
    rng = np.random.default_rng(4)
    xt = (rng.normal(size=x.shape) * mask).astype(np.float32)
    kt = (rng.integers(1, 9, k.shape) * mask).astype(np.int32)
    drift = (rng.normal(size=x.shape) * mask).astype(np.float32)
    t = np.linspace(0.05, 0.95, 6).astype(np.float32)

    def loss(p):
        out = jsys.module.apply({"params": p}, JaxMultiModal(
            time=jnp.asarray(t), continuous=jnp.asarray(xt), discrete=jnp.asarray(kt),
            mask=jnp.asarray(mask)), jnp.asarray(drift), jnp.asarray(k),
            method="training_loss")
        return out[0], out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tsys.module.zero_grad()
    out = tsys.module.training_loss(MultiModal(
        time=torch.from_numpy(t), continuous=torch.from_numpy(xt), discrete=torch.from_numpy(kt),
        mask=torch.from_numpy(mask)), torch.from_numpy(drift), torch.from_numpy(k))
    out[0].backward()
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.item(), float(r), rtol=1e-6, atol=1e-7)
    converted = params_from_flax(grads)
    assert set(converted) == {n for n, _ in tsys.module.named_parameters()}
    for name, p in tsys.module.named_parameters():
        g = converted[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, err_msg=name,
                                   atol=GRAD_RTOL * float(np.abs(g).max()) + GRAD_FLOOR)


# ------------------------------------------------------------------ dropout


def _dropout_inputs():
    x, k, mask = _jets(6, 12, [5, 12, 3, 9, 7, 1], seed=6)
    return MultiModal(time=torch.linspace(0.1, 0.9, 6), continuous=torch.from_numpy(x),
                      discrete=torch.from_numpy(k), mask=torch.from_numpy(mask)), mask


@pytest.mark.parametrize("model", ["ParticleFormer", "FusedParticleFormer"])
def test_dropout_eval_mode_equals_no_dropout_exactly(model):
    """With the same weights, a `dropout=0.3` encoder in eval mode is the
    `dropout=0` encoder bit for bit; in train mode it is not."""
    from multimodal_flows_tpu_torch.models.blocks import set_dropout_generator

    state, mask = _dropout_inputs()
    plain = MMF(Config(**dict(SMALL, model=model)), device="cpu",
                generator=torch.Generator().manual_seed(0))
    dropped = MMF(Config(**dict(SMALL, model=model, dropout=0.3)), device="cpu",
                  generator=torch.Generator().manual_seed(0))
    real = torch.from_numpy(mask[..., 0] > 0)
    with torch.no_grad():
        ref, out = plain.module(state), dropped.module(state)
        for o, r in zip(out, ref):
            assert torch.equal(o, r)
        set_dropout_generator(dropped.module, torch.Generator().manual_seed(1))
        dropped.module.train()
        noisy = dropped.module(state)
        dropped.module.eval()
    assert not torch.allclose(noisy[0][real], ref[0][real], atol=1e-3)
    assert torch.isfinite(noisy[0][real]).all() and torch.isfinite(noisy[1][real]).all()


def test_dropout_layer_keep_fraction_scaling_and_generator():
    """`Dropout`: the identity in eval mode; in train mode about 1 - p of
    the entries kept (300k entries, 5 sigma) and scaled by 1 / (1 - p);
    the same generator seed gives the same mask, another seed another."""
    drop = blocks.Dropout(0.25)
    x = torch.ones(300, 1000)
    assert drop.eval()(x) is x
    drop.train()
    masks = []
    for seed in (0, 0, 1):
        drop.dropout_generator = torch.Generator().manual_seed(seed)
        masks.append(drop(x))
    out = masks[0]
    kept = out != 0
    assert abs(float(kept.float().mean()) - 0.75) < 5 * (0.75 * 0.25 / x.numel()) ** 0.5
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.75))
    assert torch.equal(masks[0], masks[1]) and not torch.equal(masks[0], masks[2])
    assert blocks.Dropout(0.0).train()(x) is x


def test_dropout_train_step_takes_plain_attention_and_is_seeded():
    """`loss_fn(train=True)` at dropout 0.1: 5 attention calls a forward
    (2 + 2 + 1 blocks), all through the plain dropout path; the same
    generator seed gives the same loss, another seed another;
    `train=False` equals the dropout-free system's loss exactly and calls
    no dropout path; the module's mode is restored.  On the CPU neither
    kernel is launched in any of this."""
    from multimodal_flows_tpu_torch.data.state import DataCoupling
    from multimodal_flows_tpu_torch.ops import attention
    from multimodal_flows_tpu_torch.ops import btc_attention as k1
    from multimodal_flows_tpu_torch.ops import set_attention as k2

    cfg_kw = dict(SMALL, multitask_loss="time-weighted")
    plain = MMF(Config(**cfg_kw), device="cpu", generator=torch.Generator().manual_seed(0))
    dropped = MMF(Config(**dict(cfg_kw, dropout=0.1)), device="cpu",
                  generator=torch.Generator().manual_seed(0))
    x, k, mask = _jets(6, 12, [5, 12, 3, 9, 7, 2], seed=7)
    batch = DataCoupling(source=MultiModal(mask=torch.from_numpy(mask)),
                         target=MultiModal(continuous=torch.from_numpy(x),
                                           discrete=torch.from_numpy(k),
                                           mask=torch.from_numpy(mask)))
    k1.reset_launch_counts()
    k2.reset_launch_counts()
    attention.reset_plain_dropout_calls()
    losses = [dropped.loss_fn(batch, torch.Generator().manual_seed(s), train=True)[0].item()
              for s in (0, 0, 1)]
    assert attention.PLAIN_DROPOUT_CALLS == {"head_major": 0, "token_major": 3 * 5}
    assert losses[0] == losses[1] != losses[2] and np.isfinite(losses).all()
    assert not dropped.module.training

    attention.reset_plain_dropout_calls()
    with torch.no_grad():
        held = float(dropped.loss_fn(batch, torch.Generator().manual_seed(0), train=False)[0])
        ref = float(plain.loss_fn(batch, torch.Generator().manual_seed(0), train=True)[0])
    assert held == ref and held != losses[0]
    assert sum(attention.PLAIN_DROPOUT_CALLS.values()) == 0
    assert sum(k1.LAUNCHES.values()) == 0 and sum(k2.LAUNCHES.values()) == 0


def test_attention_prob_dropout_keep_fraction_and_scaling():
    """The plain attention with probability dropout, against the JAX
    formula probs * keep / (1 - p): with v = I the output rows are the
    dropped probabilities themselves, so every entry is 0 or the
    dropout-free probability / (1 - p) (rtol 1e-6), the kept share of the
    25.6k probabilities is 1 - p within 5 sigma, and a seed fixes the mask."""
    from multimodal_flows_tpu_torch.ops.attention import (
        attention_btc_reference,
        attention_reference,
    )

    B, T, H, p = 50, 16, 2, 0.3
    rng = np.random.default_rng(8)
    q, k = (torch.from_numpy(rng.normal(size=(B, T, H * T)).astype(np.float32)) for _ in "qk")
    v = torch.eye(T).repeat(1, H).expand(B, T, H * T).contiguous()      # per head: v = I
    probs = attention_btc_reference(q, k, v, H)                         # (B, T, H*T)
    gen = torch.Generator().manual_seed(0)
    out = attention_btc_reference(q, k, v, H, dropout_rate=p, generator=gen)
    kept = out != 0
    share = float(kept.float().mean())
    assert abs(share - (1 - p)) < 5 * (p * (1 - p) / out.numel()) ** 0.5
    torch.testing.assert_close(out[kept], probs[kept] / (1 - p), rtol=1e-6, atol=0)
    again = attention_btc_reference(q, k, v, H, dropout_rate=p, generator=gen.manual_seed(0))
    assert torch.equal(out, again)

    qh, kh = (t.reshape(B, T, H, T).transpose(1, 2) for t in (q, k))
    vh = torch.eye(T).expand(B, H, T, T)
    out_h = attention_reference(qh, kh, vh, dropout_rate=p, generator=gen.manual_seed(0))
    assert torch.equal(out_h.transpose(1, 2).reshape(B, T, H * T), out)  # the same draw
