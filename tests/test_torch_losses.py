"""The port's losses, the training half of its bridges and its learning-rate
schedule against the JAX package, on inputs made from numpy: the masked
and packed per-jet losses, the multitask combination in its three modes
through the converted `multitask` leaves (values and gradients), the
telegraph posterior (to the last bits of fp32) and its sampler (in
distribution), the uniform-flow interpolant, and the warmup -> cosine
staircase."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.config import Config as JaxConfig
from multimodal_flows_tpu.dynamics import bridges as jbridges
from multimodal_flows_tpu.train import losses as jlosses
from multimodal_flows_tpu.train.lr_schedules import (
    warmup_cosine_epoch_schedule as jax_schedule,
)
from multimodal_flows_tpu.train.systems import MMF as JaxMMF
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.convert import load_flax_params, params_from_flax
from multimodal_flows_tpu_torch.dynamics import bridges
from multimodal_flows_tpu_torch.train import losses
from multimodal_flows_tpu_torch.train.lr_schedules import warmup_cosine_epoch_schedule
from multimodal_flows_tpu_torch.train.systems import MMFModel

torch.set_num_threads(2)

# fp32 on both sides; the sums run in another order
LOSS_ATOL = 1e-6
# gradients: relative to the largest entry of each gradient tensor
GRAD_RTOL = 1e-5


def _jets(seed=0, B=5, D=7, V=9):
    """Padded jets: pred/target (B, D, 3), logits (B, D, V), targets with
    some real tokens 0 (weighted out of the CE, still counted), mask."""
    rng = np.random.default_rng(seed)
    mults = np.array([7, 3, 1, 5, 0][:B])
    mask = (np.arange(D)[None, :] < mults[:, None]).astype(np.int32)[..., None]
    pred = rng.normal(size=(B, D, 3)).astype(np.float32)
    target = rng.normal(size=(B, D, 3)).astype(np.float32)
    logits = (rng.normal(size=(B, D, V)) * 2).astype(np.float32)
    tokens = (rng.integers(0, V, size=(B, D, 1)) * mask).astype(np.int32)
    return pred, target, logits, tokens, mask


def _close_grads(ours, ref):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0, atol=GRAD_RTOL * scale)


def test_masked_mse_and_ce_match_jax():
    pred, target, logits, tokens, mask = _jets()
    w = np.linspace(0.5, 1.5, len(mask)).astype(np.float32)

    def jax_total(pred, logits):
        return ((jlosses.masked_mse(pred, jnp.asarray(target), jnp.asarray(mask))
                 + jlosses.masked_ce(logits, jnp.asarray(tokens), jnp.asarray(mask))) * w).sum()

    ref_mse = np.asarray(jlosses.masked_mse(jnp.asarray(pred), jnp.asarray(target),
                                            jnp.asarray(mask)))
    ref_ce = np.asarray(jlosses.masked_ce(jnp.asarray(logits), jnp.asarray(tokens),
                                          jnp.asarray(mask)))
    ref_dp, ref_dl = jax.grad(jax_total, argnums=(0, 1))(jnp.asarray(pred), jnp.asarray(logits))

    tp = torch.from_numpy(pred).requires_grad_(True)
    tl = torch.from_numpy(logits).requires_grad_(True)
    mse = losses.masked_mse(tp, torch.from_numpy(target), torch.from_numpy(mask))
    ce = losses.masked_ce(tl, torch.from_numpy(tokens), torch.from_numpy(mask))
    ((mse + ce) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(mse.detach().numpy(), ref_mse, atol=LOSS_ATOL)
    np.testing.assert_allclose(ce.detach().numpy(), ref_ce, atol=LOSS_ATOL)
    _close_grads(tp.grad, ref_dp)
    _close_grads(tl.grad, ref_dl)


def _packed_rows(seed=1, B=3, W=12, V=9):
    """Rows of jets 0..J-1 with pads -1 between and after them (an id
    layout the kernels never see, but the sums must take)."""
    rng = np.random.default_rng(seed)
    seg = np.full((B, W), -1, np.int32)
    seg[0, :4], seg[0, 4:9], seg[0, 10:] = 0, 1, 2
    seg[1, :12] = 0
    seg[2, :3], seg[2, 5:7] = 0, 1
    mask = (seg >= 0).astype(np.int32)[..., None]
    pred = rng.normal(size=(B, W, 3)).astype(np.float32)
    target = rng.normal(size=(B, W, 3)).astype(np.float32)
    logits = rng.normal(size=(B, W, V)).astype(np.float32)
    tokens = (rng.integers(0, V, size=(B, W, 1)) * mask).astype(np.int32)
    return pred, target, logits, tokens, mask, seg, 3


def test_packed_losses_match_jax():
    pred, target, logits, tokens, mask, seg, J = _packed_rows()
    j = [jnp.asarray(a) for a in (pred, target, logits, tokens, mask, seg)]
    ref_mse = jlosses.packed_masked_mse(j[0], j[1], j[4], j[5], J)
    ref_ce = jlosses.packed_masked_ce(j[2], j[3], j[4], j[5], J)
    ref_sums = jlosses._per_jet_sums(j[0][..., 0], j[5], J)
    t = [torch.from_numpy(a) for a in (pred, target, logits, tokens, mask, seg)]
    np.testing.assert_allclose(losses.packed_masked_mse(t[0], t[1], t[4], t[5], J).numpy(),
                               np.asarray(ref_mse), atol=LOSS_ATOL)
    np.testing.assert_allclose(losses.packed_masked_ce(t[2], t[3], t[4], t[5], J).numpy(),
                               np.asarray(ref_ce), atol=LOSS_ATOL)
    np.testing.assert_allclose(losses._per_jet_sums(t[0][..., 0], t[5], J).numpy(),
                               np.asarray(ref_sums), atol=LOSS_ATOL)


def test_global_losses_match_the_jax_systems_formulas():
    """The CFM and MJB normalisations (`train/systems.py:288-289,387-391`
    of the JAX package compute them inline)."""
    pred, target, logits, tokens, mask = _jets(2)
    se = (jnp.asarray(pred) - jnp.asarray(target)) ** 2 * jnp.asarray(mask)
    ref_mse = float(se.sum() / jnp.asarray(mask).sum())
    tg = jnp.asarray(tokens)[..., 0]
    logp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    nll = -jnp.take_along_axis(logp, tg[..., None], axis=-1)[..., 0]
    ref_ce = float((nll * jnp.asarray(mask)[..., 0] * (tg != 0)).sum()
                   / jnp.asarray(mask)[..., 0].sum())
    assert float(losses.global_masked_mse(torch.from_numpy(pred), torch.from_numpy(target),
                                          torch.from_numpy(mask))) == pytest.approx(ref_mse,
                                                                                   rel=1e-6)
    assert float(losses.global_masked_ce(torch.from_numpy(logits), torch.from_numpy(tokens),
                                         torch.from_numpy(mask))) == pytest.approx(ref_ce,
                                                                                  rel=1e-6)
    empty = torch.zeros((2, 4, 1), dtype=torch.int32)
    assert float(losses.global_masked_mse(torch.ones(2, 4, 3), torch.zeros(2, 4, 3), empty)) == 0


def _randomize(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.normal(size=a.shape) * 0.3).astype(np.float32), tree)


@pytest.mark.parametrize("weighted_slots", [False, True], ids=["all_jets", "jet_valid"])
@pytest.mark.parametrize("mode", ["sum", "weighted", "time-weighted"])
def test_multitask_loss_matches_jax(mode, weighted_slots):
    """Outputs and gradients (into both per-jet losses and every
    parameter) of the flax module and the port's, through the converted
    `multitask` leaves."""
    n_embd, N = 16, 9
    rng = np.random.default_rng(3)
    l1 = rng.uniform(0.5, 3.0, N).astype(np.float32)
    l2 = rng.uniform(0.5, 3.0, N).astype(np.float32)
    t = rng.uniform(0.0, 1.0, N).astype(np.float32)
    w = (rng.uniform(size=N) > 0.3).astype(np.float32) if weighted_slots else None
    jw = None if w is None else jnp.asarray(w)

    flax_mod = jlosses.MultiTaskLoss(mode, n_embd)
    variables = flax_mod.init(jax.random.PRNGKey(0), jnp.asarray(l1), jnp.asarray(l2),
                              jnp.asarray(t), jw)
    params = _randomize(variables.get("params", {}), 4)

    def jax_loss(p, a, b):
        out = flax_mod.apply({"params": p}, a, b, jnp.asarray(t), jw)
        return out[0], out

    (_, ref), ref_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(l1), jnp.asarray(l2))

    mod = losses.MultiTaskLoss(mode, n_embd)
    load_flax_params(mod, params)
    a, b = (torch.from_numpy(x).requires_grad_(True) for x in (l1, l2))
    out = mod(a, b, torch.from_numpy(t), None if w is None else torch.from_numpy(w))
    out[0].backward()
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), atol=LOSS_ATOL, rtol=1e-6)
    _close_grads(a.grad, ref_grads[1])
    _close_grads(b.grad, ref_grads[2])
    converted = params_from_flax(ref_grads[0])
    assert set(converted) == {n for n, _ in mod.named_parameters()}
    for name, p in mod.named_parameters():
        _close_grads(p.grad, converted[name])


FLAGSHIP = dict(model="ParticleFormer", n_embd=256, n_inner=512, n_layer=5, n_layer_fused=6,
                n_head=4, vocab_size=9, dim_continuous=3, max_num_particles=150)


@pytest.mark.parametrize("mode,widths,leaves,numel", [
    ("time-weighted", FLAGSHIP, 4, 66_306),
    ("weighted", dict(FLAGSHIP, n_embd=32, n_inner=64, n_layer=1, n_layer_fused=1), 1, 2),
    ("sum", dict(FLAGSHIP, n_embd=32, n_inner=64, n_layer=1, n_layer_fused=1), 0, 0)])
def test_whole_mmf_tree_converts(mode, widths, leaves, numel):
    """The whole flax tree (`encoder` + `multitask`) loads strictly into
    `MMFModel`; at the flagship the multitask subtree is 4 leaves and
    66,306 parameters (time-weighted)."""
    shapes = jax.eval_shape(JaxMMF(JaxConfig(**widths, multitask_loss=mode)).init_params,
                            jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    assert len(jax.tree.leaves(tree.get("multitask", {}))) == leaves
    model = MMFModel(Config(**widths, multitask_loss=mode))
    load_flax_params(model, tree)
    assert sum(p.numel() for p in model.multitask.parameters()) == numel
    if mode == "time-weighted":
        np.testing.assert_array_equal(model.multitask.c_fc.weight.detach().numpy(),
                                      tree["multitask"]["c_fc"]["kernel"].T)
    if mode == "weighted":
        np.testing.assert_array_equal(model.multitask.loss_weights.detach().numpy(),
                                      tree["multitask"]["loss_weights"])
    with pytest.raises(ValueError, match="loss_weights"):
        params_from_flax({"multitask": {"loss_weights": np.zeros(3, np.float32)}})


def _telegraph_inputs(seed=5, B=4, D=6, V=9):
    rng = np.random.default_rng(seed)
    k0 = rng.integers(1, V, size=(B, D, 1)).astype(np.int32)
    k1 = rng.integers(0, V, size=(B, D, 1)).astype(np.int32)
    t_jet = rng.uniform(0.0, 1.0, B).astype(np.float32)
    t_tok = rng.uniform(0.0, 1.0, (B, D)).astype(np.float32)
    return k0, k1, t_jet, t_tok


@pytest.mark.parametrize("time_shape", ["per_jet", "per_token"])
def test_transition_probability_matches_jax(time_shape):
    """The same fp32 formula on both sides.  XLA's exp rounds differently
    from libm in the last bit; where w_t is near 1, 1/S + w_t (0 - 1/S)
    cancels, so the bound is absolute: 3e-7, about 2 ulp of 1/S."""
    k0, k1, t_jet, t_tok = _telegraph_inputs()
    t = t_jet if time_shape == "per_jet" else t_tok
    ref = jbridges.RandomTelegraphBridge(0.075, 9).transition_probability(
        jnp.asarray(t), jnp.asarray(k0), jnp.asarray(k1))
    out = bridges.RandomTelegraphBridge(0.075, 9).transition_probability(
        torch.from_numpy(t), torch.from_numpy(k0), torch.from_numpy(k1))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=3e-7)


def test_telegraph_sample_follows_the_posterior():
    """Each row holds one (t, k0, k1) repeated over many sites: the
    empirical token frequencies of the port's sampler (and, as a check of
    the test, of JAX's) match the posterior within 5 standard errors."""
    n, V = 20_000, 9
    cases = [(0.1, 3, 7), (0.5, 3, 7), (0.9, 2, 2), (0.5, 5, 0)]
    t = np.array([c[0] for c in cases], np.float32)
    k0 = np.repeat(np.array([c[1] for c in cases], np.int32)[:, None], n, 1)[..., None]
    k1 = np.repeat(np.array([c[2] for c in cases], np.int32)[:, None], n, 1)[..., None]
    bridge = bridges.RandomTelegraphBridge(0.075, V)
    post = bridge.transition_probability(torch.from_numpy(t), torch.from_numpy(k0[:, :1]),
                                         torch.from_numpy(k1[:, :1]))[:, 0].numpy()
    kt = bridge.sample(torch.Generator().manual_seed(0), torch.from_numpy(t),
                       torch.from_numpy(k0), torch.from_numpy(k1))
    assert kt.shape == (len(cases), n, 1) and kt.dtype == torch.int32
    jkt = jbridges.RandomTelegraphBridge(0.075, V).sample(
        jax.random.PRNGKey(0), jnp.asarray(t), jnp.asarray(k0), jnp.asarray(k1))
    for draws in (kt.numpy()[..., 0], np.asarray(jkt)[..., 0]):
        freq = np.stack([np.bincount(row, minlength=V) / n for row in draws])
        se = np.sqrt(post * (1 - post) / n)
        assert (np.abs(freq - post) <= 5 * se + 1e-4).all(), np.abs(freq - post).max()


def test_uniform_flow_matches_jax():
    """At sigma 0 the interpolant is deterministic and equals JAX's, for
    per-jet and per-token time; at sigma > 0 the noise is N(0, sigma^2)."""
    rng = np.random.default_rng(6)
    x0, x1 = (rng.normal(size=(4, 6, 3)).astype(np.float32) for _ in range(2))
    for t in (rng.uniform(size=4).astype(np.float32),
              rng.uniform(size=(4, 6)).astype(np.float32)):
        ref = jbridges.UniformFlow(0.0).sample(jax.random.PRNGKey(0), jnp.asarray(t),
                                               jnp.asarray(x0), jnp.asarray(x1))
        out = bridges.UniformFlow(0.0).sample(None, torch.from_numpy(t), torch.from_numpy(x0),
                                              torch.from_numpy(x1))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7)
    drift = bridges.UniformFlow(0.0).conditional_drift(None, torch.from_numpy(x0),
                                                       torch.from_numpy(x1))
    np.testing.assert_array_equal(drift.numpy(), x1 - x0)
    x = torch.zeros(64, 64, 3)
    z = bridges.UniformFlow(0.5).sample(torch.Generator().manual_seed(1), torch.full((64,), 0.3),
                                        x, x) / 0.5
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1.0) < 0.05


def test_bridge_top_k_raises_with_roadmap_pointer():
    """The bridge's `top_k` is ported and no longer raises: the posterior
    sample is drawn from the top-k filtered posterior, so only the k most
    probable classes of a site are ever drawn."""
    bridge = bridges.RandomTelegraphBridge(0.075, 9, top_k=2)
    rng = np.random.default_rng(0)
    k0 = torch.from_numpy(rng.integers(1, 9, size=(64, 16, 1)).astype(np.int32))
    k1 = torch.from_numpy(rng.integers(1, 9, size=(64, 16, 1)).astype(np.int32))
    t = torch.full((64,), 0.5)
    kt = bridge.sample(torch.Generator().manual_seed(0), t, k0, k1)
    probs = bridge.transition_probability(t, k0, k1)
    allowed = probs >= probs.topk(2, dim=-1).values[..., -1:]
    assert kt.shape == (64, 16, 1) and kt.dtype == torch.int32
    assert torch.gather(allowed, -1, kt.long()).all()


@pytest.mark.parametrize("warmup,max_epochs,spe", [(0, 7, 3), (2, 12, 10), (3, 3, 1)])
def test_lr_schedule_matches_jax_on_a_grid(warmup, max_epochs, spe):
    """Every step of the run and past its end; JAX computes in float32."""
    ref = jax_schedule(5e-4, 1e-5, warmup, max_epochs, spe)
    ours = warmup_cosine_epoch_schedule(5e-4, 1e-5, warmup, max_epochs, spe)
    for step in range((max_epochs + 2) * spe):
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6)
