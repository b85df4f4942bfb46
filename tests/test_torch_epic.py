"""EPiC and its pooling in the port against the JAX package: the three
pooling ops (pads of -1, empty slots), `WNLinear` against flax's
`nn.WeightNorm(nn.Dense)` with a non-unit scale, the whole encoder per row
and on packed rows, the CFM + EPiC losses, and packed == unpacked sampling
through `generate_packed`.  Inputs from numpy seeds, fp32 on both sides,
the flax weights carried over by `convert.load_flax_params`; tolerances
are stated in each test (forwards atol / rtol 1e-5, gradients 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from multimodal_flows_tpu.config import Config as JaxConfig
from multimodal_flows_tpu.data import packing as jpacking
from multimodal_flows_tpu.data.state import DataCoupling as JaxCoupling
from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
from multimodal_flows_tpu.ops import pooling as jpooling
from multimodal_flows_tpu.train import systems as jsystems
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.convert import load_flax_params, params_from_flax
from multimodal_flows_tpu_torch.data import packing
from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
from multimodal_flows_tpu_torch.models.epic import EPiC, WNLinear
from multimodal_flows_tpu_torch.ops import pooling
from multimodal_flows_tpu_torch.sampling.generator import generate_packed
from multimodal_flows_tpu_torch.train import systems
from multimodal_flows_tpu_torch.utils import profiling

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-5
SMALL = dict(model="EPiC", n_embd=32, n_embd_glob=6, n_layer=2, dim_continuous=3,
             max_num_particles=12, sigma=0.0)


def _randomize(tree, seed):
    """Random values for every leaf; WeightNorm scales around 1."""
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(tree)

    def draw(path, leaf):
        noise = rng.normal(size=leaf.shape).astype(np.float32) * 0.2
        return noise + 1.0 if path[-1].key.endswith("scale") else noise

    return jax.tree_util.tree_unflatten(flat[1], [draw(p, l) for p, l in flat[0]])


def _segments(B=5, W=12, seed=0):
    """Segment ids with pads (-1), an empty jet slot and a full row."""
    rng = np.random.default_rng(seed)
    seg = np.full((B, W), -1, np.int32)
    seg[0, :5], seg[0, 5:9] = 0, 1                  # two jets, three pads
    seg[1, :] = 0                                   # one jet fills the row
    seg[2, :3], seg[2, 3:4], seg[2, 4:10] = 0, 1, 2
    seg[3, :4], seg[3, 4:8] = 0, 2                  # slot 1 empty
    return seg, rng                                 # row 4: all pads


# ------------------------------------------------------------------ pooling


def test_masked_meansum_pool_matches_jax():
    rng = np.random.default_rng(0)
    mask = (np.arange(9)[None, :] < np.array([3, 9, 1, 6])[:, None]).astype(np.int32)[..., None]
    x = rng.normal(size=(4, 9, 5)).astype(np.float32)
    g1, g2 = (rng.normal(size=(4, n)).astype(np.float32) for n in (2, 3))
    ref = jpooling.masked_meansum_pool(jnp.asarray(mask), jnp.asarray(x), jnp.asarray(g1),
                                       jnp.asarray(g2))
    out = pooling.masked_meansum_pool(*map(torch.from_numpy, (mask, x, g1, g2)))
    assert out.shape == (4, 2 * 5 + 2 + 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-6)
    ref = jpooling.masked_meansum_pool(jnp.asarray(mask), jnp.asarray(x), scale=0.5)
    out = pooling.masked_meansum_pool(torch.from_numpy(mask), torch.from_numpy(x), scale=0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("with_global", [False, True])
def test_segment_meansum_pool_matches_jax(with_global):
    """Pads (-1) go to the overflow slot and are dropped; an empty slot
    pools to exactly 0 (count clipped at 1)."""
    seg, rng = _segments()
    x = rng.normal(size=(5, 12, 4)).astype(np.float32)
    g = [rng.normal(size=(5, 3, 2)).astype(np.float32)] if with_global else []
    ref = jpooling.segment_meansum_pool(jnp.asarray(seg), jnp.asarray(x),
                                        *map(jnp.asarray, g), num_segments=3)
    out = pooling.segment_meansum_pool(torch.from_numpy(seg), torch.from_numpy(x),
                                       *map(torch.from_numpy, g), num_segments=3)
    assert out.shape == (5, 3, 8 + (2 if with_global else 0))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-6)
    assert (out[3, 1, :8] == 0).all() and (out[4, :, :8] == 0).all()
    np.testing.assert_allclose(out[1, 0, :4].numpy(), x[1].mean(0), rtol=RTOL, atol=1e-6)


def test_segment_gather_matches_jax_and_undoes_the_pool():
    """Ids clamp to [0, J-1]: a pad reads jet 0's global.  Gathering the
    pooled per-jet mean of a per-jet constant gives the constant back."""
    seg, rng = _segments()
    g = rng.normal(size=(5, 3, 4)).astype(np.float32)
    ref = jpooling.segment_gather(jnp.asarray(g), jnp.asarray(seg))
    out = pooling.segment_gather(torch.from_numpy(g), torch.from_numpy(seg))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out[0, 9:].numpy(), np.broadcast_to(g[0, 0], (3, 4)))
    t_jets = torch.from_numpy(rng.uniform(size=(5, 3)).astype(np.float32))
    t_tok = pooling.segment_gather(t_jets[..., None], torch.from_numpy(seg))
    back = pooling.segment_meansum_pool(torch.from_numpy(seg), t_tok, num_segments=3)[..., 0]
    real_slots = torch.tensor([[1, 1, 0], [1, 0, 0], [1, 1, 1], [1, 0, 1], [0, 0, 0]]).bool()
    torch.testing.assert_close(back[real_slots], t_jets[real_slots], rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------- WNLinear


def test_wnlinear_matches_flax_weightnorm_with_a_non_unit_scale():
    """flax keeps the raw kernel under the Dense's own name and the scale
    under the wrapper's; with scale != 1 the output and the gradients of
    v, scale and bias match (1e-5 / 1e-4).  torch's own weight_norm would
    not: it initialises g to the norm, flax's scale to ones."""

    class Wrapped(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.WeightNorm(nn.Dense(7), name="fc")(x)

    x = np.random.default_rng(0).normal(size=(5, 3, 11)).astype(np.float32)
    mod = Wrapped()
    init = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    assert set(init) == {"Dense_0", "fc"} and set(init["fc"]) == {"Dense_0/kernel/scale"}
    np.testing.assert_array_equal(np.asarray(init["fc"]["Dense_0/kernel/scale"]), np.ones(7))
    params = _randomize(init, 1)
    assert abs(float(np.asarray(params["fc"]["Dense_0/kernel/scale"]).mean()) - 1) < 0.3

    def loss(p):
        return (mod.apply({"params": p}, jnp.asarray(x)) ** 2).sum()

    ref, grads = jax.value_and_grad(loss)(params)

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = WNLinear(11, 7)

    holder = Holder()
    assert torch.equal(holder.fc.scale.detach(), torch.ones(7))
    load_flax_params(holder, jax.tree.map(np.asarray, params))
    out = holder.fc(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(mod.apply({"params": params}, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    (out ** 2).sum().backward()
    converted = params_from_flax(jax.tree.map(np.asarray, grads))
    assert set(converted) == {"fc.weight", "fc.bias", "fc.scale"}
    for name, p in holder.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), converted[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


# --------------------------------------------------------------------- EPiC


@pytest.fixture(scope="module")
def epic_pair():
    jsys = jsystems.CFM(JaxConfig(**SMALL))
    params = _randomize(jax.jit(jsys.init_params)(jax.random.PRNGKey(0))["params"], 2)
    tsys = systems.build_system(Config(**SMALL), "CFM", device="cpu")
    assert isinstance(tsys.module, EPiC)
    load_flax_params(tsys.module, jax.tree.map(np.asarray, params))
    return jsys, params, tsys


def _jets(mults, D=12, seed=0):
    rng = np.random.default_rng(seed)
    mask = (np.arange(D)[None, :] < np.asarray(mults)[:, None]).astype(np.int32)[..., None]
    x = (rng.normal(size=(len(mults), D, 3)) * mask).astype(np.float32)
    return x, mask


def test_epic_conversion_consumes_every_leaf_of_the_tree(epic_pair):
    """CFM + EPiC: every flax leaf maps to one torch parameter and back
    (strict load), the WeightNorm scale included; the counts agree."""
    _, params, tsys = epic_pair
    leaves = jax.tree.leaves(params)
    converted = params_from_flax(jax.tree.map(np.asarray, params))
    named = dict(tsys.module.named_parameters())
    assert set(converted) == set(named) and len(converted) == len(leaves)
    assert sum(int(np.size(a)) for a in leaves) == sum(p.numel() for p in named.values())
    n_wn = 4 + 4 * SMALL["n_layer"]
    assert sum(name.endswith(".scale") for name in named) == n_wn
    np.testing.assert_array_equal(
        named["layer_1.fc_loc2.weight"].detach().numpy(),
        np.asarray(params["layer_1"]["Dense_3"]["kernel"]).T)
    bad = jax.tree.map(np.asarray, params)
    bad["layer_0"] = dict(bad["layer_0"], extra={"Dense_9/kernel/scale": np.ones(3)})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_flax_params(tsys.module, bad)


def test_epic_per_row_matches_jax(epic_pair):
    jsys, params, tsys = epic_pair
    x, mask = _jets([5, 12, 3, 9, 1, 7], seed=1)
    t = np.linspace(0.1, 0.9, 6).astype(np.float32)
    ref = jax.jit(lambda s: jsys.module.apply({"params": params}, s))(
        JaxMultiModal(time=jnp.asarray(t), continuous=jnp.asarray(x), mask=jnp.asarray(mask)))
    with torch.no_grad():
        out = tsys.module(MultiModal(time=torch.from_numpy(t), continuous=torch.from_numpy(x),
                                     mask=torch.from_numpy(mask)))
    real = mask[..., 0] > 0
    assert out.shape == (6, 12, 3)
    np.testing.assert_allclose(out.numpy()[real], np.asarray(ref)[real], rtol=RTOL, atol=ATOL)


def _packed(mults, seed):
    x, mask = _jets(mults, seed=seed)
    k = mask.astype(np.int32)
    packed, leftover = packing.pack_multimodal(MultiModal(continuous=x, discrete=k, mask=mask), 12)
    assert len(leftover) == 0
    return x, mask, packed


@pytest.mark.parametrize("per_token_time", [False, True], ids=["shared_t", "per_jet_t"])
def test_epic_packed_matches_jax_and_the_per_row_forward(epic_pair, per_token_time):
    """Packed rows with `segments` and a static `num_segments`: against
    flax (1e-5), and per jet against the port's own per-row forward
    (2e-5), with one shared time (sampling) and with a time per jet
    (packed training), recovered inside as the segment mean."""
    jsys, params, tsys = epic_pair
    mults = [5, 4, 3, 7, 2, 6, 12, 1]
    x, mask, packed = _packed(mults, seed=2)
    J = packed.jet_valid.shape[1]
    rng = np.random.default_rng(3)
    if per_token_time:
        t_jets = rng.uniform(0.05, 0.95, packed.jet_valid.shape).astype(np.float32)
        t = np.take_along_axis(t_jets, np.clip(packed.segments, 0, None), axis=1)
    else:
        t = np.full(len(packed.mask), 0.37, np.float32)
    ref = jax.jit(lambda s, g: jsys.module.apply({"params": params}, s, segments=g,
                                                 num_segments=J))(
        JaxMultiModal(time=jnp.asarray(t), continuous=jnp.asarray(packed.continuous),
                      mask=jnp.asarray(packed.mask)), jnp.asarray(packed.segments))
    p = packed.to("cpu")
    with torch.no_grad():
        out = tsys.module(MultiModal(time=torch.from_numpy(t), continuous=p.continuous,
                                     mask=p.mask), p.segments, J)
    real = packed.segments >= 0
    np.testing.assert_allclose(out.numpy()[real], np.asarray(ref)[real], rtol=RTOL, atol=ATOL)

    # per jet: the port's per-row forward of each jet at its own time
    row_of, offset_of, _ = packing.pack_jets(np.asarray(mults), 12)
    slot = packed.segments[row_of, offset_of]
    t_jet = t[row_of, offset_of] if per_token_time else np.full(len(mults), 0.37, np.float32)
    with torch.no_grad():
        alone = tsys.module(MultiModal(time=torch.from_numpy(t_jet), continuous=torch.from_numpy(x),
                                       mask=torch.from_numpy(mask)))
    assert (slot >= 0).all()
    for j, m in enumerate(mults):
        r, o = row_of[j], offset_of[j]
        np.testing.assert_allclose(out[r, o:o + m].numpy(), alone[j, :m].numpy(),
                                   rtol=2e-4, atol=2e-5)
    with pytest.raises(ValueError, match="num_segments"):
        tsys.module(MultiModal(time=torch.from_numpy(t), continuous=p.continuous, mask=p.mask),
                    p.segments)


def _inject(monkeypatch, mod, sys_, t, x0, xt, as_array):
    monkeypatch.setattr(mod, "_sample_time", lambda *a, **kw: as_array(t))
    monkeypatch.setattr(sys_.bridge_continuous, "draw_source", lambda *a, **kw: as_array(x0))
    monkeypatch.setattr(sys_.bridge_continuous, "sample", lambda *a, **kw: as_array(xt))


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_cfm_epic_loss_and_grads_match_jax(monkeypatch, epic_pair, packed):
    """CFM + EPiC `loss_fn` and `packed_loss_fn` (through `num_segments`)
    with t, the source and the bridge state injected into both sides: the
    loss (rtol 1e-5) and every parameter gradient (1e-4 of each tensor's
    largest entry) against jax.value_and_grad."""
    jsys, params, tsys = epic_pair
    mults = [5, 4, 3, 7, 2, 6, 12, 1]
    x1, mask, pk = _packed(mults, seed=4)
    rng = np.random.default_rng(5)
    if packed:
        x1, mask = pk.continuous, pk.mask
        t = rng.uniform(0.05, 0.95, pk.jet_valid.shape).astype(np.float32)
        jbatch = jpacking.PackedJets(**{f: jnp.asarray(getattr(pk, f)) for f in
                                        ("continuous", "discrete", "mask", "segments",
                                         "jet_valid")})
        tbatch = pk.to("cpu")
    else:
        t = rng.uniform(0.05, 0.95, len(mults)).astype(np.float32)
        jbatch = JaxCoupling(source=JaxMultiModal(mask=jnp.asarray(mask)),
                             target=JaxMultiModal(continuous=jnp.asarray(x1),
                                                  mask=jnp.asarray(mask)))
        tbatch = DataCoupling(source=MultiModal(mask=torch.from_numpy(mask)),
                              target=MultiModal(continuous=torch.from_numpy(x1),
                                                mask=torch.from_numpy(mask)))
    x0 = (rng.normal(size=x1.shape) * mask).astype(np.float32)
    xt = (rng.normal(size=x1.shape) * mask).astype(np.float32)
    _inject(monkeypatch, jsystems, jsys, t, x0, xt, jnp.asarray)
    _inject(monkeypatch, systems, tsys, t, x0, xt, torch.from_numpy)

    (ref, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jsys.loss_fn({"params": p}, b, jax.random.PRNGKey(0)), has_aux=True))(
        params, jbatch)
    tsys.module.zero_grad()
    loss, metrics = tsys.loss_fn(tbatch, None, train=True)
    loss.backward()
    assert set(metrics) == {"loss", "loss_mse"}
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    converted = params_from_flax(jax.tree.map(np.asarray, grads))
    for name, p in tsys.module.named_parameters():
        g = converted[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, err_msg=name,
                                   atol=1e-4 * float(np.abs(g).max()) + 1e-9)


def test_generate_packed_epic_equals_unpacked_per_jet(monkeypatch):
    """CFM + EPiC through `generate_packed`: packed rows (per-segment
    pooling, `num_segments` from the packing) against `generate` (one jet
    per row) from the same per-jet noise, within 1e-4; no kernel runs
    (EPiC has no attention)."""
    from multimodal_flows_tpu_torch.sampling import generator as gen_mod

    cfg = Config(**dict(SMALL, max_num_particles=12))
    system = systems.build_system(cfg, "CFM", device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    mults = np.array([5, 4, 3, 7, 2, 6, 12, 1, 9, 3])
    pad_masks = (np.arange(12)[None, :] < mults[:, None]).astype(np.int64)[..., None]
    noise = np.random.default_rng(6).normal(size=(len(mults), 12, 3)).astype(np.float32)
    row_of, offset_of, n_rows = packing.pack_jets(mults, 12)
    packed_noise = np.zeros((n_rows, 12, 3), np.float32)
    for j, m in enumerate(mults):
        packed_noise[row_of[j], offset_of[j]:offset_of[j] + m] = noise[j, :m]

    def source_from(table):
        def make(generator, pad_mask, config):
            B = pad_mask.shape[0]
            x = torch.zeros(B, 12, 3)
            x[:min(B, len(table))] = torch.from_numpy(table[:B])
            mask = pad_mask.to(torch.int32)
            return MultiModal(time=torch.full((B,), config.time_eps), continuous=x * mask,
                              discrete=mask.clone(), mask=mask)
        return make

    profiling.take_counters()
    monkeypatch.setattr(gen_mod, "make_noise_source", source_from(packed_noise))
    packed = generate_packed(system, pad_masks, num_timesteps=5, pack_width=12, batch_size=16)
    monkeypatch.setattr(gen_mod, "make_noise_source", source_from(noise))
    flat = gen_mod.generate(system, pad_masks, num_timesteps=5, batch_size=16)
    real = torch.from_numpy(pad_masks[..., 0] > 0)
    assert packed.sample.continuous.shape == (10, 12, 3)
    torch.testing.assert_close(packed.sample.continuous[real], flat.sample.continuous[real],
                               rtol=1e-4, atol=1e-4)
    assert (packed.sample.continuous[~real] == 0).all()
    assert not any(v for k, v in profiling.peek_counters().items()
                   if k.startswith(("k1.", "k2.")))


def test_four_train_steps_of_cfm_epic_match_the_jax_trainer(monkeypatch):
    """CFM + EPiC at the training CLI's widths (n_embd 256, n_embd_glob
    16, 5 layers; a batch of 12 short jets keeps it small) from flax's
    initial weights (carried over), four train steps on one packed batch
    with the same injected draws every step, at the settings of the
    fixed-batch check of `chip_smoke.py` (lr 5e-4 without warm-up, clip
    1.0, EMA): the JAX trainer's step
    (optax clip + Adam, `ema_update`) against the port's `_train_step`.
    Each step's loss (rtol 1e-4) and gradient norm (rtol 1e-3), and the
    weights and their EMA after the last update (atol 2e-5; an Adam
    update moves a weight by about lr = 5e-4), agree.  At this width the
    first update overshoots: the second loss is more than 1.3 times the
    first on both sides, so that jump is the reference's own behaviour."""
    from multimodal_flows_tpu.train.trainer import Trainer as JaxTrainer
    from multimodal_flows_tpu.train.trainer import TrainState as JaxTrainState
    from multimodal_flows_tpu_torch.train.trainer import Trainer

    cfg_kw = dict(SMALL, n_embd=256, n_embd_glob=16, n_layer=5, lr=5e-4, gradient_clip_val=1.0,
                  use_ema_weights=True, max_epochs=2)
    jsys = jsystems.CFM(JaxConfig(**cfg_kw))
    params = jax.jit(jsys.init_params)(jax.random.PRNGKey(0))
    tsys = systems.build_system(Config(**cfg_kw), "CFM", device="cpu")
    load_flax_params(tsys.module, jax.tree.map(np.asarray, params["params"]))

    mults = [5, 4, 3, 7, 2, 6, 12, 1, 9, 3, 8, 11]
    _, _, pk = _packed(mults, seed=7)
    rng = np.random.default_rng(8)
    t = rng.uniform(0.05, 0.95, pk.jet_valid.shape).astype(np.float32)
    x0 = (rng.normal(size=pk.continuous.shape) * pk.mask).astype(np.float32)
    xt = (rng.normal(size=pk.continuous.shape) * pk.mask).astype(np.float32)
    _inject(monkeypatch, jsystems, jsys, t, x0, xt, jnp.asarray)
    _inject(monkeypatch, systems, tsys, t, x0, xt, torch.from_numpy)
    jbatch = jpacking.PackedJets(**{f: jnp.asarray(getattr(pk, f)) for f in
                                    ("continuous", "discrete", "mask", "segments", "jet_valid")})

    jtrainer = JaxTrainer(jsys, JaxConfig(**cfg_kw), mesh=None)
    jtrainer.tx = jtrainer.make_optimizer(steps_per_epoch=10)
    jstate = JaxTrainState(params=params, opt_state=jtrainer.tx.init(params),
                           ema_params=jax.tree.map(jnp.copy, params), step=0)
    jstep = jax.jit(lambda s: jtrainer._train_step(s, jbatch, jax.random.PRNGKey(0)))

    trainer = Trainer(tsys, Config(**cfg_kw))
    state = trainer.init_state(steps_per_epoch=10)
    tsys.module.train()
    tbatch = pk.to("cpu")
    ref_losses, losses = [], []
    for _ in range(4):
        jstate, jmetrics = jstep(jstate)
        metrics = trainer._train_step(state, tbatch, None)
        ref_losses.append(float(jmetrics["loss"]))
        losses.append(float(metrics["loss"]))
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                                   rtol=1e-3)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    assert losses[1] > 1.3 * losses[0] and ref_losses[1] > 1.3 * ref_losses[0]
    assert np.isfinite(losses).all() and len(set(losses)) == 4     # the weights moved
    for tree, module in ((jstate.params, state.module), (jstate.ema_params, state.ema)):
        ref = params_from_flax(jax.tree.map(np.asarray, tree["params"]))
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=2e-5,
                                       err_msg=name)
