"""The port's pairwise-bias paths against the JAX package, with the flax
parameters converted (`convert.params_from_flax`) and the inputs made
with numpy from a seed:

- `CrossAttention` (head-major attention with a bias, Tq != Tk);
- the co-occurrence ParticleFormer on its pair-mask and segment forms,
  and packed equal to per-jet;
- FlavorFormer with the lambda_u-gated co-occurrence bias and learned
  positions, KinFormer with the Lund bias at `pair_chunk` < D and with
  dataset metadata, and `lund_observables`;
- the MJB, CFM and co-occurrence MMF samplers on shared sources and
  uniforms, and the generation driver's routing of the three systems.

`lambda_u` initialises to 0, which would switch the pairwise term off, so
every test sets it nonzero on both sides.  Only real tokens are compared
(rows of pad queries are garbage by design,
multimodal_flows_tpu/models/blocks.py:120-129).  The attention runs
through the plain versions on both sides (K2 is held to them on the card
by chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.config import Config as JaxConfig
from multimodal_flows_tpu.data.packing import build_packed_rows, pack_jets
from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
from multimodal_flows_tpu.dynamics import solvers as jsolvers
from multimodal_flows_tpu.models import particle_transformers as jpt
from multimodal_flows_tpu.models.attention import CrossAttention as JaxCrossAttention
from multimodal_flows_tpu.train import systems as jsystems
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.convert import load_flax_params, params_from_flax
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.dynamics import solvers
from multimodal_flows_tpu_torch.models import particle_transformers as pt
from multimodal_flows_tpu_torch.models.attention import CrossAttention
from multimodal_flows_tpu_torch.models.registry import build_model
from multimodal_flows_tpu_torch.sampling.generator import generate_packed
from multimodal_flows_tpu_torch.train import systems
from multimodal_flows_tpu_torch.train.trainer import Trainer
from multimodal_flows_tpu_torch.utils.jet_features import JetFeatures
from multimodal_flows_tpu_torch.utils import profiling

torch.set_num_threads(2)

# fp32 on both sides, same op order up to the sums inside the matmuls
ATOL = 1e-5
# a sampler: 8 steps of the model, each feeding the next
SAMPLER_ATOL = 1e-4

D = 12
BASE = dict(n_embd=32, n_inner=64, n_layer=2, n_layer_fused=1, n_head=4, vocab_size=9,
            dim_continuous=3, max_num_particles=D, pair_chunk=5)
COOCC = dict(BASE, model="ParticleFormer", use_coocurrence=True)
FLAVOR = dict(BASE, model="FlavorFormer", use_pairwise=True, use_pos_emb=True)
FLAVOR_PACKABLE = dict(BASE, model="FlavorFormer", use_pairwise=True)
KIN = dict(BASE, model="KinFormer", use_pairwise=True,
           metadata={"mean": [2.0, 0.1, -0.2], "std": [3.0, 0.5, 0.7]})
LAMBDA_U = 0.8


def _randomize(tree, seed):
    """Random values for every leaf (LayerNorm scales around 1, lambda_u
    set to LAMBDA_U, the pair tables at scale 0.5 so the bias is O(1))."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)

    def draw(path, leaf):
        keys = [p.key for p in path]
        if keys[-1] == "lambda_u":
            return np.float32(LAMBDA_U)
        scale = 0.5 if {"wue", "wue_proj"} & set(keys) else 0.1
        noise = rng.normal(size=leaf.shape).astype(np.float32) * scale
        return noise + 1.0 if keys[-1] == "scale" else noise

    return jax.tree_util.tree_unflatten(treedef, [draw(p, l) for p, l in flat])


def _jets(N, mults, seed=0):
    rng = np.random.default_rng(seed)
    mask = (np.arange(D)[None, :] < np.asarray(mults)[:, None]).astype(np.int32)[..., None]
    x = (rng.normal(size=(N, D, 3)) * mask).astype(np.float32)
    k = (rng.integers(1, 9, size=(N, D, 1)) * mask).astype(np.int32)
    return x, k, mask


def _packed(x, k, mask, W=D):
    mults = mask[..., 0].sum(1)
    row_of, offset_of, n_rows = pack_jets(mults, W)
    row_mask, row_seg = build_packed_rows(mask, row_of, offset_of, n_rows, W)
    px = np.zeros((n_rows, W, 3), np.float32)
    pk = np.zeros((n_rows, W, 1), np.int32)
    for j, m in enumerate(mults):
        r, o = row_of[j], offset_of[j]
        px[r, o:o + m], pk[r, o:o + m] = x[j, :m], k[j, :m]
    return px, pk, row_mask.astype(np.int32), row_seg, row_of, offset_of


def _states(t, x, k, mask):
    """The same state for JAX and for the port."""
    j = JaxMultiModal(time=jnp.asarray(t), continuous=jnp.asarray(x),
                      discrete=jnp.asarray(k), mask=jnp.asarray(mask))
    p = MultiModal(time=torch.from_numpy(t), continuous=torch.from_numpy(x),
                   discrete=torch.from_numpy(k), mask=torch.from_numpy(mask))
    return j, p


def _system_pair(kind, cfg_kw, seed=3):
    """The JAX system with randomized parameters and its jitted apply, and
    the port's system holding the same parameters."""
    jsys = jsystems.SYSTEM_REGISTRY[kind](JaxConfig(**cfg_kw))
    params = jax.jit(jsys.init_params)(jax.random.PRNGKey(0))["params"]
    tsys = systems.build_system(Config(**cfg_kw), kind, device="cpu")
    if kind == "MMF":
        params = {"encoder": _randomize(params["encoder"], seed),
                  "multitask": params["multitask"]}
        load_flax_params(tsys.module.encoder, params["encoder"])
    else:
        params = _randomize(params, seed)
        load_flax_params(tsys.module, params)
    apply = jax.jit(lambda state, segments=None: jsys.module.apply(
        {"params": params}, state, segments=segments))
    return jsys, {"params": params}, apply, tsys


def _compare(out, ref, real, atol=ATOL):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(outs, refs):
        np.testing.assert_allclose(o.detach().numpy()[real], np.asarray(r)[real], atol=atol)


# ---------------------------------------------------------------- CrossAttention


@pytest.mark.parametrize("with_bias", [False, True])
def test_cross_attention_matches_flax(with_bias):
    B, T, Tz, C, H = 3, 9, 5, 32, 4
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    z = rng.normal(size=(B, Tz, C)).astype(np.float32)
    bias = rng.normal(size=(B, 1, T, Tz)).astype(np.float32) if with_bias else None
    mod = JaxCrossAttention(C, H)
    params = _randomize(mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(z))
                        ["params"], 1)
    ref = mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(z),
                    None if bias is None else jnp.asarray(bias))
    attn = CrossAttention(C, H)
    load_flax_params(attn, params)
    out = attn(torch.from_numpy(x), torch.from_numpy(z),
               None if bias is None else torch.from_numpy(bias))
    assert out.shape == (B, T, C)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)


# ------------------------------------------------------- co-occurrence MMF


@pytest.fixture(scope="module")
def coocc_pair():
    return _system_pair("MMF", COOCC)


def test_coocc_bias_matches_flax(coocc_pair):
    _, params, _, tsys = coocc_pair
    tokens = np.random.default_rng(0).integers(0, 9, size=(3, D)).astype(np.int32)
    ref = jpt._CoOccurrenceBias(9, 32, 4).apply(
        {"params": params["params"]["encoder"]["coocc"]}, jnp.asarray(tokens))
    out = tsys.module.encoder.coocc(torch.from_numpy(tokens))
    assert out.shape == (3, 4, D, D) and out.stride(-1) == 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_array_equal(out.detach().numpy(), out.detach().numpy().swapaxes(2, 3))


def test_coocc_particleformer_pair_mask_form(coocc_pair):
    _, _, apply, tsys = coocc_pair
    x, k, mask = _jets(6, [5, 12, 3, 9, 7, 1])
    t = np.linspace(0.1, 0.9, 6).astype(np.float32)
    jstate, state = _states(t, x, k, mask)
    with torch.no_grad():
        out = tsys.module(state)
    _compare(out, apply(jstate), mask[..., 0] > 0)


def test_coocc_particleformer_segment_form_and_packed_equals_per_jet(coocc_pair):
    _, _, apply, tsys = coocc_pair
    mults = [5, 4, 3, 7, 2, 6, 1]
    x, k, mask = _jets(7, mults, seed=1)
    px, pk, row_mask, row_seg, row_of, offset_of = _packed(x, k, mask)
    t = np.full(len(px), 0.37, np.float32)
    jstate, state = _states(t, px, pk, row_mask)
    with torch.no_grad():
        out = tsys.module(state, torch.from_numpy(row_seg))
        per_jet = tsys.module(_states(np.full(7, 0.37, np.float32), x, k, mask)[1])
    _compare(out, apply(jstate, jnp.asarray(row_seg)), row_seg >= 0)
    # the bias covers cross-jet pairs too; the segment mask removes them
    for o, r in zip(out, per_jet):
        for j, m in enumerate(mults):
            ro, of = row_of[j], offset_of[j]
            np.testing.assert_allclose(o[ro, of:of + m].numpy(), r[j, :m].numpy(),
                                       rtol=2e-4, atol=2e-5)


# ----------------------------------------------------- FlavorFormer / KinFormer


@pytest.mark.parametrize("cfg_kw", [FLAVOR, FLAVOR_PACKABLE], ids=["pos_emb", "no_pos_emb"])
def test_flavorformer_matches_flax(cfg_kw):
    _, _, apply, tsys = _system_pair("MJB", cfg_kw)
    assert float(tsys.module.lambda_u.detach()) == pytest.approx(LAMBDA_U)
    x, k, mask = _jets(6, [5, 12, 3, 9, 7, 2], seed=2)
    t = np.linspace(0.1, 0.9, 6).astype(np.float32)
    jstate, state = _states(t, x, k, mask)
    with torch.no_grad():
        _compare(tsys.module(state), apply(jstate), mask[..., 0] > 0)
        # a bucket narrower than the table: positions 0..T-1
        narrow = dict(discrete=k[:, :9], mask=mask[:, :9])
        _compare(tsys.module(MultiModal(time=state.time, **{
                     n: torch.from_numpy(a) for n, a in narrow.items()})),
                 apply(JaxMultiModal(time=jstate.time, **{
                     n: jnp.asarray(a) for n, a in narrow.items()})), mask[:, :9, 0] > 0)
        if not cfg_kw.get("use_pos_emb"):
            px, pk, row_mask, row_seg, _, _ = _packed(x, k, mask)
            tp = np.full(len(px), 0.37, np.float32)
            jp, tp_state = _states(tp, px, pk, row_mask)
            _compare(tsys.module(tp_state, torch.from_numpy(row_seg)),
                     apply(jp, jnp.asarray(row_seg)), row_seg >= 0)
        else:
            with pytest.raises(ValueError, match="positional"):
                tsys.module(state, torch.zeros(6, D, dtype=torch.int32))


def test_lund_observables_match_jax():
    x, _, mask = _jets(4, [5, 12, 1, 8], seed=3)
    x[..., 2] *= 3.0  # phi differences past +-pi exercise the wrap
    mu, sig = KIN["metadata"]["mean"], KIN["metadata"]["std"]
    ref = jpt.lund_observables(JaxMultiModal(continuous=jnp.asarray(x), mask=jnp.asarray(mask)),
                               mu, sig)
    out = pt.lund_observables(MultiModal(continuous=torch.from_numpy(x),
                                         mask=torch.from_numpy(mask)), mu, sig)
    assert out.shape == (4, D, D, 2) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.fixture(scope="module")
def kin_pair():
    return _system_pair("CFM", KIN)


def test_kinformer_lund_matches_flax(kin_pair):
    """pair_chunk 5 < D = 12 (three chunks, the last one short), with the
    dataset metadata, on the pair-mask and the segment forms."""
    _, _, apply, tsys = kin_pair
    assert tsys.config.pair_chunk < D and D % tsys.config.pair_chunk
    x, k, mask = _jets(6, [5, 12, 3, 9, 7, 2], seed=4)
    t = np.linspace(0.1, 0.9, 6).astype(np.float32)
    jstate, state = _states(t, x, k, mask)
    with torch.no_grad():
        _compare(tsys.module(state), apply(jstate), mask[..., 0] > 0)
        px, pk, row_mask, row_seg, _, _ = _packed(x, k, mask)
        tp = np.full(len(px), 0.37, np.float32)
        jp, tp_state = _states(tp, px, pk, row_mask)
        _compare(tsys.module(tp_state, torch.from_numpy(row_seg)),
                 apply(jp, jnp.asarray(row_seg)), row_seg >= 0)


def test_kinformer_wue_ln_is_flax_layernorm_with_eps_1e6(kin_pair):
    _, params, _, tsys = kin_pair
    assert tsys.module.wue_ln.eps == 1e-6
    np.testing.assert_array_equal(tsys.module.wue_ln.weight.detach().numpy(),
                                  params["params"]["wue_ln"]["scale"])
    names = params_from_flax(params["params"])
    assert {"lambda_u", "wue_ln.weight", "wue_ln.bias", "wue_fc.weight"} <= set(names)
    assert names["lambda_u"].shape == ()


# ------------------------------------------------------------------ samplers


def _shared_source(B, seed=0):
    rng = np.random.default_rng(seed)
    mults = rng.integers(2, D + 1, size=B)
    mask = (np.arange(D)[None, :] < mults[:, None]).astype(np.int32)[..., None]
    x0 = (rng.normal(size=(B, D, 3)) * mask).astype(np.float32)
    k0 = (rng.integers(1, 9, size=(B, D, 1)) * mask).astype(np.int32)
    return x0, k0, mask, rng


def _jax_loop(step, state, steps, B, time_eps=1e-5):
    ts, dt = jsolvers.time_grid(time_eps, steps)
    for i in range(steps):
        state = step(i, state.replace(time=jnp.full((B,), ts[i], jnp.float32)), dt)
    return state


def test_mjb_sampler_matches_jax_on_shared_uniforms():
    steps, B = 8, 6
    jsys, params, apply, tsys = _system_pair("MJB", FLAVOR)
    x0, k0, mask, rng = _shared_source(B)
    us = rng.uniform(size=(steps, B, D)).astype(np.float32)
    jsolver = jsolvers.DiscreteSolver(lambda s: apply(s), jsys.bridge_discrete, 9)
    ref = _jax_loop(lambda i, s, dt: jsolver.fwd_step_u(None, jnp.asarray(us[i]), s, dt)[0],
                    JaxMultiModal(discrete=jnp.asarray(k0), mask=jnp.asarray(mask)), steps, B)
    src = MultiModal(time=torch.full((B,), 1e-5), discrete=torch.from_numpy(k0),
                     mask=torch.from_numpy(mask))
    out = tsys.simulate(src, steps, uniforms=torch.from_numpy(us), use_final_max_rates=True)
    real = mask[..., 0] > 0
    same = out.discrete.numpy()[..., 0][real] == np.asarray(ref.discrete)[..., 0][real]
    assert same.mean() >= 0.99 and (out.discrete.numpy() != k0)[real[..., None]].any()


def test_cfm_euler_matches_jax(kin_pair):
    steps, B = 8, 6
    jsys, params, _, tsys = kin_pair
    x0, _, mask, _ = _shared_source(B, seed=1)
    ref = jsys.simulate(params, jax.random.PRNGKey(0),
                        JaxMultiModal(time=jnp.full((B,), 1e-5), continuous=jnp.asarray(x0),
                                      mask=jnp.asarray(mask)), steps)
    src = MultiModal(time=torch.full((B,), 1e-5), continuous=torch.from_numpy(x0),
                     mask=torch.from_numpy(mask))
    out = tsys.simulate(src, steps, temperature=0.5, top_k=None)  # hybrid kwargs ignored
    real = mask[..., 0] > 0
    np.testing.assert_allclose(out.continuous.numpy()[real], np.asarray(ref.continuous)[real],
                               atol=SAMPLER_ATOL)


def test_coocc_mmf_sampler_matches_jax_on_shared_uniforms(coocc_pair):
    steps, B = 8, 6
    jsys, params, apply, tsys = coocc_pair
    x0, k0, mask, rng = _shared_source(B, seed=2)
    us = rng.uniform(size=(steps, B, D)).astype(np.float32)
    jsolver = jsolvers.HybridSolver(lambda s: apply(s), jsys.bridge_discrete, 9)
    ref = _jax_loop(lambda i, s, dt: jsolver.fwd_step_u(None, jnp.asarray(us[i]), s, dt)[0],
                    JaxMultiModal(continuous=jnp.asarray(x0), discrete=jnp.asarray(k0),
                                  mask=jnp.asarray(mask)), steps, B)
    src = MultiModal(time=torch.full((B,), 1e-5), continuous=torch.from_numpy(x0),
                     discrete=torch.from_numpy(k0), mask=torch.from_numpy(mask))
    out = tsys.simulate(src, steps, uniforms=torch.from_numpy(us))
    real = mask[..., 0] > 0
    np.testing.assert_allclose(out.continuous.numpy()[real], np.asarray(ref.continuous)[real],
                               atol=SAMPLER_ATOL)
    same = out.discrete.numpy()[..., 0][real] == np.asarray(ref.discrete)[..., 0][real]
    assert same.mean() >= 0.99


# ---------------------------------------------------------- generation driver


def _pad_masks(mults, width):
    return (np.arange(width)[None, :] < np.asarray(mults)[:, None]).astype(np.int64)[..., None]


@pytest.mark.parametrize("kind,cfg_kw", [("MMF", COOCC), ("MJB", FLAVOR), ("CFM", KIN)],
                         ids=["coocc_mmf", "pos_emb_mjb", "lund_cfm"])
def test_generate_packed_runs_each_system_on_cpu(kind, cfg_kw):
    """Packed rows plus the bucketed tail (MMF, CFM), or bucketed
    throughout (pos-emb FlavorFormer); on the CPU neither kernel runs."""
    cfg = Config(**dict(cfg_kw, max_num_particles=20, pair_chunk=7))
    system = systems.build_system(cfg, kind, device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    if hasattr(system.module, "lambda_u"):
        system.module.lambda_u.data.fill_(LAMBDA_U)
    mults = np.concatenate([np.random.default_rng(1).integers(2, 11, size=20), [15, 20]])
    pad_masks = _pad_masks(mults, 20)
    profiling.take_counters()
    res = generate_packed(system, pad_masks, num_timesteps=3, pack_width=12, batch_size=8)
    s = res.sample
    assert s.continuous.shape == (22, 20, 3) and s.discrete.shape == (22, 20, 1)
    np.testing.assert_array_equal(s.mask.numpy(), pad_masks)
    assert torch.isfinite(s.continuous).all()
    assert ((s.discrete >= 0) & (s.discrete < cfg.vocab_size)).all()
    pad = s.mask[..., 0] == 0
    assert (s.continuous[pad] == 0).all() and (s.discrete[pad] == 0).all()
    assert not any(v for k, v in profiling.peek_counters().items()
                   if k.startswith(("k1.", "k2.")))


def test_unported_modes_raise_with_roadmap_pointer():
    """The solver modes are all ported: each builds, and an unknown method
    raises ValueError as in JAX.  The toy model builds and jet substructure
    computes.  `Config.mesh_shape` is stored and has no effect, as in the
    JAX package.  KinFormer computes in bf16 as JAX's does (bf16 no longer
    raises)."""
    solvers.ContinuousSolver(None, method="euler_maruyama")
    for method in ("tauleap-bernouilli", "euler", "jump_or_stay"):
        solvers.DiscreteSolver(None, None, 9, method=method, top_p=0.9)
    with pytest.raises(ValueError, match="unknown continuous method"):
        solvers.ContinuousSolver(None, method="heun")
    with pytest.raises(ValueError, match="unknown discrete method"):
        solvers.DiscreteSolver(None, None, 9, method="tauleap-bernoulli")
    cfg = Config(model="FlavorFormer", n_embd=16, n_inner=32, n_layer=1, n_head=2,
                 mesh_shape={"data": 2})
    trainer = Trainer(systems.build_system(cfg, "MJB", device="cpu"), cfg)
    assert trainer.mesh is None and trainer.config.mesh_shape == {"data": 2}
    # bf16 compute is ported: KinFormer with its Lund bias in bf16 matches
    # JAX's bf16 forward op for op (the same roundings; fp32 sums in another
    # order), far closer than JAX's bf16 forward is to its fp32 one
    kin16 = dict(KIN, compute_dtype="bfloat16")
    jsys, params, _, tsys = _system_pair("CFM", kin16)
    x, k, mask = _jets(4, [12, 3, 7, 5], seed=3)
    js, ps = _states(np.linspace(0.2, 0.8, 4).astype(np.float32), x, k, mask)
    ref = jax.jit(lambda s: jsys.module.apply(params, s)).lower(js).compile(
        compiler_options={"xla_allow_excess_precision": False})(js)
    ref32 = jax.jit(lambda s: jsystems.CFM(JaxConfig(**KIN)).module.apply(params, s))(js)
    with torch.no_grad():
        out = tsys.module(ps)
    real = mask[..., 0] > 0
    err = float(np.abs(out.numpy()[real] - np.asarray(ref)[real]).max())
    gap = float(np.abs(np.asarray(ref)[real] - np.asarray(ref32)[real]).max())
    assert out.dtype == torch.float32 and err <= 1e-3 and err < gap, (err, gap)
    assert type(build_model(Config(model="ToyMLP", dim_continuous=2))).__name__ == "ToyMLP"
    rng = np.random.default_rng(0)
    jets = MultiModal(continuous=torch.from_numpy(rng.uniform(0.1, 1, (2, 4, 3))).float(),
                      mask=torch.ones(2, 4, 1))
    feats = JetFeatures(jets, compute_substructure=True)
    assert feats.tau21.shape == (2,) and np.isfinite(feats.tau21).all()
