"""The solver modes, filters and thermostats of the port against the JAX
package.  Every token step is split into a deterministic core (the jump
probabilities, the transition matrix, the leave probability and the
destination distribution), held to the probabilities JAX hands its random
draw (captured by replacing `jax.random.bernoulli` / `categorical` for the
call), and a draw, held in distribution (JAX's threefry and torch's Philox
differ) and exactly where the uniforms can be given to both sides.  fp32
on both sides; tolerances are stated in each test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.config import Config as JaxConfig
from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
from multimodal_flows_tpu.dynamics import bridges as jbridges
from multimodal_flows_tpu.dynamics import solvers as jsolvers
from multimodal_flows_tpu.dynamics import thermostats as jthermostats
from multimodal_flows_tpu.train import systems as jsystems
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.convert import load_flax_params
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.dynamics import bridges, solvers, thermostats
from multimodal_flows_tpu_torch.train import systems

torch.set_num_threads(2)

# the cores: the same fp32 expressions on both sides
CORE_RTOL, CORE_ATOL = 1e-6, 1e-7
V = 9


# ------------------------------------------------------------- thermostats


@pytest.mark.parametrize("name", sorted(jthermostats.THERMOSTAT_REGISTRY))
def test_thermostats_match_jax(name):
    """w_ts, wt_0 and wt_1 of every registered thermostat on scalar and
    (B,) times (rtol 1e-6); the registries hold the same names."""
    assert sorted(thermostats.THERMOSTAT_REGISTRY) == sorted(jthermostats.THERMOSTAT_REGISTRY)
    ref = jthermostats.THERMOSTAT_REGISTRY[name](0.075, V)
    out = thermostats.THERMOSTAT_REGISTRY[name](0.075, V)
    t = np.random.default_rng(0).uniform(0.05, 0.9, size=7).astype(np.float32)
    for t0, t1 in ((t, 1.0), (0.3, t + 0.05), (t, t + 0.05), (0.2, 0.7)):
        a = out.w_ts(*(torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                       for x in (t0, t1)))
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(ref.w_ts(t0, t1)), rtol=1e-6)
    for fn in ("wt_0", "wt_1"):
        np.testing.assert_allclose(getattr(out, fn)(torch.from_numpy(t)).numpy(),
                                   np.asarray(getattr(ref, fn)(t)), rtol=2e-6)


@pytest.mark.parametrize("name", ["inverse", "inverse_square"])
def test_thermostats_diverge_at_t0_zero_as_in_jax(name):
    """log(t1 / 0) and 1 / (t1 * 0): no clamp on either side, so both
    give w = exp(-inf) = 0."""
    ref = float(jthermostats.THERMOSTAT_REGISTRY[name](0.075, V).w_ts(0.0, 1.0))
    out = float(thermostats.THERMOSTAT_REGISTRY[name](0.075, V).w_ts(0.0, 1.0))
    assert out == ref == 0.0


def test_rate_with_a_non_constant_thermostat_matches_jax():
    rng = np.random.default_rng(1)
    t = rng.uniform(0.05, 0.95, size=5).astype(np.float32)
    k = rng.integers(0, V, size=(5, 7)).astype(np.int32)
    probs = rng.dirichlet(np.ones(V), size=(5, 7)).astype(np.float32)
    ref = jbridges.RandomTelegraphBridge(0.075, V, jthermostats.SigmoidThermostat(0.075, V)).rate(
        jnp.asarray(t), jnp.asarray(k), jnp.asarray(probs))
    out = bridges.RandomTelegraphBridge(0.075, V, thermostats.SigmoidThermostat(0.075, V)).rate(
        torch.from_numpy(t), torch.from_numpy(k), torch.from_numpy(probs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


# ----------------------------------------------------------------- filters


def _probs(seed=0, shape=(6, 11), ties=True):
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.ones(V) * 0.7, size=shape).astype(np.float32)
    if ties:  # exact ties, at the top-3 threshold of row 0 and at the top of row 1
        p[0, :, :] = np.array([0.3, 0.2, 0.1, 0.1, 0.1, 0.1, 0.05, 0.03, 0.02], np.float32)
        p[1, :, :] = np.array([0.25, 0.25, 0.25, 0.05, 0.05, 0.05, 0.05, 0.03, 0.02], np.float32)
    return p


@pytest.mark.parametrize("k", [1, 3, V - 1, V, V + 4])
def test_top_k_filter_matches_jax(k):
    """Ties at the threshold keep more than k entries; k >= V returns the
    input itself.  Same kept set, values within rtol 1e-6."""
    p = _probs()
    ref = np.asarray(jbridges.top_k_filter(jnp.asarray(p), k))
    out = bridges.top_k_filter(torch.from_numpy(p), k).numpy()
    np.testing.assert_array_equal(out > 0, ref > 0)
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    if k == 3:
        assert (out[0, 0] > 0).sum() == 6      # 0.3, 0.2 and the four tied 0.1s
    if k >= V:
        np.testing.assert_array_equal(out, p)


@pytest.mark.parametrize("p_nucleus", [0.0, 0.2, 0.5, 0.9, 2.0])
def test_top_p_filter_matches_jax(p_nucleus):
    """`cum <= p`, the argmax always kept (p below the top probability
    keeps the argmax and its ties alone; p = 2 keeps everything),
    renormalised with + 1e-8."""
    p = _probs(seed=1)
    ref = np.asarray(jbridges.top_p_filter(jnp.asarray(p), p_nucleus))
    out = bridges.top_p_filter(torch.from_numpy(p), p_nucleus).numpy()
    np.testing.assert_array_equal(out > 0, ref > 0)
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    if p_nucleus == 0.2:
        assert (out[0, 0] > 0).sum() == 1 and (out[1, 0] > 0).sum() == 3   # the tied top
        np.testing.assert_allclose(out[0, 0, 0], 1.0 / (1.0 + 1e-8 / 0.3), rtol=1e-6)


@pytest.mark.parametrize("top_k,top_p", [(None, None), (3, None), (None, 0.8), (4, 0.9)])
def test_filtered_probs_and_per_class_temperature_match_jax(top_k, top_p):
    logits = np.random.default_rng(2).normal(size=(5, 7, V)).astype(np.float32) * 2
    ref = jsolvers._filtered_probs(jnp.asarray(logits), 0.7, top_k, top_p)
    out = solvers._filtered_probs(torch.from_numpy(logits), 0.7, top_k, top_p)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-6, atol=CORE_ATOL)
    assert solvers.REFERENCE_CLASS_FREQS == jsolvers.REFERENCE_CLASS_FREQS
    ref = jsolvers._per_class_temperature(jnp.asarray(logits), 0.7, jsolvers.REFERENCE_CLASS_FREQS)
    out = solvers._per_class_temperature(torch.from_numpy(logits), 0.7,
                                         solvers.REFERENCE_CLASS_FREQS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


# ------------------------------------------------- the token steps' cores


def _step_inputs(B=64, D=40, seed=3):
    """Tokens, model probabilities, telegraph rates at per-jet times, and
    a large dt (so many sites jump and rates * dt reaches the clip)."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.05, 0.97, size=B).astype(np.float32)
    k = rng.integers(0, V, size=(B, D)).astype(np.int32)
    probs = rng.dirichlet(np.ones(V) * 0.5, size=(B, D)).astype(np.float32)
    rates = np.array(jbridges.RandomTelegraphBridge(0.075, V).rate(
        jnp.asarray(t), jnp.asarray(k), jnp.asarray(probs)))
    return k, probs, rates, np.float32(0.05)


def _capture(monkeypatch, name):
    """Replace jax.random.<name> so that it records the probabilities (or
    logits) it is asked to draw from."""
    seen = []

    def fake(key, p, *a, **kw):
        seen.append(np.asarray(p))
        return jnp.zeros(np.shape(p)[:-1] if name == "categorical" else np.shape(p),
                         jnp.int32 if name == "categorical" else bool)

    monkeypatch.setattr(jax.random, name, fake)
    return seen


def test_bernoulli_tauleap_core_matches_jax(monkeypatch):
    k, _, rates, dt = _step_inputs()
    seen = _capture(monkeypatch, "bernoulli")
    jsolvers._bernoulli_tauleap_tokens(jax.random.PRNGKey(0), jnp.asarray(k),
                                       jnp.asarray(rates), dt, V)
    out = solvers._bernoulli_tauleap_probs(torch.from_numpy(rates), torch.tensor(dt))
    assert out.shape == rates.shape and float(out.max()) == 1.0
    np.testing.assert_allclose(out.numpy(), seen[0], rtol=CORE_RTOL, atol=CORE_ATOL)


@pytest.mark.parametrize("top_k,top_p", [(None, None), (3, None), (None, 0.9), (3, 0.9)])
def test_euler_transition_core_matches_jax(monkeypatch, top_k, top_p):
    """The (B, D, S) transition matrix JAX draws from (exp of its clipped
    logits) against the port's: a class the filters removed is 1e-30 in
    JAX's logits and exactly 0 here."""
    k, _, rates, dt = _step_inputs()
    seen = _capture(monkeypatch, "categorical")
    jsolvers._euler_transition_tokens(jax.random.PRNGKey(0), jnp.asarray(k),
                                      jnp.asarray(rates), dt, top_k, top_p, V)
    out = solvers._euler_transition_probs(torch.from_numpy(k), torch.from_numpy(rates),
                                          torch.tensor(dt), top_k, top_p, V).numpy()
    ref = np.exp(seen[0])
    np.testing.assert_allclose(out, np.where(ref <= 1e-30, 0.0, ref), rtol=2e-6, atol=CORE_ATOL)
    assert (out.sum(-1) > 0).all()


def test_jump_or_stay_core_matches_jax(monkeypatch):
    k, probs, rates, dt = _step_inputs()
    p_leave, logits = _capture(monkeypatch, "bernoulli"), _capture(monkeypatch, "categorical")
    jsolvers._jump_or_stay_tokens(jax.random.PRNGKey(0), jnp.asarray(k), jnp.asarray(rates),
                                  jnp.asarray(probs), dt, V)
    out_leave, out_dest = solvers._jump_or_stay_probs(
        torch.from_numpy(k), torch.from_numpy(rates), torch.from_numpy(probs),
        torch.tensor(dt), V)
    np.testing.assert_allclose(out_leave.numpy(), p_leave[0], rtol=CORE_RTOL, atol=CORE_ATOL)
    ref = np.exp(logits[0])
    np.testing.assert_allclose(out_dest.numpy(), np.where(ref <= 1e-30, 0.0, ref),
                               rtol=2e-6, atol=CORE_ATOL)
    onehot = np.eye(V, dtype=bool)[k]
    assert (out_dest.numpy()[onehot] == 0).all()      # never back to the current class


# ------------------------------------------------------------ the draws


def test_sample_categorical_inverts_the_cdf_exactly():
    """With given uniforms the draw is the CDF's inverse: the class c with
    cdf[c-1] <= u * total < cdf[c]; a class of probability 0 is never
    drawn, not at u = 0 either."""
    p = torch.tensor([[0.0, 0.2, 0.0, 0.5, 0.3], [1.0, 0.0, 0.0, 0.0, 0.0]]) * 2.0  # unnormalised
    for u, want in ((0.0, [1, 0]), (0.19, [1, 0]), (0.21, [3, 0]), (0.69, [3, 0]),
                    (0.71, [4, 0]), (0.999999, [4, 0])):
        got = bridges.sample_categorical(None, p, torch.full((2,), u))
        assert got.tolist() == want, u


def _chi2_ok(counts, expected, dof_slack=6.0):
    """Pearson chi-square of observed counts against expected ones: below
    dof + 6 sqrt(2 dof), a bound a correct sampler passes with p > 1 - 1e-6."""
    keep = expected > 0
    assert (counts[~keep] == 0).all()
    chi2 = ((counts[keep] - expected[keep]) ** 2 / expected[keep]).sum()
    dof = keep.sum() - 1
    return chi2 < dof + dof_slack * np.sqrt(2 * dof), chi2


def test_draws_follow_their_cores_in_distribution():
    """Every draw on 64 x 400 = 25.6k sites sharing one core row: the
    Bernoulli tau-leap's per-class jump frequencies within 5 sigma, the
    euler and jump-or-stay destinations by chi-square."""
    B, D = 64, 400
    k1, probs1, rates1, dt = _step_inputs(B=1, D=1, seed=5)
    k = torch.from_numpy(np.broadcast_to(k1, (B, D)).copy())
    rates = torch.from_numpy(np.broadcast_to(rates1, (B, D, V)).copy())
    probs = torch.from_numpy(np.broadcast_to(probs1, (B, D, V)).copy())
    dt = torch.tensor(dt)
    gen = torch.Generator().manual_seed(0)
    n = B * D

    p_jump = solvers._bernoulli_tauleap_probs(rates, dt)[0, 0].numpy()
    u = torch.rand((B, D, V), generator=gen)
    freq = (u < torch.from_numpy(p_jump)).float().mean(dim=(0, 1)).numpy()
    assert (np.abs(freq - p_jump) <= 5 * np.sqrt(p_jump * (1 - p_jump) / n) + 1e-12).all()

    out = solvers._euler_transition_tokens(torch.rand((B, D), generator=gen), k, rates, dt,
                                           None, None, V)
    p = solvers._euler_transition_probs(k, rates, dt, None, None, V)[0, 0].numpy()
    ok, chi2 = _chi2_ok(np.bincount(out.reshape(-1).numpy(), minlength=V), n * p / p.sum())
    assert ok, chi2

    out = solvers._jump_or_stay_tokens(torch.rand((B, D, 2), generator=gen), k, rates, probs,
                                       dt, V)
    p_leave, dest = (a[0, 0].numpy() for a in solvers._jump_or_stay_probs(k, rates, probs, dt, V))
    expected = n * p_leave * dest
    expected[int(k1[0, 0])] = n * (1 - p_leave)
    ok, chi2 = _chi2_ok(np.bincount(out.reshape(-1).numpy(), minlength=V), expected)
    assert ok, chi2
    assert out.dtype == torch.int32


def test_bernoulli_tauleap_tokens_match_jax_on_injected_indicators(monkeypatch):
    """The same jump indicators on both sides (JAX's bernoulli replaced by
    u < p on the port's uniforms): identical tokens, including the sites
    with several jumps whose sum leaves [0, V) and wraps by the
    non-negative remainder."""
    k, _, rates, dt = _step_inputs()
    u = np.random.default_rng(6).uniform(size=rates.shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, *a: jnp.asarray(u) < p)
    ref = np.asarray(jsolvers._bernoulli_tauleap_tokens(jax.random.PRNGKey(0), jnp.asarray(k),
                                                        jnp.asarray(rates), dt, V))
    out = solvers._bernoulli_tauleap_tokens(torch.from_numpy(u), torch.from_numpy(k),
                                            torch.from_numpy(rates), torch.tensor(dt), V).numpy()
    # an indicator flips only where u is within float error of the probability
    clear = (np.abs(np.clip(rates * dt, None, 1.0) - u) > 1e-6).all(-1)
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(out[clear], ref[clear])
    raw = k + ((u < np.clip(rates * dt, None, 1.0)) * (np.arange(V)[None, None] - k[..., None])
               ).sum(-1)
    assert (raw < 0).any() and (raw >= V).any()       # the wrap was exercised
    assert out.min() >= 0 and out.max() < V and out.dtype == np.int32


def test_euler_maruyama_step_matches_jax_on_injected_normals(monkeypatch):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 6, 3)).astype(np.float32)
    dw = rng.normal(size=x.shape).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=None: jnp.asarray(dw))
    jsolver = jsolvers.ContinuousSolver(lambda s: 2.0 * s.continuous, lambda s: 0.3,
                                        method="euler_maruyama")
    ref = jsolver.fwd_step(jax.random.PRNGKey(0), JaxMultiModal(continuous=jnp.asarray(x)),
                           jnp.float32(0.1))
    solver = solvers.ContinuousSolver(lambda s: 2.0 * s.continuous, lambda s: 0.3,
                                      method="euler_maruyama")
    out = solver.fwd_step_u(torch.from_numpy(dw), MultiModal(continuous=torch.from_numpy(x)),
                            torch.tensor(0.1))
    np.testing.assert_allclose(out.continuous.numpy(), np.asarray(ref.continuous), rtol=1e-6)
    drawn = solver.step_noise(torch.Generator().manual_seed(0),
                              MultiModal(continuous=torch.zeros(64, 64, 3)))
    assert abs(float(drawn.mean())) < 0.05 and abs(float(drawn.std()) - 1) < 0.05
    assert solvers.ContinuousSolver(None).step_noise(None, None) is None      # euler: no noise
    assert bridges.UniformFlow(0.1).diffusion(None) == jbridges.UniformFlow(0.1).diffusion(None)


# ----------------------------------------------- the solvers, whole steps

SMALL = dict(n_embd=32, n_inner=64, n_layer=1, n_layer_fused=1, n_head=2, vocab_size=V,
             dim_continuous=3, max_num_particles=10)


def _pair(kind, cfg_kw):
    jsys = jsystems.SYSTEM_REGISTRY[kind](JaxConfig(**cfg_kw))
    params = jax.jit(jsys.init_params)(jax.random.PRNGKey(0))
    tsys = systems.build_system(Config(**cfg_kw), kind, device="cpu")
    load_flax_params(tsys.module, jax.tree.map(np.asarray, params["params"]))
    return jsys, params, tsys


def _source(B=6, D=10, seed=8):
    rng = np.random.default_rng(seed)
    mults = rng.integers(2, D + 1, size=B)
    mask = (np.arange(D)[None, :] < mults[:, None]).astype(np.int32)[..., None]
    x0 = (rng.normal(size=(B, D, 3)) * mask).astype(np.float32)
    k0 = (rng.integers(1, V, size=(B, D, 1)) * mask).astype(np.int32)
    return x0, k0, mask


@pytest.mark.parametrize("class_freqs", [None, list(jsolvers.REFERENCE_CLASS_FREQS)],
                         ids=["scalar_T", "class_freqs"])
def test_hybrid_euler_step_matches_jax(monkeypatch, class_freqs):
    """One hybrid `euler` step at temperature 0.8 with top_k=5: the
    kinematics (atol 1e-5), the rates and the transition matrix handed to
    the draw (rtol 1e-4: they went through the model) against JAX, with
    the scalar and with the per-class temperature."""
    cfg_kw = dict(SMALL, model="ParticleFormer", hybrid_solver="euler", class_freqs=class_freqs)
    jsys, params, tsys = _pair("MMF", cfg_kw)
    x0, k0, mask = _source()
    seen = _capture(monkeypatch, "categorical")
    jsolver = jsys.make_solver(params, temperature=0.8, top_k=5)
    assert not jsolver.uses_single_uniform
    jstate = JaxMultiModal(time=jnp.full((6,), 0.4), continuous=jnp.asarray(x0),
                           discrete=jnp.asarray(k0), mask=jnp.asarray(mask))
    jout, jrates = jsolver.fwd_step(jax.random.PRNGKey(0), jstate, jnp.float32(0.02))

    solver = tsys.make_solver(temperature=0.8, top_k=5)
    assert not solver.uses_single_uniform and solver.class_freqs == class_freqs
    state = MultiModal(time=torch.full((6,), 0.4), continuous=torch.from_numpy(x0),
                       discrete=torch.from_numpy(k0), mask=torch.from_numpy(mask))
    with torch.no_grad():
        u = solver.step_noise(torch.Generator().manual_seed(0), state)
        out, rates = solver.fwd_step_u(u, state, torch.tensor(0.02))
        matrix = solvers._euler_transition_probs(state.discrete[..., 0], rates,
                                                 torch.tensor(0.02), 5, None, V)
    real = mask[..., 0] > 0
    np.testing.assert_allclose(out.continuous.numpy()[real], np.asarray(jout.continuous)[real],
                               atol=1e-5)
    np.testing.assert_allclose(rates.numpy()[real], np.asarray(jrates)[real], rtol=1e-4)
    ref = np.exp(seen[0])
    np.testing.assert_allclose(matrix.numpy()[real], np.where(ref <= 1e-30, 0.0, ref)[real],
                               rtol=1e-4, atol=1e-7)
    assert out.discrete.shape == (6, 10, 1) and out.discrete.dtype == torch.int32
    assert (matrix.gather(-1, out.discrete.long()) > 0)[torch.from_numpy(real)].all()


@pytest.mark.parametrize("method", ["tauleap-bernouilli", "euler", "jump_or_stay"])
def test_simulate_runs_each_discrete_method_from_a_generator(method):
    """MJB through `simulate`'s per-step branch: tokens in [0, V), the same
    generator seed gives the same trajectory, another seed another, and
    injected uniforms of the step's noise shape replace the draws."""
    cfg = Config(**dict(SMALL, model="FlavorFormer", markov_jump_solver=method))
    tsys = systems.build_system(cfg, "MJB", device="cpu",
                                generator=torch.Generator().manual_seed(0))
    x0, k0, mask = _source(B=8)
    src = MultiModal(time=torch.full((8,), 1e-5), continuous=torch.from_numpy(x0),
                     discrete=torch.from_numpy(k0), mask=torch.from_numpy(mask))
    outs = [tsys.simulate(src, 6, temperature=0.9, top_p=0.95,
                          generator=torch.Generator().manual_seed(s)).discrete for s in (0, 0, 1)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    assert outs[0].dtype == torch.int32 and int(outs[0].min()) >= 0 and int(outs[0].max()) < V
    tail = {"tauleap-bernouilli": (V,), "euler": (), "jump_or_stay": (2,)}[method]
    us = torch.rand((6, 8, 10) + tail, generator=torch.Generator().manual_seed(3))
    a, b = (tsys.simulate(src, 6, uniforms=us).discrete for _ in range(2))
    assert torch.equal(a, b)


def test_cfm_euler_maruyama_runs_and_is_euler_at_zero_diffusion():
    """The CFM system's bridge has diffusion 0, as in JAX, so its
    euler_maruyama trajectory equals its euler one exactly."""
    cfg = Config(**dict(SMALL, model="KinFormer"))
    tsys = systems.build_system(cfg, "CFM", device="cpu",
                                generator=torch.Generator().manual_seed(0))
    x0, _, mask = _source()
    src = MultiModal(time=torch.full((6,), 1e-5), continuous=torch.from_numpy(x0),
                     mask=torch.from_numpy(mask))
    euler = tsys.simulate(src, 5)
    em = tsys.simulate(src, 5, method="euler_maruyama", generator=torch.Generator().manual_seed(0))
    assert torch.equal(euler.continuous, em.continuous)
    with pytest.raises(ValueError, match="unknown continuous method"):
        tsys.simulate(src, 5, method="rk4")
