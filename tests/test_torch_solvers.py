"""The port's hybrid tau-leap sampler against the JAX package: the time
grid, the telegraph rate, the tau-leap token update on shared uniforms,
and an 8-step trajectory of a small model from the same source with the
same (steps, B, D) uniforms fed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.config import Config as JaxConfig
from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
from multimodal_flows_tpu.dynamics import solvers as jsolvers
from multimodal_flows_tpu.dynamics.bridges import RandomTelegraphBridge as JaxBridge
from multimodal_flows_tpu.train.systems import MMF as JaxMMF
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.convert import load_flax_params
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.dynamics import solvers
from multimodal_flows_tpu_torch.dynamics.bridges import RandomTelegraphBridge, UniformFlow
from multimodal_flows_tpu_torch.train.systems import MMF

torch.set_num_threads(2)

SMALL = dict(model="ParticleFormer", n_embd=32, n_inner=64, n_layer=2, n_layer_fused=1,
             n_head=4, vocab_size=9, dim_continuous=3, max_num_particles=12)


@pytest.mark.parametrize("steps", [2, 8, 100, 1000])
def test_time_grid_matches_jax(steps):
    ts, dt = solvers.time_grid(1e-5, steps)
    jts, jdt = jsolvers.time_grid(1e-5, steps)
    np.testing.assert_allclose(ts.numpy(), np.asarray(jts), rtol=1e-6)
    np.testing.assert_allclose(float(dt), float(jdt), rtol=1e-6)


def _rate_inputs(B=5, D=7, V=9, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(1e-5, 0.99, size=B).astype(np.float32)
    k = rng.integers(0, V, size=(B, D)).astype(np.int32)
    logits = rng.normal(size=(B, D, V)).astype(np.float32) * 2
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return t, k, probs.astype(np.float32)


def test_rate_matches_jax():
    t, k, probs = _rate_inputs()
    ref = JaxBridge(0.075, 9).rate(jnp.asarray(t), jnp.asarray(k), jnp.asarray(probs))
    out = RandomTelegraphBridge(0.075, 9).rate(torch.from_numpy(t), torch.from_numpy(k),
                                               torch.from_numpy(probs))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("per_jet", [None, "t_in", "t_out"])
def test_conditional_probability_matches_jax(per_jet):
    """Scalar times, or per-jet (B,) times on either side."""
    t, k, _ = _rate_inputs()
    k2 = np.roll(k, 1, axis=1)
    times = {"t_in": 0.0, "t_out": 1.0}
    if per_jet:
        times[per_jet] = t
    ref = JaxBridge(0.075, 9).conditional_probability(
        *(v if isinstance(v, float) else jnp.asarray(v) for v in times.values()),
        jnp.asarray(k), jnp.asarray(k2))
    out = RandomTelegraphBridge(0.075, 9).conditional_probability(
        *(v if isinstance(v, float) else torch.from_numpy(v) for v in times.values()),
        torch.from_numpy(k), torch.from_numpy(k2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_poisson_tauleap_tokens_match_jax():
    """Equal tokens wherever u is more than 1e-5 from a threshold (a tie
    within float error may fall either way)."""
    t, k, probs = _rate_inputs(B=64, D=32)
    rates = np.array(JaxBridge(0.075, 9).rate(jnp.asarray(t), jnp.asarray(k),
                                              jnp.asarray(probs)))
    u = np.random.default_rng(1).uniform(size=k.shape).astype(np.float32)
    dt = np.float32(0.05)  # large steps, so many sites jump
    ref = np.asarray(jsolvers._poisson_tauleap_tokens(jnp.asarray(u), jnp.asarray(k),
                                                      jnp.asarray(rates), dt, 9))
    out = solvers._poisson_tauleap_tokens(torch.from_numpy(u), torch.from_numpy(k),
                                          torch.from_numpy(rates), torch.tensor(dt), 9).numpy()
    rdt = rates.astype(np.float64) * dt
    base = np.exp(-rdt.sum(-1, keepdims=True))
    thresholds = np.concatenate([base, base * (1 + np.cumsum(rdt, -1))], -1)
    clear = np.abs(thresholds - u[..., None]).min(-1) > 1e-5
    assert clear.mean() > 0.99 and (ref != k).mean() > 0.1
    np.testing.assert_array_equal(out[clear], ref[clear])
    assert out.dtype == np.int32


def test_draw_sources_are_masked():
    """Mirrors tests/test_bridges.py:79-83."""
    mask = torch.from_numpy((np.arange(3)[None, :] < np.array([1, 2, 3, 0])[:, None])
                            .astype(np.int32)[..., None])
    gen = torch.Generator().manual_seed(0)
    x0 = UniformFlow(1e-5).draw_source(gen, torch.zeros(4, 3, 2), mask)
    k0 = RandomTelegraphBridge(0.075, 9).draw_source(gen, (4, 3, 1), mask)
    assert x0.shape == (4, 3, 2) and k0.shape == (4, 3, 1) and k0.dtype == torch.int32
    assert (x0[mask[..., 0] == 0] == 0).all() and (k0[mask == 0] == 0).all()
    assert ((k0[mask > 0] >= 1) & (k0[mask > 0] < 9)).all()


def test_unported_solver_options_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solvers.HybridSolver(None, None, 9, method="euler")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solvers.HybridSolver(None, None, 9, top_k=3)


def test_simulate_matches_jax_on_shared_noise():
    """8 steps of the small model from one source with one set of
    uniforms: JAX loops `HybridSolver.fwd_step_u` over `time_grid` (its
    own `simulate` draws the uniforms inside)."""
    steps, B, D = 8, 6, 12
    jsys = JaxMMF(JaxConfig(**SMALL))
    params = jax.jit(jsys.init_params)(jax.random.PRNGKey(0))
    tsys = MMF(Config(**SMALL), device="cpu")
    load_flax_params(tsys.module.encoder,
                     jax.tree.map(np.asarray, params["params"]["encoder"]))

    rng = np.random.default_rng(0)
    mults = rng.integers(2, D + 1, size=B)
    mask = (np.arange(D)[None, :] < mults[:, None]).astype(np.int32)[..., None]
    x0 = (rng.normal(size=(B, D, 3)) * mask).astype(np.float32)
    k0 = (rng.integers(1, 9, size=(B, D, 1)) * mask).astype(np.int32)
    us = rng.uniform(size=(steps, B, D)).astype(np.float32)

    apply = jax.jit(lambda s: jsys.module.apply(params, s))
    jsolver = jsolvers.HybridSolver(apply, jsys.bridge_discrete, 9)
    ts, dt = jsolvers.time_grid(jsys.config.time_eps, steps)
    state = JaxMultiModal(continuous=jnp.asarray(x0), discrete=jnp.asarray(k0),
                          mask=jnp.asarray(mask))
    for i in range(steps):
        state = state.replace(time=jnp.full((B,), ts[i], jnp.float32))
        state, _ = jsolver.fwd_step_u(None, jnp.asarray(us[i]), state, dt)

    src = MultiModal(time=torch.full((B,), 1e-5), continuous=torch.from_numpy(x0),
                     discrete=torch.from_numpy(k0), mask=torch.from_numpy(mask))
    out = tsys.simulate(src, steps, uniforms=torch.from_numpy(us))

    real = mask[..., 0] > 0
    np.testing.assert_allclose(out.continuous.numpy()[real],
                               np.asarray(state.continuous)[real], atol=1e-4)
    same = out.discrete.numpy()[..., 0][real] == np.asarray(state.discrete)[..., 0][real]
    assert same.mean() >= 0.99
