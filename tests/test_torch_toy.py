"""The toy model and `simulate(return_trajectory=True)` in the port against
the JAX package: `TimeFourierEmbedding` and `ToyMLP` on converted weights,
the toy datasets, the trained tutorial checkpoint of `notebooks/toy_out`
(forward and a 200-step trajectory on shared uniforms: the first parity test
on weights that did not come from an initialiser), trajectories of MMF, CFM
and MJB with the shape and time of every entry, and a short closure of the
tutorial on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.config import Config as JaxConfig
from multimodal_flows_tpu.data import toy as jtoy
from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
from multimodal_flows_tpu.models import blocks as jblocks
from multimodal_flows_tpu.train import systems as jsystems
from multimodal_flows_tpu_torch.cli import toy_tutorial
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.convert import load_flax_params, params_from_flax
from multimodal_flows_tpu_torch.data import toy
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.models import blocks
from multimodal_flows_tpu_torch.models.registry import build_model
from multimodal_flows_tpu_torch.train import systems
from multimodal_flows_tpu_torch.utils import profiling

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_CHECKPOINT = os.path.join(REPO, "notebooks", "toy_out", "toy", "88de46a88ff78736",
                              "checkpoints", "last")
# fp32 on both sides; a forward within 1e-5, a trajectory of up to 200 Euler
# steps within 1e-4 (the bounds of the other samplers), tokens equal on at
# least 0.99 of the sites: a uniform within rounding of a threshold may fall
# either way
FORWARD_ATOL, TRAJECTORY_ATOL, TOKENS_EQUAL = 1e-5, 1e-4, 0.99


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _toy_cfg_kw():
    kw = toy_tutorial.toy_config().to_dict()
    kw.pop("experiment_id")
    return kw


@pytest.mark.parametrize("dim,shape", [(128, (7,)), (128, (7, 1)), (16, (5,)), (6, (3,))])
def test_time_fourier_embedding_matches_jax(dim, shape):
    t = np.random.default_rng(0).uniform(1e-5, 1.0, size=shape).astype(np.float32)
    module = blocks.TimeFourierEmbedding(dim)
    assert not list(module.parameters())
    out = module(torch.from_numpy(t))
    ref = jblocks.TimeFourierEmbedding(dim).apply({}, jnp.asarray(t))
    assert out.shape == (shape[0], 2 * (dim // 2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def _toy_state(B, seed, D=1):
    rng = np.random.default_rng(seed)
    return dict(time=rng.uniform(1e-5, 1.0, size=B).astype(np.float32),
                continuous=(rng.normal(size=(B, D, 2)) * 3).astype(np.float32),
                discrete=rng.integers(0, 9, size=(B, D, 1)).astype(np.int32),
                mask=np.ones((B, D, 1), np.int32))


@pytest.mark.parametrize("n_layer,n_inner,D", [(3, 128, 1), (1, 32, 1), (0, None, 4)])
def test_toy_mlp_matches_jax_on_converted_weights(n_layer, n_inner, D):
    """`ToyMLP` on weights from a flax initialiser, loaded by the
    converter's Dense rule (no rule of its own): `fc{i}`, `head_x`,
    `head_y`; the one-hot of tokens 0..8 and the exact GELU."""
    kw = dict(_toy_cfg_kw(), n_layer=n_layer, n_inner=n_inner, max_num_particles=D)
    jsys = jsystems.MMF(JaxConfig(**kw))
    params = _np(jsys.init_params(jax.random.PRNGKey(1)))
    # biases start at 0: give them values, so that a swapped bias shows
    rng = np.random.default_rng(2)
    params = jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
                          if a.ndim == 1 else a, params)
    tsys = systems.MMF(Config(**kw), device="cpu")
    load_flax_params(tsys.module, params["params"])
    names = {n for n, _ in tsys.module.named_parameters()}
    layers = [f"fc{i}" for i in range(max(n_layer, 1))] + ["head_x", "head_y"]
    assert names == {f"encoder.{m}.{p}" for m in layers for p in ("weight", "bias")}
    assert len(params_from_flax(params["params"])) == len(jax.tree.leaves(params))

    state = _toy_state(6, seed=3, D=D)
    vt, logits = tsys.module(MultiModal(**{k: torch.from_numpy(v) for k, v in state.items()}))
    jvt, jlogits = jsys.module.apply(params, JaxMultiModal(**state))
    assert vt.shape == (6, D, 2) and logits.shape == (6, D, 9)
    np.testing.assert_allclose(vt.detach().numpy(), np.asarray(jvt), atol=FORWARD_ATOL)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=FORWARD_ATOL)
    with pytest.raises(ValueError, match="packed rows"):
        build_model(Config(**kw))(MultiModal(), segments=torch.zeros(1, 1))


def test_toy_datasets_are_the_same_arrays():
    for ours, theirs in ((toy.NGaussians(num_points_per_gaussian=50, seed=3),
                          jtoy.NGaussians(num_points_per_gaussian=50, seed=3)),
                         (toy.TwoMoons(num_points_per_moon=70, seed=4),
                          jtoy.TwoMoons(num_points_per_moon=70, seed=4))):
        assert len(ours) == len(theirs)
        np.testing.assert_array_equal(ours.continuous, theirs.continuous)
        np.testing.assert_array_equal(ours.discrete, theirs.discrete)
        a, b = ours.as_clouds(), theirs.as_clouds()
        for field in ("continuous", "discrete", "mask"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    coupling = toy_tutorial.toy_coupling(80)
    assert coupling.source.shape == coupling.target.shape == (80, 1)
    assert set(np.unique(coupling.source.discrete)) == set(range(1, 9))
    assert set(np.unique(coupling.target.discrete)) == {1, 2}


# ------------------------------------------------- the trained checkpoint


@pytest.fixture(scope="module")
def trained_toy():
    """The tutorial's trained orbax checkpoint as numpy, in both systems.
    orbax is used here only: the port never imports it."""
    import orbax.checkpoint as ocp

    restored = _np(ocp.StandardCheckpointer().restore(TOY_CHECKPOINT))
    assert int(restored["epoch"]) == 20
    params = restored["params"]
    kw = _toy_cfg_kw()
    jsys = jsystems.MMF(JaxConfig(**kw))
    # the saved tree is today's ToyMLP tree, leaf for leaf
    want = jax.eval_shape(jsys.init_params, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: a.shape, params) == jax.tree.map(lambda a: a.shape, want)
    tsys = systems.MMF(Config(**kw), device="cpu")
    load_flax_params(tsys.module, params["params"])
    return jsys, params, tsys


def test_trained_toy_forward_matches_jax(trained_toy):
    jsys, params, tsys = trained_toy
    assert float(np.abs(params["params"]["encoder"]["head_x"]["bias"]).max()) > 1e-3  # trained
    state = _toy_state(512, seed=5)
    with torch.no_grad():
        vt, logits = tsys.module(MultiModal(**{k: torch.from_numpy(v)
                                               for k, v in state.items()}))
    jvt, jlogits = jsys.module.apply(params, JaxMultiModal(**state))
    assert float(np.abs(np.asarray(jvt)).max()) > 1.0      # drifts of the data's scale
    # trained logits reach magnitude 20: fp32 rounding is relative there
    np.testing.assert_allclose(vt.numpy(), np.asarray(jvt), atol=FORWARD_ATOL, rtol=2e-6)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=FORWARD_ATOL,
                               rtol=2e-6)


def test_trained_toy_trajectory_matches_jax_on_shared_uniforms(trained_toy):
    """200 steps from 400 fresh 8-Gaussians points: every entry of the
    trajectory against JAX's `lax.scan` outputs, the uniforms being the
    ones JAX draws from its key."""
    jsys, params, tsys = trained_toy
    steps, n = 200, 400
    key = jax.random.PRNGKey(42)
    us = np.array(jax.random.uniform(key, (steps, n, 1), dtype=jnp.float32))
    src = toy_tutorial.generation_source(tsys.config, n, "cpu")
    jsrc = JaxMultiModal(**{f: jnp.asarray(getattr(src, f).numpy())
                            for f in ("time", "continuous", "discrete", "mask")})
    jfinal, jtraj = jsys.simulate(params, key, jsrc, steps, return_trajectory=True)
    profiling.take_counters()
    final, traj = tsys.simulate(src, steps, uniforms=torch.from_numpy(us),
                                return_trajectory=True)
    assert not any(v for k, v in profiling.peek_counters().items()
                   if k.startswith(("k1.", "k2.")))   # no attention at all

    assert traj.continuous.shape == (steps, n, 1, 2) and traj.discrete.shape == (steps, n, 1, 1)
    assert traj.mask.shape == (steps, n, 1, 1) and traj.time.shape == (steps, n)
    np.testing.assert_allclose(traj.time.numpy(), np.asarray(jtraj.time), rtol=1e-6)
    same = traj.discrete.numpy() == np.asarray(jtraj.discrete)
    assert same.mean() >= TOKENS_EQUAL
    # positions: the points whose labels agree along the whole path (a
    # label that flipped the other way changes the drift from then on)
    agree = same.all(axis=(0, 2, 3))
    assert agree.mean() >= TOKENS_EQUAL
    np.testing.assert_allclose(traj.continuous.numpy()[:, agree],
                               np.asarray(jtraj.continuous)[:, agree], atol=TRAJECTORY_ATOL)
    np.testing.assert_array_equal(final.discrete.numpy(), traj.discrete[-1].numpy())
    np.testing.assert_allclose(final.continuous.numpy()[agree],
                               np.asarray(jfinal.continuous)[agree], atol=TRAJECTORY_ATOL)
    # the trained flow does its job: most points end on labels 1 and 2
    assert np.isin(final.discrete.numpy(), (1, 2)).mean() > 0.8


# ------------------------------------- return_trajectory, the three systems

SMALL = dict(n_embd=32, n_inner=64, n_layer=1, n_layer_fused=1, n_head=2, vocab_size=9,
             dim_continuous=3, max_num_particles=7)
TRAJECTORY_CASES = {
    "MMF": ("MMF", dict(SMALL, model="ParticleFormer"), {}),
    "MMF_final_max_rates": ("MMF", dict(SMALL, model="ParticleFormer"),
                            dict(use_final_max_rates=True)),
    "CFM": ("CFM", dict(SMALL, model="KinFormer"), {}),
    "MJB": ("MJB", dict(SMALL, model="FlavorFormer"), dict(temperature=0.8)),
}


def _source(kind, B=5, D=7, seed=0):
    rng = np.random.default_rng(seed)
    mult = rng.integers(2, D + 1, size=B)
    mask = (np.arange(D)[None, :] < mult[:, None]).astype(np.int32)[..., None]
    fields = dict(time=np.full(B, 1e-5, np.float32), mask=mask)
    if kind != "MJB":
        fields["continuous"] = (rng.normal(size=(B, D, 3)) * mask).astype(np.float32)
    if kind != "CFM":
        fields["discrete"] = (rng.integers(1, 9, size=(B, D, 1)) * mask).astype(np.int32)
    return fields


@pytest.mark.parametrize("case", sorted(TRAJECTORY_CASES))
def test_return_trajectory_matches_jax(case):
    """F2: `simulate(return_trajectory=True)` returns (final, trajectory)
    for every system; each entry is the state after that step with its
    time, as JAX's scan outputs; `use_final_max_rates` overrides the final
    tokens only."""
    kind, cfg_kw, sim_kw = TRAJECTORY_CASES[case]
    steps, B, D = 6, 5, 7
    jsys = jsystems.SYSTEM_REGISTRY[kind](JaxConfig(**cfg_kw))
    params = _np(jsys.init_params(jax.random.PRNGKey(0)))
    tsys = systems.build_system(Config(**cfg_kw), kind, device="cpu")
    load_flax_params(tsys.module, params["params"])

    fields = _source(kind)
    key = jax.random.PRNGKey(7)
    jfinal, jtraj = jsys.simulate(params, key, JaxMultiModal(**fields), steps,
                                  return_trajectory=True, **sim_kw)
    noise = {} if kind == "CFM" else dict(uniforms=torch.from_numpy(np.array(
        jax.random.uniform(key, (steps, B, D), dtype=jnp.float32))))
    src = MultiModal(**{k: torch.from_numpy(v) for k, v in fields.items()})
    final, traj = tsys.simulate(src, steps, return_trajectory=True, **noise, **sim_kw)
    alone = tsys.simulate(src, steps, **noise, **sim_kw)          # one state, as before

    real = fields["mask"][..., 0] > 0
    ts = np.linspace(1e-5, 1 - 1e-5, steps, dtype=np.float32)
    assert isinstance(alone, MultiModal) and isinstance(traj, MultiModal)
    assert traj.time.shape == (steps, B) and traj.mask.shape == (steps, B, D, 1)
    np.testing.assert_allclose(traj.time.numpy(), np.repeat(ts[:, None], B, 1), rtol=1e-6)
    np.testing.assert_allclose(traj.time.numpy(), np.asarray(jtraj.time), rtol=1e-6)
    np.testing.assert_allclose(final.time.numpy(), np.asarray(jfinal.time), rtol=1e-6)
    for state, jstate, lead in ((traj, jtraj, (steps,)), (final, jfinal, ())):
        if kind != "MJB":
            assert state.continuous.shape == lead + (B, D, 3)
            np.testing.assert_allclose(state.continuous.numpy()[..., real, :],
                                       np.asarray(jstate.continuous)[..., real, :],
                                       atol=TRAJECTORY_ATOL)
        else:
            assert state.continuous is None
        if kind != "CFM":
            assert state.discrete.shape == lead + (B, D, 1)
            same = (state.discrete.numpy() == np.asarray(jstate.discrete))[..., real, :]
            assert same.mean() >= TOKENS_EQUAL
        else:
            assert state.discrete is None
    for field in ("continuous", "discrete"):
        if getattr(final, field) is not None:
            assert torch.equal(getattr(final, field), getattr(alone, field))
    if "use_final_max_rates" in sim_kw:
        assert not torch.equal(final.discrete, traj.discrete[-1])
    elif kind != "CFM":
        assert torch.equal(final.discrete, traj.discrete[-1])


@pytest.mark.parametrize("kind,model", [("MMF", "ParticleFormer"), ("CFM", "KinFormer"),
                                        ("MJB", "FlavorFormer")])
def test_unknown_keyword_to_simulate_raises(kind, model):
    """F2 hid behind `**_ignored`: a keyword a system's `simulate` does not
    name raises; the token arguments that `generate_packed` passes are
    named by all three."""
    tsys = systems.build_system(Config(**dict(SMALL, model=model)), kind, device="cpu")
    src = MultiModal(**{k: torch.from_numpy(v) for k, v in _source(kind).items()})
    with pytest.raises(TypeError, match="return_trajectories"):
        tsys.simulate(src, 2, return_trajectories=True)
    out = tsys.simulate(src, 2, temperature=1.0, top_k=None, top_p=None,
                        use_final_max_rates=False, segments=None, num_segments=None,
                        generator=torch.Generator().manual_seed(0))
    assert isinstance(out, MultiModal)


# ----------------------------------------------------------------- closure


def test_toy_tutorial_closes_on_the_cpu(tmp_path):
    """The tutorial's compute half at a cut size (16 of 20 epochs, 100 of
    200 steps): the first end-to-end use of the explicit-source branch of
    `MMF.loss_fn`.  W1(x), W1(y) < 0.3 against a fresh two-moons sample
    (scale about 3), most labels on 1 and 2."""
    cfg = toy_tutorial.toy_config(epochs=16, out=str(tmp_path))
    out = toy_tutorial.run(cfg, num_points=80_000, num_timesteps=100, device="cpu")
    assert out["w1_x"] < 0.3 and out["w1_y"] < 0.3
    assert out["label_freq"][1] + out["label_freq"][2] > 0.8
    assert abs(out["label_freq"][1] - out["label_freq"][2]) < 0.2
    traj = out["trajectory"]
    assert traj.continuous.shape == (100, 2000, 1, 2) and traj.time.shape == (100, 2000)
    assert torch.isfinite(traj.continuous).all()
    exp = cfg.experiment_dir
    assert os.path.exists(os.path.join(exp, "checkpoints", "last.pt"))
    assert os.path.exists(os.path.join(exp, "metrics.jsonl"))


def test_toy_tutorial_entry_point_writes_its_plots(tmp_path):
    toy_tutorial.main(["--epochs", "1", "--num_points", "800", "--num_timesteps", "10",
                       "--out", str(tmp_path), "--device", "cpu"])
    (exp,) = (tmp_path / "toy").iterdir()
    for name in ("trajectories.png", "trajectories_panels.png", "closure.png"):
        assert (exp / name).stat().st_size > 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        toy_tutorial.main(["--epochs", "1", "--num_points", "800", "--out", str(tmp_path)])
