"""The in-training physics eval of the port against the JAX package: the
observables (`JetFeatures`, `reference_observables`), the metrics
(`wasserstein1d`, `flavor_multiplicities`, `wasserstein_flavor`), the W1
scores of one shared generated sample, and the trainer's use of it (the
`best_physics` slot, one generation seed for every eval of a run, a
failing eval swallowed).  The trainer tests mirror
tests/test_physics_eval.py.  Host-side numpy on both sides: the values
agree to rtol 1e-6 unless stated."""

import json
import os

import numpy as np
import pytest
import torch

from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
from multimodal_flows_tpu.sampling import generator as jgenerator
from multimodal_flows_tpu.train import physics_eval as jphysics
from multimodal_flows_tpu.utils import metrics as jmetrics
from multimodal_flows_tpu.utils.jet_features import JetFeatures as JaxJetFeatures
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.datasets import ArrayDataset
from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
from multimodal_flows_tpu_torch.sampling import generator
from multimodal_flows_tpu_torch.train import physics_eval
from multimodal_flows_tpu_torch.train.systems import build_system
from multimodal_flows_tpu_torch.train.trainer import Trainer
from multimodal_flows_tpu_torch.utils import metrics
from multimodal_flows_tpu_torch.utils.jet_features import JetFeatures, ParticleClouds

torch.set_num_threads(2)

META = {"mean": [1.0, 0.0, 0.0], "std": [0.5, 1.0, 1.0]}


def _jets(B=24, D=16, seed=0):
    """Standardized jets as numpy arrays: (continuous, discrete, mask)."""
    rng = np.random.default_rng(seed)
    mult = rng.integers(1, D + 1, size=B)
    mask = (np.arange(D)[None, :] < mult[:, None]).astype(np.int32)[..., None]
    x = (rng.normal(size=(B, D, 3)) * mask).astype(np.float32)
    k = (rng.integers(1, 9, size=(B, D, 1)) * mask).astype(np.int32)
    return x, k, mask


def _both(x, k, mask, as_tensors=False):
    conv = torch.from_numpy if as_tensors else (lambda a: a)
    fields = {n: a for n, a in (("continuous", x), ("discrete", k), ("mask", mask))
              if a is not None}
    return (JaxMultiModal(**fields), MultiModal(**{n: conv(a) for n, a in fields.items()}))


@pytest.mark.parametrize("as_tensors", [False, True], ids=["numpy", "tensors"])
def test_jet_features_match_jax(as_tensors):
    """pt, m, eta, phi, the 4-momentum, the charges and the flavor counts
    of `JetFeatures(compute_substructure=False)`, from numpy arrays and
    from tensors."""
    x, k, mask = _jets(seed=1)
    x[..., 0] = np.abs(x[..., 0]) + 0.1 * mask[..., 0]      # pt > 0 on real particles
    jjets, tjets = _both(x, k, mask, as_tensors)
    ref = JaxJetFeatures(jjets, compute_substructure=False)
    out = JetFeatures(tjets, compute_substructure=False)
    for name in ("pt", "m", "eta", "phi", "px", "py", "pz", "E", "charge", "jet_charge",
                 "numParticles"):
        np.testing.assert_allclose(getattr(out, name), getattr(ref, name), rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(out.flavor_counts(), ref.flavor_counts())
    assert out.Wassertein1D("pt", out) == 0.0
    assert out.wasserstein1d("m", JetFeatures(tjets[:12], compute_substructure=False)) == \
        pytest.approx(ref.Wassertein1D("m", JaxJetFeatures(jjets[:12],
                                                             compute_substructure=False)))
    clouds = ParticleClouds(tjets)
    np.testing.assert_array_equal(clouds.num_Lepton, ref.constituents.num_Lepton)
    assert len(clouds) == 24


@pytest.mark.parametrize("modes,expected", [
    (("continuous", "discrete"), {"pt", "mass", "mult"}), (("continuous",), {"pt", "mass"}),
    (("discrete",), {"mult"})])
def test_reference_observables_match_jax(modes, expected):
    """The observables follow the modalities; destandardized with the
    metadata and truncated to `num_jets`."""
    x, k, mask = _jets(seed=2)
    jjets, tjets = _both(x if "continuous" in modes else None,
                         k if "discrete" in modes else None, mask)
    ref = jphysics.reference_observables(jjets, META, 20)
    out = physics_eval.reference_observables(tjets, META, 20)
    assert set(out) == set(ref) == expected
    for name in ref:
        assert out[name].shape == (20,) and out[name].dtype == np.float64
        np.testing.assert_allclose(out[name], ref[name], rtol=1e-6, err_msg=name)
    no_meta = physics_eval.reference_observables(tjets, None, 20)
    for name, vals in jphysics.reference_observables(jjets, None, 20).items():
        np.testing.assert_allclose(no_meta[name], vals, rtol=1e-6)


def test_metrics_match_jax():
    """`wasserstein1d` (equal and unequal sample sizes), the 16
    `flavor_multiplicities` and `wasserstein_flavor` with its text dump."""
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=400), rng.normal(0.3, 1.5, size=250)
    assert metrics.wasserstein1d(a, b) == jmetrics.wasserstein1d(a, b) > 0
    assert metrics.wasserstein1d(a, a) == 0.0
    x, k, mask = _jets(seed=4)
    jjets, tjets = _both(x, k, mask, as_tensors=True)
    ref, out = jmetrics.flavor_multiplicities(jjets), metrics.flavor_multiplicities(tjets)
    assert list(out) == list(ref) and len(out) == 16
    for name in ref:
        np.testing.assert_array_equal(out[name], ref[name], err_msg=name)
    np.testing.assert_array_equal(metrics.flavor_mutliplicities(k)["leptons"], ref["leptons"])
    _, k2, _ = _jets(seed=5)
    assert metrics.wasserstein_flavor(tjets, k2) == jmetrics.wasserstein_flavor(jjets, k2)


def test_wasserstein_flavor_writes_the_same_file(tmp_path):
    _, k, _ = _jets(seed=6)
    _, k2, _ = _jets(seed=7)
    metrics.wasserstein_flavor(k, k2, path=str(tmp_path / "port.txt"))
    jmetrics.wasserstein_flavor(k, k2, path=str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()


def _cfg(**kw):
    base = dict(model="ParticleFormer", n_embd=32, n_inner=64, n_layer=1, n_layer_fused=1,
                n_head=2, vocab_size=9, dim_continuous=3, max_num_particles=16, batch_size=8,
                pack_width=16, metadata=dict(META))
    base.update(kw)
    return Config(**base)


def test_physics_metrics_match_jax_on_a_shared_sample(monkeypatch):
    """One generated sample handed to both sides in place of their
    samplers: the same val_w1_pt / mass / mult and combined score."""
    x, k, mask = _jets(B=32, seed=8)
    gx, gk, _ = _jets(B=32, seed=9)
    gx, gk = (gx * 1.3 * mask).astype(np.float32), gk * mask
    jref, tref = _both(x, k, mask)
    ref_obs = jphysics.reference_observables(jref, META, 32)
    obs = physics_eval.reference_observables(tref, META, 32)
    jsample, tsample = _both(gx, gk, mask, as_tensors=True)
    calls = []

    def fake(sample):
        def generate_packed(*a, **kw):
            calls.append(kw)
            return generator.GenerationResult(sample=sample, jets_per_sec=1.0, wall_time_s=1.0,
                                              num_timesteps=4, temperature=1.0)
        return generate_packed

    monkeypatch.setattr(jgenerator, "generate_packed", fake(jsample))
    monkeypatch.setattr(generator, "generate_packed", fake(tsample))
    kw = dict(num_timesteps=4, metadata=META, batch_size=8, seed=11, pack_width=16)
    ref = jphysics.physics_metrics(None, None, ref_obs, mask, **kw)
    system = build_system(_cfg(), "MMF", device="cpu")
    out = physics_eval.physics_metrics(system, None, obs, mask, **kw)
    assert set(out) == set(ref) == {"val_w1_pt", "val_w1_mass", "val_w1_mult", "val_w1_physics"}
    for name in ref:
        assert out[name] == pytest.approx(ref[name], rel=1e-6), name
    assert all(c["seed"] == 11 and c["pack_width"] == 16 for c in calls) and len(calls) == 2


@pytest.mark.parametrize("model,kind,expected", [
    ("ParticleFormer", "MMF", {"val_w1_pt", "val_w1_mass", "val_w1_mult"}),
    ("KinFormer", "CFM", {"val_w1_pt", "val_w1_mass"}),
    ("FlavorFormer", "MJB", {"val_w1_mult"}),
    ("EPiC", "CFM", {"val_w1_pt", "val_w1_mass"})])
def test_physics_metrics_per_modality(model, kind, expected):
    """Through the port's own `generate_packed`, on the CPU: the scores
    follow the system's modalities and are finite; the module argument
    selects the weights that generate (an EMA copy) and the system's own
    module is put back."""
    import copy

    cfg = _cfg(model=model)
    system = build_system(cfg, kind, device="cpu", generator=torch.Generator().manual_seed(0))
    x, k, mask = _jets(seed=10)
    jets = MultiModal(continuous=None if kind == "MJB" else x,
                      discrete=None if kind == "CFM" else k, mask=mask)
    ref_obs = physics_eval.reference_observables(jets, cfg.metadata, 24)
    assert {f"val_w1_{n}" for n in ref_obs} == expected
    kw = dict(num_timesteps=3, metadata=cfg.metadata, batch_size=8, seed=0, pack_width=16)
    out = physics_eval.physics_metrics(system, None, ref_obs, mask, **kw)
    assert set(out) == expected | {"val_w1_physics"}
    assert all(np.isfinite(v) for v in out.values())
    assert physics_eval.physics_metrics(system, None, ref_obs, mask, **kw) == out   # same seed

    other = copy.deepcopy(system.module)
    with torch.no_grad():
        for p in other.parameters():
            p.mul_(1.5)
    own = system.module
    scored = physics_eval.physics_metrics(system, other, ref_obs, mask, **kw)
    assert system.module is own and set(scored) == set(out)
    if kind != "MJB":      # 3 steps rarely move a token to 0: the multiplicity stays
        assert scored != out


def _fit_setup(tmp_path, **kw):
    cfg = _cfg(dir=str(tmp_path), **kw)
    x, k, mask = _jets(B=48, seed=12)
    ds = ArrayDataset(DataCoupling(source=MultiModal(mask=mask),
                                   target=MultiModal(continuous=x, discrete=k, mask=mask)))
    train_ds, val_ds = ds.split(0.7, seed=0)
    system = build_system(cfg, "MMF", device="cpu", generator=torch.Generator().manual_seed(0))
    return cfg, Trainer(system, cfg), train_ds, val_ds


def test_fit_writes_best_physics_slot(tmp_path):
    """Mirrors tests/test_physics_eval.py::test_fit_writes_best_physics_slot:
    the eval runs on every 2nd epoch and the last, logs val_w1_*, and each
    eval saves a checkpoint that enters the best_physics ranking."""
    cfg, trainer, train_ds, val_ds = _fit_setup(
        tmp_path, max_epochs=3, lr=1e-3, lr_final=1e-4, use_ema_weights=True,
        physics_eval_every_n_epochs=2, physics_eval_num_jets=14, physics_eval_num_timesteps=3,
        checkpoint_every_n_epochs=5)
    trainer.fit(train_ds, val_ds)
    exp = os.path.join(str(tmp_path), "scratch")
    ckdir = os.path.join(exp, "checkpoints")
    assert os.path.exists(os.path.join(ckdir, "best_physics.pt"))
    index = json.load(open(os.path.join(ckdir, "index.json")))
    ranked = index["topk"]["best_physics"]
    assert ranked and all(np.isfinite(e["value"]) for e in ranked)
    assert {e["epoch"] for e in ranked} == {2, 3}
    assert "best_physics" in index["best_values"]
    # checkpoint_every_n_epochs=5: only the eval epochs (2 and the last) saved
    assert [h["epoch"] for h in index["history"]] == [2, 3]
    assert all("val_w1_physics" in h for h in index["history"])
    records = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    assert ["val_w1_physics" in r for r in records] == [False, True, True]
    for r in records[1:]:
        assert all(np.isfinite(r[f"val_w1_{n}"]) for n in ("pt", "mass", "mult", "physics"))
    assert trainer._physics_ref[1].shape == (14, 16, 1)     # references cached once


def test_physics_eval_uses_common_random_numbers(tmp_path, monkeypatch):
    """One fixed generation seed, `seed + 104729`, for every eval of a run,
    and the EMA weights are the ones that generate."""
    seen = []
    real = physics_eval.physics_metrics

    def record(system, module, *a, **kw):
        seen.append((kw.get("seed"), module))
        return real(system, module, *a, **kw)

    monkeypatch.setattr(physics_eval, "physics_metrics", record)
    cfg, trainer, train_ds, val_ds = _fit_setup(
        tmp_path, max_epochs=4, seed=5, use_ema_weights=True, physics_eval_every_n_epochs=1,
        physics_eval_num_jets=12, physics_eval_num_timesteps=2)
    state = trainer.fit(train_ds, val_ds)
    assert [s for s, _ in seen] == [5 + 104729] * 4
    assert all(m is state.ema for _, m in seen) and state.ema is not state.module


def test_physics_eval_failure_does_not_kill_fit(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("synthetic failure")

    monkeypatch.setattr(physics_eval, "physics_metrics", boom)
    cfg, trainer, train_ds, val_ds = _fit_setup(
        tmp_path, max_epochs=2, physics_eval_every_n_epochs=1, physics_eval_num_jets=12,
        physics_eval_num_timesteps=2)
    state = trainer.fit(train_ds, val_ds)      # must not raise
    ckdir = os.path.join(str(tmp_path), "scratch", "checkpoints")
    assert state.step > 0 and os.path.exists(os.path.join(ckdir, "last.pt"))
    assert not os.path.exists(os.path.join(ckdir, "best_physics.pt"))
