"""The port's host-side infrastructure against the JAX package's: the
logger's sinks (TensorBoard event files, the wandb sink, the warning without
the package) and that `Trainer.fit` drives them; `MultiModal.load_from` with
a transform and the small accessors; jet substructure, energy correlators
and the charge dipole with the native library and with the numpy version;
the plotting suite; and that no port module imports at its top what the GPU
machine may lack."""

import ast
import glob
import os
import sys
import types
import warnings

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.data.state import DataCoupling as JaxCoupling
from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
from multimodal_flows_tpu.utils import jet_features as jfeatures
from multimodal_flows_tpu.utils import jet_substructure as jjk
from multimodal_flows_tpu.utils import logger as jlogger
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.datasets import ArrayDataset
from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
from multimodal_flows_tpu_torch.train import systems
from multimodal_flows_tpu_torch.train.trainer import Trainer
from multimodal_flows_tpu_torch.utils import jet_features as features
from multimodal_flows_tpu_torch.utils import jet_substructure as jk
from multimodal_flows_tpu_torch.utils import logger, plotting
from tests.conftest import make_jets
from tests.test_infra import _parse_event_scalars as parse_event_scalars
from tests.test_infra import _read_tfrecords as read_tfrecords
from tests.test_jet_features import make_clouds

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the library and the numpy version do the same float32 / float64 math in
# another order
SUBSTRUCTURE_TOL = 1e-5

SMALL = dict(model="ParticleFormer", n_embd=16, n_inner=32, n_layer=1, n_layer_fused=1,
             n_head=2, vocab_size=9, dim_continuous=3, max_num_particles=8,
             multitask_loss="sum", batch_size=8, max_epochs=2)


def _port(jets) -> MultiModal:
    return MultiModal(**{f: getattr(jets, f) for f in ("time", "continuous", "discrete", "mask")})


# ------------------------------------------------------------------ logger


def test_crc32c_and_event_encoding_equal_the_jax_packages():
    assert logger._crc32c(b"123456789") == 0xE3069283      # the published check value
    for data in (b"", b"a", bytes(range(256)) * 3):
        assert logger._crc32c(data) == jlogger._crc32c(data)
        assert logger._masked_crc(data) == jlogger._masked_crc(data)
    scalars = {"train_loss": 1.5, "val_w1_physics": 0.25, "lr": 5e-4}
    assert logger._tb_event(300, 1.7e9, scalars) == jlogger._tb_event(300, 1.7e9, scalars)


def test_tensorboard_sink_file_decodes(tmp_path):
    sink = logger.TensorBoardSink(str(tmp_path / "tb"))
    sink.log(7, {"train_loss": 1.5, "val_loss": 2.25, "note": "skipme"})
    sink.log(8, {"train_loss": 1.25})
    sink.close()
    (path,) = glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    records = read_tfrecords(path)           # verifies both masked CRCs of every record
    assert len(records) == 3 and b"brain.Event:2" in records[0]
    assert parse_event_scalars(records[1]) == (7, {"train_loss": 1.5, "val_loss": 2.25})
    assert parse_event_scalars(records[2]) == (8, {"train_loss": 1.25})


def _tiny_fit(tmp_path, **cfg_kw):
    rng = np.random.default_rng(0)
    mult = rng.integers(2, 9, size=32)
    mask = (np.arange(8)[None, :] < mult[:, None]).astype(np.int32)[..., None]
    jets = MultiModal(continuous=(rng.normal(size=(32, 8, 3)) * mask).astype(np.float32),
                      discrete=(rng.integers(1, 9, size=(32, 8, 1)) * mask).astype(np.int32),
                      mask=mask)
    train_ds, val_ds = ArrayDataset(DataCoupling(source=MultiModal(mask=mask),
                                                 target=jets)).split(0.75, seed=0)
    cfg = Config(**SMALL, dir=str(tmp_path), experiment_id="run", **cfg_kw)
    system = systems.build_system(cfg, "MMF", device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    Trainer(system, cfg).fit(train_ds, val_ds)
    return cfg


def test_fit_leaves_a_tensorboard_file_that_decodes(tmp_path):
    """F1, first half: every fit writes `tb/events.out.tfevents.*` beside
    the JSONL and CSV files, one event an epoch with the logged scalars."""
    cfg = _tiny_fit(tmp_path)
    (path,) = glob.glob(os.path.join(cfg.experiment_dir, "tb", "events.out.tfevents.*"))
    events = [parse_event_scalars(r) for r in read_tfrecords(path)[1:]]
    assert len(events) == cfg.max_epochs
    step, scalars = events[-1]
    assert step == 2 * 3                      # 24 train jets / batch 8, two epochs
    assert {"train_loss", "train_grad_norm", "val_loss", "lr", "epoch"} <= set(scalars)
    assert scalars["epoch"] == 1.0 and np.isfinite(scalars["val_loss"])


def _fake_wandb(monkeypatch):
    calls = {"log": [], "finished": False}

    class FakeRun:
        def log(self, metrics, step=None):
            calls["log"].append((step, metrics))

        def finish(self):
            calls["finished"] = True

    fake = types.ModuleType("wandb")

    def fake_init(**kw):
        calls["init"] = kw
        return FakeRun()

    fake.init = fake_init
    monkeypatch.setitem(sys.modules, "wandb", fake)
    return calls


def test_wandb_sink_fake_module(tmp_path, monkeypatch, capsys):
    calls = _fake_wandb(monkeypatch)
    log = logger.MetricsLogger(str(tmp_path / "exp"), wandb_project="proj",
                               wandb_name="run1", wandb_config={"lr": 1e-3})
    log.log(3, {"loss": 1.25, "note": "skipped-non-scalar"})
    log.close()
    assert calls["init"]["project"] == "proj" and calls["init"]["name"] == "run1"
    assert calls["init"]["config"] == {"lr": 1e-3}
    assert calls["init"]["dir"] == str(tmp_path / "exp")
    assert calls["init"]["mode"] == "offline"
    assert calls["log"] == [(3, {"loss": 1.25})] and calls["finished"]
    assert (tmp_path / "exp" / "metrics.jsonl").exists()

    # absent package: warn and go on with the three file sinks
    monkeypatch.setitem(sys.modules, "wandb", None)
    log2 = logger.MetricsLogger(str(tmp_path / "exp2"), wandb_project="proj")
    log2.log(1, {"loss": 2.0})
    log2.close()
    assert len(log2.sinks) == 3 and (tmp_path / "exp2" / "metrics.jsonl").exists()
    assert "use_wandb requested but the wandb package is not installed" in capsys.readouterr().out


def test_fit_passes_use_wandb_to_the_logger(tmp_path, monkeypatch, capsys):
    """F1, second half: `use_wandb` reaches the sink with the project, the
    experiment id and the config; without the package the fit warns and
    still trains."""
    calls = _fake_wandb(monkeypatch)
    cfg = _tiny_fit(tmp_path / "a", use_wandb=True, project="proj")
    assert calls["init"]["project"] == "proj" and calls["init"]["name"] == "run"
    assert calls["init"]["config"]["n_embd"] == 16 and calls["init"]["config"]["use_wandb"]
    assert [step for step, _ in calls["log"]] == [3, 6] and calls["finished"]
    assert "val_loss" in calls["log"][-1][1]

    monkeypatch.setitem(sys.modules, "wandb", None)
    capsys.readouterr()
    cfg = _tiny_fit(tmp_path / "b", use_wandb=True)
    assert "use_wandb requested but the wandb package is not installed" in capsys.readouterr().out
    assert os.path.exists(os.path.join(cfg.experiment_dir, "checkpoints", "last.pt"))

    capsys.readouterr()
    _tiny_fit(tmp_path / "c")                 # not asked for: no sink, no warning
    assert "wandb" not in capsys.readouterr().out


def test_unique_dirs_console_conditions_and_warnings_off(tmp_path, capsys):
    base = str(tmp_path / "run")
    assert logger.get_unique_dir(base) == jlogger.get_unique_dir(base) == base
    assert logger.setup_logging_dir(base) == base and os.path.isdir(base)
    assert logger.get_unique_dir(base) == jlogger.get_unique_dir(base) == base + "_1"
    assert logger.setup_logging_dir(base) == base + "_1"
    assert logger.setup_logging_dir(base) == base + "_2"
    assert logger.setup_logging_dir(base, exist_ok=True) == base

    logger.SimpleLogger.info("shown")
    logger.SimpleLogger.info("hidden", condition=False)
    logger.SimpleLogger.warn("warned", condition=True)
    logger.SimpleLogger.warn("silent", condition=False)
    out = capsys.readouterr().out
    assert "shown" in out and "warned" in out and "hidden" not in out and "silent" not in out
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        logger.SimpleLogger.warnings_off()
        warnings.warn("gone", UserWarning)
        warnings.warn("kept", RuntimeWarning)
    assert [str(w.message) for w in caught] == ["kept"]


# ------------------------------------------------------------- data/state


@pytest.mark.parametrize("form", ["none", "callable", "dict"])
def test_load_from_with_a_transform_equals_the_jax_packages(tmp_path, form):
    """F3: `load_from(path, transform=)` with a callable over every field
    and with a dict of per-field callables."""
    jets = make_jets(B=5, D=7, seed=3)
    path = str(tmp_path / "jets.h5")
    jets.replace(time=np.linspace(0, 1, 5, dtype=np.float32)).save_to(path)
    transform = {"none": None, "callable": lambda a: a[:3],
                 "dict": {"continuous": lambda a: a * 2.0, "discrete": lambda a: a + 1,
                          "missing": lambda a: a, "mask": "not callable"}}[form]
    ours = MultiModal.load_from(path, transform=transform)
    theirs = JaxMultiModal.load_from(path, transform=transform)
    for field in ("time", "continuous", "discrete", "mask"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert isinstance(a, torch.Tensor) and a.dtype == torch.from_numpy(np.asarray(b)).dtype
        np.testing.assert_array_equal(a.numpy(), b)
    assert len(ours) == (3 if form == "callable" else 5)


def test_accessors_equal_the_jax_packages():
    jets = make_jets(B=4, D=6)
    cases = {"full": jets.replace(time=np.zeros(4, np.float32)), "jets": jets,
             "mask_only": JaxMultiModal(mask=jets.mask), "tokens": JaxMultiModal(
                 discrete=jets.discrete, mask=jets.mask), "empty": JaxMultiModal()}
    for name, theirs in cases.items():
        ours = _port(theirs).map(torch.as_tensor)
        assert ours.ndim == theirs.ndim, name
        assert ours.shape == (None if theirs.shape is None else tuple(theirs.shape)), name
        assert ours.num_particles == theirs.num_particles and len(ours) == len(theirs), name
        for include_mask in (False, True):
            assert ours.available_modes(include_mask) == theirs.available_modes(include_mask)
        assert (ours.has_continuous, ours.has_discrete) == (theirs.has_continuous,
                                                            theirs.has_discrete), name
    ours = DataCoupling(source=MultiModal(mask=jets.mask), target=_port(jets))
    theirs = JaxCoupling(source=JaxMultiModal(mask=jets.mask), target=jets)
    assert ours.shape == tuple(theirs.shape) == (4, 6)
    assert (ours.has_source, ours.has_target, ours.has_context) == (
        theirs.has_source, theirs.has_target, theirs.has_context) == (True, True, False)
    assert not DataCoupling().has_target and DataCoupling().shape is None


# ------------------------------------------------------------ substructure


def _numpy_version(monkeypatch, module):
    """Make `module.load_library()` find no library."""
    monkeypatch.setattr(module, "load_library", lambda: None)


def test_jetkit_builds_into_the_build_directory_not_beside_the_source():
    lib = jk.load_library()
    assert lib is not None, "the host compiler could not build native/jetkit.cpp"
    build_dir = os.path.join(REPO, "build", "multimodal_flows_tpu_torch")
    assert os.path.dirname(lib._name) == build_dir
    assert os.path.basename(lib._name).startswith("libjetkit_")
    assert jk.load_library() is lib               # tried once per process


def test_without_a_source_the_loader_warns_once_and_the_numpy_version_runs(monkeypatch, tmp_path):
    clouds = make_clouds(B=3, D=6)
    pt, eta, phi = (clouds.continuous[..., i] for i in range(3))
    jk.load_library.cache_clear()
    try:
        with monkeypatch.context() as patched:
            patched.delenv("JETKIT_LIB", raising=False)
            patched.setattr(jk, "SOURCE", tmp_path / "nowhere" / "jetkit.cpp")
            with pytest.warns(RuntimeWarning, match="native jetkit build unavailable") as caught:
                assert jk.load_library() is None
                sub = jk.substructure(pt, eta, phi)
                jk.ecf2(pt, eta, phi)
            assert len(caught) == 1
    finally:
        jk.load_library.cache_clear()
    want = jk.substructure(pt, eta, phi, force_numpy=True)
    np.testing.assert_array_equal(sub["tau21"], want["tau21"])
    assert jk.load_library() is not None


def test_a_toolchain_without_openmp_gets_a_serial_library(monkeypatch, tmp_path):
    """The loader tries the OpenMP build first and then a serial one: a
    compiler that refuses `-fopenmp` (no libgomp) still gives a library,
    equal to the numpy version."""
    fake = tmp_path / "cxx"
    fake.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = "-fopenmp" ] && '
                    '{ echo "cannot read spec file libgomp.spec" >&2; exit 1; }; done\n'
                    'exec g++ "$@"\n')
    fake.chmod(0o755)
    clouds = make_clouds(B=4, D=9)
    pt, eta, phi = (clouds.continuous[..., i] for i in range(3))
    jk.load_library.cache_clear()
    try:
        with monkeypatch.context() as patched:
            patched.delenv("JETKIT_LIB", raising=False)
            patched.setenv("CXX", str(fake))
            patched.setattr(jk, "BUILD_DIR", tmp_path / "build")
            with warnings.catch_warnings():
                warnings.simplefilter("error")          # no fallback warning
                lib = jk.load_library()
            assert lib is not None and os.path.dirname(lib._name) == str(tmp_path / "build")
            assert os.path.basename(lib._name) == jk._lib_path(jk.CXX_FLAGS).name
            assert len(os.listdir(tmp_path / "build")) == 1     # no stray temporary file
            serial = jk.substructure(pt, eta, phi)
    finally:
        jk.load_library.cache_clear()
    want = jk.substructure(pt, eta, phi, force_numpy=True)
    for key in serial:
        np.testing.assert_allclose(serial[key], want[key], rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("version", ["library", "numpy"])
@pytest.mark.parametrize("data", ["make_jets", "make_clouds"])
def test_substructure_ecf_and_dipole_equal_the_jax_packages(monkeypatch, version, data):
    """`JetFeatures` with substructure, `EnergyCorrelationFunctions` and
    `JetChargeDipole` against the JAX package's on the same jets, with the
    native library and with the numpy version on both sides (atol and rtol
    1e-5), and the two versions against each other."""
    jets = make_jets(B=12, D=10, seed=2, min_particles=1) if data == "make_jets" \
        else make_clouds(B=10, D=12, seed=4)
    if version == "numpy":
        _numpy_version(monkeypatch, jk)
        _numpy_version(monkeypatch, jjk)
    else:
        assert jk.load_library() is not None and jjk.load_library() is not None
    tol = dict(rtol=SUBSTRUCTURE_TOL, atol=SUBSTRUCTURE_TOL, equal_nan=True)

    ours = features.JetFeatures(_port(jets).map(torch.as_tensor))   # tensors in
    theirs = jfeatures.JetFeatures(jets)
    np.testing.assert_array_equal(ours.substructure_mask, theirs.substructure_mask)
    for key in ("d0", "tau1", "tau2", "tau3", "tau21", "tau32", "c1", "d2"):
        assert getattr(ours, key).shape == (int(theirs.substructure_mask.sum()),)
        np.testing.assert_allclose(getattr(ours, key), getattr(theirs, key), err_msg=key, **tol)
    for key in ("pt", "m", "charge", "jet_charge"):
        np.testing.assert_allclose(getattr(ours, key), getattr(theirs, key), err_msg=key, **tol)

    ecf_ours = features.EnergyCorrelationFunctions(_port(jets))
    ecf_theirs = jfeatures.EnergyCorrelationFunctions(jets)
    assert set(features.ECF_FLAVOR_GROUPS) == set(jfeatures.ECF_FLAVOR_GROUPS)
    for pair in (("hadron", None), ("photon", None), ("positive", "negative"),
                 ("charged", "neutral"), ("e+/-", "mu+/-")):
        for a, b in zip(ecf_ours.compute_ecf(*pair, beta=1.5),
                        ecf_theirs.compute_ecf(*pair, beta=1.5)):
            np.testing.assert_allclose(a, b, err_msg=str(pair), **tol)

    dip_ours = features.JetChargeDipole(features.JetFeatures(_port(jets),
                                                             compute_substructure=False))
    dip_theirs = jfeatures.JetChargeDipole(jfeatures.JetFeatures(jets,
                                                                 compute_substructure=False))
    for a, b in zip(dip_ours.charge_and_dipole(kappa=0.5, beta=2.0),
                    dip_theirs.charge_and_dipole(kappa=0.5, beta=2.0)):
        np.testing.assert_allclose(a, b, **tol)

    if version == "library":        # and the library against the numpy version
        c = ours.constituents
        lib = jk.substructure(c.pt, c.eta_rel, c.phi_rel)
        ref = jk.substructure(c.pt, c.eta_rel, c.phi_rel, force_numpy=True)
        for key in lib:
            np.testing.assert_allclose(lib[key], ref[key], rtol=1e-4, atol=1e-5,
                                       equal_nan=True, err_msg=key)


# ---------------------------------------------------------------- plotting


def _plot_inputs():
    gen, ref = _port(make_clouds(B=30, D=15, seed=0)), _port(make_clouds(B=30, D=15, seed=1))
    return gen.map(torch.as_tensor), ref


def _trajectory(T=8, N=40):
    rng = np.random.default_rng(0)
    return MultiModal(
        time=torch.linspace(0, 1, T)[:, None].expand(T, N),
        continuous=torch.from_numpy(rng.normal(size=(T, N, 1, 2)).astype(np.float32).cumsum(0)),
        discrete=torch.from_numpy(rng.integers(1, 3, size=(T, N, 1, 1)).astype(np.int32)),
        mask=torch.ones((T, N, 1, 1), dtype=torch.int32))


def _draw(name, path):
    gen, ref = _plot_inputs()
    if name == "plot_hist_and_ratio":
        fig, pairs = plotting._grid_with_ratios(1, 2, (6, 3))
        rng = np.random.default_rng(1)
        plotting.plot_hist_and_ratio(*pairs[0], rng.normal(size=200), rng.normal(size=300),
                                     xlabel="x")
        plotting.plot_hist_and_ratio(*pairs[1], rng.exponential(size=200),
                                     np.append(rng.exponential(size=300), np.nan),
                                     bins=20, log_scale=True)
        fig.savefig(path)
        return fig
    if name == "plot_flavor_feats":
        return plotting.plot_flavor_feats(gen, ref, path=path)
    if name in ("plot_trajectories", "plot_trajectory_panels"):
        kw = dict(timesteps_to_mark=(0.25, 0.5)) if name == "plot_trajectories" else {}
        return getattr(plotting, name)(_trajectory(), num_points=30, path=path, **kw)
    gf, rf = features.JetFeatures(gen), features.JetFeatures(ref)
    if name == "plot_charge_features":
        return plotting.plot_charge_features(features.JetChargeDipole(gf),
                                             features.JetChargeDipole(rf), path=path)
    return getattr(plotting, name)(gf, rf, path=path)


@pytest.mark.parametrize("name", [
    "plot_hist_and_ratio", "plot_flavor_feats", "plot_kin_feats", "plot_jet_features",
    "flavor_kinematics", "plot_charge_features", "plot_trajectories", "plot_trajectory_panels"])
def test_every_plot_function_writes_a_png(tmp_path, name):
    path = str(tmp_path / f"{name}.png")
    fig = _draw(name, path)
    assert os.path.getsize(path) > 0
    assert open(path, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    plt.close(fig)


# ----------------------------------------------------------------- imports


def test_no_port_module_imports_at_its_top_what_the_gpu_machine_may_lack():
    """`h5py`, `yaml`, `matplotlib`, `wandb`, `rich` and `triton` are
    imported inside the functions that use them, and nothing of JAX or of
    the JAX package is imported at all, by the port or by `chip_smoke.py`."""
    lazy = {"h5py", "yaml", "matplotlib", "wandb", "rich", "triton"}
    never = {"jax", "flax", "optax", "orbax", "multimodal_flows_tpu"}
    files = glob.glob(os.path.join(REPO, "multimodal_flows_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 40
    for path in files:
        tree = ast.parse(open(path).read())
        top = {id(n) for n in tree.body}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                roots = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not roots & never, f"{path}:{node.lineno} imports {roots & never}"
            if id(node) in top:
                assert not roots & lazy, f"{path}:{node.lineno} imports {roots & lazy} at its top"
