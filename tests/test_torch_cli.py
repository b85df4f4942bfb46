"""The port's command-line entry points on the CPU at tiny widths: the
round trip "write a synthetic AOJ file, train, resume, sample, read
metrics.json, recompute it with --metrics_only", the flags (same names and
defaults as the JAX package's scripts, the ones that raise, the ones stored
without effect), and `config.yaml` files crossing between the packages."""

import contextlib
import glob
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from multimodal_flows_tpu.config import Config as JaxConfig
from multimodal_flows_tpu_torch.cli import sample_mmf, train_mmf
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.state import MultiModal
from tests.test_aoj import write_synthetic_aoj
from tests.test_infra import _parse_event_scalars as parse_event_scalars
from tests.test_infra import _read_tfrecords as read_tfrecords

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--num_jets", "64", "--max_num_particles", "8", "--batch_size", "16",
        "--n_embd", "16", "--n_inner", "32", "--n_layer", "1", "--n_layer_fused", "1",
        "--n_head", "2", "--device", "cpu"]


def _jax_script(name):
    """A script of the JAX package (`scripts/<name>.py`) as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(main, argv) -> str:
    """Run an entry point; its console output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _aoj_dir(tmp, seed=0):
    aoj = tmp / "aoj"
    aoj.mkdir()
    write_synthetic_aoj(str(aoj / "RunG_batch0.h5"), num_jets=64, max_p=8, seed=seed)
    return str(aoj)


def _only_experiment(exp_dir):
    ids = os.listdir(os.path.join(exp_dir, "aoj_jets"))
    assert len(ids) == 1
    return ids[0], os.path.join(exp_dir, "aoj_jets", ids[0])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs of the packed MMF through the training entry point, with
    the two flags that have no effect here."""
    tmp = tmp_path_factory.mktemp("cli")
    aoj, exp_dir = _aoj_dir(tmp), str(tmp / "experiments")
    common = ["--dir", exp_dir, "--dir_aoj", aoj]
    console = _run(train_mmf.main, common + TINY + [
        "--max_epochs", "2", "--packed_training", "--pack_width", "16", "-ema",
        "--attn_impl", "pallas", "--remat"])
    exp_id, exp = _only_experiment(exp_dir)
    return dict(common=common, exp_dir=exp_dir, exp_id=exp_id, exp=exp, console=console)


@pytest.fixture(scope="module")
def sampled(trained):
    """The sampling entry point on the minted id: two sweep points, plots."""
    console = _run(sample_mmf.main, trained["common"] + [
        "-id", trained["exp_id"], "--num_jets", "24", "--batch_size", "16",
        "--num_timesteps", "3", "4", "--temperature", "1.0", "--make_plots",
        "--scan_unroll", "2", "--device", "cpu"])
    dirs = sorted(glob.glob(os.path.join(trained["exp"], "generation_results*")))
    return dict(trained, res_dirs=dirs, sample_console=console)


def test_train_leaves_config_checkpoints_and_metric_files(trained):
    exp = trained["exp"]
    cfg = Config.load(exp)
    assert cfg.tags == ["system:MMF"] and cfg.experiment_id == trained["exp_id"]
    assert cfg.packed_training and cfg.attn_impl == "pallas" and cfg.remat
    # the metadata went through yaml as plain numbers
    assert cfg.metadata["num_jets_sample"] == 64 and len(cfg.metadata["mean"]) == 3
    assert all(type(v) is float for v in cfg.metadata["mean"] + cfg.metadata["std"])
    assert {"last.pt", "best.pt", "index.json"} <= set(os.listdir(os.path.join(exp,
                                                                             "checkpoints")))
    records = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in records)
    assert open(os.path.join(exp, "metrics.csv")).readline().startswith("step,")
    (events,) = glob.glob(os.path.join(exp, "tb", "events.out.tfevents.*"))
    decoded = [parse_event_scalars(r) for r in read_tfrecords(events)[1:]]
    assert [step for step, _ in decoded] == [r["step"] for r in records]
    assert decoded[-1][1]["val_loss"] == pytest.approx(records[-1]["val_loss"], rel=1e-6)
    assert "have no effect in the PyTorch port" in trained["console"]
    assert trained["console"].count("have no effect") == 1


def test_resume_runs_the_remaining_epoch(trained):
    console = _run(train_mmf.main, trained["common"] + [
        "-id", trained["exp_id"], "--max_epochs", "3", "--lr", "1e-4", "--device", "cpu"])
    assert "resumed from 'last' at epoch 2" in console
    records = [json.loads(line)
               for line in open(os.path.join(trained["exp"], "metrics.jsonl"))]
    assert [r["epoch"] for r in records] == [0, 1, 2]
    cfg = Config.load(trained["exp"])
    # the resume overrides are persisted, the architecture is the first run's
    assert (cfg.max_epochs, cfg.lr, cfg.n_embd, cfg.packed_training) == (3, 1e-4, 16, True)
    assert len(glob.glob(os.path.join(trained["exp"], "tb", "events.out.tfevents.*"))) >= 1


def test_sample_writes_samples_configs_metrics_and_plots(sampled):
    assert len(sampled["res_dirs"]) == 2
    assert [os.path.basename(d) for d in sampled["res_dirs"]] == [
        "generation_results_system:MMF_steps_3_temp_1.0",
        "generation_results_system:MMF_steps_4_temp_1.0"]
    for steps, res_dir in zip((3, 4), sampled["res_dirs"]):
        sample = MultiModal.load_from(os.path.join(res_dir, "generated_sample.h5"))
        assert sample.continuous.shape == (24, 8, 3) and sample.discrete.shape == (24, 8, 1)
        pad = sample.mask[..., 0] == 0
        assert (sample.discrete[..., 0][pad] == 0).all() and (sample.continuous[pad] == 0).all()
        assert torch.isfinite(sample.continuous).all()
        assert os.path.exists(os.path.join(res_dir, "configs.yaml"))
        point = json.load(open(os.path.join(res_dir, "metrics.json")))
        assert point["num_timesteps"] == steps and point["temperature"] == 1.0
        assert point["jets_per_sec"] > 0 and len(point["w1_flavor"]) == 16
        assert set(point["w1_kinematics"]) == {"pt", "eta_rel", "phi_rel"}
        for png in ("plots_flavor.png", "plots_kin.png", "flavor_kinematics.png"):
            assert os.path.getsize(os.path.join(res_dir, png)) > 0
    assert sampled["sample_console"].count("have no effect") == 1


def test_metrics_only_recomputes_and_sets_a_corrupt_sample_aside(sampled):
    res_dir = sampled["res_dirs"][1]
    mpath = os.path.join(res_dir, "metrics.json")
    first = json.load(open(mpath))
    os.remove(mpath)
    broken = os.path.join(sampled["exp"], "generation_results_steps_9_temp_1.0")
    os.makedirs(broken)
    with open(os.path.join(broken, "generated_sample.h5"), "wb") as f:
        f.write(b"not an hdf5 file")
    console = _run(sample_mmf.main, sampled["common"] + [
        "-id", sampled["exp_id"], "--num_jets", "24", "--metrics_only"])  # no --device: none used
    assert "wrote metrics.json for 1 generation dir(s)" in console
    redone = json.load(open(mpath))
    assert redone["num_timesteps"] == 4 and redone["temperature"] == 1.0
    assert redone["jets_per_sec"] is None
    assert redone["w1_flavor"] == pytest.approx(first["w1_flavor"])
    assert redone["w1_kinematics"] == pytest.approx(first["w1_kinematics"])
    assert os.path.exists(os.path.join(broken, "generated_sample.h5.corrupt"))
    assert not os.path.exists(os.path.join(broken, "generated_sample.h5"))


@pytest.mark.parametrize("kind,model_flags", [
    ("CFM", ["--model", "KinFormer"]),
    ("MJB", ["--model", "FlavorFormer", "--use_pairwise"]),
    ("MMF", ["--model", "FusedParticleFormer", "--bucketed_training", "--multitask_loss", "sum"]),
])
def test_round_trip_of_the_other_systems(tmp_path, kind, model_flags):
    """`--system` is persisted as a tag and rebuilt by the sampling entry
    point; each system's sample has the fields it generates."""
    aoj, exp_dir = _aoj_dir(tmp_path), str(tmp_path / "experiments")
    common = ["--dir", exp_dir, "--dir_aoj", aoj]
    _run(train_mmf.main, common + TINY + ["--max_epochs", "1", "--system", kind] + model_flags)
    exp_id, exp = _only_experiment(exp_dir)
    assert Config.load(exp).tags == [f"system:{kind}"]
    _run(sample_mmf.main, common + ["-id", exp_id, "--num_jets", "20", "--batch_size", "16",
                                    "--num_timesteps", "3", "--checkpoint", "last",
                                    "--device", "cpu"])
    (res_dir,) = glob.glob(os.path.join(exp, "generation_results*"))
    assert f"system:{kind}" in res_dir
    sample = MultiModal.load_from(os.path.join(res_dir, "generated_sample.h5"))
    assert len(sample) == 20 and torch.isfinite(sample.continuous).all()
    point = json.load(open(os.path.join(res_dir, "metrics.json")))
    assert "w1_kinematics" in point and "w1_flavor" in point


@pytest.mark.parametrize("flags,error,match", [
    (["--fsdp"], None, None),
    (["--tensor_parallel", "2"], ValueError, "1 devices not divisible by model=2"),
    (["--compute_dtype", "bfloat16"], None, None),
], ids=["fsdp", "tensor_parallel", "bfloat16"])
def test_flags_of_what_is_not_ported_raise_before_any_file_is_written(tmp_path, flags, error,
                                                                       match):
    """A tensor-parallel mesh that does not fit the world size raises the
    JAX package's divisibility error before any file is written.  `--fsdp`
    at world size 1 (no process group, so no mesh) trains on the one
    device, as in JAX.  bf16 compute is ported: `--compute_dtype bfloat16`
    trains, its saved config keeps the dtype, and the sampling entry point
    samples with it (finite kinematics, tokens in range)."""
    exp_dir = str(tmp_path / "experiments")
    if error is None:
        common = ["--dir", exp_dir, "--dir_aoj", _aoj_dir(tmp_path)]
        _run(train_mmf.main, common + TINY + ["--max_epochs", "1"] + flags)
        exp_id, exp = _only_experiment(exp_dir)
        cfg = Config.load(exp)
        assert os.path.exists(os.path.join(exp, "checkpoints", "last.pt"))
        if "--fsdp" in flags:
            assert cfg.fsdp
            return
        assert cfg.compute_dtype == "bfloat16"
        records = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
        assert np.isfinite(records[-1]["train_loss"]) and np.isfinite(records[-1]["val_loss"])
        _run(sample_mmf.main, common + ["-id", exp_id, "--num_jets", "20", "--batch_size", "16",
                                        "--num_timesteps", "3", "--checkpoint", "last",
                                        "--device", "cpu"])
        (res_dir,) = glob.glob(os.path.join(exp, "generation_results*"))
        sample = MultiModal.load_from(os.path.join(res_dir, "generated_sample.h5"))
        assert len(sample) == 20 and torch.isfinite(sample.continuous).all()
        assert ((sample.discrete >= 0) & (sample.discrete < cfg.vocab_size)).all()
        return
    with pytest.raises(error, match=match):
        train_mmf.main(["--dir", exp_dir, "--dir_aoj", str(tmp_path / "nowhere")] + TINY + flags)
    assert not os.path.exists(exp_dir)


def test_entry_points_raise_without_cuda_unless_asked_for_the_cpu(tmp_path, trained):
    """The default device is the card: on a machine without CUDA the entry
    points raise, they never carry on on the CPU."""
    assert not torch.cuda.is_available()
    no_device = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mmf.main(["--dir", str(tmp_path / "e"), "--dir_aoj", str(tmp_path)] + no_device)
    assert not os.path.exists(tmp_path / "e")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_mmf.main(trained["common"] + ["-id", trained["exp_id"], "--num_jets", "8"])


def test_gpt_round_trip_through_both_entry_points(tmp_path):
    """`--system GPT` trains on the token sequences of the jets
    (`max_seq_length` = `max_num_particles`), and the sampling entry point
    writes the stripped token sample as `sample.npy` where the JAX script
    writes it; two runs on one seed give the same sample."""
    aoj, exp_dir = _aoj_dir(tmp_path), str(tmp_path / "experiments")
    common = ["--dir", exp_dir, "--dir_aoj", aoj]
    _run(train_mmf.main, common + TINY + ["--max_epochs", "1", "--system", "GPT"])
    exp_id, exp = _only_experiment(exp_dir)
    cfg = Config.load(exp)
    assert cfg.tags == ["system:GPT"] and cfg.max_seq_length == cfg.max_num_particles == 8
    argv = common + ["-id", exp_id, "--num_jets", "20", "--batch_size", "16", "--checkpoint",
                     "last", "--temperature", "0.8", "--device", "cpu"]
    _run(sample_mmf.main, argv)
    path = os.path.join(exp, "generation_results__gpt_temp_0.8", "sample.npy")
    sample = np.load(path)
    assert sample.shape == (20, 8) and sample.min() >= 0 and sample.max() <= cfg.vocab_size
    _run(sample_mmf.main, argv)
    np.testing.assert_array_equal(np.load(path), sample)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_mmf.main(argv[:-2])


def test_training_flags_and_defaults_are_the_jax_scripts(tmp_path):
    """The same command line gives the same Config in both packages: the
    defaults, and a line that sets most flags by their short names."""
    jax_train = _jax_script("train_mmf")
    assert train_mmf.experiment_configs([])[0].to_dict() == \
        jax_train.experiment_configs([]).to_dict()
    argv = ["-N", "2", "-proj", "p", "-ckpt", "c.pt", "-resume", "best", "--tags", "a", "b",
            "-f", "x.h5", "-n", "99", "-d", "30", "-bs", "32", "-epochs", "7", "-ema",
            "-nn", "EPiC", "-cont", "pt", "eta_rel", "-disc", "tokens", "--qk_layernorm", "false",
            "--bias", "False", "-loss", "weighted", "-b", "0.1", "-sig", "0.01", "-eps", "1e-4",
            "-steps", "50", "--top_k", "3", "--top_p", "0.9", "--system", "CFM",
            "--physics_eval_every_n_epochs", "2", "--use_wandb", "--epoch_hbm_budget_mb", "64",
            "--use_coocurrence", "--use_pairwise", "--use_pos_emb", "--n_embd_glob", "8"]
    ours, device = train_mmf.experiment_configs(argv + ["--device", "cuda:1"])
    assert device == "cuda:1"
    assert ours.to_dict() == jax_train.experiment_configs(argv).to_dict()
    assert ours.tags == ["a", "b", "system:CFM"] and not ours.qk_layernorm and not ours.bias


def test_config_yaml_crosses_between_the_packages(tmp_path, trained):
    """A `config.yaml` written by the JAX training script (metadata of the
    same AOJ file included) loads in the port, equal to the port's own; the
    port's loads in the JAX package; and both sampling entry points parse
    the same line over it into the same config."""
    aoj = os.path.join(os.path.dirname(trained["exp_dir"]), "aoj")
    jax_train, jax_sample = _jax_script("train_mmf"), _jax_script("sample_mmf")
    argv = ["--dir", str(tmp_path), "--dir_aoj", aoj, "--experiment_id", "placeholder"]
    jcfg = jax_train.experiment_configs([a for a in argv[:4]] + TINY[:-2])
    jcfg.experiment_id = "from_jax"
    jax_train.make_datasets(jcfg)
    jcfg.save()

    ours = Config.load(os.path.join(str(tmp_path), "aoj_jets", "from_jax"))
    assert ours.to_dict() == jcfg.to_dict()
    port_cfg = Config.load(trained["exp"])
    assert ours.metadata == port_cfg.metadata    # the same file through both readers
    assert JaxConfig.load(trained["exp"]).to_dict() == port_cfg.to_dict()

    line = ["--dir", trained["exp_dir"], "-id", trained["exp_id"], "-n", "12", "-steps", "5",
            "10", "-tmp", "0.9", "1.0", "--top_k", "4", "--use_final_max_rates", "-t", "x"]
    our_cfg, our_args = sample_mmf.experiment_configs(line)
    jax_cfg, jax_args = jax_sample.experiment_configs(line)
    assert our_cfg.to_dict() == jax_cfg.to_dict()
    ours_ns = vars(our_args)
    assert ours_ns.pop("device") == "cuda"
    assert ours_ns == vars(jax_args)
