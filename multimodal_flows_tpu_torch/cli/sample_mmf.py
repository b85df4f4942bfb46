"""Sampling entry point of the port: generate AOJ jets from a trained
experiment.

    python -m multimodal_flows_tpu_torch.cli.sample_mmf -id <experiment id> \
        --dir_aoj ./aoj --num_jets 100000 --num_timesteps 100 500

The twin of `scripts/sample_mmf.py`, with the same flags, short names and
defaults: loads the persisted config and a checkpoint, draws the pad masks
from the test file's multiplicities, sweeps num_files x temperature x
num_timesteps through `run_generation_sweep` (packed rows, K1 / K2 on the
card), writes `generation_results{tag}/generated_sample.h5`, `configs.yaml`
and the W1 metrics `metrics.json`; `--make_plots` adds the closure plots and
`--metrics_only` recomputes a missing `metrics.json` from the saved samples
without touching a device.  One flag is new, `--device` (default `cuda`,
raising without a CUDA device; `cpu` runs on the CPU).
`--max_dispatch_steps` and `--scan_unroll` steer the JAX package's compiled
loop; here they are accepted and have no effect.  Under `torchrun` each
sweep point's batches shard over the ranks (`Trainer(mesh="auto")`, the
model replicated as in the JAX sampler), every rank ends with all the
jets, and rank 0 writes every file.

A GPT experiment (tag `system:GPT`) is sampled autoregressively instead:
`--num_jets` token sets in batches of `--batch_size` at the first
`--temperature`, written as `generation_results_{tag}_gpt_temp_{temp}/
sample.npy`, as the JAX script writes it (no metrics, as there).

`main` is the file I/O (`Config.load`, `_load_test`, the result files)
around the compute halves `sample` (the flows: the test pad masks and a
device) and `sample_gpt`, and `point_metrics`, which is numpy.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from multimodal_flows_tpu_torch.cli.train_mmf import system_kind_of
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.parallel.mesh import init_from_env, initialized, is_primary
from multimodal_flows_tpu_torch.sampling.generator import GenerationResult, run_generation_sweep
from multimodal_flows_tpu_torch.train.systems import build_system
from multimodal_flows_tpu_torch.train.trainer import Trainer, _seed
from multimodal_flows_tpu_torch.utils.logger import SimpleLogger as log


def experiment_configs(argv=None):
    """(config, args): the experiment's persisted config under the
    selective overrides of the command line."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--num_nodes", "-N", type=int, default=1)
    p.add_argument("--dir", type=str, default="./experiments")
    p.add_argument("--project", "-proj", type=str, default="aoj_jets")
    p.add_argument("--experiment_id", "-id", type=str, required=True)
    p.add_argument("--data_files", "-f", type=str, default="RunG_batch0.h5")
    p.add_argument("--dir_aoj", type=str, default=None,
                   help="override the experiment's stored AOJ data dir")
    p.add_argument("--continuous_features", "-cont", type=str, nargs="*",
                   default=["pt", "eta_rel", "phi_rel"])
    p.add_argument("--discrete_features", "-disc", type=str, default="tokens")
    p.add_argument("--batch_size", "-bs", type=int, default=256)
    p.add_argument("--tag", "-t", type=str, default="")
    p.add_argument("--checkpoint", "-ckpt", type=str, default="best")
    p.add_argument("--num_jets", "-n", type=int, default=100_000)
    p.add_argument("--num_timesteps", "-steps", type=int, nargs="*", default=[100])
    p.add_argument("--temperature", "-tmp", type=float, nargs="*", default=[1.0])
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--use_final_max_rates", action="store_true", default=False)
    p.add_argument("--num_files", type=int, default=1)
    p.add_argument("--make_plots", "-plots", action="store_true", default=False)
    p.add_argument("--max_dispatch_steps", type=int, default=8_000,
                   help="a knob of the JAX package's dispatch; no effect here")
    p.add_argument("--scan_unroll", type=int, default=1,
                   help="a knob of the JAX package's compiled loop; no effect here")
    p.add_argument("--metrics_only", action="store_true", default=False,
                   help="crash-resume: skip generation and (re)compute metrics.json "
                        "for every existing generation_results* dir that has a "
                        "generated_sample.h5 but no metrics")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run; without CUDA the default raises, "
                        "`cpu` runs on the CPU")
    args = p.parse_args(argv)

    run_cfg = Config.load(os.path.join(args.dir, args.project, args.experiment_id))
    for k in ["dir", "project", "experiment_id", "data_files", "continuous_features",
              "discrete_features", "batch_size", "num_jets", "top_k", "top_p",
              "use_final_max_rates", "num_files"]:
        setattr(run_cfg, k, getattr(args, k))
    if args.dir_aoj is not None:
        run_cfg.dir_aoj = args.dir_aoj
    run_cfg.temperature = args.temperature
    run_cfg.num_timesteps = args.num_timesteps
    return run_cfg, args


def sample(config: Config, kind: str, test_masks: np.ndarray, device="cuda", *,
           checkpoint: str = "best", temperatures: Sequence[float] = (1.0,),
           timestep_grid: Sequence[int] = (100,), num_files: int = 1,
           save: bool = True) -> List[GenerationResult]:
    """The compute half: build the `kind` system on `device`, load
    checkpoint slot `checkpoint` of the experiment, draw `config.num_jets`
    pad masks from the multiplicities of `test_masks` (N, D, 1) and run the
    generation sweep.  With `save` each sweep point is written into the
    experiment directory (that needs h5py and yaml).  With a process group
    the batches shard over its ranks; the model is replicated (the
    training layout does not matter: a checkpoint holds full tensors)."""
    from multimodal_flows_tpu_torch.data.aoj import sample_from_empirical_masks

    system = build_system(config, kind, device=device)
    trainer = Trainer(system, config.replace(fsdp=False, tensor_parallel=1), mesh="auto")
    system.module.load_state_dict(trainer.load_for_inference(name=checkpoint))
    log.info(f"loaded checkpoint {checkpoint!r} from {config.experiment_dir}")

    pad_masks = sample_from_empirical_masks(
        test_masks, config.num_jets, config.max_num_particles, seed=config.seed)
    return run_generation_sweep(system, pad_masks, config, temperatures=list(temperatures),
                                timestep_grid=list(timestep_grid), num_files=num_files,
                                save=save, mesh=trainer.mesh)


def main(argv=None):
    config, args = experiment_configs(argv)
    kind = system_kind_of(config)
    if args.metrics_only and kind != "GPT":
        return _metrics_only(config)
    args.device = init_from_env(args.device)  # under torchrun: this rank's device
    try:
        if kind == "GPT":
            _sample_gpt(config, args)
        else:
            _sample_flows(config, kind, args)
    finally:
        if initialized():
            torch.distributed.destroy_process_group()


def _sample_flows(config: Config, kind: str, args) -> None:
    if args.max_dispatch_steps != 8_000 or args.scan_unroll != 1:
        log.info("--max_dispatch_steps and --scan_unroll steer the JAX package's compiled "
                 "loop and have no effect in the PyTorch port")

    test = _load_test(config)
    results = sample(config, kind, test.mask, args.device, checkpoint=args.checkpoint,
                     temperatures=args.temperature, timestep_grid=args.num_timesteps,
                     num_files=args.num_files)
    if not is_primary():
        return

    # W1 closure metrics against the test sample
    for res in results:
        res_dir = os.path.join(config.experiment_dir, f"generation_results{res.tag}")
        point = {"jets_per_sec": res.jets_per_sec,
                 "num_timesteps": res.num_timesteps,
                 "temperature": res.temperature}
        _write_point_metrics(res_dir, res.sample, test, config, point, tag=res.tag)

    if args.make_plots:
        from multimodal_flows_tpu_torch.utils.jet_features import JetFeatures
        from multimodal_flows_tpu_torch.utils.plotting import (
            flavor_kinematics,
            plot_flavor_feats,
            plot_kin_feats,
        )

        for res in results:
            res_dir = os.path.join(config.experiment_dir, f"generation_results{res.tag}")
            plot_flavor_feats(res.sample, test, path=os.path.join(res_dir, "plots_flavor.png"))
            gen_feats, test_feats = JetFeatures(res.sample), JetFeatures(test)
            plot_kin_feats(gen_feats, test_feats, path=os.path.join(res_dir, "plots_kin.png"))
            flavor_kinematics(gen_feats, test_feats,
                              path=os.path.join(res_dir, "flavor_kinematics.png"))


def sample_gpt(config: Config, device="cuda", *, checkpoint: str = "best",
               temperature: float = 1.0) -> np.ndarray:
    """The GPT compute half: build the GPT system on `device`, load
    checkpoint slot `checkpoint` and generate `config.num_jets` token sets
    in batches of `config.batch_size`, batch b from a generator seeded by
    (`config.seed`, b).  Returns (num_jets, max_num_particles) flavor
    tokens, the special tokens stripped."""
    system = build_system(config, "GPT", device=device)
    trainer = Trainer(system, config, mesh=None)
    system.module.load_state_dict(trainer.load_for_inference(name=checkpoint))
    log.info(f"loaded GPT checkpoint {checkpoint!r} from {config.experiment_dir}")
    bs = config.batch_size
    chunks = []
    for b in range(-(-config.num_jets // bs)):
        gen = torch.Generator(device=system.device).manual_seed(_seed(config.seed, b))
        chunks.append(system.sample_jets(bs, gen, temperature=temperature,
                                         top_k=config.top_k))
    return np.concatenate(chunks, axis=0)[:config.num_jets]


def _sample_gpt(config: Config, args) -> None:
    """Autoregressive generation of a GPT experiment into `sample.npy`
    (every rank generates the same jets; rank 0 writes them)."""
    temp = args.temperature[0]
    sample = sample_gpt(config, args.device, checkpoint=args.checkpoint, temperature=temp)
    if not is_primary():
        return
    res_dir = os.path.join(config.experiment_dir,
                           f"generation_results_{args.tag}_gpt_temp_{temp}")
    os.makedirs(res_dir, exist_ok=True)
    out = os.path.join(res_dir, "sample.npy")
    np.save(out, sample)
    log.info(f"wrote {sample.shape} token sample -> {out}")


def _load_test(config: Config) -> MultiModal:
    """The test jets (physical units, numpy): the source of the empirical
    multiplicities and the W1 reference sample."""
    from multimodal_flows_tpu_torch.data.aoj import AspenOpenJets

    aoj = AspenOpenJets(data_dir=config.dir_aoj, data_files=config.data_files)
    test, _ = aoj(num_jets=config.num_jets,
                  max_num_particles=config.max_num_particles,
                  features={"continuous": config.continuous_features,
                            "discrete": config.discrete_features},
                  pt_order=True, padding="zeros")
    return test


def point_metrics(sample: MultiModal, test: MultiModal, config: Config, point: Dict,
                  tag: str = "", flavor_path: Optional[str] = None) -> Dict:
    """One sweep point's W1 closure metrics added to `point` (numpy only):
    `w1_flavor` over the 16 flavor observables and `w1_kinematics` per
    continuous feature over real particles, in physical units."""
    from multimodal_flows_tpu_torch.utils.jet_features import astype_numpy
    from multimodal_flows_tpu_torch.utils.metrics import wasserstein1d, wasserstein_flavor

    sample, test = astype_numpy(sample), astype_numpy(test)
    if sample.discrete is not None and test.discrete is not None:
        w1 = wasserstein_flavor(sample, test, path=flavor_path)
        point["w1_flavor"] = w1
        log.info(f"{tag}: W1(multiplicity)={w1['multiplicity']:.4f}")
    if sample.continuous is not None and test.continuous is not None:
        gm, rm = sample.mask[..., 0] > 0, test.mask[..., 0] > 0
        names = config.continuous_features or ["pt", "eta_rel", "phi_rel"]
        point["w1_kinematics"] = {
            name: wasserstein1d(sample.continuous[..., i][gm], test.continuous[..., i][rm])
            for i, name in enumerate(names)}
        log.info(f"{tag}: W1(kin)=" + str(
            {k: round(v, 4) for k, v in point['w1_kinematics'].items()}))
    return point


def _write_point_metrics(res_dir, sample, test, config, point, tag=""):
    """Compute one sweep point's metrics and persist them as `metrics.json`
    (with the flavor W1s also as `w1_flavor.txt`)."""
    point_metrics(sample, test, config, point, tag=tag,
                  flavor_path=os.path.join(res_dir, "w1_flavor.txt"))
    with open(os.path.join(res_dir, "metrics.json"), "w") as f:
        json.dump(point, f, indent=1)


def _metrics_only(config: Config) -> None:
    """Crash-resume: recompute metrics.json for existing generation dirs.

    Generation and metrics fail apart: the h5 write lands before the W1
    pass, and a crash in between must not force regenerating the jets.  The
    steps and the temperature are read back from the directory's tag.  No
    device code runs; a truncated sample file is renamed to `.corrupt` so
    that the next full run regenerates it."""
    import glob
    import re

    test = _load_test(config)
    done = 0
    for res_dir in sorted(glob.glob(os.path.join(config.experiment_dir,
                                                 "generation_results*"))):
        h5 = os.path.join(res_dir, "generated_sample.h5")
        if not os.path.exists(h5) or os.path.exists(os.path.join(res_dir, "metrics.json")):
            continue
        m = re.search(r"steps_(\d+)_temp_([\d.]+)", os.path.basename(res_dir))
        point = {"jets_per_sec": None,  # unknown: generation ran in an earlier process
                 "num_timesteps": int(m.group(1)) if m else None,
                 "temperature": float(m.group(2)) if m else None}
        try:
            sample = MultiModal.load_from(h5)
        except OSError as e:
            log.info(f"corrupt sample {h5} ({e}); renaming to .corrupt")
            os.replace(h5, h5 + ".corrupt")
            continue
        _write_point_metrics(res_dir, sample, test, config, point,
                             tag=os.path.basename(res_dir))
        done += 1
    log.info(f"metrics_only: wrote metrics.json for {done} generation dir(s)")


if __name__ == "__main__":
    main()
