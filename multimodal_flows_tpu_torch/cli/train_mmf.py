"""Training entry point of the port: train a MultiModal Flow Bridge (or
CFM / MJB, or the GPT baseline) on AOJ jets.

    python -m multimodal_flows_tpu_torch.cli.train_mmf --dir_aoj ./aoj \
        --data_files RunG_batch0.h5 --num_jets 100000 --packed_training
    torchrun --nproc_per_node=8 -m multimodal_flows_tpu_torch.cli.train_mmf ... \
        [--fsdp | --tensor_parallel 2]

The twin of `scripts/train_mmf.py`: the same flags, short names and
defaults, the same `config.yaml` round trip (a file written by either
package loads in both), the same `system:<kind>` tag and resume overrides
(`-id <experiment> [-resume last]`).  One flag is new, `--device` (default
`cuda`): the run raises without a CUDA device unless `--device cpu` is
given.  `--attn_impl` and `--remat` steer XLA in the JAX package; here they
are stored in the config and have no effect.  `--compute_dtype bfloat16`
trains the transformer encoders in bf16 (parameters fp32, each layer cast
at use, K1 and K2 in bf16 on the card), as the JAX package's flag does;
EPiC and GPT ignore it there and here.  Under `torchrun` every process trains
on its rank's device (NCCL on `cuda:LOCAL_RANK`, gloo with `--device cpu`)
over the mesh of `Trainer(mesh="auto")`: data parallel, FSDP (`--fsdp`) or
tensor parallel (`--tensor_parallel N`); rank 0 mints the experiment id
and writes every file.  `--system GPT` trains data parallel the same way.
With `--system GPT` the jets become BOS/EOS/PAD token sequences of
`max_num_particles + 2` (`max_seq_length` is set to `max_num_particles`).

`main` is the file I/O (`make_datasets`, `Config.save`) around the compute
half, `build_trainer` and `Trainer.fit`; `train` is that half in one call,
on in-memory datasets and a device, and needs neither h5py nor yaml.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import torch

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.datasets import ArrayDataset, jet_set_to_seq
from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
from multimodal_flows_tpu_torch.parallel.mesh import (
    broadcast_object,
    init_from_env,
    initialized,
    is_primary,
    sync_hosts,
)
from multimodal_flows_tpu_torch.train.systems import build_system
from multimodal_flows_tpu_torch.train.trainer import Trainer, TrainState
from multimodal_flows_tpu_torch.utils.logger import SimpleLogger as log


def _flag(s: str) -> bool:
    return s.lower() != "false"


def experiment_configs(argv=None) -> Tuple[Config, str]:
    """(config, device) from the command line; with `--experiment_id` the
    persisted config of that run, under the resume overrides."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # system
    p.add_argument("--num_nodes", "-N", type=int, default=1)
    p.add_argument("--dir", type=str, default="./experiments")
    p.add_argument("--dir_aoj", type=str, default="./aoj")
    p.add_argument("--project", "-proj", type=str, default="aoj_jets")
    p.add_argument("--experiment_id", "-id", type=str, default=None)
    p.add_argument("--ckpt_path", "-ckpt", type=str, default=None)
    p.add_argument("--resume_ckpt", "-resume", type=str, default="last")
    p.add_argument("--tags", type=str, nargs="*")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run; without CUDA the default raises, "
                        "`cpu` runs on the CPU")
    # training
    p.add_argument("--data_files", "-f", type=str, default="RunG_batch0.h5")
    p.add_argument("--num_jets", "-n", type=int, default=1_250_000)
    p.add_argument("--max_num_particles", "-d", type=int, default=150)
    p.add_argument("--batch_size", "-bs", type=int, default=256)
    p.add_argument("--max_epochs", "-epochs", type=int, default=1500)
    p.add_argument("--train_frac", type=float, default=0.8)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--lr_final", type=float, default=1e-5)
    p.add_argument("--warmup_epochs", type=int, default=0)
    p.add_argument("--use_ema_weights", "-ema", action="store_true", default=False)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--seed", type=int, default=0)
    # model
    p.add_argument("--model", "-nn", type=str, default="ParticleFormer")
    p.add_argument("--continuous_features", "-cont", type=str, nargs="*",
                   default=["pt", "eta_rel", "phi_rel"])
    p.add_argument("--discrete_features", "-disc", type=str, default="tokens")
    p.add_argument("--vocab_size", type=int, default=9)
    p.add_argument("--dim_continuous", type=int, default=3)
    p.add_argument("--n_embd", type=int, default=256)
    p.add_argument("--n_inner", type=int, default=512)
    p.add_argument("--n_layer", type=int, default=5)
    p.add_argument("--n_layer_fused", type=int, default=6)
    p.add_argument("--n_head", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--qk_layernorm", type=_flag, default=True)
    p.add_argument("--bias", type=_flag, default=True)
    p.add_argument("--multitask_loss", "-loss", type=str, default="time-weighted")
    p.add_argument("--use_coocurrence", action="store_true", default=False)
    p.add_argument("--use_pairwise", action="store_true", default=False,
                   help="pairwise attention bias (Lund for KinFormer, token "
                        "co-occurrence for FlavorFormer)")
    p.add_argument("--use_pos_emb", action="store_true", default=False,
                   help="learned positional embedding (FlavorFormer/KinFormer)")
    p.add_argument("--n_embd_glob", type=int, default=16, help="EPiC global-stream width")
    # dynamics
    p.add_argument("--beta", "-b", type=float, default=0.075)
    p.add_argument("--sigma", "-sig", type=float, default=1e-5)
    p.add_argument("--time_eps", "-eps", type=float, default=1e-5)
    # sampling defaults stored in config
    p.add_argument("--num_timesteps", "-steps", type=int, default=100)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=None)
    # execution
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--attn_impl", type=str, default=None,
                   choices=[None, "auto", "xla", "pallas"],
                   help="stored for the JAX package; no effect here")
    p.add_argument("--system", type=str, default="MMF", choices=["MMF", "CFM", "MJB", "GPT"],
                   help="trainable system")
    p.add_argument("--bucketed_training", action="store_true", default=False,
                   help="group jets by multiplicity into static-width buckets "
                        "(within-bucket batches)")
    p.add_argument("--packed_training", action="store_true", default=False,
                   help="multi-jet packed training: jets share pack_width-token rows "
                        "behind a block-diagonal segment mask, with per-jet time and "
                        "per-jet loss normalization")
    p.add_argument("--pack_width", type=int, default=128,
                   help="packed row width for packed training/sampling")
    p.add_argument("--physics_eval_every_n_epochs", type=int, default=0,
                   help="0 = off; every N epochs sample a few thousand jets and "
                        "checkpoint the best W1(pt/mass/mult) in a `best_physics` slot")
    p.add_argument("--physics_eval_num_jets", type=int, default=2000)
    p.add_argument("--physics_eval_num_timesteps", type=int, default=250)
    p.add_argument("--physics_eval_margin", type=float, default=0.3,
                   help="tie-to-later slot rule: best_physics holds the LATEST eval "
                        "within (1+margin) of the best score seen; 0 = argmin")
    p.add_argument("--use_wandb", action="store_true", default=False,
                   help="extra Weights & Biases metric sink (offline-first; needs the "
                        "wandb package)")
    p.add_argument("--remat", action="store_true", default=False,
                   help="stored for the JAX package; no effect here")
    p.add_argument("--fsdp", action="store_true", default=False,
                   help="ZeRO-3-style: shard params + optimizer state over "
                        "the data axis (FSDP2)")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="model-axis size of a (data, model) mesh with "
                        "Megatron-style layer sharding")
    p.add_argument("--epoch_hbm_budget_mb", type=int, default=4096,
                   help="cap of the device-resident epoch data; larger sets stay on "
                        "the host and ship batch by batch")

    ns = vars(p.parse_args(argv))
    device = ns.pop("device")
    system_kind = ns.pop("system")
    cfg = Config(**ns)
    # the system kind goes into the persisted tags, so that a resume and the
    # sampling entry point rebuild the right system
    cfg.tags = [t for t in (cfg.tags or []) if not t.startswith("system:")]
    cfg.tags.append(f"system:{system_kind}")

    if cfg.experiment_id is not None:
        # resume: reload the persisted config, keep the resume-relevant overrides
        run_cfg = Config.load(os.path.join(cfg.dir, cfg.project, cfg.experiment_id))
        run_cfg.max_epochs = cfg.max_epochs
        run_cfg.lr = cfg.lr
        run_cfg.lr_final = cfg.lr_final
        run_cfg.resume_ckpt = cfg.resume_ckpt
        run_cfg.experiment_id = cfg.experiment_id
        return run_cfg, device
    return cfg, device


def system_kind_of(config: Config) -> str:
    for t in config.tags or []:
        if t.startswith("system:"):
            return t.split(":", 1)[1]
    return "MMF"


def make_datasets(config: Config, kind: str = "MMF") -> Tuple[ArrayDataset, ArrayDataset]:
    """Read the AOJ files of the config (standardized, pT-ordered), put the
    metadata into `config.metadata`, and split into (train, val) for the
    `kind` system."""
    from multimodal_flows_tpu_torch.data.aoj import AspenOpenJets

    aoj = AspenOpenJets(data_dir=config.dir_aoj, data_files=config.data_files)
    jets, metadata = aoj(
        num_jets=config.num_jets,
        max_num_particles=config.max_num_particles,
        download=True,
        features={"continuous": config.continuous_features,
                  "discrete": config.discrete_features},
        transform="standardize",
        pt_order=True,
        padding="zeros",
    )
    config.metadata = metadata
    return split_jets(jets, config, kind)


def split_jets(jets: MultiModal, config: Config,
               kind: str = "MMF") -> Tuple[ArrayDataset, ArrayDataset]:
    """(train, val) of in-memory jets.  For the flow systems the source
    carries only the pad mask: x0 and k0 are drawn on the device at every
    loss call.  For GPT the target is the jets' token sequences
    (`jet_set_to_seq`)."""
    if kind == "GPT":
        coupling = DataCoupling(target=jet_set_to_seq(jets, config.vocab_size))
    else:
        coupling = DataCoupling(source=MultiModal(mask=jets.mask), target=jets)
    return ArrayDataset(coupling).split(config.train_frac, seed=config.seed)


def build_trainer(config: Config, kind: str, device="cuda") -> Trainer:
    """The `kind` system on `device` (weights from `config.seed`) inside
    its trainer, over the mesh of the process group when there is one.
    Raises on the default device without CUDA, and when the world size
    does not divide by `tensor_parallel`.  For GPT the sequences hold every
    particle: `max_seq_length` is set to `max_num_particles` first, as the
    JAX script's `make_datasets` does."""
    if kind == "GPT":
        config.max_seq_length = config.max_num_particles
    system = build_system(config, kind, device=device,
                          generator=torch.Generator().manual_seed(config.seed))
    return Trainer(system, config)


def train(config: Config, kind: str, train_ds: ArrayDataset, val_ds: ArrayDataset,
          device="cuda", resume: Optional[str] = None) -> Tuple[Trainer, TrainState]:
    """The compute half: build the system and its trainer on `device` and
    fit in-memory datasets; the experiment directory takes the checkpoints
    and the metric files."""
    trainer = build_trainer(config, kind, device)
    return trainer, trainer.fit(train_ds, val_ds, resume=resume)


def main(argv=None):
    config, device = experiment_configs(argv)
    device = init_from_env(device)  # under torchrun: this rank's device
    kind = system_kind_of(config)
    if config.attn_impl is not None or config.remat:
        log.info("--attn_impl and --remat are stored for the JAX package and have no "
                 "effect in the PyTorch port")
    # before any file is read or written: a missing CUDA device and a mesh
    # that does not fit raise here
    trainer = build_trainer(config, kind, device)

    resume = None
    if config.experiment_id is not None:
        resume = config.resume_ckpt
        log.info(f"resuming experiment {config.experiment_id} from {resume!r}")
    else:
        config.experiment_id = broadcast_object(
            config.mint_experiment_id() if is_primary() else None)

    train_ds, val_ds = make_datasets(config, kind)
    if is_primary():
        config.save()  # config.yaml, metadata included, into the experiment dir
    sync_hosts("config")
    log.info(f"experiment dir: {config.experiment_dir} (system {kind}, device {device})")
    trainer.fit(train_ds, val_ds, resume=resume)
    if initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
