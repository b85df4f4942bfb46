"""Experiment configuration (PyTorch port of `multimodal_flows_tpu/config.py`).

The same `Config` dataclass, field for field and with the same defaults,
so a `config.yaml` written by either package loads in both.  The knobs
that only the JAX package acts on (`attn_impl`, `mesh_shape`, `fsdp`,
`tensor_parallel`, `remat`, ...) stay as fields for that reason.  `yaml`
is imported where it is used: the GPU machine may not have it.
"""

from __future__ import annotations

import dataclasses
import os
import secrets
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Config:
    # system
    num_nodes: int = 1
    dir: str = "./experiments"
    dir_aoj: str = "./aoj"
    project: str = "aoj_jets"
    experiment_id: Optional[str] = None
    ckpt_path: Optional[str] = None
    resume_ckpt: str = "last"
    tags: Optional[List[str]] = None

    # training
    data_files: Any = "RunG_batch0.h5"
    num_jets: int = 1_250_000
    max_num_particles: int = 150
    batch_size: int = 256
    max_epochs: int = 1500
    train_frac: float = 0.8
    lr: float = 5e-4
    lr_final: float = 1e-5
    warmup_epochs: int = 0
    use_ema_weights: bool = False
    ema_decay: float = 0.9999
    gradient_clip_val: float = 1.0
    seed: int = 0

    # model
    model: str = "ParticleFormer"
    continuous_features: List[str] = field(default_factory=lambda: ["pt", "eta_rel", "phi_rel"])
    discrete_features: str = "tokens"
    vocab_size: int = 9  # tokens 1..8 plus pad token 0
    dim_continuous: int = 3
    n_embd: int = 256
    n_inner: Optional[int] = 512
    n_layer: int = 5
    n_layer_fused: int = 6
    n_head: int = 4
    dropout: float = 0.0
    qk_layernorm: bool = True
    bias: bool = True
    multitask_loss: str = "time-weighted"
    use_coocurrence: bool = False
    use_pos_emb: bool = False
    use_pairwise: bool = False
    n_embd_glob: int = 16
    markov_jump_solver: str = "tauleap-poisson"
    hybrid_solver: str = "tauleap"
    class_freqs: Optional[List[float]] = None

    # GPT baseline keys
    max_seq_length: int = 150
    activation: str = "gelu_new"
    dropout_att: float = 0.0
    dropout_emb: float = 0.0
    dropout_res: float = 0.0

    # dynamics
    beta: float = 0.075
    sigma: float = 1e-5
    time_eps: float = 1e-5

    # sampling
    num_timesteps: Any = 100
    temperature: Any = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    use_final_max_rates: bool = False

    # dataset metadata injected at runtime
    metadata: Optional[Dict[str, Any]] = None

    # knobs of the JAX package, kept so configs round-trip between packages
    mesh_shape: Optional[Dict[str, int]] = None
    compute_dtype: str = "float32"
    attn_impl: Optional[str] = None
    remat: bool = False
    bucketed_training: bool = False
    bucket_widths: List[int] = field(default_factory=lambda: [48, 64, 128])
    packed_training: bool = False
    pack_width: int = 128
    pair_chunk: int = 16
    fsdp: bool = False
    tensor_parallel: int = 1
    epoch_hbm_budget_mb: int = 4096
    checkpoint_every_n_epochs: int = 1
    save_top_k: int = 10
    physics_eval_every_n_epochs: int = 0
    physics_eval_num_jets: int = 2000
    physics_eval_num_timesteps: int = 250
    physics_eval_margin: float = 0.3
    log_every_n_steps: int = 50
    use_wandb: bool = False

    # ------------------------------------------------------------ helpers

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def experiment_dir(self) -> str:
        if self.experiment_id is None:
            raise ValueError("experiment_id is not set")
        return os.path.join(self.dir, self.project, self.experiment_id)

    def mint_experiment_id(self) -> str:
        if self.experiment_id is None:
            self.experiment_id = secrets.token_hex(8)
        return self.experiment_id

    def save(self, path: Optional[str] = None) -> str:
        """Persist config.yaml into the experiment dir."""
        import yaml

        path = path or self.experiment_dir
        os.makedirs(path, exist_ok=True)
        out = os.path.join(path, "config.yaml")
        with open(out, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False, default_flow_style=False)
        return out

    @classmethod
    def load(cls, experiment_path: str) -> "Config":
        """Reload a persisted config; unknown keys are ignored."""
        import yaml

        with open(os.path.join(experiment_path, "config.yaml")) as f:
            raw = yaml.safe_load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})
