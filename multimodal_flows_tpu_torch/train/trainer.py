"""The training loop on one device (PyTorch port of
`multimodal_flows_tpu/train/trainer.py`).

A step is loss -> backward -> global-norm clip -> Adam at the schedule's
rate for this step -> EMA, on the system's device (CUDA unless the system
was built on the CPU).  Validation runs the same loss with the EMA weights
when `use_ema_weights` is set, and the per-epoch means feed the best-k
checkpoints on val_loss / val_loss_mse / val_loss_ce.

The JAX package compiles an epoch into one `lax.scan` over batches that
are gathered on the device; the port keeps what that means, not how: a
unit (a dataset, or the packed rows of one width) is shipped to the device
once when it fits `epoch_hbm_budget_mb`, each epoch ships one (n_batches,
batch) index matrix drawn from the JAX package's permutation stream, and
each batch is gathered on the device.  The per-step metrics stay on the
device until the end of the unit's epoch, and come back in one copy, so a
step makes no host sync.

In packed training (`packed_training`) `batch_size` counts jets per step:
the row batch is round(batch_size / jets per row), at most batch_size,
computed once from the training set's packing and kept for validation.
In bucketed training (`bucketed_training`) jets are grouped by
multiplicity into the static widths `bucket_widths` + the full width, a
bucket is a unit, and batches are cut within a bucket, so the pad columns
beyond a bucket's width are never computed.  The two are mutually
exclusive.

With `physics_eval_every_n_epochs > 0` the trainer samples
`physics_eval_num_jets` jets on every such epoch and the last, scores W1
against the validation set (`train/physics_eval.py`), logs `val_w1_*` and
saves a checkpoint, which fills the `best_physics` slot.

Not ported, raising with a pointer to ROADMAP.md: meshes (FSDP, tensor
parallelism).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.datasets import ArrayDataset, num_batches
from multimodal_flows_tpu_torch.data.packing import (
    PackedDataset,
    first_n_filled,
    pack_multimodal,
    pad_rows,
    singleton_rows,
)
from multimodal_flows_tpu_torch.data.state import DataCoupling
from multimodal_flows_tpu_torch.train.checkpoints import CheckpointManager
from multimodal_flows_tpu_torch.train.ema import ema_update
from multimodal_flows_tpu_torch.train.lr_schedules import warmup_cosine_epoch_schedule
from multimodal_flows_tpu_torch.utils.logger import MetricsLogger, SimpleLogger as log

# Adam as optax.adam builds it: eps outside the square root, no weight decay
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


@dataclasses.dataclass
class TrainState:
    module: nn.Module                 # the system's trained module
    optimizer: torch.optim.Optimizer
    ema: Optional[nn.Module]          # an EMA copy of `module`, None when EMA is off
    step: int                         # optimizer updates so far


def _check_supported(cfg: Config) -> None:
    if cfg.fsdp or cfg.tensor_parallel > 1 or cfg.mesh_shape:
        raise NotImplementedError("meshes, FSDP and TP are not ported yet (ROADMAP.md "
                                  "Queue 1 item 22)")


def _seed(*parts: int) -> int:
    return int(np.random.SeedSequence(list(parts)).generate_state(1)[0])


class Trainer:
    """Trains `system` on its own device."""

    def __init__(self, system, config: Config):
        _check_supported(config)
        self.system = system
        self.config = config
        self.device = system.device
        self._packed_row_bs = None  # rows per step in packed training (_pack_units)
        self._physics_ref = None    # (reference observables, masks) of the physics eval

    # ------------------------------------------------------------ building

    def make_optimizer(self, steps_per_epoch: int) -> torch.optim.Optimizer:
        """Adam over every parameter of the system's module (the multitask
        loss's included); `_apply_gradients` clips first and sets the rate."""
        cfg = self.config
        self.lr_schedule = warmup_cosine_epoch_schedule(
            cfg.lr, cfg.lr_final, cfg.warmup_epochs, cfg.max_epochs, steps_per_epoch)
        return torch.optim.Adam(self.system.module.parameters(), lr=self.lr_schedule(0),
                                betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=0.0)

    def init_state(self, steps_per_epoch: int) -> TrainState:
        module = self.system.module
        ema = (copy.deepcopy(module).requires_grad_(False)
               if self.config.use_ema_weights else None)
        return TrainState(module, self.make_optimizer(steps_per_epoch), ema, 0)

    # --------------------------------------------------------------- steps

    def _apply_gradients(self, state: TrainState, loss: torch.Tensor,
                         metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Backward, then optax's `clip_by_global_norm` (scale by max/norm
        only when norm >= max), Adam at schedule(step) (optax evaluates the
        schedule before counting the update), EMA."""
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        out = {k: v.detach() for k, v in metrics.items()}
        out["grad_norm"] = self._update(state)
        return out

    def _update(self, state: TrainState) -> torch.Tensor:
        """One update from the gradients in `.grad`; returns their global
        norm before clipping."""
        cfg = self.config
        params = list(state.module.parameters())
        for p in params:  # optax updates a parameter the loss does not reach too
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, torch.clamp(cfg.gradient_clip_val / grad_norm, max=1.0))
        for group in state.optimizer.param_groups:
            group["lr"] = self.lr_schedule(state.step)
        state.optimizer.step()
        if state.ema is not None:
            ema_update(state.ema.parameters(), params, cfg.ema_decay)
        state.step += 1
        return grad_norm.detach()

    def _train_step(self, state: TrainState, batch, generator: torch.Generator):
        loss, metrics = self.system.loss_fn(batch, generator, train=True, module=state.module)
        return self._apply_gradients(state, loss, metrics)

    @torch.no_grad()
    def _eval_step(self, module: nn.Module, batch, generator: torch.Generator):
        return self.system.loss_fn(batch, generator, train=False, module=module)[1]

    @staticmethod
    def _fetch_metrics(metrics_seq: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
        """{name: (n_batches,)} of a unit's epoch, in one device -> host copy."""
        names = sorted(metrics_seq[0])
        stacked = torch.stack([torch.stack([m[k].to(torch.float32) for m in metrics_seq])
                               for k in names]).cpu().numpy()
        return {k: stacked[i] for i, k in enumerate(names)}

    @staticmethod
    def _epoch_perm(n: int, batch_size: int, *, shuffle: bool, seed: int,
                    epoch: int, pad_last: bool = False) -> np.ndarray:
        """(n_b, B) row indices for one epoch: the index stream of
        `shuffle_batches` (`SeedSequence([seed, epoch])`)."""
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(np.random.SeedSequence([seed, epoch])).shuffle(idx)
        num_full = n // batch_size
        out = idx[:num_full * batch_size].reshape(num_full, batch_size)
        rem = n - num_full * batch_size
        if rem and pad_last:
            tail = np.tile(idx[num_full * batch_size:], math.ceil(batch_size / rem))[:batch_size]
            out = np.concatenate([out, tail[None]], axis=0)
        return out.astype(np.int32)

    # ------------------------------------------------- multiplicity buckets

    @staticmethod
    def _truncate_width(coupling: DataCoupling, w: int) -> DataCoupling:
        """Drop the pad columns beyond width w (valid for first-n masks
        only); per-jet fields (time) are kept whole."""
        def trunc(a):
            return a[:, :w] if a.ndim >= 2 else a

        return DataCoupling(coupling.source.map(trunc), coupling.target.map(trunc),
                            coupling.context)

    def _bucketize(self, ds: ArrayDataset, min_size: int = 1):
        """Split a dataset into multiplicity buckets of static widths
        (`config.bucket_widths` + the full width).  Returns
        [(width, ArrayDataset, indices)], or None when the masks are not
        first-n filled (truncating would drop real particles).

        A bucket smaller than `min_size` (the batch size) is merged into
        the next wider one; that loses nothing, since truncation keeps
        every particle at any width >= the multiplicity.  When the widest
        buckets are undersized, the widest surviving bucket is folded into
        them at the wider width.  So the partition excludes no jet from
        training."""
        mask = np.asarray(ds.coupling.target.mask)
        D = mask.shape[1]
        mult = mask[..., 0].sum(axis=1)
        if not first_n_filled(mask):
            return None
        widths = sorted(w for w in self.config.bucket_widths if w < D) + [D]
        raw, lo = [], -1
        for w in widths:
            sel = np.where((mult <= w) & (mult > lo))[0]
            lo = w
            if len(sel):
                raw.append((w, sel))

        merged = []
        carry_sel, carry_w = None, None
        for w, sel in raw:
            if carry_sel is not None:
                sel = np.concatenate([carry_sel, sel])
                carry_sel = None
            if len(sel) < min_size:
                carry_sel, carry_w = sel, w
            else:
                merged.append((w, sel))
        if carry_sel is not None:
            if merged:
                w_prev, sel_prev = merged.pop()
                merged.append((max(w_prev, carry_w), np.concatenate([sel_prev, carry_sel])))
            else:
                merged.append((carry_w, carry_sel))

        return [(w, ArrayDataset(self._truncate_width(ds.coupling[sel], w)), sel)
                for w, sel in merged]

    # --------------------------------------------------- packed training

    def _pack_units(self, ds: ArrayDataset) -> Optional[List[PackedDataset]]:
        """The packed units of a dataset: its `pack_width` rows and, when
        some jets are wider, one-jet rows at the full width, each padded
        with empty rows to a multiple of the row batch.  None when packing
        does not apply: learned positions, explicit sources in the
        coupling (the packed loss draws its own), or masks that are not
        first-n filled.  Rows are packed once; epochs shuffle rows."""
        cfg = self.config
        if cfg.use_pos_emb:
            log.warn("packed_training disabled: learned positional embeddings "
                     "(use_pos_emb) are incompatible with multi-jet packed rows")
            return None
        src = ds.coupling.source
        if src.continuous is not None or src.discrete is not None:
            log.warn("packed_training disabled: coupling has explicit sources "
                     "(packed loss draws sources per token)")
            return None
        target = ds.coupling.target
        try:
            packed, leftover = pack_multimodal(target, cfg.pack_width)
        except ValueError:
            log.warn("packed_training disabled: masks are not first-n filled")
            return None

        if self._packed_row_bs is None:
            n_rows = (len(packed) if packed is not None else 0) + len(leftover)
            jets_per_row = max(len(target) / max(n_rows, 1), 1.0)
            row_bs = max(int(round(cfg.batch_size / jets_per_row)), 1)
            self._packed_row_bs = min(row_bs, cfg.batch_size)
            log.info(f"packed training: {jets_per_row:.2f} jets/row -> "
                     f"{self._packed_row_bs} rows per step (~{cfg.batch_size} jets/step)")
        row_bs = self._packed_row_bs

        units = []
        if packed is not None:
            units.append(PackedDataset(pad_rows(packed, row_bs)))
        if len(leftover):
            units.append(PackedDataset(pad_rows(singleton_rows(target[leftover]), row_bs)))
        return units or None

    def _units(self, train_ds: ArrayDataset, val_ds: ArrayDataset):
        """(train units, val units, batch rows, bucket widths): packed rows
        or multiplicity buckets when configured and possible for both
        sets, else the datasets themselves.  The widths are those of the
        train buckets, None when training is not bucketed."""
        cfg = self.config
        if cfg.packed_training:
            if cfg.bucketed_training:
                raise ValueError("packed_training and bucketed_training are mutually exclusive")
            train_units = self._pack_units(train_ds)
            val_units = self._pack_units(val_ds) if train_units else None
            if val_units is not None:
                return train_units, val_units, self._packed_row_bs, None
        if cfg.bucketed_training:
            train_buckets = self._bucketize(train_ds, min_size=cfg.batch_size)
            val_buckets = self._bucketize(val_ds)
            if train_buckets is not None and val_buckets is not None:
                return ([b for _, b, _ in train_buckets], [b for _, b, _ in val_buckets],
                        cfg.batch_size, [w for w, _, _ in train_buckets])
            log.warn("bucketed_training disabled: masks are not first-n filled")
        return [train_ds], [val_ds], cfg.batch_size, None

    def _resident(self, ds):
        """A unit's arrays as tensors: on the device when they fit
        `epoch_hbm_budget_mb` (batches are then gathered there), else on
        the host (each batch is cut there and shipped)."""
        nbytes = sum(a.nbytes for a in _leaves(ds.coupling))
        data = ds.coupling.map(torch.from_numpy)
        return data.to(self.device) if nbytes <= self.config.epoch_hbm_budget_mb << 20 else data

    def _batches(self, data, idx: np.ndarray):
        """The batches of rows `idx` (n_b, B) of a resident unit, on the
        device; the index matrix goes to the unit's device in one copy."""
        rows = torch.from_numpy(idx).long().to(next(_leaves(data)).device)
        for i in range(len(idx)):
            yield data[rows[i]].to(self.device)

    def _val_sets(self, val_units, bs: int):
        """Per val unit: (resident data, fixed row order with the tail
        batch padded, rows per batch as the weights of the mean)."""
        sets = []
        for u in val_units:
            n = len(u)
            weights = [min(bs, n - i * bs) for i in range(num_batches(n, bs, drop_last=False))]
            idx = self._epoch_perm(n, bs, shuffle=False, seed=0, epoch=0, pad_last=True)
            sets.append((self._resident(u), idx, weights))
        return sets

    def _validate(self, module: nn.Module, val_sets, epoch: int) -> Dict[str, float]:
        gen = torch.Generator(device=self.device).manual_seed(_seed(self.config.seed, epoch, 1))
        accum, weights = [], []
        for data, idx, w in val_sets:
            accum.append(self._fetch_metrics([self._eval_step(module, b, gen)
                                              for b in self._batches(data, idx)]))
            weights.append(w)
        if len(accum) == 1:
            return _mean_stacked(accum[0], prefix="val_", weights=weights[0])
        return _combine_stacked(accum, [sum(w) for w in weights], prefix="val_",
                                inner_weights=weights)

    def evaluate(self, val_ds: ArrayDataset, module: nn.Module, epoch: int) -> Dict[str, float]:
        """The validation metrics `fit` logs at `epoch`, of `module`."""
        cfg = self.config
        units, bs = None, cfg.batch_size
        if cfg.packed_training:
            units = self._pack_units(val_ds)
            bs = self._packed_row_bs if units is not None else bs
        elif cfg.bucketed_training:
            buckets = self._bucketize(val_ds)
            units = None if buckets is None else [b for _, b, _ in buckets]
        return self._validate(module, self._val_sets(units or [val_ds], bs), epoch)

    def _experiment_dir(self) -> str:
        cfg = self.config
        return cfg.experiment_dir if cfg.experiment_id else os.path.join(cfg.dir, "scratch")

    # ----------------------------------------------------------------- fit

    def fit(self, train_ds: ArrayDataset, val_ds: ArrayDataset,
            resume: Optional[str] = None) -> TrainState:
        cfg = self.config
        train_units, val_units, bs, bucket_widths = self._units(train_ds, val_ds)
        # the schedule's steps per epoch: the units' batches, or for buckets
        # (as in the JAX trainer) those of the whole set at the batch size
        spe = max(sum(num_batches(len(u), bs) for u in train_units)
                  if bucket_widths is None else num_batches(len(train_ds), bs), 1)
        state = self.init_state(spe)

        exp_dir = self._experiment_dir()
        ckpt = CheckpointManager(os.path.join(exp_dir, "checkpoints"), top_k=cfg.save_top_k,
                                 physics_margin=cfg.physics_eval_margin)
        logger = MetricsLogger(exp_dir)

        start_epoch = 0
        if resume and ckpt.has(resume):
            start_epoch = self._from_ckpt(state, ckpt.load(resume, map_location=self.device))
            log.info(f"resumed from {resume!r} at epoch {start_epoch}")
        elif cfg.ckpt_path:
            start_epoch = self._from_ckpt(
                state, CheckpointManager.load_path(cfg.ckpt_path, map_location=self.device))
            log.info(f"warm-started from {cfg.ckpt_path} at epoch {start_epoch}")

        train_data = [self._resident(u) for u in train_units]
        val_sets = self._val_sets(val_units, bs)

        for epoch in range(start_epoch, cfg.max_epochs):
            t0 = time.time()
            gen = torch.Generator(device=self.device).manual_seed(_seed(cfg.seed, epoch, 0))
            order = [0]
            if len(train_units) > 1:  # a random unit order per epoch, no fixed curriculum
                rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, epoch, 77]))
                order = rng.permutation(len(train_units))
            accum, weights = [], []
            state.module.train()
            for ui in order:
                if bucket_widths is not None and len(train_units[ui]) < bs:
                    # only when the whole dataset is smaller than a batch:
                    # buckets merge upward to the batch size
                    log.warn(f"bucket width {bucket_widths[ui]}: {len(train_units[ui])} jets "
                             f"< batch_size {bs}; skipped")
                    continue
                idx = self._epoch_perm(len(train_units[ui]), bs, shuffle=True, seed=cfg.seed,
                                       epoch=epoch)
                if len(idx):
                    accum.append(self._fetch_metrics([self._train_step(state, b, gen)
                                                      for b in self._batches(train_data[ui],
                                                                             idx)]))
                    weights.append(len(idx))
            state.module.eval()
            train_metrics = _combine_stacked(accum, weights, prefix="train_")

            val_metrics = self._validate(state.ema if state.ema is not None else state.module,
                                         val_sets, epoch)

            # the periodic physics eval: the validation losses rank sample
            # quality badly, W1 of generated jets against the val set does not
            did_physics = False
            if cfg.physics_eval_every_n_epochs > 0 and (
                    (epoch + 1) % cfg.physics_eval_every_n_epochs == 0
                    or epoch == cfg.max_epochs - 1):
                val_metrics.update(self._run_physics_eval(state, val_ds, epoch))
                did_physics = "val_w1_physics" in val_metrics

            epoch_metrics = {**train_metrics, **val_metrics, "epoch": epoch,
                             "lr": self.lr_schedule(state.step),
                             "epoch_time_s": time.time() - t0}
            logger.log(state.step, epoch_metrics)
            if ((epoch + 1) % cfg.checkpoint_every_n_epochs == 0 or epoch == cfg.max_epochs - 1
                    or did_physics):
                ckpt.save(self._to_ckpt(state, epoch + 1), val_metrics, epoch + 1)
            log.info(f"epoch {epoch}: train_loss={train_metrics.get('train_loss', math.nan):.4f} "
                     f"val_loss={val_metrics.get('val_loss', math.nan):.4f} "
                     f"({epoch_metrics['epoch_time_s']:.1f}s)")

        logger.close()
        return state

    # -------------------------------------------------------- physics eval

    def _run_physics_eval(self, state: TrainState, val_ds: ArrayDataset,
                          epoch: int) -> Dict[str, float]:
        """Sample with the current (EMA) weights and score W1 against the
        validation set (`train/physics_eval.py`).  The reference
        observables and masks are computed once per fit and cached."""
        from multimodal_flows_tpu_torch.train import physics_eval

        cfg = self.config
        target = val_ds.coupling.target
        if target.mask is None:
            return {}
        n = min(cfg.physics_eval_num_jets, len(target))
        if self._physics_ref is None:
            self._physics_ref = (physics_eval.reference_observables(target, cfg.metadata, n),
                                 np.asarray(target.mask)[:n])
        ref_obs, masks = self._physics_ref
        module = state.ema if state.ema is not None else state.module
        t0 = time.time()
        try:
            # common random numbers: one fixed generation seed for every
            # eval of the run, so successive scores differ only through the
            # weights and the shared sampling noise cancels in the ranking;
            # reseeding per eval lets the argmin pick a noise dip
            out = physics_eval.physics_metrics(
                self.system, module, ref_obs, masks,
                num_timesteps=cfg.physics_eval_num_timesteps, metadata=cfg.metadata,
                batch_size=cfg.batch_size, seed=cfg.seed + 104729, pack_width=cfg.pack_width)
        except Exception as e:  # a metric never kills a long run
            log.warn(f"physics eval failed at epoch {epoch}: {e!r}")
            return {}
        if "val_w1_physics" in out:
            log.info(f"physics eval: w1={out['val_w1_physics']:.4f} "
                     + " ".join(f"{k.removeprefix('val_w1_')}={v:.3f}"
                                for k, v in out.items() if k != "val_w1_physics")
                     + f" ({time.time() - t0:.1f}s)")
        return out

    # ----------------------------------------------------------- inference

    def load_for_inference(self, name: str = "best", use_ema: Optional[bool] = None):
        """The state dict of checkpoint slot `name` to predict with: the EMA
        weights when enabled, else the trained ones."""
        restored = CheckpointManager(os.path.join(self._experiment_dir(), "checkpoints")).load(
            name, map_location=self.device)
        want_ema = self.config.use_ema_weights if use_ema is None else use_ema
        if want_ema and "ema_params" in restored:
            return restored["ema_params"]
        return restored["params"]

    # -------------------------------------------------------- ckpt mapping

    @staticmethod
    def _to_ckpt(state: TrainState, epoch: int = 0) -> dict:
        d = {"params": state.module.state_dict(), "opt_state": state.optimizer.state_dict(),
             "step": state.step, "epoch": epoch}
        if state.ema is not None:
            d["ema_params"] = state.ema.state_dict()
        return d

    @staticmethod
    def _from_ckpt(state: TrainState, restored: dict) -> int:
        """Restore `state` in place; returns the checkpoint's epoch."""
        state.module.load_state_dict(restored["params"])
        state.optimizer.load_state_dict(restored["opt_state"])
        if state.ema is not None and "ema_params" in restored:
            state.ema.load_state_dict(restored["ema_params"])
        state.step = int(restored["step"])
        return int(restored["epoch"])


def _leaves(x):
    """The arrays of a (nested) dataclass of arrays."""
    if dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name))
    elif x is not None:
        yield x


def _combine_stacked(accum, weights, prefix: str = "", inner_weights=None) -> Dict[str, float]:
    """Weighted mean across several per-unit metric stacks; `inner_weights`
    optionally weights within each stack."""
    if not accum:
        return {}
    per = [_mean_stacked(m, prefix=prefix,
                         weights=None if inner_weights is None else inner_weights[i])
           for i, m in enumerate(accum)]
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    return {k: float(sum(p[k] * wi for p, wi in zip(per, w))) for k in per[0]}


def _mean_stacked(metrics_seq, prefix: str = "", weights=None) -> Dict[str, float]:
    """Mean over a metric stack {name: (n_batches,)}."""
    ws = None if weights is None else np.asarray(weights, np.float64)
    out = {}
    for k, v in metrics_seq.items():
        v = np.asarray(v, np.float64)
        out[prefix + k] = float(v.mean() if ws is None else (v * ws).sum() / ws.sum())
    return out


def _mean_metrics(accum, prefix: str = "", weights=None) -> Dict[str, float]:
    """Weighted mean of a list of metric dicts."""
    if not accum:
        return {}
    w = np.ones(len(accum)) if weights is None else np.asarray(weights, np.float64)
    w = w / w.sum()
    return {prefix + k: float((np.asarray([float(m[k]) for m in accum]) * w).sum())
            for k in accum[0]}
