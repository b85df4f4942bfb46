"""The training loop, on one device or over a mesh of processes (PyTorch
port of `multimodal_flows_tpu/train/trainer.py`).

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

Meshes (`parallel/`): `Trainer(system, config, mesh="auto")` trains over
`make_mesh_2d(tensor_parallel)` when `tensor_parallel > 1`, over
`make_mesh()` when a process group exists (`torchrun`), and on the one
device otherwise; `config.mesh_shape` is stored and has no effect, as in
the JAX package.  The module takes one of three layouts in `init_state`,
the EMA copy the same one:
- data parallel (the default on a mesh): the module is replicated and
  `_update` all-reduces the gradients in one flattened collective;
- FSDP (`fsdp`): `fully_shard` per residual block and at the root, the
  gradients reduce-scattered by FSDP2;
- tensor parallel (`tensor_parallel > 1`): Megatron layers over the model
  axis, the gradients all-reduced over the data axis when it has more
  than one rank.
Every rank holds each global batch (one shuffle from the shared seed),
draws the bridge states at its shape and runs the forward on its share
of the rows (`process_batch_slice`), with the loss normalised over the
global batch (`train/systems.py`), so a step equals the one-device step
on the whole batch.  The per-step metrics are averaged over the data axis
in one collective at the end of a unit's epoch.  Checkpoints hold the
full tensors whatever the layout (`parallel.tensor_parallel`); rank 0
writes them and the metric files.

On CUDA, on one device or on each rank of a data-parallel mesh over NCCL,
a step is captured (`_graph_step`): loss, backward, clip, Adam and EMA as
one CUDA graph for each key (the module, the batch's field names, shapes
and dtypes, the device; bucketed training has one a width, all in one
memory pool) and replayed after.  On a mesh the gradients' all-reduce
splits the step into two graphs, and a replay launches the collective
between them from the host, on the replay's stream: NCCL's teardown of a
communicator waits for every graph that holds one of its collectives, so
a process group destroyed while the trainer's graphs live would hang.
The step's draws are made before it from the caller's generator
(`loss_draws`, the eager route's draws in its order, at the global batch's
shape on a mesh) and copied with the batch into the key's static inputs,
Adam's rate is written into its 0-d device tensor, and the step's scalars
are copied out of the graph's outputs.  A key's first step runs eagerly
on the stream the capture uses, its second is captured and replayed once,
and no step runs twice.  Every rank holds the global batch, so every rank
captures at the same step and makes the same collectives in the same
order.  The CPU, gloo, FSDP and tensor-parallel meshes (whose hooks and
DTensors are not captured), dropout (whose masks the forward draws) and a
loss without `loss_draws` take the eager route, the same code op by op.  On CUDA without a mesh or
on a data mesh Adam is fused and capturable on both routes: its step
counts and its rate live on the card, so an update reads nothing back to
the host.  The counters `train_graph.captures`, `train_graph.replays` and
`train_graph.eager_steps` say which route each step took.

A step is the span `train.step` (`utils/profiling.py`): `train.loss`,
`train.backward`, `train.update` (`train.clip`, `train.adam`, `train.ema`);
`fit` adds `train.batch`, `train.fetch`, `train.validate`,
`train.physics_eval` and `train.checkpoint`.  A replayed step is the
`train.step` span alone: its phases ran at the capture.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import itertools
import math
import os
import time
from typing import Callable, Dict, List, Optional

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
from multimodal_flows_tpu_torch.parallel import tensor_parallel as tpar
from multimodal_flows_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    data_axis_size,
    data_group,
    data_rows,
    initialized,
    make_mesh,
    make_mesh_2d,
)
from multimodal_flows_tpu_torch.train.checkpoints import CheckpointManager
from multimodal_flows_tpu_torch.train.ema import ema_update
from multimodal_flows_tpu_torch.train.lr_schedules import warmup_cosine_epoch_schedule
from multimodal_flows_tpu_torch.utils.logger import MetricsLogger, SimpleLogger as log
from multimodal_flows_tpu_torch.utils.profiling import (
    add_counts, captured_counts, count, declare, span, spanned,
)

# Adam as optax.adam builds it: eps outside the square root, no weight decay
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8

declare("train_graph", "captures", "replays", "eager_steps")


@dataclasses.dataclass
class TrainState:
    module: nn.Module                 # the system's trained module
    optimizer: torch.optim.Optimizer
    ema: Optional[nn.Module]          # an EMA copy of `module`, None when EMA is off
    step: int                         # optimizer updates so far
    # the captured steps of this state by `_graph_key`; they hold its tensors
    graphs: Dict[tuple, "_StepGraph"] = dataclasses.field(default_factory=dict, repr=False)


def _seed(*parts: int) -> int:
    return int(np.random.SeedSequence(list(parts)).generate_state(1)[0])


class Trainer:
    """Trains `system` on its own device, over `mesh` when there is one
    ("auto": see the module docstring; None: one device)."""

    def __init__(self, system, config: Config, mesh="auto"):
        if config.fsdp and config.tensor_parallel > 1:
            raise ValueError("fsdp and tensor_parallel are mutually exclusive")
        if isinstance(mesh, str) and mesh == "auto":
            device_type = system.device.type
            if config.tensor_parallel > 1:
                mesh = make_mesh_2d(config.tensor_parallel, device_type)
            else:
                mesh = make_mesh(device_type) if initialized() else None
        self.mesh = mesh
        self.system = system
        self.config = config
        self.device = system.device
        self._packed_row_bs = None  # rows per step in packed training (_pack_units)
        self._physics_ref = None    # (reference observables, masks) of the physics eval
        self._graph_pool = None     # the memory pool every captured step shares
        self._capture = None        # the `_StepGraph` being captured

    # ------------------------------------------------------------ building

    def make_optimizer(self, steps_per_epoch: int) -> torch.optim.Optimizer:
        """Adam over every parameter of the system's module (the multitask
        loss's included); `_update` clips first and sets the rate.  On one
        CUDA device or a data mesh of them Adam is capturable, its rate a
        0-d tensor on the card (`_set_rate`), and fused: one kernel updates
        every parameter, with the bias corrections in double as on the host
        (the capturable foreach Adam takes them in fp32, 1 - 0.999 off by
        1.3e-5, and adds two kernels a parameter).  FSDP's and tensor
        parallelism's sharded parameters keep the plain Adam."""
        cfg = self.config
        self.lr_schedule = warmup_cosine_epoch_schedule(
            cfg.lr, cfg.lr_final, cfg.warmup_epochs, cfg.max_epochs, steps_per_epoch)
        params, lr = self.system.module.parameters(), self.lr_schedule(0)
        if self.device.type == "cuda" and (self.mesh is None or self._data_mesh()):
            return torch.optim.Adam(params, lr=torch.full((), lr, device=self.device),
                                    betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=0.0,
                                    capturable=True, fused=True)
        return torch.optim.Adam(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS, weight_decay=0.0)

    def init_state(self, steps_per_epoch: int) -> TrainState:
        """The system's module in the mesh's layout (sharded in place), its
        EMA copy in the same layout, and Adam over its parameters."""
        module = self.system.module
        ema = (copy.deepcopy(module).requires_grad_(False)
               if self.config.use_ema_weights else None)
        if self.mesh is not None and not self._data_mesh():
            shard = tpar.tp_sharding if self.config.tensor_parallel > 1 else tpar.fsdp_sharding
            for m in (module, ema):
                if m is not None:
                    shard(m, self.mesh)
        return TrainState(module, self.make_optimizer(steps_per_epoch), ema, 0)

    # --------------------------------------------------------------- steps

    def _apply_gradients(self, state: TrainState, loss: torch.Tensor,
                         metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Backward, then optax's `clip_by_global_norm` (scale by max/norm
        only when norm >= max), Adam at schedule(step) (optax evaluates the
        schedule before counting the update), EMA."""
        state.optimizer.zero_grad(set_to_none=True)
        with span("train.backward"):
            loss.backward()
        out = {k: v.detach() for k, v in metrics.items()}
        out["grad_norm"] = self._update(state)
        return out

    @spanned("train.update")
    def _update(self, state: TrainState) -> torch.Tensor:
        """One update from the gradients in `.grad`; returns their global
        norm before clipping."""
        cfg = self.config
        params = list(state.module.parameters())
        with span("train.clip"):
            for p in params:  # optax updates a parameter the loss does not reach too
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = [p.grad for p in params]
            self._average_gradients(grads)
            grad_norm = tpar.grad_norm(params, grads)
            torch._foreach_mul_(tpar.local_tensors(grads),
                                torch.clamp(cfg.gradient_clip_val / grad_norm, max=1.0))
        with span("train.adam"):
            # a replay's rate is written before it (`_graph_step`)
            if not (self.device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
                self._set_rate(state)
            state.optimizer.step()
        if state.ema is not None:
            with span("train.ema"):
                ema_update(state.ema.parameters(), params, cfg.ema_decay)
        state.step += 1
        return grad_norm.detach()

    def _set_rate(self, state: TrainState) -> None:
        """Adam's rate for the update at `state.step`: a fill of its 0-d
        device tensor (no sync; what a replay reads), or a float."""
        rate = self.lr_schedule(state.step)
        for group in state.optimizer.param_groups:
            if torch.is_tensor(group["lr"]):
                group["lr"].fill_(rate)
            else:
                group["lr"] = rate

    @torch.no_grad()
    def _average_gradients(self, grads: List[torch.Tensor]) -> None:
        """Data parallelism of replicated (or tensor-parallel) parameters:
        the gradients' mean over the data axis, in one all-reduce of their
        concatenation.  FSDP reduces its own, and a tensor-parallel mesh
        with one data rank has nothing to do; a data-parallel mesh of one
        rank runs the collective all the same, so that a process group of
        one takes the path of many."""
        n_data = data_axis_size(self.mesh)
        if (self.mesh is None or self.config.fsdp
                or (n_data == 1 and self.config.tensor_parallel > 1)):
            return
        with span("train.allreduce"):
            flat = torch._utils._flatten_dense_tensors(grads)
            reduce = functools.partial(torch.distributed.all_reduce, flat,
                                       group=self.mesh.get_group(DATA_AXIS))
            if self._capture is None:
                reduce()
            else:  # kept out of the graphs, between two of them (module docstring)
                self._capture.cut(reduce)
            flat /= n_data
            torch._foreach_copy_(grads, torch._utils._unflatten_dense_tensors(flat, grads))

    @spanned("train.step")
    def _train_step(self, state: TrainState, batch, generator: torch.Generator):
        """One step on `batch` with the draws from `generator`: captured and
        replayed where `_graphable`, else run eagerly.  Returns the step's
        metrics (its loss terms and `grad_norm`), tensors of its own."""
        if self._graphable(state):
            return self._graph_step(state, batch, generator)
        count("train_graph.eager_steps")
        return self._eager_step(state, batch, generator)

    def _eager_step(self, state: TrainState, batch, generator: torch.Generator):
        """The step op by op: the system's loss (its draws from
        `generator`), then `_apply_gradients`."""
        with span("train.loss"):
            loss, metrics = self.system.loss_fn(batch, generator, train=True,
                                                module=state.module,
                                                rows=data_rows(len(batch), self.mesh))
        return self._apply_gradients(state, loss, metrics)

    def _data_mesh(self) -> bool:
        """A data-parallel mesh: the module replicated, its gradients
        all-reduced by `_average_gradients` (neither FSDP nor tensor
        parallelism)."""
        return self.mesh is not None and not self.config.fsdp and self.config.tensor_parallel == 1

    def _graphable(self, state: TrainState) -> bool:
        """A step is captured on CUDA with a capturable Adam, on one device
        or on a data mesh over NCCL (whose all-reduce runs between two
        graphs), when the loss's draws come apart from it (`loss_draws`)
        and no dropout mask is drawn inside the forward, outside another
        capture.  FSDP's hooks, tensor parallelism's DTensors and gloo's
        collectives are not captured."""
        return (self.device.type == "cuda"
                and (self.mesh is None or (self._data_mesh() and torch.distributed.get_backend(
                    self.mesh.get_group(DATA_AXIS)) == "nccl"))
                and hasattr(self.system, "loss_draws") and self.system.dropout_rate == 0
                and all(g["capturable"] for g in state.optimizer.param_groups)
                and not torch.cuda.is_current_stream_capturing())

    def _step_of_draws(self, state: TrainState, batch, draws: Dict[str, torch.Tensor]):
        """The step at the draws `draws` (made at the global batch's shape),
        on this rank's rows: what a graph captures."""
        with span("train.loss"):
            loss, metrics = self.system.loss_from_draws(batch, draws, train=True,
                                                        module=state.module,
                                                        rows=data_rows(len(batch), self.mesh))
        return self._apply_gradients(state, loss, metrics)

    def _graph_step(self, state: TrainState, batch, generator: torch.Generator):
        """A step on the captured route (module docstring).  The draws are
        made here, eagerly, whatever the step does with them."""
        draws = self.system.loss_draws(batch, generator)
        key = _graph_key(state.module, batch, self.device)
        step = state.graphs.get(key)
        if step is None:
            step = state.graphs[key] = _StepGraph(batch, draws, self.device)
            count("train_graph.eager_steps")
            return step.run_eagerly(lambda: self._step_of_draws(state, step.batch, step.draws))
        step.feed(batch, draws)
        self._set_rate(state)
        if not step.graphs:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            # the backward allocates the gradients in the graph's pool
            state.optimizer.zero_grad(set_to_none=True)
            # the capture runs `_update` once on the host, which counts this step
            self._capture = step
            try:
                step.capture(lambda: self._step_of_draws(state, step.batch, step.draws),
                             self._graph_pool, state.module)
            finally:
                self._capture = None
            count("train_graph.captures")
        else:
            state.step += 1
        return step.replay()

    @torch.no_grad()
    def _eval_step(self, module: nn.Module, batch, generator: torch.Generator):
        return self.system.loss_fn(batch, generator, train=False, module=module,
                                   rows=data_rows(len(batch), self.mesh))[1]

    @spanned("train.fetch")
    def _fetch_metrics(self, metrics_seq: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
        """{name: (n_batches,)} of a unit's epoch, averaged over the data
        axis in one collective, in one device -> host copy.  Each rank's
        loss is its share of the global weighted mean scaled by the axis
        size, so the plain mean over ranks is the global value."""
        names = sorted(metrics_seq[0])
        stacked = torch.stack([torch.stack([m[k].to(torch.float32) for m in metrics_seq])
                               for k in names])
        group = data_group(self.mesh)
        if group is not None:
            torch.distributed.all_reduce(stacked, group=group)
            stacked /= data_axis_size(self.mesh)
        stacked = stacked.cpu().numpy()
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
            n_data = data_axis_size(self.mesh)  # rows shard over the data axis
            row_bs = max((row_bs // n_data) * n_data, n_data)
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
            with span("train.batch"):
                batch = data[rows[i]].to(self.device)
            yield batch

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
        n_data = data_axis_size(self.mesh)
        if cfg.batch_size % n_data:
            raise ValueError(f"batch_size {cfg.batch_size} must be divisible by the "
                             f"{n_data}-device data axis")
        train_units, val_units, bs, bucket_widths = self._units(train_ds, val_ds)
        # the schedule's steps per epoch: the units' batches, or for buckets
        # (as in the JAX trainer) those of the whole set at the batch size
        spe = max(sum(num_batches(len(u), bs) for u in train_units)
                  if bucket_widths is None else num_batches(len(train_ds), bs), 1)
        state = self.init_state(spe)

        exp_dir = self._experiment_dir()
        ckpt = CheckpointManager(os.path.join(exp_dir, "checkpoints"), top_k=cfg.save_top_k,
                                 physics_margin=cfg.physics_eval_margin)
        logger = MetricsLogger(
            exp_dir,
            wandb_project=cfg.project if cfg.use_wandb else None,
            wandb_name=cfg.experiment_id,
            wandb_config=cfg.to_dict() if cfg.use_wandb else None)

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

            with span("train.validate"):
                val_metrics = self._validate(
                    state.ema if state.ema is not None else state.module, val_sets, epoch)

            # the periodic physics eval: the validation losses rank sample
            # quality badly, W1 of generated jets against the val set does not
            did_physics = False
            if cfg.physics_eval_every_n_epochs > 0 and (
                    (epoch + 1) % cfg.physics_eval_every_n_epochs == 0
                    or epoch == cfg.max_epochs - 1):
                with span("train.physics_eval"):
                    val_metrics.update(self._run_physics_eval(state, val_ds, epoch))
                did_physics = "val_w1_physics" in val_metrics

            epoch_metrics = {**train_metrics, **val_metrics, "epoch": epoch,
                             "lr": self.lr_schedule(state.step),
                             "epoch_time_s": time.time() - t0}
            logger.log(state.step, epoch_metrics)
            if ((epoch + 1) % cfg.checkpoint_every_n_epochs == 0 or epoch == cfg.max_epochs - 1
                    or did_physics):
                with span("train.checkpoint"):
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
                batch_size=cfg.batch_size, seed=cfg.seed + 104729, pack_width=cfg.pack_width,
                mesh=self.mesh)
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
        """The single-device checkpoint of `state` in any layout: sharded
        tensors are gathered (a collective: every rank calls it)."""
        d = {"params": tpar.full_state_dict(state.module),
             "opt_state": tpar.full_optimizer_state_dict(state.module, state.optimizer),
             "step": state.step, "epoch": epoch}
        if state.ema is not None:
            d["ema_params"] = tpar.full_state_dict(state.ema)
        return d

    @staticmethod
    def _from_ckpt(state: TrainState, restored: dict) -> int:
        """Restore `state` in place from a single-device checkpoint, each
        tensor cut to this rank's share; returns the checkpoint's epoch.
        The optimizer keeps its own form whatever device wrote the
        checkpoint (a fused, capturable Adam with its rate on the card, or
        floats), and the captured steps, which hold the replaced tensors,
        go."""
        tpar.load_full_state_dict(state.module, restored["params"])
        saved = restored["opt_state"]
        groups = [dict(s, **{k: g[k] for k in ("lr", "capturable", "fused", "foreach")})
                  for s, g in zip(saved["param_groups"], state.optimizer.param_groups)]
        tpar.load_full_optimizer_state_dict(state.module, state.optimizer,
                                            dict(saved, param_groups=groups))
        if state.ema is not None and "ema_params" in restored:
            tpar.load_full_state_dict(state.ema, restored["ema_params"])
        state.step = int(restored["step"])
        state.graphs.clear()
        return int(restored["epoch"])


def _named_leaves(x, prefix: str = ""):
    """(dotted field name, array) of each array of a (nested) dataclass of
    arrays."""
    if dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _named_leaves(getattr(x, f.name), prefix + "." + f.name)
    elif x is not None:
        yield prefix, x


def _leaves(x):
    """The arrays of a (nested) dataclass of arrays."""
    return (a for _, a in _named_leaves(x))


def _graph_key(module: nn.Module, batch, device: torch.device) -> tuple:
    """What a captured step bakes in: the module (by identity), the
    batch's type and each field's name, shape and dtype, and the device."""
    return (id(module), type(batch).__name__, device,
            tuple((name, tuple(a.shape), a.dtype) for name, a in _named_leaves(batch)))


class _StepGraph:
    """One key's captured step: static copies of the batch and the draws
    (the first step's own), the side stream of the first step and the
    capture, the graphs and the host calls a replay makes between them
    (`cut`), the outputs, what the capture counted, and the gradient
    tensors it writes."""

    def __init__(self, batch, draws: Dict[str, torch.Tensor], device: torch.device):
        self.batch = batch.map(torch.clone)
        self.draws = draws
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.graphs: List[torch.cuda.CUDAGraph] = []
        self.between: List[Callable] = []
        self.pool = None
        self.outputs: Dict[str, torch.Tensor] = {}
        self.counts: Dict[str, int] = {}
        self.params: List[torch.Tensor] = []
        self.grads: List[torch.Tensor] = []

    def run_eagerly(self, step: Callable):
        """The first step, eagerly on the stream the capture will use (the
        kernels' attributes and cuBLAS's workspace are set up there)."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = step()
        current.wait_stream(self.stream)
        return out

    def feed(self, batch, draws: Dict[str, torch.Tensor]) -> None:
        """This step's batch and draws into the static inputs."""
        torch._foreach_copy_(list(_leaves(self.batch)), list(_leaves(batch)))
        if draws:
            torch._foreach_copy_(list(self.draws.values()), list(draws.values()))

    def capture(self, step: Callable, pool, module: nn.Module) -> None:
        """Capture `step` (which runs nothing) on the side stream, in
        `pool`, into one graph and one more after each `cut`, as
        `torch.cuda.graph` captures; what it counted waits for the
        replays."""
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        self.pool = pool
        with captured_counts() as self.counts, torch.cuda.stream(self.stream):
            self._begin()
            try:
                self.outputs = step()
            finally:
                self.graphs[-1].capture_end()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        self.params = list(module.parameters())
        self.grads = [p.grad for p in self.params]

    def _begin(self) -> None:
        self.graphs.append(torch.cuda.CUDAGraph())
        self.graphs[-1].capture_begin(self.pool)

    def cut(self, call: Callable) -> None:
        """End the graph being captured here: a replay makes `call` on the
        host after it, then runs the next graph, whose capture begins."""
        self.graphs[-1].capture_end()
        self.between.append(call)
        self._begin()

    def replay(self) -> Dict[str, torch.Tensor]:
        """Run the graphs, with the calls between them, on the current
        stream; the parameters' `.grad` are its gradients again (another
        key's step may have moved them), and the step's scalars come back
        in one copy that no replay overwrites."""
        for graph, call in itertools.zip_longest(self.graphs, self.between):
            graph.replay()
            if call is not None:
                call()
        add_counts(self.counts)
        count("train_graph.replays")
        if self.params[0].grad is not self.grads[0]:
            for p, g in zip(self.params, self.grads):
                p.grad = g
        values = torch.stack(list(self.outputs.values()))
        return dict(zip(self.outputs, values.unbind()))


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
