"""What the entry drivers share: the work records the metrics read, the
worst-leaf comparison of the training checks, and the training loop.

A driver has `setup()`, `window(seconds)`, `metrics()` (the end-to-end
values of its window), `traced_work()` / `traced_steps()` (the work of the
window, for the per-layer readers), `release()` (frees the program's state
before the reference runs) and `check(control)` ({name: number} compared
with the limits), and counts `attempted` and `failed`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench_torch import jets
from bench_torch.reference.common import Ops, adam_steps

Tensor = torch.Tensor
#: steps of the training check: the reference follows the first three
CHECK_STEPS = 3


def work_record(count: int, tokens: int, pairs: int, kv_tokens: Optional[int] = None,
                extra_bytes: int = 0) -> Dict:
    """`count` forwards, each over `tokens` real tokens with `pairs` real
    (query, key) pairs an attention layer; `kv_tokens` keys read (the
    queries themselves unless a cache is read), `extra_bytes` of mask,
    segment ids or bias an attention call."""
    return {"count": int(count), "tokens": int(tokens), "pairs": int(pairs),
            "kv_tokens": int(tokens if kv_tokens is None else kv_tokens),
            "extra_bytes": int(extra_bytes)}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def worst_leaf(prog: Dict[str, Tensor], ref: Dict[str, Tensor],
               rows: Optional[Dict[str, Tensor]] = None) -> float:
    """The largest |‖prog_l‖ - ‖ref_l‖| over the leaves l (their rows
    `rows[l]` where given), each against the larger of ‖ref_l‖ and the
    median leaf's ‖ref‖."""
    if rows is not None:
        prog = {n: prog[n][r] for n, r in rows.items()}
        ref = {n: ref[n][r] for n, r in rows.items()}
    ref_n = {n: float(t.double().norm()) for n, t in ref.items()}
    med = float(np.median(list(ref_n.values())))
    return max(abs(float(prog[n].double().norm()) - v) / max(v, med, 1e-30)
               for n, v in ref_n.items())


def moved_rows(grads: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The rows (first index) of each leaf whose reference gradient is above
    a thousandth of the median row's, for the leaves that keep any: the
    others (a key's bias under softmax, a slice of a fused qkv bias) move
    under Adam by round-off alone."""
    norms = {n: g.double().reshape(len(g), -1).norm(dim=1) if g.dim() else g.double().abs()[None]
             for n, g in grads.items()}
    med = float(torch.cat(list(norms.values())).median())
    keep = {n: v > 1e-3 * med for n, v in norms.items()}
    return {n: k for n, k in keep.items() if bool(k.any())}


class TrainDriver:
    """The training window: `Trainer._train_step` over `fit`'s batch order
    (`_epoch_perm`, `_batches` of the `_resident` units), epoch after epoch,
    the unit's metrics fetched once an epoch as `fit` does.  Set-up runs the
    first CHECK_STEPS steps through the same call and keeps the state the
    check compares: each step's loss, the first clipped gradient (from
    Adam's first moment after one step) and the parameters' change over
    the CHECK_STEPS steps.  Subclasses build the system and the data set
    (`build`), cut the set into the trainer's units (`split`), give each
    unit's work by row (`row_work`) and the reference's loss of a step
    (`reference_loss`)."""

    def __init__(self, run):
        self.run = run
        self.attempted = self.failed = 0
        self.window_steps: List[tuple] = []
        self.wall = None
        self.gaps_ms: List[float] = []

    # ----------------------------------------------------------------- set-up

    def setup(self) -> None:
        from multimodal_flows_tpu_torch.data.datasets import num_batches
        from multimodal_flows_tpu_torch.train.trainer import Trainer

        run = self.run
        self.system, self.train_cfg, ds = self.build()
        self.system.module.load_state_dict(run.params, strict=True)
        self.trainer = Trainer(self.system, self.train_cfg, mesh=None)
        self.units, self.rows_per_step = self.split(ds)
        self.data = [self.trainer._resident(u) for u in self.units]
        spe = sum(num_batches(len(u), self.rows_per_step) for u in self.units)
        self.state = self.trainer.init_state(spe)
        self.perm_seed = jets.sub_seed(run.seed, 2)
        self._stream = self._batches()
        self._pending: List[Dict[str, Tensor]] = []
        if run.trace:
            self._name_phases()

        module, opt = self.state.module, self.state.optimizer
        p0 = {n: p.detach().clone() for n, p in module.named_parameters()}
        losses = []
        for i in range(CHECK_STEPS):
            out, _ = self._step()
            losses.append(out["loss"].detach().clone())
            if i == 0:
                beta1 = opt.param_groups[0]["betas"][0]
                # a step that left the optimizer's state alone reads as a zero gradient
                g1 = {n: opt.state[p].get("exp_avg", torch.zeros_like(p)).detach().clone()
                      / (1.0 - beta1) for n, p in module.named_parameters()}
        self.first = {"losses": [float(v) for v in losses], "grad": g1,
                      "delta": {n: p.detach() - p0[n] for n, p in module.named_parameters()}}
        synchronize(run.device)

    def _name_phases(self) -> None:
        """The trace's forward and optimizer ranges, around the system's
        loss and the trainer's update (the calls `_train_step` makes)."""
        from bench_torch.trace import phase

        loss_fn, update = self.system.loss_fn, self.trainer._update

        def named_loss(*a, **kw):
            with phase("bench.train_forward"):
                return loss_fn(*a, **kw)

        def named_update(*a, **kw):
            with phase("bench.train_optimizer"):
                return update(*a, **kw)

        self.system.loss_fn, self.trainer._update = named_loss, named_update

    def epoch_seed(self, epoch: int) -> int:
        return jets.sub_seed(self.run.seed, 3, epoch)

    def _batches(self):
        """(unit, rows, batch, generator, last of the unit's epoch) for ever."""
        device = self.run.device
        epoch = 0
        while True:
            gen = torch.Generator(device=device).manual_seed(self.epoch_seed(epoch))
            for ui, data in enumerate(self.data):
                idx = self.trainer._epoch_perm(len(self.units[ui]), self.rows_per_step,
                                               shuffle=True, seed=self.perm_seed, epoch=epoch)
                for i, b in enumerate(self.trainer._batches(data, idx)):
                    yield ui, idx[i], b, gen, i == len(idx) - 1
            epoch += 1

    def _step(self):
        ui, rows, batch, gen, last = next(self._stream)
        out = self.trainer._train_step(self.state, batch, gen)
        self._pending.append(out)
        self.attempted += 1
        if last:
            losses = self.trainer._fetch_metrics(self._pending)["loss"]
            self.failed += int((~np.isfinite(losses)).sum())
            self._pending = []
        return out, (ui, rows)

    # ----------------------------------------------------------------- window

    def window(self, seconds: float) -> None:
        device = self.run.device
        on_cuda = device.type == "cuda"
        events = []
        if on_cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        self.attempted = self.failed = 0
        self.window_steps = []
        t0 = time.perf_counter()
        while True:
            _, where = self._step()
            self.window_steps.append(where)
            if on_cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            if time.perf_counter() - t0 >= seconds:
                break
        synchronize(device)
        self.wall = time.perf_counter() - t0
        self.gaps_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]

    def metrics(self) -> Dict[str, float]:
        jets_done = sum(self.row_work(ui, rows)["jets"] for ui, rows in self.window_steps)
        out = {"trained_jets_per_s": jets_done / self.wall}
        if self.gaps_ms:
            out["train_step_ms_p95"] = float(np.percentile(self.gaps_ms, 95))
        return out

    def traced_work(self) -> List[Dict]:
        return [self.row_work(ui, rows)["record"] for ui, rows in self.window_steps]

    def traced_steps(self) -> int:
        return len(self.window_steps)

    def release(self) -> None:
        self._stream = None
        self.state = self.trainer = self.system = self.data = self._pending = None

    # ------------------------------------------------------------------ check

    def check(self, control: bool = False) -> Dict[str, float]:
        """The program's first CHECK_STEPS steps against the reference's (or,
        as the control, the reference at TF32 against the reference)."""
        ref = self.reference_steps(Ops(False))
        prog = self.reference_steps(Ops(True)) if control else self.first
        rows = moved_rows(ref["grad"])
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
        return {"loss_rel_gap": loss_gap,
                "grad_leaf_gap": worst_leaf(prog["grad"], ref["grad"]),
                "change_leaf_gap": worst_leaf(prog["delta"], ref["delta"], rows)}

    def reference_steps(self, ops: Ops) -> Dict:
        """Each step's loss, the first clipped gradient and the change of
        the parameters over CHECK_STEPS steps of the reference, from the
        weights of the seed, on the rows and with the draws of the
        program's first steps."""
        run = self.run
        params = {n: t.clone().requires_grad_(True) for n, t in run.params.items()}
        p0 = {n: t.detach().clone() for n, t in params.items()}
        state, losses, first = {}, [], None
        for step in range(CHECK_STEPS):
            loss = self.reference_loss(ops, params, step)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(params.items(), grads)}
            clipped = adam_steps(params, grads, state, self.train_cfg.lr,
                                 self.train_cfg.gradient_clip_val)
            losses.append(float(loss.detach()))
            if step == 0:
                first = clipped
        return {"losses": losses, "grad": first,
                "delta": {n: params[n].detach() - p0[n] for n in params}}
