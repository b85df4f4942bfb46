"""Training of the GPT baseline on token sequences (BOS, the jet's flavor
tokens in pT order, EOS, PAD) of a resident set of synthetic jets, in
batches of sequences, `Trainer._train_step` over `fit`'s order.

Traffic parameters: `num_jets`, `multiplicity` (mean, min, max),
`jets_per_step`, `lr`, `gradient_clip_val`, `use_ema_weights`,
`trace_seconds`.  The loss draws nothing (no dropout), so the check's
reference needs only the rows of the program's first steps.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bench_torch import jets
from bench_torch.drivers.common import TrainDriver, work_record
from bench_torch.reference import packing


class Driver(TrainDriver):

    def build(self):
        from multimodal_flows_tpu_torch.data.datasets import ArrayDataset, jet_set_to_seq
        from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
        from multimodal_flows_tpu_torch.train.systems import build_system

        run, t = self.run, self.run.traffic
        D = run.cfg["max_num_particles"]
        r = jets.rng(run.seed, 10)
        self.mult = jets.multiplicities(r, t["num_jets"], t["multiplicity"])
        x, self.k, mask = jets.physical_jets(r, self.mult, D)
        cfg = run.config(batch_size=t["jets_per_step"], lr=t["lr"],
                         gradient_clip_val=t["gradient_clip_val"],
                         use_ema_weights=t["use_ema_weights"])
        system = build_system(cfg, run.cfg["system"], device=run.device,
                              generator=torch.Generator().manual_seed(0))
        seqs = jet_set_to_seq(MultiModal(continuous=x, discrete=self.k, mask=mask),
                              cfg.vocab_size)
        return system, cfg, ArrayDataset(DataCoupling(target=seqs))

    def split(self, ds):
        """One unit, batches of sequences; each sequence's real tokens (BOS,
        the particles, EOS) and their causal pairs."""
        n = self.mult + 2
        self._row_work = (np.ones_like(n), n, n * (n + 1) // 2)
        return [ds], self.train_cfg.batch_size

    def row_work(self, ui: int, rows) -> Dict:
        n_jets, tokens, pairs = (int(a[rows].sum()) for a in self._row_work)
        return {"jets": n_jets, "record": work_record(1, tokens, pairs)}

    def reference_loss(self, ops, params, step: int) -> torch.Tensor:
        run, cfg, gpt = self.run, self.run.cfg, self.run.reference
        rows = packing.epoch_perm(len(self.mult), self.rows_per_step, self.perm_seed, 0)[step]
        ids = torch.as_tensor(gpt.jet_set_to_seq(self.k[rows, :, 0], cfg["vocab_size"]),
                              device=run.device)
        logits = gpt.forward(ops, params, cfg, ids)
        targets = ids[:, 1:]
        nll = -torch.log_softmax(logits[:, :-1], dim=-1).gather(-1, targets[..., None])[..., 0]
        w = (targets != gpt.special_tokens(cfg)[2]).float()
        return (nll * w).sum() / w.sum()
