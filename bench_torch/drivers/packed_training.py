"""Packed training of a flow system (the flagship MMF): a resident set of
synthetic jets packed into rows, `Trainer._train_step` over `fit`'s order.

Traffic parameters: `num_jets` (the resident set), `multiplicity` (mean,
min, max), `jets_per_step`, `pack_width`, `lr`, `gradient_clip_val`,
`use_ema_weights`, `trace_seconds`.

The check's reference repeats the packed loss of the program's first steps
jet by jet: its own packing of the same jets finds each jet's row, slot
and offset, and its generator, seeded as the program's, repeats the
loss's draws in the program's order (per-jet times (B, J); the kinematic
source, the token source, the interpolant's noise and the bridge's token
draw, all at the rows' shape).
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
        from multimodal_flows_tpu_torch.data.datasets import ArrayDataset
        from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
        from multimodal_flows_tpu_torch.train.systems import build_system

        run, t = self.run, self.run.traffic
        D = run.cfg["max_num_particles"]
        r = jets.rng(run.seed, 10)
        mult = jets.multiplicities(r, t["num_jets"], t["multiplicity"])
        self.x, self.k, self.mask = jets.physical_jets(r, mult, D)
        self.mult = mult
        cfg = run.config(packed_training=True, pack_width=t["pack_width"],
                         batch_size=t["jets_per_step"], lr=t["lr"],
                         gradient_clip_val=t["gradient_clip_val"],
                         use_ema_weights=t["use_ema_weights"])
        system = build_system(cfg, run.cfg["system"], device=run.device,
                              generator=torch.Generator().manual_seed(0))
        target = MultiModal(continuous=self.x, discrete=self.k, mask=self.mask)
        return system, cfg, ArrayDataset(DataCoupling(source=MultiModal(mask=self.mask),
                                                      target=target))

    def split(self, ds):
        """The trainer's packed units and row batch, and each row's jets,
        tokens and same-jet pairs."""
        units = self.trainer._pack_units(ds)
        self._row_work = []
        for u in units:
            seg = np.asarray(u.coupling.segments)
            m = np.stack([(seg == j).sum(axis=1) for j in range(seg.max() + 1)], axis=1)
            self._row_work.append((np.asarray(u.coupling.jet_valid).sum(axis=1),
                                   m.sum(axis=1), (m * m).sum(axis=1)))
        return units, self.trainer._packed_row_bs

    def row_work(self, ui: int, rows) -> Dict:
        n_jets, tokens, pairs = (int(a[rows].sum()) for a in self._row_work[ui])
        return {"jets": n_jets,
                "record": work_record(1, tokens, pairs, extra_bytes=4 * tokens)}

    # ------------------------------------------------------------------ check

    def _layout(self):
        """The reference's packing of the jets: each jet's row, offset and
        slot, the rows a step, the slots a row, and the first steps' rows."""
        if not hasattr(self, "_lay"):
            t = self.run.traffic
            W = t["pack_width"]
            row_of, offset_of, n_rows = packing.pack_jets(self.mult, W)
            if (row_of < 0).any():
                raise ValueError("the reference packs jets of at most pack_width particles")
            slot = packing.segment_slots(row_of, offset_of)
            bs = packing.training_row_batch(len(self.mult), n_rows, t["jets_per_step"])
            total = packing.padded_rows(n_rows, bs)
            perm = packing.epoch_perm(total, bs, self.perm_seed, 0)
            self._lay = dict(row_of=row_of, offset_of=offset_of, slot=slot, bs=bs,
                             n_slots=int(slot.max()) + 1, perm=perm, W=W)
        return self._lay

    def reference_loss(self, ops, params, step: int) -> torch.Tensor:
        run, cfg, lay = self.run, self.run.cfg, self._layout()
        pf = run.reference
        dev, W, V = run.device, lay["W"], cfg["vocab_size"]
        eps, sigma, beta = cfg["time_eps"], cfg["sigma"], cfg["beta"]
        rows = lay["perm"][step]
        B, J = len(rows), lay["n_slots"]
        where = {int(r): i for i, r in enumerate(rows)}
        sel = np.array([j for j in range(len(self.mult)) if int(lay["row_of"][j]) in where])
        b_of = np.array([where[int(lay["row_of"][j])] for j in sel])

        # the program's draws, in its order, at its shapes
        if step == 0:
            self._gen = torch.Generator(device=dev).manual_seed(self.epoch_seed(0))
        gen = self._gen
        u_t = torch.rand((B, J), generator=gen, device=dev)
        z_x0 = torch.randn((B, W, cfg["dim_continuous"]), generator=gen, device=dev)
        z_k0 = torch.randint(1, V, (B, W, 1), generator=gen, dtype=torch.int32, device=dev)
        z_xt = torch.randn((B, W, cfg["dim_continuous"]), generator=gen, device=dev)
        u_kt = torch.rand((B, W), generator=gen, device=dev)

        m = self.mult[sel]
        Dm = int(m.max())
        pos = np.arange(Dm)
        real = pos[None, :] < m[:, None]
        col = np.minimum(lay["offset_of"][sel][:, None] + pos[None, :], W - 1)
        bi = torch.as_tensor(np.repeat(b_of[:, None], Dm, 1), device=dev)
        ci = torch.as_tensor(col, device=dev)
        mask = torch.as_tensor(real, device=dev)
        fm = mask[..., None].float()
        t = eps + (1.0 - eps) * u_t[torch.as_tensor(b_of, device=dev),
                                   torch.as_tensor(lay["slot"][sel], device=dev)]
        x1 = torch.as_tensor(self.x[sel, :Dm], device=dev)
        k1 = torch.as_tensor(self.k[sel, :Dm, 0], device=dev).long()
        x0 = z_x0[bi, ci] * fm
        k0 = z_k0[bi, ci][..., 0].long() * mask
        tb = t[:, None, None]
        xt = tb * x1 + (1.0 - tb) * x0 + sigma * z_xt[bi, ci]

        # the telegraph bridge's posterior P(k_t | k0, k1), drawn by one
        # uniform a site through its CDF
        S = V
        grid = torch.arange(S, device=dev)
        w_t1 = torch.exp(-S * beta * (1.0 - t))[:, None, None]
        w_0t = torch.exp(-S * beta * t)[:, None, None]
        w_01 = torch.exp(torch.tensor(-S * beta, device=dev))
        p_k_k1 = 1.0 / S + w_t1 * ((k1[..., None] == grid).float() - 1.0 / S)
        p_k0_k = 1.0 / S + w_0t * ((grid == k0[..., None]).float() - 1.0 / S)
        p_k0_k1 = 1.0 / S + w_01 * ((k0 == k1).float()[..., None] - 1.0 / S)
        cdf = (p_k_k1 * p_k0_k / p_k0_k1).cumsum(dim=-1)
        u = u_kt[bi, ci][..., None] * cdf[..., -1:]
        kt = (cdf <= u).sum(dim=-1).clamp(max=S - 1)

        vt, logits = pf.forward(ops, params, cfg, xt, kt, mask, t)
        n = fm[..., 0].sum(dim=1)
        mse = (((vt - (x1 - x0)) ** 2) * fm).sum(dim=(1, 2)) / n
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, k1[..., None])[..., 0]
        ce = (nll * fm[..., 0] * (k1 != 0)).sum(dim=1) / n
        return pf.multitask_loss(ops, params, cfg, mse, ce, t).mean()
