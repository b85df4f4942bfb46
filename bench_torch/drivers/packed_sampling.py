"""Sampling of a flow system through `generate_packed`, one call after
another (a closed loop: the next call is issued when the last returns its
host tensors).

Traffic parameters: `jets_per_call`, `multiplicity` (mean, min, max),
`pack_width`, `rows_per_batch` (the entry's `batch_size`), `num_timesteps`,
`temperature`, `warm_timesteps` (the set-up's call: the cell's shapes at
fewer steps), `trace_seconds`.

The check: the reference repeats the trajectories of every jet of one
call of the window (drawn from the seed) with the noise the program drew
for them
(its own packing finds each jet's row and offset; its generator, seeded as
the call was, repeats the call's draws: per batch of rows the kinematic
source, the token source and every step's uniforms), and compares the
final tokens and kinematics.  A token lands on the other side of a jump
threshold now and then under rounding alone, and the jet's trajectory
then parts from the reference's; so the share of jets whose tokens differ
is one number, and the median jet's widest kinematic gap (over the RMS of
the kinematics), among the jets whose tokens agree, the other.  The widest
gap of all, which a jet that crossed a threshold and came back sets, is
printed beside them and not compared.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from bench_torch import jets
from bench_torch.drivers.common import synchronize, work_record
from bench_torch.reference import packing
from bench_torch.reference.common import Ops


class Driver:

    def __init__(self, run):
        self.run, self.t = run, run.traffic
        self.attempted = self.failed = 0
        self.calls: List[Dict] = []

    def call_mult(self, i: int) -> np.ndarray:
        t = self.t
        return jets.multiplicities(jets.rng(self.run.seed, 20, i), t["jets_per_call"],
                                   t["multiplicity"])

    def call_seed(self, i: int) -> int:
        return jets.sub_seed(self.run.seed, 21, i)

    def _generate(self, mult, steps: int, seed: int):
        from multimodal_flows_tpu_torch.sampling.generator import generate_packed

        t = self.t
        masks = jets.pad_masks(mult, self.run.cfg["max_num_particles"])
        return generate_packed(self.system, masks, num_timesteps=steps,
                               pack_width=t["pack_width"], temperature=t["temperature"],
                               batch_size=t["rows_per_batch"], seed=seed)

    def setup(self) -> None:
        from multimodal_flows_tpu_torch.train.systems import build_system

        run = self.run
        self.system = build_system(run.config(), run.cfg["system"], device=run.device,
                                   generator=torch.Generator().manual_seed(0))
        self.system.module.load_state_dict(run.params, strict=True)
        self._generate(self.call_mult(jets.WARM), self.t["warm_timesteps"],
                       self.call_seed(jets.WARM))
        synchronize(run.device)

    def window(self, seconds: float) -> None:
        self.calls = []
        self.attempted = self.failed = 0
        start = time.perf_counter()
        i = 0
        while True:
            mult = self.call_mult(i)
            t0 = time.perf_counter()
            res = self._generate(mult, self.t["num_timesteps"], self.call_seed(i))
            wall = time.perf_counter() - t0
            sample = res.sample
            self.calls.append({"i": i, "mult": mult, "wall": wall,
                               "x": sample.continuous, "k": sample.discrete[..., 0]})
            self.attempted += 1
            self.failed += int(not torch.isfinite(sample.continuous).all())
            i += 1
            if time.perf_counter() - start >= seconds:
                break

    def metrics(self) -> Dict[str, float]:
        return {"sampled_jets_per_s": sum(len(c["mult"]) for c in self.calls)
                / sum(c["wall"] for c in self.calls)}

    def traced_work(self) -> List[Dict]:
        return [work_record(self.t["num_timesteps"], c["mult"].sum(), (c["mult"] ** 2).sum(),
                            extra_bytes=4 * c["mult"].sum()) for c in self.calls]

    def traced_steps(self) -> int:
        return len(self.calls) * self.t["num_timesteps"]

    def release(self) -> None:
        self.system = None

    # ------------------------------------------------------------------ check

    def check(self, control: bool = False) -> Dict[str, float]:
        run = self.run
        call = self.calls[int(jets.rng(run.seed, 30).integers(len(self.calls)))]
        mult = call["mult"]
        sel = np.arange(len(mult))
        x0, k0, u = self.jet_noise(call["i"], mult, sel)
        mask = torch.as_tensor(np.arange(x0.shape[1])[None, :] < mult[sel][:, None],
                               device=run.device)
        x_ref, k_ref = self.trajectory(Ops(False), x0, k0, u, mask)
        if control:
            x_prog, k_prog = self.trajectory(Ops(True), x0, k0, u, mask)
        else:
            Dm = x0.shape[1]
            x_prog = call["x"][sel, :Dm].to(run.device)
            k_prog = call["k"][sel, :Dm].to(run.device).long()
        m = mask[..., None]
        differ = ((k_prog != k_ref) & mask).any(dim=1)
        agree = ~differ
        scale = float(torch.sqrt((x_ref ** 2 * m).sum() / (m.sum() * x_ref.shape[-1])))
        gap = ((x_prog - x_ref).abs() * m).amax(dim=(1, 2))[agree] / scale
        self.notes = {"jets_differing": int(differ.sum()), "jets_checked": len(sel),
                      "kin_gap_max": float(gap.max()) if len(gap) else float("inf")}
        return {"token_differ_share": float(differ.float().mean()),
                "kin_gap_median": float(gap.median()) if len(gap) else float("inf")}

    def jet_noise(self, i: int, mult: np.ndarray, sel: np.ndarray):
        """Each selected jet's kinematic source, token source and uniforms
        (steps, N, Dm) as the program drew them for call `i`."""
        t, cfg, dev = self.t, self.run.cfg, self.run.device
        W, steps = t["pack_width"], t["num_timesteps"]
        row_of, offset_of, n_rows = packing.pack_jets(mult, W)
        if (row_of < 0).any():
            raise ValueError("the reference packs jets of at most pack_width particles")
        bs, n_batches = packing.sampling_batches(n_rows, min(t["rows_per_batch"], 128))
        seg = np.full((bs * n_batches, W), 0, np.int32)
        for j in range(len(mult)):
            seg[row_of[j], offset_of[j]:offset_of[j] + mult[j]] = 1
        masks = torch.as_tensor(seg, device=dev)[..., None]
        gen = torch.Generator(device=dev).manual_seed(self.call_seed(i))
        xs, ks, us = [], [], []
        for b in range(n_batches):
            mb = masks[b * bs:(b + 1) * bs]
            xs.append(torch.randn((bs, W, cfg["dim_continuous"]), generator=gen,
                                  device=dev) * mb)
            ks.append(torch.randint(1, cfg["vocab_size"], (bs, W, 1), generator=gen,
                                    dtype=torch.int32, device=dev) * mb)
            us.append(torch.rand((steps, bs, W), generator=gen, device=dev))
        x_all, k_all, u_all = torch.cat(xs), torch.cat(ks)[..., 0], torch.cat(us, dim=1)
        Dm = int(mult[sel].max())
        pos = np.arange(Dm)
        ri = torch.as_tensor(np.repeat(row_of[sel][:, None], Dm, 1), device=dev)
        ci = torch.as_tensor(np.minimum(offset_of[sel][:, None] + pos[None, :], W - 1),
                             device=dev)
        return x_all[ri, ci], k_all[ri, ci].long(), u_all[:, ri, ci]

    def trajectory(self, ops: Ops, x: torch.Tensor, k: torch.Tensor, u: torch.Tensor,
                   mask: torch.Tensor):
        """The hybrid sampler of the MMF system: Poisson tau-leap on the
        tokens (one uniform a site: stay below e^{-R dt}, move to class j
        in [c_{j-1}, c_j), stay past the last threshold) with the
        telegraph bridge's model-guided rates, Euler on the kinematics."""
        cfg, t = self.run.cfg, self.t
        S, beta, eps = cfg["vocab_size"], cfg["beta"], cfg["time_eps"]
        steps, dev = t["num_timesteps"], x.device
        ts = torch.linspace(eps, 1.0 - eps, steps, dtype=torch.float32, device=dev)
        dt = (ts[-1] - ts[0]) / (steps - 1)
        with torch.no_grad():
            for i in range(steps):
                time_ = ts[i].expand(len(x))
                v, logits = self.run.reference.forward(ops, self.run.params, cfg, x, k, mask,
                                                       time_)
                probs = torch.softmax(logits / t["temperature"], dim=-1)
                w = torch.exp(-S * beta * (1.0 - time_))
                bc = (w * S) / (1.0 - w)
                qy = probs.gather(-1, k[..., None])
                rdt = (1.0 + bc[:, None, None] * probs + w[:, None, None] * qy) * dt
                base = torch.exp(-rdt.sum(dim=-1, keepdim=True))
                cum = base * (1.0 + rdt.cumsum(dim=-1))
                uu = u[i][..., None]
                jumped = (uu >= base) & (uu < cum[..., -1:])
                k = torch.where(jumped[..., 0], (uu >= cum).sum(dim=-1), k)
                x = x + v * dt
        return x, k
