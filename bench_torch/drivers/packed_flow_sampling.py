"""Sampling of the CFM system through `generate_packed`, one call after
another (a closed loop, as `packed_sampling.py`): Euler on the kinematics,
no tokens.

Traffic parameters: those of `packed_sampling.py` (`jets_per_call`,
`multiplicity`, `pack_width`, `rows_per_batch`, `num_timesteps`,
`temperature`, which has no effect here, `warm_timesteps`,
`trace_seconds`).

Each call's work record also holds the program's Lund-bias counters over
the call (`lund.pairs`, `lund.forwards`: `utils/profiling.py`, kept while
tracing is on), None where the program has none.

The check: the reference (`reference/kinformer.py:euler`) repeats every
jet of one call of the window (drawn from the seed) from the kinematic
source the program drew at that jet's slot (its own packing finds each
jet's row and offset; its generator, seeded as the call was, repeats the
call's draws: per batch of rows the kinematic source, then the token
source that the CFM system leaves unused), for the call's steps, and
compares the final kinematics: each jet's widest gap over the RMS of the
reference's kinematics, of the median jet (`kin_gap_median`) and of the
jet at the 99th percentile (`kin_gap_p99`).  The ODE is not smooth: two
values normalised over a pair are +-(1, -1) by the sign of
log kT - log dR, so the pair bias steps where a pair crosses
log kT = log dR, and a trajectory that crosses at a step the reference
does not (rounding alone does it, in some jets of every call) parts from
the reference's by up to about 5e-4.  Such jets are a few in a call; the
widest gap of all (`kin_gap_all_max`) is printed beside the compared
numbers and not compared.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from bench_torch import jets
from bench_torch.drivers import packed_sampling
from bench_torch.drivers.common import work_record
from bench_torch.reference import packing
from bench_torch.reference.common import Ops

#: jets of one block of the reference's trajectory (sorted by multiplicity,
#: each block padded to its widest jet)
REFERENCE_BLOCK = 128


def lund_counters() -> Optional[Dict[str, int]]:
    """The program's Lund-bias counters, None where it has none."""
    from multimodal_flows_tpu_torch.utils import profiling

    if not hasattr(profiling, "peek_counters"):
        return None
    c = profiling.peek_counters()
    if "lund.pairs" not in c:
        return None
    return {"pairs": c["lund.pairs"], "forwards": c["lund.forwards"]}


class Driver(packed_sampling.Driver):

    def __init__(self, run):
        super().__init__(run)
        self.lund: List[Optional[Dict[str, int]]] = []

    def _generate(self, mult, steps: int, seed: int):
        before = lund_counters()
        res = super()._generate(mult, steps, seed)
        after = lund_counters()
        self.lund.append(None if before is None else {k: after[k] - before[k] for k in before})
        return res

    def window(self, seconds: float) -> None:
        self.lund = []
        super().window(seconds)

    def traced_work(self) -> List[Dict]:
        """A record a call: the call's steps over its real tokens and
        same-jet pairs, segment ids and the real pairs' bias (fp32, every
        head) read by each attention call, and the Lund counters."""
        H = self.run.cfg["n_head"]
        out = []
        for c, lund in zip(self.calls, self.lund):
            tokens, pairs = int(c["mult"].sum()), int((c["mult"] ** 2).sum())
            r = work_record(self.t["num_timesteps"], tokens, pairs,
                            extra_bytes=4 * tokens + 4 * H * pairs)
            r["lund"] = lund
            out.append(r)
        return out

    # ------------------------------------------------------------------ check

    def check(self, control: bool = False) -> Dict[str, float]:
        run = self.run
        call = self.calls[int(jets.rng(run.seed, 30).integers(len(self.calls)))]
        mult = call["mult"]
        x0 = self.jet_noise(call["i"], mult)
        order = np.argsort(mult, kind="stable")
        gaps = np.zeros(len(mult))
        sq, n = 0.0, 0
        for a in range(0, len(order), REFERENCE_BLOCK):
            sel = order[a:a + REFERENCE_BLOCK]
            Dm = int(mult[sel].max())
            mask = torch.as_tensor(np.arange(Dm)[None, :] < mult[sel][:, None], device=run.device)
            x = x0[torch.as_tensor(sel, device=run.device), :Dm]
            x_ref = self.trajectory(Ops(False), x, mask)
            x_prog = (self.trajectory(Ops(True), x, mask) if control
                      else call["x"][sel, :Dm].to(run.device))
            m = mask[..., None]
            gaps[sel] = ((x_prog - x_ref).abs() * m).amax(dim=(1, 2)).double().cpu().numpy()
            sq += float((x_ref.double() ** 2 * m).sum())
            n += int(m.sum()) * x_ref.shape[-1]
        gaps /= np.sqrt(sq / n)
        self.notes = {"jets_checked": len(mult), "kin_rms": float(np.sqrt(sq / n)),
                      "kin_gap_all_max": float(gaps.max()),
                      "jets_past_1e-5": int((gaps > 1e-5).sum())}
        return {"kin_gap_median": float(np.median(gaps)),
                "kin_gap_p99": float(np.quantile(gaps, 0.99))}

    def jet_noise(self, i: int, mult: np.ndarray) -> torch.Tensor:
        """Each jet's kinematic source (N, Dmax, Fc) as the program drew it
        for call `i`: per batch of rows the kinematic source, then the token
        source (Euler draws nothing more)."""
        t, cfg, dev = self.t, self.run.cfg, self.run.device
        W = t["pack_width"]
        row_of, offset_of, n_rows = packing.pack_jets(mult, W)
        if (row_of < 0).any():
            raise ValueError("the reference packs jets of at most pack_width particles")
        bs, n_batches = packing.sampling_batches(n_rows, min(t["rows_per_batch"], 128))
        seg = np.zeros((bs * n_batches, W), np.int32)
        for j in range(len(mult)):
            seg[row_of[j], offset_of[j]:offset_of[j] + mult[j]] = 1
        masks = torch.as_tensor(seg, device=dev)[..., None]
        gen = torch.Generator(device=dev).manual_seed(self.call_seed(i))
        xs = []
        for b in range(n_batches):
            mb = masks[b * bs:(b + 1) * bs]
            xs.append(torch.randn((bs, W, cfg["dim_continuous"]), generator=gen,
                                  device=dev) * mb)
            torch.randint(1, cfg["vocab_size"], (bs, W, 1), generator=gen, dtype=torch.int32,
                          device=dev)
        x_all = torch.cat(xs)
        Dm = int(mult.max())
        pos = np.arange(Dm)
        ri = torch.as_tensor(np.repeat(row_of[:, None], Dm, 1), device=dev)
        ci = torch.as_tensor(np.minimum(offset_of[:, None] + pos[None, :], W - 1), device=dev)
        return x_all[ri, ci] * torch.as_tensor(pos[None, :] < mult[:, None],
                                                device=dev)[..., None]

    def trajectory(self, ops: Ops, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self.run.reference.euler(ops, self.run.params, self.run.cfg, x, mask,
                                        self.t["num_timesteps"])
