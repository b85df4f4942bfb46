"""Autoregressive sampling of the GPT baseline: `GPT.generate` from BOS
through the KV-cached decode, one batch after another (a closed loop), each
call ending when the program returns its token sequences to the host.

Traffic parameters: `batch`, `temperature`, `trace_seconds`.  The program's
`sample_jets` is this call followed by a host-side strip of the special
tokens; the check needs the sequences with their special tokens, so the
window calls `generate` and copies its result to the host.

The check: the reference's full causal forward over every sequence of
every call of the window (no cache), teacher-forced on the served tokens, and the Gumbel noise of
the call repeated from a generator seeded as the program's was (one draw of
(seq_len - 1, batch, vocab + 4)).  Each served token is the argmax of the
logits over the temperature plus that noise; the number compared is the
widest gap by which a served token's perturbed logit lies below the
reference's best.  A token after EOS must be PAD and the first BOS: the
count of tokens that break this is compared exactly.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from bench_torch import jets
from bench_torch.drivers.common import synchronize, work_record
from bench_torch.reference.common import Ops


#: the cache position past which the notes count the sequences compared
#: (K2's decode form reads a third 64-key tile from position 129)
LATE = 128


class Driver:

    def __init__(self, run):
        self.run, self.t, self.gpt = run, run.traffic, run.reference
        self.attempted = self.failed = 0
        self.calls: List[Dict] = []

    def call_seed(self, i: int) -> int:
        return jets.sub_seed(self.run.seed, 21, i)

    def _generate(self, i: int) -> torch.Tensor:
        gen = torch.Generator(device=self.run.device).manual_seed(self.call_seed(i))
        return self.system.generate(self.t["batch"], gen, temperature=self.t["temperature"],
                                    top_k=None).cpu()

    def setup(self) -> None:
        from multimodal_flows_tpu_torch.train.systems import build_system

        run = self.run
        self.system = build_system(run.config(), run.cfg["system"], device=run.device,
                                   generator=torch.Generator().manual_seed(0))
        self.system.module.load_state_dict(run.params, strict=True)
        self._generate(jets.WARM)
        synchronize(run.device)

    def window(self, seconds: float) -> None:
        self.calls = []
        self.attempted = self.failed = 0
        start = time.perf_counter()
        i = 0
        while True:
            t0 = time.perf_counter()
            tokens = self._generate(i)
            self.calls.append({"i": i, "tokens": tokens, "wall": time.perf_counter() - t0})
            self.attempted += 1
            i += 1
            if time.perf_counter() - start >= seconds:
                break

    def metrics(self) -> Dict[str, float]:
        return {"sampled_jets_per_s": sum(len(c["tokens"]) for c in self.calls)
                / sum(c["wall"] for c in self.calls)}

    def _eos_at(self, tokens: torch.Tensor) -> np.ndarray:
        """The first EOS position of each sequence (seq_len - 1 without one)."""
        eos = (tokens == self.gpt.special_tokens(self.run.cfg)[1]).numpy()
        return np.where(eos.any(axis=1), eos.argmax(axis=1), tokens.shape[1] - 1)

    def traced_work(self) -> List[Dict]:
        """A decode step t reads position t of every sequence whose EOS is
        not before it, against its t + 1 cached positions."""
        Tc = self.gpt.seq_len(self.run.cfg)
        out = []
        for c in self.calls:
            eos = self._eos_at(c["tokens"])
            for t in range(Tc - 1):
                q = int((eos >= t).sum())
                out.append(work_record(1, q, q * (t + 1), kv_tokens=q * (t + 1),
                                       extra_bytes=4 * q * Tc))
        return out

    def traced_steps(self) -> int:
        return len(self.calls) * (self.gpt.seq_len(self.run.cfg) - 1)

    def release(self) -> None:
        self.system = None

    # ------------------------------------------------------------------ check

    def check(self, control: bool = False) -> Dict[str, float]:
        run, cfg, gpt = self.run, self.run.cfg, self.gpt
        bos, eos, pad = gpt.special_tokens(cfg)
        T, Vf = gpt.seq_len(cfg), gpt.full_vocab(cfg)
        gap, broken, drawn_n, deepest, lengths = 0.0, 0, 0, 0, []
        for call in self.calls:
            tokens = call["tokens"].to(run.device).long()
            B = len(tokens)
            gen = torch.Generator(device=run.device).manual_seed(self.call_seed(call["i"]))
            u = torch.rand((T - 1, B, Vf), generator=gen, device=run.device)
            g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
            g = g.transpose(0, 1)                                   # (B, T - 1, V + 4)
            with torch.no_grad():
                ref = gpt.forward(Ops(False), run.params, cfg, tokens)[:, :-1]
                ref = ref / self.t["temperature"] + g
                served = tokens[:, 1:]
                if control:
                    low = gpt.forward(Ops(True), run.params, cfg, tokens)[:, :-1]
                    served = (low / self.t["temperature"] + g).argmax(dim=-1)
            # position p + 1 is served by a draw while no EOS came before it
            done = torch.cumsum(tokens[:, 1:] == eos, dim=1) - (tokens[:, 1:] == eos).long() > 0
            drawn = ~done
            best = ref.max(dim=-1).values
            got = ref.gather(-1, served[..., None])[..., 0]
            gap = max(gap, float(((best - got) * drawn).max()))
            at = drawn.sum(dim=1)
            drawn_n += int(at.sum())
            deepest = max(deepest, int(at.max()))
            lengths.append(at.cpu())
            broken += int(((tokens[:, 1:] != pad) & done).sum()) + int((tokens[:, 0] != bos).sum())
        lengths = torch.cat(lengths).double()
        self.notes = {"tokens_compared": drawn_n, "deepest_position_compared": deepest,
                      "sequences_compared": len(lengths),
                      "mean_tokens_a_sequence": float(lengths.mean()),
                      f"sequences_past_position_{LATE}": int((lengths > LATE).sum())}
        return {"logit_gap_max": gap, "rule_breaks": float(broken)}
