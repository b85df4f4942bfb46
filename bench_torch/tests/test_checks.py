"""The correctness check of every cell, on the CPU at a size a test run
holds: a sound run passes; the control (the reference at TF32 in the
program's place) and each fault the cell can have, planted in the program
underneath the timed path, come out as not correct.  The look for a card
is skipped: the run drives the program's CPU path.

    python -m pytest bench_torch/tests/test_checks.py -q
"""

import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench_torch.harness import run_cell  # noqa: E402

TINY = dict(n_embd=16, n_inner=32, n_layer=1, n_layer_fused=1, n_head=2, max_num_particles=16,
            max_seq_length=16)
MULT = {"mean": 6, "min": 2, "max": 16}
TRAFFIC = {
    "mmf-particleformer.sample": dict(jets_per_call=64, multiplicity=MULT, pack_width=16,
                                      rows_per_batch=8, num_timesteps=6),
    "mmf-particleformer.train": dict(num_jets=256, multiplicity=MULT, jets_per_step=32,
                                     pack_width=16),
    "gpt-flavorseq.sample": dict(batch=32),
    "gpt-flavorseq.train": dict(num_jets=256, multiplicity=MULT, jets_per_step=32),
}
#: the GPT decode's control needs near ties between perturbed logits,
#: which wider products, more positions and some ten thousand draws make
CONTROL_CFG = {"gpt-flavorseq.sample": dict(TINY, n_embd=128, n_inner=256, n_layer=2,
                                            max_num_particles=40, max_seq_length=40)}
CONTROL_TRAFFIC = {"gpt-flavorseq.sample": dict(batch=1024)}
SEED = 2**31 + 977


def run(cell, control=False, cfg=None, traffic=None):
    return run_cell(cell, SEED, 0.3, False, torch.device("cpu"), time.perf_counter(),
                    cfg_override=cfg or TINY, traffic_override=traffic or TRAFFIC[cell],
                    control=control)


@pytest.mark.parametrize("cell", sorted(TRAFFIC))
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(TRAFFIC))
def test_control_is_not_correct(cell):
    res = run(cell, control=True, cfg=CONTROL_CFG.get(cell), traffic=CONTROL_TRAFFIC.get(cell))
    assert not res["control_correct"], res["control_checks"]


# ---------------------------------------------------------------- faults

def _step_unchanged(monkeypatch, cell):
    if cell == "mmf-particleformer.sample":
        from multimodal_flows_tpu_torch.dynamics import solvers

        fwd = solvers.HybridSolver.fwd_step_u
        monkeypatch.setattr(solvers.HybridSolver, "fwd_step_u",
                            lambda self, u, state, dt: (state, fwd(self, u, state, dt)[1]))
    elif cell == "gpt-flavorseq.sample":
        from multimodal_flows_tpu_torch.models.gpt import FlavorSeqGPT

        decode = FlavorSeqGPT.decode

        def stale(self, token, pos, caches):   # the caches come back unwritten
            logits, _ = decode(self, token, pos, [(k.clone(), v.clone()) for k, v in caches])
            return logits, caches

        monkeypatch.setattr(FlavorSeqGPT, "decode", stale)
    else:
        from multimodal_flows_tpu_torch.train.trainer import Trainer

        update = Trainer._update

        def no_step(self, state):               # the optimizer's step left out
            step = state.optimizer.step
            state.optimizer.step = lambda: None
            try:
                return update(self, state)
            finally:
                state.optimizer.step = step

        monkeypatch.setattr(Trainer, "_update", no_step)


def _half_batch(monkeypatch, cell):
    if cell == "mmf-particleformer.sample":
        from multimodal_flows_tpu_torch.train.systems import MMF

        simulate = MMF.simulate

        def half(self, source, *a, **kw):       # the second half of the rows not sampled
            out = simulate(self, source, *a, **kw)
            n = len(source) // 2
            out.continuous[n:] = source.continuous[n:]
            out.discrete[n:] = source.discrete[n:]
            return out

        monkeypatch.setattr(MMF, "simulate", half)
    elif cell == "gpt-flavorseq.sample":
        from multimodal_flows_tpu_torch.train.gpt import GPT

        generate = GPT.generate

        def half(self, batch_size, *a, **kw):   # half the sequences left as PAD
            out = generate(self, batch_size, *a, **kw)
            out[batch_size // 2:, 1:] = self.pad_token
            return out

        monkeypatch.setattr(GPT, "generate", half)
    else:
        from multimodal_flows_tpu_torch.train.trainer import Trainer

        step = Trainer._train_step

        def half(self, state, batch, generator):  # the mean over half the rows
            return step(self, state, batch[torch.arange(len(batch) // 2)], generator)

        monkeypatch.setattr(Trainer, "_train_step", half)


def _token_altered(monkeypatch, cell):
    if cell == "mmf-particleformer.sample":
        from multimodal_flows_tpu_torch.dynamics import solvers

        tokens = solvers._poisson_tauleap_tokens

        def shifted(u, k, rates, dt, V):        # every jump lands one class over
            new = tokens(u, k, rates, dt, V)
            return torch.where(new != k, (new % (V - 1)) + 1, new)

        monkeypatch.setattr(solvers, "_poisson_tauleap_tokens", shifted)
    else:
        from multimodal_flows_tpu_torch.models.gpt import FlavorSeqGPT

        decode = FlavorSeqGPT.decode

        def nudged(self, token, pos, caches):   # one class's logit raised
            logits, caches = decode(self, token, pos, caches)
            raised = torch.nn.functional.one_hot(torch.tensor(3, device=logits.device),
                                                 logits.shape[-1])
            return logits + raised, caches

        monkeypatch.setattr(FlavorSeqGPT, "decode", nudged)


def _late_cache_lost(monkeypatch, cell):
    """The decode's cache entries from position 128 of 152 on (at a test's
    size, the same share of the sequence) are lost as they are written:
    only the steps past 128 read a wrong cache."""
    from multimodal_flows_tpu_torch.models.gpt import FlavorSeqGPT

    decode = FlavorSeqGPT.decode

    def lossy(self, token, pos, caches):
        logits, caches = decode(self, token, pos, caches)
        if pos >= self.seq_len * 128 // 152:
            for k, v in caches:
                k[:, pos] = 0.0
                v[:, pos] = 0.0
        return logits, caches

    monkeypatch.setattr(FlavorSeqGPT, "decode", lossy)


FAULTS = [(cell, fault) for cell in sorted(TRAFFIC) for fault in (_step_unchanged, _half_batch)]
FAULTS += [(c, _token_altered) for c in ("mmf-particleformer.sample", "gpt-flavorseq.sample")]
FAULTS += [("gpt-flavorseq.sample", _late_cache_lost)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    res = run(cell)
    assert not res["correct"], res["checks"]
