"""The correctness check of `cfm-kinformer-lund.sample`, on the CPU at a
size a test run holds: a sound run passes; the control (the reference at
TF32 in the program's place) and each fault, planted in the program
underneath the timed path, come out as not correct.

    python -m pytest bench_torch/tests/test_checks_pair_bias.py -q

At the cell's own size on the card, one line a fault and seed
(`FAULT <cell> <fault> <seed> {numbers}`):

    python3 bench_torch/tests/test_checks_pair_bias.py --seconds 5 --seeds 21 22 23

Dropping the 0.5 (f(U) + f(U^T)) average of the pair MLP is no fault
here: the Lund observables are symmetric in (i, j), so the average is the
identity and no output shows it.  The unsymmetrised fault is a bias left
on one triangle of the pairs, never mirrored.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench_torch.harness import run_cell  # noqa: E402

LUND = "cfm-kinformer-lund.sample"
TINY = dict(n_embd=16, n_inner=32, n_layer=2, n_layer_fused=1, n_head=2, max_num_particles=16,
            pair_chunk=5)
MULT = {"mean": 6, "min": 2, "max": 16}
TRAFFIC = dict(jets_per_call=64, multiplicity=MULT, pack_width=24, rows_per_batch=8,
               num_timesteps=6)
SEED = 2**31 + 977


def run(control=False):
    return run_cell(LUND, SEED, 0.3, False, torch.device("cpu"), time.perf_counter(),
                    cfg_override=TINY, traffic_override=TRAFFIC, control=control)


def test_sound_run_is_correct():
    res = run()
    assert res["correct"], res["checks"]


def test_control_is_not_correct():
    res = run(control=True)
    assert res["correct"], res["checks"]
    assert not res["control_correct"], res["control_checks"]


# ---------------------------------------------------------------- faults

def _bias_dropped(mp):
    from multimodal_flows_tpu_torch.models.particle_transformers import KinFormer

    mp.setattr(KinFormer, "_lund_bias",
               lambda self, state: torch.zeros((), device=state.continuous.device))


def _unsymmetrised(mp):
    from multimodal_flows_tpu_torch.models.particle_transformers import KinFormer

    bias = KinFormer._lund_bias
    mp.setattr(KinFormer, "_lund_bias", lambda self, state: bias(self, state).triu())


def _cross_jet_unmasked(mp):
    """Every jet of a packed row attends to the row's other jets."""
    from multimodal_flows_tpu_torch.models.particle_transformers import KinFormer

    forward = KinFormer.forward

    def one_segment(self, state, segments=None, num_segments=None):
        if segments is not None:
            segments = torch.where(segments >= 0, torch.zeros_like(segments), segments)
        return forward(self, state, segments, num_segments)

    mp.setattr(KinFormer, "forward", one_segment)


def _step_fewer(mp):
    """The last Euler step (t = 1 - eps) left out, the grid unchanged."""
    from multimodal_flows_tpu_torch.dynamics import solvers

    step = solvers.ContinuousSolver.fwd_step_u

    def skip_last(self, dw, state, dt):
        if float(state.time.reshape(-1)[0]) > 1.0 - 1e-4:
            return state
        return step(self, dw, state, dt)

    mp.setattr(solvers.ContinuousSolver, "fwd_step_u", skip_last)


FAULTS = [_bias_dropped, _unsymmetrised, _cross_jet_unmasked, _step_fewer]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = run()
    assert not res["correct"], res["checks"]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("the faults are read on the card", file=sys.stderr)
        return 2
    for fault in FAULTS:
        for seed in args.seeds:
            with pytest.MonkeyPatch.context() as mp:
                fault(mp)
                res = run_cell(LUND, seed, args.seconds, False, torch.device("cuda", 0),
                               time.perf_counter())
            print("FAULT", LUND, fault.__name__[1:], seed,
                  json.dumps({k: v["value"] for k, v in res["checks"].items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
