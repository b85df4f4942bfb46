"""The correctness check of `cfm-part.sample`, on the CPU at a size a test
run holds: a sound run passes; the control (the reference at TF32 in the
program's place) and each fault, planted in the program underneath the
timed path, come out as not correct.  Also: the BatchNorm input
statistics stored in the configuration are what
`reference/part.py:norm_statistics` computes; and the four-card
data-parallel training cell's check (`drivers/packed_training_ddp.py`) at
world size 2 over gloo: a sound run passes, the control and a run whose
rank 0 leaves its rows out do not, and rank 0 tears the group down only
after every other rank had its stop.

    python -m pytest bench_torch/tests/test_checks_part.py -q

At the cell's own size on the card, one line a fault and seed
(`FAULT <cell> <fault> <seed> {numbers}`):

    python3 bench_torch/tests/test_checks_part.py --seconds 5 --seeds 21 22 23
"""

import argparse
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_torch.harness import run_cell  # noqa: E402

PART = "cfm-part.sample"
TINY = dict(n_embd=16, n_inner=32, n_layer=2, n_head=2, max_num_particles=16)
MULT = {"mean": 6, "min": 2, "max": 16}
TRAFFIC = dict(jets_per_call=64, multiplicity=MULT, pack_width=24, rows_per_batch=8,
               num_timesteps=6)
SEED = 2**31 + 977


def run(control=False):
    return run_cell(PART, SEED, 0.3, False, torch.device("cpu"), time.perf_counter(),
                    cfg_override=TINY, traffic_override=TRAFFIC, control=control)


def test_sound_run_is_correct():
    res = run()
    assert res["correct"], res["checks"]


def test_control_is_not_correct():
    res = run(control=True)
    assert res["correct"], res["checks"]
    assert not res["control_correct"], res["control_checks"]


def test_the_stored_input_statistics_are_recomputed():
    from bench_torch.reference import part

    cfg = json.loads((ROOT / "bench_torch" / "configs" / "cfm-part.json").read_text())
    got = part.norm_statistics(cfg)
    for key in ("input_stats", "pair_stats"):
        for stat in ("mean", "var"):
            assert got[key][stat] == pytest.approx(cfg[key][stat], rel=1e-9, abs=1e-12)


# ---------------------------------------------------------------- faults

def _bias_dropped(mp):
    from multimodal_flows_tpu_torch.models.part import ParticleTransformer

    mp.setattr(ParticleTransformer, "_pair_bias",
               lambda self, state: torch.zeros((), device=state.continuous.device))


def _block_forward(relayout=True, post_fc_norm=True):
    """`_Block.forward` with the head scales' channel re-layout or the
    post-FC LayerNorm left out."""
    import torch.nn.functional as F

    def forward(self, x, bias, key_mask, segments):
        B, T, E = x.shape
        H = self.n_head
        a = self.attn(self.pre_attn_norm(x), bias, key_mask, segments)
        a = a.view(B, T, H, E // H) * self.c_attn[:, None]
        a = (a.transpose(2, 3) if relayout else a).reshape(B, T, E)
        x = self.post_attn_norm(a) + x
        f = F.gelu(self.fc1(self.pre_fc_norm(x)))
        f = self.fc2(self.post_fc_norm(f) if post_fc_norm else f)
        return f + self.w_resid * x

    return forward


def _c_attn_unrelaid(mp):
    from multimodal_flows_tpu_torch.models import part

    mp.setattr(part._Block, "forward", _block_forward(relayout=False))


def _post_fc_norm_dropped(mp):
    from multimodal_flows_tpu_torch.models import part

    mp.setattr(part._Block, "forward", _block_forward(post_fc_norm=False))


def _lnm2_from_four_vectors(mp):
    """lnm2 in upstream's E^2 - |p|^2 form of the summed four-vectors."""
    from multimodal_flows_tpu_torch.models import part

    observables = part.pair_observables

    def upstream_m2(state, mu, sig):
        obs = observables(state, mu, sig)
        dim = state.continuous.shape[-1]
        mu = torch.as_tensor(mu, dtype=torch.float32, device=obs.device).reshape(1, 1, dim)
        sig = torch.as_tensor(sig, dtype=torch.float32, device=obs.device).reshape(1, 1, dim)
        kin = (state.continuous.float() * sig + mu) * state.mask
        pt, eta, phi = kin[..., 0], kin[..., 1], kin[..., 2]
        p4 = torch.stack([pt * torch.cos(phi), pt * torch.sin(phi), pt * torch.sinh(eta),
                          pt * torch.cosh(eta)], dim=-1)
        s = p4[:, :, None] + p4[:, None, :]
        m2 = s[..., 3] ** 2 - (s[..., :3] ** 2).sum(dim=-1)
        return torch.cat([obs[..., :3], torch.log(m2.clamp(min=part.PAIR_EPS))[..., None]], -1)

    mp.setattr(part, "pair_observables", upstream_m2)


def _step_fewer(mp):
    """The last Euler step (t = 1 - eps) left out, the grid unchanged."""
    from multimodal_flows_tpu_torch.dynamics import solvers

    step = solvers.ContinuousSolver.fwd_step_u

    def skip_last(self, dw, state, dt):
        if float(state.time.reshape(-1)[0]) > 1.0 - 1e-4:
            return state
        return step(self, dw, state, dt)

    mp.setattr(solvers.ContinuousSolver, "fwd_step_u", skip_last)


FAULTS = [_bias_dropped, _c_attn_unrelaid, _post_fc_norm_dropped, _lnm2_from_four_vectors,
          _step_fewer]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__[1:] for f in FAULTS])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = run()
    assert not res["correct"], res["checks"]


# ------------------------------------------- the data-parallel training cell

DDP = "mmf-particleformer.train-ddp4"
DDP_TINY = dict(n_embd=16, n_inner=32, n_layer=1, n_layer_fused=1, n_head=2,
                max_num_particles=16)
DDP_TRAFFIC = dict(ranks=2, num_jets=256, multiplicity=MULT, jets_per_step=64, pack_width=16,
                   warm_seconds=0.5, group_timeout_s=120)


def run_ddp(control=False):
    return run_cell(DDP, SEED, 0.3, False, torch.device("cpu"), time.perf_counter(),
                    cfg_override=DDP_TINY, traffic_override=DDP_TRAFFIC, control=control)


def test_ddp_sound_run_is_correct_and_the_control_is_not():
    res = run_ddp(control=True)
    assert res["correct"], res["checks"]
    assert not res["control_correct"], res["control_checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_ddp_rank_leaving_its_rows_out_is_not_correct(monkeypatch):
    """Rank 0 (this process) adds nothing of its rows to the loss or the
    gradient; the other rank's are intact."""
    from multimodal_flows_tpu_torch.train.trainer import Trainer

    step = Trainer._eager_step

    def rows_left_out(self, state, batch, generator):
        loss_fn = self.system.loss_fn

        def zeroed(*a, **kw):
            loss, metrics = loss_fn(*a, **kw)
            return loss * 0.0, {k: v * 0.0 for k, v in metrics.items()}

        self.system.loss_fn = zeroed
        try:
            return step(self, state, batch, generator)
        finally:
            self.system.loss_fn = loss_fn

    monkeypatch.setattr(Trainer, "_eager_step", rows_left_out)
    res = run_ddp()
    assert not res["correct"], res["checks"]


def test_ddp_release_stops_every_rank_before_rank_0_tears_down(monkeypatch):
    """NCCL's teardown returns only once every rank of the group tears
    down: here rank 0's waits for the other rank to end, which it does only
    after its stop, so rank 0 must send the stop before it tears down."""
    import multiprocessing

    destroy = torch.distributed.destroy_process_group

    def teardown_waiting_for_every_rank(*a, **kw):
        t0 = time.perf_counter()
        while multiprocessing.active_children():
            if time.perf_counter() - t0 > 30:
                raise AssertionError("rank 0 tore the group down while another rank waited")
            time.sleep(0.05)
        return destroy(*a, **kw)

    monkeypatch.setattr(torch.distributed, "destroy_process_group",
                        teardown_waiting_for_every_rank)
    res = run_ddp()
    assert res["correct"], res["checks"]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("the faults are read on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for fault in FAULTS:
        for seed in args.seeds:
            with pytest.MonkeyPatch.context() as mp:
                fault(mp)
                res = run_cell(PART, seed, args.seconds, False, torch.device("cuda", 0),
                               time.perf_counter())
            print("FAULT", PART, fault.__name__[1:], seed,
                  json.dumps({k: v["value"] for k, v in res["checks"].items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
