"""CFM over KinFormer with its Lund-plane pair bias (`use_pairwise`, a
nonzero `lambda_u`) against the benchmark's plain reference
(`bench_torch/reference/kinformer.py`) on seeded random weights, at a
small size on the CPU: jets of 2-20 particles packed into rows of 24, the
pair MLP in chunks of 5 rows (which do not divide a row).  The forward of
every jet, and a 4-step `generate_packed` Euler sample from the noise the
program drew at each jet's slot.  The comparison fails when the port's
pair bias is dropped or left unsymmetrised."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.packing import build_packed_rows, pack_jets
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.models import particle_transformers as pt
from multimodal_flows_tpu_torch.sampling.generator import generate_packed
from multimodal_flows_tpu_torch.train.systems import build_system

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_torch.drivers.packed_flow_sampling import Driver  # noqa: E402
from bench_torch.reference import kinformer as ref  # noqa: E402
from bench_torch.reference.common import Ops  # noqa: E402

torch.set_num_threads(2)

CFG = dict(model="KinFormer", use_pairwise=True, n_embd=32, n_inner=48, n_layer=2, n_head=2,
           dim_continuous=3, vocab_size=9, max_num_particles=20, qk_layernorm=True, bias=True,
           pair_chunk=5, time_eps=1e-5, sigma=1e-5,
           metadata={"mean": [21.0, 1e-4, 2e-5], "std": [20.0, 0.15, 0.15]})
W = 24
#: the forward's tolerance (drift of order one): the two sum the same fp32
#: products in other orders (packed rows of 24 against one jet a row, the
#: pair MLP in chunks), about 1e-7 a product over some hundred terms
FORWARD_TOL = 5e-6
#: the sample's: 4 Euler steps carry the forward's rounding, x of order one
SAMPLE_TOL = 2e-5


def _system(seed=7):
    params = ref.draw_weights(CFG, seed, torch.device("cpu"))
    system = build_system(Config(**CFG), "CFM", device="cpu",
                          generator=torch.Generator().manual_seed(0))
    system.module.load_state_dict(params, strict=True)
    return system, params


def _jets(n=14, seed=3):
    mult = np.random.default_rng(seed).integers(2, 21, size=n)
    masks = (np.arange(CFG["max_num_particles"])[None, :] < mult[:, None]).astype(np.int64)
    return mult, masks[..., None]


def _forward_gap(system, params, time=0.37):
    """The widest gap of any real particle's drift, port (packed rows)
    against reference (one jet a row)."""
    mult, masks = _jets()
    row_of, offset_of, n_rows = pack_jets(mult, W)
    row_mask, row_seg = build_packed_rows(masks, row_of, offset_of, n_rows, W)
    x = torch.randn(len(mult), CFG["max_num_particles"], 3,
                    generator=torch.Generator().manual_seed(5)) * torch.as_tensor(masks)
    rows = torch.zeros(n_rows, W, 3)
    for j, m in enumerate(mult):
        rows[row_of[j], offset_of[j]:offset_of[j] + m] = x[j, :m]
    with torch.no_grad():
        v = system.module(MultiModal(time=torch.full((n_rows,), time), continuous=rows,
                                     mask=torch.as_tensor(row_mask, dtype=torch.int32)),
                          torch.as_tensor(row_seg))
        v_ref = ref.forward(Ops(), params, CFG, x, torch.as_tensor(masks[..., 0] > 0),
                            torch.full((len(mult),), time))
    return max(float((v[row_of[j], offset_of[j]:offset_of[j] + m] - v_ref[j, :m]).abs().max())
               for j, m in enumerate(mult))


def test_lambda_u_is_drawn_of_order_one():
    _, params = _system()
    assert 0.25 < float(params["lambda_u"]) < 1.75


@pytest.mark.parametrize("time", [1e-5, 0.37, 0.99])
def test_forward_of_every_jet_equals_the_reference(time):
    system, params = _system()
    assert _forward_gap(system, params, time) < FORWARD_TOL


def test_rows_not_divided_by_the_chunk_equal_one_chunk(monkeypatch):
    """pair_chunk 5 on rows of 24 and one chunk of the whole row give the
    same bias to the bit: each chunk averages both orientations."""
    system, _ = _system()
    mult, masks = _jets()
    row_of, offset_of, n_rows = pack_jets(mult, W)
    row_mask, _ = build_packed_rows(masks, row_of, offset_of, n_rows, W)
    state = MultiModal(continuous=torch.randn(n_rows, W, 3),
                       mask=torch.as_tensor(row_mask, dtype=torch.int32))
    with torch.no_grad():
        chunked = system.module._lund_bias(state)
        monkeypatch.setattr(system.module.config, "pair_chunk", 0)
        whole = system.module._lund_bias(state)
    assert torch.equal(chunked, whole)
    assert torch.equal(whole, whole.transpose(-1, -2))


_LUND_BIAS = pt.KinFormer._lund_bias


def _upper_triangle(self, state):
    """The bias of the pairs i <= j only, the others never mirrored from
    them."""
    return _LUND_BIAS(self, state).triu()


#: the pair bias dropped, or left unsymmetrised as a half-triangle pass
#: that forgot to mirror.  Dropping the 0.5 (f(U) + f(U^T)) average itself
#: is no fault that any output shows: the Lund observables are symmetric in
#: (i, j), so the average is the identity (the test above holds the bias
#: symmetric to the bit)
FAULTS = {"dropped": lambda self, state: torch.zeros((), device=state.continuous.device),
          "unsymmetrised": _upper_triangle}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_the_comparison_fails_without_the_symmetric_pair_bias(fault, monkeypatch):
    system, params = _system()
    monkeypatch.setattr(pt.KinFormer, "_lund_bias", FAULTS[fault])
    assert _forward_gap(system, params) > 100 * FORWARD_TOL


def test_generate_packed_euler_sample_equals_the_reference():
    system, params = _system()
    mult, masks = _jets(n=40, seed=11)
    steps, seed = 4, 12345
    traffic = dict(pack_width=W, rows_per_batch=8, num_timesteps=steps)
    res = generate_packed(system, masks, num_timesteps=steps, pack_width=W,
                          batch_size=traffic["rows_per_batch"], seed=seed)
    # the benchmark's copy of the program's packing and draws finds each
    # jet's kinematic source
    driver = Driver(SimpleNamespace(traffic=traffic, seed=0, cfg=CFG,
                                    device=torch.device("cpu")))
    driver.call_seed = lambda i: seed
    x0 = driver.jet_noise(0, mult)
    assert x0.abs().sum() > 0
    Dm = int(mult.max())
    mask = torch.as_tensor(np.arange(Dm)[None, :] < mult[:, None])
    x_ref = ref.euler(Ops(), params, CFG, x0[:, :Dm], mask, steps)
    gap = ((res.sample.continuous[:, :Dm] - x_ref).abs() * mask[..., None]).max()
    assert float(gap) < SAMPLE_TOL
    # pads come back zeroed
    assert not res.sample.continuous[~torch.as_tensor(masks[..., 0] > 0)].any()
