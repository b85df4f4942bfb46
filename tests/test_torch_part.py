"""CFM over the Particle Transformer (`models/part.py`) against the
benchmark's plain reference (`bench_torch/reference/part.py`) on seeded
random weights, at a small size on the CPU: the published structure
(embedding, pair embedding at its published widths, NormFormer blocks)
with narrower token widths and two blocks, jets of 2-20 particles packed
into rows of 24 or padded one a row.  The forward of every jet, a 4-step
`generate_packed` Euler sample from the noise the program drew at each
jet's slot, the pair observables by hand, the channel re-layout of the
head scales, the span and counters, and two packed training steps."""

import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.datasets import ArrayDataset
from multimodal_flows_tpu_torch.data.packing import build_packed_rows, pack_jets
from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
from multimodal_flows_tpu_torch.models import part
from multimodal_flows_tpu_torch.sampling.generator import generate_packed
from multimodal_flows_tpu_torch.train.systems import build_system
from multimodal_flows_tpu_torch.train.trainer import Trainer
from multimodal_flows_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench_torch.drivers.packed_flow_sampling import Driver  # noqa: E402
from bench_torch.reference import part as ref  # noqa: E402
from bench_torch.reference.common import Ops  # noqa: E402

torch.set_num_threads(2)

PUBLISHED = json.loads((ROOT / "bench_torch" / "configs" / "cfm-part.json").read_text())
CFG = dict(model="ParticleTransformer", n_embd=32, n_inner=48, n_layer=2, n_head=4,
           dim_continuous=3, vocab_size=9, max_num_particles=20, qk_layernorm=False, bias=True,
           time_eps=1e-5, sigma=1e-5, pair_embed_dims=PUBLISHED["pair_embed_dims"],
           metadata=PUBLISHED["metadata"], input_stats=PUBLISHED["input_stats"],
           pair_stats=PUBLISHED["pair_stats"])
W = 24
#: the forward's tolerance (drift of order one): the two sum the same fp32
#: products in other orders (packed rows of 24 against one jet a row, the
#: BatchNorm as one fused op against its four steps), about 1e-7 a product
#: over some hundred terms
FORWARD_TOL = 5e-6
#: the sample's: 4 Euler steps carry the forward's rounding, x of order one
SAMPLE_TOL = 2e-5


def _config(**kw):
    return Config(**{k: v for k, v in {**CFG, **kw}.items()
                     if k in Config.__dataclass_fields__})


def _system(seed=7):
    params = ref.draw_weights(CFG, seed, torch.device("cpu"))
    system = build_system(_config(), "CFM", device="cpu",
                          generator=torch.Generator().manual_seed(0))
    system.module.load_state_dict(params, strict=True)
    return system, params


def _jets(n=14, seed=3):
    mult = np.random.default_rng(seed).integers(2, 21, size=n)
    masks = (np.arange(CFG["max_num_particles"])[None, :] < mult[:, None]).astype(np.int64)
    return mult, masks[..., None]


def _kinematics(mult, masks, seed=5):
    """Standardized kinematics of real particles, as the sampler's states are."""
    return torch.randn(len(mult), CFG["max_num_particles"], 3,
                       generator=torch.Generator().manual_seed(seed)) * torch.as_tensor(masks)


def _reference(params, x, masks, time):
    return ref.forward(Ops(), params, CFG, x, torch.as_tensor(masks[..., 0] > 0),
                       torch.full((len(x),), time))


def _packed_gap(system, params, time=0.37):
    """The widest gap of any real particle's drift, port (packed rows)
    against reference (one jet a row)."""
    mult, masks = _jets()
    row_of, offset_of, n_rows = pack_jets(mult, W)
    row_mask, row_seg = build_packed_rows(masks, row_of, offset_of, n_rows, W)
    x = _kinematics(mult, masks)
    rows = torch.zeros(n_rows, W, 3)
    for j, m in enumerate(mult):
        rows[row_of[j], offset_of[j]:offset_of[j] + m] = x[j, :m]
    with torch.no_grad():
        v = system.module(MultiModal(time=torch.full((n_rows,), time), continuous=rows,
                                     mask=torch.as_tensor(row_mask, dtype=torch.int32)),
                          torch.as_tensor(row_seg))
        v_ref = _reference(params, x, masks, time)
    return max(float((v[row_of[j], offset_of[j]:offset_of[j] + m] - v_ref[j, :m]).abs().max())
               for j, m in enumerate(mult))


def test_head_scales_are_drawn_away_from_one():
    _, params = _system()
    c = params["block_0.c_attn"]
    assert float(c.std()) > 0.05 and 0.2 < float(c.min()) and float(c.max()) < 1.8


@pytest.mark.parametrize("time", [1e-5, 0.37, 0.99])
def test_packed_forward_of_every_jet_equals_the_reference(time):
    system, params = _system()
    assert _packed_gap(system, params, time) < FORWARD_TOL


def test_padded_forward_equals_the_reference():
    """One jet a row, the pads folded into the pair bias as the key mask."""
    system, params = _system()
    mult, masks = _jets(seed=4)
    x = _kinematics(mult, masks, seed=6)
    with torch.no_grad():
        v = system.module(MultiModal(time=torch.full((len(mult),), 0.5), continuous=x,
                                     mask=torch.as_tensor(masks, dtype=torch.int32)))
        v_ref = _reference(params, x, masks, 0.5)
    real = torch.as_tensor(masks[..., 0] > 0)
    assert float((v - v_ref).abs()[real].max()) < FORWARD_TOL


def _pair_row(kin):
    """The port's observables of one row of destandardized (pt, eta, phi)."""
    meta = {"mean": [0.0] * 3, "std": [1.0] * 3}
    mask = torch.tensor([[1] * (len(kin) - 1) + [0]], dtype=torch.int32)[..., None]
    state = MultiModal(continuous=torch.tensor([kin], dtype=torch.float32), mask=mask)
    return part.pair_observables(state, meta["mean"], meta["std"])[0].double()


def test_pair_observables_equal_a_hand_computation():
    """Three particles and a pad slot: a pair across the phi seam, a
    self-pair and a pair with the pad, against the formulas in float64."""
    kin = [[30.0, 0.1, 3.1], [12.0, -0.2, -3.0], [5.0, 0.05, 0.4], [7.0, 0.3, 0.2]]
    got = _pair_row(kin)
    eps = 1e-8

    def by_hand(a, b):
        (pa, ea, fa), (pb, eb, fb) = a, b
        de = ea - eb
        dp = (fa - fb + math.pi) % (2 * math.pi) - math.pi
        delta = math.hypot(de, dp)
        ptmin = min(pa, pb)
        m2 = 2 * pa * pb * (math.cosh(de) - math.cos(dp))
        return [math.log(max(ptmin * delta, eps)), math.log(max(ptmin / max(pa + pb, eps), eps)),
                math.log(max(delta, eps)), math.log(max(m2, eps))]

    pad = [0.0, 0.0, 0.0]
    for i, j, a, b in ((0, 1, kin[0], kin[1]), (2, 2, kin[2], kin[2]), (0, 3, kin[0], pad),
                       (3, 3, pad, pad)):
        want = torch.tensor(by_hand(a, b), dtype=torch.float64)
        assert torch.allclose(got[i, j], want, rtol=2e-6, atol=2e-6), (i, j, got[i, j], want)
    # the seam: phi 3.1 and -3.0 are 0.183 apart, not 6.1
    assert math.exp(float(got[0, 1, 2])) == pytest.approx(math.hypot(0.3, 2 * math.pi - 6.1),
                                                          rel=1e-5)
    # a self-pair has no separation and no mass: kT, delta and m^2 at the floor
    assert torch.allclose(got[2, 2, [0, 2, 3]], torch.full((3,), math.log(eps),
                                                           dtype=torch.float64))
    # symmetric in (i, j) to rounding (the phi wrap rounds each order its own way)
    assert torch.allclose(got, got.transpose(0, 1), rtol=1e-6, atol=1e-6)


def _scaled_without_relayout(self, x, bias, key_mask, segments):
    """The head scales applied in the attention's own (H, hs) layout."""
    B, T, E = x.shape
    H = self.n_head
    a = self.attn(self.pre_attn_norm(x), bias, key_mask, segments)
    a = (a.view(B, T, H, E // H) * self.c_attn[:, None]).reshape(B, T, E)
    x = self.post_attn_norm(a) + x
    f = self.fc2(self.post_fc_norm(torch.nn.functional.gelu(self.fc1(self.pre_fc_norm(x)))))
    return f + self.w_resid * x


def test_the_comparison_fails_without_the_channel_relayout(monkeypatch):
    system, params = _system()
    monkeypatch.setattr(part._Block, "forward", _scaled_without_relayout)
    assert _packed_gap(system, params) > 100 * FORWARD_TOL


def test_the_comparison_fails_with_the_pair_bias_dropped(monkeypatch):
    system, params = _system()
    monkeypatch.setattr(part.ParticleTransformer, "_pair_bias",
                        lambda self, state: torch.zeros((), device=state.continuous.device))
    assert _packed_gap(system, params) > 100 * FORWARD_TOL


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


def test_the_sampler_packs_every_encoder_that_says_it_can():
    """`generate_packed` reads the encoder's `packable`, through the MMF
    model's `encoder` too; an encoder that does not say so is bucketed."""
    from multimodal_flows_tpu_torch.models.registry import MODEL_REGISTRY
    from multimodal_flows_tpu_torch.sampling.generator import _packable

    said = {n for n, cls in MODEL_REGISTRY.items() if getattr(cls, "packable", False)}
    assert said == {"ParticleFormer", "FusedParticleFormer", "FlavorFormer", "KinFormer",
                    "EPiC", "ParticleTransformer"}
    for name, cls in MODEL_REGISTRY.items():
        assert _packable(SimpleNamespace(module=cls)) == (name in said)
        assert _packable(SimpleNamespace(module=SimpleNamespace(encoder=cls))) == (name in said)


@pytest.fixture
def spans():
    profiling.take_spans()
    profiling.take_counters()
    profiling.record_spans(True)
    yield profiling.take_spans
    profiling.record_spans(False)
    profiling.take_spans()


def test_the_pair_embedding_spans_one_forward_nested_in_each_solver_step(spans):
    system, _ = _system()
    mult, masks = _jets(n=30, seed=2)
    steps = 3
    generate_packed(system, masks, num_timesteps=steps, pack_width=W, batch_size=8, seed=0)
    got = spans()
    solver_steps = [s for s in got if s.name == "solver.step"]
    pair = [s for s in got if s.name == "part.pair_embed"]
    assert len(solver_steps) >= steps and len(pair) == len(solver_steps)
    assert {s.parent for s in pair} == {"solver.step"}
    assert profiling.take_counters()["part.forwards"] == len(pair)


@pytest.mark.parametrize("B,T", [(3, 12), (1, 7)])
def test_part_pairs_count_every_slot_pair_of_a_forward(spans, B, T):
    system, _ = _system()
    state = MultiModal(time=torch.full((B,), 0.5), continuous=torch.randn(B, T, 3),
                       mask=torch.ones(B, T, 1, dtype=torch.int32))
    profiling.take_counters()
    with torch.no_grad():
        system.module(state, torch.zeros(B, T, dtype=torch.int32))
        system.module(state, torch.zeros(B, T, dtype=torch.int32))
    got = profiling.take_counters()
    assert (got["part.pairs"], got["part.forwards"]) == (2 * B * T * T, 2)
    assert [s.name for s in spans()] == ["part.pair_embed"] * 2


def test_the_pair_embedding_keeps_nothing_with_tracing_off():
    profiling.take_spans()
    profiling.take_counters()
    system, _ = _system()
    state = MultiModal(time=torch.full((2,), 0.5), continuous=torch.randn(2, 9, 3),
                       mask=torch.ones(2, 9, 1, dtype=torch.int32))
    with torch.no_grad():
        system.module(state)
    assert profiling.take_spans() == []
    got = profiling.take_counters()
    assert (got["part.pairs"], got["part.forwards"]) == (0, 0)


def test_the_configuration_holds_the_ports_published_widths():
    assert tuple(PUBLISHED["pair_embed_dims"]) == part.PAIR_EMBED_DIMS
    assert (PUBLISHED["n_embd"], PUBLISHED["n_inner"], PUBLISHED["n_layer"],
            PUBLISHED["n_head"]) == (128, 512, 8, 8)
    module = build_system(Config(**{k: v for k, v in PUBLISHED.items()
                                    if k in Config.__dataclass_fields__}),
                          "CFM", device="cpu").module
    assert sum(p.numel() for p in module.parameters()) == 1_808_431
    # every BatchNorm's statistics are buffers, never trained
    assert not any(n.endswith(("running_mean", "running_var"))
                   for n, _ in module.named_parameters())


@pytest.mark.parametrize("field,value", [("compute_dtype", "bfloat16"), ("dropout", 0.1),
                                         ("use_pos_emb", True)])
def test_what_the_encoder_does_not_support_raises(field, value):
    with pytest.raises(ValueError, match=field):
        build_system(_config(**{field: value}), "CFM", device="cpu")


def test_two_packed_training_steps_through_the_trainer():
    """Two packed CFM steps on one batch of rows: a finite loss that the
    first update moves, gradients on the head scales and no change to the
    BatchNorm statistics."""
    rng = np.random.default_rng(0)
    mult = rng.integers(2, 21, size=64)
    masks = (np.arange(CFG["max_num_particles"])[None, :] < mult[:, None]).astype(np.int64)
    x = rng.normal(size=(64, CFG["max_num_particles"], 3)).astype(np.float32) * masks[..., None]
    cfg = _config(packed_training=True, pack_width=W, batch_size=32, lr=1e-3)
    system = build_system(cfg, "CFM", device="cpu", generator=torch.Generator().manual_seed(0))
    system.module.load_state_dict(ref.draw_weights(CFG, 3, torch.device("cpu")), strict=True)
    stats = {n: b.clone() for n, b in system.module.named_buffers()}
    c_attn = system.module.block_0.c_attn.detach().clone()
    trainer = Trainer(system, cfg, mesh=None)
    target = MultiModal(continuous=x, mask=masks[..., None])
    units = trainer._pack_units(ArrayDataset(DataCoupling(source=MultiModal(mask=masks[..., None]),
                                                          target=target)))
    data = trainer._resident(units[0])
    idx = trainer._epoch_perm(len(units[0]), trainer._packed_row_bs, shuffle=False, seed=0,
                              epoch=0)
    batch = next(iter(trainer._batches(data, idx)))
    state = trainer.init_state(len(idx))
    gen = torch.Generator().manual_seed(1)
    losses = [float(trainer._train_step(state, batch, gen)["loss"]) for _ in range(2)]
    assert all(math.isfinite(v) for v in losses) and losses[0] != losses[1]
    assert not torch.equal(system.module.block_0.c_attn.detach(), c_attn)
    for n, b in system.module.named_buffers():
        assert torch.equal(b, stats[n]), n
