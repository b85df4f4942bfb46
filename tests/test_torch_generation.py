"""The port's generation path end to end on the CPU: the packing layout
against the JAX package's, `generate_packed` on a tiny model (packed rows
plus the bucketed tail of jets wider than a row), and the HDF5 file of
`save_generation` read back by the JAX package."""

import numpy as np
import pytest
import torch
import yaml

from multimodal_flows_tpu.data import packing as jpacking
from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data import packing
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.ops import btc_attention  # noqa: F401 (declares k1.*)
from multimodal_flows_tpu_torch.sampling.generator import (
    _rebalanced_batch,
    _snap_batch,
    generate_packed,
    save_generation,
)
from multimodal_flows_tpu_torch.train.systems import MMF
from multimodal_flows_tpu_torch.utils import profiling

torch.set_num_threads(2)

TINY = dict(model="ParticleFormer", n_embd=16, n_inner=32, n_layer=1, n_layer_fused=1,
            n_head=2, vocab_size=9, dim_continuous=3, max_num_particles=20)


def _pad_masks(mults, D):
    return (np.arange(D)[None, :] < np.asarray(mults)[:, None]).astype(np.int64)[..., None]


def test_packing_layout_identical_to_jax():
    rng = np.random.default_rng(0)
    mult = np.clip(rng.poisson(40, size=300), 0, 150)
    mult[:3] = [140, 129, 0]  # too wide for a row, and an empty jet
    pad_masks = _pad_masks(mult, 150)
    W = 128
    packed = packing.pack_jets(mult, W)
    ref = jpacking.pack_jets(mult, W)
    for a, b in zip(packed[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)
    assert packed[2] == ref[2]
    row_of, offset_of, n_rows = packed
    for a, b in zip(packing.build_packed_rows(pad_masks, row_of, offset_of, n_rows, W),
                    jpacking.build_packed_rows(pad_masks, row_of, offset_of, n_rows, W)):
        np.testing.assert_array_equal(a, b)

    x = rng.normal(size=(n_rows, W, 3)).astype(np.float32)
    k = rng.integers(0, 9, size=(n_rows, W, 1)).astype(np.int32)
    out = packing.unpack_rows(MultiModal(continuous=torch.from_numpy(x),
                                         discrete=torch.from_numpy(k)),
                              pad_masks, row_of, offset_of, W)
    ref = jpacking.unpack_rows(JaxMultiModal(continuous=x, discrete=k),
                               pad_masks, row_of, offset_of, W)
    for m in ("continuous", "discrete", "mask"):
        np.testing.assert_array_equal(getattr(out, m).numpy(), np.asarray(getattr(ref, m)))


def test_batch_ladders_match_jax():
    from multimodal_flows_tpu.sampling import generator as jgen

    for n in (1, 8, 9, 33, 64, 65, 200):
        assert _snap_batch(n) == jgen._snap_batch(n)
    for n_rows, bs in ((674, 256), (300, 128), (100, 128), (257, 128)):
        assert _rebalanced_batch(n_rows, bs) == jgen._rebalanced_batch(n_rows, bs)


@pytest.fixture(scope="module")
def generated():
    cfg = Config(**TINY)
    system = MMF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    mults = np.concatenate([rng.integers(2, 11, size=30), [15, 20]])  # 2 wider than a row
    pad_masks = _pad_masks(mults, 20)
    profiling.take_counters()
    res = generate_packed(system, pad_masks, num_timesteps=4, pack_width=12, batch_size=8,
                          seed=0, metadata={"mean": [1.0, 0.0, 0.0], "std": [2.0, 1.0, 1.0]})
    return cfg, pad_masks, res


def test_generate_packed_outputs(generated):
    cfg, pad_masks, res = generated
    s = res.sample
    assert s.continuous.shape == (32, 20, 3) and s.discrete.shape == (32, 20, 1)
    assert s.continuous.dtype == torch.float32 and s.discrete.dtype == torch.int32
    np.testing.assert_array_equal(s.mask.numpy(), pad_masks)
    assert torch.isfinite(s.continuous).all()
    assert ((s.discrete >= 0) & (s.discrete < cfg.vocab_size)).all()
    pad = s.mask[..., 0] == 0
    assert (s.continuous[pad] == 0).all() and (s.discrete[pad] == 0).all()
    real = s.mask[..., 0] > 0
    assert (s.continuous[real] != 0).all()  # every real slot, the wide jets' too
    assert res.jets_per_sec > 0 and res.num_timesteps == 4
    assert {k: v for k, v in profiling.peek_counters().items() if k.startswith("k1.")} == {
        "k1.segments": 0, "k1.key_mask": 0, "k1.none": 0}


def test_saved_generation_loads_in_jax(generated, tmp_path):
    cfg, _, res = generated
    path = save_generation(res, cfg, str(tmp_path / "gen"))
    loaded = JaxMultiModal.load_from(path)
    for m in ("continuous", "discrete", "mask"):
        ref = getattr(res.sample, m).numpy()
        np.testing.assert_array_equal(np.asarray(getattr(loaded, m)), ref)
        assert np.asarray(getattr(loaded, m)).dtype == ref.dtype
    assert loaded.time is None
    with open(tmp_path / "gen" / "configs.yaml") as f:
        assert yaml.safe_load(f) == cfg.to_dict()
    back = MultiModal.load_from(path)
    assert torch.equal(back.discrete, res.sample.discrete)


def test_multimodal_helpers():
    a = MultiModal(time=torch.zeros(2), continuous=torch.ones(2, 3, 3),
                   discrete=torch.full((2, 3, 1), 4), mask=torch.tensor([[1, 1, 0], [1, 0, 0]])[..., None])
    assert len(a) == 2 and a.num_particles == 3
    m = a.apply_mask()
    assert m.discrete.dtype == torch.int32 and int(m.discrete.sum()) == 12
    assert float(m.continuous.sum()) == 9.0
    both = MultiModal.concat([a, a[1:]])
    assert len(both) == 3 and both.time.shape == (3,)
    assert both.to("cpu").mask.shape == (3, 3, 1)


@pytest.mark.parametrize("tags,prefix", [(None, ""), (["a", "b"], "_a_b")])
def test_run_generation_sweep_tags_and_count(tags, prefix):
    """files x temperatures x steps results in the JAX package's order with
    its tag format; file i is seeded `seed + i` (so the files differ, and
    a file is reproducible); `save=False` writes nothing and needs neither
    h5py nor yaml."""
    from multimodal_flows_tpu_torch.sampling.generator import run_generation_sweep

    cfg = Config(**TINY, batch_size=8, seed=3, tags=tags, experiment_id=None)
    system = MMF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    masks = _pad_masks([3, 7, 5, 9, 2, 6], 20)
    results = run_generation_sweep(system, masks, cfg, temperatures=[1.0, 0.7],
                                   timestep_grid=[2, 3], num_files=2, save=False)
    expected = [f"{prefix}{suffix}_steps_{steps}_temp_{temp}"
                for suffix in ("", "_1") for temp in (1.0, 0.7) for steps in (2, 3)]
    assert [r.tag for r in results] == expected
    assert [(r.num_timesteps, r.temperature) for r in results] == [
        (steps, temp) for _ in range(2) for temp in (1.0, 0.7) for steps in (2, 3)]
    assert all(len(r.sample) == 6 and torch.isfinite(r.sample.continuous).all() for r in results)
    assert not torch.equal(results[0].sample.continuous, results[4].sample.continuous)
    again = run_generation_sweep(system, masks, cfg, temperatures=[1.0], timestep_grid=[2],
                                 save=False)
    assert torch.equal(again[0].sample.continuous, results[0].sample.continuous)


def test_run_generation_sweep_saves_under_the_experiment(tmp_path):
    from multimodal_flows_tpu_torch.sampling.generator import run_generation_sweep

    cfg = Config(**TINY, batch_size=8, dir=str(tmp_path), experiment_id="sweep")
    system = MMF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    results = run_generation_sweep(system, _pad_masks([3, 7, 5], 20), cfg, temperatures=[0.9],
                                   timestep_grid=[2])
    res_dir = tmp_path / cfg.project / "sweep" / "generation_results_steps_2_temp_0.9"
    loaded = JaxMultiModal.load_from(str(res_dir / "generated_sample.h5"))
    np.testing.assert_array_equal(np.asarray(loaded.discrete), results[0].sample.discrete.numpy())
    assert yaml.safe_load(open(res_dir / "configs.yaml"))["experiment_id"] == "sweep"
