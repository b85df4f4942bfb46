"""Packed training in the port against the JAX package: the MMF loss cores
(`training_loss`, `packed_training_loss`) with their metrics and every
parameter gradient against `jax.value_and_grad` on shared bridge states;
the three systems' `loss_fn` with their draws injected on both sides; the
optimizer (clip, Adam at the schedule's rate, EMA) over three updates;
the packing, the datasets, the epoch permutation and the row batch; the
checkpoint slots.  Then a port-only `fit` of two tiny epochs with a
checkpoint round trip and `resume`.  Everything runs on the CPU: the
systems are built with device="cpu"."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.config import Config as JaxConfig
from multimodal_flows_tpu.data import datasets as jdatasets
from multimodal_flows_tpu.data import packing as jpacking
from multimodal_flows_tpu.data.datasets import ArrayDataset as JaxArrayDataset
from multimodal_flows_tpu.data.datasets import shuffle_batches as jax_shuffle_batches
from multimodal_flows_tpu.data.state import DataCoupling as JaxCoupling
from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
from multimodal_flows_tpu.train import systems as jsystems
from multimodal_flows_tpu.train import trainer as jtrainer_mod
from multimodal_flows_tpu.train.checkpoints import CheckpointManager as JaxCheckpointManager
from multimodal_flows_tpu.train.ema import ema_update as jax_ema_update
from multimodal_flows_tpu.train.trainer import Trainer as JaxTrainer
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.convert import load_flax_params, params_from_flax
from multimodal_flows_tpu_torch.data import packing
from multimodal_flows_tpu_torch.data.datasets import (
    ArrayDataset,
    make_train_val_loaders,
    shuffle_batches,
)
from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
from multimodal_flows_tpu_torch.ops import btc_attention as k1
from multimodal_flows_tpu_torch.train import systems
from multimodal_flows_tpu_torch.train import trainer as trainer_mod
from multimodal_flows_tpu_torch.train.checkpoints import CheckpointManager
from multimodal_flows_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

# fp32 on both sides; sums run in another order
LOSS_RTOL = 1e-6
# gradients: relative to the largest entry of each gradient tensor, with a
# floor for gradients that are zero in exact arithmetic (the bias of the
# key LayerNorm shifts all scores of a query alike): both sides give
# rounding noise of ~1e-11 there
GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-9
# parameters after three Adam updates of size ~lr
UPDATE_ATOL = 1e-6

SMALL = dict(model="ParticleFormer", n_embd=32, n_inner=64, n_layer=1, n_layer_fused=1,
             n_head=2, vocab_size=9, dim_continuous=3, max_num_particles=24,
             multitask_loss="time-weighted", sigma=0.0)
KIN = dict(SMALL, model="KinFormer")
FLAVOR = dict(SMALL, model="FlavorFormer")


def _randomize(tree, seed):
    """The initial values plus noise, so every bias and scale is nonzero
    and differs from its neighbours (LayerNorm scales stay near 1)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.1)
                        .astype(np.float32), tree)


def _system_pair(kind, cfg_kw, seed=3):
    """JAX system + randomized params, and the port's system (CPU) holding
    the same params."""
    jsys = jsystems.SYSTEM_REGISTRY[kind](JaxConfig(**cfg_kw))
    params = _randomize(jax.jit(jsys.init_params)(jax.random.PRNGKey(0))["params"], seed)
    tsys = systems.build_system(Config(**cfg_kw), kind, device="cpu")
    load_flax_params(tsys.module, params)
    return jsys, params, tsys


@pytest.fixture(scope="module")
def mmf_pair():
    return _system_pair("MMF", SMALL)


def _jets(mults, D=24, seed=0):
    rng = np.random.default_rng(seed)
    mask = (np.arange(D)[None, :] < np.asarray(mults)[:, None]).astype(np.int32)[..., None]
    x = (rng.normal(size=(len(mults), D, 3)) * mask).astype(np.float32)
    k = (rng.integers(1, 9, (len(mults), D, 1)) * mask).astype(np.int32)
    return x, k, mask


def _states(mask, seed):
    """Bridge states shared by both sides: xt, kt, drift (masked)."""
    rng = np.random.default_rng(seed)
    shape = mask.shape[:2]
    xt = (rng.normal(size=shape + (3,)) * mask).astype(np.float32)
    kt = (rng.integers(1, 9, shape + (1,)) * mask).astype(np.int32)
    drift = (rng.normal(size=shape + (3,)) * mask).astype(np.float32)
    return xt, kt, drift


def _grads_match(jax_grads, module):
    converted = params_from_flax(jax_grads)
    names = {n for n, _ in module.named_parameters()}
    assert set(converted) == names
    for name, p in module.named_parameters():
        ref = converted[name].numpy()
        scale = max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                   atol=GRAD_RTOL * scale + GRAD_FLOOR, err_msg=name)


def _metrics_match(out, ref):
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.item(), float(r), rtol=LOSS_RTOL, atol=1e-7)


def test_training_loss_and_grads_match_jax(mmf_pair):
    jsys, params, tsys = mmf_pair
    x, k, mask = _jets([5, 24, 3, 11, 8, 1])
    xt, kt, drift = _states(mask, 1)
    t = np.linspace(0.05, 0.95, len(mask)).astype(np.float32)

    def loss(p):
        out = jsys.module.apply({"params": p}, JaxMultiModal(
            time=jnp.asarray(t), continuous=jnp.asarray(xt), discrete=jnp.asarray(kt),
            mask=jnp.asarray(mask)), jnp.asarray(drift), jnp.asarray(k),
            method="training_loss")
        return out[0], out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tsys.module.zero_grad()
    out = tsys.module.training_loss(MultiModal(
        time=torch.from_numpy(t), continuous=torch.from_numpy(xt), discrete=torch.from_numpy(kt),
        mask=torch.from_numpy(mask)), torch.from_numpy(drift), torch.from_numpy(k))
    out[0].backward()
    _metrics_match(out, ref)
    _grads_match(grads, tsys.module)


def _packed_inputs(seed=4):
    """Jets packed into rows of 24 (port packing), per-jet times in the
    slots, per-token times through the segment ids, shared states."""
    x, k, mask = _jets([5, 9, 3, 7, 12, 4, 6, 8, 2], seed=seed)
    packed, leftover = packing.pack_multimodal(MultiModal(continuous=x, discrete=k, mask=mask),
                                               24)
    assert len(leftover) == 0
    rng = np.random.default_rng(seed + 1)
    t_jets = rng.uniform(0.05, 0.95, packed.jet_valid.shape).astype(np.float32)
    t_tok = np.take_along_axis(t_jets, np.clip(packed.segments, 0, None), axis=1)
    xt, kt, drift = _states(packed.mask, seed + 2)
    return packed, t_jets, t_tok, xt, kt, drift


def test_packed_training_loss_and_grads_match_jax(mmf_pair):
    jsys, params, tsys = mmf_pair
    packed, t_jets, t_tok, xt, kt, drift = _packed_inputs()

    def loss(p):
        out = jsys.module.apply(
            {"params": p}, JaxMultiModal(time=jnp.asarray(t_tok), continuous=jnp.asarray(xt),
                                         discrete=jnp.asarray(kt),
                                         mask=jnp.asarray(packed.mask)),
            jnp.asarray(drift), jnp.asarray(packed.discrete), jnp.asarray(t_jets),
            jnp.asarray(packed.segments), jnp.asarray(packed.jet_valid),
            method="packed_training_loss")
        return out[0], out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    tsys.module.zero_grad()
    p = packed.to("cpu")
    out = tsys.module.packed_training_loss(
        MultiModal(time=torch.from_numpy(t_tok), continuous=torch.from_numpy(xt),
                   discrete=torch.from_numpy(kt), mask=p.mask),
        torch.from_numpy(drift), p.discrete, torch.from_numpy(t_jets), p.segments, p.jet_valid)
    out[0].backward()
    _metrics_match(out, ref)
    _grads_match(grads, tsys.module)
    assert sum(k1.LAUNCHES.values()) == 0  # CPU tensors take the plain attention


def _inject(monkeypatch, mod, sys_, draws, as_array):
    """Replace the draws of a system's loss_fn (time, sources, bridge
    samples) with fixed arrays; the drift target follows from them."""
    t, x0, k0, xt, kt = (None if a is None else as_array(a) for a in draws)
    monkeypatch.setattr(mod, "_sample_time", lambda *a, **kw: t)
    if hasattr(sys_, "bridge_continuous"):
        monkeypatch.setattr(sys_.bridge_continuous, "draw_source", lambda *a, **kw: x0)
        monkeypatch.setattr(sys_.bridge_continuous, "sample", lambda *a, **kw: xt)
    if hasattr(sys_, "bridge_discrete"):
        monkeypatch.setattr(sys_.bridge_discrete, "draw_source", lambda *a, **kw: k0)
        monkeypatch.setattr(sys_.bridge_discrete, "sample", lambda *a, **kw: kt)


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
@pytest.mark.parametrize("kind,cfg_kw", [("MMF", SMALL), ("CFM", KIN), ("MJB", FLAVOR)])
def test_loss_fn_matches_jax_with_injected_draws(monkeypatch, kind, cfg_kw, packed):
    """`loss_fn` of each system, padded and packed, with t, the sources and
    the bridge states injected into both: MMF's multitask loss, CFM's and
    MJB's global losses with their normalisation, and the metrics."""
    jsys, params, tsys = (_system_pair(kind, cfg_kw) if kind != "MMF"
                          else _system_pair("MMF", SMALL))
    if packed:
        batch, t_jets, _, xt, kt, _ = _packed_inputs(seed=7)
        t, mask, x1, k1 = t_jets, batch.mask, batch.continuous, batch.discrete
        jbatch = jpacking.PackedJets(**{f: jnp.asarray(getattr(batch, f)) for f in
                                        ("continuous", "discrete", "mask", "segments",
                                         "jet_valid")})
        tbatch = batch.to("cpu")
    else:
        x1, k1, mask = _jets([7, 2, 24, 13], seed=8)
        xt, kt, _ = _states(mask, 9)
        t = np.array([0.2, 0.5, 0.7, 0.9], np.float32)
        jbatch = JaxCoupling(source=JaxMultiModal(mask=jnp.asarray(mask)),
                             target=JaxMultiModal(continuous=jnp.asarray(x1),
                                                  discrete=jnp.asarray(k1),
                                                  mask=jnp.asarray(mask)))
        tbatch = DataCoupling(source=MultiModal(mask=torch.from_numpy(mask)),
                              target=MultiModal(continuous=torch.from_numpy(x1),
                                                discrete=torch.from_numpy(k1),
                                                mask=torch.from_numpy(mask)))
    rng = np.random.default_rng(10)
    x0 = (rng.normal(size=x1.shape) * mask).astype(np.float32)
    k0 = (rng.integers(1, 9, k1.shape) * mask).astype(np.int32)
    draws = (t, x0, k0, xt, kt)
    _inject(monkeypatch, jsystems, jsys, draws, jnp.asarray)
    _inject(monkeypatch, systems, tsys, draws, torch.from_numpy)

    # the injected draws enter the trace as constants
    ref_loss, ref = jax.jit(lambda p, b: jsys.loss_fn({"params": p}, b, jax.random.PRNGKey(0)))(
        params, jbatch)
    with torch.no_grad():
        loss, metrics = tsys.loss_fn(tbatch, None, train=True)
    assert set(metrics) == set(ref)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    for name in ref:
        np.testing.assert_allclose(float(metrics[name]), float(ref[name]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=name)


def test_sample_and_token_time():
    gen = torch.Generator().manual_seed(0)
    t = systems._sample_time(gen, (4, 3), 1e-5, torch.device("cpu"))
    assert t.shape == (4, 3) and t.dtype == torch.float32
    assert float(t.min()) >= 1e-5 and float(t.max()) < 1.0
    seg = np.array([[0, 0, 1, 2, -1], [0, -1, -1, -1, -1]], np.int32)
    ref = jsystems._token_time(jnp.asarray(t[:2].numpy()), jnp.asarray(seg))
    out = systems._token_time(t[:2], torch.from_numpy(seg))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind", ["MMF", "CFM", "MJB"])
def test_entry_points_run_on_cuda_unless_asked_for_the_cpu(kind):
    """Without a device, build_system asks for CUDA: it raises on a machine
    without one, and never carries on on the CPU."""
    cfg = Config(**dict(SMALL, model={"MMF": "ParticleFormer", "CFM": "KinFormer",
                                      "MJB": "FlavorFormer"}[kind]))
    if torch.cuda.is_available():
        assert systems.build_system(cfg, kind).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            systems.build_system(cfg, kind)
    assert systems.build_system(cfg, kind, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("option,item", [(dict(fsdp=True), 22), (dict(tensor_parallel=2), 22)])
def test_trainer_raises_on_unported_options(option, item):
    """Meshes still raise; bucketed training, the physics eval and dropout
    no longer do."""
    cfg = Config(**SMALL, **option)
    system = systems.build_system(Config(**SMALL), "MMF", device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue 1 item {item}"):
        Trainer(system, cfg)
    Trainer(system, Config(**SMALL, bucketed_training=True, physics_eval_every_n_epochs=2,
                           dropout=0.1))


def test_three_optimizer_updates_match_optax(mmf_pair):
    """Clip (below and above the threshold), Adam at the schedule's rate
    (warmup, so the rate changes every update) and EMA: the port's update
    and the JAX trainer's optax chain + `ema_update`, fed the same
    gradients, three times."""
    jsys, params, _ = mmf_pair
    cfg_kw = dict(SMALL, lr=1e-3, lr_final=1e-4, warmup_epochs=2, max_epochs=5,
                  use_ema_weights=True, ema_decay=0.9)
    jtrainer = JaxTrainer(jsys, JaxConfig(**cfg_kw), mesh=None)
    tx = jtrainer.make_optimizer(steps_per_epoch=1)
    jparams, opt_state, jema = params, tx.init(params), params

    tsys = systems.build_system(Config(**cfg_kw), "MMF", device="cpu")
    load_flax_params(tsys.module, params)
    trainer = Trainer(tsys, Config(**cfg_kw))
    state = trainer.init_state(steps_per_epoch=1)

    @jax.jit
    def jax_update(grads, opt_state, jparams, jema):
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        return opt_state, jparams, jax_ema_update(jema, jparams, cfg_kw["ema_decay"])

    rng = np.random.default_rng(11)
    for scale in (0.01, 5.0, 0.2):  # global norms below, above and below 1.0
        grads = jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale).astype(np.float32),
                             params)
        opt_state, jparams, jema = jax_update(grads, opt_state, jparams, jema)

        converted = params_from_flax(grads)
        for name, p in state.module.named_parameters():
            p.grad = converted[name].clone()
        norm = trainer._update(state)
        np.testing.assert_allclose(float(norm), float(jnp.sqrt(sum(
            (g.astype(np.float64) ** 2).sum() for g in jax.tree.leaves(grads)))), rtol=1e-5)
        for tree, module in ((jparams, state.module), (jema, state.ema)):
            ref = params_from_flax(tree)
            for name, p in module.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0,
                                           atol=UPDATE_ATOL, err_msg=name)
    assert state.step == 3


def _datasets(mults, seed=0, D=24):
    x, k, mask = _jets(mults, D=D, seed=seed)
    jds = JaxArrayDataset(JaxCoupling(source=JaxMultiModal(mask=mask),
                                      target=JaxMultiModal(continuous=x, discrete=k, mask=mask)))
    tds = ArrayDataset(DataCoupling(source=MultiModal(mask=mask),
                                    target=MultiModal(continuous=x, discrete=k, mask=mask)))
    return jds, tds


def _assert_same_packed(a, b):
    for f in ("continuous", "discrete", "mask", "segments", "jet_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                      err_msg=f)


def test_packing_and_datasets_match_jax():
    rng = np.random.default_rng(12)
    mults = np.clip(rng.poisson(8, 40), 2, 24)
    mults[:3] = [20, 22, 24]
    jds, tds = _datasets(mults)
    jets = tds.coupling.target
    for width in (16, 24):
        (jp, jl), (tp, tl) = (jpacking.pack_multimodal(jds.coupling.target, width),
                              packing.pack_multimodal(jets, width))
        _assert_same_packed(tp, jp)
        np.testing.assert_array_equal(tl, jl)
        _assert_same_packed(packing.pad_rows(tp, 7), jpacking.pad_rows(jp, 7))
    _assert_same_packed(packing.singleton_rows(jets[:5]),
                        jpacking.singleton_rows(jds.coupling.target[:5]))
    for (ja, jb), (ta, tb) in zip([jds.split(0.75, seed=3)], [tds.split(0.75, seed=3)]):
        np.testing.assert_array_equal(ta.coupling.target.mask, ja.coupling.target.mask)
        np.testing.assert_array_equal(tb.coupling.target.continuous, jb.coupling.target.continuous)
    for jb, tb in zip(jax_shuffle_batches(jds, 6, seed=1, epoch=2, drop_last=False,
                                          pad_last=True),
                      shuffle_batches(tds, 6, seed=1, epoch=2, drop_last=False, pad_last=True)):
        np.testing.assert_array_equal(tb.target.discrete, jb.target.discrete)


def test_stack_coupling_and_split_match_jax():
    """`MultiModal.stack`, `DataCoupling` indexing and length (an empty
    member stays empty), and `make_train_val_loaders`' split."""
    x, k, mask = _jets([5, 9, 3, 12], seed=15)
    t = np.linspace(0.1, 0.9, 4).astype(np.float32)
    jets = [JaxMultiModal(time=t, continuous=x, discrete=k, mask=mask),
            JaxMultiModal(time=t[::-1].copy(), continuous=x[::-1].copy(),
                          discrete=k[::-1].copy(), mask=mask[::-1].copy())]
    ref = JaxMultiModal.stack(jets, axis=1)
    out = MultiModal.stack([MultiModal(**{f: torch.from_numpy(np.asarray(getattr(j, f)))
                                          for f in ("time", "continuous", "discrete", "mask")})
                            for j in jets], dim=1)
    for f in ("time", "continuous", "discrete", "mask"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)))
    assert MultiModal.stack([MultiModal(mask=torch.ones(2, 3, 1))] * 2).continuous is None

    jc = JaxCoupling(source=JaxMultiModal(mask=mask), target=JaxMultiModal(continuous=x,
                                                                           mask=mask))
    tc = DataCoupling(source=MultiModal(mask=mask), target=MultiModal(continuous=x, mask=mask))
    assert len(tc) == len(jc) == 4
    idx = np.array([3, 0])
    np.testing.assert_array_equal(tc[idx].target.continuous, np.asarray(jc[idx].target.continuous))
    assert tc[idx].context.mask is None and tc[idx].source.continuous is None
    (ja, jb), (ta, tb) = (jdatasets.make_train_val_loaders(jc, 0.5, seed=2),
                          make_train_val_loaders(tc, 0.5, seed=2))
    np.testing.assert_array_equal(ta.coupling.target.continuous, ja.coupling.target.continuous)
    np.testing.assert_array_equal(tb.coupling.source.mask, jb.coupling.source.mask)


def test_metric_means_match_jax():
    """The per-epoch means: one stack, a stack weighted by its batches'
    rows (validation's padded tail), several units weighted by their
    batch counts with and without inner weights, and a list of metric
    dicts."""
    rng = np.random.default_rng(16)
    stacks = [{"loss": rng.normal(size=n), "loss_ce": rng.normal(size=n)} for n in (4, 2, 3)]
    inner = [rng.integers(1, 9, size=n).tolist() for n in (4, 2, 3)]
    cases = [("_mean_stacked", (stacks[0],), dict(prefix="val_")),
             ("_mean_stacked", (stacks[0],), dict(prefix="val_", weights=inner[0])),
             ("_combine_stacked", (stacks, [4, 2, 3]), dict(prefix="train_")),
             ("_combine_stacked", (stacks, [9, 3, 5]), dict(prefix="val_",
                                                              inner_weights=inner)),
             ("_combine_stacked", ([], []), {}),
             ("_mean_metrics", ([{"a": 1.0, "b": 2.0}, {"a": 3.0, "b": 5.0}],), {}),
             ("_mean_metrics", ([{"a": 1.0}, {"a": 3.0}],), dict(prefix="p_", weights=[1, 3]))]
    for name, args, kw in cases:
        out = getattr(trainer_mod, name)(*args, **kw)
        ref = getattr(jtrainer_mod, name)(*args, **kw)
        assert out.keys() == ref.keys()
        for key in ref:
            assert out[key] == pytest.approx(ref[key], rel=1e-12), (name, key)


def test_pack_units_and_epoch_perm_match_jax():
    """The units (packed rows and the singleton tail, padded to the row
    batch), the row batch (jets per step preserved), and the epoch
    permutations of the JAX trainer."""
    rng = np.random.default_rng(13)
    mults = np.clip(rng.poisson(6, 48), 2, 24)
    mults[:2] = [21, 23]
    jds, tds = _datasets(mults, seed=2)
    cfg_kw = dict(SMALL, batch_size=12, packed_training=True, pack_width=16)
    jtrainer = JaxTrainer(jsystems.MMF(JaxConfig(**cfg_kw)), JaxConfig(**cfg_kw), mesh=None)
    trainer = Trainer(systems.build_system(Config(**cfg_kw), "MMF", device="cpu"),
                      Config(**cfg_kw))
    junits, tunits = jtrainer._pack_units(jds), trainer._pack_units(tds)
    assert trainer._packed_row_bs == jtrainer._packed_row_bs
    assert len(junits) == len(tunits) == 2
    for ju, tu in zip(junits, tunits):
        _assert_same_packed(tu.coupling, ju.coupling)
    for kw in (dict(shuffle=True, seed=0, epoch=3), dict(shuffle=False, seed=0, epoch=0,
                                                         pad_last=True)):
        for n, bs in ((23, 5), (40, 8), (3, 4)):
            np.testing.assert_array_equal(Trainer._epoch_perm(n, bs, **kw),
                                          JaxTrainer._epoch_perm(n, bs, **kw))


def test_checkpoint_manager_matches_jax(tmp_path):
    """Both managers on one sequence of metrics (a NaN, a re-run epoch, a
    physics score beyond the margin): the same slots written and the same
    index; the port's slots hold the states saved."""
    monitors = {"best": "val_loss", "best_physics": "val_w1_physics"}
    jmgr = JaxCheckpointManager(str(tmp_path / "jax"), monitors, top_k=2, physics_margin=0.3)
    mgr = CheckpointManager(str(tmp_path / "port"), monitors, top_k=2, physics_margin=0.3)
    seq = [(1, 3.0, 0.10), (2, float("nan"), 0.05), (3, 2.0, 0.06), (3, 1.5, 0.09),
           (4, 2.5, 0.055)]
    for i, (epoch, loss, w1) in enumerate(seq):
        metrics = {"val_loss": loss, "val_w1_physics": w1}
        assert (mgr.save({"w": torch.full((2,), float(i))}, metrics, epoch)
                == jmgr.save({"w": np.full(2, float(i))}, metrics, epoch))
    assert mgr.index == jmgr.index
    assert float(mgr.load("best")["w"][0]) == 3.0          # epoch 3 re-run, val_loss 1.5
    assert float(mgr.load("best_physics")["w"][0]) == 4.0  # the latest within the margin
    assert float(mgr.load("last")["w"][0]) == 4.0
    assert sorted(os.listdir(mgr.dir)) == sorted(
        [n + ".pt" for n in ("last", "best", "best-ep3", "best-ep4", "best_physics",
                             "best_physics-ep2", "best_physics-ep4")] + ["index.json"])
    reloaded = CheckpointManager(mgr.dir, monitors).index  # NaN != NaN: compare the JSON
    assert json.dumps(reloaded, sort_keys=True) == json.dumps(mgr.index, sort_keys=True)
    with pytest.raises(FileNotFoundError):
        mgr.load("nope")


# the names the JAX trainer logs per epoch: the loss_fn metrics and
# grad_norm under train_, the loss_fn metrics under val_, then epoch, lr and
# epoch_time_s (multimodal_flows_tpu/train/trainer.py:139,670,716-719)
JAX_EPOCH_KEYS = {f"{p}_{m}" for p in ("train", "val")
                  for m in ("loss", "loss_mse", "loss_ce", "weight_mse", "weight_ce")}
JAX_EPOCH_KEYS |= {"train_grad_norm", "epoch", "lr", "epoch_time_s"}


def test_fit_two_epochs_checkpoints_and_resume(tmp_path):
    """A port-only fit: packed rows plus a singleton unit, EMA on; the loss
    of the trained weights on a fixed batch falls; the logged names are the
    JAX trainer's; `last` reloads the trained weights; `resume` runs the
    remaining epoch from the saved step."""
    rng = np.random.default_rng(14)
    mults = np.clip(rng.poisson(8, 64), 2, 24)
    mults[:3] = [20, 22, 24]
    _, ds = _datasets(mults, seed=5)
    train_ds, val_ds = ds.split(0.8, seed=0)
    cfg = Config(**dict(SMALL, batch_size=8, max_epochs=2, lr=3e-3, lr_final=1e-3,
                        packed_training=True, pack_width=16, use_ema_weights=True,
                        dir=str(tmp_path), experiment_id="fit"))
    system = systems.build_system(cfg, "MMF", device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    trainer = Trainer(system, cfg)
    units = trainer._pack_units(train_ds)
    batch = units[0].coupling[np.arange(8)].to("cpu")

    def fixed_loss(module):
        with torch.no_grad():
            return float(system.loss_fn(batch, torch.Generator().manual_seed(1), train=False,
                                        module=module)[0])

    before = fixed_loss(system.module)
    state = trainer.fit(train_ds, val_ds)
    assert fixed_loss(state.module) < before

    exp = os.path.join(str(tmp_path), cfg.project, "fit")
    records = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    assert len(records) == 2 and set(records[-1]) == JAX_EPOCH_KEYS | {"step", "time"}
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in records)
    assert {"last.pt", "best.pt", "best_mse.pt", "best_ce.pt"} <= set(
        os.listdir(os.path.join(exp, "checkpoints")))
    assert not glob.glob(os.path.join(exp, "checkpoints", "best_physics*"))

    trained = trainer.load_for_inference("last", use_ema=False)
    for name, p in state.module.state_dict().items():
        torch.testing.assert_close(trained[name], p, rtol=0, atol=0)
    ema = trainer.load_for_inference("last")
    assert torch.equal(ema["encoder.head_x.proj.bias"], state.ema.state_dict()[
        "encoder.head_x.proj.bias"])
    fresh = systems.build_system(cfg, "MMF", device="cpu")
    fresh.module.load_state_dict(ema)
    assert trainer.evaluate(val_ds, fresh.module, epoch=1)["val_loss"] == pytest.approx(
        records[-1]["val_loss"], rel=1e-6)

    cfg3 = cfg.replace(max_epochs=3)
    trainer3 = Trainer(systems.build_system(cfg3, "MMF", device="cpu"), cfg3)
    state3 = trainer3.fit(train_ds, val_ds, resume="last")
    assert state3.step == state.step + state.step // 2
    records = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    assert [r["epoch"] for r in records] == [0, 1, 2]


# ---------------------------------------------------------- bucketed training


def _bucket_trainers(cfg_kw):
    jtrainer = JaxTrainer(jsystems.MMF(JaxConfig(**cfg_kw)), JaxConfig(**cfg_kw), mesh=None)
    trainer = Trainer(systems.build_system(Config(**cfg_kw), "MMF", device="cpu"),
                      Config(**cfg_kw))
    return jtrainer, trainer


def _assert_same_buckets(out, ref):
    assert [w for w, _, _ in out] == [w for w, _, _ in ref]
    for (w, tds, tsel), (_, jds, jsel) in zip(out, ref):
        np.testing.assert_array_equal(tsel, jsel)
        for side in ("source", "target"):
            for f in ("continuous", "discrete", "mask"):
                a = getattr(getattr(tds.coupling, side), f)
                b = getattr(getattr(jds.coupling, side), f)
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{w} {side}.{f}")
                    assert a.shape[1] == w


@pytest.mark.parametrize("case", ["plain", "merge_upward", "undersized_widest", "all_small"])
def test_bucketize_matches_jax(case):
    """The same widths, index sets and truncated arrays as the JAX trainer
    on one dataset: every bucket filled; undersized buckets merged upward
    into the next wider one; an undersized widest bucket folded with the
    widest surviving one at the wider width; a dataset smaller than
    `min_size` as one bucket."""
    rng = np.random.default_rng(20)
    if case == "plain":
        mults, min_size = rng.integers(1, 25, size=80), 1
    elif case == "merge_upward":      # 3 jets <= 8, many in (8, 16], some wider
        mults, min_size = np.concatenate([[2, 5, 8], rng.integers(9, 17, size=30),
                                          rng.integers(17, 25, size=12)]), 8
    elif case == "undersized_widest":  # only 2 jets wider than 16
        mults, min_size = np.concatenate([rng.integers(1, 9, size=20),
                                          rng.integers(9, 17, size=20), [20, 24]]), 8
    else:
        mults, min_size = np.array([3, 12, 20]), 8
    jds, tds = _datasets(mults, seed=21)
    jtrainer, trainer = _bucket_trainers(dict(SMALL, bucket_widths=[16, 8, 64]))
    ref, out = jtrainer._bucketize(jds, min_size=min_size), trainer._bucketize(tds, min_size)
    _assert_same_buckets(out, ref)
    assert sorted(np.concatenate([sel for _, _, sel in out])) == list(range(len(mults)))
    expected = {"plain": [8, 16, 24], "merge_upward": [16, 24], "undersized_widest": [8, 24],
                "all_small": [24]}[case]
    assert [w for w, _, _ in out] == expected


def test_bucketize_refuses_masks_that_are_not_first_n_filled():
    x, k, mask = _jets([5, 9, 3], seed=22)
    mask[0, 7] = 1     # a hole
    ds = ArrayDataset(DataCoupling(source=MultiModal(mask=mask),
                                   target=MultiModal(continuous=x, discrete=k, mask=mask)))
    jds = JaxArrayDataset(JaxCoupling(source=JaxMultiModal(mask=mask),
                                      target=JaxMultiModal(continuous=x, discrete=k, mask=mask)))
    jtrainer, trainer = _bucket_trainers(dict(SMALL, bucket_widths=[8, 16]))
    assert trainer._bucketize(ds) is None and jtrainer._bucketize(jds) is None


def test_truncate_width_matches_jax():
    x, k, mask = _jets([5, 3, 7], seed=23)
    t = np.array([0.1, 0.5, 0.9], np.float32)
    tc = DataCoupling(source=MultiModal(time=t, mask=mask),
                      target=MultiModal(continuous=x, discrete=k, mask=mask))
    jc = JaxCoupling(source=JaxMultiModal(time=t, mask=mask),
                     target=JaxMultiModal(continuous=x, discrete=k, mask=mask))
    out, ref = Trainer._truncate_width(tc, 8), JaxTrainer._truncate_width(jc, 8)
    assert out.target.continuous.shape == (3, 8, 3) and out.source.time.shape == (3,)
    for side in ("source", "target"):
        for f in ("time", "continuous", "discrete", "mask"):
            a, b = getattr(getattr(out, side), f), getattr(getattr(ref, side), f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b))


def test_bucketed_fit_trains_every_bucket_at_its_width(tmp_path, monkeypatch):
    """A port-only bucketed fit: one unit a bucket, each forward at its
    bucket's width (never the full 24), validation over the val buckets
    with inner weights, the logged names those of the JAX trainer;
    `evaluate` reproduces the logged validation loss; bucketed and packed
    training together raise as in JAX."""
    rng = np.random.default_rng(24)
    mults = np.clip(rng.poisson(8, 96), 1, 24)
    mults[:16] = rng.integers(13, 25, size=16)
    _, ds = _datasets(mults, seed=25)
    train_ds, val_ds = ds.split(0.75, seed=0)
    cfg = Config(**dict(SMALL, batch_size=8, max_epochs=2, lr=3e-3, lr_final=1e-3,
                        bucketed_training=True, bucket_widths=[8, 12], use_ema_weights=True,
                        dir=str(tmp_path), experiment_id="buckets"))
    system = systems.build_system(cfg, "MMF", device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    widths = []
    forward = system.module.encoder.forward

    def spy(state, *a, **kw):
        widths.append(int(state.mask.shape[1]))
        return forward(state, *a, **kw)

    monkeypatch.setattr(system.module.encoder, "forward", spy)
    trainer = Trainer(system, cfg)
    buckets = trainer._bucketize(train_ds, min_size=8)
    assert [w for w, _, _ in buckets] == [8, 12, 24]
    state = trainer.fit(train_ds, val_ds)
    steps_per_epoch = sum(len(b) // 8 for _, b, _ in buckets)
    assert state.step == 2 * steps_per_epoch
    assert set(widths) == {8, 12, 24}
    assert widths.count(24) < len(widths) // 3      # most steps skip the pad columns

    exp = os.path.join(str(tmp_path), cfg.project, "buckets")
    records = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    assert len(records) == 2 and set(records[-1]) == JAX_EPOCH_KEYS | {"step", "time"}
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]) for r in records)
    assert trainer.evaluate(val_ds, state.ema, epoch=1)["val_loss"] == pytest.approx(
        records[-1]["val_loss"], rel=1e-6)

    both = cfg.replace(packed_training=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(systems.build_system(both, "MMF", device="cpu"), both).fit(train_ds, val_ds)


def test_bucket_smaller_than_a_batch_is_skipped_with_a_warning(tmp_path, capsys):
    """Only possible when the whole dataset is smaller than a batch: the
    one bucket is skipped with a warning and the epoch still validates."""
    _, ds = _datasets([3, 5, 7, 9, 11, 4], seed=26)
    cfg = Config(**dict(SMALL, batch_size=8, max_epochs=1, bucketed_training=True,
                        bucket_widths=[8], dir=str(tmp_path)))
    trainer = Trainer(systems.build_system(cfg, "MMF", device="cpu"), cfg)
    state = trainer.fit(ds, ds)
    assert state.step == 0
    assert "jets < batch_size 8; skipped" in capsys.readouterr().out
