"""The port's meshes over two real processes: `torch.multiprocessing`
spawns two ranks on the CPU that join one gloo group (a file store in the
test's directory), one spawn per layout.  The workers live at the top of
this module and import the port only; the JAX reference and the
single-process runs of the port are made here, in the parent, from the
same numpy inputs and seeds.

- data parallel: the loss core on each rank's rows (packed rows of
  unequal jet counts) with the gradients averaged by the trainer, against
  JAX's single-device loss on the whole batch; one `Trainer` step and a
  two-epoch `fit` against one process; what a data mesh's CUDA graph
  captures (the split loss on the rank's rows, the all-reduce) against
  the eager step, bit for bit; `setup_logging_dir`;
  `generate_packed` over the mesh against one process, `gather_multihost`;
- FSDP: one step (clipping active) against one process; a `fit` whose
  `last` checkpoint a fresh pair restores and resumes, and one process
  loads, with equal parameters;
- tensor parallel (`tensor_parallel=2`): the forward and every gradient
  of seven encoders against the unsharded module (EPiC has no column /
  row pair and stays replicated); one step against one process; the
  checkpoint gathered to full tensors and cut back, both ways; a flax
  tree refused by a sharded module;
- dropout under a mesh: a data-parallel step and a `tensor_parallel=2`
  step with dropout 0.1 against the one-process dropout step from the same
  generator seed (every mask drawn at the global shape: the data ranks'
  rows, the model ranks' heads); a bf16 `tensor_parallel=2` step against
  the one-process bf16 step.
"""

import copy
import glob
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data import packing
from multimodal_flows_tpu_torch.data.datasets import ArrayDataset
from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
from multimodal_flows_tpu_torch.models.registry import build_model
from multimodal_flows_tpu_torch.parallel import mesh
from multimodal_flows_tpu_torch.parallel import tensor_parallel as tpar
from multimodal_flows_tpu_torch.sampling.generator import gather_multihost, generate_packed
from multimodal_flows_tpu_torch.train import systems
from multimodal_flows_tpu_torch.train.checkpoints import CheckpointManager
from multimodal_flows_tpu_torch.train.systems import _rank_total
from multimodal_flows_tpu_torch.train.trainer import Trainer
from multimodal_flows_tpu_torch.utils.logger import setup_logging_dir

WORLD = 2
SPAWN_TIMEOUT_S = 120
# fp32 on both sides, sums in another order (the halves of the batch, the
# all-reduce)
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-9
# the key LayerNorm's bias shifts every score of a query alike: its gradient
# is 0 in exact arithmetic and rounding noise of ~1e-8 on both sides, summed
# over the ranks' heads under TP
TP_GRAD_FLOOR = 1e-6
# weights after one or a few Adam updates of size ~lr
WEIGHT_ATOL = 1e-5
# bf16 under TP: the row-parallel layers round each rank's partial product
# to bf16 and all-reduce in bf16 (as XLA reduces a bf16 dot), one device
# rounds the whole product once: the loss moves by a few bf16 ulp of the
# activations it sums, the gradients by a few ulp of their scale; Adam's
# first step is lr * sign(g) where |g| is far above its eps, so a weight
# moves by up to 2 lr where a gradient within that rounding of 0 flips sign,
# and Adam's g / (|g| + eps) amplifies the rounding of gradients near its
# eps (4.5% of the weights beyond WEIGHT_ATOL measured; loss rel 5.7e-6,
# grad norm rel 2.8e-4)
BF16_TP_LOSS_RTOL, BF16_TP_GRAD_NORM_RTOL, BF16_TP_WEIGHTS_EQUAL = 1e-4, 2e-3, 0.9
FORWARD_ATOL = 1e-5
TOKENS_EQUAL = 0.999

SMALL = dict(model="ParticleFormer", n_embd=32, n_inner=64, n_layer=1, n_layer_fused=1,
             n_head=2, vocab_size=9, dim_continuous=3, max_num_particles=24,
             multitask_loss="time-weighted", sigma=0.0)
# packed rows of 24, 16 jets a step, EMA; a clip that every step hits
TRAIN = dict(SMALL, packed_training=True, pack_width=24, batch_size=16, use_ema_weights=True,
             ema_decay=0.9, lr=1e-3, gradient_clip_val=0.05, max_epochs=2, save_top_k=2)


# ------------------------------------------------------------ the inputs


def _jets(n: int, seed: int, D: int = 24):
    rng = np.random.default_rng(seed)
    mult = np.concatenate([rng.integers(2, 7, n - n // 4), rng.integers(14, D + 1, n // 4)])
    rng.shuffle(mult)
    mask = (np.arange(D)[None, :] < mult[:, None]).astype(np.int32)[..., None]
    x = (rng.normal(size=(n, D, 3)) * mask).astype(np.float32)
    k = (rng.integers(1, 9, (n, D, 1)) * mask).astype(np.int32)
    return MultiModal(continuous=x, discrete=k, mask=mask)


def _datasets():
    jets = _jets(96, seed=1)
    return ArrayDataset(DataCoupling(source=MultiModal(mask=jets.mask), target=jets)).split(
        0.75, seed=0)


def _packed_inputs(seed: int = 4):
    """Packed rows (an even number) whose halves hold unequal jet counts,
    per-jet times and shared bridge states."""
    jets = _jets(16, seed=seed)
    packed, leftover = packing.pack_multimodal(jets, 24)
    packed = packing.pad_rows(packed, 2) if len(packed) % 2 else packed
    rng = np.random.default_rng(seed + 1)
    t_jets = rng.uniform(0.05, 0.95, packed.jet_valid.shape).astype(np.float32)
    t_tok = np.take_along_axis(t_jets, np.clip(packed.segments, 0, None), axis=1)
    shape = packed.mask.shape[:2]
    xt = (rng.normal(size=shape + (3,)) * packed.mask).astype(np.float32)
    kt = (rng.integers(1, 9, shape + (1,)) * packed.mask).astype(np.int32)
    drift = (rng.normal(size=shape + (3,)) * packed.mask).astype(np.float32)
    return packed, t_jets, t_tok, xt, kt, drift


def _step_batch():
    """The first packed row batch of the training set, as the trainer cuts it."""
    train_ds, _ = _datasets()
    trainer = Trainer(_system(Config(**TRAIN)), Config(**TRAIN), mesh=None)
    unit = trainer._pack_units(train_ds)[0]
    return unit.coupling[np.arange(trainer._packed_row_bs)].to("cpu")


def _system(cfg: Config, kind: str = "MMF"):
    return systems.build_system(cfg, kind, device="cpu",
                                generator=torch.Generator().manual_seed(0))


def _one_step(trainer: Trainer, batch):
    """One optimizer step of `trainer` on `batch` from a fixed draw seed:
    the step's metrics and the full parameters after it."""
    state = trainer.init_state(10)
    state.module.train()
    metrics = trainer._train_step(state, batch, torch.Generator().manual_seed(7))
    return ({k: float(v) for k, v in metrics.items()}, tpar.full_state_dict(state.module),
            tpar.full_state_dict(state.ema), state)


def _pad_masks(n: int, seed: int):
    return _jets(n, seed=seed).mask.astype(np.int64)


# --------------------------------------------------------------- spawning


def _join(rank: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD)


def _spawn(worker, tmp_path, *args):
    """Run `worker(rank, store, out, *args)` on two ranks; raise on a
    worker's error or past the time limit.  Returns the ranks' results."""
    out = str(tmp_path)
    store = os.path.join(out, f"store_{worker.__name__}")
    ctx = mp.spawn(worker, args=(store, out) + args, nprocs=WORLD, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{worker.__name__} did not finish in {SPAWN_TIMEOUT_S} s")
    return [torch.load(os.path.join(out, f"{worker.__name__}_{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _save(worker_name: str, rank: int, out: str, res: dict) -> None:
    torch.save(res, os.path.join(out, f"{worker_name}_{rank}.pt"))


# ---------------------------------------------------------------- workers


def _dp_worker(rank, store, out, params_path):
    _join(rank, store)
    try:
        res = {}
        cfg = Config(**TRAIN)
        # the loss core on this rank's rows, the gradients averaged
        system = _system(cfg)
        system.module.load_state_dict(torch.load(params_path))
        trainer = Trainer(system, cfg)
        assert mesh.data_axis_size(trainer.mesh) == WORLD
        packed, t_jets, t_tok, xt, kt, drift = _packed_inputs()
        p = packed.to("cpu")
        rows = mesh.data_rows(len(p), trainer.mesh)
        out_core = system.module.packed_training_loss(
            MultiModal(time=torch.from_numpy(t_tok[rows]), continuous=torch.from_numpy(xt[rows]),
                       discrete=torch.from_numpy(kt[rows]), mask=p.mask[rows]),
            torch.from_numpy(drift[rows]), p.discrete[rows], torch.from_numpy(t_jets[rows]),
            p.segments[rows], p.jet_valid[rows], _rank_total(p.jet_valid.sum(), rows, len(p)))
        out_core[0].backward()
        params = list(system.module.parameters())
        trainer._average_gradients([q.grad for q in params])
        res["core"] = [float(o) for o in out_core]
        res["core_grads"] = {n: q.grad.clone() for n, q in system.module.named_parameters()}
        res["core_jets"] = int(p.jet_valid[rows].sum())

        # one trainer step on the global batch
        res["step"], res["after"], res["ema_after"], _ = _one_step(
            Trainer(_system(cfg), cfg), _step_batch())

        # what a data mesh's graph captures, run op by op, against the eager step
        res["split"] = {route: _split_or_eager_step(cfg, route) for route in ("eager", "split")}

        # a two-epoch fit: validation, metrics and checkpoints included
        fit_cfg = Config(**TRAIN, dir=os.path.join(out, "dp_fit"), experiment_id="dp")
        state = Trainer(_system(fit_cfg), fit_cfg).fit(*_datasets())
        res["fit_params"] = tpar.full_state_dict(state.module)

        # the run directory: rank 0 picks it, every rank gets it
        base = os.path.join(out, "run")
        os.makedirs(base, exist_ok=True)
        res["run_dir"] = setup_logging_dir(base)

        # sampling over the mesh, and the all-gather of the jets
        res["sample"] = generate_packed(_system(Config(**SMALL)), _pad_masks(40, 3),
                                        num_timesteps=3, pack_width=24, batch_size=16, seed=0,
                                        mesh=trainer.mesh).sample
        tagged = MultiModal(mask=torch.full((3, 2, 1), rank, dtype=torch.int32))
        res["gathered"] = gather_multihost(tagged, trainer.mesh).mask
        _save("_dp_worker", rank, out, res)
    finally:
        dist.destroy_process_group()


def _split_or_eager_step(cfg: Config, route: str) -> dict:
    """One step of a fresh trainer on the global batch from `_one_step`'s
    draw seed: `_eager_step`, or what a data mesh's graph captures
    (`loss_draws` at the global batch's shape from the generator, then
    `_step_of_draws` on this rank's rows, the gradients averaged in
    `_update`).  The step's metrics, the averaged and clipped gradients,
    the weights and EMA weights after it, and the generator's state."""
    system = _system(cfg)
    trainer = Trainer(system, cfg)
    state = trainer.init_state(10)
    state.module.train()
    batch, gen = _step_batch(), torch.Generator().manual_seed(7)
    if route == "eager":
        metrics = trainer._eager_step(state, batch, gen)
    else:
        metrics = trainer._step_of_draws(state, batch, system.loss_draws(batch, gen))
    named = list(state.module.named_parameters())
    return dict(metrics=metrics, grads={n: p.grad.clone() for n, p in named},
                after={n: p.detach().clone() for n, p in named},
                ema={n: p.detach().clone() for n, p in state.ema.named_parameters()},
                rows=mesh.data_rows(len(batch), trainer.mesh), generator=gen.get_state())


def _fsdp_worker(rank, store, out):
    _join(rank, store)
    try:
        res = {}
        cfg = Config(**TRAIN, fsdp=True)
        trainer = Trainer(_system(cfg), cfg)
        res["step"], res["after"], res["ema_after"], state = _one_step(trainer, _step_batch())
        res["sharded"] = tpar.is_sharded(state.module) and tpar.is_sharded(state.ema)
        fit_cfg = Config(**dict(TRAIN, fsdp=True, max_epochs=1,
                                dir=os.path.join(out, "fsdp_fit"), experiment_id="fsdp"))
        state = Trainer(_system(fit_cfg), fit_cfg).fit(*_datasets())
        res["fit_params"] = tpar.full_state_dict(state.module)
        _save("_fsdp_worker", rank, out, res)
    finally:
        dist.destroy_process_group()


def _fsdp_resume_worker(rank, store, out):
    """A fresh pair: restore the `last` checkpoint of `_fsdp_worker`'s fit
    into FSDP, then resume the fit for its second epoch."""
    _join(rank, store)
    try:
        res = {}
        cfg = Config(**dict(TRAIN, fsdp=True, dir=os.path.join(out, "fsdp_fit"),
                            experiment_id="fsdp"))
        trainer = Trainer(_system(cfg), cfg)
        state = trainer.init_state(10)
        ckpt = CheckpointManager(os.path.join(cfg.experiment_dir, "checkpoints"))
        res["epoch"] = Trainer._from_ckpt(state, ckpt.load("last"))
        res["restored"] = tpar.full_state_dict(state.module)
        res["restored_ema"] = tpar.full_state_dict(state.ema)
        res["restored_opt"] = tpar.full_optimizer_state_dict(state.module, state.optimizer)
        resumed = Trainer(_system(cfg), cfg).fit(*_datasets(), resume="last")
        res["resumed_step"] = resumed.step
        _save("_fsdp_resume_worker", rank, out, res)
    finally:
        dist.destroy_process_group()


def _encoder_cases():
    """(name, config, kind, inputs) of each encoder under TP: packed rows
    for the ParticleFormers and EPiC, padded jets for the others."""
    packed, t_jets, t_tok, xt, kt, drift = _packed_inputs(seed=9)
    p = packed.to("cpu")
    rows = MultiModal(time=torch.from_numpy(t_tok), continuous=torch.from_numpy(xt),
                      discrete=torch.from_numpy(kt), mask=p.mask)
    jets = _jets(6, seed=5)
    padded = MultiModal(time=torch.linspace(0.1, 0.9, 6), continuous=torch.from_numpy(
        jets.continuous), discrete=torch.from_numpy(jets.discrete),
        mask=torch.from_numpy(jets.mask))
    J = p.jet_valid.shape[1]
    seq = torch.from_numpy(np.random.default_rng(2).integers(1, 13, (4, 9)))
    return [
        ("ParticleFormer", dict(SMALL), (rows, p.segments, J)),
        ("FusedParticleFormer", dict(SMALL, model="FusedParticleFormer"), (padded, None, None)),
        ("ParticleFormer co-occurrence", dict(SMALL, use_coocurrence=True), (rows, p.segments, J)),
        ("FlavorFormer pairwise", dict(SMALL, model="FlavorFormer", use_pairwise=True),
         (padded, None, None)),
        ("KinFormer Lund", dict(SMALL, model="KinFormer", use_pairwise=True, pair_chunk=8),
         (padded, None, None)),
        ("EPiC", dict(SMALL, model="EPiC", n_embd_glob=8), (rows, p.segments, J)),
        ("GPT", dict(n_embd=32, n_inner=64, n_layer=2, n_head=2, vocab_size=9,
                     max_seq_length=7), (seq,)),
    ]


def _output_sum(out) -> torch.Tensor:
    outs = out if isinstance(out, tuple) else (out,)
    return sum((o.to(torch.float32) ** 2).sum() for o in outs)


def _tp_worker(rank, store, out):
    _join(rank, store)
    try:
        res = {"forward": {}}
        cfg = Config(**TRAIN, tensor_parallel=2)
        model_mesh = mesh.make_mesh_2d(2, "cpu")
        # forward and gradients of each encoder, sharded against whole
        for name, kw, inputs in _encoder_cases():
            torch.manual_seed(0)  # the same weights on both ranks
            whole = (systems.build_system(Config(**kw), "GPT", device="cpu",
                                          generator=torch.Generator().manual_seed(0)).module
                     if name == "GPT" else build_model(Config(**kw)))
            with torch.no_grad():
                for q in whole.parameters():  # nonzero biases, scales off 1
                    q.add_(torch.randn_like(q) * 0.05)
                if hasattr(whole, "lambda_u"):
                    whole.lambda_u.fill_(0.5)
            sharded = tpar.tp_sharding(copy.deepcopy(whole), model_mesh)
            ref, got = whole(*inputs), sharded(*inputs)
            _output_sum(ref).backward()
            _output_sum(got).backward()
            refs = ref if isinstance(ref, tuple) else (ref,)
            gots = got if isinstance(got, tuple) else (got,)
            err = max(float((a - b).abs().max()) for a, b in zip(refs, gots))
            ref_grads = dict(whole.named_parameters())
            grad_err = 0.0
            for n, q in sharded.named_parameters():
                g = ref_grads[n].grad
                if g is None:  # a parameter the output does not reach
                    assert q.grad is None, n
                    continue
                full = tpar._full(q.grad, q)
                grad_err = max(grad_err, float((full - g).abs().max()
                                               / (GRAD_RTOL * g.abs().max() + TP_GRAD_FLOOR)))
            res["forward"][name] = dict(err=err, grad_err=grad_err,
                                        sharded=tpar.is_sharded(sharded))
            if name == "GPT":
                res["gpt_cache_width"] = sharded.init_cache(2)[0][0].shape[-1]
        # one step, and the checkpoint both ways
        trainer = Trainer(_system(cfg), cfg)
        assert mesh.model_axis_size(trainer.mesh) == 2
        res["step"], res["after"], res["ema_after"], state = _one_step(trainer, _step_batch())
        ck = Trainer._to_ckpt(state, 1)
        fresh = Trainer(_system(cfg), cfg).init_state(10)
        Trainer._from_ckpt(fresh, ck)
        res["round_trip"] = tpar.full_state_dict(fresh.module)
        single_cfg = Config(**TRAIN)
        _, single_after, _, single_state = _one_step(Trainer(_system(single_cfg), single_cfg,
                                                             mesh=None), _step_batch())
        into_tp = Trainer(_system(cfg), cfg).init_state(10)
        Trainer._from_ckpt(into_tp, Trainer._to_ckpt(single_state, 1))
        res["from_single"] = tpar.full_state_dict(into_tp.module)
        res["single_after"] = single_after
        try:
            from multimodal_flows_tpu_torch.convert import load_flax_params

            load_flax_params(state.module, {})
            res["flax_refused"] = False
        except ValueError:
            res["flax_refused"] = True
        _save("_tp_worker", rank, out, res)
    finally:
        dist.destroy_process_group()


TRAIN_DROPOUT = dict(TRAIN, dropout=0.1)
TRAIN_BF16 = dict(TRAIN, compute_dtype="bfloat16")


def _dropout_worker(rank, store, out):
    """Steps from `_one_step`'s draw seed under a mesh: data parallel and
    tensor_parallel=2 with dropout, tensor_parallel=2 in bf16."""
    _join(rank, store)
    try:
        res = {}
        for name, kw in (("dp", TRAIN_DROPOUT), ("tp", dict(TRAIN_DROPOUT, tensor_parallel=2)),
                         ("tp_bf16", dict(TRAIN_BF16, tensor_parallel=2))):
            cfg = Config(**kw)
            trainer = Trainer(_system(cfg), cfg)
            res[name] = _one_step(trainer, _step_batch())[:3]
            res[name + "_mesh"] = (mesh.data_axis_size(trainer.mesh),
                                   mesh.model_axis_size(trainer.mesh))
        _save("_dropout_worker", rank, out, res)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ the parent's side


def _assert_weights(a: dict, b: dict, atol=WEIGHT_ATOL):
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], atol=atol, rtol=0, msg=k)


def _single_step():
    cfg = Config(**TRAIN)
    metrics, after, ema_after, _ = _one_step(Trainer(_system(cfg), cfg, mesh=None), _step_batch())
    return metrics, after, ema_after


@pytest.fixture(scope="module")
def single_step():
    return _single_step()


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """JAX's single-device packed loss and gradients on the whole batch,
    and the (randomized) parameters, converted, for the workers."""
    import jax
    import jax.numpy as jnp

    from multimodal_flows_tpu.config import Config as JaxConfig
    from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
    from multimodal_flows_tpu.train import systems as jsystems
    from multimodal_flows_tpu_torch.convert import params_from_flax

    jsys = jsystems.MMF(JaxConfig(**SMALL))
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.1)
                          .astype(np.float32),
                          jax.jit(jsys.init_params)(jax.random.PRNGKey(0))["params"])
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
    path = str(tmp_path_factory.mktemp("params") / "params.pt")
    torch.save(params_from_flax(params), path)
    return [float(r) for r in ref], params_from_flax(grads), path


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory, jax_reference):
    tmp = tmp_path_factory.mktemp("dp")
    return tmp, _spawn(_dp_worker, tmp, jax_reference[2])


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    first = _spawn(_fsdp_worker, tmp)
    # the resumed fit of the second pair writes `last` anew
    shutil.copy(_fsdp_last(tmp), os.path.join(str(tmp), "first_last.pt"))
    return tmp, first, _spawn(_fsdp_resume_worker, tmp)


def _fsdp_last(tmp) -> str:
    return os.path.join(str(tmp), "fsdp_fit", "aoj_jets", "fsdp", "checkpoints", "last.pt")


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    return _spawn(_tp_worker, tmp_path_factory.mktemp("tp"))


def test_dp_loss_on_unequal_ranks_equals_jax_on_the_whole_batch(dp_run, jax_reference):
    """The `_wmean` trap: the ranks' rows hold unequal jet counts; with the
    denominator over the global batch the ranks' mean loss, each metric and
    the averaged gradients are JAX's single-device values; the mean of
    per-rank weighted means is not."""
    _, ranks = dp_run
    ref, ref_grads, _ = jax_reference
    assert ranks[0]["core_jets"] != ranks[1]["core_jets"]
    mean = np.mean([r["core"] for r in ranks], axis=0)
    np.testing.assert_allclose(mean, ref, rtol=LOSS_RTOL, atol=1e-7)
    for r in ranks:
        for name, g in ref_grads.items():
            scale = max(float(g.abs().max()), 1e-30)
            np.testing.assert_allclose(r["core_grads"][name].numpy(), g.numpy(), rtol=0,
                                       atol=GRAD_RTOL * scale + GRAD_FLOOR, err_msg=name)
    # the trap: each rank's own weighted mean, then the plain mean
    share = [r["core_jets"] for r in ranks]
    per_rank = [r["core"][0] * sum(share) / (WORLD * s) for r, s in zip(ranks, share)]
    assert abs(np.mean(per_rank) - ref[0]) > 1e-3 * abs(ref[0])


def test_dp_step_and_fit_equal_one_process(dp_run, single_step, tmp_path):
    tmp, ranks = dp_run
    metrics, after, ema_after = single_step
    np.testing.assert_allclose(np.mean([r["step"]["loss"] for r in ranks]), metrics["loss"],
                               rtol=LOSS_RTOL)
    for r in ranks:
        np.testing.assert_allclose(r["step"]["grad_norm"], metrics["grad_norm"], rtol=1e-5)
        _assert_weights(r["after"], after)
        _assert_weights(r["ema_after"], ema_after)
    # the fit: logged metrics (rank 0 only) and the weights
    cfg = Config(**TRAIN, dir=str(tmp_path), experiment_id="single")
    state = Trainer(_system(cfg), cfg, mesh=None).fit(*_datasets())
    logged = [json.loads(line) for line in open(
        os.path.join(str(tmp), "dp_fit", cfg.project, "dp", "metrics.jsonl"))]
    single = [json.loads(line) for line in open(
        os.path.join(cfg.experiment_dir, "metrics.jsonl"))]
    assert len(logged) == len(single) == 2
    for a, b in zip(logged, single):
        for k in ("train_loss", "train_loss_mse", "train_grad_norm", "val_loss", "val_loss_ce"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    for r in ranks:
        _assert_weights(r["fit_params"], tpar.full_state_dict(state.module))
    assert sorted(os.listdir(os.path.join(str(tmp), "dp_fit", cfg.project))) == ["dp"]


def test_dp_captured_computation_equals_the_eager_step(dp_run):
    """What a data mesh's graph captures (`loss_draws` from the shared
    generator at the global batch's shape, then `_step_of_draws` on the
    rank's rows with the mesh's all-reduce) equals `_eager_step` bit for
    bit on each rank: the loss and its terms, the averaged and clipped
    gradients, the weights after Adam and the EMA, and the generator's
    state.  The ranks ran their own rows (their losses differ) and hold one
    averaged gradient, clipped to the clip value."""
    _, ranks = dp_run
    for r in ranks:
        eager, split = r["split"]["eager"], r["split"]["split"]
        assert eager["rows"] == split["rows"] is not None
        assert torch.equal(eager["generator"], split["generator"])
        assert eager["metrics"].keys() == split["metrics"].keys()
        for k, v in eager["metrics"].items():
            assert torch.equal(v, split["metrics"][k]), k
        for kind in ("grads", "after", "ema"):
            assert eager[kind].keys() == split[kind].keys()
            for n, v in eager[kind].items():
                assert torch.equal(v, split[kind][n]), (kind, n)
    a, b = (r["split"]["split"] for r in ranks)
    assert a["rows"] != b["rows"] and not torch.equal(a["metrics"]["loss"], b["metrics"]["loss"])
    assert all(torch.equal(g, b["grads"][n]) for n, g in a["grads"].items())
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                 for g in a["grads"].values()]))
    assert float(a["metrics"]["grad_norm"]) > TRAIN["gradient_clip_val"]
    np.testing.assert_allclose(float(norm), TRAIN["gradient_clip_val"], rtol=1e-5)


def test_dp_run_dir_sampling_and_gather(dp_run):
    tmp, ranks = dp_run
    assert ranks[0]["run_dir"] == ranks[1]["run_dir"] == os.path.join(str(tmp), "run_1")
    assert glob.glob(os.path.join(str(tmp), "run_*")) == [os.path.join(str(tmp), "run_1")]
    single = generate_packed(_system(Config(**SMALL)), _pad_masks(40, 3), num_timesteps=3,
                             pack_width=24, batch_size=16, seed=0).sample
    for r in ranks:
        s = r["sample"]
        assert len(s) == 40
        real = single.mask[..., 0] > 0
        torch.testing.assert_close(s.continuous, single.continuous, atol=1e-5, rtol=1e-5)
        same = float((s.discrete[..., 0] == single.discrete[..., 0])[real].float().mean())
        assert same >= TOKENS_EQUAL
        assert r["gathered"][:, 0, 0].tolist() == [0, 0, 0, 1, 1, 1]


def test_fsdp_step_equals_one_process_with_the_clip(fsdp_run, single_step):
    _, ranks, _ = fsdp_run
    metrics, after, ema_after = single_step
    assert metrics["grad_norm"] > TRAIN["gradient_clip_val"]  # the clip is active
    np.testing.assert_allclose(np.mean([r["step"]["loss"] for r in ranks]), metrics["loss"],
                               rtol=LOSS_RTOL)
    for r in ranks:
        assert r["sharded"]
        np.testing.assert_allclose(r["step"]["grad_norm"], metrics["grad_norm"], rtol=1e-5)
        _assert_weights(r["after"], after)
        _assert_weights(r["ema_after"], ema_after)


def test_fsdp_checkpoint_restores_in_a_fresh_pair_and_one_process(fsdp_run):
    tmp, first, second = fsdp_run
    saved = first[0]["fit_params"]
    for r in (*first, *second):
        _assert_weights(r["restored"] if "restored" in r else r["fit_params"], saved, atol=0)
    restored = CheckpointManager.load_path(os.path.join(str(tmp), "first_last.pt"))
    cfg = Config(**TRAIN)
    state = Trainer(_system(cfg), cfg, mesh=None).init_state(10)
    assert Trainer._from_ckpt(state, restored) == 1
    _assert_weights(tpar.full_state_dict(state.module), saved, atol=0)
    assert CheckpointManager.load_path(_fsdp_last(tmp))["epoch"] == 2
    for r in second:
        assert r["epoch"] == 1 and r["resumed_step"] > restored["step"]
        _assert_weights(r["restored_ema"], restored["ema_params"], atol=0)
        for i, s in restored["opt_state"]["state"].items():
            torch.testing.assert_close(r["restored_opt"]["state"][i]["exp_avg"], s["exp_avg"])


def test_tp_forward_and_gradients_equal_the_whole_module(tp_run):
    for r in tp_run:
        for name, f in r["forward"].items():
            assert f["err"] <= FORWARD_ATOL, (name, f)
            assert f["grad_err"] <= 1.0, (name, f)
            assert f["sharded"] == (name != "EPiC"), name
        assert r["gpt_cache_width"] == 16  # one of the two heads of 16


def test_tp_step_and_checkpoints_equal_one_process(tp_run, single_step):
    metrics, after, ema_after = single_step
    np.testing.assert_allclose(tp_run[0]["step"]["loss"], metrics["loss"], rtol=LOSS_RTOL)
    for r in tp_run:
        np.testing.assert_allclose(r["step"]["grad_norm"], metrics["grad_norm"], rtol=1e-5)
        _assert_weights(r["after"], after)
        _assert_weights(r["ema_after"], ema_after)
        _assert_weights(r["round_trip"], r["after"], atol=0)
        _assert_weights(r["from_single"], r["single_after"], atol=0)
        assert r["flax_refused"]


@pytest.fixture(scope="module")
def dropout_run(tmp_path_factory):
    return _spawn(_dropout_worker, tmp_path_factory.mktemp("dropout"))


def _single(cfg_kw):
    cfg = Config(**cfg_kw)
    return _one_step(Trainer(_system(cfg), cfg, mesh=None), _step_batch())[:3]


def test_dropout_steps_under_a_mesh_equal_one_process(dropout_run):
    """With dropout 0.1 every rank draws each mask at the global shape from
    the shared generator and keeps its share: the data-parallel step (the
    ranks' rows) and the tensor_parallel=2 step (the ranks' heads of the
    attention-probability masks) equal the one-process dropout step, to
    the tolerances of the dropout-free steps.  Drawing at the local shape,
    the ranks of one data axis would drop the same pattern on different
    jets, and a model rank's masks would differ from the unsharded ones."""
    metrics, after, ema_after = _single(TRAIN_DROPOUT)
    ranks = dropout_run
    assert [r["dp_mesh"] for r in ranks] == [(2, 1)] * 2
    assert [r["tp_mesh"] for r in ranks] == [(1, 2)] * 2
    np.testing.assert_allclose(np.mean([r["dp"][0]["loss"] for r in ranks]), metrics["loss"],
                               rtol=LOSS_RTOL)
    for r in ranks:
        for name in ("dp", "tp"):
            step, w, ema = r[name]
            if name == "tp":
                np.testing.assert_allclose(step["loss"], metrics["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(step["grad_norm"], metrics["grad_norm"], rtol=1e-5)
            _assert_weights(w, after)
            _assert_weights(ema, ema_after)


def test_bf16_tensor_parallel_step_equals_one_process(dropout_run):
    """A bf16 step at tensor_parallel=2 against the one-process bf16 step:
    the loss and the gradient norm within the bf16 rounding of the
    row-parallel all-reduce; the weights after the update equal on most
    entries, and within Adam's step where a gradient near 0 rounded apart."""
    metrics, after, _ = _single(TRAIN_BF16)
    for r in dropout_run:
        step, w, _ = r["tp_bf16"]
        np.testing.assert_allclose(step["loss"], metrics["loss"], rtol=BF16_TP_LOSS_RTOL)
        np.testing.assert_allclose(step["grad_norm"], metrics["grad_norm"],
                                   rtol=BF16_TP_GRAD_NORM_RTOL)
        assert w.keys() == after.keys()
        lr = TRAIN["lr"]
        off = sum(int(((w[k] - after[k]).abs() > WEIGHT_ATOL).sum()) for k in after)
        assert off <= (1 - BF16_TP_WEIGHTS_EQUAL) * sum(t.numel() for t in after.values())
        for k in after:  # Adam's first step moves a weight by at most ~lr
            torch.testing.assert_close(w[k], after[k], atol=2 * lr + WEIGHT_ATOL, rtol=0,
                                       msg=k)
