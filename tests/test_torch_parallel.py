"""The port's meshes without a second process: the host-side batch slicing
against the JAX package's, the mesh constructors' errors, the data-parallel
loss on simulated ranks against the JAX package's single-device loss on
the whole batch (the packed rows of the ranks hold unequal numbers of
jets), the sharded draws of the samplers, and the layout-free helpers on
an unsharded module.  The runs over two real ranks are in
`test_torch_parallel_mp.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.config import Config as JaxConfig
from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
from multimodal_flows_tpu.parallel import mesh as jmesh
from multimodal_flows_tpu.train import systems as jsystems
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.convert import load_flax_params, params_from_flax
from multimodal_flows_tpu_torch.data import packing
from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
from multimodal_flows_tpu_torch.parallel import mesh
from multimodal_flows_tpu_torch.parallel import tensor_parallel as tpar
from multimodal_flows_tpu_torch.train import systems
from multimodal_flows_tpu_torch.train.systems import _rank_total
from multimodal_flows_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

# fp32 on both sides; sums in another order
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-9

SMALL = dict(model="ParticleFormer", n_embd=32, n_inner=64, n_layer=1, n_layer_fused=1,
             n_head=2, vocab_size=9, dim_continuous=3, max_num_particles=24,
             multitask_loss="time-weighted", sigma=0.0)


# ------------------------------------------------------ host-side slicing


@pytest.mark.parametrize("n,n_proc,idx", [(8, 1, 0), (8, 2, 0), (8, 2, 1), (12, 4, 3),
                                          (64, 8, 5)])
def test_batch_slicing_equals_jax(n, n_proc, idx):
    a = np.arange(n * 3).reshape(n, 3)
    assert mesh.process_batch_slice(n, n_proc, idx) == jmesh.process_batch_slice(n, n_proc, idx)
    np.testing.assert_array_equal(mesh.local_batch_shard(a, 0, n_proc, idx),
                                  jmesh.local_batch_shard(a, 0, n_proc, idx))
    b = a.T.copy()
    np.testing.assert_array_equal(mesh.local_batch_shard(b, 1, n_proc, idx),
                                  jmesh.local_batch_shard(b, 1, n_proc, idx))


def test_uneven_batch_raises_and_one_process_helpers():
    with pytest.raises(ValueError, match="must divide evenly over 3 processes"):
        mesh.process_batch_slice(8, 3, 0)
    # without a process group: one process holding everything
    assert mesh.world_size() == 1 and mesh.rank() == 0 and mesh.is_primary()
    assert mesh.process_slice(10) == slice(0, 10) == jmesh.process_slice(10)
    assert mesh.process_batch_slice(10) == slice(0, 10)
    assert mesh.data_axis_size(None) == 1 and mesh.data_rows(16, None) is None
    assert mesh.data_group(None) is None and mesh.model_axis_size(None) == 1
    assert mesh.broadcast_object({"a": 1}) == {"a": 1}
    mesh.sync_hosts()
    coupling = DataCoupling(target=MultiModal(mask=np.ones((4, 3, 1), np.int32)))
    assert len(mesh.shard_coupling(coupling, None)) == 4
    assert mesh.shard_state(coupling.target, None, "cpu").mask.shape == (4, 3, 1)
    assert mesh.init_from_env("cpu") == torch.device("cpu")


def test_mesh_constructors_raise_at_world_size_one():
    with pytest.raises(ValueError, match="1 devices not divisible by model=2"):
        mesh.make_mesh_2d(2)
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.make_mesh("cpu")


# -------------------------------------- the data-parallel loss (the trap)


def _packed_global_batch(seed=7):
    """Packed rows of 24 of small and large jets: the two halves of the
    rows (the ranks of a 2-way data axis) carry unequal jet counts."""
    rng = np.random.default_rng(seed)
    mults = [3, 4, 2, 5, 3, 4, 2, 3, 4, 5, 3, 2, 20, 22, 18, 21]
    D = 24
    mask = (np.arange(D)[None, :] < np.asarray(mults)[:, None]).astype(np.int32)[..., None]
    x = (rng.normal(size=(len(mults), D, 3)) * mask).astype(np.float32)
    k = (rng.integers(1, 9, (len(mults), D, 1)) * mask).astype(np.int32)
    packed, leftover = packing.pack_multimodal(MultiModal(continuous=x, discrete=k, mask=mask),
                                               D)
    assert len(leftover) == 0 and len(packed) % 2 == 0
    t_jets = rng.uniform(0.05, 0.95, packed.jet_valid.shape).astype(np.float32)
    t_tok = np.take_along_axis(t_jets, np.clip(packed.segments, 0, None), axis=1)
    shape = packed.mask.shape[:2]
    xt = (rng.normal(size=shape + (3,)) * packed.mask).astype(np.float32)
    kt = (rng.integers(1, 9, shape + (1,)) * packed.mask).astype(np.int32)
    drift = (rng.normal(size=shape + (3,)) * packed.mask).astype(np.float32)
    return packed, t_jets, t_tok, xt, kt, drift


@pytest.fixture(scope="module")
def mmf_pair():
    jsys = jsystems.MMF(JaxConfig(**SMALL))
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: (np.asarray(a) + rng.normal(size=a.shape) * 0.1)
                          .astype(np.float32),
                          jax.jit(jsys.init_params)(jax.random.PRNGKey(0))["params"])
    tsys = systems.build_system(Config(**SMALL), "MMF", device="cpu")
    load_flax_params(tsys.module, params)
    return jsys, params, tsys


def _jax_packed_loss(jsys, params, packed, t_jets, t_tok, xt, kt, drift):
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
    return [float(r) for r in ref], params_from_flax(grads)


def _rank_losses(tsys, inputs, n_ranks, global_total: bool):
    """Each simulated rank's loss outputs and gradients on its rows, the
    denominators over the global batch (`_rank_total`) or, the trap, over
    the rank's own rows."""
    packed, t_jets, t_tok, xt, kt, drift = inputs
    p = packed.to("cpu")
    B = len(packed)
    outs, grads = [], []
    for r in range(n_ranks):
        rows = mesh.process_batch_slice(B, n_ranks, r)
        total = _rank_total(p.jet_valid.sum(), rows, B) if global_total else None
        tsys.module.zero_grad()
        out = tsys.module.packed_training_loss(
            MultiModal(time=torch.from_numpy(t_tok[rows]), continuous=torch.from_numpy(xt[rows]),
                       discrete=torch.from_numpy(kt[rows]), mask=p.mask[rows]),
            torch.from_numpy(drift[rows]), p.discrete[rows], torch.from_numpy(t_jets[rows]),
            p.segments[rows], p.jet_valid[rows], total)
        out[0].backward()
        outs.append([float(o) for o in out])
        grads.append({n: q.grad.clone() for n, q in tsys.module.named_parameters()})
    return outs, grads


def test_data_parallel_loss_on_unequal_ranks_equals_jax_on_the_whole_batch(mmf_pair):
    """Two ranks, rows of unequal jet counts: the ranks' mean of the loss,
    of each metric and of the gradients is JAX's single-device value on the
    whole batch; the mean of per-rank weighted means is not."""
    jsys, params, tsys = mmf_pair
    inputs = _packed_global_batch()
    packed = inputs[0]
    half = len(packed) // 2
    jets = [int(packed.jet_valid[:half].sum()), int(packed.jet_valid[half:].sum())]
    assert jets[0] != jets[1]
    ref, ref_grads = _jax_packed_loss(jsys, params, *inputs)

    outs, grads = _rank_losses(tsys, inputs, 2, global_total=True)
    mean = np.mean(np.asarray(outs), axis=0)
    np.testing.assert_allclose(mean[:3], ref[:3], rtol=LOSS_RTOL, atol=1e-7)
    np.testing.assert_allclose(mean[3:], ref[3:], rtol=LOSS_RTOL, atol=1e-7)
    for name, g in ref_grads.items():
        avg = (grads[0][name] + grads[1][name]) / 2
        scale = max(float(g.abs().max()), 1e-30)
        np.testing.assert_allclose(avg.numpy(), g.numpy(), rtol=0,
                                   atol=GRAD_RTOL * scale + GRAD_FLOOR, err_msg=name)

    trap, _ = _rank_losses(tsys, inputs, 2, global_total=False)
    trap_loss = float(np.mean([o[0] for o in trap]))
    assert abs(trap_loss - ref[0]) > 1e-3 * abs(ref[0])


@pytest.mark.parametrize("kind,model", [("MMF", "ParticleFormer"), ("CFM", "KinFormer"),
                                        ("MJB", "FlavorFormer")])
def test_loss_fn_on_ranks_averages_to_the_one_device_loss(kind, model):
    """`loss_fn(rows=)` on each rank's rows, with every draw made at the
    global batch's shape from one generator state: the ranks' mean loss and
    gradients equal the one-device `loss_fn` on the whole batch, packed and
    padded."""
    cfg = Config(**dict(SMALL, model=model))
    system = systems.build_system(cfg, kind, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    inputs = _packed_global_batch(seed=11)
    for batch in (inputs[0].to("cpu"), None):
        if batch is None:  # padded jets: the packed rows' states as jets
            x = torch.from_numpy(inputs[3])
            mask = inputs[0].to("cpu").mask
            k = torch.from_numpy(inputs[4])
            batch = DataCoupling(source=MultiModal(mask=mask),
                                 target=MultiModal(continuous=x, discrete=k, mask=mask))
        B = len(batch)

        def run(rows):
            system.module.zero_grad()
            loss = system.loss_fn(batch, torch.Generator().manual_seed(5), rows=rows)[0]
            loss.backward()
            return float(loss), [q.grad.clone() for q in system.module.parameters()]

        ref_loss, ref_grads = run(None)
        parts = [run(mesh.process_batch_slice(B, 2, r)) for r in range(2)]
        np.testing.assert_allclose(np.mean([p[0] for p in parts]), ref_loss, rtol=LOSS_RTOL)
        for i, g in enumerate(ref_grads):
            avg = (parts[0][1][i] + parts[1][1][i]) / 2
            scale = max(float(g.abs().max()), 1e-30)
            np.testing.assert_allclose(avg.numpy(), g.numpy(), rtol=0,
                                       atol=GRAD_RTOL * scale + GRAD_FLOOR)


def test_gpt_loss_on_ranks_averages_to_the_one_device_loss():
    cfg = Config(n_embd=16, n_inner=32, n_layer=1, n_head=2, vocab_size=9, max_seq_length=6)
    gpt = systems.build_system(cfg, "GPT", device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, 9, size=(8, 8))
    tokens[:, 0], tokens[:, -1] = 10, 11
    tokens[:4, 3:] = 12  # PAD: the halves carry unequal target counts
    batch = DataCoupling(target=MultiModal(discrete=torch.from_numpy(tokens)))
    ref = float(gpt.loss_fn(batch)[0])
    parts = [float(gpt.loss_fn(batch, rows=mesh.process_batch_slice(8, 2, r))[0])
             for r in range(2)]
    np.testing.assert_allclose(np.mean(parts), ref, rtol=LOSS_RTOL)


# ------------------------------------------------------- sharded sampling


@pytest.mark.parametrize("kind,method", [
    ("MMF", "tauleap"), ("MMF", "euler"), ("MJB", "tauleap-bernouilli"),
    ("MJB", "jump_or_stay"), ("CFM", "euler_maruyama")])
def test_sharded_draws_rebuild_the_unsharded_trajectory(kind, method):
    """`simulate(draw_rows=)` on each half of a batch, every draw at the
    batch's shape: the halves put together are the whole batch's
    trajectory, for the one-uniform tau-leap and the per-step draws."""
    model = {"MMF": "ParticleFormer", "MJB": "FlavorFormer", "CFM": "KinFormer"}[kind]
    cfg = Config(**dict(SMALL, model=model, hybrid_solver=method if kind == "MMF" else "tauleap",
                        markov_jump_solver=method if kind == "MJB" else "tauleap-poisson"))
    system = systems.build_system(cfg, kind, device="cpu",
                                  generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    B, D = 8, 24
    mask = torch.from_numpy((np.arange(D)[None, :] < rng.integers(3, D, B)[:, None])
                            .astype(np.int32)[..., None])
    src = MultiModal(time=torch.full((B,), cfg.time_eps),
                     continuous=torch.randn((B, D, 3)) * mask,
                     discrete=torch.randint(1, 9, (B, D, 1), dtype=torch.int32) * mask,
                     mask=mask)
    kw = dict(method=method) if kind == "CFM" else {}

    def run(rows):
        part = src if rows is None else src[rows]
        return system.simulate(part, 4, generator=torch.Generator().manual_seed(3),
                               draw_rows=None if rows is None else (B, rows), **kw)

    whole = run(None)
    halves = MultiModal.concat([run(mesh.process_batch_slice(B, 2, r)) for r in range(2)])
    for field in ("continuous", "discrete"):
        a, b = getattr(halves, field), getattr(whole, field)
        if a is not None:
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# -------------------------------------------- layouts on one process


def test_unsharded_helpers_are_the_plain_ones():
    """On an unsharded module the full state dicts are the module's and the
    optimizer's own, loading them back is `load_state_dict`, and the global
    gradient norm is the plain one."""
    cfg = Config(**SMALL)
    system = systems.build_system(cfg, "MMF", device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    module = system.module
    assert not tpar.is_sharded(module)
    opt = torch.optim.Adam(module.parameters(), lr=1e-3)
    for p in module.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    sd = tpar.full_state_dict(module)
    assert sd.keys() == module.state_dict().keys()
    osd = tpar.full_optimizer_state_dict(module, opt)
    plain = opt.state_dict()
    assert osd["param_groups"] == plain["param_groups"]
    for i, s in plain["state"].items():
        for k, v in s.items():
            torch.testing.assert_close(osd["state"][i][k], v)
    other = systems.build_system(cfg, "MMF", device="cpu",
                                 generator=torch.Generator().manual_seed(9)).module
    tpar.load_full_state_dict(other, sd)
    for a, b in zip(other.parameters(), module.parameters()):
        torch.testing.assert_close(a, b)
    grads = [p.grad for p in module.parameters()]
    torch.testing.assert_close(tpar.grad_norm(list(module.parameters()), grads),
                               torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))))


def test_trainer_without_process_group_has_no_mesh():
    cfg = Config(**SMALL, mesh_shape={"data": 8})
    system = systems.build_system(cfg, "MMF", device="cpu")
    trainer = Trainer(system, cfg)
    assert trainer.mesh is None
    state = trainer.init_state(4)
    assert not tpar.is_sharded(state.module)
