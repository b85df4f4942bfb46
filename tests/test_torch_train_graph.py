"""The trainer's captured route (`train/trainer.py`) on the CPU, where every
step is eager: each system's loss split into its draws and the computation
that takes them, held to the draws made where the bridges need them (the
loss before the split) to the bit; the route predicate (one device and
data meshes over NCCL captured; FSDP, tensor-parallel and gloo meshes,
dropout and an unsplit loss eager) and its counters;
the copy of a replay's outputs; the optimizer's form across a checkpoint
written on the card.  The captured steps themselves run on the card only
(`chip_smoke.py:train_graph_check`)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data import packing
from multimodal_flows_tpu_torch.data.datasets import jet_set_to_seq
from multimodal_flows_tpu_torch.data.packing import PackedJets
from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
from multimodal_flows_tpu_torch.train import systems
from multimodal_flows_tpu_torch.train import trainer as trainer_mod
from multimodal_flows_tpu_torch.train.trainer import Trainer
from multimodal_flows_tpu_torch.utils import profiling

torch.set_num_threads(2)

SMALL = dict(model="ParticleFormer", n_embd=16, n_inner=32, n_layer=1, n_layer_fused=1,
             n_head=2, vocab_size=9, dim_continuous=3, max_num_particles=12, batch_size=4,
             use_ema_weights=True)
MODELS = {"MMF": SMALL, "CFM": dict(SMALL, model="KinFormer"),
          "MJB": dict(SMALL, model="FlavorFormer"), "GPT": SMALL}
MULTS = [5, 9, 3, 7, 12, 4, 6, 8, 2]
SEED = 11


def _system(kind, **kw):
    return systems.build_system(Config(**MODELS[kind], **kw), kind, device="cpu",
                                generator=torch.Generator().manual_seed(0))


def _batch(kind, packed, mults=MULTS, seed=3):
    """Padded jets (sources left to the loss), packed rows of 24, or the
    GPT's token sequences, as CPU tensors."""
    D = SMALL["max_num_particles"]
    rng = np.random.default_rng(seed)
    mask = (np.arange(D)[None] < np.asarray(mults)[:, None]).astype(np.int32)[..., None]
    x = (rng.normal(size=(len(mults), D, 3)) * mask).astype(np.float32)
    k = (rng.integers(1, 9, (len(mults), D, 1)) * mask).astype(np.int32)
    jets = MultiModal(continuous=x, discrete=k, mask=mask)
    if kind == "GPT":
        return DataCoupling(target=jet_set_to_seq(jets, SMALL["vocab_size"])).map(torch.from_numpy)
    if packed:
        rows, leftover = packing.pack_multimodal(jets, 24)
        assert not len(leftover)
        return rows.to("cpu")
    return DataCoupling(source=MultiModal(mask=mask), target=jets).map(torch.from_numpy)


def _drawn_as_they_go(system, batch, generator):
    """(t, the bridges' time, x0, k0, xt, kt) with each draw made where the
    bridges need it, from `generator`, in the loss's order: the states of
    the loss before its draws came apart (None for a bridge the system
    lacks)."""
    x1, k1, mask, x0, k0, shape = systems._fields(batch)
    t = systems._sample_time(generator, shape, system.config.time_eps, mask.device)
    time = systems._token_time(t, batch.segments) if isinstance(batch, PackedJets) else t
    cont, disc = system._bridges()
    xt = kt = None
    if cont is not None and x0 is None:
        x0 = cont.draw_source(generator, x1, mask)
    if disc is not None and k0 is None:
        k0 = disc.draw_source(generator, k1.shape, mask)
    if cont is not None:
        xt = cont.sample(generator, time, x0, x1)
    if disc is not None:
        kt = disc.sample(generator, time, k0, k1)
    return t, time, x0, k0, xt, kt


def _loss_and_grads(system, loss_fn):
    system.module.zero_grad(set_to_none=True)
    loss, metrics = loss_fn()
    loss.backward()
    return ({k: v.detach() for k, v in metrics.items()},
            {n: p.grad for n, p in system.module.named_parameters()})


def _same(a, b) -> bool:
    return (a is None and b is None) or (a is not None and b is not None and torch.equal(a, b))


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
@pytest.mark.parametrize("kind", ["MMF", "CFM", "MJB"])
def test_the_split_loss_draws_and_computes_as_before(monkeypatch, kind, packed):
    """`loss_draws` takes from the generator what the bridges took as they
    went, in the same order, and `loss_fn` (the split) gives the loss, its
    terms and every gradient of the states drawn as they go, to the bit."""
    system, batch = _system(kind), _batch(kind, packed)
    gen_before, gen = torch.Generator().manual_seed(SEED), torch.Generator().manual_seed(SEED)
    t, time, x0, k0, xt, kt = _drawn_as_they_go(system, batch, gen_before)
    draws = system.loss_draws(batch, gen)
    assert torch.equal(gen.get_state(), gen_before.get_state())
    after = system._bridge_states(batch, draws)
    for name, a, b in zip(("t", "time", "x0", "xt", "kt"), (t, time, x0, xt, kt), after):
        assert _same(a, b), name

    split = _loss_and_grads(system, lambda: system.loss_fn(batch,
                                                           torch.Generator().manual_seed(SEED)))
    # the states drawn as they go, injected where the split's draws are used
    monkeypatch.setattr(systems, "_sample_time", lambda *a, **kw: t)
    for bridge, source, state in zip(system._bridges(), (x0, k0), (xt, kt)):
        if bridge is not None:
            monkeypatch.setattr(bridge, "draw_source", lambda *a, v=source, **kw: v)
            monkeypatch.setattr(bridge, "sample", lambda *a, v=state, **kw: v)
    before = _loss_and_grads(system, lambda: system.loss_fn(batch, None))
    assert split[0].keys() == before[0].keys()
    for name in split[0]:
        assert torch.equal(split[0][name], before[0][name]), name
    for name, g in split[1].items():
        assert _same(g, before[1][name]), name


def test_dropout_masks_follow_the_loss_draws_on_one_generator():
    """At dropout > 0 the forward's masks come from the generator after the
    loss's draws: `loss_fn` is `loss_from_draws` on the generator that
    made the draws."""
    system, batch = _system("MMF", dropout=0.1), _batch("MMF", True)
    assert system.dropout_rate == 0.1
    whole = system.loss_fn(batch, torch.Generator().manual_seed(SEED))[0]
    gen = torch.Generator().manual_seed(SEED)
    parts = system.loss_from_draws(batch, system.loss_draws(batch, gen), generator=gen)[0]
    fresh = system.loss_from_draws(batch, system.loss_draws(
        batch, torch.Generator().manual_seed(SEED)), generator=torch.Generator().manual_seed(5))[0]
    assert torch.equal(whole, parts) and not torch.equal(whole, fresh)


def test_the_gpt_loss_draws_nothing_at_dropout_zero():
    system, batch = _system("GPT"), _batch("GPT", False)
    gen = torch.Generator().manual_seed(SEED)
    state = gen.get_state()
    assert system.dropout_rate == 0 and system.loss_draws(batch, gen) == {}
    loss = system.loss_fn(batch, gen)[0]
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(loss, system.loss_from_draws(batch, {})[0])
    assert _system("GPT", dropout_res=0.1).dropout_rate == 0.1


def _graph_counters():
    return {k: v for k, v in profiling.peek_counters().items() if k.startswith("train_graph.")}


def _cuda_like(trainer, state, monkeypatch):
    """What `_graphable` reads of a trainer on one CUDA device with a
    capturable Adam, on the CPU: the device, the optimizer's flag and no
    capture running."""
    monkeypatch.setattr(trainer, "device", torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    for group in state.optimizer.param_groups:
        monkeypatch.setitem(group, "capturable", True)


def _mesh_of_one(monkeypatch):
    """A data mesh of one rank (no process group: the all-reduce a no-op)."""
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda flat, group=None: None)
    return SimpleNamespace(mesh_dim_names=("data",), size=lambda dim=None: 1,
                           get_group=lambda axis: None)


#: what each case changes of a trainer as on one CUDA device: the system's
#: dropout, the mesh (a data mesh of one rank), its layout and its backend
ROUTES = {"cpu": {}, "mesh": dict(mesh=True), "fsdp_mesh": dict(mesh=True, fsdp=True),
          "tp_mesh": dict(mesh=True, tensor_parallel=2),
          "gloo_mesh": dict(mesh=True, backend="gloo"), "dropout": dict(dropout=0.1),
          "dropout_mesh": dict(mesh=True, dropout=0.1), "no_split": {}}


class _Unsplit:
    """A system whose loss draws as it goes: `loss_fn` and no `loss_draws`."""

    def __init__(self, system):
        self.module, self.device, self.config = system.module, system.device, system.config
        self.loss_fn = system.loss_fn


@pytest.mark.parametrize("route", list(ROUTES))
def test_the_route_predicate_and_its_counters(monkeypatch, route):
    """A data mesh over NCCL is captured as one device is; the CPU, an FSDP
    or tensor-parallel mesh, a mesh over gloo, dropout > 0 (with a mesh or
    without) and a loss without `loss_draws` take the eager route: on a
    trainer that is otherwise as on one CUDA device the predicate says yes
    for the data mesh alone (and yes without the case's difference), and
    CPU steps count as eager, none captured or replayed."""
    case = ROUTES[route]
    system = _system("MMF", **({"dropout": case["dropout"]} if "dropout" in case else {}))
    mesh = _mesh_of_one(monkeypatch) if case.get("mesh") else None
    if route == "no_split":
        system = _Unsplit(system)
    trainer = Trainer(system, system.config, mesh=mesh)
    state = trainer.init_state(4)
    assert not trainer._graphable(state)
    if route != "cpu":
        with monkeypatch.context() as m:
            _cuda_like(trainer, state, m)
            m.setattr(torch.distributed, "get_backend",
                      lambda group=None: case.get("backend", "nccl"))
            for key in ("fsdp", "tensor_parallel"):
                if key in case:
                    m.setattr(trainer.config, key, case[key])
            assert trainer._graphable(state) == (route == "mesh")
            m.setattr(trainer, "mesh", None)
            m.setattr(trainer.system.config, "dropout", 0.0)
            assert trainer._graphable(state) == (route != "no_split")

    batch = _batch("MMF", True)
    profiling.take_counters()
    for _ in range(3):
        trainer._train_step(state, batch, torch.Generator().manual_seed(SEED))
    assert _graph_counters() == {"train_graph.captures": 0, "train_graph.replays": 0,
                                 "train_graph.eager_steps": 3}
    assert state.step == 3 and not state.graphs


def test_two_successive_steps_return_outputs_of_their_own():
    """Each step's metrics are tensors of its own: a later step leaves them
    as they were (eager steps here; a replay's are copied out of the
    graph's outputs, below)."""
    system = _system("MMF")
    trainer = Trainer(system, system.config)
    state = trainer.init_state(4)
    batch = _batch("MMF", True)
    first = trainer._train_step(state, batch, torch.Generator().manual_seed(1))
    kept = {k: v.clone() for k, v in first.items()}
    second = trainer._train_step(state, batch, torch.Generator().manual_seed(2))
    assert set(first) == set(second) == {"loss", "loss_mse", "loss_ce", "weight_mse",
                                         "weight_ce", "grad_norm"}
    assert all(torch.equal(first[k], kept[k]) for k in first)
    assert not torch.equal(first["loss"], second["loss"])
    ptrs = {v.data_ptr() for v in first.values()}
    assert not ptrs & {v.data_ptr() for v in second.values()}


def test_a_replay_returns_a_copy_of_the_graph_outputs():
    """`_StepGraph.replay` (a stand-in graph that rewrites its outputs in
    place): each replay's metrics are a copy that the next replay leaves
    alone, the replay counted, the capture's counts added, and the
    parameters' `.grad` set back to the graph's gradients."""
    outputs = {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(2.0)}
    step = trainer_mod._StepGraph.__new__(trainer_mod._StepGraph)
    step.graphs = [SimpleNamespace(replay=lambda: [v.add_(1.0) for v in outputs.values()])]
    step.between = []
    step.outputs, step.counts = outputs, {"train_graph.eager_steps": 0}
    param, grad = torch.nn.Parameter(torch.zeros(3)), torch.ones(3)
    step.params, step.grads = [param], [grad]
    param.grad = torch.full((3,), 7.0)
    profiling.take_counters()
    a = step.replay()
    assert param.grad is grad
    b = step.replay()
    assert (float(a["loss"]), float(a["grad_norm"]), float(b["loss"])) == (2.0, 3.0, 3.0)
    assert _graph_counters()["train_graph.replays"] == 2


class _StandInGraph:
    """What `_StepGraph` calls of a `torch.cuda.CUDAGraph`, logged."""

    def __init__(self, log):
        self.log, self.name = log, f"graph {sum(e.startswith('begin') for e in log)}"

    def capture_begin(self, pool):
        self.log.append(f"begin {self.name}")

    def capture_end(self):
        self.log.append(f"end {self.name}")

    def replay(self):
        self.log.append(f"replay {self.name}")


def test_a_mesh_step_runs_its_all_reduce_between_two_graphs(monkeypatch):
    """On a data mesh the capture of `_step_of_draws` ends its first graph
    at the gradients' all-reduce, which it does not run, and captures the
    rest into a second graph (stand-in graphs on the CPU); a replay runs
    the first graph, the all-reduce on the flattened gradients, then the
    second.  Outside a capture the all-reduce runs in place."""
    log = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: _StandInGraph(log))
    system = _system("MMF")
    trainer = Trainer(system, system.config, mesh=_mesh_of_one(monkeypatch))
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda flat, group=None: log.append(f"all-reduce {flat.numel()}"))
    state = trainer.init_state(4)
    batch = _batch("MMF", True)
    draws = system.loss_draws(batch, torch.Generator().manual_seed(SEED))
    n_params = sum(p.numel() for p in system.module.parameters())
    trainer._step_of_draws(state, batch, draws)
    assert log == [f"all-reduce {n_params}"]

    log.clear()
    step = trainer_mod._StepGraph.__new__(trainer_mod._StepGraph)
    step.graphs, step.between, step.pool = [], [], None
    step._begin()
    trainer._capture = step
    trainer._step_of_draws(state, batch, draws)
    step.graphs[-1].capture_end()
    assert log == ["begin graph 0", "end graph 0", "begin graph 1", "end graph 1"]
    assert len(step.between) == 1
    step.outputs, step.counts = {"loss": torch.tensor(1.0)}, {}
    step.params = list(system.module.parameters())
    step.grads = [p.grad for p in step.params]
    monkeypatch.setattr(trainer_mod, "add_counts", lambda counts: None)
    log.clear()
    step.replay()
    assert log == ["replay graph 0", f"all-reduce {n_params}", "replay graph 1"]


def test_the_graph_key_is_the_batch_fields_names_shapes_and_dtypes():
    system = _system("MMF")
    cpu = torch.device("cpu")
    padded, rows = _batch("MMF", False), _batch("MMF", True)
    key = trainer_mod._graph_key(system.module, padded, cpu)
    assert key == trainer_mod._graph_key(system.module, _batch("MMF", False, seed=4), cpu)
    assert [name for name, _, _ in key[3]] == [".source.mask", ".target.continuous",
                                               ".target.discrete", ".target.mask"]
    narrower = DataCoupling(source=padded.source.map(lambda a: a[:, :8]),
                            target=padded.target.map(lambda a: a[:, :8]))
    others = [trainer_mod._graph_key(system.module, b, cpu) for b in (
        rows, narrower, padded[torch.arange(4)],
        DataCoupling(source=padded.target, target=padded.target))]
    others.append(trainer_mod._graph_key(_system("MMF").module, padded, cpu))
    assert len({key, *others}) == 6


def test_a_checkpoint_of_the_card_form_resumes_on_the_cpu(tmp_path):
    """A checkpoint whose optimizer is a fused, capturable Adam with its
    rate a tensor (the card's form) restores into a CPU trainer, which
    keeps its own form (float rate, neither fused nor capturable), and its
    next update equals the one of the run it was taken from."""
    system = _system("MMF")
    trainer = Trainer(system, system.config)
    state = trainer.init_state(4)
    batch = _batch("MMF", True)
    for s in range(2):
        trainer._train_step(state, batch, torch.Generator().manual_seed(s))
    ckpt = trainer._to_ckpt(state, epoch=1)
    for group in ckpt["opt_state"]["param_groups"]:
        group.update(capturable=True, fused=True, lr=torch.tensor(group["lr"]))
    for s in ckpt["opt_state"]["state"].values():
        s["step"] = s["step"].to(torch.float32)
    torch.save(ckpt, tmp_path / "card.pt")

    fresh = _system("MMF")
    resumed_trainer = Trainer(fresh, fresh.config)
    resumed = resumed_trainer.init_state(4)
    resumed.graphs["stale"] = None
    assert Trainer._from_ckpt(resumed, torch.load(tmp_path / "card.pt")) == 1
    assert not resumed.graphs and resumed.step == 2
    assert all(not g["capturable"] and not g["fused"] and isinstance(g["lr"], float)
               for g in resumed.optimizer.param_groups)
    outs = [t._train_step(s, batch, torch.Generator().manual_seed(2))
            for t, s in ((trainer, state), (resumed_trainer, resumed))]
    assert torch.equal(outs[0]["loss"], outs[1]["loss"])
    for (n, p), q in zip(system.module.named_parameters(), fresh.module.parameters()):
        assert torch.equal(p, q), n
