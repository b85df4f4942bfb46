"""The port's spans and counters (`utils/profiling.py`) on the CPU: the
no-op when tracing is off, nesting and the bounded buffer, the profiler's
clock, the spans of the sampler, the GPT decode and the trainer, the
counters behind `take_counters`, and the benchmark's readers of the spans
(`bench_torch/metrics/*_host_*.py`) on a hand-built trace."""

import ast
import importlib
import inspect
import sys
import time
import tracemalloc
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data import packing
from multimodal_flows_tpu_torch.data.datasets import ArrayDataset
from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
from multimodal_flows_tpu_torch.ops import btc_attention  # noqa: F401 (declares k1.*)
from multimodal_flows_tpu_torch.sampling import generator as gen_mod
from multimodal_flows_tpu_torch.train import systems
from multimodal_flows_tpu_torch.train.gpt import GPT
from multimodal_flows_tpu_torch.train.trainer import Trainer
from multimodal_flows_tpu_torch.utils import profiling
from multimodal_flows_tpu_torch.utils.profiling import Span

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench_torch.harness import read_metric  # noqa: E402

torch.set_num_threads(2)

TINY = dict(model="ParticleFormer", n_embd=16, n_inner=32, n_layer=1, n_layer_fused=1,
            n_head=2, vocab_size=9, dim_continuous=3, max_num_particles=20)
#: how far a span's stamps lie from its profiler range's, the median of a
#: run of spans (the range opens just before the first stamp and closes
#: just after the second; a busy host can preempt a few of them longer)
CLOCK_NS = 100_000
#: how far a stamp may lie outside its range: the profiler converts its
#: own clock to the Unix epoch's, to within a few microseconds
CONVERT_NS = 10_000


@pytest.fixture
def spans():
    """Spans recorded without a profiler for the test, the buffer empty
    before and after."""
    profiling.take_spans()
    profiling.record_spans(True)
    try:
        yield profiling.take_spans
    finally:
        profiling.record_spans(False)
        profiling.take_spans()
        profiling.take_counters()


def _pad_masks(mults, D):
    return (np.arange(D)[None, :] < np.asarray(mults)[:, None]).astype(np.int64)[..., None]


def _children(spans, parent):
    return [s.name for s in sorted(spans, key=lambda s: s.start_ns) if s.parent == parent]


# ------------------------------------------------------------ the facility

def test_span_is_the_shared_no_op_when_tracing_is_off(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a span opened a profiler range or called the device")

    monkeypatch.setattr(profiling._autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(time, "time_ns", refuse)
    profiling.take_spans()
    assert profiling.span("a") is profiling.span("b") is profiling._NO_SPAN
    with profiling.span("a"):
        pass
    for _ in range(100):  # let the interpreter's caches settle
        with profiling.span("a"):
            pass
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(20_000):
            with profiling.span("a"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = sum(d.size_diff for d in after.compare_to(before, "filename")
                if d.traceback[0].filename == profiling.__file__)
    assert grown == 0
    assert profiling.take_spans() == []


def test_nested_spans_carry_their_parent_and_request(spans):
    with profiling.span("a"):
        with profiling.span("b"):
            with profiling.span("c"):
                pass
        with profiling.span("d"):
            pass
    with profiling.span("e"):
        pass
    got = spans()
    assert [s.name for s in got] == ["c", "b", "d", "a", "e"]  # the order they ended
    by = {s.name: s for s in got}
    assert [by[n].parent for n in "abcde"] == [None, "a", "b", "a", None]
    assert len({by[n].root for n in "abcd"}) == 1 and by["e"].root != by["a"].root
    assert by["a"].start_ns <= by["b"].start_ns <= by["c"].start_ns <= by["c"].end_ns
    assert by["d"].end_ns <= by["a"].end_ns <= by["e"].start_ns
    assert spans() == []
    reqs = profiling.requests(got, "a")
    assert len(reqs) == 1 and sorted(s.name for s in reqs[0]) == list("abcd")
    assert profiling.requests(got, "a", after_ns=by["a"].start_ns) == []
    assert profiling.requests(got, "b") == []  # not a request's top-level span


def test_the_bounded_buffer_drops_the_oldest_and_counts_them(spans, monkeypatch):
    monkeypatch.setattr(profiling, "_spans", deque(maxlen=3))
    for i in range(5):
        with profiling.span(f"s{i}"):
            pass
    assert [s.name for s in profiling.peek_spans()] == ["s2", "s3", "s4"]
    assert [s.name for s in spans()] == ["s2", "s3", "s4"]
    assert profiling.take_counters()["spans.dropped"] == 2
    assert profiling.take_counters()["spans.dropped"] == 0


def test_a_profiler_session_records_spans_on_its_clock():
    profiling.take_spans()
    torch.autograd.profiler.record_function("warm-up").__enter__().__exit__(None, None, None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            for i in range(20):
                with profiling.span(f"inner{i}"):
                    torch.ones(64, 64).sum()
            time.sleep(0.002)
    with profiling.span("after"):
        pass
    got = profiling.take_spans()
    assert [s.name for s in got] == [f"inner{i}" for i in range(20)] + ["outer"]
    ranges = {e.name(): (e.start_ns(), e.end_ns())
              for e in prof.profiler.kineto_results.events() if e.name() in {s.name for s in got}}
    opens, closes = [], []
    for s in got:
        start, end = ranges[s.name]
        opens.append(s.start_ns - start)
        closes.append(end - s.end_ns)
    # each span lies inside its range, on one clock, and close to its ends
    assert min(opens + closes) > -CONVERT_NS, (opens, closes)
    assert np.median(opens) < CLOCK_NS and np.median(closes) < CLOCK_NS, (opens, closes)


#: every counter of the port, declared by the modules that count them
EVERY_COUNTER = (
    {f"k1.{f}" for f in ("segments", "key_mask", "none")}
    | {f"k1_bf16.{f}" for f in ("segments", "key_mask", "none")}
    | {f"k2.{f}" for f in ("bias_segments", "bias", "bias_key_mask", "key_mask", "none",
                           "causal")}
    | {f"k2_bf16.{f}" for f in ("bias_segments", "bias", "bias_key_mask", "key_mask", "none")}
    | {"attn.plain_dropout.head_major", "attn.plain_dropout.token_major"}
    | {"gpt_decode.graph_steps", "gpt_decode.eager_steps", "gpt_decode.captures"}
    | {"lund.pairs", "lund.forwards"} | {"lund_mlp.kernel", "lund_mlp.plain"}
    | {"part.pairs", "part.forwards"}
    | {"train_graph.captures", "train_graph.replays", "train_graph.eager_steps"}
    | {"spans.dropped"})


def test_take_counters_reads_and_zeroes_every_counter():
    profiling.take_counters()
    counted = {"k1.segments": 3, "k1_bf16.none": 1, "k2.causal": 5, "k2_bf16.bias": 2,
               "attn.plain_dropout.head_major": 4, "gpt_decode.graph_steps": 6,
               "lund.pairs": 7, "lund_mlp.kernel": 8}
    for name, n in counted.items():
        profiling.count(name, n)
    assert profiling.peek_counters() == profiling.peek_counters()  # peeking zeroes nothing
    got = profiling.take_counters()
    assert set(got) == EVERY_COUNTER
    assert {k: v for k, v in got.items() if v} == counted
    assert not any(profiling.peek_counters().values())
    with pytest.raises(KeyError):  # a counter is declared before it counts
        profiling.count("k1.undeclared")


def test_captured_counts_takes_a_capture_back_and_each_replay_adds_it():
    """Around a capture (here a fake one that counts, as a CUDA graph's
    capture runs the step's host code) the helper gives the block's change
    over the whole registry and leaves the registry as it was; each replay
    adds the change."""
    profiling.take_counters()
    profiling.count("k2.key_mask", 2)
    with profiling.captured_counts() as change:
        profiling.count("k2.key_mask", 5)
        profiling.count("lund.pairs", 3)
    assert change == {"k2.key_mask": 5, "lund.pairs": 3}
    assert {k: v for k, v in profiling.peek_counters().items() if v} == {"k2.key_mask": 2}
    profiling.add_counts(change)
    profiling.add_counts(change)
    assert {k: v for k, v in profiling.take_counters().items() if v} == {
        "k2.key_mask": 12, "lund.pairs": 6}


@pytest.mark.parametrize("module,allowed", [
    # the counters' and spans' home sits below every layer of the port
    ("multimodal_flows_tpu_torch.utils.profiling", ()),
    # the GPT system reaches the kernels through its model, never directly
    ("multimodal_flows_tpu_torch.train.gpt", ("config", "data", "models", "train", "utils")),
])
def test_layer_imports_no_module_above_it(module, allowed):
    tree = ast.parse(inspect.getsource(importlib.import_module(module)))
    imported = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    imported += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    ours = [name.split(".")[1] for name in imported
            if name.startswith("multimodal_flows_tpu_torch.")]
    assert all(layer in allowed for layer in ours), ours


# ------------------------------------------------------ spans in the program

def test_generate_packed_spans_one_request(spans):
    cfg = Config(**TINY)
    system = systems.MMF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    mults = np.random.default_rng(1).integers(2, 11, size=40)
    pad_masks = _pad_masks(mults, 20)
    steps = 3
    gen_mod.generate_packed(system, pad_masks, num_timesteps=steps, pack_width=12,
                            batch_size=8, seed=0)
    got = spans()
    (call,) = [s for s in got if s.parent is None]
    assert call.name == "sample.call" and {s.root for s in got} == {call.root}
    row_of, offset_of, n_rows = packing.pack_jets(mults, 12)
    row_mask, row_seg = packing.build_packed_rows(pad_masks, row_of, offset_of, n_rows, 12)
    (masks, _), bs = gen_mod._packed_rows_on_device(system, row_mask, row_seg, 8, None)
    n_batches = len(masks) // bs
    assert n_batches >= 2
    assert _children(got, "sample.call") == (["sample.pack"] + ["sample.batch"] * n_batches
                                             + ["sample.fetch", "sample.unpack",
                                                "sample.finalize"])
    assert [s.parent for s in got if s.name == "solver.step"] == ["sample.batch"] * (
        steps * n_batches)
    for b in (s for s in got if s.name == "sample.batch"):
        inside = [s for s in got if s.name == "solver.step"
                  and b.start_ns <= s.start_ns <= s.end_ns <= b.end_ns]
        assert len(inside) == steps

    # jets wider than a row: the bucketed tail is a call within the call
    gen_mod.generate_packed(system, _pad_masks(np.concatenate([mults, [15, 20]]), 20),
                            num_timesteps=steps, pack_width=12, batch_size=8, seed=0)
    got = spans()
    assert len({s.root for s in got}) == 1
    top = _children(got, "sample.call")
    assert top[0] == "sample.pack" and top[-1] == "sample.finalize"
    assert "sample.call" in top and top.count("sample.unpack") >= 2


def test_gpt_generate_spans_each_decode_step(spans):
    cfg = Config(vocab_size=9, max_seq_length=6, n_embd=32, n_inner=64, n_layer=2, n_head=2)
    system = GPT(cfg, device="cpu")
    system.generate(4, torch.Generator().manual_seed(0))
    got = spans()
    (top,) = [s for s in got if s.parent is None]
    assert top.name == "gpt.generate"
    assert _children(got, "gpt.generate") == ["gpt.decode_step"] * (system.module.seq_len - 1)
    assert {s.root for s in got} == {top.root}


LUND_TINY = dict(TINY, model="KinFormer", use_pairwise=True, n_layer=2, pair_chunk=5,
                 metadata={"mean": [21.0, 0.0, 0.0], "std": [20.0, 0.15, 0.15]})


def _lund_system():
    system = systems.CFM(Config(**LUND_TINY), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        system.module.lambda_u.fill_(1.0)
    return system


def test_the_lund_bias_spans_one_forward_nested_in_each_solver_step(spans):
    system = _lund_system()
    mults = np.random.default_rng(2).integers(2, 11, size=30)
    steps = 3
    gen_mod.generate_packed(system, _pad_masks(mults, 20), num_timesteps=steps,
                            pack_width=12, batch_size=8, seed=0)
    got = spans()
    solver_steps = [s for s in got if s.name == "solver.step"]
    lund = [s for s in got if s.name == "kinformer.lund_bias"]
    assert len(solver_steps) >= 2 * steps and len(lund) == len(solver_steps)
    assert {s.parent for s in lund} == {"solver.step"}
    for s in lund:
        assert any(p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns and p.root == s.root
                   for p in solver_steps)
    assert profiling.take_counters()["lund.forwards"] == len(lund)


@pytest.mark.parametrize("B,T", [(3, 12), (2, 16), (1, 7)])
def test_lund_pairs_count_every_pair_row_of_a_forward_across_chunks(spans, B, T):
    """pair_chunk 5: rows of 12 and 7 end in a short chunk; 16 too."""
    system = _lund_system()
    mask = torch.ones(B, T, 1, dtype=torch.int32)
    state = MultiModal(time=torch.full((B,), 0.5), continuous=torch.randn(B, T, 3), mask=mask)
    profiling.take_counters()
    with torch.no_grad():
        system.module(state, torch.zeros(B, T, dtype=torch.int32))
        system.module(state, torch.zeros(B, T, dtype=torch.int32))
    got = profiling.take_counters()
    assert (got["lund.pairs"], got["lund.forwards"]) == (2 * B * T * T, 2)
    assert [s.name for s in spans()] == ["kinformer.lund_bias"] * 2


def test_the_lund_bias_keeps_nothing_with_tracing_off():
    profiling.take_spans()
    profiling.take_counters()
    system = _lund_system()
    state = MultiModal(time=torch.full((2,), 0.5), continuous=torch.randn(2, 9, 3),
                       mask=torch.ones(2, 9, 1, dtype=torch.int32))
    with torch.no_grad():
        system.module(state)
    assert profiling.take_spans() == []
    got = profiling.take_counters()
    assert (got["lund.pairs"], got["lund.forwards"]) == (0, 0)


def _packed_trainer(tmp_path, **kw):
    rng = np.random.default_rng(14)
    mults = np.clip(rng.poisson(8, 48), 2, 20)
    D = 20
    mask = (np.arange(D)[None, :] < mults[:, None]).astype(np.int32)[..., None]
    x = rng.normal(size=(48, D, 3)).astype(np.float32) * mask
    k = (rng.integers(1, 9, size=(48, D, 1)) * mask).astype(np.int32)
    ds = ArrayDataset(DataCoupling(source=MultiModal(mask=mask),
                                   target=MultiModal(continuous=x, discrete=k, mask=mask)))
    cfg = Config(**dict(TINY, batch_size=8, packed_training=True, pack_width=16,
                        use_ema_weights=True, dir=str(tmp_path), experiment_id="spans", **kw))
    system = systems.build_system(cfg, "MMF", device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    return Trainer(system, cfg), ds


def test_a_train_step_spans_its_phases(spans, tmp_path):
    trainer, ds = _packed_trainer(tmp_path)
    (unit,) = trainer._pack_units(ds)
    state = trainer.init_state(4)
    batch = unit.coupling[np.arange(trainer._packed_row_bs)].to("cpu")
    trainer._train_step(state, batch, torch.Generator().manual_seed(1))
    got = spans()
    (top,) = [s for s in got if s.parent is None]
    assert top.name == "train.step" and {s.root for s in got} == {top.root}
    assert _children(got, "train.step") == ["train.loss", "train.backward", "train.update"]
    assert _children(got, "train.update") == ["train.clip", "train.adam", "train.ema"]
    assert len(got) == 7


def test_the_gradients_all_reduce_is_a_span_on_a_data_mesh(spans, tmp_path, monkeypatch):
    trainer, _ = _packed_trainer(tmp_path)
    reduced = []
    monkeypatch.setattr(torch.distributed, "all_reduce",
                        lambda flat, group=None: reduced.append(flat.numel()))
    trainer.mesh = SimpleNamespace(mesh_dim_names=("data",), size=lambda dim=None: 2,
                                   get_group=lambda axis: None)
    trainer._average_gradients([torch.ones(3), torch.ones(2, 2)])
    assert reduced == [7]
    assert [(s.name, s.parent) for s in spans()] == [("train.allreduce", None)]


def test_fit_spans_the_epochs_work(spans, tmp_path):
    trainer, ds = _packed_trainer(tmp_path, max_epochs=1, physics_eval_every_n_epochs=1,
                                  physics_eval_num_jets=8, physics_eval_num_timesteps=2)
    train_ds, val_ds = ds.split(0.75, seed=0)
    trainer.fit(train_ds, val_ds)
    names = {s.name for s in spans() if s.parent is None}
    assert {"train.step", "train.batch", "train.fetch", "train.validate",
            "train.physics_eval", "train.checkpoint"} <= names


# ------------------------------------------------- the benchmark's readers

def _ctx(work, steps, after=1_500):
    """A traced run's context: the host-and-device window's last device
    record ends at `after`; the device-only window did `work` records and
    `steps` steps."""
    detail = SimpleNamespace(device=[(after - 500, after, "kernel", 1)])
    return SimpleNamespace(detail=detail, trace=SimpleNamespace(device=[]), work=[{}] * work,
                           steps=steps)


def _s(name, start, end, parent, root):
    return Span(name, start, end, parent, root)


def _sampler_spans():
    """One call before the threshold (the host-and-device window's) and
    two after: 2 batches x 2 steps each, steps of 10 and 30 ns; pack,
    unpack and finalize 200 ns a call."""
    out = [_s("sample.call", 100, 900, None, 1), _s("solver.step", 200, 999_999, "sample.batch", 1)]
    for root, t0 in ((2, 2_000), (3, 10_000)):
        out += [_s("sample.call", t0, t0 + 5_000, None, root),
                _s("sample.pack", t0 + 10, t0 + 110, "sample.call", root),
                _s("sample.fetch", t0 + 3_000, t0 + 4_000, "sample.call", root),
                _s("sample.unpack", t0 + 4_000, t0 + 4_050, "sample.call", root),
                _s("sample.finalize", t0 + 4_050, t0 + 4_100, "sample.call", root)]
        for b in range(2):
            out.append(_s("sample.batch", t0 + 200 + b * 1_000, t0 + 900 + b * 1_000,
                          "sample.call", root))
            out += [_s("solver.step", t0 + 300 + b * 1_000, t0 + 310 + b * 1_000,
                       "sample.batch", root),
                    _s("solver.step", t0 + 400 + b * 1_000, t0 + 430 + b * 1_000,
                       "sample.batch", root)]
    return out


def _decode_spans():
    """One call before the threshold, one after: steps of 40, 60, 80 ns."""
    out = []
    for root, t0 in ((1, 0), (2, 2_000)):
        out.append(_s("gpt.generate", t0, t0 + 1_000, None, root))
        out += [_s("gpt.decode_step", t0 + 10 + 100 * i, t0 + 10 + 100 * i + 40 + 20 * i,
                   "gpt.generate", root) for i in range(3)]
    return out


def _train_spans():
    """A step before the threshold, a batch (its own request), then three
    steps of 2 ms: loss 0.5 ms, backward 1 ms."""
    out = [_s("train.step", 500, 900, None, 1), _s("train.batch", 1_500, 1_600, None, 2)]
    for i, t0 in enumerate((2_000, 5_000, 8_000)):
        root = 10 + i
        out += [_s("train.step", t0, t0 + 2_000_000, None, root),
                _s("train.loss", t0 + 1, t0 + 500_001, "train.step", root),
                _s("train.backward", t0 + 500_001, t0 + 1_500_001, "train.step", root),
                _s("train.update", t0 + 1_500_001, t0 + 1_999_000, "train.step", root)]
    return out


READS = {
    # (metric, spans, work, steps): value
    ("sample.step_host_us", "sampler", 2, 4): 0.02,
    ("sample.step_host_us", "decode", 3, 3): 0.06,
    ("sample.call_host_ms", "sampler", 2, 4): 2e-4,
    ("train.step_host_ms", "train", 3, 3): 2.0,
    ("train.loss_host_ms", "train", 3, 3): 0.5,
    ("train.backward_host_ms", "train", 3, 3): 1.0,
}
SPANS = {"sampler": _sampler_spans, "decode": _decode_spans, "train": _train_spans}


@pytest.mark.parametrize("case", sorted(READS), ids=lambda c: f"{c[0]}-{c[1]}")
def test_span_readers_read_the_device_only_window(case, monkeypatch):
    metric, kind, work, steps = case
    monkeypatch.setattr(profiling, "_spans", deque(SPANS[kind]()))
    ctx = _ctx(work, steps)
    assert read_metric(metric, ctx) == pytest.approx(READS[case])
    assert len(profiling.peek_spans()) == len(SPANS[kind]())  # the readers do not drain
    # a count that is not the window's reads nothing
    ctx.steps += 1
    ctx.work = ctx.work + [{}]
    assert read_metric(metric, ctx) is None


@pytest.mark.parametrize("metric", ["sample.step_host_us", "sample.call_host_ms",
                                    "train.step_host_ms", "train.loss_host_ms",
                                    "train.backward_host_ms"])
def test_span_readers_read_nothing_without_spans(metric, monkeypatch):
    monkeypatch.setattr(profiling, "_spans", deque())
    ctx = _ctx(work=2, steps=4)
    assert read_metric(metric, ctx) is None
    monkeypatch.delattr(profiling, "peek_spans")  # a program without spans
    assert read_metric(metric, ctx) is None


# ---------------------------------------------- the readers of the pair bias

def _lund_spans():
    """One call before the threshold; two after, each of one batch of two
    solver steps holding a `kinformer.lund_bias` of 4 and 8 ns."""
    out = [_s("sample.call", 100, 900, None, 1),
           _s("kinformer.lund_bias", 200, 300, "solver.step", 1)]
    for root, t0 in ((2, 2_000), (3, 10_000)):
        out += [_s("sample.call", t0, t0 + 5_000, None, root),
                _s("sample.batch", t0 + 100, t0 + 900, "sample.call", root)]
        for i, length in enumerate((4, 8)):
            a = t0 + 200 + 100 * i
            out += [_s("solver.step", a, a + 50, "sample.batch", root),
                    _s("kinformer.lund_bias", a + 10, a + 10 + length, "solver.step", root)]
    return out


def test_lund_host_us_reads_the_device_only_window(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", deque(_lund_spans()))
    ctx = _ctx(work=2, steps=4)
    assert read_metric("sample.lund_host_us", ctx) == pytest.approx(0.006)
    ctx.work = ctx.work + [{}]
    assert read_metric("sample.lund_host_us", ctx) is None
    monkeypatch.setattr(profiling, "_spans", deque(_sampler_spans()))  # no pair bias
    assert read_metric("sample.lund_host_us", _ctx(work=2, steps=4)) is None


def _record(mults, steps, lund):
    m = np.asarray(mults)
    return dict(count=steps, tokens=int(m.sum()), pairs=int((m ** 2).sum()), kv_tokens=0,
                extra_bytes=0, lund=lund)


def test_lund_pairs_per_real_divides_the_counters_by_the_real_pairs():
    # rows of 8 slots: 2 forwards of 2 rows = 256 pair rows against 2 x 29
    work = [_record([2, 5], 2, {"pairs": 256, "forwards": 2}),
            _record([3], 2, {"pairs": 128, "forwards": 2})]
    ctx = SimpleNamespace(work=work)
    assert read_metric("sample.lund_pairs_per_real", ctx) == pytest.approx(384 / (2 * 29 + 2 * 9))
    ctx.work = [dict(w, lund=None) for w in work]   # a program without the counters
    assert read_metric("sample.lund_pairs_per_real", ctx) is None


def test_lund_pairs_per_real_reads_nothing_from_an_empty_window():
    assert read_metric("sample.lund_pairs_per_real", SimpleNamespace(work=[])) is None
    # a window whose forwards fed no pair through the pair MLP
    work = [_record([2, 5], 2, {"pairs": 0, "forwards": 0})]
    assert read_metric("sample.lund_pairs_per_real", SimpleNamespace(work=work)) is None


def test_lund_mfu_counts_the_pair_mlp_of_each_real_pair():
    from bench_torch import counts
    from bench_torch.reference import kinformer

    cfg = dict(architecture="kinformer", n_embd=256, n_inner=512, n_layer=5, n_head=4,
               dim_continuous=3, compute_dtype="float32")
    assert kinformer.pair_flops(cfg) == 134_144
    work = [_record([40, 30], 100, None)]
    ctx = SimpleNamespace(cfg=cfg, plain_work=work, plain_wall=2.0)
    flops = 100 * (counts.forward_flops(cfg, 70, 2_500) + 134_144 * 2_500)
    assert read_metric("sample.lund_mfu", ctx) == pytest.approx(100 * flops / 2.0 / 495e12)
    ctx.cfg = dict(cfg, architecture="particleformer")   # no pair term
    assert read_metric("sample.lund_mfu", ctx) is None


# ------------------------------------------------- the readers of ParT

def _part_spans():
    """`_lund_spans` with ParT's `part.pair_embed` in each solver step."""
    return [s._replace(name="part.pair_embed") if s.name == "kinformer.lund_bias" else s
            for s in _lund_spans()]


def test_part_pair_host_us_reads_the_device_only_window(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", deque(_part_spans()))
    ctx = _ctx(work=2, steps=4)
    assert read_metric("sample.part_pair_host_us", ctx) == pytest.approx(0.006)
    ctx.work = ctx.work + [{}]
    assert read_metric("sample.part_pair_host_us", ctx) is None
    monkeypatch.setattr(profiling, "_spans", deque(_lund_spans()))  # another pair bias
    assert read_metric("sample.part_pair_host_us", _ctx(work=2, steps=4)) is None
    monkeypatch.delattr(profiling, "peek_spans")  # a program without spans
    assert read_metric("sample.part_pair_host_us", _ctx(work=2, steps=4)) is None


def test_part_mfu_counts_the_pair_embedding_of_each_real_pair():
    import json

    from bench_torch import counts
    from bench_torch.reference import part

    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "bench_torch" / "configs" / "cfm-part.json").read_text())
    assert part.pair_flops(cfg) == 17_920
    assert part.dense_flops(cfg) == 3_542_784
    assert part.attention_layers(cfg) == [(128, 8)]
    work = [_record([40, 30], 100, None)]
    ctx = SimpleNamespace(cfg=cfg, plain_work=work, plain_wall=2.0)
    flops = 100 * (counts.forward_flops(cfg, 70, 2_500) + 17_920 * 2_500)
    assert read_metric("sample.part_mfu", ctx) == pytest.approx(100 * flops / 2.0 / 495e12)
    ctx.cfg = dict(cfg, architecture="particleformer")   # no pair term
    assert read_metric("sample.part_mfu", ctx) is None
    assert read_metric("sample.part_mfu", SimpleNamespace(cfg=cfg, plain_work=[],
                                                          plain_wall=2.0)) is None


def test_allreduce_ms_reads_the_nccl_kernels_a_step():
    from bench_torch.trace import Trace

    trace = Trace.__new__(Trace)
    trace.device = [(0, 2_000_000, "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 1),
                    (3_000_000, 4_000_000, "cutlass_80_simt_sgemm_128x256_8x4_nt_align1", 2),
                    (5_000_000, 5_500_000, "ncclDevKernel_AllReduce_Sum_f32_RING_LL", 3)]
    ctx = SimpleNamespace(trace=trace, steps=5)
    assert read_metric("train.allreduce_ms", ctx) == pytest.approx(2.5 / 5)
    trace.device = trace.device[1:2]   # one card: no collective kernel
    assert read_metric("train.allreduce_ms", ctx) is None
    trace.device, ctx.steps = [(0, 1_000_000, "ncclDevKernel_AllReduce", 1)], 0
    assert read_metric("train.allreduce_ms", ctx) is None
