"""The port's GPT baseline against the JAX package, at small widths on the
CPU: the named activations, `FlavorSeqGPT`'s logits, its KV-cached decode,
the loss and its gradients, the three dropouts, generation (greedy, and
with JAX's Gumbel noise injected), a `Trainer.fit`; then the profiling
and progress helpers.  The flax parameters are randomized and converted
(`convert.load_flax_params`), the inputs made from numpy; the port takes
its plain attention on CPU tensors (K2 carries it on the card, where
`chip_smoke.py` holds it)."""

import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.config import Config as JaxConfig
from multimodal_flows_tpu.data.state import DataCoupling as JaxCoupling
from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
from multimodal_flows_tpu.models import blocks as jblocks
from multimodal_flows_tpu.train.gpt import GPT as JaxGPT
from multimodal_flows_tpu_torch.cli import train_mmf
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.convert import load_flax_params, params_from_flax
from multimodal_flows_tpu_torch.data.datasets import jet_set_to_seq
from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
from multimodal_flows_tpu_torch.models import blocks
from multimodal_flows_tpu_torch.ops import attention
from multimodal_flows_tpu_torch.train import gpt as gpt_train
from multimodal_flows_tpu_torch.train.gpt import GPT, gumbel_noise
from multimodal_flows_tpu_torch.train.systems import build_system
from multimodal_flows_tpu_torch.utils import profiling
from multimodal_flows_tpu_torch.utils.progress import EpochProgress
from tests.test_torch_model import _randomize, _to_numpy

torch.set_num_threads(2)

V = 9  # BOS 10, EOS 11, PAD 12
SMALL = dict(vocab_size=V, max_seq_length=6, n_embd=32, n_inner=64, n_layer=2, n_head=2,
             batch_size=8)
# fp32 on both sides, the same ops up to the sums inside the matmuls
ATOL = 1e-5
# the decode sums over the cache in another order than the full forward
DECODE_ATOL = 2e-4


def _pair(seed=0, **kw):
    """(JAX system, its randomized params, port system on the CPU with the
    same weights)."""
    jsys = JaxGPT(JaxConfig(**SMALL, **kw))
    params = _randomize(jsys.init_params(jax.random.PRNGKey(seed))["params"], seed + 1)
    system = GPT(Config(**SMALL, **kw), device="cpu")
    load_flax_params(system.module, _to_numpy(params))
    return jsys, {"params": params}, system


def _sequences(B=6, seed=3):
    """(B, D + 2) BOS/EOS/PAD sequences of jets of 1..D tokens."""
    rng = np.random.default_rng(seed)
    D = SMALL["max_seq_length"]
    mask = (np.arange(D)[None, :] < rng.integers(1, D + 1, size=B)[:, None])[..., None]
    tokens = (rng.integers(1, V, size=(B, D, 1)) * mask).astype(np.int32)
    return jet_set_to_seq(MultiModal(discrete=tokens, mask=mask.astype(np.int32)), V)


def _jax_gumbel(key, B, T):
    """The noise JAX's `generate` draws: per step `k, sub = split(k)`, then
    `categorical(sub, .)` = argmax(logits + gumbel(sub, (B, V + 4)))."""
    noise = []
    for _ in range(T - 1):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.gumbel(sub, (B, V + 4))))
    return torch.from_numpy(np.stack(noise))


@pytest.mark.parametrize("name", ["gelu", "gelu_new", "relu", "silu", "tanh"])
def test_activations_match_jax(name):
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    ref = np.asarray(jblocks.activation_fn(name)(jnp.asarray(x)))
    out = blocks.activation_fn(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)


def test_unknown_activation_raises_as_in_jax():
    with pytest.raises(ValueError, match="unknown activation"):
        blocks.activation_fn("nope")
    with pytest.raises(ValueError, match="unknown activation"):
        GPT(Config(**SMALL, activation="nope"), device="cpu")
    # the encoders keep exact GELU
    assert blocks.MLP(4, 8).act is blocks.ACTIVATIONS["gelu"]


@pytest.mark.parametrize("activation", ["gelu", "gelu_new"])
def test_logits_match_jax(activation):
    jsys, params, system = _pair(activation=activation)
    seq = _sequences().discrete
    ref = np.asarray(jsys.module.apply(params, jnp.asarray(seq)))
    with torch.no_grad():
        out = system.module(torch.from_numpy(seq)).numpy()
    assert out.shape == (6, 8, V + 4)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_the_flax_tree_loads_strictly_and_the_causal_bias_is_no_parameter():
    jsys, params, system = _pair()
    names = set(params_from_flax(_to_numpy(params["params"])))
    assert names == set(system.module.state_dict())
    assert not dict(system.module.named_buffers())   # the causal bias is built in ops
    assert {"wte.weight", "wpe.weight", "block_1.attn.c_attn.weight", "block_1.ffw.c_fc.bias",
            "ln_f.weight", "lm_head.weight"} <= names
    assert "lm_head.bias" not in names and "block_0.attn.q_layernorm.weight" not in names
    bias = attention.causal_bias(system.module.seq_len, system.device)
    assert bias.shape == (1, 1, 8, 8) and bias[0, 0, 2, 3] == -1e9 and bias[0, 0, 3, 2] == 0


def test_decode_matches_jax_decode_and_the_full_forward():
    """The KV-cached decode at every position against JAX's decode and
    against the port's own teacher-forced logits."""
    jsys, params, system = _pair(seed=4, activation="gelu_new")
    ids = _sequences(B=4, seed=5).discrete
    T = ids.shape[1]
    full = system.module(torch.from_numpy(ids)).detach()
    jcaches = jsys.module.apply(params, 4, method="init_cache")
    caches = system.module.init_cache(4)
    assert [tuple(k.shape) for k, _ in caches] == [(4, T, 32)] * 2
    with torch.no_grad():
        for t in range(T):
            ref, jcaches = jsys.module.apply(params, jnp.asarray(ids[:, t]), jnp.int32(t),
                                             jcaches, method="decode")
            out, caches = system.module.decode(torch.from_numpy(ids[:, t]), t, caches)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                                       err_msg=f"pos {t} vs JAX")
            np.testing.assert_allclose(out.numpy(), full[:, t].numpy(), atol=DECODE_ATOL,
                                       err_msg=f"pos {t} vs the full forward")
    for (k, v), (jk, jv) in zip(caches, jcaches):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=ATOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=ATOL)


def test_decode_at_a_device_position_equals_an_int_position():
    """`decode` with the position as a 0-d int64 tensor gives the logits
    and the caches of an int position, bit for bit, at every position."""
    _, _, system = _pair(seed=4, activation="gelu_new")
    ids = torch.from_numpy(_sequences(B=4, seed=5).discrete)
    by_int, by_tensor = system.module.init_cache(4), system.module.init_cache(4)
    with torch.no_grad():
        for t in range(ids.shape[1]):
            a, by_int = system.module.decode(ids[:, t], t, by_int)
            b, by_tensor = system.module.decode(ids[:, t], torch.tensor(t), by_tensor)
            assert torch.equal(a, b), f"pos {t}"
    for (ka, va), (kb, vb) in zip(by_int, by_tensor):
        assert torch.equal(ka, kb) and torch.equal(va, vb)


def _decode_before(module, token, pos, caches):
    """The decode as the port wrote it before the position became a device
    scalar: the position row by an int, the caches written through slices,
    the causal key mask built again in each layer."""
    h = module.wte(token[:, None]) + module.wpe.weight[pos][None, None, :]
    for block, (kc, vc) in zip(module.blocks, caches):
        attn, x = block.attn, block.ln1(h)
        C = attn.n_head * attn.head_size
        q, k, v = attn.c_attn(x).split(C, dim=-1)
        kc[:, pos:pos + 1] = k
        vc[:, pos:pos + 1] = v
        Tc = kc.shape[1]
        causal = torch.where(torch.arange(Tc) <= pos, 0.0, -1e9)
        y = attention.multihead_attention_btc(q.contiguous(), kc, vc, attn.n_head, None,
                                              causal.expand(len(token), Tc).contiguous())
        h = h + attn.c_proj(y)
        h = h + block.ffw(block.ln2(h))
    return module.lm_head(module.ln_f(h))[:, 0]


def _generate_before(system, B, gumbel, temperature, top_k):
    """`GPT.generate`'s loop before the static buffers: a Python position,
    fresh caches, the noise indexed by the host."""
    module = system.module
    T = module.seq_len
    caches = module.init_cache(B)
    tokens = torch.empty((B, T), dtype=torch.int32)
    tokens[:, 0] = system.start_token
    prev = tokens[:, 0]
    done = torch.zeros(B, dtype=torch.bool)
    for t in range(T - 1):
        logits = _decode_before(module, prev, t, caches).to(torch.float32) / float(temperature)
        if top_k is not None:
            thresh = torch.topk(logits, top_k, dim=-1).values[:, -1:]
            logits = torch.where(logits >= thresh, logits, -1e9)
        nxt = torch.argmax(logits + gumbel[t], dim=-1).to(torch.int32)
        nxt = torch.where(done, system.pad_token, nxt)
        done = done | (nxt == system.end_token)
        tokens[:, t + 1] = nxt
        prev = nxt
    return tokens


@pytest.mark.parametrize("top_k,injected", [(None, False), (4, False), (None, True)],
                         ids=["no_top_k", "top_k", "injected_gumbel"])
def test_generate_equals_the_loop_before_device_positions(top_k, injected):
    """The static-buffer step with a device position draws the tokens the
    per-step Python loop drew on the same noise: from one seed's generator,
    with and without top-k, and with `gumbel=` injected."""
    _, _, system = _pair(seed=20)
    B, T = 24, system.module.seq_len
    noise = gumbel_noise(torch.Generator().manual_seed(7), (T - 1, B, V + 4), "cpu")
    with torch.no_grad():
        ref = _generate_before(system, B, noise, 1.3, top_k)
    if injected:
        out = system.generate(B, temperature=1.3, top_k=top_k, gumbel=noise)
    else:
        out = system.generate(B, torch.Generator().manual_seed(7), temperature=1.3, top_k=top_k)
    assert out.dtype == torch.int32
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (ref == system.end_token).any() and (ref == system.pad_token).any()


def test_generate_runs_eagerly_on_the_cpu_and_counts_its_steps():
    """Off CUDA every decode step runs eagerly: `take_counters()` reports
    (seq_len - 1) eager steps a call, no graph step and no capture."""
    _, _, system = _pair(seed=21)
    profiling.take_counters()
    for s in range(3):
        system.generate(5, torch.Generator().manual_seed(s))
    got = profiling.take_counters()
    assert got["gpt_decode.eager_steps"] == 3 * (system.module.seq_len - 1)
    assert got["gpt_decode.graph_steps"] == 0 and got["gpt_decode.captures"] == 0
    assert not gpt_train._graphable(system.module, system.device)
    assert system._decode_loops == {}


def test_decode_graph_key_tells_the_captured_steps_apart():
    """A key for each batch size, temperature, top-k, module (and where its
    parameters live) and device; the same arguments give the same key."""
    _, _, system = _pair(seed=22)
    module, cpu = system.module, torch.device("cpu")
    key = gpt_train.decode_graph_key(module, 8, 1.0, None, cpu)
    assert key == gpt_train.decode_graph_key(module, 8, 1, None, cpu)
    other = GPT(Config(**SMALL), device="cpu").module
    moved = [(9, 1.0, None, module), (8, 0.8, None, module), (8, 1.0, 5, module),
             (8, 1.0, None, other)]
    keys = {gpt_train.decode_graph_key(m, b, temp, k, cpu) for b, temp, k, m in moved}
    assert len(keys) == len(moved) and key not in keys
    module.wpe.weight.data = module.wpe.weight.data.clone()
    assert gpt_train.decode_graph_key(module, 8, 1.0, None, cpu) != key


def test_loss_matches_jax():
    jsys, params, system = _pair(seed=6)
    seq = _sequences(B=8, seed=7)
    ref, jm = jsys.loss_fn(params, jax.tree.map(jnp.asarray, JaxCoupling(target=JaxMultiModal(
        discrete=seq.discrete, mask=seq.mask))), jax.random.PRNGKey(0))
    loss, m = system.loss_fn(DataCoupling(target=seq.to("cpu")), train=True)
    assert loss.item() == pytest.approx(float(ref), rel=1e-6)
    assert set(m) == set(jm) == {"loss", "loss_ce"}
    assert (seq.discrete[:, 1:] == V + 3).any()   # the batch has PAD targets to ignore


def test_loss_gradients_match_jax():
    jsys, params, system = _pair(seed=8, activation="gelu_new")
    seq = _sequences(B=8, seed=9)
    coupling = jax.tree.map(jnp.asarray, JaxCoupling(target=JaxMultiModal(
        discrete=seq.discrete, mask=seq.mask)))
    jgrads = jax.grad(lambda p: jsys.loss_fn(p, coupling, jax.random.PRNGKey(0))[0])(params)
    ref = params_from_flax(_to_numpy(jgrads["params"]))
    loss, _ = system.loss_fn(DataCoupling(target=seq.to("cpu")))
    loss.backward()
    grads = {n: p.grad for n, p in system.module.named_parameters()}
    assert set(grads) == set(ref)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("rate", ["dropout_emb", "dropout_att", "dropout_res"])
def test_each_dropout_acts_in_train_mode_only(rate):
    """Each GPT2 dropout draws its masks from the step's generator in
    train mode and leaves the eval forward alone; the attention with
    probability dropout takes the plain version."""
    _, _, system = _pair(seed=10, **{rate: 0.5})
    batch = DataCoupling(target=_sequences(B=8, seed=11).to("cpu"))
    profiling.take_counters()
    with torch.no_grad():
        det = [system.loss_fn(batch, torch.Generator().manual_seed(s), train=False)[0]
               for s in (0, 1)]
        r1, r1_again, r2 = (system.loss_fn(batch, torch.Generator().manual_seed(s))[0]
                            for s in (1, 1, 2))
    assert det[0] == det[1] and r1 != det[0] and r1 == r1_again and r1 != r2
    assert not system.module.training
    calls = profiling.peek_counters()["attn.plain_dropout.token_major"]
    assert calls == (3 * SMALL["n_layer"] if rate == "dropout_att" else 0)


@pytest.mark.parametrize("temperature,top_k", [(1.0, 1), (1.5, 10)], ids=["greedy", "gumbel"])
def test_generate_equals_jax(temperature, top_k):
    """Greedy generation (top_k=1), and temperature + top-k with JAX's own
    Gumbel noise injected: the same sequences as JAX's `generate`."""
    jsys, params, system = _pair(seed=12)
    key = jax.random.PRNGKey(1)
    ref = np.asarray(jsys.generate(params, key, 16, temperature=temperature, top_k=top_k))
    out = system.generate(16, temperature=[temperature], top_k=top_k,
                          gumbel=_jax_gumbel(key, 16, 8)).numpy()
    assert out.dtype == np.int32 and out.shape == (16, 8)
    np.testing.assert_array_equal(out, ref)
    if top_k > 1:
        assert (ref == V + 2).any()   # some sequences end inside the window


def test_generate_semantics():
    """As tests/test_gpt.py holds JAX: BOS first, PAD after the first EOS,
    `sample_jets` strips the special tokens; the draws come from the
    generator."""
    _, _, system = _pair(seed=14)
    gen = torch.Generator().manual_seed(3)
    seq = system.generate(12, gen).numpy()
    assert seq.shape == (12, 8) and np.all(seq[:, 0] == V + 1)
    for row in seq:
        eos = np.where(row == V + 2)[0]
        if len(eos):
            assert np.all(row[eos[0] + 1:] == V + 3)
    assert np.array_equal(seq, system.generate(12, torch.Generator().manual_seed(3)).numpy())
    jets = system.sample_jets(12, torch.Generator().manual_seed(4))
    assert jets.shape == (12, SMALL["max_seq_length"]) and jets.min() >= 0 and jets.max() <= V
    assert system.example_state(3).shape == (3, 8)
    with pytest.raises(ValueError, match="gumbel must be"):
        system.generate(2, gumbel=torch.zeros(7, 3, V + 4))


def test_trainer_fit_of_gpt(tmp_path):
    """A few epochs of the GPT system through the port's trainer on the
    CPU: finite logged losses, the loss on a fixed batch falls, `last`
    reloads to the logged validation loss."""
    rng = np.random.default_rng(15)
    D = SMALL["max_seq_length"]
    mask = (np.arange(D)[None, :] < rng.integers(2, D + 1, size=96)[:, None]).astype(np.int32)
    tokens = rng.integers(1, 4, size=(96, D, 1)).astype(np.int32) * mask[..., None]
    jets = MultiModal(continuous=rng.normal(size=(96, D, 3)).astype(np.float32),
                      discrete=tokens, mask=mask[..., None])
    cfg = Config(**dict(SMALL, max_num_particles=D, max_epochs=3, lr=3e-3, lr_final=1e-3,
                        dir=str(tmp_path), experiment_id="gpt"))
    train_ds, val_ds = train_mmf.split_jets(jets, cfg, "GPT")
    trainer = train_mmf.build_trainer(cfg, "GPT", device="cpu")
    system = trainer.system
    batch = DataCoupling(target=MultiModal(discrete=torch.from_numpy(
        val_ds.coupling.target.discrete)))
    before = system.loss_fn(batch, train=False)[0].item()
    state = trainer.fit(train_ds, val_ds)
    assert system.loss_fn(batch, train=False, module=state.module)[0].item() < before
    exp = os.path.join(str(tmp_path), cfg.project, "gpt")
    records = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    assert len(records) == 3 and all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
                                     for r in records)
    fresh = build_system(cfg, "GPT", device="cpu")
    fresh.module.load_state_dict(trainer.load_for_inference("last"))
    assert trainer.evaluate(val_ds, fresh.module, epoch=2)["val_loss"] == pytest.approx(
        records[-1]["val_loss"], rel=1e-6)


def test_gpt_builds_on_the_card_by_default():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_system(Config(**SMALL), "GPT")
    assert isinstance(build_system(Config(**SMALL), "GPT", device="cpu"), GPT)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(None):
        torch.ones(3).sum()
    assert not os.listdir(tmp_path)
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("test.span"):
            (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    (name,) = os.listdir(tmp_path / "tr")
    assert name.startswith("trace_") and name.endswith(".json")
    events = json.load(open(tmp_path / "tr" / name))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    # a program span is a range of the trace
    assert any(e.get("name") == "test.span" for e in events)
    assert [s.name for s in profiling.take_spans()] == ["test.span"]


def test_force_completion_sums_the_float_leaves():
    tree = {"a": torch.ones(3), "b": [torch.full((2,), 2.5), torch.arange(4)],
            "c": MultiModal(continuous=torch.ones(2, 2), discrete=torch.ones(2, 2, 1,
                                                                               dtype=torch.int32))}
    assert profiling.force_completion(tree) == pytest.approx(3 + 5 + 4)
    assert profiling.force_completion({"n": 1}) == 0.0


def test_epoch_progress_is_a_no_op_off_a_tty(monkeypatch):
    monkeypatch.setattr("sys.stderr", io.StringIO())
    bar = EpochProgress()
    assert not bar.enabled
    bar.start_epoch(0, 3)
    bar.update(1.0)
    bar.end_epoch()


def test_epoch_progress_when_enabled():
    bar = EpochProgress(enabled=True)
    assert bar.enabled
    bar.start_epoch(2, 3)
    bar.update(0.5)
    bar.update(float("nan"))  # a placeholder between logging steps
    task = bar._progress.tasks[0]
    assert task.completed == 2 and task.total == 3 and task.fields["loss"] == "loss=0.5000"
    bar.end_epoch()
    assert bar._task is None and not bar._progress.tasks
