"""K2's causal form (GPT's full forward) on the CPU, against the JAX
package: the port's dispatcher with `causal=True` and `FlavorSeqGPT`'s
attention equal JAX's `_xla_attention_btc` under the causal bias of
`multimodal_flows_tpu/models/gpt.py:71-72`, forward and q/k/v gradients;
GPT's full forward marks every attention call causal, with no bias, and
its decode none; the dispatcher refuses a bias with `causal=True`;
the wrapper refuses what the causal form does not take before it looks at
the device; the kernel's autograd backward recomputes with the causal
bias.  Inputs are made with numpy from a seed.  The kernel itself runs on
the card, where `chip_smoke.py:check_k2_causal` holds it to the plain
version."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.ops.attention import _xla_attention_btc
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.models import attention as mattn
from multimodal_flows_tpu_torch.models.gpt import FlavorSeqGPT
from multimodal_flows_tpu_torch.ops import set_attention as k2
from multimodal_flows_tpu_torch.ops.attention import causal_bias, multihead_attention_btc
from multimodal_flows_tpu_torch.utils import profiling

torch.set_num_threads(2)

# fp32 on both sides, the same ops; the sums inside the matmuls run in
# another order
ATOL = 1e-6
H = 4


def _jax_causal_bias(T):
    """`FlavorSeqGPT.__call__`'s bias (multimodal_flows_tpu/models/gpt.py:71-72)."""
    causal = jnp.tril(jnp.ones((T, T), bool))
    return jnp.where(causal, 0.0, -1e9).astype(jnp.float32)[None, None]


def _inputs(B, T, C, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, C)).astype(np.float32) for _ in range(4)]


def _jax_out_and_grads(q, k, v, up):
    bias = _jax_causal_bias(q.shape[1])

    def loss(a, b, c):
        return jnp.sum(_xla_attention_btc(a, b, c, H, bias, None) * up)

    out = _xla_attention_btc(*map(jnp.asarray, (q, k, v)), H, bias, None)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("T", [1, 17, 65])
def test_causal_dispatch_matches_jax(T, with_bias):
    """`multihead_attention_btc(causal=True)` on CPU tensors builds the
    causal bias itself (a bias passed with it is refused) and equals
    `_xla_attention_btc` under the causal bias, forward and the q/k/v
    gradients (T = 65 is one past a 64-row block)."""
    q, k, v, up = _inputs(3, T, 32, seed=T)
    ref, ref_grads = _jax_out_and_grads(q, k, v, jnp.asarray(up))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    if with_bias:
        with pytest.raises(ValueError, match="no bias"):
            multihead_attention_btc(*leaves, H, causal_bias(T, torch.device("cpu")), causal=True)
    out = multihead_attention_btc(*leaves, H, causal=True)
    (out * torch.from_numpy(up)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL, rtol=0)
    for leaf, g in zip(leaves, ref_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), g, atol=ATOL, rtol=0)


def _record(monkeypatch):
    """Patch the self-attention's dispatcher to record each call's inputs,
    `causal` and output."""
    calls = []
    real = mattn.multihead_attention_btc

    def recording(q, k, v, n_head, bias=None, key_mask=None, **kw):
        out = real(q, k, v, n_head, bias, key_mask, **kw)
        calls.append(dict(q=q.detach(), k=k.detach(), v=v.detach(), n_head=n_head, bias=bias,
                          key_mask=key_mask, causal=kw.get("causal", False),
                          out=out.detach()))
        return out

    monkeypatch.setattr(mattn, "multihead_attention_btc", recording)
    return calls


def _gpt(seed=0):
    torch.manual_seed(seed)
    cfg = Config(vocab_size=9, max_seq_length=63, n_embd=32, n_inner=64, n_layer=2, n_head=H)
    return FlavorSeqGPT(cfg).eval()


@pytest.mark.parametrize("T", [1, 65])
def test_gpt_forward_attention_is_causal_and_matches_jax(monkeypatch, T):
    """Every attention call of `FlavorSeqGPT.forward` is marked causal, gets
    no bias (the dispatcher builds it), and equals `_xla_attention_btc`
    under JAX's causal bias on the same q/k/v; its q/k/v gradients do too."""
    calls = _record(monkeypatch)
    model = _gpt()
    ids = torch.from_numpy(np.random.default_rng(T).integers(0, 13, size=(2, T)))
    with torch.no_grad():
        model(ids)
    assert len(calls) == model.config.n_layer
    for call in calls:
        assert call["causal"] and call["n_head"] == H and call["key_mask"] is None
        assert call["bias"] is None
        q, k, v = (call[n].numpy() for n in ("q", "k", "v"))
        up = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
        ref, ref_grads = _jax_out_and_grads(q, k, v, jnp.asarray(up))
        np.testing.assert_allclose(call["out"].numpy(), ref, atol=ATOL, rtol=0)
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = multihead_attention_btc(*leaves, H, causal=True)
        (out * torch.from_numpy(up)).sum().backward()
        for leaf, g in zip(leaves, ref_grads):
            np.testing.assert_allclose(leaf.grad.numpy(), g, atol=ATOL, rtol=0)


def test_gpt_decode_is_not_causal_form(monkeypatch):
    """The KV-cached decode keeps its key-mask form: one query, `causal`
    False, the causal key mask over the cache."""
    calls = _record(monkeypatch)
    model = _gpt()
    caches = model.init_cache(2)
    token = torch.tensor([3, 5])
    with torch.no_grad():
        for pos in range(3):
            _, caches = model.decode(token, pos, caches)
    assert len(calls) == 3 * model.config.n_layer
    for i, call in enumerate(calls):
        pos = i // model.config.n_layer
        assert not call["causal"] and call["bias"] is None and call["q"].shape[1] == 1
        expect = torch.where(torch.arange(model.seq_len) <= pos, 0.0, -1e9)
        torch.testing.assert_close(call["key_mask"], expect.expand(2, -1), rtol=0, atol=0)


def test_gpt_decode_builds_one_key_mask_a_step(monkeypatch):
    """A decode step builds the causal key mask once and hands every layer
    that one tensor: contiguous (B, seq_len) fp32, 0 where arange <= pos and
    -1e9 elsewhere, as each layer built it before; a 0-d tensor position
    gives the same mask as an int."""
    calls = _record(monkeypatch)
    torch.manual_seed(0)
    cfg = Config(vocab_size=9, max_seq_length=14, n_embd=32, n_inner=64, n_layer=5, n_head=H)
    model = FlavorSeqGPT(cfg).eval()
    caches = model.init_cache(3)
    token = torch.tensor([3, 5, 7])
    positions = [0, torch.tensor(1), 2, torch.tensor(15)]
    with torch.no_grad():
        for pos in positions:
            _, caches = model.decode(token, pos, caches)
    assert len(calls) == len(positions) * cfg.n_layer
    for i, pos in enumerate(positions):
        step = calls[i * cfg.n_layer:(i + 1) * cfg.n_layer]
        mask = step[0]["key_mask"]
        assert all(call["key_mask"] is mask for call in step)
        expect = torch.where(torch.arange(model.seq_len) <= int(pos), 0.0, -1e9)
        assert mask.dtype == torch.float32 and mask.is_contiguous()
        torch.testing.assert_close(mask, expect.expand(3, -1), rtol=0, atol=0)


def test_causal_form_refuses_what_it_does_not_take():
    """Tq != Tk, a bias, segments and bf16 are refused before the device is
    looked at (these are CPU tensors)."""
    x = torch.zeros(2, 6, 8)
    with pytest.raises(ValueError, match="Tq == Tk"):
        k2.set_attention_btc(x[:, :1], x, x, 2, causal=True)
    with pytest.raises(ValueError, match="no bias"):
        k2.set_attention_btc(x, x, x, 2, bias=torch.zeros(1, 1, 6, 6), causal=True)
    with pytest.raises(ValueError, match="no segments"):
        k2.set_attention_btc(x, x, x, 2, segments=torch.zeros(2, 6, dtype=torch.int32),
                             causal=True)
    with pytest.raises(ValueError, match="fp32"):
        xb = x.to(torch.bfloat16)
        k2.set_attention_btc(xb, xb, xb, 2, causal=True)
    with pytest.raises(ValueError, match="CUDA"):  # a well-formed call: the device check
        k2.set_attention_btc(x, x, x, 2, causal=True)
    assert profiling.peek_counters()["k2.causal"] == 0


def test_causal_backward_recomputes_with_the_causal_bias():
    """The kernel's autograd backward, run on CPU tensors with a stand-in
    ctx: dq, dk, dv equal `jax.grad` under the causal bias, nothing for
    the key mask, bias and segments."""
    q, k, v, up = _inputs(3, 9, 32, seed=4)
    _, ref_grads = _jax_out_and_grads(q, k, v, jnp.asarray(up))
    saved = tuple(torch.from_numpy(a) for a in (q, k, v)) + (None, None, None)
    ctx = types.SimpleNamespace(saved_tensors=saved, n_head=H, causal=True,
                                needs_input_grad=(True,) * 3 + (False,) * 5)
    grads = k2._SetAttention.backward(ctx, torch.from_numpy(up))
    assert grads[3:] == (None,) * 5
    for g, ref in zip(grads[:3], ref_grads):
        np.testing.assert_allclose(g.numpy(), ref, atol=ATOL, rtol=0)


def test_causal_bias_is_built_once_per_length_and_device():
    cpu = torch.device("cpu")
    assert causal_bias(7, cpu) is causal_bias(7, cpu)
    bias = causal_bias(7, cpu)
    assert bias.shape == (1, 1, 7, 7) and bias.dtype == torch.float32
    np.testing.assert_array_equal(bias.numpy(), np.asarray(_jax_causal_bias(7)))
