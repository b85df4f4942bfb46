"""K2's plain versions against the JAX package, and its dispatch.

- `attention_reference` (head-major) against `_xla_reference` and
  `_xla_attention`, with key mask and bias in every combination, the bias
  as (B, 1, T, T) and (B, H, T, T), and Tq != Tk;
- the biased `attention_btc_reference`, with and without segments,
  against `_xla_attention_btc`;
- the gradients of both, the bias's included, against `jax.grad`, and the
  K2 autograd backward (which recomputes through them) on the CPU;
- the CPU dispatch never launches K2, and the K2 wrappers refuse CPU
  tensors.

The JAX side runs through its plain reference: the Pallas kernel K2
(`pallas_set_attention`) has no interpret mode here (tests/test_ops.py
runs it on a TPU only).  The K2 CUDA kernel itself is held to the same
plain versions on the card by chip_smoke.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.ops.attention import _xla_attention, _xla_attention_btc
from multimodal_flows_tpu.ops.pallas_attention import _xla_reference
from multimodal_flows_tpu_torch.ops import attention
from multimodal_flows_tpu_torch.ops import btc_attention as k1
from multimodal_flows_tpu_torch.ops import set_attention as k2
from multimodal_flows_tpu_torch.ops.attention import (
    attention_btc_reference,
    attention_reference,
    multihead_attention,
    multihead_attention_btc,
)

torch.set_num_threads(2)

# fp32 on both sides; the sums over <= 12 keys run in another order
ATOL = 1e-5
# gradients go through two softmax backward passes in different orders
GRAD_ATOL = 2e-4

ZERO_K2 = {"bias_segments": 0, "bias": 0, "bias_key_mask": 0, "key_mask": 0, "none": 0}


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(shape, seed):
    return _rng(seed).normal(size=shape).astype(np.float32)


def _key_mask(B, T, seed=1):
    n = _rng(seed).integers(2, T + 1, size=B)
    real = np.arange(T)[None, :] < n[:, None]
    return np.where(real, 0.0, -1e9).astype(np.float32)


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _torch(a):
    return None if a is None else torch.from_numpy(a)


HEAD_MAJOR_CASES = [
    # (B, H, Tq, Tk, Dh), key mask, bias heads (None: no bias)
    ((4, 3, 9, 9, 8), True, None),
    ((4, 3, 9, 9, 8), True, 1),
    ((4, 3, 9, 9, 8), True, 3),
    ((4, 3, 9, 9, 8), False, 1),
    ((4, 3, 9, 9, 8), False, 3),
    ((4, 3, 7, 11, 8), True, 1),
    ((4, 3, 7, 11, 8), False, 3),
    ((2, 2, 5, 6, 4), False, None),
]


def _head_major_inputs(shape, with_mask, bias_heads, seed=0):
    B, H, Tq, Tk, Dh = shape
    q = _normal((B, H, Tq, Dh), seed)
    k = _normal((B, H, Tk, Dh), seed + 1)
    v = _normal((B, H, Tk, Dh), seed + 2)
    km = _key_mask(B, Tk) if with_mask else None
    bias = None if bias_heads is None else _normal((B, bias_heads, Tq, Tk), seed + 3)
    return q, k, v, km, bias


@pytest.mark.parametrize("shape,with_mask,bias_heads", HEAD_MAJOR_CASES)
def test_head_major_reference_matches_jax(shape, with_mask, bias_heads):
    q, k, v, km, bias = _head_major_inputs(shape, with_mask, bias_heads)
    out = attention_reference(*map(_torch, (q, k, v, km, bias))).numpy()
    ref = np.asarray(_xla_reference(*map(_jnp, (q, k, v, km, bias))))
    xla = np.asarray(_xla_attention(*map(_jnp, (q, k, v)), _jnp(bias), _jnp(km)))
    assert out.shape == shape[:3] + (shape[4],)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    np.testing.assert_allclose(out, xla, atol=ATOL)


def _packed_segments(B, T):
    """Jets of width 5 and 4, then pads (-1)."""
    seg = np.full((B, T), -1, np.int32)
    seg[:, :5], seg[:, 5:9] = 0, 1
    return seg


@pytest.mark.parametrize("bias_heads,with_segments,with_mask", [
    (4, True, False),    # co-occurrence packed rows
    (4, False, False),   # pair mask + co-occurrence, bucketed
    (1, False, False),   # pair mask alone: the broadcast bias
    (4, False, True),    # key mask and bias
    (1, True, False),
])
def test_biased_btc_reference_matches_jax(bias_heads, with_segments, with_mask):
    B, T, C, H = 6, 12, 32, 4
    q, k, v = (_normal((B, T, C), s) for s in range(3))
    bias = _normal((B, bias_heads, T, T), 3)
    seg = _packed_segments(B, T) if with_segments else None
    km = _key_mask(B, T) if with_mask else None
    out = attention_btc_reference(*map(_torch, (q, k, v)), H, _torch(km), _torch(seg),
                                  _torch(bias)).numpy()
    ref = np.asarray(_xla_attention_btc(*map(_jnp, (q, k, v)), H, _jnp(bias), _jnp(km),
                                        segments=_jnp(seg)))
    real = seg >= 0 if seg is not None else np.ones((B, T), bool)
    np.testing.assert_allclose(out[real], ref[real], atol=ATOL)


def test_pair_mask_pad_rows_stay_finite():
    """Under the pair-mask form a pad query row is -1e9 + bias throughout:
    finite, and equal to JAX's."""
    from multimodal_flows_tpu.models.blocks import pair_mask_bias as jax_pair_mask_bias
    from multimodal_flows_tpu_torch.models.blocks import pair_mask_bias

    B, T, C, H = 4, 10, 16, 4
    mask = (np.arange(T)[None, :] < np.array([3, 10, 0, 6])[:, None]).astype(np.int32)[..., None]
    bias = pair_mask_bias(torch.from_numpy(mask)) + torch.from_numpy(_normal((B, H, T, T), 5))
    np.testing.assert_array_equal(pair_mask_bias(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jax_pair_mask_bias(jnp.asarray(mask))))
    q, k, v = (_normal((B, T, C), s) for s in range(3))
    out = attention_btc_reference(*map(_torch, (q, k, v)), H, bias=bias).numpy()
    assert np.isfinite(out).all()
    ref = np.asarray(_xla_attention_btc(*map(_jnp, (q, k, v)), H, jnp.asarray(bias.numpy()),
                                        None))
    np.testing.assert_allclose(out, ref, atol=ATOL)


def _jax_grads(fn, args, n):
    return jax.grad(lambda *a: (fn(*a) ** 2).sum(), argnums=tuple(range(n)))(
        *map(jnp.asarray, args))


@pytest.mark.parametrize("bias_heads", [1, 3])
def test_head_major_gradients_match_jax(bias_heads):
    """The plain version's gradients, dbias included (summed back to the
    bias's broadcast shape), against `jax.grad` of `_xla_reference`."""
    q, k, v, km, bias = _head_major_inputs((4, 3, 7, 11, 8), True, bias_heads)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias)]
    (attention_reference(*leaves[:3], torch.from_numpy(km), leaves[3]) ** 2).sum().backward()
    g_jax = _jax_grads(lambda a, b, c, d: _xla_reference(a, b, c, jnp.asarray(km), d),
                       (q, k, v, bias), 4)
    for t, g in zip(leaves, g_jax):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=GRAD_ATOL)


def test_btc_gradients_with_bias_and_segments_match_jax():
    B, T, C, H = 6, 12, 32, 4
    q, k, v = (_normal((B, T, C), s) for s in range(3))
    bias = _normal((B, H, T, T), 3)
    seg = _packed_segments(B, T)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias)]
    (attention_btc_reference(*leaves[:3], H, None, torch.from_numpy(seg), leaves[3]) ** 2
     ).sum().backward()
    g_jax = _jax_grads(lambda a, b, c, d: _xla_attention_btc(
        a, b, c, H, d, None, segments=jnp.asarray(seg)), (q, k, v, bias), 4)
    for t, g in zip(leaves, g_jax):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=GRAD_ATOL)


def _backward(saved, n_head, g):
    """Run the K2 autograd backward on CPU tensors with a stand-in ctx."""
    ctx = types.SimpleNamespace(saved_tensors=saved, n_head=n_head,
                                needs_input_grad=(True,) * 7)
    return k2._SetAttention.backward(ctx, g)


@pytest.mark.parametrize("token_major", [False, True])
def test_kernel_backward_matches_jax(token_major):
    """The K2 backward recomputes through the plain version: dq, dk, dv and
    dbias (in the bias's own (B, 1, T, T) shape) equal `jax.grad`'s, and
    key_mask and segments get none."""
    if token_major:
        B, T, C, H = 6, 12, 32, 4
        q, k, v = (_normal((B, T, C), s) for s in range(3))
        bias, seg, km = _normal((B, 1, T, T), 3), _packed_segments(B, T), None
        out = _xla_attention_btc(*map(jnp.asarray, (q, k, v)), H, jnp.asarray(bias), None,
                                 segments=jnp.asarray(seg))
        g_jax = _jax_grads(lambda a, b, c, d: _xla_attention_btc(
            a, b, c, H, d, None, segments=jnp.asarray(seg)), (q, k, v, bias), 4)
    else:
        H = None
        q, k, v, km, bias = _head_major_inputs((4, 3, 7, 11, 8), True, 1)
        seg = None
        out = _xla_reference(*map(jnp.asarray, (q, k, v, km, bias)))
        g_jax = _jax_grads(lambda a, b, c, d: _xla_reference(a, b, c, jnp.asarray(km), d),
                           (q, k, v, bias), 4)
    grads = _backward(tuple(map(_torch, (q, k, v, km, bias, seg))), H,
                      torch.from_numpy(2 * np.asarray(out)))
    assert grads[3] is None and grads[5] is None and grads[6] is None
    assert grads[4].shape == bias.shape
    for t, g in zip(grads[:3] + (grads[4],), g_jax):
        np.testing.assert_allclose(t.numpy(), np.asarray(g), atol=GRAD_ATOL)


def test_cpu_dispatch_never_launches_k2():
    B, T, C, H = 6, 12, 32, 4
    q, k, v = (torch.from_numpy(_normal((B, T, C), s)) for s in range(3))
    bias = torch.from_numpy(_normal((B, H, T, T), 3))
    seg = torch.from_numpy(_packed_segments(B, T))
    k1.reset_launch_counts()
    k2.reset_launch_counts()
    out = multihead_attention_btc(q, k, v, H, bias, segments=seg)
    torch.testing.assert_close(out, attention_btc_reference(q, k, v, H, None, seg, bias),
                               rtol=0, atol=0)
    hq, hk, hv, km, hb = map(_torch, _head_major_inputs((4, 3, 7, 11, 8), True, 1))
    out = multihead_attention(hq, hk, hv, hb, km)
    torch.testing.assert_close(out, attention_reference(hq, hk, hv, km, hb), rtol=0, atol=0)
    assert k2.LAUNCHES == ZERO_K2
    assert k1.LAUNCHES == {"segments": 0, "key_mask": 0, "none": 0}


def test_k2_wrappers_refuse_cpu_tensors():
    q, k, v, km, bias = map(_torch, _head_major_inputs((2, 2, 5, 6, 4), True, 1))
    with pytest.raises(ValueError, match="CUDA"):
        k2.set_attention(q, k, v, km, bias)
    x = torch.zeros(2, 6, 8)
    with pytest.raises(ValueError, match="CUDA"):
        k2.set_attention_btc(x, x, x, 2, bias=torch.zeros(2, 1, 6, 6))
    # probability dropout is ported: the head-major call takes the plain
    # version and never K2; at rate 0 the generator is not touched
    attention.reset_plain_dropout_calls()
    gen = torch.Generator().manual_seed(0)
    dropped = multihead_attention(q, k, v, bias, km, dropout_rate=0.5, generator=gen)
    assert attention.PLAIN_DROPOUT_CALLS == {"head_major": 1, "token_major": 0}
    assert not torch.equal(dropped, attention_reference(q, k, v, km, bias))
    torch.testing.assert_close(multihead_attention(q, k, v, bias, km, dropout_rate=0.0,
                                                   generator=gen),
                               attention_reference(q, k, v, km, bias), rtol=0, atol=0)
    assert k2.LAUNCHES == ZERO_K2
