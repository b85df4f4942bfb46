"""The port's set attention against the JAX package: the plain PyTorch
reference `attention_btc_reference` vs `_xla_attention_btc` and the Pallas
kernel `pallas_btc_attention` in interpret mode, on the key-mask, packed
segment and unmasked forms (mirrors tests/test_ops.py:94-123,157-180).
The K1 CUDA kernel itself is checked against the same reference on the
card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.ops.attention import _xla_attention_btc
from multimodal_flows_tpu.ops.pallas_attention import pallas_btc_attention
from multimodal_flows_tpu_torch.ops import attention
from multimodal_flows_tpu_torch.ops import btc_attention as k1
from multimodal_flows_tpu_torch.ops.attention import (
    attention_btc_reference,
    multihead_attention_btc,
)

torch.set_num_threads(2)

# fp32 on both sides; the sums over <= 12 keys run in another order
ATOL = 1e-5


def _qkv(B, T, C, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, C)).astype(np.float32) for _ in range(3)]


def _key_mask(B, T, seed=1, all_pad_row=False):
    n = np.random.default_rng(seed).integers(2, T + 1, size=B)
    if all_pad_row:
        n[0] = 0
    real = np.arange(T)[None, :] < n[:, None]
    return np.where(real, 0.0, -1e9).astype(np.float32), real


def _segments(B, T, all_pad_row=False):
    """Packed rows: jets of width 5 and 4, then pads (-1)."""
    seg = np.full((B, T), -1, np.int32)
    seg[:, :5] = 0
    seg[:, 5:9] = 1
    if all_pad_row:
        seg[0] = -1
    return seg, seg >= 0


def _case(form, B, T, C, all_pad_row=False):
    km = seg = None
    real = np.ones((B, T), bool)
    if form == "key_mask":
        km, real = _key_mask(B, T, all_pad_row=all_pad_row)
    elif form == "segments":
        seg, real = _segments(B, T, all_pad_row=all_pad_row)
    return _qkv(B, T, C), km, seg, real


def _torch(a):
    return None if a is None else torch.from_numpy(a)


def _jnp(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("form,B,T,C,H", [
    ("key_mask", 12, 10, 32, 4),
    ("segments", 8, 12, 32, 4),
    ("none", 6, 10, 32, 4),
])
def test_reference_matches_jax(form, B, T, C, H):
    (q, k, v), km, seg, real = _case(form, B, T, C)
    out = attention_btc_reference(*map(_torch, (q, k, v)), H, _torch(km), _torch(seg)).numpy()
    xla = np.asarray(_xla_attention_btc(*map(_jnp, (q, k, v)), H, None, _jnp(km),
                                        segments=_jnp(seg)))
    pallas = np.asarray(pallas_btc_attention(*map(_jnp, (q, k, v)), _jnp(km), _jnp(seg),
                                             H, 16, True))
    np.testing.assert_allclose(out[real], xla[real], atol=ATOL)
    np.testing.assert_allclose(out[real], pallas[real], atol=ATOL)


@pytest.mark.parametrize("form", ["key_mask", "segments"])
def test_all_pad_row_stays_finite(form):
    """A row that is all pad (every key masked, or segment -1 throughout)
    comes out finite and equal to JAX's, pad queries included."""
    H = 4
    (q, k, v), km, seg, _ = _case(form, 8, 12, 32, all_pad_row=True)
    out = attention_btc_reference(*map(_torch, (q, k, v)), H, _torch(km), _torch(seg)).numpy()
    assert np.isfinite(out).all()
    xla = np.asarray(_xla_attention_btc(*map(_jnp, (q, k, v)), H, None, _jnp(km),
                                        segments=_jnp(seg)))
    np.testing.assert_allclose(out[0], xla[0], atol=ATOL)


def test_cpu_dispatch_takes_plain_path_without_launching():
    (q, k, v), km, seg, _ = _case("segments", 8, 12, 32)
    q, k, v, seg = map(_torch, (q, k, v, seg))
    k1.reset_launch_counts()
    out = multihead_attention_btc(q, k, v, 4, segments=seg)
    assert k1.LAUNCHES == {"segments": 0, "key_mask": 0, "none": 0}
    torch.testing.assert_close(out, attention_btc_reference(q, k, v, 4, segments=seg),
                               rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors_and_unported_forms():
    q, k, v = map(_torch, _qkv(2, 6, 32))
    with pytest.raises(ValueError, match="CUDA"):
        k1.btc_attention(q, k, v, 4)
    # probability dropout is ported: it takes the plain version, by name,
    # with or without a bias, and never a kernel
    attention.reset_plain_dropout_calls()
    gen = torch.Generator().manual_seed(0)
    out = multihead_attention_btc(q, k, v, 4, dropout_rate=0.1, generator=gen)
    biased = multihead_attention_btc(q, k, v, 4, bias=torch.zeros(2, 1, 6, 6),
                                     dropout_rate=0.1, generator=gen.manual_seed(0))
    torch.testing.assert_close(out, biased, rtol=0, atol=0)
    assert attention.PLAIN_DROPOUT_CALLS == {"head_major": 0, "token_major": 2}
    assert k1.LAUNCHES == {"segments": 0, "key_mask": 0, "none": 0}


def test_autograd_through_reference_matches_jax():
    """The kernel's backward recomputes through the reference; its
    gradients equal JAX's on the segment form."""
    import jax

    H = 4
    (q, k, v), _, seg, _ = _case("segments", 8, 12, 32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    (attention_btc_reference(tq, tk, tv, H, segments=torch.from_numpy(seg)) ** 2).sum().backward()
    g_jax = jax.grad(lambda a, b, c: (_xla_attention_btc(
        a, b, c, H, None, None, segments=jnp.asarray(seg)) ** 2).sum(),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for t, g in zip((tq, tk, tv), g_jax):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-4)
