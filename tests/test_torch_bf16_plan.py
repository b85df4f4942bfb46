"""The host plan of K1's and K2's bf16 core (`ops/set_attention.py:bf16_plan`),
on the CPU: which operands a call hands to TMA and how much shared memory
it takes.  The plan is all the host decides; the kernel (run on the card
by `chip_smoke.py:check_bf16_kernels`, which prints each case's plan)
follows it, and its C entry refuses a plan whose shared memory is not its
own count.

- Every bias the bf16 encoders produce at the flagship's and the training
  CLI's widths, on packed rows of 128 and at the bucket widths whose rows
  meet TMA's 16-byte rule, goes through shared memory by TMA, and their
  q/k/v by TMA too.
- Biases whose strides miss the rules (rows of 150 values, a view of a
  wider tensor, keys not contiguous, a base off 16 bytes) and odd head
  sizes do not.
- The shared memory stays under the 227 KB a block has at the limits.
"""

import numpy as np
import pytest
import torch

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.models import attention as mattn
from multimodal_flows_tpu_torch.ops import set_attention as k2
from multimodal_flows_tpu_torch.train import systems

torch.set_num_threads(2)

# the flagship (ParticleFormer + co-occurrence) and the training CLI's
# widths (scripts/train_mmf.py: n_embd 256, 4 heads), as chip_smoke.py runs them
WIDTHS = dict(n_embd=256, n_inner=512, n_layer=1, n_layer_fused=1, n_head=4, vocab_size=9,
              dim_continuous=3, max_num_particles=150, pair_chunk=16,
              compute_dtype="bfloat16")
ENCODERS = {
    "ParticleFormer co-occurrence": ("MMF", dict(model="ParticleFormer", use_coocurrence=True)),
    "FusedParticleFormer": ("MMF", dict(model="FusedParticleFormer")),
    "FlavorFormer pairwise": ("MJB", dict(model="FlavorFormer", use_pairwise=True,
                                          use_pos_emb=True)),
    "KinFormer Lund": ("CFM", dict(model="KinFormer", use_pairwise=True,
                                   metadata={"mean": [2.0, 0.1, -0.2],
                                             "std": [3.0, 0.5, 0.7]})),
}


class _Captured(Exception):
    pass


def _first_attention(name, width, packed):
    """The first self-attention call of the bf16 encoder `name` on jets of
    `width` (packed rows with segments, or padded jets): (q, k, v, n_head,
    bias)."""
    kind, kw = ENCODERS[name]
    system = systems.build_system(Config(**WIDTHS, **kw), kind, device="cpu")
    encoder = system.module.encoder if kind == "MMF" else system.module
    if hasattr(encoder, "lambda_u"):  # 0 at init turns the pairwise bias off
        with torch.no_grad():
            encoder.lambda_u.fill_(0.5)
    rng = np.random.default_rng(width)
    B = 2
    mult = rng.integers(3, width + 1, size=B)
    mask = (np.arange(width)[None, :] < mult[:, None]).astype(np.int32)[..., None]
    x = (rng.normal(size=(B, width, 3)) * mask).astype(np.float32)
    tok = (rng.integers(1, 9, size=(B, width, 1)) * mask).astype(np.int32)
    segments = None
    t = np.full((B,), 0.5, np.float32)
    if packed:  # two jets a row
        segments = torch.from_numpy(np.where(np.arange(width) < width // 2, 0, 1)[None]
                                    .repeat(B, 0).astype(np.int32))
        mask[:] = 1
        t = np.full((B, width), 0.5, np.float32)
    state = MultiModal(time=torch.from_numpy(t), continuous=torch.from_numpy(x),
                       discrete=torch.from_numpy(tok), mask=torch.from_numpy(mask))
    seen = {}

    def capture(q, k, v, n_head, bias=None, key_mask=None, **_):
        seen.update(q=q, k=k, v=v, n_head=n_head, bias=bias)
        raise _Captured

    real = mattn.multihead_attention_btc
    mattn.multihead_attention_btc = capture
    try:
        with torch.no_grad(), pytest.raises(_Captured):
            encoder(state, segments)
    finally:
        mattn.multihead_attention_btc = real
    return seen["q"], seen["k"], seen["v"], seen["n_head"], seen["bias"]


def _plan(q, k, v, n_head, bias=None):
    views = [k2._heads(t, n_head) for t in (q, k, v)]
    B, H, Tq, _ = views[0].shape
    bias4 = None if bias is None else bias.expand(B, H, Tq, views[1].shape[2])
    return k2.bf16_plan(*views, bias4)


# packed rows of 128 (not FlavorFormer: its learned positions refuse
# packing) and the bucket widths 48, 64 and 128
CALLS = [(name, width, packed) for name in ENCODERS
         for width, packed in ((128, True), (48, False), (64, False), (128, False))
         if not (packed and name == "FlavorFormer pairwise")]


@pytest.mark.parametrize("name, width, packed", CALLS)
def test_encoder_biases_go_through_shared_memory_by_tma(name, width, packed):
    q, k, v, n_head, bias = _first_attention(name, width, packed)
    assert q.dtype == torch.bfloat16
    plan = _plan(q, k, v, n_head, bias)
    assert plan.qkv_tma
    if name == "FusedParticleFormer":
        assert bias is None
    else:
        assert bias is not None and bias.dtype == torch.float32
        assert plan.bias_tma, (tuple(bias.shape), bias.stride())
    assert plan.smem_bytes <= k2.MAX_SHARED_BYTES


def _bf16(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape)
                            .astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("form", ["rows of 150", "rows of 150, bf16", "view of a wider tensor",
                                  "keys not contiguous", "base off 16 bytes",
                                  "broadcast over queries"])
def test_biases_that_miss_tma_rules_are_read_per_fragment(form):
    B, T, C, H = 2, 128, 256, 4
    if form.startswith("rows of 150"):
        T = 150
    q = _bf16(B, T, C)
    bias = torch.randn(B, H, T, T)
    if form == "rows of 150, bf16":
        bias = bias.to(torch.bfloat16)
    elif form == "view of a wider tensor":
        bias = torch.randn(B, H, T, T + 1)[..., :T]
    elif form == "keys not contiguous":
        bias = bias.transpose(-1, -2)
    elif form == "base off 16 bytes":
        bias = torch.randn(B * H * T * T + 1)[1:].view(B, H, T, T)
    elif form == "broadcast over queries":
        bias = torch.randn(B, 1, 1, T)
    plan = _plan(q, q, q, H, bias)
    assert plan.qkv_tma and not plan.bias_tma


@pytest.mark.parametrize("bias_shape", [(2, 4, 128, 128), (2, 1, 128, 128), (1, 1, 128, 128)])
def test_broadcast_biases_take_tma(bias_shape):
    """A zero stride over rows or heads is a map dimension of extent 1."""
    q = _bf16(2, 128, 256)
    assert _plan(q, q, q, 4, torch.randn(bias_shape)).bias_tma


@pytest.mark.parametrize("C, H", [(36, 4), (144, 4)])
def test_odd_head_sizes_stage_qkv_in_the_kernel(C, H):
    """Head sizes 9 and 36: a head's rows are not 16-byte multiples apart,
    so the block's threads stage q/k/v; the bias may still go by TMA."""
    q = _bf16(2, 128, C)
    plan = _plan(q, q, q, H, torch.randn(2, H, 128, 128))
    assert not plan.qkv_tma and plan.bias_tma


def test_head_major_strided_views():
    """CrossAttention's head-major q/k/v with Tq != Tk: TMA takes them where
    their rows are 16-byte multiples apart (head size 64), not at head size
    9; a transposed view is never TMA's."""
    q, kv = _bf16(2, 4, 20, 64), _bf16(2, 4, 150, 64)
    assert k2.bf16_plan(q, kv, kv).qkv_tma
    q9, kv9 = _bf16(2, 3, 20, 9), _bf16(2, 3, 150, 9)
    assert not k2.bf16_plan(q9, kv9, kv9).qkv_tma
    assert not k2.bf16_plan(q.transpose(-1, -2), kv, kv).qkv_tma


@pytest.mark.parametrize("hs, bucket, swizzle", [(9, 32, 64), (32, 32, 64), (33, 64, 128),
                                                 (64, 64, 128), (100, 128, 128),
                                                 (128, 128, 128)])
@pytest.mark.parametrize("bias_dtype", [None, torch.bfloat16, torch.float32])
def test_shared_memory_fits_at_the_limits(hs, bucket, swizzle, bias_dtype):
    """Tk = 256 (4 key tiles of 64): the plan's head bucket and swizzle, and
    its shared memory under the 227 KB a block has, an fp32 bias at head
    size 128 the largest (217,256 bytes)."""
    T = 256
    q = _bf16(1, 1, T, hs)
    bias = None if bias_dtype is None else torch.zeros(1, 1, T, T, dtype=bias_dtype)
    plan = k2.bf16_plan(q, q, q, bias)
    assert (plan.head_bucket, plan.swizzle_bytes, plan.key_tiles) == (bucket, swizzle, 4)
    assert plan.smem_bytes <= k2.MAX_SHARED_BYTES
    tile = 64 * bucket * 2
    bias_bytes = 0 if bias_dtype is None else 4 * 64 * 64 * bias.element_size()
    assert plan.smem_bytes >= 8 * tile + bias_bytes  # every K and V tile, the bias blocks
    if (hs, bias_dtype) == (128, torch.float32):
        assert plan.smem_bytes == 217_256
