"""K1 and K2 past 256 keys and past a head size of 128, on the CPU.

The kernels take any Tq, Tk and head size: their wrappers refuse only
malformed input, and the host plans (`ops/set_attention.py:fp32_plan`,
`bf16_plan`) say how a call runs there (the bf16 ring's stages, the slices
of 128 output columns) and raise, naming the shared memory, where a block
cannot hold the call.  The kernels themselves run on the card
(`chip_smoke.py:wide_phase`); here:

- the wrappers' checks accept the wide shapes and refuse malformed ones;
- the plans at Tk up to 4096 and head sizes 136-512 fit a block, with a
  ring of at least 2 stages and ceil(hs / 128) slices, and at Tk <= 256,
  head size <= 128 they equal the plan of the capped kernels;
- the plain versions, which the kernels are held to on the card, against
  the JAX package at these shapes: K1's against `pallas_btc_attention` in
  interpret mode, K2's against `_xla_attention` / `_xla_attention_btc`
  (`pallas_set_attention` has no interpret mode);
- the slice against the JAX package on converted weights, at depth 1 and
  narrow widths: ParticleFormer at D = 300 and at one head of 160, the
  packed loss at `pack_width` 512, GPT's logits and decode at
  `max_seq_length` 300.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.config import Config as JaxConfig
from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
from multimodal_flows_tpu.ops.attention import _xla_attention, _xla_attention_btc
from multimodal_flows_tpu.ops.pallas_attention import pallas_btc_attention
from multimodal_flows_tpu.train.gpt import GPT as JaxGPT
from multimodal_flows_tpu.train.systems import MMF as JaxMMF
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.convert import load_flax_params, params_from_flax
from multimodal_flows_tpu_torch.data.datasets import jet_set_to_seq
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.ops import btc_attention as k1
from multimodal_flows_tpu_torch.ops import set_attention as k2
from multimodal_flows_tpu_torch.ops.attention import (
    attention_btc_reference,
    attention_reference,
    causal_bias,
)
from multimodal_flows_tpu_torch.train.gpt import GPT
from multimodal_flows_tpu_torch.train.systems import MMF
from tests.test_torch_model import _packed, _randomize, _to_numpy

torch.set_num_threads(2)

# fp32 on both sides; sums over up to 512 keys in another order
ATOL = 1e-5
# the whole encoder or GPT: a few layers of such sums
MODEL_ATOL = 2e-5
# gradients relative to the largest entry of each tensor, with a floor for
# gradients that are zero in exact arithmetic (as tests/test_torch_model.py)
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-9

LENGTHS = [257, 300, 302, 512, 1024, 2048, 4096]
HEAD_SIZES = [136, 160, 256, 512]


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _key_mask(B, T, seed=1):
    """Trailing pads; every row keeps at least 2 keys."""
    n = np.random.default_rng(seed).integers(2, T + 1, size=B)
    return np.where(np.arange(T)[None, :] < n[:, None], 0.0, -1e9).astype(np.float32)


def _segments(B, T, seed=2):
    """Packed rows: jets of 3-150 tokens back to back, then pads (-1)."""
    rng = np.random.default_rng(seed)
    seg = np.full((B, T), -1, np.int32)
    for b in range(B):
        pos, j = 0, 0
        while True:
            n = int(np.clip(rng.poisson(40), 3, 150))
            if pos + n > T - 4:
                break
            seg[b, pos:pos + n], pos, j = j, pos + n, j + 1
    return seg


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _torch(a):
    return None if a is None else torch.from_numpy(a)


# ----------------------------------------------------------- the wrappers


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("B, T, C, H", [(2, 300, 256, 4), (2, 512, 256, 4), (1, 4096, 256, 4),
                                        (2, 300, 256, 1), (2, 257, 1024, 2), (1, 2048, 512, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_check_accepts_any_length_and_head_size(B, T, C, H, dtype):
    q = _meta(B, T, C, dtype=dtype)
    k1._check(q, q, q, H, _meta(B, T), None)
    k1._check(q, q, q, H, None, _meta(B, T, dtype=torch.int32))


@pytest.mark.parametrize("case, match", [
    ("k shape", "shape"), ("v dtype", "must be"), ("key_mask shape", r"\(B, T\)"),
    ("segments dtype", "int32"), ("not contiguous", "contiguous"), ("heads", "multiple"),
    ("rank", r"\(B, T, C\)"), ("device", "is on")])
def test_k1_check_still_refuses_malformed_input(case, match):
    B, T, C, H = 2, 300, 256, 4
    q = k = v = _meta(B, T, C)
    km, seg, n_head = None, None, H
    if case == "k shape":
        k = _meta(B, T + 1, C)
    elif case == "v dtype":
        v = _meta(B, T, C, dtype=torch.bfloat16)
    elif case == "key_mask shape":
        km = _meta(B, T - 1)
    elif case == "segments dtype":
        seg = _meta(B, T)
    elif case == "not contiguous":
        q = _meta(B, C, T).transpose(1, 2)
        k = v = q
    elif case == "heads":
        n_head = 3
    elif case == "rank":
        q = k = v = _meta(B, T, 4, C // 4)
    elif case == "device":
        km = torch.zeros(B, T)
    with pytest.raises(ValueError, match=match):
        k1._check(q, k, v, n_head, km, seg)


@pytest.mark.parametrize("B, H, Tq, Tk, D", [(2, 4, 300, 300, 64), (2, 4, 1, 302, 64),
                                             (2, 1, 512, 512, 256), (1, 1, 300, 300, 512),
                                             (2, 2, 20, 4096, 160)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_check_accepts_any_length_and_head_size(B, H, Tq, Tk, D, dtype):
    q, kv = _meta(B, H, Tq, D, dtype=dtype), _meta(B, H, Tk, D, dtype=dtype)
    bias = k2._check(q, kv, kv, _meta(B, Tk), _meta(B, 1, Tq, Tk), None)
    assert bias.shape == (B, H, Tq, Tk)
    if Tq == Tk:
        k2._check(q, kv, kv, None, _meta(H, Tq, Tk), _meta(B, Tq, dtype=torch.int32))


@pytest.mark.parametrize("case, match", [
    ("k shape", "do not match"), ("q dtype", "must be one of"), ("key_mask", r"\(B, Tk\)"),
    ("segments without bias", "K1's form"), ("segments Tq != Tk", "Tq == Tk"),
    ("bias rank", "broadcast"), ("fp32 with a bf16 bias", "bias must be")])
def test_k2_check_still_refuses_malformed_input(case, match):
    B, H, T, D = 2, 4, 300, 64
    q = k = v = _meta(B, H, T, D)
    km, bias, seg = None, _meta(B, H, T, T), None
    if case == "k shape":
        k = _meta(B, H, T, D + 1)
    elif case == "q dtype":
        q = k = v = _meta(B, H, T, D, dtype=torch.float16)
    elif case == "key_mask":
        km = _meta(B, T + 1)
    elif case == "segments without bias":
        bias, seg = None, _meta(B, T, dtype=torch.int32)
    elif case == "segments Tq != Tk":
        q, seg = _meta(B, H, T - 2, D), _meta(B, T - 2, dtype=torch.int32)
        bias = _meta(B, H, T - 2, T)
    elif case == "bias rank":
        bias = _meta(1, B, H, T, T)
    elif case == "fp32 with a bf16 bias":
        bias = _meta(B, H, T, T, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        k2._check(q, k, v, km, bias, seg)


def test_wrappers_refuse_cpu_tensors_at_wide_shapes():
    q = torch.zeros(1, 300, 256)
    with pytest.raises(ValueError, match="CUDA"):
        k1.btc_attention(q, q, q, 1)
    with pytest.raises(ValueError, match="CUDA"):
        k2.set_attention_btc(q, q, q, 1, bias=torch.zeros(1, 1, 300, 300))
    with pytest.raises(ValueError, match="CUDA"):
        k2.set_attention_btc(q, q, q, 1, causal=True)


# ------------------------------------------------------------- the plans


def _views(Tq, Tk, hs, dtype=torch.bfloat16):
    return torch.zeros(1, 1, Tq, hs, dtype=dtype), torch.zeros(1, 1, Tk, hs, dtype=dtype)


@pytest.mark.parametrize("hs", HEAD_SIZES)
@pytest.mark.parametrize("Tk", LENGTHS)
def test_plans_fit_with_a_ring_and_slices(Tk, hs):
    """Both cores past the old limits: the shared memory under 227 KB, ceil(hs
    / 128) slices of 128 columns, the bf16 ring at least 2 chunks deep
    (nothing of the bias by TMA in slices)."""
    q, kv = _views(64, Tk, hs)
    bias = torch.zeros(1, 1, 64, Tk)
    plan = k2.bf16_plan(q, kv, kv, bias)
    slices = -(-hs // 128)
    assert (plan.slices, plan.head_bucket, plan.key_tiles) == (slices, 128, -(-Tk // 64))
    assert 2 <= plan.stages <= k2.MAX_SLICED_STAGES and not plan.bias_tma
    assert plan.smem_bytes <= k2.MAX_SHARED_BYTES
    # the query rows of the whole head, the ring's chunks, mask and ids
    assert plan.smem_bytes >= (slices + plan.stages) * 64 * 128 * 2 + 8 * Tk
    f = k2.fp32_plan(q.float(), kv.float(), kv.float())
    assert (f.slices, f.head_bucket, f.chunk) == (slices, 128, 64)
    assert 1 <= f.stages <= k2.MAX_FP32_STAGES
    assert f.smem_bytes <= k2.MAX_SHARED_BYTES
    # the query rows of the whole head, a stage and the work chunks, mask and ids
    assert f.smem_bytes >= 64 * hs * 4 + 3 * 64 * 64 * 4 + 8 * Tk


@pytest.mark.parametrize("hs, bucket", [(9, 32), (64, 64), (128, 128)])
@pytest.mark.parametrize("Tk", LENGTHS)
@pytest.mark.parametrize("bias_dtype", [None, torch.float32])
def test_whole_head_ring_past_256_keys(Tk, hs, bucket, bias_dtype):
    """Head sizes <= 128 past 256 keys: a ring of 2-4 stages of 64 keys
    (with the bias block where TMA reads it) that fits, one slice."""
    q, kv = _views(64, Tk, hs)
    bias = None if bias_dtype is None else torch.zeros(1, 1, 64, Tk, dtype=bias_dtype)
    plan = k2.bf16_plan(q, kv, kv, bias)
    assert (plan.slices, plan.head_bucket) == (1, bucket)
    assert 2 <= plan.stages <= k2.MAX_RING_STAGES < plan.key_tiles
    assert plan.smem_bytes <= k2.MAX_SHARED_BYTES
    assert plan.bias_tma == (bias is not None and Tk % 4 == 0)
    assert k2.fp32_plan(q.float(), kv.float(), kv.float()).slices == 1


def _pr10_bf16_smem(bucket, Tk, bias_tile):
    """The bf16 kernel's shared memory when Tk was capped at 256: the whole
    row resident, one barrier a key tile."""
    tile, out, n = 64 * bucket * 2, 64 * (bucket + 8) * 2, -(-Tk // 64)
    k = -(-max(tile, out) // 1024) * 1024
    bar = -(-(k + 2 * n * tile + n * bias_tile + 8 * Tk + 128) // 8) * 8
    return bar + 8 * (1 + n) + 1024


@pytest.mark.parametrize("Tk", [1, 33, 64, 100, 128, 150, 200, 256])
@pytest.mark.parametrize("hs", [9, 32, 36, 64, 100, 128])
@pytest.mark.parametrize("bias_dtype", [None, torch.bfloat16, torch.float32])
def test_plans_at_the_old_shapes_are_unchanged(Tk, hs, bias_dtype):
    """At Tk <= 256 and head size <= 128 the bf16 plan keeps every key tile
    resident (the ring never wraps) with the shared memory of the capped
    kernel; the fp32 plan holds the whole head in one block, in chunks of
    64 rows x 64 columns (32 at head size <= 32): Q's, the ring's and the
    work chunks, then the mask, the ids and the tile intervals."""
    q, kv = _views(Tk, Tk, hs)
    bias = None if bias_dtype is None else torch.zeros(1, 1, Tk, Tk, dtype=bias_dtype)
    plan = k2.bf16_plan(q, kv, kv, bias)
    bias_tile = 64 * 64 * bias.element_size() if plan.bias_tma else 0
    assert plan.stages == plan.key_tiles == -(-Tk // 64) and plan.slices == 1
    assert plan.smem_bytes == _pr10_bf16_smem(plan.head_bucket, Tk, bias_tile)
    f = k2.fp32_plan(q.float(), kv.float(), kv.float())
    w = 32 if hs <= 32 else 64
    chunks = -(-hs // w) + f.stages + (3 if hs <= 64 else 2)
    ints = max(32, 8 + 3 * -(-Tk // 64))
    at_bars = -(-(chunks * 64 * w * 4 + 8 * Tk + 4 * ints) // 8) * 8
    assert (f.slices, f.chunk, f.key_tiles) == (1, w, -(-Tk // 64))
    assert f.smem_bytes == at_bars + 8 * (1 + 2 * f.stages) + 1024


@pytest.mark.parametrize("hs, Tk, form", [(128, 20480, "fp32"), (256, 16384, "fp32"),
                                          (512, 16384, "bf16"), (2048, 1024, "bf16"),
                                          (1024, 4096, "fp32")])
def test_the_shared_memory_bound_is_named(hs, Tk, form):
    """What bounds the shapes now: a block's 227 KB (the key mask and ids
    staged whole, the query rows of a whole head in slices)."""
    with pytest.raises(ValueError, match=f"the {form} kernel needs .* shared memory"):
        if form == "fp32":
            q, kv = _views(64, Tk, hs, torch.float32)
            k2.fp32_plan(q, kv, kv)
        else:
            k2.bf16_plan(*_views(64, Tk, hs)[:1], *[_views(64, Tk, hs)[1]] * 2)


def test_a_bias_that_would_not_fit_goes_per_fragment():
    """At 16,384 keys the bias blocks no longer fit beside a ring: the plan
    reads the bias per fragment instead of refusing the call."""
    q, kv = _views(64, 16384, 128)
    plan = k2.bf16_plan(q, kv, kv, torch.zeros(1, 1, 64, 16384))
    assert not plan.bias_tma and plan.stages >= 2
    assert plan.smem_bytes <= k2.MAX_SHARED_BYTES


# ------------------------------------------------ the plain versions vs JAX


@pytest.mark.parametrize("form", ["key_mask", "segments"])
@pytest.mark.parametrize("T, C, H", [(257, 256, 4), (300, 256, 4), (300, 320, 2)])
def test_plain_k1_matches_pallas_interpret(form, T, C, H):
    B = 2
    q, k, v = (_normal((B, T, C), s) for s in range(3))
    km = _key_mask(B, T) if form == "key_mask" else None
    seg = _segments(B, T) if form == "segments" else None
    real = seg >= 0 if seg is not None else np.ones((B, T), bool)
    out = attention_btc_reference(*map(_torch, (q, k, v)), H, _torch(km), _torch(seg)).numpy()
    ref = np.asarray(pallas_btc_attention(*map(_jnp, (q, k, v)), _jnp(km), _jnp(seg), H, 2,
                                          True))
    np.testing.assert_allclose(out[real], ref[real], atol=ATOL)


@pytest.mark.parametrize("form", ["bias", "bias_key_mask", "bias_segments"])
def test_plain_k2_with_a_bias_at_300_matches_jax(form):
    B, T, C, H = 2, 300, 128, 4
    q, k, v = (_normal((B, T, C), s) for s in range(3, 6))
    bias = _normal((B, H, T, T), 6)
    km = _key_mask(B, T) if form == "bias_key_mask" else None
    seg = _segments(B, T) if form == "bias_segments" else None
    real = seg >= 0 if seg is not None else np.ones((B, T), bool)
    out = attention_btc_reference(*map(_torch, (q, k, v)), H, _torch(km), _torch(seg),
                                  _torch(bias)).numpy()
    ref = np.asarray(_xla_attention_btc(*map(_jnp, (q, k, v)), H, _jnp(bias), _jnp(km),
                                        segments=_jnp(seg)))
    np.testing.assert_allclose(out[real], ref[real], atol=ATOL)
    # the head-major form (CrossAttention's), a (B, 1, T, T) bias
    qh, kh, vh = (x.reshape(B, T, H, C // H).transpose(0, 2, 1, 3) for x in (q, k, v))
    out = attention_reference(*map(_torch, (qh, kh, vh)), _torch(km),
                              _torch(bias[:, :1])).numpy()
    ref = np.asarray(_xla_attention(*map(_jnp, (qh, kh, vh)), _jnp(bias[:, :1]), _jnp(km)))
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_plain_k2_causal_at_302_matches_jax():
    """GPT's full forward: the causal bias JAX adds, at 302 tokens."""
    B, T, C, H = 2, 302, 128, 4
    q, k, v = (_normal((B, T, C), s) for s in range(7, 10))
    bias = causal_bias(T, torch.device("cpu"))
    out = attention_btc_reference(*map(_torch, (q, k, v)), H, None, None, bias).numpy()
    ref = np.asarray(_xla_attention_btc(*map(_jnp, (q, k, v)), H, jnp.asarray(bias.numpy()),
                                        None))
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("pos", [0, 150, 301])
def test_plain_k2_decode_at_302_matches_jax(pos):
    """GPT's decode: one query against 302 cached keys under the causal key
    mask of position `pos`."""
    B, T, C, H = 3, 302, 128, 4
    q = _normal((B, 1, C), 10)
    k, v = _normal((B, T, C), 11), _normal((B, T, C), 12)
    km = np.broadcast_to(np.where(np.arange(T) <= pos, 0.0, -1e9), (B, T)).astype(np.float32)
    out = attention_btc_reference(*map(_torch, (q, k, v)), H, _torch(km.copy())).numpy()
    ref = np.asarray(_xla_attention_btc(*map(_jnp, (q, k, v)), H, None, _jnp(km)))
    np.testing.assert_allclose(out, ref, atol=ATOL)


# -------------------------------------------------------------- the slice

WIDE = dict(model="ParticleFormer", n_embd=32, n_inner=64, n_layer=1, n_layer_fused=1,
            n_head=4, vocab_size=9, dim_continuous=3, max_num_particles=300)
ONE_HEAD = dict(WIDE, n_embd=160, n_inner=64, n_head=1)   # head sizes 80 and 160


def _jets(mults, D, seed=0):
    rng = np.random.default_rng(seed)
    mask = (np.arange(D)[None, :] < np.asarray(mults)[:, None]).astype(np.int32)[..., None]
    x = (rng.normal(size=(len(mults), D, 3)) * mask).astype(np.float32)
    k = (rng.integers(1, 9, size=(len(mults), D, 1)) * mask).astype(np.int32)
    return x, k, mask


def _mmf_pair(cfg, seed):
    jsys = JaxMMF(JaxConfig(**cfg))
    params = jax.jit(jsys.init_params)(jax.random.PRNGKey(seed))["params"]
    params = {"encoder": _randomize(params["encoder"], seed + 1),
              "multitask": params["multitask"]}
    tsys = MMF(Config(**cfg), device="cpu")
    load_flax_params(tsys.module, _to_numpy(params))
    return jsys, params, tsys


@pytest.mark.parametrize("cfg", [WIDE, ONE_HEAD], ids=["D300", "one head of 160"])
def test_particleformer_at_300_tokens_matches_jax(cfg):
    """The encoder on padded jets of up to 300 tokens (the key-mask path
    at T = 300), both heads on the real tokens."""
    jsys, params, tsys = _mmf_pair(cfg, 11)
    x, k, mask = _jets([300, 211, 57], 300, seed=1)
    t = np.array([0.2, 0.5, 0.9], np.float32)
    ref = jax.jit(lambda s: jsys.module.apply({"params": params}, s))(JaxMultiModal(
        time=jnp.asarray(t), continuous=jnp.asarray(x), discrete=jnp.asarray(k),
        mask=jnp.asarray(mask)))
    with torch.no_grad():
        out = tsys.module.encoder(MultiModal(time=torch.from_numpy(t),
                                             continuous=torch.from_numpy(x),
                                             discrete=torch.from_numpy(k),
                                             mask=torch.from_numpy(mask)))
    real = mask[..., 0] > 0
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy()[real], np.asarray(r)[real], atol=MODEL_ATOL)


def test_packed_loss_at_pack_width_512_matches_jax():
    """`packed_training_loss` on rows of 512 (jets of up to 300), injected
    bridge states: the loss and every parameter gradient."""
    cfg = dict(WIDE, multitask_loss="time-weighted", sigma=0.0)
    jsys, params, tsys = _mmf_pair(cfg, 21)
    mults = [300, 150, 41, 212, 97, 8, 260, 33]
    x, k, mask = _jets(mults, 300, seed=2)
    x, k, mask, seg, _, _ = _packed(x, k, mask, 512)
    assert x.shape[1] == 512 and len(x) >= 2
    rng = np.random.default_rng(3)
    J = int(seg.max()) + 1
    jet_valid = np.stack([[(seg[r] == j).any() for j in range(J)] for r in range(len(seg))])
    jet_valid = jet_valid.astype(np.float32)
    t_jets = rng.uniform(0.05, 0.95, jet_valid.shape).astype(np.float32)
    t_tok = np.take_along_axis(t_jets, np.clip(seg, 0, None), axis=1)
    drift = (rng.normal(size=x.shape) * mask).astype(np.float32)
    xt = (rng.normal(size=x.shape) * mask).astype(np.float32)

    def jloss(p):
        return jsys.module.apply(
            {"params": p}, JaxMultiModal(time=jnp.asarray(t_tok), continuous=jnp.asarray(xt),
                                         discrete=jnp.asarray(k), mask=jnp.asarray(mask)),
            jnp.asarray(drift), jnp.asarray(k), jnp.asarray(t_jets), jnp.asarray(seg),
            jnp.asarray(jet_valid), method="packed_training_loss")[0]

    ref, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)
    ref_grads = params_from_flax(_to_numpy(ref_grads))
    module = tsys.module
    module.zero_grad()
    out = module.packed_training_loss(
        MultiModal(time=torch.from_numpy(t_tok), continuous=torch.from_numpy(xt),
                   discrete=torch.from_numpy(k), mask=torch.from_numpy(mask)),
        torch.from_numpy(drift), torch.from_numpy(k), torch.from_numpy(t_jets),
        torch.from_numpy(seg), torch.from_numpy(jet_valid))
    out[0].backward()
    np.testing.assert_allclose(float(out[0].detach()), float(ref), rtol=1e-5)
    for name, p in module.named_parameters():
        g = ref_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, atol=GRAD_RTOL * np.abs(g).max()
                                   + GRAD_FLOOR, rtol=0, err_msg=name)


GPT_WIDE = dict(vocab_size=9, max_seq_length=300, n_embd=32, n_inner=64, n_layer=1, n_head=2,
                batch_size=4)


@pytest.fixture(scope="module")
def gpt_pair():
    jsys = JaxGPT(JaxConfig(**GPT_WIDE, activation="gelu_new"))
    params = _randomize(jsys.init_params(jax.random.PRNGKey(30))["params"], 31)
    system = GPT(Config(**GPT_WIDE, activation="gelu_new"), device="cpu")
    load_flax_params(system.module, _to_numpy(params))
    rng = np.random.default_rng(32)
    D = GPT_WIDE["max_seq_length"]
    mask = (np.arange(D)[None, :] < np.array([300, 123, 7])[:, None])[..., None]
    tokens = (rng.integers(1, 9, size=(3, D, 1)) * mask).astype(np.int32)
    ids = jet_set_to_seq(MultiModal(discrete=tokens, mask=mask.astype(np.int32)), 9).discrete
    return jsys, {"params": params}, system, ids


def test_gpt_logits_at_302_tokens_match_jax(gpt_pair):
    jsys, params, system, ids = gpt_pair
    assert ids.shape == (3, 302)
    ref = np.asarray(jax.jit(lambda i: jsys.module.apply(params, i))(jnp.asarray(ids)))
    with torch.no_grad():
        out = system.module(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(out, ref, atol=MODEL_ATOL)


def test_gpt_decode_over_302_positions_matches_jax(gpt_pair):
    """The KV-cached decode at every position of 302 against JAX's decode
    (one query against the cache under the causal key mask)."""
    jsys, params, system, ids = gpt_pair
    B, T = ids.shape
    decode = jax.jit(lambda i, t, c: jsys.module.apply(params, i, t, c, method="decode"))
    jcaches = jsys.module.apply(params, B, method="init_cache")
    caches = system.module.init_cache(B)
    with torch.no_grad():
        for t in range(T):
            ref, jcaches = decode(jnp.asarray(ids[:, t]), jnp.int32(t), jcaches)
            out, caches = system.module.decode(torch.from_numpy(ids[:, t]), t, caches)
            if t in (0, 1, 150, 255, 256, 257, T - 1):
                np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=MODEL_ATOL,
                                           err_msg=f"pos {t}")
    for (k, v), (jk, jv) in zip(caches, jcaches):
        np.testing.assert_allclose(k.numpy(), np.asarray(jk), atol=MODEL_ATOL)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=MODEL_ATOL)
