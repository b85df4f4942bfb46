"""The port's bf16 compute path (`Config.compute_dtype="bfloat16"`) against
the JAX package's, on the CPU, with the flax parameters converted
(`convert.params_from_flax`, fp32 as in JAX) and the inputs made with numpy
from a seed:

- the plain bf16 attention against each kernel's JAX function: K1's
  `pallas_btc_attention` in interpret mode and `_xla_attention_btc` (key
  mask and segments), K2's `_xla_reference` (its custom VJP's reference:
  the Pallas K2 has no interpret mode here) with an fp32 and a bf16 bias;
- each of the four transformer encoders, forward, on its key-mask (or
  pair-mask) form and on packed rows with segments;
- the MMF `packed_training_loss` on injected bridge states, the loss and
  every gradient;
- a few tau-leap steps of `simulate` on injected uniforms.

JAX's bf16 side is compiled with `xla_allow_excess_precision` off
(`_exact_jit`): with it on, XLA's CPU compiler keeps some bf16
intermediates in fp32, so the jitted forward rounds in fewer places than
the flax modules declare.  With it off, the jitted forward equals JAX's op
by op run, which rounds every layer's output to its `dtype`, as the port
does.

Only real tokens are compared (rows of pad queries are garbage by design).
Each encoder test also holds the port's distance to JAX-bf16 below JAX's
own distance between its bf16 and fp32 forwards: the port rounds where
flax rounds, not merely somewhere near fp32.  The attention runs through
the plain versions on both sides (the bf16 forms of K1 and K2 are held to
them on the card by chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_flows_tpu.config import Config as JaxConfig
from multimodal_flows_tpu.data.packing import build_packed_rows, pack_jets
from multimodal_flows_tpu.data.state import MultiModal as JaxMultiModal
from multimodal_flows_tpu.dynamics import solvers as jsolvers
from multimodal_flows_tpu.ops.attention import _xla_attention_btc
from multimodal_flows_tpu.ops.pallas_attention import _xla_reference, pallas_btc_attention
from multimodal_flows_tpu.train import systems as jsystems
from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.convert import load_flax_params, params_from_flax
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.dynamics import solvers
from multimodal_flows_tpu_torch.models import blocks
from multimodal_flows_tpu_torch.ops.attention import attention_btc_reference, attention_reference
from multimodal_flows_tpu_torch.train import systems

torch.set_num_threads(2)

BF16 = torch.bfloat16
# One bf16 ulp is 2^-8 relative (0.4%).  The plain attention rounds where
# XLA rounds (the probabilities, the output); the sums inside its fp32
# matmuls run in another order, so an output may land one ulp apart:
# outputs of order 1 within 1e-2.
ATTN_ATOL = 1e-2
# The Pallas K1 keeps its probabilities in fp32 for the product with v
# (pallas_attention.py:252), XLA and the port round them to bf16 first: a
# few ulp of the output apart.
PALLAS_ATOL = 3e-2
# An encoder: the same roundings on both sides; where an fp32 sum in
# another order puts an activation on the other side of a bf16 rounding,
# the later layers move by an ulp of their scale (9.7e-5 measured, the
# co-occurrence bias), against 3e-3 to 7e-3 between JAX's bf16 and fp32.
ENCODER_ATOL = 1e-3
# The loss: the same roundings, the fp32 sums in another order.  Its
# gradients: autograd rounds the bf16 activation gradients at other places
# than JAX's transpose rules (a cast's backward, the fp32 accumulations of
# bf16 products): up to a few bf16 ulp (1.6% measured) of a parameter's
# largest gradient; the key LayerNorm's bias has a gradient of 0 in exact
# arithmetic and rounding noise of ~1e-7 on both sides.
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_FLOOR = 3e-2, 2e-6
# 4 tau-leap steps, each feeding the next: where an activation rounds to the
# neighbouring bf16 (fp32 sums in another order) the drift moves by one ulp
# of the drift's scale times dt (1.8e-4 measured); a token may flip where
# a uniform falls within the rounding of its jump probability
SIM_ATOL, SIM_TOKENS_EQUAL = 1e-3, 0.99

D = 12
BASE = dict(n_embd=32, n_inner=64, n_layer=1, n_layer_fused=1, n_head=4, vocab_size=9,
            dim_continuous=3, max_num_particles=D, pair_chunk=5, compute_dtype="bfloat16")
ENCODERS = {
    "ParticleFormer": dict(BASE, model="ParticleFormer"),
    "ParticleFormer co-occurrence": dict(BASE, model="ParticleFormer", use_coocurrence=True),
    "FusedParticleFormer": dict(BASE, model="FusedParticleFormer"),
    "FlavorFormer pairwise": dict(BASE, model="FlavorFormer", use_pairwise=True),
    "KinFormer Lund": dict(BASE, model="KinFormer", use_pairwise=True,
                           metadata={"mean": [2.0, 0.1, -0.2], "std": [3.0, 0.5, 0.7]}),
}
KIND = {"ParticleFormer": "MMF", "FusedParticleFormer": "MMF", "FlavorFormer": "MJB",
        "KinFormer": "CFM"}
LAMBDA_U = 0.8


def _randomize(tree, seed):
    """Random values for every leaf (LayerNorm scales around 1, lambda_u
    set nonzero, the pair tables at scale 0.5 so the bias is O(1))."""
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)

    def draw(path, leaf):
        keys = [p.key for p in path]
        if keys[-1] == "lambda_u":
            return np.float32(LAMBDA_U)
        scale = 0.5 if {"wue", "wue_proj"} & set(keys) else 0.1
        noise = rng.normal(size=leaf.shape).astype(np.float32) * scale
        return noise + 1.0 if keys[-1] == "scale" else noise

    return jax.tree_util.tree_unflatten(treedef, [draw(p, l) for p, l in flat])


def _random_params(jsys, seed):
    """A JAX system's parameter tree, every leaf drawn by `_randomize` (no
    initialiser runs)."""
    return _randomize(jax.eval_shape(jsys.init_params, jax.random.PRNGKey(0))["params"], seed)


def _jets(N, mults, seed=0):
    rng = np.random.default_rng(seed)
    mask = (np.arange(D)[None, :] < np.asarray(mults)[:, None]).astype(np.int32)[..., None]
    x = (rng.normal(size=(N, D, 3)) * mask).astype(np.float32)
    k = (rng.integers(1, 9, size=(N, D, 1)) * mask).astype(np.int32)
    return x, k, mask


def _packed(x, k, mask, W=D):
    mults = mask[..., 0].sum(1)
    row_of, offset_of, n_rows = pack_jets(mults, W)
    row_mask, row_seg = build_packed_rows(mask, row_of, offset_of, n_rows, W)
    px = np.zeros((n_rows, W, 3), np.float32)
    pk = np.zeros((n_rows, W, 1), np.int32)
    for j, m in enumerate(mults):
        r, o = row_of[j], offset_of[j]
        px[r, o:o + m], pk[r, o:o + m] = x[j, :m], k[j, :m]
    return px, pk, row_mask.astype(np.int32), row_seg


def _states(t, x, k, mask):
    j = JaxMultiModal(time=jnp.asarray(t), continuous=jnp.asarray(x),
                      discrete=jnp.asarray(k), mask=jnp.asarray(mask))
    p = MultiModal(time=torch.from_numpy(t), continuous=torch.from_numpy(x),
                   discrete=torch.from_numpy(k), mask=torch.from_numpy(mask))
    return j, p


def _exact_jit(fn, *args):
    """`fn` jitted for `args` with every bf16 rounding kept (XLA may not
    widen bf16 intermediates to fp32)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _bf16_np(shape, seed, scale=1.0):
    """Normal values already rounded to bf16, as float32 arrays."""
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * scale
    return _f32(jnp.asarray(a, jnp.bfloat16))


# ------------------------------------------------------- plain attention


def _key_mask(B, T, seed=1):
    n = np.random.default_rng(seed).integers(2, T + 1, size=B)
    return np.where(np.arange(T)[None, :] < n[:, None], 0.0, -1e9).astype(np.float32), \
        np.arange(T)[None, :] < n[:, None]


@pytest.mark.parametrize("form", ["key_mask", "segments"])
def test_plain_bf16_attention_matches_k1s_jax_function(form):
    """bf16 q/k/v: the port's plain token-major attention (K1's plain
    version) against `_xla_attention_btc` and the Pallas K1 in interpret
    mode, both in bf16; the output is bf16 on both sides."""
    B, T, C, H = 6, 12, 32, 4
    q, k, v = (_bf16_np((B, T, C), s) for s in (1, 2, 3))
    km, real = _key_mask(B, T)
    seg = None
    if form == "segments":
        seg = np.full((B, T), -1, np.int32)
        seg[:, :5], seg[:, 5:9] = 0, 1
        km, real = None, seg >= 0
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    jkm = None if km is None else jnp.asarray(km)
    jseg = None if seg is None else jnp.asarray(seg)
    xla = _xla_attention_btc(jq, jk, jv, H, None, jkm, segments=jseg)
    pallas = pallas_btc_attention(jq, jk, jv, jkm, jseg, H, 16, True)
    assert xla.dtype == pallas.dtype == jnp.bfloat16
    tq, tk, tv = (torch.from_numpy(a).to(BF16) for a in (q, k, v))
    out = attention_btc_reference(tq, tk, tv, H, None if km is None else torch.from_numpy(km),
                                  None if seg is None else torch.from_numpy(seg))
    assert out.dtype == BF16
    out = out.float().numpy()
    np.testing.assert_allclose(out[real], _f32(xla)[real], atol=ATTN_ATOL, rtol=0)
    np.testing.assert_allclose(out[real], _f32(pallas)[real], atol=PALLAS_ATOL, rtol=0)


@pytest.mark.parametrize("bias_dtype", ["float32", "bfloat16"])
def test_plain_bf16_head_major_attention_matches_k2s_reference(bias_dtype):
    """bf16 q/k/v, a key mask and a (B, H, T, T) bias in fp32 or bf16: the
    port's head-major plain attention (K2's plain version) against JAX's
    `_xla_reference` (the reference of K2's custom VJP)."""
    B, H, T, Dh = 4, 2, 10, 16
    q, k, v = (_bf16_np((B, H, T, Dh), s) for s in (4, 5, 6))
    bias = _bf16_np((B, H, T, T), 7)
    km, real = _key_mask(B, T, seed=8)
    jdt = jnp.bfloat16 if bias_dtype == "bfloat16" else jnp.float32
    ref = _xla_reference(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(km),
                         jnp.asarray(bias, jdt))
    tdt = BF16 if bias_dtype == "bfloat16" else torch.float32
    out = attention_reference(*(torch.from_numpy(a).to(BF16) for a in (q, k, v)),
                              torch.from_numpy(km), torch.from_numpy(bias).to(tdt))
    assert out.dtype == BF16 and ref.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _f32(ref), atol=ATTN_ATOL, rtol=0)


# ------------------------------------------------------------ the encoders


@functools.lru_cache(maxsize=None)
def _encoder_pair(name, seed=3):
    """JAX's encoder in bf16 and in fp32 (applies to jit, the same
    randomized parameters), and the port's bf16 encoder holding them."""
    cfg_kw = ENCODERS[name]
    kind = KIND[cfg_kw["model"]]
    applies = {}
    for dt in ("bfloat16", "float32"):
        jsys = jsystems.SYSTEM_REGISTRY[kind](JaxConfig(**dict(cfg_kw, compute_dtype=dt)))
        if dt == "bfloat16":
            tree = _random_params(jsys, seed)
            enc = tree["encoder"] if kind == "MMF" else tree
        module = jsys.module

        def apply(state, segments=None, module=module):
            return module.apply({"params": tree}, state, segments=segments)

        applies[dt] = apply
    tsys = systems.build_system(Config(**cfg_kw), kind, device="cpu")
    encoder = tsys.module.encoder if kind == "MMF" else tsys.module
    load_flax_params(encoder, enc)
    return applies, encoder


def _max_err(outs, refs, real):
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    return max(float(np.abs(np.asarray(o, np.float32)[real] - _f32(r)[real]).max())
               for o, r in zip(outs, refs))


@pytest.mark.parametrize("form", ["mask", "segments"])
@pytest.mark.parametrize("name", list(ENCODERS))
def test_encoder_forward_matches_jax_bf16(name, form):
    """The forward in bf16 on padded jets (key mask, or the pair mask with
    a pairwise bias) and on packed rows (segments): within ENCODER_ATOL of
    JAX's bf16 forward on real tokens, and closer to it than JAX's bf16
    forward is to its own fp32 forward."""
    applies, encoder = _encoder_pair(name)
    x, k, mask = _jets(8, [12, 3, 7, 5, 9, 2, 4, 6])
    if form == "mask":
        t = np.linspace(0.1, 0.9, 8).astype(np.float32)
        seg = None
        real = mask[..., 0] > 0
    else:
        x, k, mask, seg = _packed(x, k, mask)
        t = np.random.default_rng(2).uniform(0.05, 0.95, mask.shape[:2]).astype(np.float32)
        real = seg >= 0
    js, ps = _states(t, x, k, mask)
    jseg = None if seg is None else jnp.asarray(seg)
    ref = _exact_jit(applies["bfloat16"], js, jseg)(js, jseg)
    ref32 = jax.jit(applies["float32"])(js, jseg)
    with torch.no_grad():
        out = encoder(ps, None if seg is None else torch.from_numpy(seg))
    outs = out if isinstance(out, tuple) else (out,)
    assert all(o.dtype == torch.float32 for o in outs)  # the fp32 heads
    err = _max_err(tuple(o.numpy() for o in outs), ref, real)
    gap = _max_err(tuple(_f32(r) for r in (ref if isinstance(ref, tuple) else (ref,))),
                   ref32, real)
    print(f"{name} {form}: port vs JAX bf16 {err:.3e}, JAX bf16 vs fp32 {gap:.3e}")
    assert err <= ENCODER_ATOL
    assert err < gap


def test_bf16_layers_round_where_flax_does():
    """`Dense` rounds the product before adding the bias (flax's `Dense`),
    `gelu` rounds after each op of JAX's bf16 GELU, `LayerNorm` returns its
    dtype: each equals its flax counterpart bit for bit here."""
    from flax import linen as nn

    from multimodal_flows_tpu.models import blocks as jblocks

    x = np.random.default_rng(0).normal(size=(64, 24)).astype(np.float32)
    mod = nn.Dense(16, dtype=jnp.bfloat16)
    params = _randomize(mod.init(jax.random.PRNGKey(0), x)["params"], 1)
    ref = _f32(mod.apply({"params": params}, x))
    dense = blocks.Dense(24, 16, dtype=BF16)
    load_flax_params(dense, params)
    with torch.no_grad():
        out = dense(torch.from_numpy(x))
    assert out.dtype == BF16
    np.testing.assert_array_equal(out.float().numpy(), ref)
    h = np.random.default_rng(1).normal(size=(4096,)).astype(np.float32) * 3
    ref = _f32(nn.gelu(jnp.asarray(h, jnp.bfloat16), approximate=False))
    np.testing.assert_array_equal(blocks.gelu(torch.from_numpy(h).to(BF16)).float().numpy(), ref)
    ln = jblocks.LayerNorm(dtype=jnp.bfloat16)
    xb = jnp.asarray(x, jnp.bfloat16)
    lp = _randomize(ln.init(jax.random.PRNGKey(0), xb)["params"], 2)
    ref = _f32(ln.apply({"params": lp}, xb))
    tln = blocks.LayerNorm(24, dtype=BF16)
    load_flax_params(tln, lp)
    with torch.no_grad():
        out = tln(torch.from_numpy(_f32(xb)).to(BF16))
    assert out.dtype == BF16
    # fp32 statistics in another order (flax: E[x^2] - E[x]^2): a value may
    # round to the neighbouring bf16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=1e-2, rtol=0)
    assert float((out.float().numpy() != ref).mean()) < 0.01


# --------------------------------------------------- training and sampling


@pytest.fixture(scope="module")
def mmf_pair():
    cfg = dict(BASE, model="ParticleFormer", multitask_loss="time-weighted", sigma=0.0)
    jsys = jsystems.MMF(JaxConfig(**cfg))
    params = _random_params(jsys, 5)
    tsys = systems.build_system(Config(**cfg), "MMF", device="cpu")
    load_flax_params(tsys.module, params)
    return jsys, params, tsys


def test_packed_training_loss_and_gradients_match_jax_bf16(mmf_pair):
    """MMF `packed_training_loss` in bf16 on injected bridge states: the
    loss and every parameter gradient against JAX's bf16 ones."""
    jsys, params, tsys = mmf_pair
    x, k, mask = _jets(10, [12, 3, 7, 5, 9, 2, 4, 6, 11, 8], seed=4)
    x, k, mask, seg = _packed(x, k, mask)
    rng = np.random.default_rng(6)
    J = int(seg.max()) + 1
    jet_valid = np.stack([[(seg[r] == j).any() for j in range(J)] for r in range(len(seg))])
    jet_valid = jet_valid.astype(np.float32)
    t_jets = rng.uniform(0.05, 0.95, jet_valid.shape).astype(np.float32)
    t_tok = np.take_along_axis(t_jets, np.clip(seg, 0, None), axis=1)
    drift = (rng.normal(size=x.shape) * mask).astype(np.float32)
    xt = (rng.normal(size=x.shape) * mask).astype(np.float32)

    def jloss(p):
        out = jsys.module.apply(
            {"params": p}, JaxMultiModal(time=jnp.asarray(t_tok), continuous=jnp.asarray(xt),
                                         discrete=jnp.asarray(k), mask=jnp.asarray(mask)),
            jnp.asarray(drift), jnp.asarray(k), jnp.asarray(t_jets), jnp.asarray(seg),
            jnp.asarray(jet_valid), method="packed_training_loss")
        return out[0]

    ref, ref_grads = _exact_jit(jax.value_and_grad(jloss), params)(params)
    ref_grads = params_from_flax(ref_grads)
    module = tsys.module
    module.zero_grad()
    out = module.packed_training_loss(
        MultiModal(time=torch.from_numpy(t_tok), continuous=torch.from_numpy(xt),
                   discrete=torch.from_numpy(k), mask=torch.from_numpy(mask)),
        torch.from_numpy(drift), torch.from_numpy(k), torch.from_numpy(t_jets),
        torch.from_numpy(seg), torch.from_numpy(jet_valid))
    out[0].backward()
    assert out[0].dtype == torch.float32
    np.testing.assert_allclose(float(out[0].detach()), float(ref), rtol=LOSS_RTOL)
    for name, p in module.named_parameters():
        assert p.dtype == torch.float32
        g = ref_grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, atol=GRAD_RTOL * np.abs(g).max()
                                   + GRAD_FLOOR, rtol=0, err_msg=name)


def test_tau_leap_steps_match_jax_bf16(mmf_pair):
    """A few hybrid tau-leap steps of `simulate` in bf16 on a shared source
    and injected uniforms: the final kinematics and tokens against JAX's."""
    jsys, params, tsys = mmf_pair
    steps = 4
    x, k, mask = _jets(6, [12, 3, 7, 5, 9, 2], seed=7)
    rng = np.random.default_rng(8)
    x0 = (rng.normal(size=x.shape) * mask).astype(np.float32)
    k0 = (rng.integers(1, 9, size=k.shape) * mask).astype(np.int32)
    us = rng.uniform(size=(steps, 6, D)).astype(np.float32)
    t0 = np.full((6,), jsys.config.time_eps, np.float32)
    jout, psrc = _states(t0, x0, k0, mask)
    # JAX's `simulate` draws its uniforms inside: loop its step on ours
    apply = _exact_jit(lambda s: jsys.module.apply({"params": params}, s), jout)
    jsolver = jsolvers.HybridSolver(apply, jsys.bridge_discrete, jsys.config.vocab_size)
    ts, dt = jsolvers.time_grid(jsys.config.time_eps, steps)
    for i in range(steps):
        jout = jout.replace(time=jnp.full((6,), ts[i], jnp.float32))
        jout, _ = jsolver.fwd_step_u(None, jnp.asarray(us[i]), jout, dt)
    with torch.no_grad():
        out = tsys.simulate(psrc, steps, uniforms=torch.from_numpy(us))
    real = mask[..., 0] > 0
    np.testing.assert_allclose(out.continuous.numpy()[real], _f32(jout.continuous)[real],
                               atol=SIM_ATOL)
    same = float((out.discrete.numpy()[..., 0] == np.asarray(jout.discrete)[..., 0])[real].mean())
    assert same >= SIM_TOKENS_EQUAL
