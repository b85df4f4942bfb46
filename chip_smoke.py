"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Setup: refuses to run without CUDA; turns TF32 off; prints the card's
   name and power limit.
2. Builds the two kernels from the checkout's sources, one nvcc each, both
   at once: K1 (`multimodal_flows_tpu_torch/csrc/btc_attention.cu`) and K2
   (`csrc/set_attention.cu`), both around the shared core
   `csrc/set_attention_core.cuh`; prints each build's time, the compiler's
   register / shared-memory report and the number of tensor-core (HMMA)
   instructions `cuobjdump -sass` finds in each library (0 fails).
3. Holds each kernel against its plain PyTorch version on the card, fp32,
   on the shapes the sampler and the trainer give it and on the edges of
   the kernels' tiling (head sizes not a multiple of 8, T not a multiple of
   16, one jet filling a row, rows of 3-particle jets, scattered segment
   ids, head-major Tq != Tk with an odd Dh), and compares the autograd
   gradients (K1's also at the packed training batch, K2's with the bias's
   gradient).
4. Times each kernel, its plain version and one PyTorch call of the same
   function (`scaled_dot_product_attention` with the equivalent float
   mask) at the packed-row shapes, C=128 and C=256, and K1 in its key-mask
   form on wide jets (device time by CUDA events with the stream held
   while the host enqueues, median of alternating runs after warm-up);
   works out each kernel's bound (bytes at 3.35 TB/s or same-jet FLOPs at
   the 3xTF32 rate, whichever is larger).
5. Drives the serving paths through `generate_packed`, each with the
   launch counters set to 0 just before it and read just after:
   - the flagship MMF at full width on 512 jets of AOJ-like multiplicity
     plus 4 jets wider than a packed row: K1 in its segment and key-mask
     forms, K2 never;
   - the co-occurrence MMF (the flagship plus `use_coocurrence`), the same
     jets: K2 in its bias + segments form (packed rows) and its bias form
     (the bucketed wide jets), K1 never;
   - MJB + FlavorFormer (pairwise, learned positions: bucketed) and
     CFM + KinFormer (Lund bias: packed rows) at the CLI's widths, with
     lambda_u set nonzero, fewer jets and steps: K2 ran.
   Each path's output must be well formed; both MMF samplers must agree
   with the CPU sampler (plain attention) for 8 steps on shared uniforms.
6. Training, on 2048 synthetic jets of that multiplicity plus 8 of
   135-150, split 90/10:
   - the flagship's packed training loss and every parameter gradient on
     the card against the CPU on one packed batch with shared bridge
     states, then one optimizer update from the same gradients on both;
   - 30 steps on one fixed batch with fixed draws: the loss falls;
   - the main path: `Trainer.fit` of the flagship, packed rows of 128,
     256 jets a step, EMA, 3 epochs, counts set to 0 just before and read
     just after: K1 in its segment form (the wide jets as one-jet rows at
     width 150), K2 never; the logged losses finite, `last` and `best`
     written, `last` reloaded into a fresh system gives the logged
     validation loss;
   - the step's wall time, jets/s, peak memory, its device time split
     into forward, backward and optimizer, and the share of K1's forward
     and of its backward (the recompute through the plain version);
   - 5 steps of the co-occurrence MMF: K2 in its bias + segments form
     (its backward gives the bias's gradient), K1 never.
7. Prints one JSON line of the kernels, the card line, and the contract
   line {"ok": true, "device": {...}} last.  Any failure exits non-zero.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.datasets import ArrayDataset
from multimodal_flows_tpu_torch.data.packing import build_packed_rows, pack_jets
from multimodal_flows_tpu_torch.data.state import DataCoupling, MultiModal
from multimodal_flows_tpu_torch.models.blocks import pair_mask_bias
from multimodal_flows_tpu_torch.ops import btc_attention as k1
from multimodal_flows_tpu_torch.ops import cuda_build
from multimodal_flows_tpu_torch.ops import set_attention as k2
from multimodal_flows_tpu_torch.ops.attention import attention_btc_reference, attention_reference
from multimodal_flows_tpu_torch.sampling.generator import generate_packed
from multimodal_flows_tpu_torch.train.systems import build_system
from multimodal_flows_tpu_torch.train.trainer import Trainer

# fp32 on both sides, TF32 off; the kernels sum over <= 256 keys in
# another order than the plain version's matmuls
ATOL, RTOL = 2e-5, 1e-5
# the gradients go through the same plain backward on both sides; their
# upstream gradient 2*out differs by the forward's rounding
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-4

FLAGSHIP = dict(model="ParticleFormer", n_embd=256, n_inner=512, n_layer=5, n_layer_fused=6,
                n_head=4, vocab_size=9, dim_continuous=3, max_num_particles=150,
                batch_size=128, multitask_loss="time-weighted")
COOCC = dict(FLAGSHIP, use_coocurrence=True)
# the training CLI's default widths (scripts/train_mmf.py:57-66), pair_chunk 16
CLI = dict(n_embd=256, n_inner=512, n_layer=5, n_head=4, vocab_size=9, dim_continuous=3,
           max_num_particles=150, pair_chunk=16)
FLAVOR = dict(CLI, model="FlavorFormer", use_pairwise=True, use_pos_emb=True)
KIN = dict(CLI, model="KinFormer", use_pairwise=True)
LAMBDA_U = 0.5
# training: the flagship on packed rows of 128, 256 jets a step (the
# training CLI's default, scripts/train_mmf.py:41), EMA, lr 5e-4, clip 1.0
TRAIN = dict(FLAGSHIP, batch_size=256, packed_training=True, pack_width=128,
             use_ema_weights=True, lr=5e-4, gradient_clip_val=1.0, max_epochs=3)
TRAIN_COOCC = dict(TRAIN, use_coocurrence=True)
# card vs CPU on one training batch: fp32 on both sides, TF32 off; the sums
# run in another order and the card's per-jet sums (index_add_) use
# atomics, whose order changes from run to run
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3
# one Adam update from the same gradients on both sides
UPDATE_ATOL = 1e-5
# the packed training batch at the flagship: about 256 jets in rows of 128
TRAIN_K1_GRAD_SHAPE = (85, 128, 256, 4)

# (B, T, C, H), form: the flagship packed rows (half- and full-width
# blocks), wide jets at T=150, the parity-test shapes, the kernel's limits;
# then the edges of the tiling: head size 9 (not a multiple of 8), T=33
# with segments, one jet filling each row (no key tile skipped), rows of
# 3-particle jets (most tiles skipped), scattered ids in {-1, 0, 1, 2}
SEGMENT_FORMS = ("segments", "one_jet", "jets_of_3", "scattered")
K1_CASES = [
    ((128, 128, 128, 4), "segments"),
    ((128, 128, 256, 4), "segments"),
    ((16, 150, 128, 4), "key_mask"),
    ((16, 150, 256, 4), "key_mask"),
    ((12, 10, 32, 4), "key_mask"),
    ((8, 12, 32, 4), "segments"),
    ((16, 150, 128, 4), "none"),
    ((4, 256, 512, 4), "segments"),
    ((16, 128, 36, 4), "segments"),
    ((16, 150, 36, 4), "key_mask"),
    ((8, 33, 128, 4), "segments"),
    ((16, 128, 256, 4), "one_jet"),
    ((16, 128, 256, 4), "jets_of_3"),
    ((16, 128, 128, 4), "scattered"),
    ((4, 256, 256, 4), "scattered"),
]
# token-major (B, T, C, H) and form: the co-occurrence packed rows, the
# bucketed wide jets (pair mask + bias), the pair mask alone (a broadcast
# bias), the kernel's limits, then the tiling's edges as for K1; then
# CrossAttention's head-major shapes (B, H, Tq, Tk, Dh), and odd Dh with
# Tq != Tk both ways
K2_BTC_CASES = [
    ((128, 128, 128, 4), "bias_segments"),
    ((128, 128, 256, 4), "bias_segments"),
    ((16, 150, 256, 4), "pair_mask_bias"),
    ((16, 150, 128, 4), "pair_mask"),
    ((4, 256, 512, 4), "bias_segments"),
    ((16, 128, 36, 4), "bias_segments"),
    ((8, 33, 128, 4), "bias_segments"),
    ((16, 128, 256, 4), "bias_one_jet"),
    ((16, 128, 256, 4), "bias_jets_of_3"),
    ((16, 128, 128, 4), "bias_scattered"),
]
K2_HEAD_MAJOR_CASES = [((16, 4, 150, 64, 64), True), ((16, 4, 150, 64, 64), False),
                       ((16, 4, 150, 64, 33), True), ((8, 3, 20, 150, 9), False)]
TIMED = [(128, 128, 128, 4), (128, 128, 256, 4)]
# K1 in its key-mask form on the wide-jet batch: no key tile is skipped
TIMED_WIDE = (8, 150, 256, 4)


def _multiplicities(rng: np.random.Generator, n: int, hi: int) -> np.ndarray:
    """AOJ-like multiplicities: Poisson(40) clipped to [3, hi]."""
    return np.clip(rng.poisson(40, size=n), 3, hi)


def _packed_segments(B: int, T: int, rng: np.random.Generator) -> np.ndarray:
    """Segment ids of B packed rows of width T (pads -1)."""
    if T == 12:  # jets of 5 and 4, then 3 pads, as in tests/test_ops.py
        seg = np.full((B, T), -1, np.int32)
        seg[:, :5], seg[:, 5:9] = 0, 1
        return seg
    mult = _multiplicities(rng, 4 * B * T // 40, T)
    row_of, offset_of, n_rows = pack_jets(mult, T)
    pad = (np.arange(T)[None, :] < mult[:, None]).astype(np.int64)[..., None]
    _, seg = build_packed_rows(pad, row_of, offset_of, n_rows, T)
    if n_rows < B:
        raise ValueError(f"{n_rows} packed rows, {B} wanted")
    return seg[:B]


def _segments(pattern: str, B: int, T: int, rng: np.random.Generator) -> np.ndarray:
    """(B, T) segment ids of one of SEGMENT_FORMS (pads -1)."""
    if pattern == "segments":
        return _packed_segments(B, T, rng)
    if pattern == "one_jet":
        return np.zeros((B, T), np.int32)
    if pattern == "jets_of_3":
        pos = np.arange(T)
        return np.tile(np.where(pos < T - T % 3, pos // 3, -1), (B, 1)).astype(np.int32)
    return rng.integers(-1, 3, size=(B, T)).astype(np.int32)  # scattered


def _case_inputs(shape, form, dev, seed=0):
    """q, k, v (B, T, C), key mask, segments, bias and the query rows
    compared of one kernel case: the real ones, or all of them for
    scattered ids, where a pad query's own key is a pad too."""
    B, T, C, H = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, T, C), generator=gen, device=dev) for _ in range(3))
    rng = np.random.default_rng(seed)
    km = seg = bias = None
    real = torch.ones((B, T), dtype=torch.bool, device=dev)
    pattern = form.removeprefix("bias_")
    if pattern in SEGMENT_FORMS:
        seg = torch.from_numpy(_segments(pattern, B, T, rng)).to(dev)
        if pattern != "scattered":
            real = seg >= 0
    elif form in ("key_mask", "pair_mask", "pair_mask_bias"):
        mult = torch.from_numpy(rng.integers(2, T + 1, size=B)).to(dev)
        real = torch.arange(T, device=dev)[None, :] < mult[:, None]
        if form == "key_mask":
            km = torch.where(real, 0.0, -1e9).to(torch.float32)
        else:
            bias = pair_mask_bias(real[..., None].to(torch.int32))
    if form.startswith("bias_") or form == "pair_mask_bias":
        pairwise = torch.randn((B, H, T, T), generator=gen, device=dev)
        bias = pairwise if bias is None else bias + pairwise
    return q, k, v, km, seg, bias, real


def _held(name, out, ref, real) -> float:
    """max abs error over the real query rows; raises past the tolerance."""
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (out - ref).abs()[real]
    bad = err > ATOL + RTOL * ref.abs()[real]
    max_err = float(err.max())
    print(f"{name}: max_abs_err {max_err:.3e} (atol {ATOL}, rtol {RTOL}, "
          f"{int(real.sum())} real rows)")
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} values out of tolerance")
    return max_err


def _grads_held(name, fns, leaves):
    """Compare the autograd gradients of fns[0] (a kernel) and fns[1] (its
    plain version) of sum(out**2) with respect to `leaves`."""
    grads = []
    for fn in fns:
        ls = [t.clone().requires_grad_(True) for t in leaves]
        (fn(*ls) ** 2).sum().backward()
        grads.append([t.grad for t in ls])
    for i, (a, b) in enumerate(zip(*grads)):
        err = float((a - b).abs().max())
        print(f"{name} grad of input {i} {tuple(a.shape)} vs plain: max_abs_err {err:.3e}")
        if a.shape != b.shape or not torch.allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL):
            raise AssertionError(f"{name} gradient {i} out of tolerance")


def check_k1(dev) -> float:
    worst = 0.0
    for shape, form in K1_CASES:
        q, k, v, km, seg, _, real = _case_inputs(shape, form, dev)
        H = shape[3]
        out = k1.btc_attention(q, k, v, H, km, seg)
        ref = attention_btc_reference(q, k, v, H, km, seg)
        worst = max(worst, _held(f"K1 vs plain {shape} {form}", out, ref, real))
    q, k, v, km, _, _, _ = _case_inputs((16, 150, 128, 4), "key_mask", dev, seed=1)
    _grads_held("K1", [lambda a, b, c: k1.btc_attention(a, b, c, 4, km, None),
                       lambda a, b, c: attention_btc_reference(a, b, c, 4, km, None)],
                [q, k, v])
    q, k, v, _, seg, _, _ = _case_inputs(TRAIN_K1_GRAD_SHAPE, "segments", dev, seed=4)
    _grads_held(f"K1 at the training batch {TRAIN_K1_GRAD_SHAPE} segments",
                [lambda a, b, c: k1.btc_attention(a, b, c, 4, None, seg),
                 lambda a, b, c: attention_btc_reference(a, b, c, 4, None, seg)], [q, k, v])
    return worst


def _head_major_inputs(shape, masked, dev, seed=2):
    """CrossAttention's shapes: q (B, H, Tq, Dh), k/v (B, H, Tk, Dh), with
    or without a key mask and a (B, 1, Tq, Tk) bias."""
    B, H, Tq, Tk, Dh = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, Tq, Dh), generator=gen, device=dev)
    k, v = (torch.randn((B, H, Tk, Dh), generator=gen, device=dev) for _ in range(2))
    if not masked:
        return q, k, v, None, None
    rng = np.random.default_rng(seed)
    mult = torch.from_numpy(rng.integers(2, Tk + 1, size=B)).to(dev)
    km = torch.where(torch.arange(Tk, device=dev)[None, :] < mult[:, None], 0.0, -1e9)
    bias = torch.randn((B, 1, Tq, Tk), generator=gen, device=dev)
    return q, k, v, km.to(torch.float32), bias


def check_k2(dev) -> float:
    worst = 0.0
    for shape, form in K2_BTC_CASES:
        q, k, v, km, seg, bias, real = _case_inputs(shape, form, dev)
        H = shape[3]
        out = k2.set_attention_btc(q, k, v, H, km, bias, seg)
        ref = attention_btc_reference(q, k, v, H, km, seg, bias)
        worst = max(worst, _held(f"K2 vs plain {shape} {form} bias {tuple(bias.shape)}",
                                 out, ref, real))
    for shape, masked in K2_HEAD_MAJOR_CASES:
        q, k, v, km, bias = _head_major_inputs(shape, masked, dev)
        out = k2.set_attention(q, k, v, km, bias)
        ref = attention_reference(q, k, v, km, bias)
        real = torch.ones(out.shape[:3], dtype=torch.bool, device=dev)
        form = "key_mask + (B,1,Tq,Tk) bias" if masked else "no mask, no bias"
        worst = max(worst, _held(f"K2 vs plain head-major {shape} {form}", out, ref, real))
    q, k, v, km, bias = _head_major_inputs(K2_HEAD_MAJOR_CASES[0][0], True, dev, seed=3)
    _grads_held("K2", [lambda a, b, c, d: k2.set_attention(a, b, c, km, d),
                       lambda a, b, c, d: attention_reference(a, b, c, km, d)],
                [q, k, v, bias])
    return worst


# GPU clock cycles (about 1 ms) that a sleep kernel holds the stream before
# each timed call, so the host has enqueued the call's kernels when the
# start event runs
HOLD_CYCLES = 2_000_000


def _median_ms(fns, n=40, warmup=5):
    """Median CUDA-event device time of each fn, the fns run in turns.  The
    stream is held while the host enqueues fn, so the time is the
    kernels' own and not the host's launch overhead."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(n):
        for fn, ts in zip(fns, times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [float(np.median(ts)) for ts in times]


# published H100 SXM rates: HBM 3.35 TB/s; dense TF32 tensor cores 495
# TFLOP/s, and the kernels' 3xTF32 spends three TF32 products on each fp32
# product
HBM_BYTES_PER_S = 3.35e12
KERNEL_FLOP_PER_S = 495e12 / 3


def _bound(q: torch.Tensor, real_pairs: int, extra_bytes: int):
    """(ms, what bounds it): the least time for the kernel's work on these
    inputs: q, k, v read and the output written once plus `extra_bytes`
    (segments or key mask, the bias of the pairs used) at the HBM rate,
    against QK^T and PV over
    the (query, key) pairs that this data needs (real tokens of one jet)
    at the 3xTF32 rate, whichever is longer."""
    nbytes = 4 * q.numel() * 4 + extra_bytes
    flops = 4 * q.shape[-1] * real_pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / KERNEL_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _library_call(q, k, v, H, mask, ref, real, name):
    """One PyTorch call of the same function: scaled_dot_product_attention
    over head-major views of q/k/v with the equivalent additive float mask
    (made beforehand); checked against the plain version once."""
    B, T, C = q.shape

    def heads(t):
        return t.view(B, T, H, C // H).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)

    def call():
        return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    out = call().transpose(1, 2).reshape(B, T, C)
    err = float((out - ref).abs()[real].max())
    print(f"{name}: scaled_dot_product_attention vs plain max_abs_err {err:.3e} (atol 1e-4)")
    if err > 1e-4:
        raise AssertionError(f"{name}: the library call does not compute the kernel's function")
    return call


def _print_time(name, shape, form, t):
    print(f"{name} time {shape} {form}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
          f"scaled_dot_product_attention {t['library_ms']:.4f} ms, kernel / plain "
          f"{t['ms'] / t['plain_ms']:.3f} (median of 40, CUDA events, device time); bound "
          f"{t['bound_ms']:.4f} ms by {t['bound_by']}, kernel / bound "
          f"{t['ms'] / t['bound_ms']:.2f}")


def time_kernels(dev):
    """{(kernel, shape): times} at the packed-row shapes: K1 in its segment
    form, K2 in its bias + segments form; then K1 in its key-mask form on
    the wide-jet batch.  Each with its plain version, the library call and
    its bound."""
    result = {}
    with torch.no_grad():
        for shape in TIMED:
            q, k, v, _, seg, bias, real = _case_inputs(shape, "bias_segments", dev)
            B, T, C, H = shape
            same = seg[:, None, :, None] == seg[:, None, None, :]
            # (query, key) pairs of one jet: the only ones the function
            # reads a bias entry for and computes a product of
            pairs = int((same[:, 0] & real[:, :, None]).sum())
            cross = torch.where(same, 0.0, -1e9)
            forms = {
                "K1": ("segments", lambda: k1.btc_attention(q, k, v, H, None, seg),
                       lambda: attention_btc_reference(q, k, v, H, None, seg),
                       None, cross, 4 * seg.numel()),
                "K2": ("bias (B,H,T,T) + segments",
                       lambda: k2.set_attention_btc(q, k, v, H, None, bias, seg),
                       lambda: attention_btc_reference(q, k, v, H, None, seg, bias),
                       bias, (bias + cross).contiguous(), 4 * (seg.numel() + H * pairs)),
            }
            for name, (form, kernel, plain, b, mask, extra) in forms.items():
                library = _library_call(q, k, v, H, mask, plain(), real, f"{name} {shape}")
                ms, plain_ms, library_ms = _median_ms([kernel, plain, library])
                bound_ms, bound_by = _bound(q, pairs, extra)
                t = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
                _print_time(name, shape, form, t)
                result[name, shape] = t
        q, k, v, km, _, _, real = _case_inputs(TIMED_WIDE, "key_mask", dev)
        H = TIMED_WIDE[3]
        plain = lambda: attention_btc_reference(q, k, v, H, km)  # noqa: E731
        library = _library_call(q, k, v, H, km[:, None, None, :], plain(), real,
                                f"K1 {TIMED_WIDE} key_mask")
        ms, plain_ms, library_ms = _median_ms(
            [lambda: k1.btc_attention(q, k, v, H, km, None), plain, library])
        n_real = real.sum(dim=1)
        bound_ms, bound_by = _bound(q, int((n_real * n_real).sum()), 4 * km.numel())
        t = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                 bound_by=bound_by)
        _print_time("K1", TIMED_WIDE, "key_mask", t)
        result["K1", TIMED_WIDE] = t
    return result


def _pad_masks(mult, D):
    return (np.arange(D)[None, :] < np.asarray(mult)[:, None]).astype(np.int64)[..., None]


def _jets(rng, n, n_wide, D=150):
    """n AOJ-like jets plus n_wide jets of 135-150, wider than a packed row."""
    return np.concatenate([_multiplicities(rng, n, D), rng.integers(135, D + 1, size=n_wide)])


def drive(name, system, mult, steps, expect):
    """One serving path: counts set to 0, `generate_packed`, counts read.
    `expect(k1_launches, k2_launches)` returns what is wrong, or ''."""
    cfg = system.config
    pad_masks = _pad_masks(mult, cfg.max_num_particles)
    kw = dict(pack_width=128, batch_size=128, seed=0)
    generate_packed(system, pad_masks[-40:], num_timesteps=2, **kw)  # warm-up

    k1.reset_launch_counts()
    k2.reset_launch_counts()
    res = generate_packed(system, pad_masks, num_timesteps=steps, **kw)
    launches = {"K1": dict(k1.LAUNCHES), "K2": dict(k2.LAUNCHES)}
    print(f"{name}: launches {launches}")
    wrong = expect(launches["K1"], launches["K2"])
    if wrong:
        raise AssertionError(f"{name}: {wrong}")

    s = res.sample
    N, D = pad_masks.shape[:2]
    if s.continuous.shape != (N, D, cfg.dim_continuous) or s.discrete.shape != (N, D, 1):
        raise AssertionError(f"{name}: bad output shapes {s.continuous.shape} "
                             f"{s.discrete.shape}")
    pad = s.mask[..., 0] == 0
    checks = {
        "finite": bool(torch.isfinite(s.continuous).all()),
        "tokens in [0, V)": bool(((s.discrete >= 0) & (s.discrete < cfg.vocab_size)).all()),
        "pads zero": bool((s.continuous[pad] == 0).all() and (s.discrete[pad] == 0).all()),
        "mask kept": bool((s.mask.numpy() == pad_masks).all()),
    }
    print(f"{name}: checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"{name}: output failed {checks}")
    print(f"{name}: {N} jets ({int((mult > 128).sum())} wider than a row), {steps} steps, "
          f"wall {res.wall_time_s:.3f} s, {res.jets_per_sec:.2f} jets/s")
    return launches, res


def sampler_vs_cpu(name, system, cfg_kw, dev, steps=8, rows=8):
    """The MMF sampler on the card and on the CPU (plain attention), same
    weights, source, segments and uniforms."""
    cfg = system.config
    cpu_system = build_system(Config(**cfg_kw), "MMF", device="cpu",
                              generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    mult = _multiplicities(rng, 4 * rows, 128)
    row_of, offset_of, n_rows = pack_jets(mult, 128)
    mask, seg = build_packed_rows(_pad_masks(mult, 128), row_of, offset_of, n_rows, 128)
    mask, seg = mask[:rows].astype(np.int32), seg[:rows]
    x0 = (rng.normal(size=(rows, 128, 3)) * mask).astype(np.float32)
    k0 = (rng.integers(1, 9, size=(rows, 128, 1)) * mask).astype(np.int32)
    us = rng.uniform(size=(steps, rows, 128)).astype(np.float32)
    outs = []
    for sys_, d in ((system, dev), (cpu_system, torch.device("cpu"))):
        src = MultiModal(time=torch.full((rows,), cfg.time_eps), continuous=torch.from_numpy(x0),
                         discrete=torch.from_numpy(k0), mask=torch.from_numpy(mask)).to(d)
        outs.append(sys_.simulate(src, steps, segments=torch.from_numpy(seg).to(d),
                                  uniforms=torch.from_numpy(us).to(d)).to("cpu"))
    real = torch.from_numpy(seg >= 0)
    err = float((outs[0].continuous - outs[1].continuous).abs()[real].max())
    same = float((outs[0].discrete[..., 0] == outs[1].discrete[..., 0])[real].float().mean())
    print(f"{name} sampler card vs CPU, {steps} steps x {rows} packed rows: continuous "
          f"max_abs_err {err:.3e} (atol 1e-4), tokens equal on {same:.4f} of real sites (>= 0.99)")
    if err > 1e-4 or same < 0.99:
        raise AssertionError(f"{name}: the sampler on the card disagrees with the CPU sampler")


def _train_data(rng, n=2048, n_wide=8, D=150):
    """(train, val) datasets, 90/10: n jets of AOJ-like multiplicity plus
    n_wide of 135-150, normal kinematics and tokens 1..8."""
    mult = _jets(rng, n, n_wide, D)
    mask = _pad_masks(mult, D).astype(np.int32)
    x = (rng.normal(size=(len(mult), D, 3)) * mask).astype(np.float32)
    k = (rng.integers(1, 9, size=(len(mult), D, 1)) * mask).astype(np.int32)
    ds = ArrayDataset(DataCoupling(source=MultiModal(mask=mask),
                                   target=MultiModal(continuous=x, discrete=k, mask=mask)))
    return ds.split(0.9, seed=0)


def _first_batch(trainer, train_ds):
    """The first row batch of the packed unit (host arrays)."""
    return trainer._pack_units(train_ds)[0].coupling[np.arange(trainer._packed_row_bs)]


def train_card_vs_cpu(dev, train_ds):
    """The flagship's packed training loss and every parameter gradient on
    the card and on the CPU (plain attention), same weights, one packed
    batch, shared bridge states; then one optimizer update (clip, Adam,
    EMA) from the card's gradients on both."""
    cfg = Config(**TRAIN)
    sides = {side: (d, build_system(cfg, "MMF", device=d,
                                    generator=torch.Generator().manual_seed(0)))
             for side, d in (("card", dev), ("cpu", torch.device("cpu")))}
    batch = _first_batch(Trainer(sides["card"][1], cfg), train_ds)
    rng = np.random.default_rng(3)
    m = batch.mask
    t_jets = rng.uniform(cfg.time_eps, 1.0, batch.jet_valid.shape).astype(np.float32)
    states = dict(time=np.take_along_axis(t_jets, np.clip(batch.segments, 0, None), axis=1),
                  continuous=(rng.normal(size=m.shape[:2] + (3,)) * m).astype(np.float32),
                  discrete=(rng.integers(1, 9, size=m.shape) * m).astype(np.int32), mask=m)
    drift = (rng.normal(size=m.shape[:2] + (3,)) * m).astype(np.float32)
    loss, grads = {}, {}
    for side, (d, system) in sides.items():
        b = batch.to(d)
        state = MultiModal(**{f: torch.from_numpy(a) for f, a in states.items()}).to(d)
        k1.reset_launch_counts()
        out = system.module.packed_training_loss(state, torch.from_numpy(drift).to(d),
                                                 b.discrete, torch.from_numpy(t_jets).to(d),
                                                 b.segments, b.jet_valid)
        out[0].backward()
        loss[side] = out[0].item()
        grads[side] = {n: p.grad.cpu() for n, p in system.module.named_parameters()}
        print(f"training loss on the {side}: {loss[side]:.7f} ({len(b)} rows x {b.width}, "
              f"{b.num_jets} jets; K1 launches {sum(k1.LAUNCHES.values())})")
    rel = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
    worst = max(float(((grads["card"][n] - g).abs() / (TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL
                                                        * g.abs())).max())
                for n, g in grads["cpu"].items())
    print(f"training card vs CPU: loss rel err {rel:.3e} (<= {TRAIN_LOSS_RTOL}); "
          f"{len(grads['cpu'])} gradients, worst |diff| / (atol {TRAIN_GRAD_ATOL} + rtol "
          f"{TRAIN_GRAD_RTOL} |g|) = {worst:.3f} (<= 1)")
    if rel > TRAIN_LOSS_RTOL or worst > 1.0:
        raise AssertionError("the training loss or its gradients on the card disagree with "
                             "the CPU")

    after = {}
    for side, (d, system) in sides.items():
        trainer = Trainer(system, cfg)
        state = trainer.init_state(10)
        for n, p in system.module.named_parameters():
            p.grad = grads["card"][n].to(d)
        trainer._update(state)
        after[side] = [t.detach().cpu() for t in (*system.module.parameters(),
                                                  *state.ema.parameters())]
    err = max(float((a - b).abs().max()) for a, b in zip(after["card"], after["cpu"]))
    print(f"one update (clip, Adam, EMA) from the same gradients, card vs CPU: max_abs_err "
          f"{err:.3e} (atol {UPDATE_ATOL})")
    if err > UPDATE_ATOL:
        raise AssertionError("the optimizer update on the card disagrees with the CPU")


def fit_fixed_batch(dev, train_ds, steps=30):
    """`steps` train steps on one packed batch with the same draws (the
    generator reseeded) every step: the loss must fall."""
    cfg = Config(**TRAIN)
    system = build_system(cfg, "MMF", device=dev, generator=torch.Generator().manual_seed(1))
    trainer = Trainer(system, cfg)
    state = trainer.init_state(steps)
    batch = _first_batch(trainer, train_ds).to(dev)
    gen = torch.Generator(device=dev)
    system.module.train()
    losses = []
    for _ in range(steps):
        gen.manual_seed(0)
        losses.append(trainer._train_step(state, batch, gen)["loss"])
    losses = torch.stack(losses).cpu().numpy()
    print(f"fixed batch, {steps} steps: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
          f"(first 5 mean {losses[:5].mean():.5f}, last 5 mean {losses[-5:].mean():.5f})")
    if not (np.isfinite(losses).all() and losses[-5:].mean() < losses[:5].mean()):
        raise AssertionError("the loss on a fixed batch did not fall")


def train_flagship(dev, train_ds, val_ds, out_dir):
    """The training main path: `Trainer.fit` of the flagship, the launch
    counters set to 0 just before and read just after."""
    cfg = Config(**TRAIN, dir=out_dir, experiment_id="flagship")
    system = build_system(cfg, "MMF", device=dev, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(system, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.reset_launch_counts()
    k2.reset_launch_counts()
    t0 = time.perf_counter()
    state = trainer.fit(train_ds, val_ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": dict(k1.LAUNCHES), "K2": dict(k2.LAUNCHES)}
    peak = torch.cuda.max_memory_allocated()
    print(f"flagship training: launches {launches}")
    if not launches["K1"]["segments"] or sum(launches["K2"].values()):
        raise AssertionError("flagship training: K1 did not run in its segment form, or K2 ran")

    exp = os.path.join(out_dir, cfg.project, "flagship")
    records = [json.loads(line) for line in open(os.path.join(exp, "metrics.jsonl"))]
    losses = [r[k] for r in records for k in r if "loss" in k]
    slots = set(os.listdir(os.path.join(exp, "checkpoints")))
    fresh = build_system(cfg, "MMF", device=dev)
    fresh.module.load_state_dict(trainer.load_for_inference("last"))
    reloaded = trainer.evaluate(val_ds, fresh.module, epoch=cfg.max_epochs - 1)["val_loss"]
    logged = records[-1]["val_loss"]
    checks = {
        f"{len(records)} epochs logged": len(records) == cfg.max_epochs,
        "every logged loss finite": bool(np.isfinite(losses).all()),
        "last and best written": {"last.pt", "best.pt"} <= slots,
        "last reloaded gives the logged val_loss (rel 1e-5)":
            abs(reloaded - logged) <= 1e-5 * abs(logged),
    }
    for r in records:
        print(f"  epoch {r['epoch']:.0f}: train_loss {r['train_loss']:.5f} val_loss "
              f"{r['val_loss']:.5f} lr {r['lr']:.3e} ({r['epoch_time_s']:.2f} s)")
    print(f"flagship training: {state.step} steps in {wall:.2f} s (3 epochs, validation and "
          f"checkpoints included); val_loss logged {logged:.7f}, reloaded {reloaded:.7f}; "
          f"peak max_memory_allocated {peak / 2**20:.1f} MiB; checks {checks}")
    if not all(checks.values()):
        raise AssertionError(f"flagship training failed {checks}")
    return launches, trainer, state, peak


def _step_phases(trainer, state, batch, gen):
    """One train step with its phases named for the profiler."""
    from torch.profiler import record_function

    with record_function("train_forward"):
        loss, _ = trainer.system.loss_fn(batch, gen, train=True, module=state.module)
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    with record_function("train_optimizer"):
        trainer._update(state)


def _share(part: float, whole: float) -> float:
    return part / whole if whole else float("nan")


def time_training(dev, trainer, state, train_ds, n=20, n_prof=5):
    """Wall time of a train step (ending in a synchronize) and jets/s; then
    `torch.profiler` over `n_prof` steps: the kernels' device time split
    into forward (launched inside the loss), optimizer (inside the update)
    and backward (the rest: the autograd engine launches it from its own
    thread), the device's busy share of the wall, and the kernels that
    take the most time.  A step launches more kernels than the stream's
    queue holds, so holding the stream while the host enqueues (as
    `_median_ms` does) cannot time it."""
    from torch.profiler import ProfilerActivity, profile

    unit = trainer._pack_units(train_ds)[0]
    rows = trainer._packed_row_bs
    idx = trainer._epoch_perm(len(unit), rows, shuffle=True, seed=1, epoch=0)
    batches = list(trainer._batches(trainer._resident(unit), idx))
    jets = [int(unit.coupling.jet_valid[i].sum()) for i in idx]
    gen = torch.Generator(device=dev).manual_seed(2)
    state.module.train()
    for b in batches[:3]:  # warm-up
        trainer._train_step(state, b, gen)
    torch.cuda.synchronize()
    walls, step_jets = [], []
    for i in range(n):
        j = i % len(batches)
        t0 = time.perf_counter()
        trainer._train_step(state, batches[j], gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        step_jets.append(jets[j])
    wall_ms = float(np.median(walls)) * 1e3
    jets_per_s = sum(step_jets) / sum(walls)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_prof):
            _step_phases(trainer, state, batches[i % len(batches)], gen)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    state.module.eval()
    events = prof.events()
    ranges = {name: sum(e.device_time_total for e in events
                        if e.name == name and e.device_type.name == "CPU") / n_prof / 1e3
              for name in ("train_forward", "train_optimizer")}
    total_ms = sum(e.device_time_total for e in events
                   if e.device_type.name == "CPU" and e.cpu_parent is None) / n_prof / 1e3
    split = {"forward": ranges["train_forward"], "optimizer": ranges["train_optimizer"]}
    split["backward"] = total_ms - split["forward"] - split["optimizer"]
    averages = prof.key_averages()
    launches = sum(e.count for e in averages if e.key == "cudaLaunchKernel") / n_prof
    print(f"train step (flagship, {rows} rows x 128, ~{np.mean(jets):.1f} jets): median wall "
          f"{wall_ms:.3f} ms over {n} steps (each synchronized), {jets_per_s:.1f} trained "
          f"jets/s")
    print(f"train step kernel time (torch.profiler, {n_prof} steps): forward "
          f"{split['forward']:.3f} ms, backward {split['backward']:.3f} ms, optimizer "
          f"{split['optimizer']:.3f} ms, total {total_ms:.3f} ms; device busy share "
          f"{_share(total_ms, wall_ms):.3f} of the unprofiled wall ({_share(total_ms, prof_wall_ms):.3f} of "
          f"the profiled wall, {prof_wall_ms:.3f} ms a step); {launches:.0f} cudaLaunchKernel "
          f"a step"
          + ("" if total_ms else " (the profiler shows no device time)"))
    annotations = {e.key for e in averages if e.device_type.name == "CPU"}
    kernels = [e for e in averages if e.device_type.name == "CUDA" and e.key not in annotations]
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / n_prof:8.3f} ms/step "
              f"{_share(e.self_device_time_total / 1e3 / n_prof, total_ms):6.3f}  "
              f"{e.count / n_prof:6.1f}/step  {e.key[:100]}")
    # in the profiled steps: K1's own kernels, and the device time of the
    # autograd nodes of its backward (the recompute through the plain version)
    k1_fwd_ms = sum(e.self_device_time_total for e in kernels
                    if "attention_kernel" in e.key) / n_prof / 1e3
    node = "BtcAttentionBackward"
    k1_bwd = [e for e in events if e.device_type.name == "CPU" and node in e.name
              and not (e.cpu_parent is not None and node in e.cpu_parent.name)]
    k1_bwd_ms = sum(e.device_time_total for e in k1_bwd) / n_prof / 1e3
    print(f"attention in the profiled steps: K1 kernels {k1_fwd_ms:.3f} ms a step "
          f"({_share(k1_fwd_ms, split['forward']):.3f} of the forward); {len(k1_bwd) / n_prof:.0f} "
          f"backward nodes a step, {k1_bwd_ms:.3f} ms ({_share(k1_bwd_ms, split['backward']):.3f} "
          f"of the backward)")
    return dict(wall_ms=wall_ms, jets_per_s=jets_per_s, device_ms=total_ms,
                busy_share=_share(total_ms, wall_ms), launches_per_step=launches, **split,
                attention_forward_ms=k1_fwd_ms, attention_backward_ms=k1_bwd_ms)


def train_coocc(dev, train_ds, steps=5):
    """5 train steps of the co-occurrence MMF: K2 in its bias + segments
    form, forward and (through the plain version) backward with the bias's
    gradient; K1 never."""
    cfg = Config(**TRAIN_COOCC)
    system = build_system(cfg, "MMF", device=dev, generator=torch.Generator().manual_seed(0))
    trainer = Trainer(system, cfg)
    state = trainer.init_state(steps)
    unit = trainer._pack_units(train_ds)[0]
    idx = trainer._epoch_perm(len(unit), trainer._packed_row_bs, shuffle=True, seed=0,
                              epoch=0)[:steps]
    gen = torch.Generator(device=dev).manual_seed(0)
    system.module.train()
    k1.reset_launch_counts()
    k2.reset_launch_counts()
    metrics = [trainer._train_step(state, b, gen)
               for b in trainer._batches(trainer._resident(unit), idx)]
    torch.cuda.synchronize()
    launches = {"K1": dict(k1.LAUNCHES), "K2": dict(k2.LAUNCHES)}
    losses = torch.stack([m["loss"] for m in metrics]).cpu().numpy()
    wue = system.module.encoder.coocc.wue.weight
    print(f"co-occurrence training, {steps} steps: losses {np.round(losses, 5).tolist()}; "
          f"launches {launches}")
    if not (len(losses) == steps and np.isfinite(losses).all()
            and launches["K2"]["bias_segments"] and not sum(launches["K1"].values())):
        raise AssertionError("co-occurrence training: a loss is not finite, K2 did not run "
                             "as bias + segments, or K1 ran")
    if wue.grad is None or not torch.isfinite(wue.grad).all() or not wue.grad.abs().sum():
        raise AssertionError("co-occurrence training: no gradient reached the bias table")
    return launches


def _system(kind, cfg_kw, dev):
    system = build_system(Config(**cfg_kw), kind, device=dev,
                          generator=torch.Generator().manual_seed(0))
    if hasattr(system.module, "lambda_u"):  # initialised to 0, which turns the bias off
        with torch.no_grad():
            system.module.lambda_u.fill_(LAMBDA_U)
    return system


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    return found or str(Path(cuda_build._nvcc()).with_name("cuobjdump"))


def _hmma_count(so: Path) -> int:
    """Tensor-core (HMMA) instructions in a library's device code."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    return sum("HMMA" in line for line in sass.splitlines())


def _build_all():
    """Build both kernels at once, one nvcc each; print the reports and
    each library's HMMA count, and fail if one has none."""
    def timed(mod):
        t0 = time.perf_counter()
        mod.build()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        seconds = list(pool.map(timed, (k1, k2)))
    for name, mod, s in (("K1", k1, seconds[0]), ("K2", k2, seconds[1])):
        print(f"{name} build: {s:.2f} s ({mod.library_path().name})")
        log = mod.library_path().with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())
        hmma = _hmma_count(mod.library_path())
        print(f"{name}: {hmma} HMMA instructions in {mod.library_path().name}")
        if hmma == 0:
            raise AssertionError(f"{name} has no tensor-core instruction")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    _build_all()
    err = {"K1": check_k1(dev), "K2": check_k2(dev)}
    times = time_kernels(dev)

    rng = np.random.default_rng(0)
    mult = _jets(rng, 512, 4)

    flagship = _system("MMF", FLAGSHIP, dev)
    main_launches, _ = drive(
        "flagship MMF", flagship, mult, 100,
        lambda l1, l2: ("did not run both K1 forms" if not (l1["segments"] and l1["key_mask"])
                        else "launched K2" if sum(l2.values()) else ""))
    sampler_vs_cpu("flagship MMF", flagship, FLAGSHIP, dev)
    del flagship

    coocc = _system("MMF", COOCC, dev)
    coocc_launches, _ = drive(
        "co-occurrence MMF", coocc, mult, 100,
        lambda l1, l2: ("did not run K2 as bias + segments and as bias"
                        if not (l2["bias_segments"] and l2["bias"])
                        else "launched K1" if sum(l1.values()) else ""))
    sampler_vs_cpu("co-occurrence MMF", coocc, COOCC, dev)
    del coocc

    for name, kind, cfg_kw, n, steps in (
            ("MJB + FlavorFormer (pairwise, pos-emb)", "MJB", FLAVOR, 256, 20),
            ("CFM + KinFormer (Lund)", "CFM", KIN, 128, 10)):
        system = _system(kind, cfg_kw, dev)
        drive(name, system, _jets(rng, n, 2), steps,
              lambda l1, l2: "did not run K2" if not sum(l2.values()) else "")
        del system

    train_ds, val_ds = _train_data(np.random.default_rng(5))
    train_card_vs_cpu(dev, train_ds)
    fit_fixed_batch(dev, train_ds)
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as out_dir:
        train_launches, trainer, state, peak = train_flagship(dev, train_ds, val_ds, out_dir)
    step = time_training(dev, trainer, state, train_ds)
    print(json.dumps({"training": {"config": "flagship MMF, packed rows of 128, 256 jets/step",
                                   "card": card, "peak_mib": peak / 2**20, **step}}))
    del trainer, state
    coocc_train_launches = train_coocc(dev, train_ds)

    def timed(name):
        out = {}
        for shape, suffix in ((TIMED[0], ""), (TIMED[1], "_c256")):
            out.update({k + suffix: v for k, v in times[name, shape].items()})
        return out

    print(json.dumps({"kernels": [
        {"name": "btc_attention (K1, timed at B=128 T=128 H=4 segments, C=128 and C=256)",
         "route": "cuda",
         "source": "multimodal_flows_tpu_torch/csrc/btc_attention.cu",
         "replaces": "multimodal_flows_tpu/ops/pallas_attention.py:201",
         "launches": sum(main_launches["K1"].values()),
         "launches_training": sum(train_launches["K1"].values()),
         "max_abs_err": err["K1"], **timed("K1")},
        {"name": "set_attention (K2, timed at B=128 T=128 H=4 bias + segments, "
                 "C=128 and C=256)",
         "route": "cuda",
         "source": "multimodal_flows_tpu_torch/csrc/set_attention.cu",
         "replaces": "multimodal_flows_tpu/ops/pallas_attention.py:48",
         "launches": sum(coocc_launches["K2"].values()),
         "launches_training": sum(coocc_train_launches["K2"].values()),
         "max_abs_err": err["K2"], **timed("K2")},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
