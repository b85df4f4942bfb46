"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Setup: refuses to run without CUDA; turns TF32 off; prints the card's
   name and power limit.
2. Builds the K1 kernel (`multimodal_flows_tpu_torch/csrc/btc_attention.cu`)
   with nvcc for sm_90a and prints the build time and the compiler's
   register / shared-memory report.
3. Holds K1 against its plain PyTorch version on the card, fp32, on the
   shapes the sampler gives it (packed segment rows, key-masked wide jets,
   small and unmasked forms), and compares the autograd gradients once.
4. Times K1 and the plain version at the two flagship shapes (CUDA events,
   median of alternating runs after warm-up).
5. Drives the serving path: the flagship MMF at full width (random weights
   from a seed) through `generate_packed` on 512 jets of AOJ-like
   multiplicity plus 4 jets wider than a packed row, and checks that both
   the segment and the key-mask forms of K1 ran, and that the output is
   well formed.  Then runs the sampler for 8 steps on the card and on the
   CPU (plain attention) from one source with one set of uniforms and
   compares them.
6. Prints one JSON line per kernel, the card line, and the contract line
   {"ok": true, "device": {...}} last.  Any failure exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.packing import build_packed_rows, pack_jets
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.ops import btc_attention as k1
from multimodal_flows_tpu_torch.ops.attention import attention_btc_reference
from multimodal_flows_tpu_torch.sampling.generator import generate_packed
from multimodal_flows_tpu_torch.train.systems import MMF

# fp32 on both sides, TF32 off; the kernel sums over <= 150 keys in
# another order than the plain version's matmuls
ATOL, RTOL = 2e-5, 1e-5
# the gradients go through the same plain backward on both sides; their
# upstream gradient 2*out differs by the forward's rounding
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-4

FLAGSHIP = dict(model="ParticleFormer", n_embd=256, n_inner=512, n_layer=5, n_layer_fused=6,
                n_head=4, vocab_size=9, dim_continuous=3, max_num_particles=150,
                batch_size=128, multitask_loss="time-weighted")

# (B, T, C, H), form: the flagship packed rows (half- and full-width
# blocks), wide jets at T=150, the parity-test shapes, the kernel's limits
KERNEL_CASES = [
    ((128, 128, 128, 4), "segments"),
    ((128, 128, 256, 4), "segments"),
    ((16, 150, 128, 4), "key_mask"),
    ((16, 150, 256, 4), "key_mask"),
    ((12, 10, 32, 4), "key_mask"),
    ((8, 12, 32, 4), "segments"),
    ((16, 150, 128, 4), "none"),
    ((4, 256, 512, 4), "segments"),
]
TIMED = [(128, 128, 128, 4), (128, 128, 256, 4)]


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


def _case_inputs(shape, form, dev, seed=0):
    B, T, C, _ = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((B, T, C), generator=gen, device=dev) for _ in range(3))
    rng = np.random.default_rng(seed)
    km = seg = None
    real = torch.ones((B, T), dtype=torch.bool, device=dev)
    if form == "segments":
        seg = torch.from_numpy(_packed_segments(B, T, rng)).to(dev)
        real = seg >= 0
    elif form == "key_mask":
        mult = torch.from_numpy(rng.integers(2, T + 1, size=B)).to(dev)
        real = torch.arange(T, device=dev)[None, :] < mult[:, None]
        km = torch.where(real, 0.0, -1e9).to(torch.float32)
    return q, k, v, km, seg, real


def check_kernel(dev) -> float:
    worst = 0.0
    for shape, form in KERNEL_CASES:
        q, k, v, km, seg, real = _case_inputs(shape, form, dev)
        H = shape[3]
        out = k1.btc_attention(q, k, v, H, km, seg)
        ref = attention_btc_reference(q, k, v, H, km, seg)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"K1 {shape} {form}: non-finite output")
        err = (out - ref).abs()[real]
        bad = err > ATOL + RTOL * ref.abs()[real]
        max_err = float(err.max())
        print(f"K1 vs plain {shape} {form}: max_abs_err {max_err:.3e} "
              f"(atol {ATOL}, rtol {RTOL}, {int(real.sum())} real rows)")
        if bad.any():
            raise AssertionError(f"K1 {shape} {form}: {int(bad.sum())} values out of tolerance")
        worst = max(worst, max_err)

    q, k, v, km, _, _ = _case_inputs((16, 150, 128, 4), "key_mask", dev, seed=1)
    grads = []
    for fn in (k1.btc_attention, attention_btc_reference):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        (fn(*leaves, 4, km, None) ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for name, a, b in zip("qkv", *grads):
        err = float((a - b).abs().max())
        print(f"K1 grad d{name} vs plain: max_abs_err {err:.3e}")
        if not torch.allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL):
            raise AssertionError(f"K1 gradient d{name} out of tolerance")
    return worst


def _median_ms(fns, n=40, warmup=5):
    """Median CUDA-event time of each fn, the fns run in turns."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(n):
        for fn, ts in zip(fns, times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [float(np.median(ts)) for ts in times]


def time_kernel(dev):
    result = {}
    with torch.no_grad():
        for shape in TIMED:
            q, k, v, _, seg, _ = _case_inputs(shape, "segments", dev)
            H = shape[3]
            ms, plain_ms = _median_ms([lambda: k1.btc_attention(q, k, v, H, None, seg),
                                       lambda: attention_btc_reference(q, k, v, H, None, seg)])
            print(f"K1 time {shape} segments: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
                  f"(median of 40, CUDA events)")
            result[shape] = (ms, plain_ms)
    return result


def _pad_masks(mult, D):
    return (np.arange(D)[None, :] < np.asarray(mult)[:, None]).astype(np.int64)[..., None]


def main_path(system):
    cfg = system.config
    rng = np.random.default_rng(0)
    mult = np.concatenate([_multiplicities(rng, 512, cfg.max_num_particles),
                           rng.integers(135, 151, size=4)])
    pad_masks = _pad_masks(mult, cfg.max_num_particles)
    kw = dict(pack_width=128, batch_size=128, seed=0)
    generate_packed(system, pad_masks[-40:], num_timesteps=2, **kw)  # warm-up

    k1.reset_launch_counts()
    res = generate_packed(system, pad_masks, num_timesteps=100, **kw)
    launches = dict(k1.LAUNCHES)
    print(f"main path launches of K1: {launches}")
    if launches["segments"] == 0 or launches["key_mask"] == 0:
        raise AssertionError(f"main path did not run both K1 forms: {launches}")

    s = res.sample
    N, D = pad_masks.shape[:2]
    if s.continuous.shape != (N, D, cfg.dim_continuous) or s.discrete.shape != (N, D, 1):
        raise AssertionError(f"bad output shapes {s.continuous.shape} {s.discrete.shape}")
    pad = s.mask[..., 0] == 0
    checks = {
        "finite": bool(torch.isfinite(s.continuous).all()),
        "tokens in [0, V)": bool(((s.discrete >= 0) & (s.discrete < cfg.vocab_size)).all()),
        "pads zero": bool((s.continuous[pad] == 0).all() and (s.discrete[pad] == 0).all()),
        "mask kept": bool((s.mask.numpy() == pad_masks).all()),
    }
    print(f"main path checks: {checks}")
    if not all(checks.values()):
        raise AssertionError(f"main path output failed {checks}")
    print(f"main path: {N} jets ({int((mult > 128).sum())} wider than a row), 100 steps, "
          f"wall {res.wall_time_s:.3f} s, {res.jets_per_sec:.2f} jets/s")
    return launches, res


def sampler_vs_cpu(system, dev, steps=8, rows=8):
    """The flagship sampler on the card (K1) and on the CPU (plain
    attention), same weights, source and uniforms."""
    cfg = system.config
    cpu_system = MMF(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
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
    print(f"sampler card vs CPU, {steps} steps x {rows} packed rows: continuous max_abs_err "
          f"{err:.3e} (atol 1e-4), tokens equal on {same:.4f} of real sites (>= 0.99)")
    if err > 1e-4 or same < 0.99:
        raise AssertionError("the sampler on the card disagrees with the CPU sampler")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    k1.build()
    print(f"K1 build: {time.perf_counter() - t0:.2f} s ({k1.library_path().name})")
    log = k1.library_path().with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())

    max_err = check_kernel(dev)
    times = time_kernel(dev)

    system = MMF(Config(**FLAGSHIP), device=dev, generator=torch.Generator().manual_seed(0))
    launches, _ = main_path(system)
    sampler_vs_cpu(system, dev)

    ms, plain_ms = times[TIMED[0]]
    print(json.dumps({"kernels": [{
        "name": "btc_attention (K1, timed at B=128 T=128 C=128 H=4 segments)",
        "route": "cuda",
        "source": "multimodal_flows_tpu_torch/csrc/btc_attention.cu",
        "replaces": "multimodal_flows_tpu/ops/pallas_attention.py:201",
        "launches": sum(launches.values()),
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
