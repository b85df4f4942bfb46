"""K1 on Hopper: the wrapper of `csrc/btc_attention.cu`.

Replaces the Pallas TPU kernel `_btc_kernel`
(`multimodal_flows_tpu/ops/pallas_attention.py:201-257`): token-major
segment-masked set attention, q/k/v (B, T, C) fp32 with the heads packed
in C.  The source file says what bounds the kernel on the card and how its
design answers that.

Build: at first use, `nvcc` compiles the source for `sm_90a` into a shared
library with a plain C interface under `build/multimodal_flows_tpu_torch/`
of the checkout, named by a hash of the source and the flags; it is loaded
with ctypes.  Nothing is compiled when this module is imported.

The wrapper takes CUDA tensors only and launches the kernel or raises;
the plain version (`ops/attention.py:attention_btc_reference`) serves CPU
tensors through `multihead_attention_btc`.  The backward recomputes
through the plain version, as the JAX custom VJP `_btc_vjp_bwd` recomputes
through XLA; a backward kernel comes with packed training.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

from multimodal_flows_tpu_torch.ops.attention import attention_btc_reference

Tensor = torch.Tensor

MAX_T = 256
MAX_HEAD_SIZE = 128

#: launches of the kernel by form, counted where the launch succeeds
LAUNCHES = {"segments": 0, "key_mask": 0, "none": 0}

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "btc_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "multimodal_flows_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for form in LAUNCHES:
        LAUNCHES[form] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the K1 kernel builds only where the CUDA toolkit is")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbtc_attention_{digest.hexdigest()[:16]}.so"


def build() -> ctypes.CDLL:
    """Compile (if this source has no library yet) and load the kernel.
    The compiler's register and shared-memory report is kept beside the
    library as `<name>.log`."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.btc_attention_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.btc_attention_fwd.restype = ctypes.c_int
    lib.btc_attention_error_string.argtypes = [ctypes.c_int]
    lib.btc_attention_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(q: Tensor, k: Tensor, v: Tensor, n_head: int,
           key_mask: Optional[Tensor], segments: Optional[Tensor]) -> None:
    if q.device.type != "cuda":
        raise ValueError("btc_attention takes CUDA tensors; CPU tensors take "
                         "ops.attention.attention_btc_reference")
    if q.dim() != 3:
        raise ValueError(f"q must be (B, T, C), got {tuple(q.shape)}")
    B, T, C = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
    for name, t, dtype in (("q", q, torch.float32), ("k", k, torch.float32),
                           ("v", v, torch.float32), ("key_mask", key_mask, torch.float32),
                           ("segments", segments, torch.int32)):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("key_mask", "segments") and t.shape != (B, T):
            raise ValueError(f"{name} must be (B, T) = {(B, T)}, got {tuple(t.shape)}")
    if n_head <= 0 or C % n_head:
        raise ValueError(f"C={C} is not a multiple of n_head={n_head}")
    if not 1 <= T <= MAX_T or C // n_head > MAX_HEAD_SIZE or B < 1:
        raise ValueError(f"K1 takes 1 <= T <= {MAX_T}, head size <= {MAX_HEAD_SIZE} "
                         f"and B >= 1; got B={B}, T={T}, head size {C // n_head}")


def _launch(q: Tensor, k: Tensor, v: Tensor, n_head: int,
            key_mask: Optional[Tensor], segments: Optional[Tensor]) -> Tensor:
    _check(q, k, v, n_head, key_mask, segments)
    lib = build()
    B, T, C = q.shape
    out = torch.empty_like(q)
    scale = 1.0 / float(C // n_head) ** 0.5
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.btc_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_mask is None else key_mask.data_ptr(),
            None if segments is None else segments.data_ptr(),
            out.data_ptr(), B, T, C, n_head, scale, stream)
    if rc != 0:
        raise RuntimeError(f"btc_attention launch failed: CUDA error {rc} "
                           f"({lib.btc_attention_error_string(rc).decode()})")
    form = "segments" if segments is not None else "key_mask" if key_mask is not None else "none"
    LAUNCHES[form] += 1
    return out


class _BtcAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, segments, n_head):
        ctx.save_for_backward(q, k, v, key_mask, segments)
        ctx.n_head = n_head
        return _launch(q, k, v, n_head, key_mask, segments)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, key_mask, segments = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attention_btc_reference(*inputs, ctx.n_head, key_mask, segments)
            dq, dk, dv = torch.autograd.grad(out, inputs, grad_out)
        return dq, dk, dv, None, None, None


def btc_attention(q: Tensor, k: Tensor, v: Tensor, n_head: int,
                  key_mask: Optional[Tensor] = None,
                  segments: Optional[Tensor] = None) -> Tensor:
    """K1 forward on CUDA tensors: q/k/v (B, T, C) fp32 contiguous,
    key_mask (B, T) fp32 additive, segments (B, T) int32 (pads -1)."""
    return _BtcAttention.apply(q, k, v, key_mask, segments, n_head)
