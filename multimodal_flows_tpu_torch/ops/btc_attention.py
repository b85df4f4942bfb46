"""K1 on Hopper: the wrapper of `csrc/btc_attention.cu`.

Replaces the Pallas TPU kernel `_btc_kernel`
(`multimodal_flows_tpu/ops/pallas_attention.py:201-257`): token-major
segment-masked set attention, q/k/v (B, T, C) fp32 or bf16 with the heads
packed in C, the output in their dtype (the Pallas kernel takes the input
dtype and returns `v.dtype`).  The source file says what bounds the kernel
on the card; its design is the shared core `csrc/set_attention_core.cuh`:
a block's TMA loads on mbarriers and `wgmma` products in both dtypes
(fp32: 3xTF32 at fp32 parity, the raw tiles serving as the hi parts, a
ring of key-tile chunks, the key tiles split across blocks on grids that
fill at most half of the card, planned by `ops.set_attention.fp32_plan`; bf16:
planned by `ops.set_attention.bf16_plan`; fp32 softmax and cross-jet key
tiles not loaded in both).  Any T and head size run (slices of 128 output
columns past a head size of 128); a block's shared memory is the only
bound, and the plans raise, naming it, where it does not fit.

Build: `ops/cuda_build.py` compiles the source with nvcc for `sm_90a` at
first use and loads it with ctypes; nothing is compiled at import.

The wrapper takes CUDA tensors only and launches the kernel or raises;
the plain version (`ops/attention.py:attention_btc_reference`) serves CPU
tensors through `multihead_attention_btc`.  The backward recomputes
through the plain version in the input dtype, as the JAX custom VJP
`_btc_vjp_bwd` recomputes through XLA; a backward kernel is ROADMAP.md
Queue 4 item 3.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from multimodal_flows_tpu_torch.ops.attention import attention_btc_reference
from multimodal_flows_tpu_torch.ops.cuda_build import CudaLibrary
from multimodal_flows_tpu_torch.ops.set_attention import bf16_plan, fp32_plan
from multimodal_flows_tpu_torch.utils.profiling import count, declare

Tensor = torch.Tensor

FORMS = ("segments", "key_mask", "none")
DTYPES = (torch.float32, torch.bfloat16)
#: the launch counters by dtype and form, counted where the launch succeeds
_LAUNCHED = {torch.float32: declare("k1", *FORMS), torch.bfloat16: declare("k1_bf16", *FORMS)}


def _declare(lib: ctypes.CDLL) -> None:
    # q, k, v, key_mask, segments, out, B, T, C, n_head, scale, then the plan:
    # fp32 qkv_tma, stages, splits, smem, split scratch; bf16 qkv_tma, stages,
    # smem; then the stream
    head = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float]
    lib.btc_attention_fwd.argtypes = head + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    lib.btc_attention_bf16_fwd.argtypes = head + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for fn in (lib.btc_attention_fwd, lib.btc_attention_bf16_fwd):
        fn.restype = ctypes.c_int


_LIB = CudaLibrary("btc_attention.cu", _declare)


def library_path() -> Path:
    return _LIB.path()


def build() -> ctypes.CDLL:
    """Compile (if this source has no library yet) and load the kernel."""
    return _LIB.load()


def _check(q: Tensor, k: Tensor, v: Tensor, n_head: int,
           key_mask: Optional[Tensor], segments: Optional[Tensor]) -> None:
    """Raise on malformed input: shapes, dtypes, devices, strides, the heads.
    Any T and head size pass; the shared memory is the plans' to check."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, T, C), got {tuple(q.shape)}")
    B, T, C = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape {tuple(q.shape)}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be one of {DTYPES}, got {q.dtype}")
    for name, t, dtype in (("q", q, q.dtype), ("k", k, q.dtype),
                           ("v", v, q.dtype), ("key_mask", key_mask, torch.float32),
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
    if B < 1 or T < 1:
        raise ValueError(f"K1 takes B, T >= 1; got B={B}, T={T}")


def _launch(q: Tensor, k: Tensor, v: Tensor, n_head: int,
            key_mask: Optional[Tensor], segments: Optional[Tensor]) -> Tensor:
    if q.device.type != "cuda":
        raise ValueError("btc_attention takes CUDA tensors; CPU tensors take "
                         "ops.attention.attention_btc_reference")
    _check(q, k, v, n_head, key_mask, segments)
    B, T, C = q.shape
    bf16 = q.dtype == torch.bfloat16
    # the host plans; they raise where a block's shared memory does not fit
    views = [t.unflatten(-1, (n_head, C // n_head)).transpose(1, 2) for t in (q, k, v)]
    if bf16:
        p = bf16_plan(*views)
        plan = [int(p.qkv_tma), p.stages, p.smem_bytes]
    else:
        p = fp32_plan(*views)
        part = (torch.empty(p.scratch_floats(B, n_head, T, C // n_head), device=q.device)
                if p.splits > 1 else None)
        plan = [int(p.qkv_tma), p.stages, p.splits, p.smem_bytes,
                None if part is None else part.data_ptr()]
    lib = build()
    out = torch.empty_like(q)
    scale = 1.0 / float(C // n_head) ** 0.5
    fwd = lib.btc_attention_bf16_fwd if bf16 else lib.btc_attention_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if key_mask is None else key_mask.data_ptr(),
            None if segments is None else segments.data_ptr(),
            out.data_ptr(), B, T, C, n_head, scale, *plan, stream)
    _LIB.check(rc)
    form = "segments" if segments is not None else "key_mask" if key_mask is not None else "none"
    count(_LAUNCHED[q.dtype][form])
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
    """K1 forward on CUDA tensors: q/k/v (B, T, C) contiguous, all fp32 or
    all bf16 (the output in their dtype), key_mask (B, T) fp32 additive,
    segments (B, T) int32 (pads -1)."""
    return _BtcAttention.apply(q, k, v, key_mask, segments, n_head)
