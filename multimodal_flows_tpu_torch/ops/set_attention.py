"""K2 on Hopper: the wrapper of `csrc/set_attention.cu`.

Replaces the Pallas TPU kernel `_kernel`
(`multimodal_flows_tpu/ops/pallas_attention.py:48-71`, reached through
`_pallas_forward` / `pallas_set_attention`): attention with an additive
(B, Tk) key mask and an additive bias that broadcasts to (B, H, Tq, Tk).
The port uses it for two callers:

- `set_attention`: head-major (B, H, T, Dh) q/k/v, Tq != Tk allowed, the
  form `CrossAttention` calls through `ops.attention.multihead_attention`;
- `set_attention_btc`: token-major (B, T, C) q/k/v with the heads packed
  in C, optionally with (B, T) segment ids, the biased self-attention of
  the pairwise encoders (co-occurrence, FlavorFormer pairwise, Lund),
  which JAX runs as `_xla_attention_btc(bias=...)`, and the GPT
  baseline's attention, which JAX runs in XLA too: its full forward under
  a (1, 1, T, T) causal bias, and its KV-cache decode, one query against
  the (B, seq_len, C) caches under a (B, seq_len) causal key mask.

Both take fp32 or bf16 q/k/v (the output in their dtype, as the Pallas
kernel returns `v.dtype`); with bf16 q/k/v the bias may be fp32 or bf16.
Both hand the kernel strided views, so neither layout is copied, and a
broadcast bias (a zero stride) is never expanded.  The source file says
what bounds the kernel on the card; its design is the core it shares with
K1, `csrc/set_attention_core.cuh` (3xTF32 tensor cores at fp32 parity,
cp.async key/value tiles, cross-jet key tiles and their bias skipped).
Build: `ops/cuda_build.py` (nvcc for `sm_90a` at first use, ctypes).

The wrappers take CUDA tensors only and launch the kernel or raise; the
plain versions (`ops/attention.py`) serve CPU tensors through the
dispatchers.  The backward recomputes through the plain version, as the
JAX custom VJP `_bwd` recomputes through `_xla_reference`, and returns
dq, dk, dv and dbias (summed back to the bias's own broadcast shape);
key_mask and segments get no gradient.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from multimodal_flows_tpu_torch.ops.attention import (
    attention_btc_reference,
    attention_reference,
)
from multimodal_flows_tpu_torch.ops.cuda_build import CudaLibrary

Tensor = torch.Tensor

MAX_T = 256
MAX_HEAD_SIZE = 128

#: launches of the kernel by form, counted where the launch succeeds: fp32
#: q/k/v in LAUNCHES, bf16 in LAUNCHES_BF16
LAUNCHES = {"bias_segments": 0, "bias": 0, "bias_key_mask": 0, "key_mask": 0, "none": 0}
LAUNCHES_BF16 = dict(LAUNCHES)
DTYPES = (torch.float32, torch.bfloat16)


def _declare(lib: ctypes.CDLL) -> None:
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    lib.set_attention_fwd.argtypes = [ctypes.c_void_p] * 8 + tail
    lib.set_attention_fwd.restype = ctypes.c_int
    # q, k, v, key_mask, bias, bias_bf16, segments, out, strides, ...
    lib.set_attention_bf16_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                                           + [ctypes.c_void_p] * 3 + tail)
    lib.set_attention_bf16_fwd.restype = ctypes.c_int


_LIB = CudaLibrary("set_attention.cu", _declare)


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LAUNCHES_BF16):
        for form in counts:
            counts[form] = 0


def library_path() -> Path:
    return _LIB.path()


def build() -> ctypes.CDLL:
    """Compile (if this source has no library yet) and load the kernel."""
    return _LIB.load()


def _form(key_mask, bias, segments) -> str:
    if bias is not None:
        return ("bias_segments" if segments is not None
                else "bias_key_mask" if key_mask is not None else "bias")
    return "key_mask" if key_mask is not None else "none"


def _check(q4: Tensor, k4: Tensor, v4: Tensor, key_mask: Optional[Tensor],
           bias: Optional[Tensor], segments: Optional[Tensor]) -> Optional[Tensor]:
    """Check the (B, H, T, Dh) views and the optional inputs; returns the
    bias expanded (as a view) to (B, H, Tq, Tk)."""
    B, H, Tq, hs = q4.shape
    Tk = k4.shape[2]
    if q4.device.type != "cuda":
        raise ValueError("set_attention takes CUDA tensors; CPU tensors take the plain "
                         "versions in ops.attention")
    if k4.shape != (B, H, Tk, hs) or v4.shape != k4.shape:
        raise ValueError(f"k {tuple(k4.shape)} and v {tuple(v4.shape)} do not match "
                         f"q {tuple(q4.shape)}")
    if q4.dtype not in DTYPES:
        raise ValueError(f"q must be one of {DTYPES}, got {q4.dtype}")
    bias_dtypes = DTYPES if q4.dtype == torch.bfloat16 else (torch.float32,)
    for name, t, dtypes in (("q", q4, (q4.dtype,)), ("k", k4, (q4.dtype,)),
                            ("v", v4, (q4.dtype,)), ("key_mask", key_mask, (torch.float32,)),
                            ("bias", bias, bias_dtypes), ("segments", segments, (torch.int32,))):
        if t is None:
            continue
        if t.device != q4.device:
            raise ValueError(f"{name} is on {t.device}, q on {q4.device}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if key_mask is not None and (key_mask.shape != (B, Tk) or not key_mask.is_contiguous()):
        raise ValueError(f"key_mask must be contiguous (B, Tk) = {(B, Tk)}, "
                         f"got {tuple(key_mask.shape)}")
    if segments is not None:
        if bias is None:
            raise ValueError("segments without a bias is K1's form (ops.btc_attention)")
        if Tq != Tk or segments.shape != (B, Tq) or not segments.is_contiguous():
            raise ValueError(f"segments must be contiguous (B, T) = {(B, Tq)} with Tq == Tk, "
                             f"got {tuple(segments.shape)}, Tk={Tk}")
    if not (1 <= Tq <= MAX_T and 1 <= Tk <= MAX_T and 1 <= hs <= MAX_HEAD_SIZE and B >= 1):
        raise ValueError(f"K2 takes 1 <= Tq, Tk <= {MAX_T}, head size <= {MAX_HEAD_SIZE} "
                         f"and B >= 1; got B={B}, Tq={Tq}, Tk={Tk}, head size {hs}")
    if bias is None:
        return None
    if bias.dim() > 4:
        raise ValueError(f"bias must broadcast to (B, H, Tq, Tk), got {tuple(bias.shape)}")
    return bias.expand(B, H, Tq, Tk)


def _launch(q4: Tensor, k4: Tensor, v4: Tensor, key_mask: Optional[Tensor],
            bias: Optional[Tensor], segments: Optional[Tensor], out4: Tensor) -> None:
    """Launch K2 on (B, H, T, Dh) views, writing through the view `out4`."""
    bias4 = _check(q4, k4, v4, key_mask, bias, segments)
    lib = build()
    B, H, Tq, hs = q4.shape
    Tk = k4.shape[2]
    strides = [*q4.stride(), *k4.stride(), *v4.stride(),
               *(bias4.stride() if bias4 is not None else (0, 0, 0, 0)), *out4.stride()]
    packed = (ctypes.c_longlong * 20)(*strides)
    bf16 = q4.dtype == torch.bfloat16
    pointers = [q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                None if key_mask is None else key_mask.data_ptr(),
                None if bias4 is None else bias4.data_ptr()]
    if bf16:
        fwd = lib.set_attention_bf16_fwd
        pointers.append(int(bias4 is not None and bias4.dtype == torch.bfloat16))
    else:
        fwd = lib.set_attention_fwd
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream(q4.device).cuda_stream
        rc = fwd(*pointers, None if segments is None else segments.data_ptr(),
                 out4.data_ptr(), packed, B, H, Tq, Tk, hs, 1.0 / float(hs) ** 0.5, stream)
    _LIB.check(rc)
    (LAUNCHES_BF16 if bf16 else LAUNCHES)[_form(key_mask, bias, segments)] += 1


def _heads(x: Tensor, n_head: int) -> Tensor:
    """(B, T, C) -> its (B, H, T, hs) view, no copy."""
    return x.unflatten(-1, (n_head, x.shape[-1] // n_head)).transpose(1, 2)


class _SetAttention(torch.autograd.Function):
    """K2 forward; backward through the plain version.  `n_head` None
    means head-major q/k/v, else token-major with that many heads."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, bias, segments, n_head):
        ctx.save_for_backward(q, k, v, key_mask, bias, segments)
        ctx.n_head = n_head
        if n_head is None:
            out = q.new_empty(q.shape[:3] + (v.shape[-1],))
            _launch(q, k, v, key_mask, bias, segments, out)
        else:
            out = q.new_empty(q.shape)
            _launch(_heads(q, n_head), _heads(k, n_head), _heads(v, n_head), key_mask, bias,
                    segments, _heads(out, n_head))
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, key_mask, bias, segments = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
            if bias is not None and ctx.needs_input_grad[4]:
                inputs.append(bias.detach().requires_grad_(True))
                b = inputs[3]
            else:
                b = bias
            if ctx.n_head is None:
                out = attention_reference(*inputs[:3], key_mask, b)
            else:
                out = attention_btc_reference(*inputs[:3], ctx.n_head, key_mask, segments, b)
            grads = torch.autograd.grad(out, inputs, grad_out)
        dbias = grads[3] if len(grads) == 4 else None
        return grads[0], grads[1], grads[2], None, dbias, None, None


def set_attention(q: Tensor, k: Tensor, v: Tensor, key_mask: Optional[Tensor] = None,
                  bias: Optional[Tensor] = None) -> Tensor:
    """K2 on head-major CUDA tensors: q (B, H, Tq, Dh), k/v (B, H, Tk, Dh)
    of any strides, all fp32 or all bf16, key_mask (B, Tk) fp32 additive,
    bias additive and broadcastable to (B, H, Tq, Tk), fp32 (or bf16 with
    bf16 q/k/v).  Returns (B, H, Tq, Dh) in q's dtype."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, Dh), got {tuple(q.shape)}")
    return _SetAttention.apply(q, k, v, key_mask, bias, None, None)


def set_attention_btc(q: Tensor, k: Tensor, v: Tensor, n_head: int,
                      key_mask: Optional[Tensor] = None, bias: Optional[Tensor] = None,
                      segments: Optional[Tensor] = None) -> Tensor:
    """K2 on token-major CUDA tensors: q (B, Tq, C), k/v (B, Tk, C), all fp32
    or all bf16, with the heads packed in C, key_mask (B, Tk) fp32, bias
    broadcastable to (B, H, Tq, Tk) (fp32, or bf16 with bf16 q/k/v),
    segments (B, T) int32 (pads -1, needs a bias and Tq == Tk).  Returns
    (B, Tq, C) in q's dtype."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, T, C), got {tuple(q.shape)}")
    if n_head <= 0 or q.shape[-1] % n_head:
        raise ValueError(f"C={q.shape[-1]} is not a multiple of n_head={n_head}")
    return _SetAttention.apply(q, k, v, key_mask, bias, segments, n_head)
