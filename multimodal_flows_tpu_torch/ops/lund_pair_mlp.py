"""KinFormer's Lund pair MLP: the plain version and, on Hopper, one fused
kernel (`csrc/lund_pair_mlp.cu`).

For the Lund observables U (B, D, D, 2) of every slot pair of a row, the
pair bias (B, H, D, D) is

    lambda_u * W_out gelu(W_fc 0.5 (f(U) + f(U^T)) + b_fc) + b_out,
    f(u) = LayerNorm(gelu(W_1 u + b_1)),

Dense 2 -> C, exact GELU and LayerNorm (eps 1e-6 in KinFormer, flax's bare
`nn.LayerNorm`), then Dense C -> C, GELU and Dense C -> H.  The JAX package
runs it as plain XLA; it replaces no Pallas kernel.

- `pair_bias`: the chunked form over any stage 1 and head, in chunks of
  `chunk` query rows (the peak pair hidden is chunk / D of the unchunked
  form), each chunk symmetrised as 0.5 (f(U) + f(U^T)) rows: exactly the
  unchunked form; `plain_pair_bias` is it as a counted forward (the
  dispatch's CPU route; KinFormer's bf16 and tensor-parallel route).
- `lund_pair_mlp_reference`: `pair_bias` in fp32 over the weights of a
  `PairMLP`, the ops KinFormer's fp32 layers run.
- `lund_pair_mlp_kernel`: the fused kernel on CUDA fp32 tensors, one launch
  a forward on the current stream; raises on CPU tensors and on shapes it
  does not take (C = 256, 1 to 4 heads).  The 256-wide hidden of each pair
  stays in registers and shared memory; the C x C product runs on the
  tensor cores in 3xTF32, the split of the attention kernels (fp32-level
  error).  The source says what bounds it.
- `lund_pair_mlp`: the dispatch, by device alone.  CUDA tensors go to the
  kernel through `_LundPairMLP`, whose backward recomputes through the
  plain version, as K1's and K2's do; CPU tensors take the plain version.

The forwards are counted by route (`utils/profiling.py`: `lund_mlp.kernel`
where the kernel launched, `lund_mlp.plain` in `plain_pair_bias`); the
backward's recompute counts nothing.  Build:
`ops/cuda_build.py` (nvcc for `sm_90a` at first use, ctypes); nothing is
compiled at import.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from multimodal_flows_tpu_torch.ops.cuda_build import CudaLibrary
from multimodal_flows_tpu_torch.utils.profiling import count, declare

Tensor = torch.Tensor

declare("lund_mlp", "kernel", "plain")
#: the width (n_embd) the kernel takes, and its most heads
KERNEL_WIDTH = 256
MAX_HEADS = 4


class PairMLP(NamedTuple):
    """The pair MLP's weights: Dense 2 -> C (`fc_w`, `fc_b`), the LayerNorm
    (`ln_w`, `ln_b`, `eps`), Dense C -> C (`proj_w`, `proj_b`), Dense C -> H
    (`out_w`, `out_b`) and the 0-d gate `lambda_u`; the biases of the two
    projections may be None."""

    fc_w: Tensor
    fc_b: Tensor
    ln_w: Tensor
    ln_b: Tensor
    proj_w: Tensor
    proj_b: Optional[Tensor]
    out_w: Tensor
    out_b: Optional[Tensor]
    lambda_u: Tensor
    eps: float

    def tensors(self) -> tuple:
        """The tensors the kernel reads, in its argument order (absent
        biases as None)."""
        return tuple(self[:9])

    def stage1(self, u: Tensor) -> Tensor:
        """The plain version's f(u) = LayerNorm(gelu(W_1 u + b_1))."""
        return F.layer_norm(F.gelu(F.linear(u, self.fc_w, self.fc_b)), self.ln_w.shape,
                            self.ln_w, self.ln_b, self.eps)

    def head(self, x: Tensor) -> Tensor:
        """The plain version's W_out gelu(W_fc x + b_fc) + b_out."""
        return F.linear(F.gelu(F.linear(x, self.proj_w, self.proj_b)), self.out_w, self.out_b)


def pair_bias(U: Tensor, stage1: Callable[[Tensor], Tensor], head: Callable[[Tensor], Tensor],
              lambda_u: Tensor, chunk: int = 0) -> Tensor:
    """lambda_u * head(0.5 (stage1(U) + stage1(U^T))) as (B, H, D, D) fp32,
    in chunks of `chunk` query rows (0: one chunk)."""
    D = U.shape[1]
    c = chunk if chunk and chunk > 0 else D
    Ut = U.transpose(1, 2)
    outs = [head(0.5 * (stage1(U[:, a:a + c]) + stage1(Ut[:, a:a + c])))
            for a in range(0, D, c)]
    u = torch.cat(outs, dim=1)                                     # (B, D, D, H)
    return lambda_u * u.permute(0, 3, 1, 2).to(torch.float32).contiguous()


def plain_pair_bias(U: Tensor, stage1: Callable[[Tensor], Tensor],
                    head: Callable[[Tensor], Tensor], lambda_u: Tensor,
                    chunk: int = 0) -> Tensor:
    """`pair_bias`, counted as a forward on the plain route."""
    count("lund_mlp.plain")
    return pair_bias(U, stage1, head, lambda_u, chunk)


def lund_pair_mlp_reference(U: Tensor, mlp: PairMLP, chunk: int = 0) -> Tensor:
    """The pair bias (B, H, D, D) fp32 of U (B, D, D, 2) fp32, in chunks of
    `chunk` query rows (0: one chunk)."""
    return pair_bias(U, mlp.stage1, mlp.head, mlp.lambda_u, chunk)


def _declare(lib: ctypes.CDLL) -> None:
    # u, fc_w, fc_b, ln_w, ln_b, proj_w, proj_b, out_w, out_b, lambda, out,
    # B, D, C, H, eps, stream
    lib.lund_pair_mlp_fwd.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                                      + [ctypes.c_float, ctypes.c_void_p])
    lib.lund_pair_mlp_fwd.restype = ctypes.c_int


_LIB = CudaLibrary("lund_pair_mlp.cu", _declare)


def build() -> ctypes.CDLL:
    """Compile (if this source has no library yet) and load the kernel."""
    return _LIB.load()


def _check(U: Tensor, w: tuple) -> None:
    if U.device.type != "cuda":
        raise ValueError("lund_pair_mlp_kernel takes CUDA tensors; CPU tensors take "
                         "lund_pair_mlp_reference")
    if U.dtype != torch.float32:
        raise ValueError(f"U must be float32, got {U.dtype}")
    if U.dim() != 4 or U.shape[1] != U.shape[2] or U.shape[3] != 2 or not U.is_contiguous():
        raise ValueError(f"U must be contiguous (B, D, D, 2), got {tuple(U.shape)}")
    C, H = w[0].shape[0], w[6].shape[0]
    if C != KERNEL_WIDTH or not 1 <= H <= MAX_HEADS:
        raise ValueError(f"the Lund pair MLP kernel takes n_embd {KERNEL_WIDTH} and 1 to "
                         f"{MAX_HEADS} heads, got n_embd {C} and {H} heads")
    shapes = [(C, 2), (C,), (C,), (C,), (C, C), (C,), (H, C), (H,), ()]
    names = ["fc_w", "fc_b", "ln_w", "ln_b", "proj_w", "proj_b", "out_w", "out_b", "lambda_u"]
    for name, t, shape in zip(names, w, shapes):
        if t is None and name in ("proj_b", "out_b"):
            continue
        if t is None or t.device != U.device:
            raise ValueError(f"{name} is on {None if t is None else t.device}, U on {U.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {shape}, got {tuple(t.shape)}")
    if w[4].data_ptr() % 16:
        raise ValueError("proj_w must be 16-byte aligned (the kernel reads it by TMA)")


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def lund_pair_mlp_kernel(U: Tensor, mlp: PairMLP) -> Tensor:
    """The fused kernel: the pair bias (B, H, D, D) fp32 of U (B, D, D, 2),
    fp32 CUDA tensors (`_check` says which), in one launch on the current
    stream."""
    w = mlp.tensors()
    _check(U, w)
    B, D = U.shape[0], U.shape[1]
    C, H = w[0].shape[0], w[6].shape[0]
    out = torch.empty((B, H, D, D), device=U.device, dtype=torch.float32)
    if out.numel():
        lib = build()
        with torch.cuda.device(U.device):
            stream = torch.cuda.current_stream(U.device).cuda_stream
            rc = lib.lund_pair_mlp_fwd(U.data_ptr(), *(_ptr(t) for t in w), out.data_ptr(),
                                       B, D, C, H, mlp.eps, stream)
        _LIB.check(rc)
        count("lund_mlp.kernel")
    return out


#: the kernel the Function launches (the CPU tests put the plain version here)
_launch = lund_pair_mlp_kernel


class _LundPairMLP(torch.autograd.Function):
    """The kernel forward; the backward recomputes through the plain
    version in fp32, in chunks of `chunk` query rows.  The weights enter
    as inputs so that autograd hands them their gradients."""

    @staticmethod
    def forward(ctx, U, mlp, chunk, *weights):
        ctx.save_for_backward(U)
        ctx.mlp, ctx.chunk = mlp, chunk
        return _launch(U, mlp)

    @staticmethod
    def backward(ctx, grad_out):
        (U,) = ctx.saved_tensors
        needs = ctx.needs_input_grad
        wanted = ([U.detach().requires_grad_(True)] if needs[0] else []) + [
            t for t, need in zip(ctx.mlp.tensors(), needs[3:]) if need]
        with torch.enable_grad():
            u = wanted[0] if needs[0] else U
            grads = iter(torch.autograd.grad(
                lund_pair_mlp_reference(u, ctx.mlp, ctx.chunk), wanted, grad_out))
        return ((next(grads) if needs[0] else None), None, None,
                *(next(grads) if need else None for need in needs[3:]))


def lund_pair_mlp(U: Tensor, mlp: PairMLP, chunk: int = 0) -> Tensor:
    """The pair bias (B, H, D, D) fp32 of U (B, D, D, 2) fp32: on CUDA the
    kernel (with its gradient through the plain version), on the CPU the
    plain version in chunks of `chunk` query rows."""
    if U.device.type == "cuda":
        return _LundPairMLP.apply(U, mlp, chunk, *mlp.tensors())
    return plain_pair_bias(U, mlp.stage1, mlp.head, mlp.lambda_u, chunk)
