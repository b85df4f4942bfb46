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
  baseline's attention, which JAX runs in XLA too: its full forward
  (`causal=True`: the kernel's causal form, which computes in the kernel
  what JAX's (1, 1, T, T) causal bias adds and skips the key tiles past
  each query tile), and its KV-cache decode, one query against the
  (B, seq_len, C) caches under a (B, seq_len) causal key mask.

Both take fp32 or bf16 q/k/v (the output in their dtype, as the Pallas
kernel returns `v.dtype`); with bf16 q/k/v the bias may be fp32 or bf16.
Both hand the kernel strided views, so neither layout is copied, and a
broadcast bias (a zero stride) is never expanded.  The source file says
what bounds the kernel on the card; its design is the core it shares with
K1, `csrc/set_attention_core.cuh`: TMA loads on mbarriers and `wgmma` for
both dtypes (fp32: 3xTF32 at fp32 parity; cross-jet key tiles and their
bias skipped).  `fp32_plan` and `bf16_plan` decide on the host how a call
runs (which operands go by TMA, the ring's stages, the slices, for fp32
the key splits, the shared memory), and K1's wrapper takes them too.  Any
Tq, Tk and head size run: the key tiles pass through a ring of stages
(bf16: past 256 keys), past a head size of 128 a block computes one slice
of 128 output columns; the only bound is a block's shared memory (the key
mask and segment ids are staged whole), and the plans raise, naming it,
where it does not fit.  Build: `ops/cuda_build.py` (nvcc for `sm_90a` at
first use, ctypes).

The wrappers take CUDA tensors only and launch the kernel or raise; the
plain versions (`ops/attention.py`) serve CPU tensors through the
dispatchers.  The backward recomputes through the plain version, as the
JAX custom VJP `_bwd` recomputes through `_xla_reference`, and returns
dq, dk, dv and dbias (summed back to the bias's own broadcast shape);
key_mask and segments get no gradient.  The causal form's backward
recomputes through the plain version with the causal bias, built once per
(T, device).
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path
from typing import Optional

import torch

from multimodal_flows_tpu_torch.ops.attention import (
    attention_btc_reference,
    attention_reference,
    causal_bias,
)
from multimodal_flows_tpu_torch.ops.cuda_build import CudaLibrary
from multimodal_flows_tpu_torch.utils.profiling import count, declare

Tensor = torch.Tensor

FORMS = ("bias_segments", "bias", "bias_key_mask", "key_mask", "none")
DTYPES = (torch.float32, torch.bfloat16)
#: the launch counters by dtype and form (GPT's full forward: `k2.causal`)
_LAUNCHED = {torch.float32: declare("k2", *FORMS, "causal"),
             torch.bfloat16: declare("k2_bf16", *FORMS)}

#: the bf16 core's tiles: 64 query rows a block (one warpgroup), 64 keys a
#: key tile; a bias box is 64 rows of 128 bytes
BF16_TILE = 64
#: the fp32 core's ring stages at most (chunks of 64 rows x 64 columns, 32
#: at head size <= 32)
MAX_FP32_STAGES = 4
#: the SMs of an H100: an fp32 call whose blocks fill at most half of the
#: blocks the card holds at once splits its key tiles across blocks, at
#: most MAX_SPLITS ways
NUM_SMS = 132
MAX_SPLITS = 8
#: an SM's shared memory (228 KB), of which 1 KB is reserved a block
SM_SHARED_BYTES = 233_472
#: the widest head a block holds whole; wider heads run in slices of this
#: many output columns (both cores)
SLICE = 128
#: the bf16 ring's stages at most, where the key tiles of a row do not all
#: stay resident: a whole-head tile (K, V and a bias block) or a chunk of
#: 64 keys x SLICE columns in slices
MAX_RING_STAGES = 4
MAX_SLICED_STAGES = 4
#: the shared memory one block may use on an H100 (227 KB)
MAX_SHARED_BYTES = 232_448


def _declare(lib: ctypes.CDLL) -> None:
    # the fp32 plan's qkv_tma, stages, splits, smem; the split scratch; the stream
    plan = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    # q, k, v, key_mask, bias, segments, out, strides, B, H, Tq, Tk, hs, scale, plan
    lib.set_attention_fwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                                      + [ctypes.c_float] + plan)
    lib.set_attention_fwd.restype = ctypes.c_int
    # q, k, v, key_mask, out, strides, B, H, T, hs, scale, plan
    lib.set_attention_causal_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                             + [ctypes.c_float] + plan)
    lib.set_attention_causal_fwd.restype = ctypes.c_int
    # q, k, v, key_mask, bias, bias_bf16, segments, out, strides, B, H, Tq, Tk,
    # hs, scale, qkv_tma, bias_tma, stages, smem, stream
    lib.set_attention_bf16_fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                                           + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                                           + [ctypes.c_float] + [ctypes.c_int] * 4
                                           + [ctypes.c_void_p])
    lib.set_attention_bf16_fwd.restype = ctypes.c_int


_LIB = CudaLibrary("set_attention.cu", _declare)


def library_path() -> Path:
    return _LIB.path()


def build() -> ctypes.CDLL:
    """Compile (if this source has no library yet) and load the kernel."""
    return _LIB.load()


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _slices(hs: int) -> int:
    return -(-hs // SLICE)


def _too_big(form: str, smem: int, Tk: int, hs: int) -> ValueError:
    return ValueError(f"the {form} kernel needs {smem} bytes of shared memory at Tk={Tk}, "
                      f"head size {hs}: more than the {MAX_SHARED_BYTES} a block has")


@dataclasses.dataclass(frozen=True)
class Fp32Plan:
    """How the fp32 core runs one call (`csrc/set_attention_core.cuh`,
    `attention_kernel_tf32`): the output columns of a block (32, 64 or
    SLICE; SLICE in slices past a head size of 128), the columns of a chunk
    (64 rows x `chunk` fp32: min(head_bucket, 64)), the slices a head is cut
    into, its key tiles of 64, whether q/k/v go by TMA (else the block's
    threads stage them), the stages of the ring of chunks (each a K pass or
    a V part of a key tile), the key splits (each block one contiguous
    share of the key tiles, its partial merged by `merge_splits`) and the
    launch's shared memory, which the C entry checks against its own
    count."""

    head_bucket: int
    chunk: int
    slices: int
    key_tiles: int
    qkv_tma: bool
    stages: int
    splits: int
    smem_bytes: int

    def scratch_floats(self, B: int, H: int, Tq: int, hs: int) -> int:
        """The split rows' partials: O (splits, B, H, Tq, hs), then each
        row's max and sum (splits, B, H, Tq); 0 without splits."""
        return 0 if self.splits == 1 else self.splits * B * H * Tq * (hs + 2)


def fp32_smem_bytes(head_bucket: int, hs: int, Tk: int, stages: int) -> int:
    """The fp32 kernel's shared memory (`fp32_smem` in the core), in chunks
    of 64 rows x w fp32, w = min(head_bucket, 64): the query rows of the
    whole head (ceil(hs / w) chunks), `stages` chunks of the ring, the work
    chunks (K's lo part, V^T's hi and lo parts: 3 up to head size 64, 2
    past it), the key mask and the segment ids (4 Tk bytes each), a scratch
    of the tile intervals (at least 32 ints), one mbarrier for Q and a
    `full` and an `empty` one a stage, and 1024 bytes to align the base."""
    w = min(head_bucket, 64)
    chunk = BF16_TILE * w * 4
    km = (-(-hs // w) + stages + (3 if head_bucket <= 64 else 2)) * chunk
    scratch_ints = max(32, 8 + 3 * -(-Tk // BF16_TILE))
    bar = _round_up(km + 8 * Tk + 4 * scratch_ints, 8)
    return bar + 8 * (1 + 2 * stages) + 1024


def fp32_plan(q4: Tensor, k4: Tensor, v4: Tensor) -> Fp32Plan:
    """The plan of one fp32 call on (B, H, T, D) views (K1's token-major
    views included).  q/k/v go by TMA where all three can (`_tma_readable`).
    The ring: the stages (up to MAX_FP32_STAGES, no more than the block's
    chunks; at least 2 up to head size 64, where a tile's K and V chunks are
    held together) that give the most blocks an SM, by shared memory and by
    the kernel's registers (4 at head size <= 32, else 2), and of those the
    most.  The key tiles are split across blocks where the call's blocks (B
    x query tiles x H x slices) fill at most half of the card's resident
    blocks (NUM_SMS x blocks an SM): into as many shares as the resident
    blocks hold, at most MAX_SPLITS, one a key tile, and one a whole 8
    chunks of the block's work (a split below that costs its merge more
    than it saves).  Raises where even the fewest stages pass
    MAX_SHARED_BYTES (the key mask and segment ids, 8 Tk bytes, and the
    query rows of the whole head, 256 hs bytes, are what grow)."""
    B, H, Tq, hs = q4.shape
    Tk = k4.shape[2]
    bucket = 32 if hs <= 32 else 64 if hs <= 64 else SLICE
    w = min(bucket, 64)
    slices = _slices(hs)
    n_tiles = -(-Tk // BF16_TILE)
    chunks = n_tiles * (-(-hs // w) + bucket // w)  # a block's K passes and V parts
    least = 2 if bucket <= 64 else 1
    fits = [st for st in range(max(least, min(MAX_FP32_STAGES, chunks)), least - 1, -1)
            if fp32_smem_bytes(bucket, hs, Tk, st) <= MAX_SHARED_BYTES]
    if not fits:
        raise _too_big("fp32", fp32_smem_bytes(bucket, hs, Tk, least), Tk, hs)

    def blocks_an_sm(stages: int) -> int:
        return min(4 if bucket == 32 else 2,
                   SM_SHARED_BYTES // (fp32_smem_bytes(bucket, hs, Tk, stages) + 1024))

    stages = max(fits, key=lambda st: (blocks_an_sm(st), st))
    resident = NUM_SMS * blocks_an_sm(stages)
    blocks = B * -(-Tq // BF16_TILE) * H * slices
    splits = 1
    if 2 * blocks <= resident:
        splits = max(1, min(resident // blocks, n_tiles, MAX_SPLITS, chunks // 8))
    return Fp32Plan(head_bucket=bucket, chunk=w, slices=slices, key_tiles=n_tiles,
                    qkv_tma=all(_tma_readable(t) for t in (q4, k4, v4)), stages=stages,
                    splits=splits, smem_bytes=fp32_smem_bytes(bucket, hs, Tk, stages))


def split_partials(q4: Tensor, k4: Tensor, v4: Tensor, splits: int,
                   key_mask: Optional[Tensor] = None, bias: Optional[Tensor] = None):
    """The plain version of what the blocks of a split call write: for
    each share s of the key tiles of 64 (tiles s n / splits.. (s + 1) n /
    splits - 1 of n), the unnormalised output O_s = sum_j exp(s_j - m_s)
    v_j, the rows' max m_s and sum l_s over the share's keys (head-major
    (B, H, Tq, Dh) views; the scores as `attention_reference` makes them).
    A share with no key has m = -inf, l = 0, O = 0.  Returns (O, m, l),
    (splits, B, H, Tq, Dh) and (splits, B, H, Tq)."""
    scores = (q4 @ k4.transpose(-1, -2)) / float(q4.shape[-1]) ** 0.5
    if key_mask is not None:
        scores = scores + key_mask[:, None, None, :]
    if bias is not None:
        scores = scores + bias
    Tk = k4.shape[2]
    n_tiles = -(-Tk // BF16_TILE)
    outs, maxes, sums = [], [], []
    for s in range(splits):
        j0 = min(Tk, s * n_tiles // splits * BF16_TILE)
        j1 = min(Tk, (s + 1) * n_tiles // splits * BF16_TILE)
        part = scores[..., j0:j1]
        if j1 == j0:
            m = torch.full(scores.shape[:-1], -torch.inf, dtype=scores.dtype)
            outs.append(torch.zeros(scores.shape[:-1] + v4.shape[-1:], dtype=scores.dtype))
            maxes.append(m)
            sums.append(torch.zeros_like(m))
            continue
        m = part.amax(dim=-1)
        e = torch.exp(part - m[..., None])
        outs.append(e @ v4[..., j0:j1, :])
        maxes.append(m)
        sums.append(e.sum(dim=-1))
    return torch.stack(outs), torch.stack(maxes), torch.stack(sums)


def merge_partials(o: Tensor, m: Tensor, l: Tensor) -> Tensor:
    """The plain version of the core's `merge_splits`: rows split over
    shares s, out = sum_s w_s O_s / sum_s w_s l_s with w_s = exp(m_s -
    max_s m_s) (0 for a share without keys), from O (splits, ..., D) and m,
    l (splits, ...)."""
    w = torch.where(m == -torch.inf, 0.0, torch.exp(m - m.amax(dim=0)))
    return (w[..., None] * o).sum(dim=0) / (w * l).sum(dim=0)[..., None]


@dataclasses.dataclass(frozen=True)
class Bf16Plan:
    """How the bf16 core runs one call (`csrc/set_attention_core.cuh`):
    the head-size template (32, 64 or 128; SLICE in slices), the swizzle of
    its Q/K/V rows in shared memory, its key tiles of 64, whether q/k/v and
    the bias go by TMA (else the block's threads stage q/k/v and the
    fragments read the bias from global memory), the stages of its ring, the
    slices a head is cut into, and the launch's shared memory, which the C
    entry checks against its own count.  With one slice a stage holds a key
    tile's K, V and bias block, and `stages == key_tiles` keeps the whole
    row resident (every Tk <= 256); in slices a stage holds one chunk of 64
    keys x SLICE columns (a K pass or V's slice) and the bias is read per
    fragment."""

    head_bucket: int
    swizzle_bytes: int
    key_tiles: int
    qkv_tma: bool
    bias_tma: bool
    smem_bytes: int
    stages: int
    slices: int


def bf16_smem_bytes(head_bucket: int, Tk: int, bias_tile: int, stages: Optional[int] = None,
                    slices: int = 1) -> int:
    """The bf16 kernel's shared memory (`bf16_smem` in the core).  One
    slice: the query tile (or the output's staging rows), `stages` K and V
    tiles and bias blocks staged by TMA (`bias_tile` bytes each; `stages`
    defaults to every key tile); in slices: the query rows as `slices`
    chunks of 64 x SLICE, then `stages` chunks.  Then the key mask, the
    segment ids, a scratch of the tile intervals (at least 32 ints), one
    mbarrier for Q, one `full` a stage and, where a stage is reused, one
    `empty` a stage, and 1024 bytes to align the base."""
    tile = BF16_TILE * head_bucket * 2
    out = BF16_TILE * (head_bucket + 8) * 2
    n_tiles = -(-Tk // BF16_TILE)
    stages = n_tiles if stages is None else stages
    if slices > 1:
        k = slices * tile
        km = k + stages * tile
    else:
        k = _round_up(max(tile, out), 1024)
        km = k + 2 * stages * tile + stages * bias_tile
    scratch_ints = max(32, 8 + 3 * n_tiles)
    bar = _round_up(km + 8 * Tk + 4 * scratch_ints, 8)
    n_bars = 1 + stages + (stages if slices > 1 or stages < n_tiles else 0)
    return bar + 8 * n_bars + 1024


def _tma_readable(t: Tensor, broadcast_ok: bool = False) -> bool:
    """Whether a tensor map can describe the 4-d view `t`: its last
    dimension contiguous, its base 16-byte aligned and every other stride
    of a dimension longer than 1 a multiple of 16 bytes; a zero stride (a
    broadcast) only where `broadcast_ok` and not in the rows' dimension."""
    es = t.element_size()
    if t.data_ptr() % 16 or (t.shape[-1] > 1 and t.stride(-1) != 1):
        return False
    for dim in range(t.dim() - 1):
        n, s = t.shape[dim], t.stride(dim)
        if n == 1:
            continue
        if s == 0 and not (broadcast_ok and dim < t.dim() - 2):
            return False
        if s * es % 16:
            return False
    return True


def bf16_plan(q4: Tensor, k4: Tensor, v4: Tensor, bias4: Optional[Tensor] = None) -> Bf16Plan:
    """The plan of one bf16 call on (B, H, T, D) views (K1's token-major
    views included) and the bias expanded to (B, H, Tq, Tk), or None.
    q/k/v go by TMA where all three can; the bias where its keys are
    contiguous and its rows' stride and base meet TMA's 16-byte rules (a
    zero head or row stride is a dimension of extent 1 in its map), and the
    head is whole.  The ring: every key tile resident where there are at
    most MAX_RING_STAGES of them (Tk <= 256), else the most stages up to
    MAX_RING_STAGES that fit; in slices the most chunks up to
    MAX_SLICED_STAGES that fit.  Raises where even the smallest ring passes
    MAX_SHARED_BYTES (the key mask and segment ids, 8 Tk bytes, and in
    slices the query rows, 128 hs bytes, are what grow)."""
    hs, Tk = q4.shape[-1], k4.shape[2]
    slices = _slices(hs)
    n_tiles = -(-Tk // BF16_TILE)
    bucket = 32 if hs <= 32 else 64 if hs <= 64 else SLICE
    most = MAX_SLICED_STAGES if slices > 1 else min(n_tiles, MAX_RING_STAGES)
    least = 1 if slices == 1 and n_tiles == 1 else 2
    qkv_tma = all(_tma_readable(t) for t in (q4, k4, v4))
    bias_tma = slices == 1 and bias4 is not None and _tma_readable(bias4, broadcast_ok=True)
    # the bias by TMA where a ring still fits with its blocks, else per fragment
    for by_tma in ((True, False) if bias_tma else (False,)):
        bias_tile = BF16_TILE * BF16_TILE * bias4.element_size() if by_tma else 0
        for stages in range(most, least - 1, -1):
            smem = bf16_smem_bytes(bucket, Tk, bias_tile, stages, slices)
            if smem <= MAX_SHARED_BYTES:
                return Bf16Plan(head_bucket=bucket, swizzle_bytes=min(2 * bucket, 128),
                                key_tiles=n_tiles, qkv_tma=qkv_tma, bias_tma=by_tma,
                                smem_bytes=smem, stages=stages, slices=slices)
    raise _too_big("bf16", smem, Tk, hs)


def _form(key_mask, bias, segments, causal) -> str:
    if causal:
        return "causal"
    if bias is not None:
        return ("bias_segments" if segments is not None
                else "bias_key_mask" if key_mask is not None else "bias")
    return "key_mask" if key_mask is not None else "none"


def _check_causal(q: Tensor, k: Tensor, bias: Optional[Tensor],
                  segments: Optional[Tensor]) -> None:
    """The causal form is GPT's self-attention: Tq == Tk, fp32, the causal
    term in place of a bias, no segments."""
    if k.shape[-2] != q.shape[-2]:
        raise ValueError(f"causal attention needs Tq == Tk, got Tq={q.shape[-2]}, "
                         f"Tk={k.shape[-2]}")
    if bias is not None or segments is not None:
        raise ValueError("the causal form computes its causal bias in the kernel: pass no bias "
                         "and no segments")
    if q.dtype != torch.float32:
        raise ValueError(f"the causal form is fp32 (GPT has no compute dtype), got {q.dtype}")


def _check(q4: Tensor, k4: Tensor, v4: Tensor, key_mask: Optional[Tensor],
           bias: Optional[Tensor], segments: Optional[Tensor]) -> Optional[Tensor]:
    """Check the (B, H, T, Dh) views and the optional inputs; returns the
    bias expanded (as a view) to (B, H, Tq, Tk)."""
    B, H, Tq, hs = q4.shape
    Tk = k4.shape[2]
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
    if min(B, H, Tq, Tk, hs) < 1:
        raise ValueError(f"K2 takes B, H, Tq, Tk and the head size >= 1; got B={B}, H={H}, "
                         f"Tq={Tq}, Tk={Tk}, head size {hs}")
    if bias is None:
        return None
    if bias.dim() > 4:
        raise ValueError(f"bias must broadcast to (B, H, Tq, Tk), got {tuple(bias.shape)}")
    return bias.expand(B, H, Tq, Tk)


def _launch(q4: Tensor, k4: Tensor, v4: Tensor, key_mask: Optional[Tensor],
            bias: Optional[Tensor], segments: Optional[Tensor], out4: Tensor,
            causal: bool = False) -> None:
    """Launch K2 on (B, H, T, Dh) views, writing through the view `out4`
    (`causal`: the causal form, its inputs checked by the caller)."""
    if q4.device.type != "cuda":
        raise ValueError("set_attention takes CUDA tensors; CPU tensors take the plain "
                         "versions in ops.attention")
    bias4 = _check(q4, k4, v4, key_mask, bias, segments)
    bf16 = q4.dtype == torch.bfloat16
    B, H, Tq, hs = q4.shape
    Tk = k4.shape[2]
    # the shared memory bounds the shapes: the plans raise where it does not fit
    plan = bf16_plan(q4, k4, v4, bias4) if bf16 else fp32_plan(q4, k4, v4)
    lib = build()
    scale = 1.0 / float(hs) ** 0.5
    mask = None if key_mask is None else key_mask.data_ptr()
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream(q4.device).cuda_stream
        if not bf16:
            part = (torch.empty(plan.scratch_floats(B, H, Tq, hs), device=q4.device)
                    if plan.splits > 1 else None)
            fp32 = [int(plan.qkv_tma), plan.stages, plan.splits, plan.smem_bytes,
                    None if part is None else part.data_ptr(), stream]
        if causal:
            packed = (ctypes.c_longlong * 16)(*q4.stride(), *k4.stride(), *v4.stride(),
                                              *out4.stride())
            rc = lib.set_attention_causal_fwd(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), mask,
                                              out4.data_ptr(), packed, B, H, Tq, hs, scale,
                                              *fp32)
        else:
            packed = (ctypes.c_longlong * 20)(
                *q4.stride(), *k4.stride(), *v4.stride(),
                *(bias4.stride() if bias4 is not None else (0, 0, 0, 0)), *out4.stride())
            pointers = [q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), mask,
                        None if bias4 is None else bias4.data_ptr()]
            seg = None if segments is None else segments.data_ptr()
            if bf16:
                rc = lib.set_attention_bf16_fwd(
                    *pointers, int(bias4 is not None and bias4.dtype == torch.bfloat16), seg,
                    out4.data_ptr(), packed, B, H, Tq, Tk, hs, scale, int(plan.qkv_tma),
                    int(plan.bias_tma), plan.stages, plan.smem_bytes, stream)
            else:
                rc = lib.set_attention_fwd(*pointers, seg, out4.data_ptr(), packed, B, H, Tq, Tk,
                                           hs, scale, *fp32)
    _LIB.check(rc)
    count(_LAUNCHED[q4.dtype][_form(key_mask, bias, segments, causal)])


def _heads(x: Tensor, n_head: int) -> Tensor:
    """(B, T, C) -> its (B, H, T, hs) view, no copy."""
    return x.unflatten(-1, (n_head, x.shape[-1] // n_head)).transpose(1, 2)


class _SetAttention(torch.autograd.Function):
    """K2 forward; backward through the plain version.  `n_head` None
    means head-major q/k/v, else token-major with that many heads."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, bias, segments, n_head, causal):
        ctx.save_for_backward(q, k, v, key_mask, bias, segments)
        ctx.n_head, ctx.causal = n_head, causal
        if n_head is None:
            out = q.new_empty(q.shape[:3] + (v.shape[-1],))
            _launch(q, k, v, key_mask, bias, segments, out, causal)
        else:
            out = q.new_empty(q.shape)
            _launch(_heads(q, n_head), _heads(k, n_head), _heads(v, n_head), key_mask, bias,
                    segments, _heads(out, n_head), causal)
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
            if ctx.causal:
                b = causal_bias(q.shape[-2], q.device)
            if ctx.n_head is None:
                out = attention_reference(*inputs[:3], key_mask, b)
            else:
                out = attention_btc_reference(*inputs[:3], ctx.n_head, key_mask, segments, b)
            grads = torch.autograd.grad(out, inputs, grad_out)
        dbias = grads[3] if len(grads) == 4 else None
        return grads[0], grads[1], grads[2], None, dbias, None, None, None


def set_attention(q: Tensor, k: Tensor, v: Tensor, key_mask: Optional[Tensor] = None,
                  bias: Optional[Tensor] = None) -> Tensor:
    """K2 on head-major CUDA tensors: q (B, H, Tq, Dh), k/v (B, H, Tk, Dh)
    of any strides, all fp32 or all bf16, key_mask (B, Tk) fp32 additive,
    bias additive and broadcastable to (B, H, Tq, Tk), fp32 (or bf16 with
    bf16 q/k/v).  Returns (B, H, Tq, Dh) in q's dtype."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, H, T, Dh), got {tuple(q.shape)}")
    return _SetAttention.apply(q, k, v, key_mask, bias, None, None, False)


def set_attention_btc(q: Tensor, k: Tensor, v: Tensor, n_head: int,
                      key_mask: Optional[Tensor] = None, bias: Optional[Tensor] = None,
                      segments: Optional[Tensor] = None, causal: bool = False) -> Tensor:
    """K2 on token-major CUDA tensors: q (B, Tq, C), k/v (B, Tk, C), all fp32
    or all bf16, with the heads packed in C, key_mask (B, Tk) fp32, bias
    broadcastable to (B, H, Tq, Tk) (fp32, or bf16 with bf16 q/k/v),
    segments (B, T) int32 (pads -1, needs a bias and Tq == Tk).  With
    `causal` (fp32, Tq == Tk, no bias, no segments) key j > query i is
    masked by -1e9 in the kernel, exactly the additive causal bias of
    `ops.attention.causal_bias`.  Returns (B, Tq, C) in q's dtype."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, T, C), got {tuple(q.shape)}")
    if n_head <= 0 or q.shape[-1] % n_head:
        raise ValueError(f"C={q.shape[-1]} is not a multiple of n_head={n_head}")
    if causal:
        _check_causal(q, k, bias, segments)
    return _SetAttention.apply(q, k, v, key_mask, bias, segments, n_head, causal)
