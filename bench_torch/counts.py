"""The work the yardstick counts, and the peaks of the card it divides by.

Every number here is computed from the inputs of a run, never from the
program: the real tokens (particles, or sequence positions up to EOS) that
the traffic hands the entry, and the attention pairs among them.  Pads and
recomputation are not counted, so a program that pads less, or recomputes
less, does less than this count and not more.

- Model FLOPs: 2 per multiply-add of every dense layer a real token passes
  through, 4 x width per real (query, key) pair of every attention layer
  (QK^T and PV, width = heads x head size).  Layers applied once a jet or a
  row rather than once a token (the time projection, the multitask MLP) are
  left out: they are below 0.1% of a forward at the published widths.
- Attention bound: the larger of the bytes an attention call needs (q and
  out once for every real query, k and v once for every key it reads, plus
  the mask, the segment ids or the bias) at the card's memory bandwidth,
  and its FLOPs at the dense tensor-core peak of the configuration's dtype.
"""

from __future__ import annotations

import importlib
from typing import Dict

#: NVIDIA H100 SXM, NVIDIA's data sheet, dense rates without sparsity, at
#: the full 700 W power limit: HBM3 bandwidth and the dense tensor-core
#: peak by dtype (fp32 products run fastest as TF32)
H100_HBM_BYTES_PER_S = 3.35e12
H100_DENSE_FLOP_PER_S = {"float32": 495e12, "bfloat16": 989e12}
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def dense_peak(cfg: Dict) -> float:
    return H100_DENSE_FLOP_PER_S[cfg.get("compute_dtype", "float32")]


def block_flops(width: int, inner: int) -> int:
    """A pre-LN residual block a token: fused qkv, output projection, MLP."""
    return 2 * (width * 3 * width + width * width + 2 * width * inner)


def architecture(cfg: Dict):
    """The plain reference of the configuration's `architecture`
    (`reference/<architecture>.py`), which also states the architecture's
    work: `dense_flops(cfg)` a real token and `attention_layers(cfg)`.  An
    architecture without a module there is an error, never another's count."""
    name = f"bench_torch.reference.{cfg['architecture']}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise SystemExit(f"no plain reference {name} for the configuration's "
                         "architecture") from e


def forward_flops(cfg: Dict, tokens: int, pairs: int) -> int:
    """Model FLOPs of forwards over `tokens` real tokens with `pairs` real
    (query, key) pairs in each attention layer."""
    ref = architecture(cfg)
    return ref.dense_flops(cfg) * tokens + sum(4 * w * n * pairs
                                               for w, n in ref.attention_layers(cfg))


def attention_bytes(q_tokens: int, kv_tokens: int, width: int, elem_bytes: int,
                    extra_bytes: int) -> int:
    """q and out of every query, k and v of every key read, plus the mask,
    segment ids or bias."""
    return elem_bytes * width * (2 * q_tokens + 2 * kv_tokens) + extra_bytes


def attention_flops(width: int, pairs: int) -> int:
    return 4 * width * pairs


def attention_bound_s(record: Dict, cfg: Dict) -> float:
    """Least seconds of the attention calls of one work record (see
    `drivers/common.py:work_record`): for each layer width, `count`
    forwards' calls, each bounded by its bytes or its FLOPs."""
    elem = DTYPE_BYTES[cfg.get("compute_dtype", "float32")]
    peak = dense_peak(cfg)
    total = 0.0
    for width, layers in architecture(cfg).attention_layers(cfg):
        nbytes = attention_bytes(record["tokens"], record["kv_tokens"], width, elem,
                                 record["extra_bytes"])
        flops = attention_flops(width, record["pairs"])
        total += record["count"] * layers * max(nbytes / H100_HBM_BYTES_PER_S, flops / peak)
    return total
