"""The yardstick's counts on the CPU: the model FLOPs against a brute count
of the reference's products, the causal pair count against enumeration,
and the attention bytes against the port's kernel bound at the shapes its
kernel table times (`chip_smoke.py:_bound`: q, k, v and out once at q's
element size, plus segments, key mask or bias).

    python -m pytest bench_torch/tests/test_counts.py -q
"""

import math
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench_torch import counts, weights  # noqa: E402
from bench_torch.reference import flavorseq_gpt, particleformer  # noqa: E402
from bench_torch.reference.common import Ops  # noqa: E402

SMALL = dict(n_embd=32, n_inner=48, n_layer=2, n_layer_fused=1, n_head=4, vocab_size=9,
             dim_continuous=3, max_num_particles=20, max_seq_length=20)


def _brute(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("m", [1, 7, 20])
def test_particleformer_flops_equal_a_brute_count(m):
    cfg = dict(SMALL, architecture="particleformer")
    p = weights.draw(particleformer.param_spec(cfg), 0, torch.device("cpu"))
    x = torch.randn(1, m, 3)
    k = torch.randint(1, 9, (1, m))
    mask = torch.ones(1, m, dtype=torch.bool)
    brute = _brute(lambda: particleformer.forward(Ops(), p, cfg, x, k, mask, torch.rand(1)))
    # the time projection runs once a jet, not once a particle: left out
    once_a_jet = 2 * (cfg["n_embd"] // 2) * cfg["n_embd"]
    assert brute == counts.forward_flops(cfg, m, m * m) + once_a_jet


@pytest.mark.parametrize("T", [1, 9, 22])
def test_gpt_flops_equal_a_brute_count(T):
    cfg = dict(SMALL, architecture="flavorseq_gpt")
    p = weights.draw(flavorseq_gpt.param_spec(cfg), 0, torch.device("cpu"))
    ids = torch.randint(0, 13, (1, T))
    brute = _brute(lambda: flavorseq_gpt.forward(Ops(), p, cfg, ids))
    # the plain reference multiplies every (query, key) pair, masked or not
    assert brute == counts.forward_flops(cfg, T, T * T)


@pytest.mark.parametrize("n", [1, 2, 41, 152])
def test_causal_pairs_equal_enumeration(n):
    assert sum(1 for i in range(n) for j in range(n) if j <= i) == n * (n + 1) // 2


def _bytes_of_bound(q_numel, extra):
    """`chip_smoke.py:_bound`'s bytes for fp32."""
    return 4 * q_numel * 4 + extra


@pytest.mark.parametrize("B,T,C,H", [(128, 128, 128, 4), (128, 128, 256, 4)])
def test_packed_row_bytes_equal_the_kernel_table_bound(B, T, C, H):
    seg_bytes = 4 * B * T
    assert counts.attention_bytes(B * T, B * T, C, 4, seg_bytes) == \
        _bytes_of_bound(B * T * C, seg_bytes)
    # K2 with a (B, H, T, T) bias: the bias of the same-jet pairs
    pairs = 3_000_000
    extra = 4 * (B * T + H * pairs)
    assert counts.attention_bytes(B * T, B * T, C, 4, extra) == _bytes_of_bound(B * T * C, extra)
    # the numbers of the kernel table (0.0100 / 0.0201 ms at 3.35 TB/s)
    ms = counts.attention_bytes(B * T, B * T, C, 4, seg_bytes) / counts.H100_HBM_BYTES_PER_S * 1e3
    assert round(ms, 4) == {128: 0.0100, 256: 0.0201}[C]


def test_key_mask_and_gpt_bytes_equal_the_kernel_table_bound():
    B, T, C = 8, 150, 256
    assert counts.attention_bytes(B * T, B * T, C, 4, 4 * B * T) == \
        _bytes_of_bound(B * T * C, 4 * B * T)
    B, T, C = 256, 152, 256                                     # GPT's forward
    assert counts.attention_bytes(B * T, B * T, C, 4, 0) == 4 * 4 * B * T * C
    for pos in (75, 151):                                       # a decode step
        keys = B * (pos + 1)
        smoke = 4 * (2 * B * C + B * T + 2 * keys * C)
        assert counts.attention_bytes(B, keys, C, 4, 4 * B * T) == smoke


def test_bound_takes_the_longer_of_bytes_and_flops():
    cfg = dict(SMALL, architecture="flavorseq_gpt", n_embd=256, n_layer=1)
    rec = dict(count=1, tokens=10, kv_tokens=10, pairs=10**9, extra_bytes=0)
    flops_s = 4 * 256 * 10**9 / counts.H100_DENSE_FLOP_PER_S["float32"]
    assert math.isclose(counts.attention_bound_s(rec, cfg), flops_s)
    rec = dict(count=2, tokens=10**6, kv_tokens=10**6, pairs=1, extra_bytes=0)
    assert math.isclose(counts.attention_bound_s(rec, cfg),
                        2 * 4 * 256 * 4 * 10**6 / counts.H100_HBM_BYTES_PER_S)


def test_an_architecture_without_a_reference_has_no_count():
    cfg = dict(SMALL, architecture="no_such_architecture")
    with pytest.raises(SystemExit, match="no plain reference"):
        counts.forward_flops(cfg, 10, 100)
