"""The fp32 core on the CPU: its host plan, its arithmetic and its key splits.

The fp32 forms of K1 and K2 (`csrc/set_attention_core.cuh:
attention_kernel_tf32`) run on the card only (`chip_smoke.py` holds them
against their plain versions there).  Here:

- `ops/set_attention.py:fp32_plan` at every shape `chip_smoke.py` runs the
  fp32 kernels at (`TIMED`, `TIMED_WIDE`, `TP_SHAPES`, `WIDE_CASES`, GPT's
  forward and decode): one slice up to a head size of 128, slices of 128
  columns past it; q/k/v by TMA where their rows and heads are 16-byte
  multiples apart; the key tiles split across blocks where a call's blocks
  fill at most half of the blocks the H100's 132 SMs hold at once; a ring
  of 1-4 stages; the shared
  memory the core counts, under the 227 KB a block has (at the packed rows
  as many blocks an SM as the kernel's registers allow), and the raise
  past it.
- The kernel's arithmetic in numpy, exactly as it splits: the raw fp32
  value as the hi part (the tensor core reads a .tf32 operand's top 19
  bits), lo = tf32(x - trunc(x)) rounded to nearest, the products lo*hi,
  hi*lo, hi*hi of each 8-wide step summed into fp32, for S = Q K^T and for
  P V with P split the same way.  It sits within the kernels' atol 2e-5 /
  rtol 1e-5 of fp64 attention at head sizes 32-512 and up to 2048 keys,
  where plain TF32 (one product of rounded operands) does not.
- The split rows: the plain partials of contiguous shares of the key
  tiles, merged as `merge_splits` merges them, equal the whole softmax.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from multimodal_flows_tpu_torch.ops import set_attention as k2
from multimodal_flows_tpu_torch.ops.attention import attention_reference

torch.set_num_threads(2)

# what the kernels are held to on the card
ATOL, RTOL = 2e-5, 1e-5

SM_BYTES = 233_472  # an H100 SM's shared memory; 1 KB of it reserved a block


def _cases():
    """(B, Tq, Tk, C, H) of every fp32 call chip_smoke.py makes."""
    cases = [(B, T, T, C, H) for B, T, C, H in chip_smoke.TIMED + chip_smoke.TP_SHAPES]
    B, T, C, H = chip_smoke.TIMED_WIDE
    cases.append((B, T, T, C, H))
    B, T, C, H = chip_smoke.GPT_SHAPE
    cases += [(B, T, T, C, H), (B, 1, T, C, H)]
    cases += [case[:5] for case in chip_smoke.WIDE_CASES]
    return sorted(set(cases))


def _views(B, Tq, Tk, C, H):
    """Token-major q (B, Tq, C), k and v (B, Tk, C) as (B, H, T, hs) views,
    as the wrappers hand them to the plan."""
    q = torch.empty(B, Tq, C)
    kv = torch.empty(B, Tk, C)
    return [t.unflatten(-1, (H, C // H)).transpose(1, 2) for t in (q, kv, kv)]


def _smem(bucket, hs, Tk, stages):
    """The core's count, re-derived: chunks of 64 rows x w fp32 for Q's
    whole head, the ring and the work (K's lo part and V^T's two parts,
    K's lo part in V^T's hi part's place past head size 64); the key mask
    and ids; the tile intervals; 1 + 2 stages mbarriers; the alignment's
    1024 bytes."""
    w = min(bucket, 64)
    chunks = -(-hs // w) + stages + (3 if bucket <= 64 else 2)
    ints = max(32, 8 + 3 * -(-Tk // 64))
    at_bars = -(-(chunks * 64 * w * 4 + 8 * Tk + 4 * ints) // 8) * 8
    return at_bars + 8 * (1 + 2 * stages) + 1024


def _blocks_an_sm(bucket, smem):
    """Resident blocks of the kernel: its shared memory against the SM's,
    its registers (bounded for 4 blocks at head size <= 32, else 2)."""
    return min(4 if bucket == 32 else 2, SM_BYTES // (smem + 1024))


@pytest.mark.parametrize("B, Tq, Tk, C, H", _cases())
def test_plan_at_the_smoke_shapes(B, Tq, Tk, C, H):
    hs = C // H
    plan = k2.fp32_plan(*_views(B, Tq, Tk, C, H))
    bucket = 32 if hs <= 32 else 64 if hs <= 64 else 128
    w = min(bucket, 64)
    slices = -(-hs // 128)
    n_tiles = -(-Tk // 64)
    assert (plan.head_bucket, plan.chunk, plan.slices, plan.key_tiles) == (
        bucket, w, slices, n_tiles)
    # a head's rows (C floats apart) and its first column (hs floats in) on 16 bytes
    assert plan.qkv_tma == (C % 4 == 0 and hs % 4 == 0)
    # up to head size 64 a tile's K and V chunks are held together
    assert (2 if bucket <= 64 else 1) <= plan.stages <= k2.MAX_FP32_STAGES
    assert plan.smem_bytes == _smem(bucket, hs, Tk, plan.stages) <= k2.MAX_SHARED_BYTES
    # no other number of stages keeps more blocks an SM, or as many with more stages
    occupancy = _blocks_an_sm(bucket, plan.smem_bytes)
    for stages in range(2 if bucket <= 64 else 1, k2.MAX_FP32_STAGES + 1):
        other = _blocks_an_sm(bucket, _smem(bucket, hs, Tk, stages))
        assert other < occupancy or (other == occupancy and stages <= plan.stages) or (
            _smem(bucket, hs, Tk, stages) > k2.MAX_SHARED_BYTES
            or stages > n_tiles * (-(-hs // w) + bucket // w))
    # split only where the blocks fill at most half of the resident ones
    blocks = B * -(-Tq // 64) * H * slices
    resident = 132 * occupancy
    chunks = n_tiles * (-(-hs // w) + bucket // w)
    splits = max(1, min(resident // blocks, n_tiles, 8, chunks // 8)) if 2 * blocks <= resident else 1
    assert plan.splits == splits
    assert plan.scratch_floats(B, H, Tq, hs) == (0 if splits == 1 else splits * B * H * Tq * (hs + 2))


@pytest.mark.parametrize("B, T, C, H", chip_smoke.TIMED + chip_smoke.TP_SHAPES)
def test_packed_rows_keep_blocks_an_sm(B, T, C, H):
    """The main path's shapes: no split (B x 2 query tiles x H blocks fill
    the card), q/k/v by TMA, and a ring of at least 2 stages that leaves
    room for the blocks an SM the kernel's registers allow: 4 at head size
    <= 32, 2 past it."""
    plan = k2.fp32_plan(*_views(B, T, T, C, H))
    assert plan.splits == 1 and plan.qkv_tma and plan.slices == 1
    assert plan.stages >= 2
    assert (4 if C // H <= 32 else 2) * (plan.smem_bytes + 1024) <= SM_BYTES


@pytest.mark.parametrize("B, Tq, Tk, C, H, splits", [
    (8, 150, 150, 256, 4, 1),    # the wide jets: 96 blocks of 6 chunks, 264 resident
    (8, 300, 300, 256, 1, 1),    # head size 256: 80 blocks in 2 slices, 132 resident
    (4, 300, 300, 512, 1, 1),    # head size 512: 80 blocks in 4 slices
    (16, 1, 302, 512, 2, 2),     # the decode at head size 256: 64 blocks
    (2, 1024, 1024, 256, 4, 2),  # 128 blocks of 32 chunks, 264 resident
    (1, 2048, 2048, 64, 1, 4),   # 32 blocks, 132 resident
    (1, 2048, 2048, 32, 1, 8),   # 32 blocks, 396 resident: at most MAX_SPLITS
    (2, 4, 30, 256, 4, 1),       # one key tile: nothing to split
    (128, 128, 128, 256, 4, 1),  # 1,024 blocks
])
def test_small_grids_split_their_keys(B, Tq, Tk, C, H, splits):
    assert k2.fp32_plan(*_views(B, Tq, Tk, C, H)).splits == splits


@pytest.mark.parametrize("hs, Tk", [(128, 20_480), (256, 16_384), (1024, 64), (1024, 4096)])
def test_the_shared_memory_bound_is_named(hs, Tk):
    """Past a block's 227 KB even with one stage (the key mask and ids, 8
    Tk bytes, and the query rows of the whole head, 256 hs bytes) the plan
    raises, naming it."""
    q, kv = torch.empty(1, 1, 64, hs), torch.empty(1, 1, Tk, hs)
    with pytest.raises(ValueError, match="the fp32 kernel needs .* shared memory"):
        k2.fp32_plan(q, kv, kv)


def test_strides_that_miss_tma_rules_stage_qkv():
    """Head size 9 (rows 36 bytes apart), a transposed view and a base off
    16 bytes are staged by the block's threads."""
    q, kv = torch.empty(2, 3, 20, 9), torch.empty(2, 3, 150, 9)
    assert not k2.fp32_plan(q, kv, kv).qkv_tma
    q, kv = torch.empty(2, 4, 20, 64), torch.empty(2, 4, 150, 64)
    assert k2.fp32_plan(q, kv, kv).qkv_tma
    assert not k2.fp32_plan(q.transpose(-1, -2)[..., :20, :], kv, kv).qkv_tma
    off = torch.empty(2 * 4 * 20 * 64 + 1)[1:].view(2, 4, 20, 64)
    assert not k2.fp32_plan(off, kv, kv).qkv_tma


# ------------------------------------------------------------ arithmetic

def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _trunc(x):
    """What the tensor core reads of a raw .tf32 operand."""
    return (_bits(x) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32(x):
    """cvt.rna.tf32.f32: to 10 mantissa bits, to nearest, ties away."""
    return ((_bits(x).astype(np.uint64) + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _split(x):
    x = np.asarray(x, np.float32)
    return _trunc(x), _tf32(x - _trunc(x))


def _mma(a, b, parts):
    """sum_k a[i, k] b[j, k] as the kernel's products give it: for each
    8-wide step of k, each product pair of `parts` (a sum of 8 exact
    products) added to an fp32 accumulator in turn."""
    n = a.shape[1]
    pad = -n % 8
    a = np.pad(a, ((0, 0), (0, pad)))
    b = np.pad(b, ((0, 0), (0, pad)))
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k0 in range(0, n + pad, 8):
        for fa, fb in parts:
            step = fa(a[:, k0:k0 + 8]).astype(np.float64) @ fb(b[:, k0:k0 + 8]).astype(np.float64).T
            acc = (acc.astype(np.float64) + step).astype(np.float32)
    return acc


def _hi(x):
    return _split(x)[0]


def _lo(x):
    return _split(x)[1]


THREE = [(_lo, _hi), (_hi, _lo), (_hi, _hi)]  # the kernel's order: small products first
PLAIN_TF32 = [(_tf32, _tf32)]


def _attention(q, k, v, parts):
    """One head: the scores, the fp32 softmax (max-subtracted, its sum and
    the division in fp32) and P V with `parts`."""
    s = _mma(q, k, parts) * np.float32(1 / np.sqrt(q.shape[1]))
    p = np.exp((s - s.max(axis=1, keepdims=True)).astype(np.float64)).astype(np.float32)
    return _mma(p, v.T, parts) / p.sum(axis=1, keepdims=True, dtype=np.float32)


@pytest.mark.parametrize("hs, Tk", [(32, 64), (64, 150), (64, 2048), (128, 300), (256, 512),
                                    (512, 300), (512, 2048)])
def test_three_tf32_products_hold_the_fp32_tolerance(hs, Tk):
    rng = np.random.default_rng(hs + Tk)
    q = rng.standard_normal((8, hs)).astype(np.float32)
    k, v = (rng.standard_normal((Tk, hs)).astype(np.float32) for _ in range(2))
    s = q.astype(np.float64) @ k.astype(np.float64).T / np.sqrt(hs)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    ref = p @ v.astype(np.float64) / p.sum(axis=1, keepdims=True)
    out = _attention(q, k, v, THREE)
    assert np.all(np.abs(out - ref) <= ATOL + RTOL * np.abs(ref)), np.abs(out - ref).max()
    # the test has teeth: one TF32 product misses the same tolerance
    plain = _attention(q, k, v, PLAIN_TF32)
    assert not np.all(np.abs(plain - ref) <= ATOL + RTOL * np.abs(ref))


def test_split_is_exact_where_lo_fits():
    """trunc(x) + lo == x wherever x - trunc(x) has at most 11 significant
    bits (tf32's), and within 2^-22 |x| everywhere."""
    x = np.random.default_rng(0).standard_normal(100_000).astype(np.float32)
    hi, lo = _split(x)
    err = np.abs(hi.astype(np.float64) + lo - x)
    assert np.all(err <= 2.0 ** -22 * np.abs(x))
    y = _trunc(x) + np.float32(2.0 ** -14) * np.sign(x)  # a lo of one bit
    assert np.all(np.sum(_split(y), axis=0) == y)


# ------------------------------------------------------------ key splits

@pytest.mark.parametrize("Tk, splits", [(150, 1), (150, 2), (150, 3), (300, 4), (2048, 8)])
@pytest.mark.parametrize("masked", [False, True])
def test_merged_partials_are_the_whole_softmax(Tk, splits, masked):
    gen = torch.Generator().manual_seed(Tk + splits)
    B, H, Tq, D = 2, 3, 20, 16
    q = torch.randn(B, H, Tq, D, generator=gen)
    k, v = (torch.randn(B, H, Tk, D, generator=gen) for _ in range(2))
    km = bias = None
    if masked:  # trailing pads, and a pairwise bias
        n = torch.tensor([Tk // 3, Tk])
        km = torch.where(torch.arange(Tk)[None, :] < n[:, None], 0.0, -1e9)
        bias = torch.randn(B, H, Tq, Tk, generator=gen)
    o, m, l = k2.split_partials(q, k, v, splits, km, bias)
    assert o.shape == (splits, B, H, Tq, D) and m.shape == l.shape == (splits, B, H, Tq)
    torch.testing.assert_close(k2.merge_partials(o, m, l), attention_reference(q, k, v, km, bias),
                               atol=1e-5, rtol=1e-5)


def test_a_share_without_keys_weighs_nothing():
    """More shares than key tiles: the empty shares (m = -inf, l = 0) drop
    out of the merge."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 5, 8, generator=gen) for _ in range(3))
    o, m, l = k2.split_partials(q, k, v, 3)
    assert torch.isinf(m[:2]).all() and (l[:2] == 0).all()
    torch.testing.assert_close(k2.merge_partials(o, m, l), attention_reference(q, k, v))
