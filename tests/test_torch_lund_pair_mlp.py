"""KinFormer's Lund pair MLP (`ops/lund_pair_mlp.py`) on the CPU: the plain
version against the chunked pair MLP `KinFormer._lund_bias` ran before the
fused kernel (copied below), bit for bit; the autograd Function of the
kernel route, its forward replaced by the plain version, against the
plain path's gradients; the route counters; and a numpy emulation of the
kernel's 3xTF32 product (`csrc/lund_pair_mlp.cu`) at the Lund cell's
width, held against fp64.  The kernel itself runs only on the card
(`chip_smoke.py:lund_pair_mlp_phase`)."""

import ast
import inspect
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodal_flows_tpu_torch.config import Config
from multimodal_flows_tpu_torch.data.packing import build_packed_rows, pack_jets
from multimodal_flows_tpu_torch.data.state import MultiModal
from multimodal_flows_tpu_torch.models import particle_transformers as pt
from multimodal_flows_tpu_torch.models.blocks import dense, gelu
from multimodal_flows_tpu_torch.ops import lund_pair_mlp as lpm
from multimodal_flows_tpu_torch.utils import profiling

torch.set_num_threads(2)

METADATA = {"mean": [21.0, 1e-4, 2e-5], "std": [20.0, 0.15, 0.15]}
CFG = dict(model="KinFormer", use_pairwise=True, n_embd=32, n_inner=48, n_layer=1, n_head=2,
           dim_continuous=3, vocab_size=9, max_num_particles=150, qk_layernorm=True,
           bias=True, metadata=METADATA)


def _lund_bias_before(self, state):
    """`KinFormer._lund_bias` as it was before the pair MLP moved to
    `ops/lund_pair_mlp.py` (its counters left out)."""
    cfg = self.config
    meta = cfg.metadata or {}
    U = pt.lund_observables(state, meta.get("mean", [0.0] * cfg.dim_continuous),
                            meta.get("std", [1.0] * cfg.dim_continuous))

    def stage1(u):
        return self.wue_ln(gelu(self.wue_fc(u)))

    B, D = U.shape[0], U.shape[1]
    c = cfg.pair_chunk if cfg.pair_chunk and cfg.pair_chunk > 0 else D
    U = U.to(self.dtype)
    Ut = U.transpose(1, 2)
    outs = [self.wue_proj_out(gelu(self.wue_proj_fc(
                0.5 * (stage1(U[:, a:a + c]) + stage1(Ut[:, a:a + c])))))
            for a in range(0, D, c)]
    u = torch.cat(outs, dim=1)                                     # (B, D, D, H)
    return self.lambda_u * u.permute(0, 3, 1, 2).to(torch.float32).contiguous()


def _module(pair_chunk=16, compute_dtype="float32", bias=True, seed=0):
    torch.manual_seed(seed)
    m = pt.KinFormer(Config(**dict(CFG, pair_chunk=pair_chunk, compute_dtype=compute_dtype,
                                   bias=bias)))
    with torch.no_grad():  # weights of order one, as the benchmark draws them
        for name, p in m.named_parameters():
            p.copy_(torch.randn(p.shape) * (p.shape[-1] ** -0.5 if p.dim() > 1 else 0.1))
        m.lambda_u.fill_(0.8)
        m.wue_ln.weight.add_(1.0)
    return m


def _packed_state(W=24, seed=3):
    """Packed rows of jets of 2-20 particles, pad slots in every row."""
    rng = np.random.default_rng(seed)
    mult = rng.integers(2, 21, size=14)
    masks = (np.arange(20)[None, :] < mult[:, None]).astype(np.int64)[..., None]
    row_of, offset_of, n_rows = pack_jets(mult, W)
    row_mask, _ = build_packed_rows(masks, row_of, offset_of, n_rows, W)
    mask = torch.as_tensor(row_mask, dtype=torch.int32)
    x = torch.randn((n_rows, W, 3), generator=torch.Generator().manual_seed(seed)) * mask
    return MultiModal(continuous=x, mask=mask)


def _wide_state(B=2, D=150, seed=4):
    """Rows of 150 slots (the bucketed width): a full one, then rows padded
    past 97 slots."""
    mask = torch.zeros((B, D, 1), dtype=torch.int32)
    mask[0], mask[1:, :97] = 1, 1
    x = torch.randn((B, D, 3), generator=torch.Generator().manual_seed(seed)) * mask
    return MultiModal(continuous=x, mask=mask)


STATES = {"packed": _packed_state, "wide": _wide_state}


@pytest.mark.parametrize("rows", sorted(STATES))
@pytest.mark.parametrize("chunk", [0, 5, 16])
def test_plain_version_equals_the_chunked_bias_before_it(rows, chunk):
    m = _module(pair_chunk=chunk)
    state = STATES[rows]()
    with torch.no_grad():
        got = m._lund_bias(state)
        want = _lund_bias_before(m, state)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)


def test_bf16_keeps_the_plain_chunked_path_bit_for_bit():
    m = _module(pair_chunk=5, compute_dtype="bfloat16")
    state = _packed_state()
    with torch.no_grad():
        before = profiling.peek_counters()["lund_mlp.plain"]
        got = m._lund_bias(state)
        assert profiling.peek_counters()["lund_mlp.plain"] == before + 1
        assert torch.equal(got, _lund_bias_before(m, state))


def _mlp(m):
    """The pair MLP of KinFormer `m`, its own parameters."""
    fc, ln, proj, out = m.wue_fc, m.wue_ln, m.wue_proj_fc, m.wue_proj_out
    return lpm.PairMLP(fc.weight, fc.bias, ln.weight, ln.bias, proj.weight, proj.bias,
                       out.weight, out.bias, m.lambda_u, ln.eps)


def _function(u, mlp, chunk=0):
    """The kernel route's autograd Function, as `lund_pair_mlp` calls it on
    CUDA tensors."""
    return lpm._LundPairMLP.apply(u, mlp, chunk, *mlp.tensors())


def _grads(route, m, U, upstream, chunk):
    """The gradients of sum(route(U) * upstream) for U and every parameter
    of KinFormer (None where it gets none)."""
    m.zero_grad(set_to_none=True)
    u = U.detach().clone().requires_grad_(True)
    (route(u, _mlp(m), chunk) * upstream).sum().backward()
    return [u.grad] + [None if p.grad is None else p.grad.clone() for p in m.parameters()]


@pytest.mark.parametrize("bias", [True, False])
def test_function_gradients_equal_the_plain_paths(bias, monkeypatch):
    """The kernel route's autograd Function, its forward the plain version
    (the kernel needs the card), gives U and every parameter the plain
    path's gradient: its backward recomputes through the plain version."""
    m = _module(pair_chunk=5, bias=bias)
    U = pt.lund_observables(_packed_state(), METADATA["mean"], METADATA["std"])
    launched = []

    def plain_launch(u, mlp):
        launched.append(1)
        return lpm.lund_pair_mlp_reference(u, mlp)

    monkeypatch.setattr(lpm, "_launch", plain_launch)
    upstream = torch.randn((U.shape[0], 2, U.shape[1], U.shape[1]),
                           generator=torch.Generator().manual_seed(9))
    got = _grads(_function, m, U, upstream, 5)
    want = _grads(lpm.lund_pair_mlp_reference, m, U, upstream, 5)
    assert launched == [1]
    assert sum(g is not None for g in got) == 1 + len([t for t in _mlp(m).tensors()
                                                      if t is not None])
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


def test_function_gives_no_gradient_where_none_is_needed(monkeypatch):
    m = _module(pair_chunk=0)
    U = pt.lund_observables(_packed_state(), METADATA["mean"], METADATA["std"])
    monkeypatch.setattr(lpm, "_launch", lambda u, mlp: lpm.lund_pair_mlp_reference(u, mlp))
    m.wue_fc.weight.requires_grad_(False)
    _function(U, _mlp(m)).sum().backward()
    assert U.grad is None and m.wue_fc.weight.grad is None
    assert m.wue_proj_fc.weight.grad is not None and m.lambda_u.grad is not None
    assert m.ln1.weight.grad is None


def test_kernel_takes_only_the_models_own_fp32_layers_on_cuda(monkeypatch):
    """`_lund_bias` hands the dispatch its own fp32 parameters, and keeps
    the plain path over its layers in bf16 and under a tensor-parallel
    layout (bit for bit the chunked bias before the kernel); the dispatch
    sends every CUDA tensor to the kernel's Function and CPU tensors to the
    plain version."""
    calls = []

    def dispatch(U, mlp, chunk=0):
        calls.append((mlp, chunk))
        return lpm.lund_pair_mlp_reference(U, mlp, chunk)

    monkeypatch.setattr(pt, "lund_pair_mlp", dispatch)
    state = _packed_state()
    with torch.no_grad():
        m = _module(pair_chunk=5)
        m._lund_bias(state)
        assert len(calls) == 1 and calls[0][1] == 5
        assert all(a is b for a, b in zip(calls[0][0].tensors(), _mlp(m).tensors()))
        assert calls[0][0].eps == 1e-6
        for layout in ("bf16", "tensor-parallel"):
            m = _module(pair_chunk=5, compute_dtype="bfloat16" if layout == "bf16" else "float32")
            if layout == "tensor-parallel":
                m.wue_proj_out.weight.tp_split = object()  # what `tp_sharding` marks
            before = profiling.peek_counters()["lund_mlp.plain"]
            got = m._lund_bias(state)
            assert profiling.peek_counters()["lund_mlp.plain"] == before + 1, layout
            assert len(calls) == 1, layout
            assert torch.equal(got, _lund_bias_before(m, state)), layout

    applied = []
    monkeypatch.setattr(lpm._LundPairMLP, "apply", lambda *args: applied.append(args) or "kernel")
    on_card = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32)
    mlp = _mlp(_module())
    assert lpm.lund_pair_mlp(on_card, mlp, 16) == "kernel"
    assert applied[0][:3] == (on_card, mlp, 16) and applied[0][3:] == mlp.tensors()
    assert lpm.lund_pair_mlp(torch.zeros((1, 4, 4, 2)), mlp).shape == (1, 2, 4, 4)
    assert len(applied) == 1


def test_cpu_takes_the_plain_route_and_counts_it():
    m = _module()
    state = _packed_state()
    B, D = state.continuous.shape[:2]
    profiling.take_counters()
    profiling.record_spans(True)
    try:
        with torch.no_grad():
            m._lund_bias(state)
            m._lund_bias(state)
    finally:
        profiling.record_spans(False)
        profiling.take_spans()
    c = profiling.take_counters()
    assert c["lund_mlp.plain"] == 2 and c["lund_mlp.kernel"] == 0
    assert c["lund.pairs"] == 2 * B * D * D and c["lund.forwards"] == 2


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        lpm.lund_pair_mlp_kernel(torch.zeros((1, 4, 4, 2)), _mlp(_module()))


def test_kernel_layer_imports_nothing_above_ops():
    """The wrapper takes weight tensors: it knows no model layer (it counts
    through `utils/profiling.py`, which is below it)."""
    tree = ast.parse(inspect.getsource(lpm))
    imported = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    imported += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    ours = [name for name in imported if name.startswith("multimodal_flows_tpu_torch")]
    assert ours and all(name.startswith("multimodal_flows_tpu_torch.ops.")
                        or name == "multimodal_flows_tpu_torch.utils.profiling" for name in ours)


# ------------------------------------------------- the kernel's 3xTF32 product

def _trunc_tf32(x: np.ndarray) -> np.ndarray:
    """What the tensor core reads of a raw fp32 operand: sign, exponent and
    the top 10 mantissa bits (the low 13 masked off)."""
    return (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _round_tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: to the nearest TF32, ties away from zero."""
    b = x.view(np.uint32).astype(np.uint64)
    return ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _wgmma_products(terms, rows: int, cols: int, depth: int) -> np.ndarray:
    """fp32 accumulators of a chain of k8 wgmma steps: for each 8 inputs,
    each (A, B) term's 8 products (exact in fp32 for TF32 operands) summed
    and added to the accumulator with one fp32 rounding."""
    acc = np.zeros((rows, cols), np.float32)
    for k0 in range(0, depth, 8):
        for a, b in terms:
            part = a[:, k0:k0 + 8].astype(np.float64) @ b[:, k0:k0 + 8].astype(np.float64).T
            acc = (acc + part).astype(np.float32)
    return acc


def test_3xtf32_split_of_the_pair_product_holds_fp32_accuracy():
    """x W_fc^T at the Lund cell's width (C = 256) as the kernel computes it:
    hi = the raw fp32 values (the tensor core truncates them), lo =
    tf32(v - trunc(v)) (`tf32_lo`), per 8 inputs lo*hi + hi*lo + hi*hi.
    Within 2e-6 of fp64, relative to the product's largest entry; one TF32
    term (both operands rounded) is above 1e-4."""
    C = 256
    gen = torch.Generator().manual_seed(11)
    fc_w = torch.randn((C, 2), generator=gen) * 0.5 ** 0.5
    fc_b = torch.randn(C, generator=gen) * 0.1
    ln_w, ln_b = 1 + torch.randn(C, generator=gen) * 0.1, torch.randn(C, generator=gen) * 0.1
    U = pt.lund_observables(_wide_state(B=1), METADATA["mean"], METADATA["std"])

    def stage1(u):
        return F.layer_norm(gelu(dense(u, fc_w, fc_b, torch.float32)), (C,), ln_w, ln_b, 1e-6)

    x = (0.5 * (stage1(U) + stage1(U.transpose(1, 2)))).reshape(-1, C)[:2048].numpy()
    w = (torch.randn((C, C), generator=torch.Generator().manual_seed(12)) * C ** -0.5).numpy()
    x, w = x.astype(np.float32), w.astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64).T
    scale = np.abs(exact).max()

    def lo(v):
        return _round_tf32((v - _trunc_tf32(v)).astype(np.float32))

    split = _wgmma_products([(lo(x), _trunc_tf32(w)), (_trunc_tf32(x), lo(w)),
                             (_trunc_tf32(x), _trunc_tf32(w))], len(x), C, C)
    one = _wgmma_products([(_round_tf32(x), _round_tf32(w))], len(x), C, C)
    assert np.abs(split - exact).max() / scale < 2e-6
    assert np.abs(one - exact).max() / scale > 1e-4
