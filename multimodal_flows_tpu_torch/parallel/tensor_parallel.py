"""Sharded layouts of a module: FSDP2 over the data axis, and Megatron
column / row tensor parallelism over the model axis written out by hand
(the JAX package's `fsdp_sharding` and `tp_sharding` in
`multimodal_flows_tpu/parallel/mesh.py:91-156`, which annotate the
parameters and leave the collectives to XLA's partitioner).

- `fsdp_sharding(module, mesh)` wraps each residual block, then the root,
  in `fully_shard` (ZeRO-3: parameters, gradients and Adam's moments live
  sharded along dim 0, each block all-gathers its weights around its
  forward and backward and reduce-scatters its gradients).  The JAX
  package leaves leaves under 4096 elements replicated; FSDP2 shards every
  parameter, and the arithmetic is the same.
- `tp_sharding(module, mesh)` swaps layers in place by JAX's name rule:
  `c_attn`, `c_fc`, `fc` column-parallel (output features sharded, input
  through `copy_to_region`), `c_proj`, `proj` row-parallel (input features
  sharded, output through `reduce_from_region`, the bias added once after
  the all-reduce).  Attention is split by heads: rank r holds the q, k and
  v columns of heads [r H/tp, (r+1) H/tp) (JAX's contiguous split of the
  fused qkv kernel cuts across the q / k / v boundary and leaves the
  partitioner to reshard).  The projections to one value per head (the
  co-occurrence and Lund biases, `_TP_HEADS`) are column-parallel over the
  same heads, so K2 gets a contiguous (B, H/tp, T, T) bias.  A column / row
  pair is sharded together or not at all: where a dimension does not
  divide, it stays replicated, as JAX falls back.  The parallel layers
  compute in the dtype of the layer they replace (`models.blocks.Dense`):
  in bf16 the row-parallel partial products are rounded to bf16 and
  all-reduced in bf16, as XLA's partitioner reduces a bf16 dot.  FSDP2
  needs no mixed-precision policy: its parameters stay fp32 and the
  modules cast after the all-gather, as JAX casts at use.

A sharded parameter carries its layout: a DTensor under FSDP, a
`tp_split` attribute under TP.  `full_state_dict` / `load_full_state_dict`
and the optimizer's counterparts read it to gather every tensor to its
full shape or cut a full tensor to this rank's share, so a checkpoint
written in any layout is the single-device file and loads into any
other.  `grad_norm` counts a sharded gradient once and a replicated one
once, as optax's global norm over the unsharded tree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from multimodal_flows_tpu_torch.models.blocks import Dense, dense
from multimodal_flows_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

Tensor = torch.Tensor

#: column-parallel Linear layers (output features sharded, bias with them)
_TP_COL = ("c_attn", "c_fc", "fc")
#: row-parallel Linear layers (input features sharded, bias replicated)
_TP_ROW = ("c_proj", "proj")
#: Linear layers that project to one value per attention head: sharded
#: over the heads with the attention
_TP_HEADS = ("wue_proj", "wue_proj_out")


def _is_linear(layer) -> bool:
    """A plain Linear layer (not EPiC's `WNLinear`, which stays replicated)."""
    return type(layer) in (nn.Linear, Dense)


def _dtype(linear: nn.Linear) -> torch.dtype:
    return getattr(linear, "compute_dtype", torch.float32)


# ------------------------------------------------------------ collectives


class _CopyToRegion(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient backward (a replicated
    input entering sharded computation)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromRegion(torch.autograd.Function):
    """All-reduce forward (the partial sums of a row-parallel product);
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_region(x: Tensor, group) -> Tensor:
    return _CopyToRegion.apply(x, group)


def reduce_from_region(x: Tensor, group) -> Tensor:
    return _ReduceFromRegion.apply(x, group)


# ---------------------------------------------------------------- layers


@dataclasses.dataclass
class TPSplit:
    """How a tensor-parallel parameter is cut: along `dim`, rank r holding
    the entries `index[r]` of the full tensor, over `group`."""
    dim: int
    index: List[Tensor]
    group: object

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)


def _shard_param(t: Tensor, split: TPSplit) -> nn.Parameter:
    p = nn.Parameter(t.detach().index_select(split.dim, split.index[split.rank].to(t.device))
                     .clone())
    p.tp_split = split
    return p


class ColumnParallelLinear(nn.Module):
    """The output features `index[rank]` of a Linear: y = x W[idx]^T +
    b[idx] in the layer's compute dtype, its input through
    `copy_to_region`."""

    def __init__(self, linear: nn.Linear, index: List[Tensor], group):
        super().__init__()
        split = TPSplit(0, index, group)
        self.group, self.compute_dtype = group, _dtype(linear)
        self.in_features, self.out_features = linear.in_features, len(index[split.rank])
        self.weight = _shard_param(linear.weight, split)
        self.bias = None if linear.bias is None else _shard_param(linear.bias, split)

    def forward(self, x: Tensor) -> Tensor:
        return dense(copy_to_region(x, self.group), self.weight, self.bias, self.compute_dtype)


class RowParallelLinear(nn.Module):
    """The input features `index[rank]` of a Linear: the partial product
    x_local W[:, idx]^T (in the layer's compute dtype) all-reduced, then the
    (replicated) bias added once in that dtype."""

    def __init__(self, linear: nn.Linear, index: List[Tensor], group):
        super().__init__()
        split = TPSplit(1, index, group)
        self.group, self.compute_dtype = group, _dtype(linear)
        self.in_features, self.out_features = len(index[split.rank]), linear.out_features
        self.weight = _shard_param(linear.weight, split)
        self.bias = None if linear.bias is None else nn.Parameter(linear.bias.detach().clone())

    def forward(self, x: Tensor) -> Tensor:
        y = reduce_from_region(dense(x, self.weight, None, self.compute_dtype), self.group)
        return y if self.bias is None else y + self.bias.to(self.compute_dtype)


def _contiguous(n: int, tp: int) -> List[Tensor]:
    per = n // tp
    return [torch.arange(r * per, (r + 1) * per) for r in range(tp)]


def _head_columns(n_head: int, head_size: int, parts: int, tp: int) -> List[Tensor]:
    """Per rank, the columns of its heads in each of `parts` stacked
    (H * hs)-wide blocks (q, k, v of a fused projection)."""
    C = n_head * head_size
    cols = _contiguous(C, tp)  # heads are contiguous hs-wide column runs
    return [torch.cat([p * C + c for p in range(parts)]) for c in cols]


def _sum_over_heads(param: nn.Parameter, group) -> None:
    """Sum a replicated parameter's gradient over the model group (a
    gradient hook), for a parameter that acts on each head alone (the
    qk-LayerNorm shared by the heads, the gate of a per-head bias): each
    rank computes its heads' share of the gradient."""
    def hook(grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=group)
        return grad

    if param.requires_grad:
        param.register_hook(hook)


def tp_sharding(module: nn.Module, mesh) -> nn.Module:
    """Megatron tensor parallelism over the mesh's `model` axis, in place
    (layers swapped by name, see the module docstring).  Load weights (e.g.
    `convert.load_flax_params`) into the unsharded module first; this
    splits them.  Returns `module`."""
    from multimodal_flows_tpu_torch.models.attention import CrossAttention, SelfAttention

    group = mesh.get_group(MODEL_AXIS)
    tp = dist.get_world_size(group)
    if tp == 1:
        return module
    heads_sharded = False
    for parent in list(module.modules()):
        if isinstance(parent, (SelfAttention, CrossAttention)):
            H, hs = parent.n_head, parent.head_size
            if H % tp:
                continue
            parts = 3 if isinstance(parent, SelfAttention) else 2
            parent.c_attn = ColumnParallelLinear(parent.c_attn, _head_columns(H, hs, parts, tp),
                                                 group)
            parent.c_proj = RowParallelLinear(parent.c_proj, _contiguous(H * hs, tp), group)
            parent.n_head, parent.tp_group = H // tp, group
            for ln in (parent.q_layernorm, parent.k_layernorm):
                for p in () if ln is None else ln.parameters():
                    _sum_over_heads(p, group)
            heads_sharded = True
            continue
        children = dict(parent.named_children())
        col = next((n for n in _TP_COL if _is_linear(children.get(n))), None)
        row = next((n for n in _TP_ROW if _is_linear(children.get(n))), None)
        if col and row:
            width = children[col].out_features
            if width == children[row].in_features and width % tp == 0:
                index = _contiguous(width, tp)
                setattr(parent, col, ColumnParallelLinear(children[col], index, group))
                setattr(parent, row, RowParallelLinear(children[row], index, group))
    if heads_sharded:
        for parent in list(module.modules()):
            for name in _TP_HEADS:
                layer = getattr(parent, name, None)
                if _is_linear(layer) and layer.out_features % tp == 0:
                    setattr(parent, name, ColumnParallelLinear(
                        layer, _contiguous(layer.out_features, tp), group))
            gate = getattr(parent, "lambda_u", None)  # scales the per-head bias
            if isinstance(gate, nn.Parameter):
                _sum_over_heads(gate, group)
    return module


# ------------------------------------------------------------------ FSDP

def _residual_blocks():
    """The residual block classes that `fsdp_sharding` wraps one by one."""
    from multimodal_flows_tpu_torch.models.attention import SelfAttnBlock
    from multimodal_flows_tpu_torch.models.epic import EPiCLayer

    return (SelfAttnBlock, EPiCLayer)


#: the module methods that the systems call instead of `forward`
_FORWARD_METHODS = ("training_loss", "packed_training_loss", "decode")


def fsdp_sharding(module: nn.Module, mesh) -> nn.Module:
    """FSDP2 over the mesh's data axis, in place: each residual block, then
    the root, in `fully_shard`; the root's loss methods are registered as
    forward methods so that they unshard the parameters too.  Returns
    `module`."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    data_mesh = mesh[DATA_AXIS] if mesh.ndim > 1 else mesh
    blocks = _residual_blocks()
    for m in list(module.modules()):
        if m is not module and isinstance(m, blocks):
            fully_shard(m, mesh=data_mesh)
    fully_shard(module, mesh=data_mesh)
    for name in _FORWARD_METHODS:
        if hasattr(module, name):
            register_fsdp_forward_method(module, name)
    return module


def is_sharded(module: nn.Module) -> bool:
    """Whether any parameter of `module` is sharded (FSDP or TP)."""
    return any(_is_dtensor(p) or hasattr(p, "tp_split") for p in module.parameters())


# ------------------------------------------------------ full <-> local


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _full(t: Tensor, param: Optional[Tensor]) -> Tensor:
    """The full tensor of `t`, a parameter's value or a tensor of its
    shape (an Adam moment): gathered over the mesh when sharded.  A
    collective: every rank of the group calls it."""
    if _is_dtensor(t):
        return t.full_tensor()
    split = getattr(param, "tp_split", None)
    if split is None or t.ndim == 0:
        return t
    parts = [torch.empty_like(t) for _ in split.index]
    dist.all_gather(parts, t.contiguous(), group=split.group)
    shape = list(t.shape)
    shape[split.dim] = sum(len(i) for i in split.index)
    out = t.new_empty(shape)
    for idx, part in zip(split.index, parts):
        out.index_copy_(split.dim, idx.to(t.device), part)
    return out


def _local(full: Tensor, param: Tensor) -> Tensor:
    """This rank's share of `full` in the layout of `param`."""
    full = full.to(device=param.device, dtype=param.dtype)
    if _is_dtensor(param):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(full, param.device_mesh, param.placements, src_data_rank=None)
    split = getattr(param, "tp_split", None)
    if split is None:
        return full
    return full.index_select(split.dim, split.index[split.rank].to(full.device))


def full_state_dict(module: nn.Module) -> Dict[str, Tensor]:
    """`module.state_dict()` with every sharded entry gathered to its full
    shape (a collective under FSDP and TP); the plain state dict itself
    for an unsharded module."""
    params = dict(module.named_parameters())
    return {k: _full(v, params.get(k)) for k, v in module.state_dict().items()}


@torch.no_grad()
def load_full_state_dict(module: nn.Module, state: Dict[str, Tensor]) -> None:
    """Load a full (single-device) state dict into `module` in any layout,
    strictly: every parameter takes this rank's share."""
    params = dict(module.named_parameters())
    if not is_sharded(module):
        module.load_state_dict(state)
        return
    own = module.state_dict()
    missing, unexpected = set(own) - set(state), set(state) - set(own)
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {sorted(missing)}, "
                       f"unexpected {sorted(unexpected)}")
    for k, v in state.items():
        target = params.get(k)
        if target is None:  # a buffer
            module.get_buffer(k).copy_(v)
        else:
            target.copy_(_local(v, target))


def full_optimizer_state_dict(module: nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """`optimizer.state_dict()` (parameters by their index in
    `module.parameters()`) with every per-parameter tensor gathered to its
    full shape: the single-device format."""
    sd = optimizer.state_dict()
    params = list(module.parameters())
    state = {i: {k: _full(v, params[i]) if torch.is_tensor(v) and v.ndim else v
                 for k, v in s.items()}
             for i, s in sd["state"].items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def load_full_optimizer_state_dict(module: nn.Module, optimizer: torch.optim.Optimizer,
                                   state: dict) -> None:
    """Load a single-device optimizer state dict into `optimizer` over
    `module` in any layout."""
    params = list(module.parameters())
    local = {i: {k: _local(v, params[i]) if torch.is_tensor(v) and v.ndim else v
                 for k, v in s.items()}
             for i, s in state["state"].items()}
    optimizer.load_state_dict({"state": local, "param_groups": state["param_groups"]})


# ------------------------------------------------------------- gradients


def grad_norm(params: Sequence[Tensor], grads: Sequence[Tensor]) -> Tensor:
    """The global L2 norm of the gradients of the unsharded model: the
    squared norms of FSDP shards summed over the data axis and of TP shards
    over the model axis, a replicated gradient counted once.  Every rank
    gets the same value."""
    replicated, by_group = [], {}
    for p, g in zip(params, grads):
        if _is_dtensor(g):
            by_group.setdefault(g.device_mesh.get_group(), []).append(g.to_local())
        elif hasattr(p, "tp_split"):
            by_group.setdefault(p.tp_split.group, []).append(g)
        else:
            replicated.append(g)
    if not by_group:
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(replicated)))
    total = torch.zeros((), dtype=torch.float32, device=grads[0].device)
    if replicated:
        total = torch.stack(torch._foreach_norm(replicated)).square().sum()
    for group, gs in by_group.items():
        sq = torch.stack(torch._foreach_norm(gs)).square().sum()
        dist.all_reduce(sq, group=group)
        total = total + sq
    return total.sqrt()


def local_tensors(tensors: Sequence[Tensor]) -> List[Tensor]:
    """Each tensor, or its local shard when it is a DTensor (in-place
    updates of the shard update the DTensor)."""
    return [t.to_local() if _is_dtensor(t) else t for t in tensors]
