"""Flax -> PyTorch parameter conversion.

`params_from_flax(tree)` takes a flax parameter tree as nested mappings
of numpy arrays and returns a state dict whose names mirror the flax
names.  Given the whole MMF tree (`params['params']`: `encoder` +
`multitask`) it fits `MMFModel`; given the encoder subtree it fits the
encoder (`MMFModel.encoder`, or a CFM/MJB system's module); given a
`FlavorSeqGPT` tree it fits the GPT system's module:

- a Dense `kernel` (in, out) becomes the Linear `weight` (out, in);
- `bias` carries over unchanged;
- an Embed `embedding` becomes the Embedding `weight`;
- a LayerNorm's `LayerNorm_0/{scale, bias}` (the project's wrapper) and a
  bare flax `nn.LayerNorm`'s `{scale, bias}` (KinFormer's `wue_ln`)
  become `{weight, bias}`;
- the 0-d `lambda_u` gate carries over as a 0-d parameter, and the (2,)
  `loss_weights` of the weighted multitask loss as they are;
- a flax `nn.WeightNorm(nn.Dense)` named `fc` (EPiC) keeps its parts in
  two places of the parent's tree: the raw kernel and the bias under the
  wrapped layer's automatic name, `Dense_k/{kernel, bias}`, and the scale
  under the wrapper, `fc/"Dense_k/kernel/scale"`.  All three go to the
  `WNLinear` `fc`: `fc.weight` (transposed), `fc.bias`, `fc.scale`.

Any other leaf name raises.  `load_flax_params` loads the result
strictly, so a torch parameter left unset, or a flax leaf with no torch
counterpart, raises too.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _walk(tree: Mapping, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _walk(value, path)
        else:
            yield path, value


_WN_SCALE = "/kernel/scale"


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    leaves = list(_walk(tree))
    # WeightNorm: (parent path, "Dense_k") -> the wrapper's name
    wrapped = {(path[:-2], path[-1][:-len(_WN_SCALE)]): path[-2]
               for path, _ in leaves if path[-1].endswith(_WN_SCALE)}
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in leaves:
        arr = np.array(leaf, dtype=np.float32)
        *mods, name = path
        mods = [m for m in mods if m != "LayerNorm_0"]
        if (tuple(mods[:-1]), mods[-1] if mods else None) in wrapped:
            mods[-1] = wrapped[tuple(mods[:-1]), mods[-1]]   # Dense_k -> its WeightNorm
        if name.endswith(_WN_SCALE):
            if arr.ndim != 1:
                raise ValueError(f"{'/'.join(path)}: WeightNorm scale must be 1-D, "
                                 f"got {arr.shape}")
            name = "scale"
        elif name == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: Dense kernel must be 2-D, got {arr.shape}")
            arr, name = arr.T, "weight"
        elif name in ("scale", "embedding"):
            name = "weight"
        elif name == "lambda_u":
            if arr.ndim != 0:
                raise ValueError(f"{'/'.join(path)}: lambda_u must be 0-d, got {arr.shape}")
        elif name == "loss_weights":
            if arr.shape != (2,):
                raise ValueError(f"{'/'.join(path)}: loss_weights must be (2,), got {arr.shape}")
        elif name != "bias":
            raise KeyError(f"no conversion rule for flax leaf {'/'.join(path)}")
        out[".".join([*mods, name])] = torch.from_numpy(arr.copy())
    return out


def load_flax_params(module: nn.Module, tree: Mapping) -> None:
    """Load a converted flax tree into `module`, strictly (missing or
    unexpected names and shape mismatches raise): the whole MMF tree into
    `MMF.module`, an encoder subtree into an encoder.  The module must be
    unsharded: load first, then `tp_sharding` / `fsdp_sharding` split the
    weights, so one converted tree feeds every layout."""
    from multimodal_flows_tpu_torch.parallel.tensor_parallel import is_sharded

    if is_sharded(module):
        raise ValueError("load the flax tree into the unsharded module, then shard it "
                         "(parallel.tensor_parallel.tp_sharding / fsdp_sharding)")
    module.load_state_dict(params_from_flax(tree), strict=True)
