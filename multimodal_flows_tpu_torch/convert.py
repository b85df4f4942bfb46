"""Flax -> PyTorch parameter conversion.

`params_from_flax(tree)` takes a flax parameter tree as nested mappings
of numpy arrays and returns a state dict whose names mirror the flax
names.  Given the whole MMF tree (`params['params']`: `encoder` +
`multitask`) it fits `MMFModel`; given the encoder subtree it fits the
encoder (`MMFModel.encoder`, or a CFM/MJB system's module):

- a Dense `kernel` (in, out) becomes the Linear `weight` (out, in);
- `bias` carries over unchanged;
- an Embed `embedding` becomes the Embedding `weight`;
- a LayerNorm's `LayerNorm_0/{scale, bias}` (the project's wrapper) and a
  bare flax `nn.LayerNorm`'s `{scale, bias}` (KinFormer's `wue_ln`)
  become `{weight, bias}`;
- the 0-d `lambda_u` gate carries over as a 0-d parameter, and the (2,)
  `loss_weights` of the weighted multitask loss as they are.

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


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(tree):
        arr = np.array(leaf, dtype=np.float32)
        *mods, name = path
        mods = [m for m in mods if m != "LayerNorm_0"]
        if name == "kernel":
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
    `MMF.module`, an encoder subtree into an encoder."""
    module.load_state_dict(params_from_flax(tree), strict=True)
