"""Process groups and device meshes (PyTorch port of
`multimodal_flows_tpu/parallel/mesh.py`).

The JAX package lays one `jax.sharding.Mesh` over every device and lets
the partitioner insert the collectives; the port runs one process per
device (`torchrun`) and writes its collectives itself, over the groups of
a `torch.distributed.device_mesh.DeviceMesh` named `("data",)` or
`("data", "model")`.  Batches shard over `data`; the `model` axis carries
the tensor-parallel layers of `parallel/tensor_parallel.py`.

`init_from_env` starts the default process group when `torchrun` set
`WORLD_SIZE > 1`: NCCL on `cuda:LOCAL_RANK`, gloo for the CPU.  Without it
every helper here acts as for one process, and `make_mesh` raises.

The host-side slicing (`process_slice`, `process_batch_slice`,
`local_batch_shard`) is pure given explicit `(n_proc, idx)`, as in the JAX
package.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialized() -> bool:
    """Whether a default process group exists."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_primary() -> bool:
    """Rank 0, the one process that writes files."""
    return rank() == 0


def init_from_env(device="cuda") -> torch.device:
    """Start the default process group from `torchrun`'s environment
    (`WORLD_SIZE`, `RANK`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`) when
    `WORLD_SIZE > 1` and none exists yet: NCCL with this process on
    `cuda:LOCAL_RANK` for a CUDA device, gloo for the CPU.  At world size 1
    nothing starts.  Returns the device this process runs on."""
    device = torch.device(device)
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or initialized():
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device)
    else:
        dist.init_process_group("gloo")
    return device


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(device_type: Optional[str] = None, axis_name: str = DATA_AXIS):
    """1-D data-parallel mesh over every rank of the process group;
    `device_type` ("cuda" or "cpu") defaults to the backend's."""
    from torch.distributed.device_mesh import init_device_mesh

    if not initialized():
        raise RuntimeError("no process group: run under torchrun (init_from_env) or "
                           "call torch.distributed.init_process_group first")
    return init_device_mesh(_device_type(device_type), (world_size(),),
                            mesh_dim_names=(axis_name,))


def make_mesh_2d(n_model: int, device_type: Optional[str] = None):
    """(data, model) mesh: consecutive ranks form a tensor-parallel group,
    so on a multi-GPU host the model axis (the per-layer all-reduces) rides
    the fastest links.  Raises when the world size does not divide by
    `n_model`."""
    from torch.distributed.device_mesh import init_device_mesh

    n = world_size()
    if n % n_model:
        raise ValueError(f"{n} devices not divisible by model={n_model}")
    if not initialized():
        raise RuntimeError("no process group: run under torchrun (init_from_env) or "
                           "call torch.distributed.init_process_group first")
    return init_device_mesh(_device_type(device_type), (n // n_model, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def _axis_size(mesh, axis: str) -> int:
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def data_axis_size(mesh) -> int:
    """Ranks on the `data` axis (1 without a mesh).  Batch divisibility is
    checked against this, not the mesh's size: on a (data, model) mesh the
    batch shards over `data` only."""
    if mesh is not None and DATA_AXIS not in (mesh.mesh_dim_names or ()):
        return mesh.size()
    return _axis_size(mesh, DATA_AXIS)


def model_axis_size(mesh) -> int:
    return _axis_size(mesh, MODEL_AXIS)


def data_index(mesh) -> int:
    """This rank's coordinate on the `data` axis (0 without a mesh)."""
    if data_axis_size(mesh) == 1:
        return 0
    return mesh.get_local_rank(DATA_AXIS)


def data_group(mesh):
    """The process group of this rank's `data` axis, None when it has one
    rank."""
    return mesh.get_group(DATA_AXIS) if data_axis_size(mesh) > 1 else None


def data_rows(n: int, mesh) -> Optional[slice]:
    """This rank's rows of a batch of n that shards over the data axis;
    None (all rows) when the axis has one rank."""
    if data_axis_size(mesh) == 1:
        return None
    return process_batch_slice(n, data_axis_size(mesh), data_index(mesh))


def process_slice(n: int) -> slice:
    """This process's contiguous share of a length-n global set; the last
    process takes the remainder."""
    per = n // world_size()
    i = rank()
    return slice(i * per, (i + 1) * per if i < world_size() - 1 else n)


def process_batch_slice(n: int, n_proc: Optional[int] = None,
                        idx: Optional[int] = None) -> slice:
    """This process's contiguous rows of a batch axis of length n sharded
    over `n_proc` processes.  Unlike `process_slice` the shares must be
    equal: every rank runs the same shapes.  Pure given explicit (n_proc,
    idx)."""
    n_proc = world_size() if n_proc is None else n_proc
    idx = rank() if idx is None else idx
    if n % n_proc:
        raise ValueError(f"global batch axis {n} must divide evenly over {n_proc} processes")
    per = n // n_proc
    return slice(idx * per, (idx + 1) * per)


def local_batch_shard(a: np.ndarray, axis: int, n_proc: Optional[int] = None,
                      idx: Optional[int] = None) -> np.ndarray:
    """This process's rows of `a` along the sharded `axis`."""
    sl = [slice(None)] * a.ndim
    sl[axis] = process_batch_slice(a.shape[axis], n_proc, idx)
    return a[tuple(sl)]


def sync_hosts(name: str = "barrier") -> None:
    """A barrier over every rank when there is more than one (`name` names
    it in the JAX package and is kept for its callers)."""
    if world_size() > 1:
        dist.barrier()


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank `src`'s `obj` on every rank (itself at world size 1)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def shard_coupling(coupling, mesh, device=None):
    """This rank's rows of a (global) batch, on `device` when given: every
    rank holds the same global batch (one shuffle from the shared seed) and
    keeps its contiguous share of the data axis."""
    rows = data_rows(len(coupling), mesh)
    out = coupling if rows is None else coupling[rows]
    return out if device is None else out.to(device)


def shard_state(state, mesh, device=None):
    """`shard_coupling` for a `MultiModal` state."""
    return shard_coupling(state, mesh, device)
