"""Meshes and sharded layouts on `torch.distributed` (the port of
`multimodal_flows_tpu/parallel/`): `mesh` for the process groups, the
device meshes and the host-side batch slicing, `tensor_parallel` for the
FSDP2 and Megatron tensor-parallel layouts and their full checkpoints."""
