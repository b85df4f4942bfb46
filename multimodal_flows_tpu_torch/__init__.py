"""multimodal_flows_tpu_torch — the PyTorch/CUDA port of multimodal_flows_tpu.

Mirrors the JAX package's layout and public names.  It imports torch and
never JAX; the JAX package stays the reference the port's tests hold it
to.  The hand-written Hopper kernels live in `csrc/` and build at first
use on a machine with the CUDA toolkit.
"""

__version__ = "0.1.0"

from multimodal_flows_tpu_torch.data.state import MultiModal

__all__ = ["MultiModal", "__version__"]
