"""The least time the sampling window's attention calls need
(`counts.attention_bound_s`: their bytes at the HBM rate or their FLOPs at
the dense peak, whichever is longer) over the device time of the program's
hand-written attention kernels (%).  Nothing to read where no such kernel
ran."""

from bench_torch import counts
from bench_torch.trace import CSRC_KERNELS


def read(ctx):
    device_s = ctx.trace.device_s(CSRC_KERNELS)
    if device_s <= 0 or not ctx.work:
        return None
    return 100.0 * sum(counts.attention_bound_s(r, ctx.cfg) for r in ctx.work) / device_s
