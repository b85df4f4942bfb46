"""Device milliseconds of collectives a train step on rank 0: the NCCL
kernels (the gradients' all-reduce, and the metrics' at the end of a
unit's epoch) over the steps of the window traced on the device alone.
Nothing to read where no NCCL kernel ran."""

NCCL = ("nccl",)


def read(ctx):
    ms = ctx.trace.device_s(NCCL) * 1e3
    if ms <= 0 or not ctx.steps:
        return None
    return ms / ctx.steps
