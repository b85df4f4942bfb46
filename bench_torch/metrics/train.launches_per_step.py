"""Kernels the card executed a train step over the traced window."""

NOT_KERNELS = ("Memcpy", "Memset")


def read(ctx):
    if not ctx.steps:
        return None
    kernels = [d for d in ctx.trace.kernels() if not d[2].startswith(NOT_KERNELS)]
    return len(kernels) / ctx.steps
