"""Kernels the card executed a solver or decode step: the kernels of the
traced window over its steps (a call's steps count once for all its jets:
`num_timesteps` a call of a flow sampler, seq_len - 1 a call of the GPT
decode)."""

NOT_KERNELS = ("Memcpy", "Memset")


def read(ctx):
    if not ctx.steps:
        return None
    kernels = [d for d in ctx.trace.kernels() if not d[2].startswith(NOT_KERNELS)]
    return len(kernels) / ctx.steps
