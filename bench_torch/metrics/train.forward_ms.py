"""Device ms a train step inside the loss (the `bench.train_forward`
range around the system's `loss_fn`): the kernels launched from it, over
the steps of the window traced with the host's ops."""


def read(ctx):
    ms = ctx.detail.phase_ms("bench.train_forward")
    return None if ms is None or not ctx.detail_steps else ms / ctx.detail_steps
