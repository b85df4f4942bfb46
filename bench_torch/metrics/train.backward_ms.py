"""Device ms a train step outside the loss and the optimizer: the
backward, which autograd launches from its own thread (with K1's and K2's
backward recomputed through the plain attention), and the batch gather;
over the steps of the window traced with the host's ops."""


def read(ctx):
    fwd = ctx.detail.phase_ms("bench.train_forward")
    opt = ctx.detail.phase_ms("bench.train_optimizer")
    if fwd is None or opt is None or not ctx.detail_steps:
        return None
    return (ctx.detail.device_s() * 1e3 - fwd - opt) / ctx.detail_steps
