"""Host milliseconds a train step in the program's `train.loss` span (the
system's `loss_fn` in `Trainer._train_step`), over the steps of the window
traced on the device alone (those whose `train.step` starts after the last
device record of the window traced with the host's ops).  Nothing to read
where the program records no such spans, or where the count of steps is
not the window's."""

SPAN = "train.loss"


def read(ctx):
    from multimodal_flows_tpu_torch.utils import profiling

    if not hasattr(profiling, "peek_spans") or not ctx.detail.device or not ctx.steps:
        return None
    after = max(end for _, end, _, _ in ctx.detail.device)
    steps = profiling.requests(profiling.peek_spans(), "train.step", after)
    if len(steps) != ctx.steps:
        return None
    ns = sum(s.end_ns - s.start_ns for r in steps for s in r if s.name == SPAN)
    return ns / len(steps) / 1e6
