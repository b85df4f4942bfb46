"""Host microseconds a Lund-bias forward: the mean duration of the
program's `kinformer.lund_bias` spans (the Lund observables and the pair
MLP of one forward, one a solver step of a batch of rows), over the
window traced on the device alone (the calls whose `sample.call` starts
after the last device record of the window traced with the host's ops).
Nothing to read where the program records no such spans, or where their
count is not one a `solver.step` of the window's calls."""

SPAN = "kinformer.lund_bias"


def read(ctx):
    from multimodal_flows_tpu_torch.utils import profiling

    if not hasattr(profiling, "peek_spans") or not ctx.detail.device or not ctx.work:
        return None
    after = max(end for _, end, _, _ in ctx.detail.device)
    calls = profiling.requests(profiling.peek_spans(), "sample.call", after)
    lund = [s for c in calls for s in c if s.name == SPAN]
    steps = sum(s.name == "solver.step" for c in calls for s in c)
    if len(calls) != len(ctx.work) or not lund or len(lund) != steps:
        return None
    return sum(s.end_ns - s.start_ns for s in lund) / len(lund) / 1e3
