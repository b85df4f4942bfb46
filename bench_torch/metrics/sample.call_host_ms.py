"""Host milliseconds a sampling call in which the device has nothing
queued: the program's `sample.pack`, `sample.unpack` and `sample.finalize`
spans of each `sample.call` (the wait in `sample.fetch` left out), over the
calls of the window traced on the device alone (those whose `sample.call`
starts after the last device record of the window traced with the host's
ops).  Nothing to read where the program records no such spans, or where
the count of calls is not the window's."""

HOST_ONLY = ("sample.pack", "sample.unpack", "sample.finalize")


def read(ctx):
    from multimodal_flows_tpu_torch.utils import profiling

    if not hasattr(profiling, "peek_spans") or not ctx.detail.device or not ctx.work:
        return None
    after = max(end for _, end, _, _ in ctx.detail.device)
    calls = profiling.requests(profiling.peek_spans(), "sample.call", after)
    if len(calls) != len(ctx.work):
        return None
    ns = sum(s.end_ns - s.start_ns for c in calls for s in c if s.name in HOST_ONLY)
    return ns / len(calls) / 1e6
