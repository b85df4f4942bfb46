"""Host microseconds a sampling step: the mean duration of the program's
`solver.step` spans (one step of one batch of rows) or `gpt.decode_step`
spans (one decode position of one batch), over the window traced on the
device alone.  That window's requests are those whose top-level span
(`sample.call`, `gpt.generate`) starts after the last device record of
the window traced with the host's ops.  Nothing to read where the program
records no such spans, or where their count is not the window's: a call
a work record and `num_timesteps` steps a batch of rows for a flow
sampler, `ctx.steps` decode steps for the GPT."""


def read(ctx):
    from multimodal_flows_tpu_torch.utils import profiling

    if not hasattr(profiling, "peek_spans") or not ctx.detail.device or not ctx.steps:
        return None
    after = max(end for _, end, _, _ in ctx.detail.device)
    spans = profiling.peek_spans()
    calls = profiling.requests(spans, "sample.call", after)
    if calls:
        steps = [s for c in calls for s in c if s.name == "solver.step"]
        batches = sum(s.name == "sample.batch" for c in calls for s in c)
        # ctx.steps counts num_timesteps a call
        if len(calls) != len(ctx.work) or len(steps) * len(calls) != batches * ctx.steps:
            return None
    else:
        calls = profiling.requests(spans, "gpt.generate", after)
        steps = [s for c in calls for s in c if s.name == "gpt.decode_step"]
        if len(steps) != ctx.steps:
            return None
    return sum(s.end_ns - s.start_ns for s in steps) / len(steps) / 1e3
