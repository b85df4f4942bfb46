"""`sample.lund_mfu`'s reading, which holds for any architecture with a
pair term, on the ParT cell: the sampling forwards' model FLOPs with the
pair embedding of each real same-jet pair over the wall of the traced
run's untraced window, as a share of the card's dense tensor-core peak for
the configuration's dtype (%)."""

from bench_torch.harness import read_metric


def read(ctx):
    return read_metric("sample.lund_mfu", ctx)
