"""Host microseconds a ParT pair embedding: `sample.lund_host_us`'s
reading of the program's `part.pair_embed` spans (the pair observables and
the pair embedding of one forward, one a solver step of a batch of rows),
over the window traced on the device alone.  Nothing to read where the
program records no such spans, or where their count is not one a
`solver.step` of the window's calls."""

import importlib.util

from bench_torch.harness import PATHS

SPAN = "part.pair_embed"


def read(ctx):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_part_pair_host_us_span", PATHS / "metrics" / "sample.lund_host_us.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    reader.SPAN = SPAN
    return reader.read(ctx)
