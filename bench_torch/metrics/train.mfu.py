"""Training FLOPs (3 x the forward's) (`counts.forward_flops`: real tokens and real attention
pairs only) over the wall of the traced run's untraced window, as a share
of the card's dense tensor-core peak for the configuration's dtype (%)."""

from bench_torch import counts


def read(ctx):
    if ctx.plain_wall <= 0 or not ctx.plain_work:
        return None
    flops = 3 * sum(r["count"] * counts.forward_flops(ctx.cfg, r["tokens"], r["pairs"])
                    for r in ctx.plain_work)
    return 100.0 * flops / ctx.plain_wall / counts.dense_peak(ctx.cfg)
