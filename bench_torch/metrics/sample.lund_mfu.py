"""The sampling forwards' model FLOPs with the pair MLP (`counts.forward_flops`
of real tokens and real attention pairs, plus the architecture's
`pair_flops` for each real same-jet pair) over the wall of the traced
run's untraced window, as a share of the card's dense tensor-core peak for
the configuration's dtype (%).  Nothing to read for an architecture
without a pair term."""

from bench_torch import counts


def read(ctx):
    ref = counts.architecture(ctx.cfg)
    if ctx.plain_wall <= 0 or not ctx.plain_work or not hasattr(ref, "pair_flops"):
        return None
    flops = sum(r["count"] * (counts.forward_flops(ctx.cfg, r["tokens"], r["pairs"])
                              + ref.pair_flops(ctx.cfg) * r["pairs"])
                for r in ctx.plain_work)
    return 100.0 * flops / ctx.plain_wall / counts.dense_peak(ctx.cfg)
