"""Pairs the program's Lund pair MLP computed for each pair a real jet
needs: the `lund.pairs` counter over the window traced on the device
alone (each call's difference, kept in its work record by the driver),
over those calls' same-jet pairs, sum of n^2 a call times its steps (x;
1 would be no pair computed across jets or on pads).  Nothing to read
where the program has no such counter."""


def read(ctx):
    if not ctx.work or any(r.get("lund") is None for r in ctx.work):
        return None
    pairs = sum(r["lund"]["pairs"] for r in ctx.work)
    real = sum(r["count"] * r["pairs"] for r in ctx.work)
    if pairs <= 0 or real <= 0:
        return None
    return pairs / real
