"""The share of the traced window in which no operation ran on the card
(the union of the profiler's device operations), in %."""


def read(ctx):
    lo, hi = ctx.window
    if not ctx.ops or hi <= lo:
        return None
    return 100.0 * (1.0 - ctx.busy_us(lo, hi) / (hi - lo))
