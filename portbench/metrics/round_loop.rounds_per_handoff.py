"""Fused rounds a hand-off retires: ``megakernel.decode_info``'s rounds,
summed by ``_run_device_fused`` over its dispatches (the super-round
totals it hands back on the bridge). Mean over the traced hand-offs."""


def read(ctx):
    if not ctx.handoffs:
        return None
    return sum(h["rounds"] for h in ctx.handoffs) / len(ctx.handoffs)
