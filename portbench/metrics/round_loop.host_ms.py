"""Host time of the round loop (``backend._run_device_fused``) per
hand-off: the host clock around the call, less the device time that the
profiler puts inside it (the union of device operations clipped to the
call). Mean over the traced hand-offs, in ms."""


def read(ctx):
    loops = [h["loop"] for h in ctx.handoffs if h.get("loop")]
    if not loops or not ctx.ops:
        return None
    total = 0.0
    for lo, hi in loops:
        total += (hi - lo) - ctx.busy_us(lo, hi)
    return total / len(loops) / 1e3
