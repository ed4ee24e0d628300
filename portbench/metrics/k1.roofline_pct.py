"""K1 (``step_run_kernel``, ``csrc/step.cu``) against its bandwidth
bound: the least time, at the card's peak memory rate, for the bytes the
K1 launches of the traced hand-offs must move (``bytes.k1_handoff_bytes``),
over K1's time in the profiler's trace, in %."""

KERNEL = "step_run_kernel"


def read(ctx):
    rate = ctx.peaks.get("hbm_bytes_per_s")
    t_us = ctx.kernel_us(KERNEL)
    if not rate or not t_us or not ctx.handoffs:
        return None
    nbytes = sum(ctx.bytes.k1_handoff_bytes(ctx.cfg, ctx.code_len_used, h["seed_rows"], h["end_rows"])
                 for h in ctx.handoffs)
    return 100.0 * ctx.bytes.least_ms(nbytes, rate) / (t_us / 1e3)
