"""The round tail, K3 (``unsat_kernel``, ``csrc/inloop.cu``) and K4
(``epilogue_kernel``, ``csrc/megakernel.cu``), against its bandwidth
bound: the least time for the bytes of the traced hand-offs' retired
rounds (``bytes.epilogue_handoff_bytes``) over the two kernels' time in
the profiler's trace, in %."""

KERNELS = ("unsat_kernel", "epilogue_kernel")


def read(ctx):
    rate = ctx.peaks.get("hbm_bytes_per_s")
    t_us = sum(ctx.kernel_us(k) for k in KERNELS)
    if not rate or not t_us or not ctx.handoffs:
        return None
    pool = ctx.bytes.pool_bytes()
    nbytes = sum(ctx.bytes.epilogue_handoff_bytes(ctx.cfg, h["rounds"], h["dying"], pool) for h in ctx.handoffs)
    return 100.0 * ctx.bytes.least_ms(nbytes, rate) / (t_us / 1e3)
