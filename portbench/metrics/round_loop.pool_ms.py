"""The round loop's in-loop pool: ``solver_cache.GLOBAL.build_inloop_pool``
and ``transfer.pool_to_device`` (the program's ``round_loop.pool`` span;
the pool's staged upload counts under ``transfer.up_host_ms``). Its self
time per hand-off, mean over the traced hand-offs, in ms."""

from portbench import spans


def read(ctx):
    return spans.self_ms(ctx, ("round_loop.pool",))
