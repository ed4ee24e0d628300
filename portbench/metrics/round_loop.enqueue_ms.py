"""The fused super-round's enqueue on the card (``megakernel.run_fused``,
the program's ``fused.enqueue`` span): the loop that queues
``max_rounds`` x (K1, K3, K4). Its self time per hand-off, mean over the
traced hand-offs, in ms."""

from portbench import spans


def read(ctx):
    return spans.self_ms(ctx, ("fused.enqueue",))
