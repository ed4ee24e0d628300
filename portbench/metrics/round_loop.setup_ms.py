"""The fused super-round's host set-up on the card (``megakernel.run_fused``,
the program's ``fused.setup`` span): the batch's clone, the scratch
batch, the control word, the K3 mask and the K1/K3/K4 argument blocks.
Its self time per hand-off, mean over the traced hand-offs, in ms."""

from portbench import spans


def read(ctx):
    return spans.self_ms(ctx, ("fused.setup",))
