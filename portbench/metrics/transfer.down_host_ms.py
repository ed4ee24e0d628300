"""The download's host work after its fetches: the host views of the
fetched buffers (the program's ``transfer.down.unpack`` spans) and the
tape and lane padding back to the batch's full shape
(``transfer.down.pad``). Their self time per hand-off, mean over the
traced hand-offs, in ms."""

from portbench import spans


def read(ctx):
    return spans.self_ms(ctx, ("transfer.down.unpack", "transfer.down.pad"))
