"""The upload's host work: ``transfer.batch_parts`` (the program's
``transfer.up.parts`` span: the plane groups' scans, the tape prefix
cut) and the staging into the pinned buffer (``transfer.up.stage``, the
pool's upload included). Their self time per hand-off, mean over the
traced hand-offs, in ms."""

from portbench import spans


def read(ctx):
    return spans.self_ms(ctx, ("transfer.up.parts", "transfer.up.stage"))
