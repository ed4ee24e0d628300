"""Blocking device-to-host reads of the round loop a hand-off: the
``reads`` that the program's ``round_loop.info_fetch``,
``round_loop.drain_read`` and ``round_loop.pruned_fetch`` spans record
where each read happens, summed per hand-off; mean over the traced
hand-offs."""

from portbench import spans


def read(ctx):
    got = spans.groups(ctx)
    if got is None:
        return None
    return sum(sp[4].get("reads", 0) for g in got for sp in g if sp[0] in spans.SYNC_SPANS) / len(got)
