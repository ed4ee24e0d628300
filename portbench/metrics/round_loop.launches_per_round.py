"""K1 + K3 + K4 launches a retired round: the ``launches`` the program's
``fused_super_round`` spans record (the launches each dispatch queued,
counted on the card only), summed over the traced hand-offs, over the
rounds they record as retired."""

from portbench import spans


def read(ctx):
    got = spans.groups(ctx)
    if got is None:
        return None
    rounds = launches = 0
    for g in got:
        for sp in g:
            if sp[0] == "fused_super_round":
                rounds += sp[4].get("rounds", 0)
                launches += sp[4].get("launches", 0)
    return launches / rounds if rounds and launches else None
