"""Upload (K6) and download (K7) of a hand-off: CUDA events recorded
before and after ``transfer.batch_to_device`` and
``transfer.batch_to_host``, summed per hand-off; mean in ms."""


def read(ctx):
    ms = [h["up_ms"] + h["down_ms"] for h in ctx.handoffs if h.get("up_ms") is not None]
    return sum(ms) / len(ms) if ms else None
