"""Device time of the decode step a sampled position: the union of the
device intervals of the kernels launched inside the program's span
vqcpcb.decode_step (models/decoder.py `_decode_one`, once a position),
found through the launching ops' parent chain in the session with host
activity, in ms, over the traced calls' positions. Only device events
linked to a host op count, as in optimizer.device_ms_per_step. None
without the span."""
SPAN = "vqcpcb.decode_step"


def read(ctx):
    t = ctx.trace
    if t is None or t.fallback:
        return None
    seconds = t.device_seconds_under((SPAN,))
    if seconds <= 0:
        return None
    return seconds * 1e3 / (t.calls * ctx.window["positions"])
