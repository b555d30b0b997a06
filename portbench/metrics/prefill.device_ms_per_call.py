"""Device time of the sampler's prefill a generation call: the union of
the device intervals of the kernels launched inside the program's span
vqcpcb.prefill (models/decoder.py `Decoder.sample_range`: the memory and
the decoder stack's caches, once a call), found through the launching
ops' parent chain in the session with host activity, in ms, over the
traced calls. Only device events linked to a host op count, as in
optimizer.device_ms_per_step. None without the span."""
SPAN = "vqcpcb.prefill"


def read(ctx):
    t = ctx.trace
    if t is None or t.fallback:
        return None
    seconds = t.device_seconds_under((SPAN,))
    if seconds <= 0:
        return None
    return seconds * 1e3 / t.calls
