"""Device idle time put down to the sampler a sampled position: the idle
gaps of the session with host activity whose middle falls inside a
vqcpcb.sample span (the head's logits, the forbidden symbols' fill and
ops/sampling.py, once a position), as optimizer.idle_ms_per_step finds
them, in ms, over the traced calls' positions. None without the span."""
from portbench.harness import registry

SPAN = "vqcpcb.sample"


def read(ctx):
    t = ctx.trace
    if t is None or t.fallback:
        return None
    seconds = registry.module("metrics", "optimizer.idle_ms_per_step").idle_seconds_inside(
        t, SPAN)
    return None if seconds is None else seconds * 1e3 / (t.calls * ctx.window["positions"])
