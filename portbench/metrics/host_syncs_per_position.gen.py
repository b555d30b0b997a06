"""Host syncs a sampled position: the synchronizing CUDA runtime calls
inside the host range of the program's span vqcpcb.sample_range
(models/decoder.py `Decoder.sample_range`: the prefill, the decode steps
and the sampling), found as host_syncs_per_step.train finds them, over the
traced calls' positions. None without the span."""
from portbench.harness import registry


def read(ctx):
    t = ctx.trace
    if t is None or t.fallback:
        return None
    syncs = registry.module("metrics", "host_syncs_per_step.train").syncs_inside(
        t, "vqcpcb.sample_range")
    return None if syncs is None else syncs / (t.calls * ctx.window["positions"])
