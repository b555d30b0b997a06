"""The whole generation call's share of the card's peak: the operations a
call needs (the configuration's costs file) x the window's calls / the
window's host time / the bf16 peak, in %. Read from the untraced window of
the traced run."""
from portbench.harness.peaks import PEAK_FLOPS


def read(ctx):
    w = ctx.window
    if not w.get("calls"):
        return None
    flops = ctx.costs.generate_flops(ctx.config, ctx.traffic)
    return 100.0 * flops * w["calls"] / w["seconds"] / PEAK_FLOPS
