"""The whole training step's share of the card's peak: the model's
operations a step (the configuration's costs file: forward x 3, nothing
recomputed) x the window's steps / the window's host time / the bf16 peak,
in %. Read from the untraced window of the traced run."""
from portbench.harness.peaks import PEAK_FLOPS


def read(ctx):
    w = ctx.window
    if not w.get("steps"):
        return None
    flops = ctx.costs.train_flops(ctx.config, ctx.traffic)
    return 100.0 * flops * w["steps"] / w["seconds"] / PEAK_FLOPS
