"""The relative-bias attention kernels' share of their roofline over the
traced training steps: the least time of every K2 forward and backward
launch of a step (the configuration's costs file: max(bytes / 3.35 TB/s,
operations over the live mask entries / 989 TFLOP/s)) x the steps, over the
device time of those kernels, matched by name: the forward of
csrc/attention_fwd_mma.cuh (namespace fwd_mma) and the backward's launches
of csrc/attention_bwd_mma.cuh (bwd_mma) and csrc/relbias_attention_bwd.cu.
In this configuration's training step no other kernel carries those names."""
NAMES = ("fwd_mma::", "bwd_mma::", "relbias_bwd")


def read(ctx):
    t = ctx.trace
    if t is None or t.fallback:
        return None
    seconds = t.device_seconds(lambda name: any(n in name for n in NAMES))
    if seconds <= 0:
        return None
    return 100.0 * ctx.costs.relbias_least_seconds(ctx.config, ctx.traffic) * t.calls / seconds
