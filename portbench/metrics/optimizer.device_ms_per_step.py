"""Device time of the optimizer a traced training step: the union of the
device intervals of the kernels launched inside the program's span
vqcpcb.optimizer (training/optim.py Adam.step, the gradient clip
included), found through the launching ops' parent chain in the session
with host activity, in ms, over the profiled steps. None without the
span.

Only device events linked to a host op count. The profiler also reports
each span's range on the device as a CUDA-typed event
(`gpu_user_annotation`, from the start of the span's first kernel to the
end of its last) in that session; it is linked to no host op, so it is
left out."""
SPAN = "vqcpcb.optimizer"


def read(ctx):
    t = ctx.trace
    if t is None or t.fallback:
        return None
    seconds = t.device_seconds_under((SPAN,))
    if seconds <= 0:
        return None
    return seconds * 1e3 / t.calls
