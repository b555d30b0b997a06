"""Device operations launched a sampled position: the kernels, copies and
sets recorded in the traced calls / (calls x positions a call). A CUDA
graph or a fused decode step lowers it."""


def read(ctx):
    t = ctx.trace
    if t is None or t.fallback:
        return None
    return len(t.kernels) / (t.calls * ctx.window["positions"])
