"""Device time of cuDNN's GRU a traced training step: the union of the
device intervals of the kernels launched inside aten::_cudnn_rnn and
aten::_cudnn_rnn_backward (the ops torch._VF.gru and its backward run), in
ms, over the profiled steps. A union, since cuDNN overlaps its RNN
kernels: a sum would move with the overlap alone."""
OPS = ("aten::_cudnn_rnn", "aten::_cudnn_rnn_backward")


def read(ctx):
    t = ctx.trace
    if t is None or t.fallback:
        return None
    seconds = t.device_seconds_under(OPS)
    if seconds <= 0:
        return None
    return seconds * 1e3 / t.calls
