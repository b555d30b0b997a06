"""The 95th percentile of the intervals between consecutive step starts
(CUDA events on the stream) over the untraced window of the traced run:
`train_step_p95_ms`, read per layer in a cell whose host-paced steps
spread too widely between runs for an end-to-end bound."""


def read(ctx):
    w = ctx.window
    if not w.get("steps"):
        return None
    return w["step_ms_p95"]
