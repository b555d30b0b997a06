"""Device idle time put down to the optimizer a traced training step: in
the session with host activity, the gaps between the device's busy
intervals (the union of the device events linked to a host op, so the
profiler's device ranges of spans are left out, as in
optimizer.device_ms_per_step) whose middle falls inside the host interval
of a vqcpcb.optimizer span, summed, in ms, over the profiled steps: the
time the device waits on the optimizer's launches. None without the
span."""
import bisect

from portbench.harness.tracing import _union

SPAN = "vqcpcb.optimizer"


def idle_seconds_inside(t, name: str):
    """Seconds of the device's idle gaps whose middle lies inside a span
    `name`, or None where no kernel was launched inside one."""
    spans = {}
    busy = []
    for start, end, op in t.launched:
        if op is None:
            continue
        busy.append((start, end))
        while op is not None:
            if op.name == name:
                spans[id(op)] = (op.time_range.start, op.time_range.end)
                break
            op = op.cpu_parent
    if not spans:
        return None
    intervals = sorted(spans.values())
    starts = [s for s, _ in intervals]
    union = _union(busy)
    idle = 0.0
    for (_, end), (start, _) in zip(union, union[1:]):
        mid = 0.5 * (end + start)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= intervals[i][1]:
            idle += start - end
    return idle / 1e6


def read(ctx):
    t = ctx.trace
    if t is None or t.fallback:
        return None
    seconds = idle_seconds_inside(t, SPAN)
    return None if seconds is None else seconds * 1e3 / t.calls
