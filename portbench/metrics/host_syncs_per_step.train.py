"""Host syncs a traced training step: the synchronizing CUDA runtime calls
(cudaStreamSynchronize and the others in SYNCS: a tensor read back with
.item() or int(), a blocking copy from host memory) that the session with
host activity recorded inside the host range of the program's span
vqcpcb.train_step (vqcpcb_tpu_torch/training/profiling.py), over the
profiled steps. The calls are found below the roots of the ops that
launched the traced device operations; they are put down to the span by
time, so that those of autograd's device thread, which runs the backward
outside the span's parent chain, count too. None without the span."""
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
                   "cuCtxSynchronize", "cuEventSynchronize"))


def syncs_inside(t, root: str):
    """The synchronizing runtime calls whose start lies inside a host range
    of span `root`, or None where the traced ops' trees hold no such span."""
    import bisect
    roots = {}
    for _, _, op in t.launched:
        while op is not None and op.cpu_parent is not None:
            op = op.cpu_parent
        if op is not None:
            roots[id(op)] = op
    spans, syncs, todo = [], [], list(roots.values())
    while todo:
        e = todo.pop()
        if e.name == root:
            spans.append((e.time_range.start, e.time_range.end))
        elif e.name in SYNCS:
            syncs.append(e.time_range.start)
        todo.extend(e.cpu_children)
    if not spans:
        return None
    spans.sort()
    starts = [s for s, _ in spans]
    inside = 0
    for start in syncs:
        i = bisect.bisect_right(starts, start) - 1
        inside += i >= 0 and start <= spans[i][1]
    return inside


def read(ctx):
    t = ctx.trace
    if t is None or t.fallback:
        return None
    syncs = syncs_inside(t, "vqcpcb.train_step")
    return None if syncs is None else syncs / t.calls
