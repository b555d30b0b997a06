"""The traced part of a `--trace 1` run: torch.profiler (CPU and CUDA
activity) around a fixed count of whole steps or calls, reduced to what the
per-layer readers and the result's `device` and `breakdown` take.

Busy time is the union of the device operations' intervals (kernels,
copies, sets), so overlapping work is counted once; the window is the host
time from the first call to the synchronize after the last, in a session
that records device activity alone, so that the host runs nearly as it
does untraced. A second session with host activity gives each aten op's
device time and the idle gaps by host op. A device session that records
no device operation is run again, up to three sessions; after that the
reduction says so and holds no device time."""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional, Tuple

SESSIONS = 3
TOP = 10
NAME_CHARS = 120


def _total_device_time(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


class Trace:
    """What the profiled sections left. From the device-only session:
    `kernels` [(name, start_us, end_us)], `busy_s`, `window_s`, `calls`,
    `fallback` (no device operation recorded). From the session with host
    activity: `ops` {aten op: device us of the kernels its outermost calls
    launched, children included}, each kernel's interval beside the host op
    that launched it (`launched`), and the idle gaps by host op."""

    def __init__(self, device_prof, window_s: float, calls: int, host_prof=None):
        from torch.autograd import DeviceType
        self.window_s = window_s
        self.calls = calls
        self.kernels = _kernels(device_prof)
        self.union = _union([(s, t) for _, s, t in self.kernels])
        self.busy_s = sum(t - s for s, t in self.union) / 1e6
        self.fallback = not self.kernels
        self.ops: Dict[str, float] = {}
        self.host: List[Tuple[str, float, float]] = []
        self.host_union: List[Tuple[float, float]] = []
        self.launched: List[tuple] = []
        if host_prof is None:
            return
        events = host_prof.events()
        for e in events:
            if e.device_type != DeviceType.CPU or not e.name.startswith("aten::"):
                continue
            self.host.append((e.name, e.time_range.start, e.time_range.end))
            parent, nested = e.cpu_parent, False
            while parent is not None:
                nested = nested or parent.name == e.name
                parent = parent.cpu_parent
            if not nested:
                self.ops[e.name] = self.ops.get(e.name, 0.0) + _total_device_time(e)
        self.host_union = _union([(s, t) for _, s, t in _kernels(host_prof)])
        # a kernel is linked to the host op that launched it: by the op's
        # correlation id where the profiler's events keep it (as torch's own
        # reduction links them), else through the runtime call (cudaLaunch*,
        # cuLaunch*, ...) that shares the kernel's id and nests in the op
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        ops_by_id = {e.id: e for e in cpu if e.name.startswith("aten::")}
        runtime_by_id = {e.id: e for e in cpu if e.name.startswith("cu")}
        for e in events:
            if e.device_type != DeviceType.CUDA:
                continue
            op = ops_by_id.get(getattr(e, "linked_correlation_id", 0) or -1)
            if op is None:
                op = runtime_by_id.get(e.id)
            self.launched.append((e.time_range.start, e.time_range.end, op))

    def device_seconds(self, match: Callable[[str], bool]) -> float:
        """Summed device time of the operations whose name matches."""
        return sum(t - s for name, s, t in self.kernels if match(name)) / 1e6

    def device_seconds_under(self, ops) -> float:
        """The union of the device intervals of the kernels launched inside
        a host op named in `ops`, at any depth, in the session with host
        activity."""
        ops = set(ops)

        def inside(op) -> bool:
            while op is not None:
                if op.name in ops:
                    return True
                op = op.cpu_parent
            return False
        return sum(t - s for s, t in
                   _union([(s, t) for s, t, op in self.launched if inside(op)])) / 1e6

    def top_device_ops(self) -> List[list]:
        by_name: Dict[str, float] = {}
        for name, s, t in self.kernels:
            key = name[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + (t - s) / 1e6
        return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        """The device's idle gaps inside the session with host activity,
        their seconds summed by the innermost host op in flight at each
        gap's middle."""
        import bisect
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by_op: Dict[str, float] = {}
        for (_, end), (start, _) in zip(self.host_union, self.host_union[1:]):
            mid = 0.5 * (end + start)
            i = bisect.bisect_right(starts, mid)
            best: Optional[Tuple[str, float]] = None
            for name, s, t in host[max(0, i - 400):i]:
                if s <= mid <= t and (best is None or t - s < best[1]):
                    best = (name, t - s)
            key = best[0] if best else "(no host op)"
            by_op[key] = by_op.get(key, 0.0) + (start - end) / 1e6
        return [[k, v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]]


def _kernels(prof) -> List[Tuple[str, float, float]]:
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def _session(fn, first: int, calls: int, activities, sync):
    from torch.profiler import profile as torch_profile
    sync()
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + calls):
            fn(i)
        sync()
        window = time.perf_counter() - t0
    return prof, window


def profile(fn: Callable[[int], None], calls: int, log, cuda: bool = True) -> Trace:
    """fn(i) for `calls` values of i in two profiled sessions, each
    synchronized after: device activity alone (busy time, window, kernels:
    the host runs as it does untraced, or nearly), then host and device
    activity (the ops' device time, the idle gaps by host op). A device
    session that records no device operation is run again."""
    import torch
    from torch.profiler import ProfilerActivity
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    device_only = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    for session in range(1, SESSIONS + 1):
        prof, window = _session(fn, 0, calls, device_only, sync)
        if _kernels(prof) or not cuda:
            break
        log(f"# trace: profiler session {session} of {SESSIONS} recorded no "
            "device operation")
        del prof
        gc.collect()
    host_prof, _ = _session(fn, calls, calls,
                            [ProfilerActivity.CPU] + device_only[:int(cuda)], sync)
    return Trace(prof, window, calls, host_prof)
