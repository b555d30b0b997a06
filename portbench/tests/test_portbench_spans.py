"""The readers of the program's spans (the seven per-layer metrics of
vqcpcb_tpu_torch/training/profiling.py's vqcpcb.* spans): each reads its
number from a synthetic Trace; the profiler's device range of a span (an
event linked to no host op) is left out; the host syncs are the
synchronizing runtime calls inside the root span's range, those of
another thread (autograd's device thread) by time; each reads None where
there is nothing to read: no span, as in a program without them (the
parent of these readers has none); a tiny CPU traced run, which records
no device operation, reports none of them. Marked `cuda`: the syncs of a
real profiled span on the card, a backward's on autograd's device thread
included, each read in a fresh interpreter."""
import json
from types import SimpleNamespace

import pytest

from portbench import run
from portbench.harness import registry
from portbench.harness.tracing import Trace
from portbench.tests import tiny

SPAN_READERS = ["optimizer.device_ms_per_step", "optimizer.idle_ms_per_step",
                "decode_step.device_ms_per_position", "sample.idle_ms_per_position",
                "prefill.device_ms_per_call", "host_syncs_per_step.train",
                "host_syncs_per_position.gen"]


def read(name, trace=None, positions=4):
    ctx = SimpleNamespace(trace=trace, window={"positions": positions})
    return registry.module("metrics", name).read(ctx)


def event(name, start, end, parent=None):
    e = SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                        cpu_parent=parent, cpu_children=[])
    if parent is not None:
        parent.cpu_children.append(e)
    return e


def trace(launched, calls=2):
    t = Trace.__new__(Trace)
    t.calls, t.fallback, t.launched = calls, False, launched
    return t


def training_trace():
    """Two steps in us: the optimizer's span at [100, 200] and [400, 500],
    each with two kernels of 10 us and a gap between them (of 30 and 60
    us), the forward's kernels before, and one annotation event over the
    first optimizer span's kernels."""
    launched = []
    for base, gap in ((0, 30), (300, 60)):
        step = event("vqcpcb.train_step", base, base + 250)
        fwd = event("vqcpcb.forward", base, base + 90, step)
        opt = event("vqcpcb.optimizer", base + 100, base + 200, step)
        launched += [(base + 10, base + 60, event("aten::mm", base + 5, base + 8, fwd)),
                     (base + 110, base + 120, event("aten::mul", base + 101, base + 102, opt)),
                     (base + 120 + gap, base + 130 + gap,
                      event("cudaLaunchKernel", base + 140, base + 141,
                            event("aten::div", base + 139, base + 142, opt)))]
    launched.append((110, 160, None))
    return trace(launched)


def generation_trace():
    """One call of 4 positions in us: a prefill span with kernels at
    [0, 40] and [20, 50] (overlapping: a union of 50), then each position a
    decode step with a 7-us kernel and a sample span with two kernels 6 us
    apart (a gap whose middle lies in the span; the gap before them has its
    middle in the decode step, the one after in no span), and one
    annotation event over the whole call."""
    call = event("vqcpcb.sample_range", 0, 1000)
    prefill = event("vqcpcb.prefill", 0, 60, call)
    launched = [(0, 40, event("aten::bmm", 1, 2, prefill)),
                (20, 50, event("aten::mm", 3, 4, prefill))]
    for p in range(4):
        base = 100 + 100 * p
        step = event("vqcpcb.decode_step", base, base + 10, call)
        sample = event("vqcpcb.sample", base + 10, base + 30, call)
        launched += [(base, base + 7, event("aten::addmm", base + 1, base + 2, step)),
                     (base + 12, base + 14, event("aten::sort", base + 11, base + 12, sample)),
                     (base + 20, base + 23, event("aten::argmax", base + 19, base + 20, sample))]
    launched.append((0, 1000, None))
    return trace(launched, calls=1)


def test_training_span_readers():
    t = training_trace()
    assert read("optimizer.device_ms_per_step", t) == pytest.approx(20e-3)
    assert read("optimizer.idle_ms_per_step", t) == pytest.approx(45e-3)


def test_generation_span_readers():
    t = generation_trace()
    assert read("prefill.device_ms_per_call", t) == pytest.approx(50e-3)
    assert read("decode_step.device_ms_per_position", t) == pytest.approx(7e-3)
    assert read("sample.idle_ms_per_position", t) == pytest.approx(6e-3)


def test_idle_gap_put_down_to_the_sample_span():
    call = event("vqcpcb.sample_range", 0, 100)
    sample = event("vqcpcb.sample", 10, 40, call)
    t = trace([(0, 12, event("aten::addmm", 1, 2, call)),
               (30, 33, event("aten::sort", 28, 29, sample)),
               (90, 95, event("aten::addmm", 60, 61, call))], calls=1)
    # gaps 12-30 (middle 21, in the span) and 33-90 (middle 61.5, outside)
    assert read("sample.idle_ms_per_position", t, positions=1) == pytest.approx(18e-3)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_read_none_without_their_span(name):
    plain = trace([(0, 10, event("aten::mm", 0, 1))])
    assert read(name, plain) is None
    assert read(name, None) is None
    fallback = trace([])
    fallback.fallback = True
    assert read(name, fallback) is None


def syncing_trace():
    """Two steps in us, [0, 250] and [300, 550]. Each has a sync under an
    op of the forward, and a backward node on another thread (a tree of
    its own) that launches a kernel and syncs inside the step's range; a
    copy after the steps syncs outside them."""
    launched = []
    for base in (0, 300):
        step = event("vqcpcb.train_step", base, base + 250)
        item = event("aten::item", base + 10, base + 30,
                     event("vqcpcb.forward", base, base + 90, step))
        event("cudaMemcpyAsync", base + 11, base + 12, item)
        event("cudaStreamSynchronize", base + 12, base + 29, item)
        launched.append((base + 15, base + 16, item))
        node = event("autograd::engine::evaluate_function: MulBackward0",
                     base + 120, base + 140)
        event("cudaStreamSynchronize", base + 130, base + 131, node)
        event("cudaLaunchKernel", base + 122, base + 123, node)
        launched.append((base + 125, base + 128, node))
    after = event("aten::copy_", 600, 620)
    event("cudaStreamSynchronize", 610, 619, after)
    launched.append((605, 606, after))
    return trace(launched)


def test_host_sync_readers():
    t = syncing_trace()
    assert read("host_syncs_per_step.train", t) == 2.0
    assert registry.module("metrics", "host_syncs_per_step.train").syncs_inside(
        t, "vqcpcb.forward") == 2
    call = event("vqcpcb.sample_range", 0, 1000)
    launched = []
    for p in range(4):
        sample = event("vqcpcb.sample", 100 * p, 100 * p + 50, call)
        for k in range(2):
            fill = event("aten::copy_", 100 * p + 10 * k, 100 * p + 10 * k + 5, sample)
            event("cudaStreamSynchronize", 100 * p + 10 * k + 1, 100 * p + 10 * k + 4, fill)
            launched.append((100 * p + 10 * k, 100 * p + 10 * k + 1, fill))
    assert read("host_syncs_per_position.gen", trace(launched, calls=1)) == 2.0


def test_host_sync_readers_read_zero_where_a_span_holds_no_sync():
    call = event("vqcpcb.sample_range", 0, 100)
    t = trace([(0, 10, event("aten::mm", 1, 2, event("vqcpcb.train_step", 0, 50))),
               (60, 70, event("aten::mm", 61, 62, call))], calls=1)
    assert read("host_syncs_per_step.train", t) == 0.0
    assert read("host_syncs_per_position.gen", t) == 0.0


@pytest.mark.parametrize("name", ["flagship-train", "encoder-train", "flagship-gen"])
def test_a_cpu_traced_run_reports_none_of_them(name, capsys):
    from vqcpcb_tpu_torch.training import profiling
    profiling.reset_counters()
    rc = run.main(["--workload", name, "--seed", str(2 ** 31 + 7), "--seconds", "0.3",
                   "--trace", "1"], device="cpu", cell=tiny.cell(name))
    assert rc == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert not set(result["metrics"]) & set(SPAN_READERS)
    counted = profiling.counters()
    assert counted.get("positions" if name.endswith("gen") else "steps", 0) > 0
    profiling.reset_counters()


# ---- on the card -------------------------------------------------------------

def launched_inside(t, root):
    """Whether a recorded device operation was launched inside span `root`."""
    for _, _, op in t.launched:
        while op is not None:
            if op.name == root:
                return True
            op = op.cpu_parent
    return False


def profiled(fn):
    """A Trace of one call of fn under a profiler with host and device
    activity, after one call to warm it up; a session that recorded no
    device operation launched inside vqcpcb.train_step is run again, up
    to three sessions. `seen` says what the last one held."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        t = Trace(prof, 1.0, 1, prof)
        t.seen = (f"{len(t.kernels)} device operations, {len(t.launched)} linked, "
                  f"events {sorted({e.name for e in prof.events()} - {n for n, _, _ in t.kernels})}")
        if launched_inside(t, "vqcpcb.train_step"):
            return t
    return t


def card_readings(case: str) -> None:
    """Prints, as one JSON line, the sync readings of a profiled call on the
    card: "span", one `.item()` and one host-to-device `torch.tensor`
    inside vqcpcb.train_step and the same outside it; "backward", a
    backward that reads a value back on autograd's device thread."""
    import torch
    from vqcpcb_tpu_torch.training.profiling import span
    card = torch.device("cuda")
    syncs_inside = registry.module("metrics", "host_syncs_per_step.train").syncs_inside
    if case == "span":
        x = torch.ones(3, device=card)

        def fn():
            with span("vqcpcb.train_step"):
                x.sum().item()
                torch.tensor(2.0, device=card)
                x * 2
            x.sum().item()
            torch.tensor(2.0, device=card)
        t = profiled(fn)
        out = {"per_step": read("host_syncs_per_step.train", t)}
    else:
        class SyncingBackward(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x * 2

            @staticmethod
            def backward(ctx, grad):
                grad.sum().item()
                return grad * 2
        x = torch.ones(3, device=card, requires_grad=True)

        def fn():
            with span("vqcpcb.train_step"):
                loss = SyncingBackward.apply(x).sum()
                with span("vqcpcb.backward"):
                    loss.backward()
        t = profiled(fn)
        out = {"train_step": syncs_inside(t, "vqcpcb.train_step"),
               "backward": syncs_inside(t, "vqcpcb.backward")}
    print(json.dumps(dict(out, seen=t.seen)))


def readings_in_a_fresh_interpreter(case: str) -> dict:
    """card_readings(case) in a new process. In a process that has run
    many profiler sessions, CPU-only ones among them, the card's profiler
    has dropped the device records of several sessions in a row (their
    events hold an 'Activity Buffer Request' and few or none of the call's
    device operations); a fresh process records them whole."""
    import subprocess
    import sys
    from pathlib import Path
    code = ("from portbench.tests.test_portbench_spans import card_readings; "
            f"card_readings({case!r})")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=Path(__file__).resolve().parents[2], timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_syncs_inside_a_span_are_read_and_outside_are_not(card):
    out = readings_in_a_fresh_interpreter("span")
    assert out["per_step"] == 2.0, out["seen"]


@pytest.mark.cuda
def test_a_sync_on_autograds_device_thread_is_read(card):
    out = readings_in_a_fresh_interpreter("backward")
    assert (out["train_step"], out["backward"]) == (1, 1), out["seen"]
