"""Tracing and debug hooks (counterpart of vqcpcb_tpu/training/profiling.py).

Two switches, read from the environment as the JAX package reads them:
  * `maybe_profile(tag)`: with VQCPCB_PROFILE_DIR set, a torch.profiler
    trace of the block (CPU and, on a machine with a card, CUDA activity),
    written under that directory as a Chrome trace that TensorBoard and
    Perfetto read ({tag}.{pid}.{time}.pt.trace.json). Unset, it does
    nothing. The epoch loop wraps each train epoch in it (loop.py:208).
  * `enable_debug_checks()`: with VQCPCB_DEBUG_NANS=1, anomaly detection in
    autograd (a backward that makes a NaN raises and names the forward op)
    and `check_finite` on every train step's loss (a non-finite loss
    raises): the nearest counterpart of jax_debug_nans, which raises on
    the first NaN. The CLIs call it first thing; it sets both switches to
    what the variable says.

Spans and counters, on only while a torch profiler records (any profiler:
`maybe_profile`'s, or one an operator opens around the port's calls):
  * `span(name)`: a `torch.profiler.record_function` range, so it sits on
    the profiler's clock beside the aten ops, the CUDA runtime calls
    (launches, copies, `cudaStreamSynchronize`) and the kernels they
    launch; with no profiler recording it costs one flag check. The
    port's spans are named `vqcpcb.*` (README, VQCPCB_PROFILE_DIR). The
    host's syncs are read from the trace: the synchronizing runtime calls
    inside a span's range (those of autograd's device thread by time).
  * `count(name, n)`, `counters()`, `reset_counters()`: a plain dict of
    counts, written only while a profiler records (`steps`, `positions`).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

_debug_checks = False
_counters: Dict[str, int] = {}
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def maybe_profile(tag: str = "epoch") -> Iterator[None]:
    profile_dir = os.environ.get("VQCPCB_PROFILE_DIR")
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with record_function(tag):
            yield
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"{tag}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def span(name: str):
    """A context manager over one phase of the port: a record_function
    range named `name` while a profiler records, else a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _autograd_profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Adds n to counter `name` while a profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of the counters."""
    return dict(_counters)


def reset_counters() -> None:
    _counters.clear()


def enable_debug_checks() -> bool:
    """Turns the NaN checks on under VQCPCB_DEBUG_NANS=1 and off otherwise;
    returns whether they are on."""
    global _debug_checks
    _debug_checks = os.environ.get("VQCPCB_DEBUG_NANS") == "1"
    torch.autograd.set_detect_anomaly(_debug_checks)
    return _debug_checks


def check_finite(loss: torch.Tensor, what: str = "loss") -> None:
    """With the debug checks on, raises FloatingPointError when `loss` holds
    a NaN or an infinity (it reads the value back: one sync a step)."""
    if _debug_checks and not bool(torch.isfinite(loss).all()):
        raise FloatingPointError(f"non-finite {what} {loss.detach().cpu()} "
                                 "(VQCPCB_DEBUG_NANS=1)")
