"""A closed training loop: the configuration's system steps through a pool
of batches made from the seed, never synchronized inside the window.

Set-up builds one trainer and drives it through its first steps with the
window's own call and feed (pool batches 0, 1, 2, whose rows all differ):
the first clipped gradient is read from Adam's state after step 1 and the
change of the parameters after step 3, before step 4. The window runs
whole steps until `seconds` have passed, a CUDA event recorded at each
step's start and one after the last; then the device is synchronized.
train_tokens_per_s = tokens of the window's steps / (host time from the
window's start to that synchronize); train_step_p95_ms = the 95th
percentile of the intervals between consecutive events. A traced run
profiles `profiled` more whole steps after the window. The reference
follows the first three steps once the program is freed."""
from __future__ import annotations

import contextlib
import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.harness import compare, tracing

FIRST_STEPS = 3


def first_steps(sysm) -> tuple:
    """(initial trainable leaves, the program's readings of its first
    steps): losses, the first clipped gradient, the change after them."""
    initial = {k: v for k, v in sysm.initial().items() if k in sysm.names}
    losses = []
    with getattr(sysm, "recording", contextlib.nullcontext)():
        for i in range(FIRST_STEPS):
            losses.append(sysm.step(sysm.pool[i]))
            if i == 0:
                first = compare.first_grads_from_adam(sysm.names,
                                                      sysm.adam_first_moments())
    params = sysm.parameters()
    change = {k: params[k].detach() - initial[k] for k in sysm.names}
    return initial, {"losses": [float(x) for x in losses], "first_grads": first,
                     "change": change}


def optimizer_config(cfg: dict) -> dict:
    return {"lr": cfg["lr"], "schedule_lr": cfg.get("schedule_lr", False),
            "warmup_steps": cfg.get("warmup_steps", 1)}


def run(ctx) -> SimpleNamespace:
    """ctx: cell, system (module), seed, seconds, trace, device, log,
    started (epoch seconds of the process start). Returns what run.py
    reports."""
    cfg, traffic, wl = ctx.cell["config"], ctx.cell["traffic"], ctx.cell["workload"]
    cuda = ctx.device.type == "cuda"
    sysm = ctx.system.Train(cfg, traffic, ctx.seed, ctx.device)
    ctx.phase("system")
    pool = sysm.pool
    initial, program = first_steps(sysm)
    for i in range(FIRST_STEPS, FIRST_STEPS + int(wl.get("warm_steps", 2))):
        sysm.step(pool[i % len(pool)])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    ctx.phase("first steps and warm-up")
    setup_s = time.time() - ctx.started

    # ---- the window --------------------------------------------------------
    starts, window_losses = [], []
    i = FIRST_STEPS + int(wl.get("warm_steps", 2))
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        starts.append(_mark(cuda))
        window_losses.append(sysm.step(pool[i % len(pool)]))
        i += 1
    end = _mark(cuda)
    sync()
    elapsed = time.perf_counter() - t0
    steps = len(starts)
    marks = starts + [end]
    intervals = [_ms(a, b, cuda) for a, b in zip(marks, marks[1:])]
    p95 = float(np.percentile(intervals, 95))
    failed = int((~torch.isfinite(torch.stack(window_losses).float())).sum())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    out = SimpleNamespace(
        attempted=steps, failed=failed, memory_peak_bytes=int(peak),
        end_to_end={"train_tokens_per_s": steps * sysm.tokens_per_step / elapsed,
                    "train_step_p95_ms": p95,
                    "setup_s": setup_s},
        window={"steps": steps, "seconds": elapsed,
                "tokens_per_step": sysm.tokens_per_step,
                "step_ms_median": float(np.median(intervals)),
                "step_ms_p95": p95},
        trace=None)
    if ctx.trace:
        k = i
        out.trace = tracing.profile(lambda j: sysm.step(pool[(k + j) % len(pool)]),
                                    int(wl["profiled"]), ctx.log, cuda)

    # ---- the reference follows the first steps ------------------------------
    loss_fn = sysm.reference_loss()
    sysm.close()
    del sysm, window_losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    reference = compare.follow(initial, pool[:FIRST_STEPS], loss_fn,
                               optimizer_config(cfg))
    out.numbers = compare.train_numbers(program, reference)
    ctx.log(f"# losses program {program['losses']} reference {reference['losses']}")
    pins = getattr(loss_fn, "pins", None)
    if pins is not None:
        ctx.log(f"# codes the reference took from the program at near ties: {pins.pinned}")
    return out


def _mark(cuda: bool):
    if cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(a, b, cuda: bool) -> float:
    return a.elapsed_time(b) if cuda else (b - a) * 1e3
