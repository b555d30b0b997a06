"""Run one cell of the benchmark once.

    python portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with a CUDA card. The cell's files are found by
the names in BENCHMARK.json (portbench/harness/registry.py). Standard output
ends with one JSON line: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device, with
--trace 1 breakdown, and last `checks`, each compared number beside its
limit; standard error ends with the same numbers, one a line. Without a
card, or with a module of the JAX package loaded, it exits non-zero and
prints no result."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import env  # noqa: E402

STARTED = env.process_start_time()


def log(msg: str) -> None:
    print(msg, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def launch_counts() -> dict:
    """The port's kernel launch counters for this process."""
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
    from vqcpcb_tpu_torch.ops import vq_kernels as vk
    return {"vq_nearest": vk.launches, "relbias_attention_fwd": ak.launches,
            "relbias_attention_bwd": ak.bwd_launches, "fused_attention": fk.launches,
            "fused_attention_train_fwd": fk.train_fwd_launches,
            "fused_attention_train_bwd": fk.train_bwd_launches
            + fk.train_bwd_nobias_launches}


def per_layer(cell, out, costs) -> dict:
    """Each per-layer metric of the cell that its reader finds something to
    read for, from the traced section and the window."""
    from portbench.harness import registry
    ctx = SimpleNamespace(trace=out.trace, window=out.window, config=cell["config"],
                          traffic=cell["traffic"], costs=costs)
    metrics = {}
    for m in cell["per_layer"]:
        value = registry.module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def main(argv=None, *, device=None, cell=None) -> int:
    """device and cell: a test's own device (no card asked for) and cell."""
    args = parse(argv)
    env.prepare()
    from portbench.harness import registry
    cell = cell or registry.cell(args.workload)
    import torch
    if device is None:
        kind = env.card_or_exit(int(cell["entry"]["chips"]))
        env.strict_f32()
        log(f"# card: {env.smi()}")
        log(f"# torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}")
        device = torch.device("cuda")
    else:
        device = torch.device(device)
        kind = str(device)
    phases = {"process start to the card": time.time() - STARTED}
    last = [time.time()]

    def phase(name: str) -> None:
        """Set-up's parts, each the seconds since the one before."""
        now = time.time()
        phases[name] = now - last[0]
        last[0] = now
    if device.type == "cuda":
        # every kernel library, built here on a checkout's first run and
        # loaded at first use; its build seconds are logged apart
        from vqcpcb_tpu_torch.ops import _build
        log(f"# kernel build: {json.dumps(_build.build_all())}")
        phase("kernel build")
    workload = cell["workload"]
    ctx = SimpleNamespace(phase=phase, cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=device, log=log,
                          started=STARTED,
                          system=registry.module("systems", cell["entry"]["config"]))
    out = registry.module("drivers", workload["driver"]).run(ctx)
    log(f"# setup phases: {json.dumps(phases)}")
    from portbench.harness import compare
    limits = workload["limits"]
    checks = {k: {"value": out.numbers[k], "limit": limits[k]} for k in limits}
    correct = compare.verdict(out.numbers, limits)
    log(f"# window: {json.dumps(out.window)}")
    if device.type == "cuda":
        log(f"# card after the window: {env.smi()}")
    if out.trace is not None:
        summed = sum(t - s for _, s, t in out.trace.kernels) / 1e6
        log(f"# trace: {len(out.trace.kernels)} device operations in {out.trace.calls} "
            f"calls, {summed} s summed, {out.trace.busy_s} s of union, window "
            f"{out.trace.window_s} s; {sum(op is not None for *_, op in out.trace.launched)} "
            f"of {len(out.trace.launched)} traced with host activity linked to a host op")
    log(f"# launches: {json.dumps(launch_counts())}")
    log(f"# memory: max_memory_allocated {out.memory_peak_bytes}")
    log(f"# numbers: {json.dumps({k: v for k, v in out.numbers.items()})}")
    if args.trace:
        costs = registry.module("costs", cell["entry"]["config"])
        metrics = per_layer(cell, out, costs)
    else:
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out.end_to_end.items() if k in units}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind, "count": int(cell["entry"]["chips"]),
           "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": out.trace.top_device_ops(),
                               "idle_gaps": out.trace.idle_gaps()}
    result["checks"] = checks
    found = env.forbidden_loaded()
    if found:
        sys.stderr.write(f"portbench: loaded modules of {', '.join(found)}; "
                         "no result\n")
        return 2
    for name, c in checks.items():
        sys.stderr.write(f"check {name} {c['value']!r} limit {c['limit']!r}\n")
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
