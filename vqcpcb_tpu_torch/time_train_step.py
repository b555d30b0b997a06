"""Decoder or prior train-step times on one CUDA card, with the port's
dropout and with torch's nn.Dropout in turns, in one process.

    python3 vqcpcb_tpu_torch/time_train_step.py [--kind flagship|absolute|prior]
                                                [--rounds 10] [--steps 20]

Builds chip_smoke.py's full-width decoder trainer (d_model 512, 3 + 3
layers, batch 32 x 384 tokens, dropout 0.2, bf16 transformer layers, Adam)
or, with --kind prior, its full-width prior trainer (configs/prior_config.py: 6
layers of 512, batch 64 x 24 codes, dropout 0.1, f32, Adam) and times
rounds of `steps` train steps, each synced and timed on the host clock as
chip_smoke.py times them. The rounds alternate the forward of the decoder's
Dropout modules (vqcpcb_tpu_torch/ops/transformer.py) between the port's,
whose mask comes from the trainer's generator, and nn.Dropout's, from
torch's default generator, in the order A B B A A B ...; everything else is
the same code on the same card. Prints one JSON line: the card, and for
each variant the median, quartiles and per-round medians of ms per step,
and in how many of the round pairs the port's variant was faster.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--kind", default="flagship",
                        choices=("flagship", "absolute", "prior"))
    parser.add_argument("--rounds", type=int, default=10)
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_train_step: needs a CUDA card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke
    from vqcpcb_tpu_torch.ops.transformer import Dropout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.kind == "prior":
        trainer, batches = chip_smoke.prior_at_full_width(gen)
        for x in batches[:2]:                 # warm-up: cuBLAS plans, caches
            trainer.train_step(x)
    else:
        trainer, batches = chip_smoke._trainer(gen, args.kind)
    forwards = {"port": Dropout.forward, "nn.Dropout": torch.nn.Dropout.forward}
    times = {name: [] for name in forwards}
    order = [("port", "nn.Dropout")[(r + 1) // 2 % 2] for r in range(args.rounds)]
    try:
        for name in order:
            Dropout.forward = forwards[name]
            steps = []
            for i in range(args.steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_step(batches[i % len(batches)])
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - t0) * 1e3)
            times[name].append(steps)
    finally:
        Dropout.forward = forwards["port"]
    out = {"card": card, "kind": args.kind, "steps_per_round": args.steps,
           "order": order}
    for name, rounds in times.items():
        flat = np.concatenate(rounds)
        out[name] = {"median_ms": float(np.median(flat)),
                     "q1_ms": float(np.percentile(flat, 25)),
                     "q3_ms": float(np.percentile(flat, 75)),
                     "round_medians_ms": [float(np.median(r)) for r in rounds]}
    pairs = list(zip(out["port"]["round_medians_ms"],
                     out["nn.Dropout"]["round_medians_ms"]))
    out["pairs_port_faster"] = sum(p < n for p, n in pairs)
    out["pairs"] = len(pairs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
