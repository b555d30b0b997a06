"""Time the relative-bias attention forward kernel of one checkout at the
serving prefill's shapes, on one CUDA card.

    python3 vqcpcb_tpu_torch/time_relbias_fwd.py [--root DIR] [--label NAME]

DIR is the root of the checkout whose vqcpcb_tpu_torch package is timed
(default: the one holding this file); its kernels are built there, into
DIR/build/kernels/. The inputs are the same in every process (f32 q, k, v
and tables from a seeded generator, B = 512, H = 8, d = 64, bf16 dots):
T = S = 384 under the causal mask (the decoder's self-attention) and
T = S = 24 under the anticausal mask (the code encoder). Prints one JSON line:
ms per call from CUDA events, a checksum of each output (equal across
checkouts whose kernels agree bit for bit) and the ptxas report of the
kernel's library. To compare two checkouts, run one process per checkout in
one session on one card, in the order A, B, B, A.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPS = 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    sys.path[0] = str(Path(args.root).resolve())   # not this file's folder
    import torch
    if not torch.cuda.is_available():
        print("time_relbias_fwd: needs a CUDA card", file=sys.stderr)
        return 2
    from vqcpcb_tpu_torch.ops import _build
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    from vqcpcb_tpu_torch.ops.masks import anticausal_mask, causal_mask
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()

    b, h, d = 512, 8, 64
    result = {"label": args.label, "root": args.root,
              "package": str(Path(ak.__file__).resolve().parents[1])}
    for name, t in (("decoder", 384), ("code_encoder", 24)):
        gen = torch.Generator(device="cuda").manual_seed(0)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
        q = rnd(b, h, t, d) * d ** -0.5
        k, v = rnd(b, h, t, d), rnd(b, h, t, d)
        e1, e2 = rnd(h, t, d), rnd(h, t, d)
        mask = causal_mask(t, device="cuda") if t == 384 else anticausal_mask(
            t, device="cuda")
        call = lambda: ak.relbias_attention_fwd_cuda(q, k, v, mask, e1, e2)  # noqa: E731
        out = call()
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            call()
        stop.record()
        torch.cuda.synchronize()
        out64 = out.double()
        result[name] = {"ms": start.elapsed_time(stop) / REPS,
                        "sum": out64.sum().item(),
                        "sum_sq": (out64 * out64).sum().item()}
        del q, k, v, out, out64
        torch.cuda.empty_cache()
    lib = _build.library_path("relbias_attention")
    report = lib.parent / (lib.name + ".log")
    result["ptxas"] = [line.strip() for line in report.read_text().splitlines()
                       if "registers" in line or "Compiling entry" in line]
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
