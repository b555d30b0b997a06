"""Time the attention kernels and the nearest-codebook kernel of one
checkout on one CUDA card.

    python3 vqcpcb_tpu_torch/time_kernels.py [--root DIR] [--label NAME]
                                             [--kernels NAME,NAME,...] [--profile]
                                             [--variants FILE]

DIR is the root of the checkout whose vqcpcb_tpu_torch package is timed
(default: the one holding this file); its kernels are built there, into
DIR/build/kernels/. The inputs are the same in every process (from a seeded
generator; H = 8, d = 64, bf16 dots). The kernels (default: all):

  K3-fwd          the relative-bias forward at the serving prefill's shape:
                  f32 q, k, v and tables, B = 512, T = S = 384, causal mask
  K3-fwd-encoder  the same at the code encoder's T = S = 24, anticausal mask
  K4              the f32 fused forward (the absolute decoder's attentions
                  at serving) at B = 512: q a (B, T, H*d) view, k and v the
                  halves of a (B, S, 2*H*d) projection, T = S = 384, causal
  K4-cross        K4 at the cross-attention: T = 384, S = 24, zero mask
  K4-encoder      K4 at the code encoder: T = S = 24, anticausal mask
  K2-fwd          the relative-bias forward at the training shape: bf16
                  q, k, v packed (B, L, H*d), B = 32, T = S = 384, causal
                  mask, dropout 0.2
  K6-fwd          the fused forward without a bias, as K2-fwd
  K6-fwd-cross    K6-fwd at the absolute decoder's cross-attention: T = 384,
                  S = 24, no mask
  K2-bwd          the relative-bias backward at K2-fwd's shape, with dout
  K3-bwd          K2-bwd on (B, H, L, d) views
  K6-bwd-nobias   the fused backward without a bias, as K2-bwd
  K6-bwd          the fused backward with a real (B*H, T, S) bias
  vq_nearest      K1 at the five main-path shapes (VQ_SHAPES), codebook
                  32 x 3: ms per call by CUDA events and device ms by
                  torch.profiler, beside the device ms of the empty and
                  I/O-floor kernels on the run-time kernel's grid, and the
                  kernel the shape picks

Prints one JSON line: for each kernel the ms per call from CUDA events over
its repetitions, and the sum and sum of squares of its first output (equal
across checkouts whose kernels agree bit for bit); and the ptxas registers
and spills of the head-dim-64 kernels of the libraries used (of every
head dim for K4's f32-dot kernel, of every kernel of vq_nearest). With
--profile, also each kernel's launches by name: device ms per call summed by
torch.profiler over the repetitions. To compare two checkouts, run one
process per checkout, all in one command on one card, in the order A, B,
B, A.

--variants FILE (JSON: {variant: [[csrc file, old text, new text], ...]})
builds each variant, the checkout's csrc/ with those edits (each old text
found exactly once), into DIR/build/variants/, and times the kernels again
with each variant's libraries in turn: the checkout, the variants, the
variants in reverse, the checkout. Variants that remove one part of a
kernel tell where its time goes (k4_parts.json).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

SERVING = ("K3-fwd", "K3-fwd-encoder", "K4", "K4-cross", "K4-encoder")
TRAIN = ("K2-fwd", "K6-fwd", "K6-fwd-cross", "K2-bwd", "K3-bwd", "K6-bwd-nobias",
       "K6-bwd")
LIBRARIES = {"K3-fwd": "relbias_attention", "K3-fwd-encoder": "relbias_attention",
             "K4": "fused_attention", "K4-cross": "fused_attention",
             "K4-encoder": "fused_attention",
             "K2-fwd": "relbias_attention", "K6-fwd": "fused_attention",
             "K6-fwd-cross": "fused_attention",
             "K2-bwd": "relbias_attention_bwd", "K3-bwd": "relbias_attention_bwd",
             "K6-bwd-nobias": "fused_attention_bwd", "K6-bwd": "fused_attention_bwd",
             "vq_nearest": "vq_nearest"}
VQ = ("vq_nearest",)
# K1's main-path shapes (N, K, d, S): the serving batch's 512 x 24 codes, the
# VQ-CPC step's 1,440 negative windows and 96 blocks, the student's 8 x 24
# codes, the decoder CLI's and the prior's 64 x 24
VQ_SHAPES = ((12288, 1, 3, 32), (1440, 1, 3, 32), (96, 1, 3, 32),
             (192, 1, 3, 32), (1536, 1, 3, 32))
VQ_REPS = 200


def forward_calls(torch, ak, fk, masks):
    """(name, repetitions, call) of the relative-bias forward and of K4,
    serving shapes."""
    b, h, d = 512, 8, 64
    for name, t in (("K3-fwd", 384), ("K3-fwd-encoder", 24)):
        gen = torch.Generator(device="cuda").manual_seed(0)
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
        q = rnd(b, h, t, d) * d ** -0.5
        k, v = rnd(b, h, t, d), rnd(b, h, t, d)
        e1, e2 = rnd(h, t, d), rnd(h, t, d)
        mask = (masks.causal_mask(t, device="cuda") if t == 384
                else masks.anticausal_mask(t, device="cuda"))
        yield name, 10, (lambda q=q, k=k, v=v, mask=mask, e1=e1, e2=e2:
                         ak.relbias_attention_fwd_cuda(q, k, v, mask, e1, e2))
    for name, t, s, kind in (("K4", 384, 384, "causal"), ("K4-cross", 384, 24, None),
                             ("K4-encoder", 24, 24, "anticausal")):
        gen = torch.Generator(device="cuda").manual_seed(0)
        split = lambda x: x.unflatten(-1, (h, d)).transpose(1, 2)  # noqa: E731
        q = split(torch.randn((b, t, h * d), generator=gen, device="cuda") * d ** -0.5)
        kv = torch.randn((b, s, 2 * h * d), generator=gen, device="cuda")
        k, v = split(kv[..., :h * d]), split(kv[..., h * d:])
        mask = {"causal": lambda: masks.causal_mask(t, device="cuda"),
                "anticausal": lambda: masks.anticausal_mask(s, device="cuda"),
                None: lambda: None}[kind]()
        yield name, 10 if t == s == 384 else 30, (
            lambda q=q, k=k, v=v, mask=mask: fk.fused_attention_cuda(q, k, v, mask))


def training_calls(torch, ak, fk, masks):
    """(name, repetitions, call) of the training forwards and the attention
    backward, training shape."""
    b, h, t, d = 32, 8, 384, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    q = (rnd(b, t, h * d) * d ** -0.5).to(torch.bfloat16)
    k, v, g = (rnd(b, t, h * d).to(torch.bfloat16) for _ in range(3))
    e1, e2 = rnd(h, t, d), rnd(h, t, d)
    bias = rnd(b * h, t, t)
    mask = masks.causal_mask(t, device="cuda")
    kw = dict(num_heads=h, dropout=0.2, seed=3, need_dmask=False)
    q4, k4, v4, g4 = (x.unflatten(-1, (h, d)).transpose(1, 2).contiguous()
                      for x in (q, k, v, g))
    kw4 = dict(kw, num_heads=None)
    fkw = dict(num_heads=h, dropout=0.2, seed=3)
    yield "K2-fwd", 20, lambda: ak.relbias_attention_fwd_cuda(
        q, k, v, mask, e1, e2, **fkw)
    yield "K6-fwd", 20, lambda: fk.fused_attention_train_fwd_cuda(
        q, k, v, mask, None, **fkw)
    kc, vc = k[:, :24], v[:, :24]
    yield "K6-fwd-cross", 50, lambda: fk.fused_attention_train_fwd_cuda(
        q, kc, vc, None, None, **fkw)
    yield "K2-bwd", 20, lambda: ak.relbias_attention_bwd_cuda(
        q, k, v, mask, e1, e2, g, **kw)
    yield "K3-bwd", 20, lambda: ak.relbias_attention_bwd_cuda(
        q4, k4, v4, mask, e1, e2, g4, **kw4)
    yield "K6-bwd-nobias", 20, lambda: fk.fused_attention_train_bwd_cuda(
        q, k, v, mask, None, g, **kw)
    yield "K6-bwd", 20, lambda: fk.fused_attention_train_bwd_cuda(
        q, k, v, mask, bias, g, **kw)


def time_call(torch, call, reps):
    """(ms per call by CUDA events after two warm-up calls, first output)."""
    out = call()
    out = out[0] if isinstance(out, tuple) else out
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def launch_ms(torch, call, reps):
    """{device kernel name: ms per call} of `call`, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return {e.key[:80]: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def device_ms(torch, call, reps):
    """Device ms per call of `call` (every kernel it launches), by
    torch.profiler over `reps` calls after one warm-up call."""
    call()
    torch.cuda.synchronize()
    return sum(launch_ms(torch, call, reps).values())


def time_vq(torch, vk):
    """{shape: numbers} of K1 at VQ_SHAPES on seeded inputs: ms by events,
    device ms, the empty and I/O-floor kernels' device ms, K1 / I/O floor,
    the kernel the shape picks (a checkout that has one kernel names none)
    and the indices' sum and sum of squares."""
    result = {}
    for n, k, d, s in VQ_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((n, k, d), generator=gen, device="cuda")
        e = torch.randn((k, s, d), generator=gen, device="cuda")
        io_out = torch.empty((n, k), dtype=torch.int32, device="cuda")

        def call(x=x, e=e):
            return vk.nearest_codebook_indices_cuda(x, e)
        ms, idx = time_call(torch, call, VQ_REPS)
        dev = device_ms(torch, call, VQ_REPS)
        io = device_ms(torch, lambda: vk.io_floor_cuda(x, e, io_out), VQ_REPS)
        idx = idx.double()
        result[f"({n},{k},{d},{s})"] = {
            "kind": vk.kernel_kind(d, s) if hasattr(vk, "kernel_kind") else None,
            "ms": ms, "device_ms": dev, "io_floor_device_ms": io,
            "vs_io_floor": dev / io,
            "empty_device_ms": device_ms(
                torch, lambda: vk.launch_floor_cuda(n, k, x.device), VQ_REPS),
            "sum": idx.sum().item(), "sum_sq": (idx * idx).sum().item()}
    return result


def ptxas_report(build, lib_name):
    """{kernel entry: [registers / spill lines]} of the head-dim-64 kernels,
    of every head dim of the f32-dot forward (fwd_f32) and of every kernel
    of vq_nearest."""
    lib = build.library_path(lib_name)
    report, entry = {}, None
    for line in (lib.parent / (lib.name + ".log")).read_text().splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif (entry and ("Li64E" in entry or "fwd_f32" in entry
                         or lib_name == "vq_nearest")
              and ("registers" in line or "spill" in line)):
            report.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
    return report


def build_variants(build, variants, libs):
    """{variant: {library: loaded library}}: the checkout's csrc/ with each
    variant's edits, one nvcc per (variant, library), all started together."""
    import ctypes
    import shutil
    import subprocess
    procs = []
    for name, edits in variants.items():
        src = build.BUILD_DIR.parent / "variants" / name
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(build.CSRC_DIR, src)
        for file, old, new in edits:
            text = (src / file).read_text()
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {file} holds {text.count(old)} "
                                 f"copies of {old[:60]!r}")
            (src / file).write_text(text.replace(old, new))
        for lib in libs:
            so = src / f"{lib}.so"
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(src / f"{lib}.cu")]
            procs.append((name, lib, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {}
    for name, lib, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed for {lib}.cu:\n{log}")
        built.setdefault(name, {})[lib] = ctypes.CDLL(str(so))
    return built


def time_variants(torch, build, calls, variants, libs):
    """{variant: {kernel: [ms, ...]}} in the order checkout, variants,
    variants reversed, checkout, all on the same inputs."""
    built = build_variants(build, variants, libs)
    own = {lib: build.library(lib) for lib in libs}
    times = {}
    for name in ["checkout", *variants, *reversed(list(variants)), "checkout"]:
        for lib in libs:
            build._LIBS[lib] = own[lib] if name == "checkout" else built[name][lib]
        for kernel, reps, call in calls:
            times.setdefault(name, {}).setdefault(kernel, []).append(
                time_call(torch, call, reps)[0])
    for lib in libs:
        build._LIBS[lib] = own[lib]
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", default=",".join(SERVING + TRAIN + VQ))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--variants", default=None)
    args = ap.parse_args()
    wanted = args.kernels.split(",")
    unknown = sorted(set(wanted) - set(SERVING + TRAIN + VQ))
    if unknown:
        ap.error(f"unknown kernels {unknown}; choose from "
                 f"{list(SERVING + TRAIN + VQ)}")
    sys.path[0] = str(Path(args.root).resolve())   # not this file's folder
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: needs a CUDA card", file=sys.stderr)
        return 2
    from vqcpcb_tpu_torch.ops import _build, masks
    from vqcpcb_tpu_torch.ops import attention_kernels as ak
    from vqcpcb_tpu_torch.ops import fused_attention_kernels as fk
    from vqcpcb_tpu_torch.ops import vq_kernels as vk
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()

    result = {"label": args.label, "root": args.root,
              "package": str(Path(ak.__file__).resolve().parents[1])}
    groups = []
    if set(wanted) & set(SERVING):
        groups.append(forward_calls(torch, ak, fk, masks))
    if set(wanted) & set(TRAIN):
        groups.append(training_calls(torch, ak, fk, masks))
    if "vq_nearest" in wanted:
        result["vq_nearest"] = time_vq(torch, vk)
    if args.variants:
        calls = [c for g in groups for c in g if c[0] in wanted]
        result["variants"] = time_variants(
            torch, _build, calls, json.loads(Path(args.variants).read_text()),
            sorted({LIBRARIES[name] for name in wanted}))
        groups = [calls]
    for calls in groups:
        for name, reps, call in calls:
            if name not in wanted:
                continue
            ms, out = time_call(torch, call, reps)
            out64 = out.double()
            result[name] = {"ms": ms, "sum": out64.sum().item(),
                            "sum_sq": (out64 * out64).sum().item()}
            if args.profile:
                result[name]["launches"] = launch_ms(torch, call, reps)
            del out, out64
        torch.cuda.empty_cache()
    result["ptxas"] = {}
    for lib_name in sorted({LIBRARIES[name] for name in wanted}):
        result["ptxas"].update(ptxas_report(_build, lib_name))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
